// Kernel K1's untextured instantiations held to kSmallSceneBlocks blocks
// an SM, so 128 registers a thread, for the scenes whose rows let that
// many blocks share an SM (frame.cu has the design and the measurements).
// A source of their own, so nvcc builds them beside frame.cu's.
#include "frame_launch.cuh"

namespace bdpt {

int launch_frame_small(const FrameParams& p, int d_max, const float* lights, const float* tris,
                       const FrameOutPtrs& out, cudaStream_t s) {
  return launch_frame_d<false, kSmallSceneBlocks, 8>(d_max, p, lights, tris, nullptr, 0, out,
                                                     s);
}

}  // namespace bdpt
