// Kernel K1's textured instantiations (frame.cu has the design), the
// replacement of the TPU kernel's textured=True program
// (fyp_bidirectionalpathtracer_tpu/accel/pallas_frame.py:frame_kernel).
//
// Built with -fmad=false (cuda.py SOURCE_FLAGS), as K6 is: the compiler
// contracts no product and sum into an FMA, so the program repeats the
// rounding of its plain version (accel/frame.frame_plain, one torch
// operation at a time) operation for operation.  Its raw estimator parts
// (unclamped, unweighted connection shades) amplify a last-bit difference
// in a ray: with contraction on, the connection rows at depth 4 were off
// by more than 1e-3 on more pixels than K1's bound of 2% allows, with the
// BVH walk and with the dense loop alike; built so, they are within it at
// depths 1-4.  It costs the textured K1 ~9% of its time (PERF.md).
#include "frame_launch.cuh"

extern "C" int bdpt_frame_textured_launch(const bdpt::FrameParams* params, int d_max,
                                          const float* lights, const float* tris,
                                          const float* nodes, int n_nodes, float* gbuf,
                                          int* splat_pix, float* splat_rgba, float* vrec,
                                          float* e1, float* e3, void* stream) {
  const bdpt::FrameParams& p = *params;
  const bdpt::FrameOutPtrs out = {nullptr, gbuf, splat_pix, nullptr, splat_rgba,
                                  vrec, e1, e3};
  cudaStream_t s = (cudaStream_t)stream;
  if (p.splat_rgb8e) return (int)cudaErrorInvalidValue;
  return bdpt::launch_frame_d<true, 1, 4>(d_max, p, lights, tris, nodes, n_nodes, out, s);
}
