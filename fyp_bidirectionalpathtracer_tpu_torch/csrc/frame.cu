// Kernel K1: the whole-frame BDPT megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/accel/
// pallas_frame.py:frame_kernel; the plain PyTorch version is
// accel/frame.py:frame_plain, and the per-pixel program is in
// frame_program.cuh.
//
// Design: one thread per pixel runs the whole program (primary hit,
// G-buffer rows, both subpaths, the three estimator families).  The TPU
// kernel kept 1024 pixels in [8, 128] vector tiles and tested triangles in
// [T, 128] pair tiles with a one-hot MXU fetch of the winner; none of that
// carries over.  Here d_max is a template parameter (1..8), so the camera
// and light vertex arrays unroll; at large d they spill to local memory.
//
// What bounds it on the H100: the brute-force triangle loops (about 16 rays
// a pixel at d=3, each over every triangle) and the divergence between the
// pixels of a warp.  The design keeps the 12 Baldwin-Weber floats of every
// triangle in dynamic shared memory (96 KB at the gate's 2048 triangles,
// which needs the opt-in above 48 KB), so every ray-triangle test reads
// shared memory; the winner's 36 attribute floats are read once a hit from
// global memory.  Outputs are field-major [rows, W*H], so a warp's stores
// coalesce.  Splat pixel ids and rgb8e payloads are int32 outputs of their
// own.
//
// The textured variant (Textured = true, d_max 1..4, the TPU kernel's
// textured=True program) stores the deferred-texture records and raw
// estimator parts to their own field-major outputs as each is produced,
// in place of the own-pixel result; the untextured instantiations are
// unchanged by it.
#include <cuda_runtime.h>

#include "frame_program.cuh"

namespace bdpt {

constexpr int kFrameThreads = 128;

template <int D, bool Textured>
__global__ void __launch_bounds__(kFrameThreads)
    frame_kernel(FrameParams p, const float* __restrict__ lights,
                 const float* __restrict__ tris, FrameOutPtrs out) {
  extern __shared__ float bw_smem[];
  const int n_bw = p.n_tris * kBwCols;
  for (int i = threadIdx.x; i < n_bw; i += blockDim.x)
    bw_smem[i] = tris[(i / kBwCols) * kPackCols + (i % kBwCols)];
  __syncthreads();
  const int lin = blockIdx.x * blockDim.x + threadIdx.x;
  if (lin >= p.width * p.height) return;
  frame_pixel<D, Textured>(p, lights, bw_smem, tris, lin, out);
}

template <int D, bool Textured = false>
int launch_frame(const FrameParams& p, const float* lights, const float* tris,
                 const FrameOutPtrs& out, cudaStream_t stream) {
  const int n = p.width * p.height;
  const size_t smem = (size_t)(p.n_tris > 0 ? p.n_tris : 1) * kBwCols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      frame_kernel<D, Textured>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kFrameThreads - 1) / kFrameThreads);
  frame_kernel<D, Textured><<<grid, kFrameThreads, smem, stream>>>(p, lights, tris, out);
  return (int)cudaGetLastError();
}

}  // namespace bdpt

extern "C" int bdpt_frame_launch(const bdpt::FrameParams* params, int d_max,
                                 const float* lights, const float* tris, float* res,
                                 float* gbuf, int* splat_pix, int* splat_pay,
                                 float* splat_rgba, void* stream) {
  const bdpt::FrameParams& p = *params;
  const bdpt::FrameOutPtrs out = {res, gbuf, splat_pix, splat_pay, splat_rgba,
                                  nullptr, nullptr, nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  switch (d_max) {
    case 1: return bdpt::launch_frame<1>(p, lights, tris, out, s);
    case 2: return bdpt::launch_frame<2>(p, lights, tris, out, s);
    case 3: return bdpt::launch_frame<3>(p, lights, tris, out, s);
    case 4: return bdpt::launch_frame<4>(p, lights, tris, out, s);
    case 5: return bdpt::launch_frame<5>(p, lights, tris, out, s);
    case 6: return bdpt::launch_frame<6>(p, lights, tris, out, s);
    case 7: return bdpt::launch_frame<7>(p, lights, tris, out, s);
    case 8: return bdpt::launch_frame<8>(p, lights, tris, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int bdpt_frame_textured_launch(const bdpt::FrameParams* params, int d_max,
                                          const float* lights, const float* tris, float* gbuf,
                                          int* splat_pix, float* splat_rgba, float* vrec,
                                          float* e1, float* e3, void* stream) {
  const bdpt::FrameParams& p = *params;
  const bdpt::FrameOutPtrs out = {nullptr, gbuf, splat_pix, nullptr, splat_rgba,
                                  vrec, e1, e3};
  cudaStream_t s = (cudaStream_t)stream;
  if (p.splat_rgb8e) return (int)cudaErrorInvalidValue;
  switch (d_max) {
    case 1: return bdpt::launch_frame<1, true>(p, lights, tris, out, s);
    case 2: return bdpt::launch_frame<2, true>(p, lights, tris, out, s);
    case 3: return bdpt::launch_frame<3, true>(p, lights, tris, out, s);
    case 4: return bdpt::launch_frame<4, true>(p, lights, tris, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
