// Kernel K6: the fused subpath builder for Hopper (sm_90a).
//
// Replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/accel/
// pallas_subpath.py:subpath_kernel (launched by build_subpath); the plain
// PyTorch version is accel/subpath.py:subpath_plain, which lists the
// program's semantics, and the per-ray program is in subpath.cuh.
//
// Design: one thread per ray runs all n_bounces: closest hit over every
// triangle, the winner's decode, sampleBRDF (frame_program.cuh's
// sample_brdf, the transcription of pallas_subpath._sample_brdf_tiles) and
// the vertex record, written field-major [24 n_bounces, N] as each bounce
// ends, then the final state [12, N].  The TPU kernel broadcast each
// triangle as scalars against [64, 128] ray tiles and fetched the winner
// with one select a triangle; here the 12 Baldwin-Weber floats of every
// triangle sit in dynamic shared memory (as in K1) and the winner's
// attributes are read once from its global pack row.  The hit test is
// K6's own, not intersect.cuh's.  This file is compiled without FMA
// contraction (cuda.py), so each float operation is the plain version's,
// one for one.
//
// What bounds it on the H100: the pair tests, n_bounces x n_tris a live
// ray, read from shared memory (the operations bound counts them by the
// stage each pair reaches), and the divergence between the rays of a warp.
#include <cuda_runtime.h>

#include "subpath.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    subpath_kernel(const float* __restrict__ state, int n, const float* __restrict__ tris,
                   int n_tris, int n_bounces, int mat_model, int faithful_rng,
                   float* __restrict__ verts, float* __restrict__ final_state) {
  extern __shared__ float bw[];
  for (int i = threadIdx.x; i < n_tris * bdpt::kBwCols; i += blockDim.x)
    bw[i] = tris[(i / bdpt::kBwCols) * bdpt::kPackCols + (i % bdpt::kBwCols)];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  bdpt::subpath_ray(state, (size_t)n, lane, bw, tris, n_tris, n_bounces, mat_model,
                    faithful_rng, verts, final_state);
}

}  // namespace

extern "C" int bdpt_subpath(const float* state, int n, const float* tris, int n_tris,
                            int n_bounces, int mat_model, int faithful_rng, float* verts,
                            float* final_state, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)(n_tris > 0 ? n_tris : 1) * bdpt::kBwCols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(subpath_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kThreads - 1) / kThreads;
  subpath_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      state, n, tris, n_tris, n_bounces, mat_model, faithful_rng, verts, final_state);
  return (int)cudaGetLastError();
}
