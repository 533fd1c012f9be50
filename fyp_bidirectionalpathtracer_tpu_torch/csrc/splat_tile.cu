// Kernel K3: per-pixel sums of pixel-sorted rgb8e splat updates (sm_90a).
//
// Replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/ops/
// splat_tile.py:_kernel_packed; the plain PyTorch version is
// ops/splat_tile.py:reduce_sorted_plain.
//
// Input: the stable-sorted live updates (keys all < n_targets) and their
// rgb8e payloads.  One thread per pixel binary-searches its run [lo, hi)
// of equal keys, decodes and sums the run in sorted (= source, depth-major)
// order, and writes (r, g, b, hi - lo) as one float4: a deterministic sum,
// with no atomics.  The TPU kernel's one-hot MXU matmul over 1024-pixel
// tiles is a TPU device and does not carry over.
//
// What bounds it on the H100: the dependent loads of the two binary
// searches (about 2 x 19 steps at ~0.4M live updates, mostly L2 hits), then
// the run reads and the 16-byte store per pixel (14.7 MB at 720p).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    splat_reduce_kernel(const int* __restrict__ keys, const int* __restrict__ pay, int m,
                        int n_targets, float4* __restrict__ out) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_targets) return;
  int lo = 0, hi = m;
  while (lo < hi) {  // first key >= pix
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < pix) lo = mid + 1; else hi = mid;
  }
  const int start = lo;
  hi = m;
  while (lo < hi) {  // first key > pix
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= pix) lo = mid + 1; else hi = mid;
  }
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int i = start; i < lo; ++i) {
    float cr, cg, cb;
    bdpt::unpack_rgb8e(pay[i], cr, cg, cb);
    r += cr;
    g += cg;
    b += cb;
  }
  out[pix] = make_float4(r, g, b, (float)(lo - start));
}

}  // namespace

extern "C" int bdpt_splat_reduce(const int* keys, const int* pay, int m, int n_targets,
                                 float* out, void* stream) {
  const int grid = (n_targets + kThreads - 1) / kThreads;
  if (grid == 0) return 0;
  splat_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      keys, pay, m, n_targets, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
