// Kernel K5: per-pixel sums of pixel-sorted splat value rows (sm_90a).
//
// Replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/ops/
// splat_tile.py:_kernel (launched by _tile_call); the plain PyTorch
// version is ops/splat_tile.py:reduce_rows_plain.
//
// Input: M keys sorted ascending (a key >= n_targets is a dropped update,
// and dropped updates sort to the end) and value rows [R, M] (R = 4: r, g,
// b, alpha; R = 3: r, g, b, alpha the update count), in float32 or
// bfloat16 (the template parameter; bf16 widens exactly by a shift).  One
// thread per pixel binary-searches its run and adds the run's rows to four
// float32 sums one update at a time, in sorted (= source) order.  A stable
// sort of the depth-concatenated updates gives each pixel the order of the
// TPU kernel's per-segment accumulation, with no atomics, so the sums are
// deterministic and bit-equal to the plain version's.  The TPU kernel's
// one-hot MXU matmul over 1024-pixel tiles, its K=2048 DMA blocks and its
// double buffer are TPU devices and do not carry over.
//
// What bounds it on the H100: the dependent loads of the binary search
// (2 x ~22 steps at U = 2,764,800, mostly L2 hits), then the strided row
// reads of a run and the 16-byte store per pixel; the bytes bound is each
// live key and value read once and each pixel written once (the dropped
// updates past the last run are never read).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const uint16_t* p) {
  return __uint_as_float((uint32_t)(*p) << 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    splat_rows_kernel(const int* __restrict__ keys, const T* __restrict__ vals, int n_rows,
                      int m, int n_targets, float4* __restrict__ out) {
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
  float r = 0.0f, g = 0.0f, b = 0.0f, a = 0.0f;
  for (int i = start; i < lo; ++i) {
    r += load_val(vals + i);
    g += load_val(vals + (size_t)m + i);
    b += load_val(vals + 2 * (size_t)m + i);
    a += n_rows == 4 ? load_val(vals + 3 * (size_t)m + i) : 1.0f;
  }
  out[pix] = make_float4(r, g, b, a);
}

}  // namespace

extern "C" int bdpt_splat_rows(const int* keys, const void* vals, int bf16, int n_rows,
                               int m, int n_targets, float* out, void* stream) {
  const int grid = (n_targets + kThreads - 1) / kThreads;
  if (grid == 0) return 0;
  float4* o = reinterpret_cast<float4*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    splat_rows_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        keys, (const uint16_t*)vals, n_rows, m, n_targets, o);
  else
    splat_rows_kernel<float><<<grid, kThreads, 0, s>>>(
        keys, (const float*)vals, n_rows, m, n_targets, o);
  return (int)cudaGetLastError();
}
