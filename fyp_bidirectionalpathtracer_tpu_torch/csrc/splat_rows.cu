// Kernels K5 and K3: per-pixel sums of pixel-sorted splat updates (sm_90a).
//
// K5 replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/ops/
// splat_tile.py:_kernel (launched by _tile_call); the plain PyTorch
// version is ops/splat_tile.py:reduce_rows_plain.  K3 replaces the TPU
// kernel ops/splat_tile.py:_kernel_packed; its plain version is
// ops/splat_tile.py:reduce_sorted_plain.  One kernel template carries
// both: K3 is its third payload.
//
// Input: M keys sorted ascending (a key >= n_targets is a dropped update,
// and dropped updates sort to the end) and, for K5, value rows [R, M] (R =
// 4: r, g, b, alpha; R = 3: r, g, b, alpha the update count), in float32 or
// bfloat16 (the template parameter; bf16 widens exactly by a shift); for
// K3 one row [M] of int32 rgb8e words, each decoded to (r, g, b) by
// common.cuh unpack_rgb8e, with alpha the update count.  Each pixel's run
// is added to four float32 sums one update at a time, in sorted (= source)
// order.  A stable sort of the depth-concatenated updates gives each
// pixel the order of the TPU kernel's per-segment accumulation, with no
// atomics, so the sums are deterministic and bit-equal to a sequential
// sum in sorted order (K5's plain version; K3's sums a run with a segment
// sum, within rounding of it).  An rgb8e channel is an 8-bit integer times
// a power of two, so its decode is exact and an FMA of decode and add
// rounds as the two operations do.  The TPU kernels' one-hot MXU matmul
// over 1024-pixel tiles, their K=2048 DMA blocks and their double buffer
// are TPU devices and do not carry over.
//
// Design: a block owns a tile of kTile consecutive pixels.  The keys are
// sorted, so the tile's updates are one contiguous segment; the block
// finds its two ends together, each by a 256-way search (a round probes
// 256 keys, one a thread, and keeps the interval between two probes that
// holds the bound: three dependent rounds at M = 2,764,800; 4 or 8 probes
// a thread, for fewer rounds, measured slower).  The dropped updates lie
// past the last tile's segment and no block reads them.  The block then
// stages its segment in chunks of kChunk updates into shared memory, keys
// and value rows (K3: its one row of words), each thread loading its part
// of every row before it stores any, so one round trip fetches the chunk:
// 16-byte loads where the rows are aligned, a scalar head and tail.  It
// marks where each pixel's run begins and ends in the chunk, and each
// thread adds the runs of its four pixels in order from shared memory,
// carrying the sums across chunks in registers, so the order, and the
// bits, hold whatever the run lengths.  A pixel with no update writes
// zeros; a tile with none writes zeros and reads nothing beyond its
// searches.  One launch, no host sync, no scratch beyond the output.
//
// What bounds it on the H100: bytes, the live keys and value rows read once
// and 16 B written per pixel (chip_smoke.py phases 3 and 3b count them so);
// for the estimator-2 splat at 1280x720 the 14.7 MB of output dominate.  The
// design reads each live update once, coalesced, and writes each pixel once
// with one 16-byte store (neighbouring threads on neighbouring pixels).
// What is left above the bound is latency: a block's chain of dependent
// round trips (three search rounds, one staging round a chunk), which the
// other resident blocks hide.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                    // pixels a block
constexpr int kPixPerThread = kTile / kThreads;
constexpr int kChunk = 1024;                   // updates staged at once
constexpr int kPad = 8;                        // room for a row's alignment offset

__device__ __forceinline__ int widen(int x) { return x; }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// The first index in [0, m) whose key is >= target (m if none), for the
// two targets t[0] and t[1] at once, by the whole block: a round probes
// kThreads evenly spaced keys of each bound's interval [lo, hi), one a
// thread; the probes below the target form a prefix (the keys are sorted),
// whose length c (summed over the block) leaves the bound in (probe c - 1,
// probe c].  Three rounds at M = 2,764,800.  Every thread returns both.
__device__ void block_lower_bounds(const int* __restrict__ keys, int m, const int t[2],
                                   int b[2], int* red) {
  int lo[2] = {0, 0}, hi[2] = {m, m};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  while (hi[0] > lo[0] || hi[1] > lo[1]) {
    int step[2], c[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      step[s] = (hi[s] - lo[s] + kThreads - 1) / kThreads;
      const int idx = lo[s] + threadIdx.x * step[s];
      const bool below = idx < hi[s] && __ldg(keys + idx) < t[s];
      const int count = __popc(__ballot_sync(0xffffffffu, below));
      if (lane == 0) red[s * kWarps + warp] = count;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      c[s] = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c[s] += red[s * kWarps + w];
    }
    __syncthreads();  // red is written again in the next round
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (hi[s] == lo[s]) continue;
      if (c[s] == 0) {
        hi[s] = lo[s];
        continue;
      }
      const int last_below = lo[s] + (c[s] - 1) * step[s];
      hi[s] = min(hi[s], last_below + step[s]);
      lo[s] = last_below + 1;
    }
  }
  b[0] = lo[0];
  b[1] = lo[1];
}

// One row of a chunk staged from global to shared memory in one round:
// every thread loads its part into registers (load), then stores it
// (store), so the loads of all rows are in flight together.  The row's n
// elements start `off` elements past a 16-byte boundary; the aligned body
// moves in 16-byte loads and aligned 16-byte shared stores (at most one a
// thread: n <= kChunk <= kThreads * kVec), the head and tail (fewer than
// kVec elements each) as scalars.  Shared element i lands at dst[off + i].
template <typename T>
struct RowStage {
  static constexpr int kVec = 16 / sizeof(T);
  const T* src;
  int n, off, head, n_vec, tail;
  uint4 body;
  T h, t;

  RowStage() = default;
  __device__ __forceinline__ RowStage(const T* s, int count) : src(s), n(count) {
    off = (int)((reinterpret_cast<uintptr_t>(src) / sizeof(T)) & (kVec - 1));
    head = min(n, (kVec - off) & (kVec - 1));
    n_vec = (n - head) / kVec;
    tail = head + n_vec * kVec;
  }
  __device__ __forceinline__ void load() {
    const int i = threadIdx.x;
    if (i < n_vec) body = __ldg(reinterpret_cast<const uint4*>(src + head) + i);
    if (i < head) h = __ldg(src + i);
    if (tail + i < n) t = __ldg(src + tail + i);
  }
  template <typename D>
  __device__ __forceinline__ void store(D* dst) const {
    const int i = threadIdx.x;
    D* out = dst + off;
    if (i < n_vec) {
      D* o = out + head + i * kVec;  // 16-byte aligned: off + head == 0 mod kVec
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<uint4*>(o) = body;
      } else {  // eight bfloat16, the lower half of each word first
        *reinterpret_cast<float4*>(o) = make_float4(
            __uint_as_float(body.x << 16), __uint_as_float(body.x & 0xFFFF0000u),
            __uint_as_float(body.y << 16), __uint_as_float(body.y & 0xFFFF0000u));
        *reinterpret_cast<float4*>(o + 4) = make_float4(
            __uint_as_float(body.z << 16), __uint_as_float(body.z & 0xFFFF0000u),
            __uint_as_float(body.w << 16), __uint_as_float(body.w & 0xFFFF0000u));
      }
    }
    if (i < head) out[i] = widen(h);
    if (tail + i < n) out[tail + i] = widen(t);
  }
};

// R value rows of type T; R = 3 counts the updates in alpha.  kPacked (K3):
// one row of int32 rgb8e words (T = int, R = 1), alpha the count.
template <typename T, int R, bool kPacked>
__global__ void __launch_bounds__(kThreads, 4)
    splat_rows_kernel(const int* __restrict__ keys, const T* __restrict__ vals, int m,
                      int n_targets, float4* __restrict__ out) {
  using S = std::conditional_t<kPacked, int, float>;  // a staged value
  __shared__ __align__(16) S vals_s[R][kChunk + kPad];
  __shared__ __align__(16) int keys_s[kChunk + kPad];
  __shared__ uint16_t beg_s[kTile], end_s[kTile];  // a pixel's run in the chunk
  __shared__ int red_s[2 * kWarps];
  const int p0 = blockIdx.x * kTile;
  const int targets[2] = {p0, min(p0 + kTile, n_targets)};
  float sum[kPixPerThread][4];
#pragma unroll
  for (int q = 0; q < kPixPerThread; ++q) {
    sum[q][0] = sum[q][1] = sum[q][2] = sum[q][3] = 0.0f;
    beg_s[threadIdx.x + q * kThreads] = 0;
    end_s[threadIdx.x + q * kThreads] = 0;
  }
  int seg[2];
  block_lower_bounds(keys, m, targets, seg, red_s);  // its syncs order the zeroing too
  for (int c0 = seg[0]; c0 < seg[1]; c0 += kChunk) {
    const int n = min(kChunk, seg[1] - c0);
    RowStage<int> ks(keys + c0, n);
    ks.load();
    RowStage<T> vs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vs[r] = RowStage<T>(vals + (size_t)r * m + c0, n);
      vs[r].load();
    }
    ks.store(keys_s);
#pragma unroll
    for (int r = 0; r < R; ++r) vs[r].store(vals_s[r]);
    __syncthreads();
    const int* k_s = keys_s + ks.off;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int k = k_s[i];
      if (i == 0 || k_s[i - 1] != k) beg_s[k - p0] = (uint16_t)i;
      if (i == n - 1 || k_s[i + 1] != k) end_s[k - p0] = (uint16_t)(i + 1);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPixPerThread; ++q) {
      const int px = threadIdx.x + q * kThreads;
      const int e = end_s[px];
      for (int j = beg_s[px]; j < e; ++j) {
        if constexpr (kPacked) {
          float cr, cg, cb;
          bdpt::unpack_rgb8e(vals_s[0][vs[0].off + j], cr, cg, cb);
          sum[q][0] += cr;
          sum[q][1] += cg;
          sum[q][2] += cb;
          sum[q][3] += 1.0f;
        } else {
          sum[q][0] += vals_s[0][vs[0].off + j];
          sum[q][1] += vals_s[1][vs[1].off + j];
          sum[q][2] += vals_s[2][vs[2].off + j];
          sum[q][3] += R == 4 ? vals_s[R - 1][vs[R - 1].off + j] : 1.0f;
        }
      }
      beg_s[px] = 0;
      end_s[px] = 0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPixPerThread; ++q) {
    const int pix = p0 + threadIdx.x + q * kThreads;
    if (pix < n_targets) out[pix] = make_float4(sum[q][0], sum[q][1], sum[q][2], sum[q][3]);
  }
}

template <typename T, int R, bool kPacked = false>
int launch(const int* keys, const void* vals, int m, int n_targets, float4* out,
           cudaStream_t s) {
  const int grid = (n_targets + kTile - 1) / kTile;
  if (grid == 0) return 0;
  splat_rows_kernel<T, R, kPacked><<<grid, kThreads, 0, s>>>(keys, (const T*)vals, m,
                                                             n_targets, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const int* keys, const void* vals, int n_rows, int m, int n_targets,
                float4* out, cudaStream_t s) {
  if (n_rows == 4) return launch<T, 4>(keys, vals, m, n_targets, out, s);
  if (n_rows == 3) return launch<T, 3>(keys, vals, m, n_targets, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int bdpt_splat_rows(const int* keys, const void* vals, int bf16, int n_rows,
                               int m, int n_targets, float* out, void* stream) {
  float4* o = reinterpret_cast<float4*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_rows<uint16_t>(keys, vals, n_rows, m, n_targets, o, s)
              : launch_rows<float>(keys, vals, n_rows, m, n_targets, o, s);
}

// K3: keys [m] and their rgb8e words [m] -> out [n_targets, 4]
extern "C" int bdpt_splat_reduce(const int* keys, const int* pay, int m, int n_targets,
                                 float* out, void* stream) {
  return launch<int, 1, true>(keys, pay, m, n_targets, reinterpret_cast<float4*>(out),
                              (cudaStream_t)stream);
}
