// BMFR's regression stage as one kernel, a thread block a 32x32 BMFR block
// (sm_90a).
//
// It replaces no TPU kernel: JAX's BMFR (fyp_bidirectionalpathtracer_tpu/
// passes/bmfr.py) is plain jnp.  It replaces the port's plain torch chain
// passes/bmfr.py `regression` / `regression_sharded` -> `_fit_window`
// (`_features_from_window`, `_normalize_features`, `_householder_qr_skip_ld`
// or `_householder_qr_noise`, `_back_substitute_ld` / `_back_substitute`),
// which stays the CPU path and the arithmetic this kernel follows: the same
// features, the same min/max scaling (bit for bit), the same Householder
// steps, back-substitution and fit in float32, each product and sum a
// rounded operation of its own (no contraction into an FMA); only the
// order of the sums over a block's 1,024 pixels differs (regressionCP.hlsl
// runs one compute shader a block too).
//
// What bounds it on the H100: bytes.  At 1280x720 the 984 blocks read the
// [768, 1312] window of 12 floats a pixel once (48.4 MB) and write the
// output image once (14.7 MB): 0.019 ms at 3.35 TB/s (chip_smoke.py's BMFR
// phase counts 0.0232 ms with the noisy image read a second time); its
// 0.40 G float32 operations take 0.006 ms.  The torch chain it replaces
// passed each block's [1024, 13] matrix through device memory some 20 times
// in ~720 launches.  Here a block loads its window once, coalesced (a warp
// reads one 32-pixel row of each channel), and keeps the matrix in
// registers: thread t owns the rows t + 256 k, k < 4, all 13 columns.
// The raw position, normal and albedo stay in shared memory for the fit.
// What is left is the latency of the QR's 21 dependent block reductions
// (min/max, then per column the tail norm and the dot products with the
// later columns): each is a warp butterfly and one shared-memory pass,
// double-buffered, so one __syncthreads each.  Every thread combines the
// warps' partials in one order, so every thread holds the same bits and
// takes the same branches.  Three threads back-substitute the 10 x 3
// system from R in shared memory; then every thread fits and writes its
// own pixels.  Blocks are disjoint in the output image: no atomics.
//
// Source addressing: one device reads the image at (block * 32 + local +
// offset) in jnp.pad's symmetric addressing; a rank of the row-sharded
// mode reads its halo-extended rows (32 above its first row) at the row
// shift s = g0 - row0 + 32, g0 the first block row meeting its rows, and
// mirrors columns.  The frame's offset comes from the frame counter on the
// device (`frame_number`) and the table in constant memory: no host read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kEdge = 32;
constexpr int kPixels = kEdge * kEdge;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kPixels / kThreads;  // rows a thread: tid + kThreads * k
constexpr int kFeatures = 10;
constexpr int kBuffers = 13;
constexpr int kScaled0 = 4;  // columns 4..9 (position, position^2) are min/max scaled
constexpr int kScaled = 6;
constexpr int kMaxReduce = 12;

// regressionCP.hlsl:40-58, (x, y) by frame_number % 16 (BLOCK_OFFSETS)
__constant__ int kOffsets[16][2] = {
    {-30, -30}, {-12, -22}, {-24, -2}, {-8, -16}, {-26, -24}, {-14, -4},
    {-4, -28},  {-26, -16}, {-4, -2},  {-24, -32}, {-10, -10}, {-18, -18},
    {-12, -30}, {-32, -4},  {-2, -20}, {-22, -12},
};

// Element (pixel q, channel c) of an image channel lies at p[q * sp + c * sc]:
// a contiguous [H, W, 4] image (sp 4, sc 1), a plane-major view (sp 1, sc
// H * W) or a column range of a [rows, W, 12] table (sp 12, sc 1).
struct Channel {
  const float* p;
  int sp, sc;
};

__device__ __forceinline__ float load(const Channel& ch, int64_t q, int c) {
  return __ldg(ch.p + q * ch.sp + (int64_t)c * ch.sc);
}

// jnp.pad(mode="symmetric")'s image index at idx: the edge repeated, period 2n
__device__ __forceinline__ int symmetric(int idx, int n) {
  int m = idx % (2 * n);
  if (m < 0) m += 2 * n;
  return m >= n ? 2 * n - 1 - m : m;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// random() (regressionCP.hlsl:78-87), as passes/bmfr.py `_hash_random`
__device__ __forceinline__ float hash_random(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return __fdiv_rn(__uint2float_rn(a), 4294967296.0f);  // exact: a power of two
}

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct Min {  // torch.amin: NaN propagates
  __device__ __forceinline__ float operator()(float a, float b) const {
    return bdpt::jmin(a, b);
  }
};

// Reduce M values over the block: a butterfly in each warp, lane 0 stores
// the warp's partials in buf ([M][kWarps]), one __syncthreads, then every
// thread combines the kWarps partials in warp order, so every thread ends
// with the same bits.  Successive reductions alternate between two
// buffers: a thread writes buffer b again only after the sync of the
// reduction in between, which every thread reaches after reading b.
template <int M, typename Op>
__device__ __forceinline__ void block_reduce(float (&v)[M], float* buf, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[m] = op(v[m], __shfl_xor_sync(0xffffffffu, v[m], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) buf[m * kWarps + warp] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float4 lo = reinterpret_cast<const float4*>(buf + m * kWarps)[0];
    const float4 hi = reinterpret_cast<const float4*>(buf + m * kWarps)[1];
    v[m] = op(op(op(op(op(op(op(lo.x, lo.y), lo.z), lo.w), hi.x), hi.y), hi.z), hi.w);
  }
}

struct Shared {
  float raw[9][kPixels];  // normal, position, albedo of each block pixel
  __align__(16) float red[2][kMaxReduce * kWarps];
  float piv;  // the pivot row's value of the current column
  float cmin[kScaled], span[kScaled];
  float r[kFeatures][kFeatures];  // R's first 10 columns, R[row][col]
  float qty[kFeatures][3];        // Q^T y: rows 0..9 of the colour columns
  float w[kFeatures][3];          // the weights
  int limit;
};

// One Householder column (`_householder_qr_skip_ld` / `_householder_qr_noise`
// loop body): the tail norm below the pivot row, R's column, the reflection
// of the later columns.  `lim` is the pivot row of the LD-skip variant;
// `kept` gathers the accepted columns as bits.
template <int kCol, bool kSkipLD>
__device__ __forceinline__ void qr_column(float (&a)[kRows][kBuffers], int& lim, int& kept,
                                          Shared& s) {
  const int tid = threadIdx.x;
  const int piv = kSkipLD ? lim : kCol;
  float nrm[1] = {0.0f};
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (tid + kThreads * k > piv) nrm[0] = __fadd_rn(nrm[0], __fmul_rn(a[k][kCol], a[k][kCol]));
  }
  if (tid == piv) s.piv = a[0][kCol];  // piv < 10: row piv is thread piv's k = 0
  block_reduce(nrm, s.red[1], Add());
  const float norm_sq = nrm[0], u_piv = s.piv;
  const float vec_len = sqrtf(__fadd_rn(norm_sq, __fmul_rn(u_piv, u_piv)));
  const bool accept = kSkipLD ? vec_len > 0.01f : true;
  const float u_new = __fsub_rn(u_piv, vec_len);
  const float u_len_sq = __fadd_rn(norm_sq, __fmul_rn(u_new, u_new));
  const bool reflect = kSkipLD ? (accept && u_len_sq >= 0.001f) : true;
  const float scale = reflect ? __fdiv_rn(2.0f, bdpt::jmax(u_len_sq, 1e-30f)) : 0.0f;
  // R: rows above the pivot keep the reduced column, the pivot row |v|
  if (tid < kFeatures) {
    const float rc = tid < piv ? a[0][kCol] : (tid == piv ? vec_len : 0.0f);
    s.r[tid][kCol] = accept ? rc : 0.0f;
  }
  float u[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = tid + kThreads * k;
    u[k] = row < piv ? 0.0f : (row == piv ? u_new : a[k][kCol]);
  }
  constexpr int kLater = kBuffers - 1 - kCol;
  float d[kLater];
#pragma unroll
  for (int j = 0; j < kLater; ++j) {
    d[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) d[j] = __fadd_rn(d[j], __fmul_rn(u[k], a[k][kCol + 1 + j]));
  }
  block_reduce(d, s.red[0], Add());
#pragma unroll
  for (int j = 0; j < kLater; ++j) {
    const float t = __fmul_rn(d[j], scale);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      a[k][kCol + 1 + j] = __fsub_rn(a[k][kCol + 1 + j], __fmul_rn(u[k], t));
  }
  if (kSkipLD) lim += accept ? 1 : 0;
  kept |= accept ? 1 << kCol : 0;
}

// the columns kCol..9 in order
template <int kCol, bool kSkipLD>
__device__ __forceinline__ void qr_from(float (&a)[kRows][kBuffers], int& lim, int& kept,
                                        Shared& s) {
  if constexpr (kCol < kFeatures) {
    qr_column<kCol, kSkipLD>(a, lim, kept, s);
    qr_from<kCol + 1, kSkipLD>(a, lim, kept, s);
  }
}

// `_back_substitute_ld` for colour channel c: walk the columns 9..0, taking
// pivot rows from limit - 1 down for accepted columns (R diagonal != 0)
__device__ __forceinline__ void back_substitute_ld(Shared& s, int c) {
  float wr[kFeatures];
#pragma unroll
  for (int r = 0; r < kFeatures; ++r) wr[r] = s.qty[r][c];
  int lim = s.limit - 1;
#pragma unroll
  for (int i = kFeatures - 1; i >= 0; --i) {
    const bool have = lim >= 0;
    const int piv = have ? lim : 0;
    const float diag = have ? s.r[piv][i] : 0.0f;
    const bool accepted = diag != 0.0f && have;
    float rhs = 0.0f;
#pragma unroll
    for (int r = 0; r < kFeatures; ++r) rhs = r == piv ? wr[r] : rhs;
    rhs = have ? rhs : 0.0f;
    const float wi = accepted ? __fdiv_rn(rhs, diag) : 0.0f;
    s.w[i][c] = wi;
    const int new_lim = lim - (accepted ? 1 : 0);
#pragma unroll
    for (int r = 0; r < kFeatures; ++r) {
      const float coeff = (r <= new_lim && accepted) ? s.r[r][i] : 0.0f;
      wr[r] = __fsub_rn(wr[r], __fmul_rn(coeff, wi));
    }
    lim = new_lim;
  }
}

// `_back_substitute` (full rank) for colour channel c
__device__ __forceinline__ void back_substitute(Shared& s, int c) {
  float wr[kFeatures];
#pragma unroll
  for (int r = 0; r < kFeatures; ++r) wr[r] = s.qty[r][c];
#pragma unroll
  for (int i = kFeatures - 1; i >= 0; --i) {
    const float wi = __fdiv_rn(wr[i], s.r[i][i]);
    s.w[i][c] = wi;
#pragma unroll
    for (int r = 0; r < i; ++r) wr[r] = __fadd_rn(wr[r], __fmul_rn(-s.r[r][i], wi));
  }
}

// `_normalize_features`' scaling of one value of scaled column i
__device__ __forceinline__ float scaled(float v, float cmin, float span) {
  const float d = __fsub_rn(v, cmin);
  return span > 1.0f ? __fdiv_rn(d, span) : d;
}

// grid (n_bx, n_by); src_h rows in the source (the image's height, or the
// rank's halo-extended rows when `sharded`); out [out_h, w, 4] contiguous,
// its alpha from `alpha` (channel 3) at the same pixel; `kept_out`, when
// not null, gets each block's accepted feature columns as bits.
template <bool kSkipLD>
__global__ void __launch_bounds__(kThreads, 2)
    bmfr_fit_kernel(Channel pos, Channel nrm, Channel alb, Channel rgb, Channel alpha,
                    int src_h, int w, const int* __restrict__ frame_number, int sharded,
                    int row0, float noise_scale, float4* __restrict__ out, int out_h,
                    int* __restrict__ kept_out) {
  __shared__ Shared s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int frame = __ldg(frame_number);
  const int o = ((frame % 16) + 16) % 16;
  const int off_x = kOffsets[o][0], off_y = kOffsets[o][1];
  // the sharded rank's row shift: the first block row meeting row0 starts
  // at global row g0, row s of the extended rows
  const int shift = sharded ? off_y + kEdge * floor_div(row0 - off_y, kEdge) - row0 + kEdge : 0;
  const int x = (int)blockIdx.x * kEdge + lane + off_x;  // the window column's image column
  const int sx = symmetric(x, w);

  // the feature rows [1, n, p, p^2, rgb/albedo] (`_features_from_window`)
  float a[kRows][kBuffers];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int q = (int)blockIdx.y * kEdge + warp + (kThreads / kEdge) * k;  // window row
    const int sy = sharded ? q + shift : symmetric(q + off_y, src_h);
    const int64_t pix = (int64_t)sy * w + sx;
    const int row = tid + kThreads * k;
    float al[3], c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float nv = load(nrm, pix, i), pv = load(pos, pix, i);
      al[i] = load(alb, pix, i);
      c[i] = load(rgb, pix, i);
      a[k][1 + i] = nv;
      a[k][4 + i] = pv;
      a[k][7 + i] = __fmul_rn(pv, pv);
      s.raw[i][row] = nv;
      s.raw[3 + i][row] = pv;
      s.raw[6 + i][row] = al[i];
    }
    a[k][0] = 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      a[k][10 + i] = al[i] < 0.01f ? 0.0f : __fdiv_rn(c[i], bdpt::jmax(al[i], 1e-20f));
  }

  // min/max scaling of columns 4..9 (`_normalize_features`); the maxima
  // as minima of the negated values, so one reduction carries both
  float mm[2 * kScaled];
#pragma unroll
  for (int i = 0; i < kScaled; ++i) {
    mm[i] = a[0][kScaled0 + i];
    mm[kScaled + i] = -a[0][kScaled0 + i];
#pragma unroll
    for (int k = 1; k < kRows; ++k) {
      mm[i] = bdpt::jmin(mm[i], a[k][kScaled0 + i]);
      mm[kScaled + i] = bdpt::jmin(mm[kScaled + i], -a[k][kScaled0 + i]);
    }
  }
  block_reduce(mm, s.red[0], Min());
#pragma unroll
  for (int i = 0; i < kScaled; ++i) {
    const float cmin = mm[i], span = __fsub_rn(-mm[kScaled + i], cmin);
#pragma unroll
    for (int k = 0; k < kRows; ++k) a[k][kScaled0 + i] = scaled(a[k][kScaled0 + i], cmin, span);
    if (tid == 0) {
      s.cmin[i] = cmin;
      s.span[i] = span;
    }
  }

  if (!kSkipLD) {  // the add-noise pattern on feature columns 1..9 (`_qr_noise_pattern`)
    const uint32_t base = (uint32_t)frame * (uint32_t)(kBuffers * kPixels);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const uint32_t row = (uint32_t)(tid + kThreads * k);
#pragma unroll
      for (int f = 0; f < kBuffers; ++f) {
        float noise = 0.0f;
        if (f >= 1 && f < kFeatures) {
          const float r = hash_random(row + (uint32_t)f * kPixels + base);
          noise = __fmul_rn(noise_scale, __fsub_rn(r, 0.5f));
        }
        a[k][f] = __fadd_rn(a[k][f], noise);
      }
    }
  }

  int lim = 0, kept = 0;
  qr_from<0, kSkipLD>(a, lim, kept, s);
  if (kept_out != nullptr && tid == 0) kept_out[blockIdx.y * gridDim.x + blockIdx.x] = kept;
  if (tid < kFeatures) {
#pragma unroll
    for (int c = 0; c < 3; ++c) s.qty[tid][c] = a[0][kFeatures + c];
  }
  if (tid == 0) s.limit = lim;
  __syncthreads();
  if (tid < 3) {
    if (kSkipLD) {
      back_substitute_ld(s, tid);
    } else {
      back_substitute(s, tid);
    }
  }
  __syncthreads();

  // the fit, albedo * max(x . w, 0), written where the window pixel lies
  // in the output image (its own pixel: blocks are disjoint there)
  float wt[kFeatures][3];
#pragma unroll
  for (int i = 0; i < kFeatures; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) wt[i][c] = s.w[i][c];
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int q = (int)blockIdx.y * kEdge + warp + (kThreads / kEdge) * k;
    const int ty = sharded ? q + shift - kEdge : q + off_y;
    if (ty < 0 || ty >= out_h || x < 0 || x >= w) continue;
    const int row = tid + kThreads * k;
    float xf[kFeatures];
    xf[0] = 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float pv = s.raw[3 + i][row];
      xf[1 + i] = s.raw[i][row];
      xf[4 + i] = scaled(pv, s.cmin[i], s.span[i]);
      xf[7 + i] = scaled(__fmul_rn(pv, pv), s.cmin[3 + i], s.span[3 + i]);
    }
    float res[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float f = __fmul_rn(xf[0], wt[0][c]);
#pragma unroll
      for (int i = 1; i < kFeatures; ++i) f = __fadd_rn(f, __fmul_rn(xf[i], wt[i][c]));
      res[c] = __fmul_rn(s.raw[6 + c][row], bdpt::jmax(f, 0.0f));
    }
    const int64_t t = (int64_t)ty * w + x;
    out[t] = make_float4(res[0], res[1], res[2], load(alpha, t, 3));
  }
}

}  // namespace

// BMFR's regression over a grid of n_bx x n_by 32x32 blocks; each channel
// is (pointer, pixel stride, channel stride) in floats; `frame_number` one
// int32 on the device; noise_scale is 2 * noise_amount (the add-noise
// variant, skip_ld = 0).  out: [out_h, w, 4] float32; kept: null, or
// [n_by, n_bx] int32 for each block's accepted feature columns as bits.
extern "C" int bdpt_bmfr_fit(const float* pos, int pos_sp, int pos_sc, const float* nrm,
                             int nrm_sp, int nrm_sc, const float* alb, int alb_sp, int alb_sc,
                             const float* rgb, int rgb_sp, int rgb_sc, const float* alpha,
                             int alpha_sp, int alpha_sc, int src_h, int w,
                             const int* frame_number, int sharded, int row0, int skip_ld,
                             float noise_scale, int n_bx, int n_by, float* out, int out_h,
                             int* kept, void* stream) {
  if (n_bx <= 0 || n_by <= 0 || w <= 0 || src_h <= 0) return (int)cudaErrorInvalidValue;
  const Channel cp{pos, pos_sp, pos_sc}, cn{nrm, nrm_sp, nrm_sc}, ca{alb, alb_sp, alb_sc},
      cr{rgb, rgb_sp, rgb_sc}, cal{alpha, alpha_sp, alpha_sc};
  const dim3 grid(n_bx, n_by);
  float4* o = reinterpret_cast<float4*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (skip_ld) {
    bmfr_fit_kernel<true><<<grid, kThreads, 0, s>>>(cp, cn, ca, cr, cal, src_h, w, frame_number,
                                                     sharded, row0, noise_scale, o, out_h, kept);
  } else {
    bmfr_fit_kernel<false><<<grid, kThreads, 0, s>>>(cp, cn, ca, cr, cal, src_h, w, frame_number,
                                                      sharded, row0, noise_scale, o, out_h, kept);
  }
  return (int)cudaGetLastError();
}
