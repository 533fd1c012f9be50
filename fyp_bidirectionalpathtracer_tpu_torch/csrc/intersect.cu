// Kernels K4: the wavefront's dense intersectors for Hopper (sm_90a).
//
// Three kernels replace the five TPU kernels of the dense tier, which
// compute two functions in different memory layouts:
//   closest  <- accel/pallas_intersect.py:_kernel (K4a)
//   shaded   <- accel/pallas_shaded.py:_kernel (K4c) and
//               accel/pallas_lane.py:_shaded_kernel (K4e)
//   occluded <- accel/pallas_intersect.py:_occlusion_kernel (K4b) and
//               accel/pallas_lane.py:_occlusion_kernel (K4d)
// Their wrappers and plain PyTorch versions are in accel/intersect.py.
//
// Design.  Each block stages the 12 Baldwin-Weber floats of every
// triangle in dynamic shared memory (96 KB at 2048 triangles, with the
// opt-in above 48 KB), as K1 does; every pair test then reads shared
// memory.  The rays come as eight structure-of-arrays rows [8, N] (ox oy
// oz dx dy dz tmin tmax), so a warp's loads coalesce.  The any-hit kernel
// takes one ray a thread.  The closest and shaded kernels run as many
// blocks as the device holds at once (the occupancy API), each stages the
// rows once, with three 16-byte loads a row, and then takes tiles of
// kClosestThreads x kClosestRays rays in a grid-stride loop; a thread
// holds kClosestRays rays and reads each row once for all of them, with
// 16-byte shared loads (closest_tiles, closest_hit_rays: intersect.cuh).
// The winner's 33 attribute floats are read from the global pack once per
// ray, and the shaded output is field-major [32, N], so a warp's stores
// coalesce.  The TPU kernels' [T, 128] pair tiles, one-hot MXU fetch and
// 128-triangle chunks do not carry over; the strict < over ascending ids
// gives their tie rule (the lowest id wins at equal t).
//
// What bounds them on the H100: on the Cornell box (34 triangles) the bytes
// of the rays and the outputs (32 B in, 8 B for a dead ray's tmin and
// tmax; 16 B out for closest, 128 B for shaded, 1 B for occluded), at
// 3.35 TB/s; with 5 to 39 flops a pair by the test it reaches, the pair
// tests pass that bound from a few hundred triangles up (67 TFLOP/s in
// float32).  The any-hit loop stops at its first hit, and a dead ray
// needs no pair.
//
// The any-hit kernel's shadow batches are mostly dead lanes (tmax <= tmin:
// 83% of the est-3-shaped batch on Cornell, 79% on the textured room), and
// with one ray a thread a warp ran its few live lanes through every row
// while the dead ones idled.  So a block lists its live rays first (warp
// ballots into shared memory) and its threads then take only those.  On an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md) that took the launch from 0.129
// to ~0.068 ms on Cornell's batch and from 1.43 to ~0.71 on the textured
// room's (342 triangles); 1,024 rays a block beat 512, 2,048 and 4,096.
// That is 4.8x its bytes bound on Cornell (0.0143 ms) and 9.7x its
// operations bound on the textured room (0.0737 ms: the pair tests of the
// live rays alone).
// Tried on the pair loop and left out: several rays a thread against each
// row read (slower), several rows a step with 16-byte row loads (within
// 1%), a reject of the pairs whose t falls outside (tmin, tmax) before
// the division (exact, but 5-17% slower: a warp divides whenever one of
// its lanes must), and persistent warps that refill from a ring of rows
// (slower).  On
// the textured room's batch the BVH any-hit kernel's two-box walk takes
// 0.28 ms for the same answers, so the dense tier's 2048 triangles are too
// many for this kernel; the bake sets that limit.
//
// The closest and shaded kernels are issue-bound at 342 triangles (~13
// instructions a pair the direction test drops, ~33 one that reaches the
// division, in the SASS of the one-ray loop), so a row read shared by R
// rays saves little, and staging the rows once a resident block saves L2
// reads that were no bottleneck: this schedule is slower than one block a
// 256 rays, one ray a thread, at every R (PERF.md, PR 9).  In it, R = 2
// is the fastest on the G-buffer batch, R = 1 on extension batches.
//
// Miss lanes: t = tmax (the wrapper maps it to 1e30), id -1, u = v = 0,
// and every attribute field 0, as the TPU kernels' one-hot fetch gives for
// a finite tmax.  Fields 27..31 are zero.
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "intersect.cuh"

namespace bdpt {

constexpr int kRayThreads = 256;  // the any-hit kernel's threads a block
constexpr int kAnyHitChunk = 4;   // the any-hit kernel's rays a block, per thread
constexpr int kClosestThreads = 256;  // the closest and shaded kernels' threads a block
constexpr int kClosestRays = 2;       // and their rays a thread

__device__ __forceinline__ void stage_bw(float* smem, const float* __restrict__ tris,
                                         int n_tris) {
  for (int i = threadIdx.x; i < n_tris * kBwCols; i += blockDim.x)
    smem[i] = tris[(i / kBwCols) * kPackCols + (i % kBwCols)];
  __syncthreads();
}

// The rows of every triangle, a thread a row, three 16-byte loads (the
// pack's 192-byte rows keep the pack's 16-byte alignment).
__device__ __forceinline__ void stage_rows(float* smem, const float* __restrict__ tris,
                                           int n_tris) {
  for (int i = threadIdx.x; i < n_tris; i += blockDim.x) {
    const float4* src = reinterpret_cast<const float4*>(tris + (size_t)i * kPackCols);
    float4* dst = reinterpret_cast<float4*>(smem + i * kBwCols);
    const float4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2);
    dst[0] = a;
    dst[1] = b;
    dst[2] = c;
  }
  __syncthreads();
}

template <bool kCull>
__global__ void __launch_bounds__(kClosestThreads)
    closest_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                   int n_tris, float* __restrict__ t_out, int* __restrict__ id_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ __align__(16) float bw[];
  stage_rows(bw, tris, n_tris);
  closest_tiles<kClosestRays>(
      rows, (size_t)n, bw, n_tris, kCull, blockIdx.x, gridDim.x, threadIdx.x, blockDim.x,
      [&](size_t i, V3 o, V3 d, float t, int id) {
        float u = 0.0f, v = 0.0f;
        if (id >= 0) hit_uv<true>(tris + (size_t)id * kPackCols, o, d, t, u, v);
        t_out[i] = t;
        id_out[i] = id;
        u_out[i] = u;
        v_out[i] = v;
      });
}

template <bool kCull>
__global__ void __launch_bounds__(kClosestThreads)
    shaded_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                  int n_tris, float* __restrict__ out) {
  extern __shared__ __align__(16) float bw[];
  stage_rows(bw, tris, n_tris);
  const size_t N = (size_t)n;
  closest_tiles<kClosestRays>(
      rows, N, bw, n_tris, kCull, blockIdx.x, gridDim.x, threadIdx.x, blockDim.x,
      [&](size_t i, V3 o, V3 d, float t, int id) {
        float f[kOutW];
        hit_fields(tris, id, t, o, d, f);
#pragma unroll
        for (int k = 0; k < kOutW; ++k) out[k * N + i] = f[k];
      });
}

// The any-hit kernel.  A block takes kRayThreads x kAnyHitChunk rays: it
// answers the dead ones (tmax <= tmin) at once, lists the others in shared
// memory behind the rows (a warp's live lanes in order), then its threads
// take the listed rays in turn, one a thread.
__global__ void __launch_bounds__(kRayThreads)
    occluded_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                    int n_tris, bool* __restrict__ out) {
  extern __shared__ float bw[];
  int* live = reinterpret_cast<int*>(bw + n_tris * kBwCols);
  __shared__ int n_live;
  if (threadIdx.x == 0) n_live = 0;
  stage_bw(bw, tris, n_tris);
  constexpr unsigned kFull = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  const int base = blockIdx.x * (kRayThreads * kAnyHitChunk);
#pragma unroll
  for (int k = 0; k < kAnyHitChunk; ++k) {
    const int i = base + k * kRayThreads + threadIdx.x;
    bool is_live = false;
    if (i < n) {
      is_live = rows[7 * (size_t)n + i] > rows[6 * (size_t)n + i];
      if (!is_live) out[i] = false;
    }
    const unsigned m = __ballot_sync(kFull, is_live);
    int slot = 0;
    if (lane == 0 && m) slot = atomicAdd(&n_live, __popc(m));
    slot = __shfl_sync(kFull, slot, 0);
    if (is_live) live[slot + __popc(m & ((1u << lane) - 1))] = i;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_live; j += kRayThreads) {
    const int i = live[j];
    const Ray r = load_ray(rows, (size_t)n, (size_t)i);
    out[i] = occluded<true>(bw, n_tris, r.o, r.d, r.tmin, r.tmax);
  }
}

// The blocks of `kernel` an SM holds at once with `smem` bytes of dynamic
// shared memory, times the SMs: the occupancy API's answer, read once a
// (kernel, device, smem).
static cudaError_t resident_blocks(const void* kernel, size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, dev, smem);
  std::lock_guard<std::mutex> hold(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kClosestThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, per_sm * sms).first;
  }
  *blocks = it->second;
  return cudaSuccess;
}

// A closest or shaded kernel: the resident blocks, or fewer where the rays
// fill fewer tiles.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int n, int n_tris, cudaStream_t stream, Args... args) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)(n_tris > 0 ? n_tris : 1) * kBwCols * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess) err = resident_blocks((const void*)kernel, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const int tile = kClosestThreads * kClosestRays;
  const int tiles = (n + tile - 1) / tile;
  const int grid = tiles < blocks ? tiles : blocks;
  kernel<<<grid, kClosestThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace bdpt

extern "C" int bdpt_intersect_closest(const float* rows, int n, const float* tris, int n_tris,
                                      int cull_backface, float* t, int* id, float* u, float* v,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cull_backface)
    return bdpt::launch(bdpt::closest_kernel<true>, n, n_tris, s, rows, n, tris, n_tris, t,
                        id, u, v);
  return bdpt::launch(bdpt::closest_kernel<false>, n, n_tris, s, rows, n, tris, n_tris, t, id,
                      u, v);
}

extern "C" int bdpt_intersect_shaded(const float* rows, int n, const float* tris, int n_tris,
                                     int cull_backface, float* fields, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cull_backface)
    return bdpt::launch(bdpt::shaded_kernel<true>, n, n_tris, s, rows, n, tris, n_tris,
                        fields);
  return bdpt::launch(bdpt::shaded_kernel<false>, n, n_tris, s, rows, n, tris, n_tris, fields);
}

extern "C" int bdpt_occluded(const float* rows, int n, const float* tris, int n_tris,
                             bool* occ, void* stream) {
  using namespace bdpt;
  if (n <= 0) return 0;
  const int per_block = kRayThreads * kAnyHitChunk;
  const size_t smem = (size_t)n_tris * kBwCols * sizeof(float) + per_block * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(occluded_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  occluded_kernel<<<(n + per_block - 1) / per_block, kRayThreads, smem, (cudaStream_t)stream>>>(
      rows, n, tris, n_tris, occ);
  return (int)cudaGetLastError();
}
