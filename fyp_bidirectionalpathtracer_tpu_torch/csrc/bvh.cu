// The BVH kernels: the wavefront's intersectors above 2048 triangles, for
// Hopper (sm_90a).
//
// Two walks of one BVH (bvh.cuh, bvh_anyhit.cuh) carry the contract of the
// TPU's five cluster and HBM kernels, which compute two functions and differ only in how they fit the
// triangles into VMEM, SMEM or HBM (clusters of ck triangles, per-cell
// shortlists, DMA paging):
//   closest  <- accel/pallas_cluster.py:_cluster_closest_kernel (K4h) and
//               _cluster_closest_hbm_kernel (K4j)
//   shaded   <- accel/pallas_cluster.py:_cluster_shaded_kernel (K4g)
//   occluded <- accel/pallas_cluster.py:_cluster_occlusion_kernel (K4f) and
//               _cluster_occlusion_hbm_kernel (K4i)
// Their wrappers and plain versions (the dense torch programs, which they
// equal bit for bit) are in accel/cluster.py.
//
// Design: the closest-hit kernels run one thread a ray through the
// threaded BVH from global memory (bvh.cuh).  The [T_pad, 48] pack is in
// BVH leaf order already, so leaf triangles are contiguous rows and ids are
// those of the JAX bake.  pink_room's pack is 2 MB and its node table 0.2
// MB; at 164k triangles 31 MB and 2.6 MB: the 50 MB L2 holds them, so
// nothing is staged in shared memory.  The rays come as the [8, N] rows of
// the dense kernels and the shaded output is the same field-major [32, N]
// table (intersect.cuh hit_fields).
//
// The any-hit kernel walks the two-box form of the same tree with a short
// stack, nearer child first (bvh_anyhit.cuh): a 64-byte row (four 16-byte
// loads) tests both children's boxes, and a leaf reads the 48-byte
// Baldwin-Weber rows [T_pad, 12] (three 16-byte loads a triangle) in place
// of the 192-byte pack rows.  Only rays that need a walk occupy its
// warps (see bdpt_bvh_occluded).
//
// What bounds them on the H100: the pair tests and the slab tests a ray's
// walk performs (operations), against the rays in and out and the tables
// read once (bytes).  The walks are divergent and latency-bound on their
// dependent node loads; sorting rays, wider trees and treelets in shared
// memory are later work.
#include <cuda_runtime.h>

#include "bvh_anyhit.cuh"

namespace bdpt {

constexpr int kBvhThreads = 128;

template <bool kCull>
__global__ void __launch_bounds__(kBvhThreads)
    bvh_closest_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                       const float* __restrict__ nodes, float* t_out, int* id_out, float* u_out,
                       float* v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rows, (size_t)n, (size_t)i);
  float t;
  const int id = bvh_closest_hit<false, kPackCols>(tris, nodes, r.o, r.d, r.tmin, r.tmax, kCull,
                                                   t, nullptr);
  float u = 0.0f, v = 0.0f;
  if (id >= 0) hit_uv<true>(tris + (size_t)id * kPackCols, r.o, r.d, t, u, v);
  t_out[i] = t;
  id_out[i] = id;
  u_out[i] = u;
  v_out[i] = v;
}

template <bool kCull>
__global__ void __launch_bounds__(kBvhThreads)
    bvh_shaded_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                      const float* __restrict__ nodes, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const Ray r = load_ray(rows, N, (size_t)i);
  float t;
  const int id = bvh_closest_hit<false, kPackCols>(tris, nodes, r.o, r.d, r.tmin, r.tmax, kCull,
                                                   t, nullptr);
  float f[kOutW];
  hit_fields(tris, id, t, r.o, r.d, f);
#pragma unroll
  for (int k = 0; k < kOutW; ++k) out[k * N + i] = f[k];
}

// ---- any hit: the two-box walk (bvh_anyhit.cuh) over the live rays only
// Persistent warps: the grid holds as many blocks as fit on the device at
// once, and each lane that has no ray takes the next one from a global
// counter (zeroed in the stream, no host sync).  A ray that needs no walk
// (tmax <= tmin: ~30% of a shadow batch; a NaN) is answered at once and
// its lane takes another, so only walking rays occupy the warps; a warp
// refills once kRefill of its lanes are idle, so lanes whose walks ended
// take new rays while the others walk on.  Between two refill checks each
// lane takes kSteps steps.  (Measured on the est-3 batch against a
// compaction pass ahead of one thread a ray, walking whole leaves, whole
// walks between refills, other kSteps and kRefill, capped registers and
// stacks in shared memory: all slower; PERF.md.)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRefill = 8;
constexpr int kSteps = 8;

__global__ void __launch_bounds__(kBvhThreads)
    bvh_occluded_kernel(const float* __restrict__ rows, int n, const float* __restrict__ bw,
                        const float* __restrict__ pairs, int* __restrict__ next,
                        bool* __restrict__ out) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  AnyHitWalk w;
  int stack[kStackSize];
  int ray = -1;
  bool drained = false;  // the same in every lane of the warp
  while (true) {
    const unsigned idle = __ballot_sync(kFull, ray < 0);
    if (drained) {
      if (idle == kFull) break;
    } else if (__popc(idle) >= kRefill) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, __popc(idle));
      base = __shfl_sync(kFull, base, 0);
      drained = base + __popc(idle) >= n;
      if (ray < 0) {
        const int i = base + __popc(idle & below);
        if (i < n) {
          const Ray r = load_ray(rows, (size_t)n, (size_t)i);
          if (any_hit_begin(w, r.o, r.d, r.tmin, r.tmax))
            ray = i;
          else
            out[i] = false;
        }
      }
      continue;  // lanes that drew dead rays are idle again
    }
    if (ray >= 0) {
      int st = kWalking;
      for (int s = 0; s < kSteps && st == kWalking; ++s)
        st = any_hit_step<false>(w, stack, bw, pairs, nullptr);
      if (st != kWalking) {
        out[ray] = st == kOccluded;
        ray = -1;
      }
    }
  }
}

// The counting instantiation: per ray, the WalkCounts of the closest walk
// (mode 0 without culling, 1 with), the threaded any-hit walk (mode 2) or
// the two-box any-hit walk of the any-hit kernel (mode 3: `tris` are the
// Baldwin-Weber rows, `nodes` the two-box rows, and the first count is of
// rows read, two slab tests each), written to rows [4, n].  Not on the
// render path; the bound of a run counts with it.
__global__ void __launch_bounds__(kBvhThreads)
    bvh_count_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                     const float* __restrict__ nodes, int mode, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rows, (size_t)n, (size_t)i);
  WalkCounts c = {0, 0, 0, 0};
  float t;
  if (mode == 3)
    bvh_any_hit<true>(tris, nodes, r.o, r.d, r.tmin, r.tmax, &c);
  else if (mode == 2)
    bvh_occluded<true, kPackCols>(tris, nodes, r.o, r.d, r.tmin, r.tmax, &c);
  else
    bvh_closest_hit<true, kPackCols>(tris, nodes, r.o, r.d, r.tmin, r.tmax, mode == 1, t,
                                     &c);
  out[i] = c.nodes;
  out[n + i] = c.s1;
  out[2 * n + i] = c.s2;
  out[3 * n + i] = c.s3;
}

template <typename Kernel, typename... Args>
int launch_rays(Kernel kernel, int n, cudaStream_t stream, Args... args) {
  if (n <= 0) return 0;
  kernel<<<(n + kBvhThreads - 1) / kBvhThreads, kBvhThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace bdpt

extern "C" int bdpt_bvh_closest(const float* rows, int n, const float* tris, const float* nodes,
                                int cull_backface, float* t, int* id, float* u, float* v,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cull_backface)
    return bdpt::launch_rays(bdpt::bvh_closest_kernel<true>, n, s, rows, n, tris, nodes, t, id,
                             u, v);
  return bdpt::launch_rays(bdpt::bvh_closest_kernel<false>, n, s, rows, n, tris, nodes, t, id, u,
                           v);
}

extern "C" int bdpt_bvh_shaded(const float* rows, int n, const float* tris, const float* nodes,
                               int cull_backface, float* fields, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cull_backface)
    return bdpt::launch_rays(bdpt::bvh_shaded_kernel<true>, n, s, rows, n, tris, nodes, fields);
  return bdpt::launch_rays(bdpt::bvh_shaded_kernel<false>, n, s, rows, n, tris, nodes, fields);
}

// next: one int32 of scratch, the kernel's ray counter
extern "C" int bdpt_bvh_occluded(const float* rows, int n, const float* bw, const float* pairs,
                                 bool* occ, int* next, void* stream) {
  using namespace bdpt;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  static int resident = 0;  // blocks that fit on the device at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_occluded_kernel, kBvhThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = (n + kBvhThreads - 1) / kBvhThreads;
  bvh_occluded_kernel<<<min(resident, grid), kBvhThreads, 0, s>>>(rows, n, bw, pairs, next,
                                                                  occ);
  return (int)cudaGetLastError();
}

extern "C" int bdpt_bvh_count(const float* rows, int n, const float* tris, const float* nodes,
                              int mode, int* counts, void* stream) {
  return bdpt::launch_rays(bdpt::bvh_count_kernel, n, (cudaStream_t)stream, rows, n, tris, nodes,
                           mode, counts);
}
