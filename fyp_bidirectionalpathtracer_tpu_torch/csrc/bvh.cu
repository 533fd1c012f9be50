// The BVH kernels: the wavefront's intersectors above 2048 triangles, for
// Hopper (sm_90a).
//
// Two walks of the two-box form of the bake's BVH (bvh_pairs.cuh) carry
// the contract of the TPU's five cluster and HBM kernels, which compute two
// functions and differ only in how they fit the triangles into VMEM, SMEM
// or HBM (clusters of ck triangles, per-cell shortlists, DMA paging):
//   closest  <- accel/pallas_cluster.py:_cluster_closest_kernel (K4h) and
//               _cluster_closest_hbm_kernel (K4j)
//   shaded   <- accel/pallas_cluster.py:_cluster_shaded_kernel (K4g)
//   occluded <- accel/pallas_cluster.py:_cluster_occlusion_kernel (K4f) and
//               _cluster_occlusion_hbm_kernel (K4i)
// Their wrappers and plain versions (the dense torch programs, which they
// equal bit for bit) are in accel/cluster.py.
//
// Design: a 64-byte row (four 16-byte loads) tests both children's boxes,
// the ray goes on into the nearer child and pushes the farther one on a
// short stack, and a leaf reads the 48-byte Baldwin-Weber rows [T_pad, 12]
// (three 16-byte loads a triangle).  The closest walk tests the boxes
// against its best t.  The rows are in BVH leaf order, so leaf triangles
// are contiguous and ids are those of the JAX bake.  pink_room's rows are
// 0.5 MB and its two-box table 0.2 MB; at 164k triangles 7.9 MB and 3.3
// MB (the shaded kernel's pack 2 and 31.5 MB): the 50 MB L2 holds them, so
// nothing is staged in shared memory.  The rays come as the [8, N] rows of
// the dense kernels.
//
// The kernels are persistent (rays_persistent): the grid holds as many
// blocks as fit on the device at once, and each lane that has no ray takes
// the next one from a global counter (zeroed in the stream, no host sync).
// A ray that needs no walk (tmax <= tmin: ~30% of a shadow batch; a NaN)
// is answered at once and its lane takes another, so only walking rays
// occupy the warps; a warp refills once kRefill of its lanes are idle, so
// lanes whose walks ended take new rays while the others walk on.  Between
// two refill checks each lane takes kSteps steps: a row or a triangle.
// (Measured for the any-hit kernel on the est-3 batch against a compaction
// pass ahead of one thread a ray, walking whole leaves, whole walks between
// refills, other kSteps and kRefill, capped registers and stacks in shared
// memory: all slower; PERF.md.)  A lane answers its ray where the walk
// ends, so its stores do not coalesce: the closest kernel stores 4 words a
// ray, and the shaded kernel's walk stores t and the id alone, then a
// second kernel, one thread a ray in order, reads the winner's pack row
// and writes the 32 fields (intersect.cuh hit_fields) with coalesced
// stores.
//
// What bounds them on the H100: the pair tests and the slab tests a ray's
// walk performs (operations), against the rays in and out and the tables
// read once (bytes).  The walks are divergent and latency-bound on their
// dependent row loads; sorting rays, wider trees and treelets in shared
// memory are later work.
#include <cuda_runtime.h>

#include "bvh_pairs.cuh"

namespace bdpt {

constexpr int kBvhThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRefill = 8;
constexpr int kSteps = 8;

// The persistent loop of one warp over rays [0, n) drawn from `next`:
// begin(i) sets up ray i's walk and returns false when it has answered the
// ray itself; step() takes one step of the lane's walk (kWalking while it
// goes on); finish(i, status) answers ray i when its walk ends.
template <typename Begin, typename Step, typename Finish>
BDPT_DEV void rays_persistent(int n, int* __restrict__ next, Begin begin, Step step,
                              Finish finish) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
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
        if (i < n && begin(i)) ray = i;
      }
      continue;  // lanes that drew dead rays are idle again
    }
    if (ray >= 0) {
      int st = kWalking;
      for (int s = 0; s < kSteps && st == kWalking; ++s) st = step();
      if (st != kWalking) {
        finish(ray, st);
        ray = -1;
      }
    }
  }
}

// ---- any hit
__global__ void __launch_bounds__(kBvhThreads)
    bvh_occluded_kernel(const float* __restrict__ rows, int n, const float* __restrict__ bw,
                        const float* __restrict__ pairs, int* __restrict__ next,
                        bool* __restrict__ out) {
  AnyHitWalk w;
  int stack[kStackSize];
  rays_persistent(
      n, next,
      [&](int i) {
        const Ray r = load_ray(rows, (size_t)n, (size_t)i);
        if (any_hit_begin(w, r.o, r.d, r.tmin, r.tmax)) return true;
        out[i] = false;
        return false;
      },
      [&]() { return any_hit_step<false>(w, stack, bw, pairs, nullptr); },
      [&](int i, int st) { out[i] = st == kOccluded; });
}

// ---- closest hit.  kFields: the shaded kernel's walk, which stores t and
// the id as fields 0 and 1 of the field-major table `out` [32, n]; else
// the closest kernel's record t, id, u, v.
template <bool kFields>
__global__ void __launch_bounds__(kBvhThreads)
    bvh_closest_kernel(const float* __restrict__ rows, int n, const float* __restrict__ bw,
                       const float* __restrict__ pairs, int cull, int* __restrict__ next,
                       float* __restrict__ t_out, int* __restrict__ id_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
  ClosestWalk w;
  int stack[kStackSize];
  auto answer = [&](int i) {
    if (kFields) {
      t_out[i] = w.t;
      t_out[n + i] = (float)w.best;
    } else {
      t_out[i] = w.t;
      id_out[i] = w.best;
      u_out[i] = w.u;
      v_out[i] = w.v;
    }
  };
  rays_persistent(
      n, next,
      [&](int i) {
        const Ray r = load_ray(rows, (size_t)n, (size_t)i);
        if (closest_begin(w, r.o, r.d, r.tmin, r.tmax, cull != 0)) return true;
        answer(i);
        return false;
      },
      [&]() { return closest_step<false>(w, stack, bw, pairs, nullptr); },
      [&](int i, int) { answer(i); });
}

// The shaded kernel's second pass, one thread a ray: the 32 fields of ray
// i's closest hit from the t and id its walk stored in fields 0 and 1 and
// the winner's [T_pad, 48] pack row.
__global__ void __launch_bounds__(kBvhThreads)
    bvh_fields_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                      float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const Ray r = load_ray(rows, N, (size_t)i);
  float f[kOutW];
  hit_fields(tris, (int)out[N + i], out[i], r.o, r.d, f);
#pragma unroll
  for (int k = 2; k < kOutW; ++k) out[k * N + i] = f[k];
}

// The counting instantiation: per ray, the WalkCounts of the threaded
// closest walk (mode 0 without culling, 1 with), the threaded any-hit walk
// (mode 2), the two-box any-hit walk (mode 3) or the two-box closest walk
// (mode 4 without culling, 5 with), written to rows [4, n].  For modes 3-5
// `tris` are the Baldwin-Weber rows, `nodes` the two-box rows, and the
// first count is of rows read, two slab tests each.  Not on the render
// path; the bound of a run counts with it.
__global__ void __launch_bounds__(kBvhThreads)
    bvh_count_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                     const float* __restrict__ nodes, int mode, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rows, (size_t)n, (size_t)i);
  WalkCounts c = {0, 0, 0, 0};
  float t, u, v;
  if (mode >= 4)
    bvh_closest_pairs<true>(tris, nodes, r.o, r.d, r.tmin, r.tmax, mode == 5, t, u, v, &c);
  else if (mode == 3)
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

// Zero the ray counter in the stream, then launch a persistent kernel on
// min(the blocks that fit on the device at once, the blocks n rays need).
// `resident`: the caller's cache of the first, one per kernel.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int& resident, int n, int* next, cudaStream_t stream,
                      Args... args) {
  if (n <= 0) return 0;
  const cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBvhThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = (n + kBvhThreads - 1) / kBvhThreads;
  kernel<<<min(resident, grid), kBvhThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace bdpt

// next: one int32 of scratch, the kernel's ray counter (all three)
extern "C" int bdpt_bvh_closest(const float* rows, int n, const float* bw, const float* pairs,
                                int cull_backface, float* t, int* id, float* u, float* v,
                                int* next, void* stream) {
  using namespace bdpt;
  static int resident = 0;
  return launch_persistent(bvh_closest_kernel<false>, resident, n, next, (cudaStream_t)stream,
                           rows, n, bw, pairs, cull_backface, next, t, id, u, v);
}

// tris: the [T_pad, 48] pack, whose winner rows give the fields
extern "C" int bdpt_bvh_shaded(const float* rows, int n, const float* tris, const float* bw,
                               const float* pairs, int cull_backface, float* fields, int* next,
                               void* stream) {
  using namespace bdpt;
  static int resident = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_persistent(bvh_closest_kernel<true>, resident, n, next, s, rows, n, bw,
                                    pairs, cull_backface, next, fields, (int*)nullptr,
                                    (float*)nullptr, (float*)nullptr);
  if (err != 0 || n <= 0) return err;
  bvh_fields_kernel<<<(n + kBvhThreads - 1) / kBvhThreads, kBvhThreads, 0, s>>>(rows, n, tris,
                                                                                fields);
  return (int)cudaGetLastError();
}

extern "C" int bdpt_bvh_occluded(const float* rows, int n, const float* bw, const float* pairs,
                                 bool* occ, int* next, void* stream) {
  using namespace bdpt;
  static int resident = 0;
  return launch_persistent(bvh_occluded_kernel, resident, n, next, (cudaStream_t)stream, rows,
                           n, bw, pairs, next, occ);
}

extern "C" int bdpt_bvh_count(const float* rows, int n, const float* tris, const float* nodes,
                              int mode, int* counts, void* stream) {
  using namespace bdpt;
  if (n <= 0) return 0;
  bvh_count_kernel<<<(n + kBvhThreads - 1) / kBvhThreads, kBvhThreads, 0,
                      (cudaStream_t)stream>>>(rows, n, tris, nodes, mode, counts);
  return (int)cudaGetLastError();
}
