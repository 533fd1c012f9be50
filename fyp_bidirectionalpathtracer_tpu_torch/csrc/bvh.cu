// The BVH kernels: the wavefront's intersectors above 2048 triangles, for
// Hopper (sm_90a).
//
// One walk (bvh.cuh) carries the contract of the TPU's five cluster and HBM
// kernels, which compute two functions and differ only in how they fit the
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
// Design: one thread a ray walks the threaded BVH from global memory.  The
// [T_pad, 48] pack is in BVH leaf order already, so leaf triangles are
// contiguous rows and ids are those of the JAX bake.  pink_room's pack is
// 2 MB and its node table 0.2 MB; at 164k triangles 31 MB and 2.6 MB: the
// 50 MB L2 holds them, so nothing is staged in shared memory.  The rays come
// as the [8, N] rows of the dense kernels and the shaded output is the same
// field-major [32, N] table (intersect.cuh hit_fields).
//
// What bounds them on the H100: the pair tests and the slab tests a ray's
// walk performs (operations), against the rays in and out and the pack and
// nodes read once (bytes).  The walk is divergent and latency-bound on its
// dependent node loads; sorting rays, wider trees and treelets in shared
// memory are later work.
#include <cuda_runtime.h>

#include "bvh.cuh"

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

__global__ void __launch_bounds__(kBvhThreads)
    bvh_occluded_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                        const float* __restrict__ nodes, bool* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rows, (size_t)n, (size_t)i);
  out[i] = bvh_occluded<false, kPackCols>(tris, nodes, r.o, r.d, r.tmin, r.tmax, nullptr);
}

// The counting instantiation: per ray, the WalkCounts of the closest walk
// (mode 0 without culling, 1 with) or the any-hit walk (mode 2), written to
// rows [4, n].  Not on the render path; the bound of a run counts with it.
__global__ void __launch_bounds__(kBvhThreads)
    bvh_count_kernel(const float* __restrict__ rows, int n, const float* __restrict__ tris,
                     const float* __restrict__ nodes, int mode, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rows, (size_t)n, (size_t)i);
  WalkCounts c = {0, 0, 0, 0};
  float t;
  if (mode == 2)
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

extern "C" int bdpt_bvh_occluded(const float* rows, int n, const float* tris, const float* nodes,
                                 bool* occ, void* stream) {
  return bdpt::launch_rays(bdpt::bvh_occluded_kernel, n, (cudaStream_t)stream, rows, n, tris,
                           nodes, occ);
}

extern "C" int bdpt_bvh_count(const float* rows, int n, const float* tris, const float* nodes,
                              int mode, int* counts, void* stream) {
  return bdpt::launch_rays(bdpt::bvh_count_kernel, n, (cudaStream_t)stream, rows, n, tris, nodes,
                           mode, counts);
}
