// The per-ray walk of the bake's threaded BVH: the device code of every ray
// query of the frame megakernel's textured variant K1 (frame_program.cuh),
// and of the counting walks of bvh.cu (the closest-hit kernels ran it
// before their two-box walk); its slab test serves the BVH kernels'
// two-box walks (bvh_pairs.cuh).  Plain C++ apart from BDPT_DEV and the
// rounding intrinsics (common.cuh), so it also compiles for the CPU.
//
// The Baldwin-Weber row of triangle i is read at tris + i * kStride: the
// counting walks pass the [T_pad, 48] pack (kStride = kPackCols) from
// global memory, K1 its 12-float rows in shared memory (kStride =
// kBwCols).
//
// The walk is JAX `intersect_bvh` (accel/traverse.py:207-286) with one
// thread a ray in place of the lockstep vector loop: a cursor steps through
// the pre-order node table, cursor = slab hit ? (leaf ? miss : next) : miss,
// and a leaf runs its <= 7 pair tests (the bake's leaf_size is 4).  Each pair
// test is the Baldwin-Weber test of intersect.cuh with rounded single
// operations, so t, u and v are bit for bit those of the dense plain
// versions (accel/intersect.py), whatever the order of the walk:
//   - ties go by (t, id): a valid pair wins when t < best t, or t equals it
//     and its id is lower.  Validity is tested against the ray's own tmax,
//     not against the best t, so a later lower-id tie still wins;
//   - culling is conservative: the bake pads every node box by a margin
//     relative to the scene's size (accel/cluster.pack_bvh_nodes), and the
//     slab interval is widened by kSlabEps relative, before it is tested
//     inclusively (t_enter <= best t);
//   - a direction component of 0 makes (box - o) / d NaN where o lies on
//     the box's face (0 * inf); such an axis then bounds nothing;
//   - a ray with a NaN component, or tmax <= tmin (the pre-masked shadow
//     lanes), is a miss and not occluded before the walk starts.
//
// Node rows, kNodeCols floats: min xyz, max xyz, then two ints in float
// bits: the miss link, and -1 for an inner node or (first << 3) | count
// for a leaf.
#pragma once

#include "intersect.cuh"

namespace bdpt {

constexpr int kNodeCols = 8;
constexpr float kSlabEps = 1e-5f;

// What the walk did, for the counting instantiation (kCount): node rows
// read (one slab test each) and pair tests by the stage they reach: n.d;
// t where the direction test passes; u and v where t is in range.
struct WalkCounts {
  int nodes, s1, s2, s3;
};

BDPT_DEV float nan_to(float x, float fallback) { return x == x ? x : fallback; }

// May the box [lo, hi] hold a pair the walk still wants, one with t in
// [tmin, tlim]?  `inv` is 1 / d, component by component.  `te` is the
// widened slab entry, the nearer-first key of the two-box walks
// (bvh_pairs.cuh).  kFinite: the caller knows that o and inv are finite
// and inv has no zero (ray_finite), so no endpoint is NaN and the NaN rules
// are no-ops, left out; that takes a sixth off the any-hit kernel's time
// on pink_room's shadow rays (PERF.md section 6).
template <bool kFinite = false>
BDPT_DEV bool slab_box(const float lo[3], const float hi[3], V3 o, V3 inv, float tmin,
                       float tlim, float& te) {
  const float ov[3] = {o.x, o.y, o.z};
  const float iv[3] = {inv.x, inv.y, inv.z};
  te = -INFINITY;
  float tx = INFINITY;
  for (int k = 0; k < 3; ++k) {
    const float a = mul_<true>(sub_<true>(lo[k], ov[k]), iv[k]);
    const float b = mul_<true>(sub_<true>(hi[k], ov[k]), iv[k]);
    if (kFinite) {
      te = fmaxf(te, fminf(a, b));
      tx = fminf(tx, fmaxf(a, b));
    } else {
      te = fmaxf(te, fminf(nan_to(a, -INFINITY), nan_to(b, -INFINITY)));
      tx = fminf(tx, fmaxf(nan_to(a, INFINITY), nan_to(b, INFINITY)));
    }
  }
  // te = +inf or tx = -inf (the ray never enters) give NaN here: culled
  te = sub_<true>(te, mul_<true>(kSlabEps, fabsf(te)));
  tx = add_<true>(tx, mul_<true>(kSlabEps, fabsf(tx)));
  return te <= tx && tx >= tmin && te <= tlim;
}

// slab_box on the box of node row `nd`
BDPT_DEV bool slab_visit(const float* __restrict__ nd, V3 o, V3 inv, float tmin, float tlim) {
  float te;
  return slab_box(nd, nd + 3, o, inv, tmin, tlim, te);
}

BDPT_DEV bool ray_live(V3 o, V3 d, float tmin, float tmax) {
  return tmax > tmin && o.x == o.x && o.y == o.y && o.z == o.z && d.x == d.x &&
         d.y == d.y && d.z == d.z;
}

BDPT_DEV V3 inverse(V3 d) { return mk3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z); }

// (box - o) * inv is never NaN for a finite box: no 0 * inf, no inf - inf
BDPT_DEV bool ray_finite(V3 o, V3 inv) {
  return isfinite(o.x) && isfinite(o.y) && isfinite(o.z) && isfinite(inv.x) &&
         isfinite(inv.y) && isfinite(inv.z) && inv.x != 0.0f && inv.y != 0.0f &&
         inv.z != 0.0f;
}

// Closest hit in (tmin, tmax) over the rows `tris` (kStride floats a
// triangle, the Baldwin-Weber row first): the lowest (t, id).  Returns the
// id, or -1 with t_best = tmax.
template <bool kCount, int kStride>
BDPT_DEV int bvh_closest_hit(const float* __restrict__ tris, const float* __restrict__ nodes,
                             V3 o, V3 d, float tmin, float tmax, bool cull_backface,
                             float& t_best, WalkCounts* c) {
  t_best = tmax;
  int best = -1;
  if (!ray_live(o, d, tmin, tmax)) return best;
  const V3 inv = inverse(d);
  int node = 0;
  while (node >= 0) {
    const float* nd = nodes + (size_t)node * kNodeCols;
    if (kCount) c->nodes++;
    const int miss = __float_as_int(nd[6]);
    const int leaf = __float_as_int(nd[7]);
    if (!slab_visit(nd, o, inv, tmin, t_best)) {
      node = miss;
      continue;
    }
    if (leaf < 0) {
      ++node;
      continue;
    }
    for (int i = leaf >> 3, end = (leaf >> 3) + (leaf & 7); i < end; ++i) {
      const float* r = tris + (size_t)i * kStride;
      if (kCount) c->s1++;
      const float ndir = dot3_<true>(r[0], r[1], r[2], d.x, d.y, d.z);
      const bool dir_ok = cull_backface ? (ndir < -1e-9f) : (fabsf(ndir) > 1e-9f);
      if (!dir_ok) continue;
      if (kCount) c->s2++;
      const float t = sub_<true>(r[3], dot3_<true>(r[0], r[1], r[2], o.x, o.y, o.z)) / ndir;
      if (!(t > tmin && t < tmax && t <= t_best)) continue;
      if (kCount) c->s3++;
      float u, v;
      hit_uv<true>(r, o, d, t, u, v);
      if (u >= 0.0f && v >= 0.0f && add_<true>(u, v) <= 1.0f && (t < t_best || i < best)) {
        t_best = t;
        best = i;
      }
    }
    node = miss;
  }
  return best;
}

// Any hit in (tmin, tmax), no culling; stops at the first valid pair.
template <bool kCount, int kStride>
BDPT_DEV bool bvh_occluded(const float* __restrict__ tris, const float* __restrict__ nodes,
                           V3 o, V3 d, float tmin, float tmax, WalkCounts* c) {
  if (!ray_live(o, d, tmin, tmax)) return false;
  const V3 inv = inverse(d);
  int node = 0;
  while (node >= 0) {
    const float* nd = nodes + (size_t)node * kNodeCols;
    if (kCount) c->nodes++;
    const int miss = __float_as_int(nd[6]);
    const int leaf = __float_as_int(nd[7]);
    if (!slab_visit(nd, o, inv, tmin, tmax)) {
      node = miss;
      continue;
    }
    if (leaf < 0) {
      ++node;
      continue;
    }
    for (int i = leaf >> 3, end = (leaf >> 3) + (leaf & 7); i < end; ++i) {
      const float* r = tris + (size_t)i * kStride;
      if (kCount) c->s1++;
      const float ndir = dot3_<true>(r[0], r[1], r[2], d.x, d.y, d.z);
      if (!(fabsf(ndir) > 1e-9f)) continue;
      if (kCount) c->s2++;
      const float t = sub_<true>(r[3], dot3_<true>(r[0], r[1], r[2], o.x, o.y, o.z)) / ndir;
      if (!(t > tmin && t < tmax)) continue;
      if (kCount) c->s3++;
      float u, v;
      hit_uv<true>(r, o, d, t, u, v);
      if (u >= 0.0f && v >= 0.0f && add_<true>(u, v) <= 1.0f) return true;
    }
    node = miss;
  }
  return false;
}

}  // namespace bdpt
