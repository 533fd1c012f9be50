// The two-box walks of the BVH kernels (bvh.cu): the any-hit walk of
// bvh_occluded_*, which replaces the TPU's cluster and HBM any-hit tiers
// K4f and K4i, and the closest-hit walk of bvh_closest_* and bvh_shaded_*,
// which replaces the closest and shaded tiers K4g, K4h and K4j.  Plain C++
// apart from BDPT_DEV, the rounding intrinsics (common.cuh) and `load4`, a
// 16-byte read: the device's __ldg here, a memcpy in a CPU harness, which
// defines `float4` and `load4` before it includes this header.
//
// The tree is the bake's BVH in two-box form (accel/cluster.
// pack_bvh_pairs): one kPairCols-float row (64 bytes, four 16-byte loads)
// for each inner node, holding both children's padded boxes and links,
// after Aila and Laine's node ("Understanding the Efficiency of Ray
// Traversal on GPUs", HPG 2009):
//   [0:6]   child 0: min xyz, max xyz
//   [6:12]  child 1: min xyz, max xyz
//   [12:14] the children's links, int32 in float bits: the child's row
//           (>= 0) for an inner child, ~((first << 3) | count) for a leaf
//   [14:16] zero
// Row 0 is the root.  The boxes are those of the node table
// (accel/cluster.pack_bvh_nodes), padded alike, and leaves read the
// Baldwin-Weber rows [T_pad, kBwCols] in leaf order (BakedScene.bw_rows),
// three 16-byte loads a triangle.
//
// A ray tests both boxes of a row at once, goes on into the nearer child
// (by widened slab entry) and pushes the farther one when both are hit;
// a leaf's triangles take a step each.  The any-hit walk stops at its
// first valid pair.  The closest-hit walk tests the boxes against its best
// t so far, so once the nearer subtree has given a hit, the farther boxes
// fall away when their row is read.  (Keeping each pushed child's slab
// entry on the stack, to drop it at the pop, measured 1-6% slower on
// pink_room: an 8-byte stack entry costs more than the rows it saves;
// PERF.md.)  The stack holds at most one entry for each inner node on the
// path from the root, so kStackSize bounds the tree's depth: the bake
// raises on a deeper tree, and no walk overflows.
//
// The answers are bit for bit the dense ones (intersect.cuh occluded<true>
// and closest_hit<true>), whatever the order of the walk: the pair test is
// intersect.cuh's with rounded single operations; the culling is bvh.cuh's
// (slab_box: padded boxes, the kSlabEps widening, its NaN rules),
// conservative and inclusive (te <= best t), so no box that holds a valid
// pair at the best t is culled; and the closest walk takes the lowest (t,
// id): a valid pair wins when t < best t, or t equals it and its id is
// lower.  The root's own box is not tested, which only visits more.
#pragma once

#include "bvh.cuh"

#ifdef __CUDACC__
BDPT_DEV float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
#endif

namespace bdpt {

constexpr int kPairCols = 16;
constexpr int kStackSize = 32;
// a step's outcome; kClear: the walk is over (for any hit: not occluded)
enum { kWalking = 0, kOccluded = 1, kClear = 2 };

// The next pushed child of a walk (AnyHitWalk, ClosestWalk); kClear when
// the stack runs out
template <typename Walk>
BDPT_DEV int pop(Walk& w, const int* stack) {
  if (w.sp == 0) return kClear;
  w.node = stack[--w.sp];
  return kWalking;
}

// One two-box row (w.node >= 0) of a walk (AnyHitWalk, ClosestWalk), its
// boxes tested against [w.tmin, tlim]: go on into the nearer child that
// may hold a pair, push the other if both may; kClear when the stack runs
// out.  kCount counts the rows read (two slab tests each) in `c`.  (With
// the boxes' outcome computed by selects, not branches, the any-hit
// kernel measured 3% slower; PERF.md.)
template <bool kCount, bool kFinite, typename Walk>
BDPT_DEV int walk_row(Walk& w, int* stack, const float* __restrict__ pairs, float tlim,
                      WalkCounts* c) {
  const float* nd = pairs + (size_t)w.node * kPairCols;
  const float4 a = load4(nd), b = load4(nd + 4), e = load4(nd + 8), l = load4(nd + 12);
  if (kCount) c->nodes++;
  const float lo0[3] = {a.x, a.y, a.z}, hi0[3] = {a.w, b.x, b.y};
  const float lo1[3] = {b.z, b.w, e.x}, hi1[3] = {e.y, e.z, e.w};
  float t0, t1;
  const bool h0 = slab_box<kFinite>(lo0, hi0, w.o, w.inv, w.tmin, tlim, t0);
  const bool h1 = slab_box<kFinite>(lo1, hi1, w.o, w.inv, w.tmin, tlim, t1);
  int c0 = __float_as_int(l.x), c1 = __float_as_int(l.y);
  if (h0 && h1) {
    if (t1 < t0) {
      const int nearer = c1;
      c1 = c0;
      c0 = nearer;
    }
    stack[w.sp++] = c1;
    w.node = c0;
    return kWalking;
  }
  if (!h0 && !h1) return pop(w, stack);
  w.node = h0 ? c0 : c1;
  return kWalking;
}

// ---------------------------------------------------------------- any hit
// Is the pair of the ray and the Baldwin-Weber row `r` valid in (tmin,
// tmax), with no culling?  bvh.cuh bvh_occluded's leaf test, kept apart:
// K1's textured instantiations, which inline that walk, ran 2.6% slower
// with the test factored out of it and shared (PERF.md section 6).  kCount
// counts the stages it reaches in `c`.
template <bool kCount>
BDPT_DEV bool pair_blocks(const float* __restrict__ r, V3 o, V3 d, float tmin, float tmax,
                          WalkCounts* c) {
  if (kCount) c->s1++;
  const float ndir = dot3_<true>(r[0], r[1], r[2], d.x, d.y, d.z);
  if (!(fabsf(ndir) > 1e-9f)) return false;
  if (kCount) c->s2++;
  const float t = sub_<true>(r[3], dot3_<true>(r[0], r[1], r[2], o.x, o.y, o.z)) / ndir;
  if (!(t > tmin && t < tmax)) return false;
  if (kCount) c->s3++;
  float u, v;
  hit_uv<true>(r, o, d, t, u, v);
  return u >= 0.0f && v >= 0.0f && add_<true>(u, v) <= 1.0f;
}

// One ray's walk, resumable a step at a time (the kernel interleaves
// refills with steps).  Its stack, int[kStackSize], is passed beside it:
// an array inside the struct would send the whole state to local memory,
// which each step then reads back.
struct AnyHitWalk {
  V3 o, d, inv;
  float tmin, tmax;
  int node, sp;  // node: a row (>= 0), or ~((first << 3) | count) of a leaf's rest
  bool finite;   // ray_finite: the slab tests may leave out their NaN rules
};

// Set up the walk of a ray; false for a ray that is not occluded before
// the walk starts (a NaN component, tmax <= tmin)
BDPT_DEV bool any_hit_begin(AnyHitWalk& w, V3 o, V3 d, float tmin, float tmax) {
  if (!ray_live(o, d, tmin, tmax)) return false;
  w.o = o;
  w.d = d;
  w.inv = inverse(d);
  w.tmin = tmin;
  w.tmax = tmax;
  w.node = 0;
  w.sp = 0;
  w.finite = ray_finite(o, w.inv);
  return true;
}

// One triangle of a leaf (w.node < 0): its pair test, the rest of the leaf
// left in w.node; the walk pops when the leaf is done.  A step does about
// the work of a row step, so a warp whose lanes are in rows and in leaves
// at once waits for one short step, not a whole leaf.  kCount counts the
// pair tests by stage in `c`.
template <bool kCount>
BDPT_DEV int any_hit_triangle(AnyHitWalk& w, const int* stack, const float* __restrict__ rows,
                              WalkCounts* c) {
  const int leaf = ~w.node;
  if ((leaf & 7) == 0) return pop(w, stack);
  const int i = leaf >> 3;
  w.node = ~(((i + 1) << 3) | ((leaf & 7) - 1));
  const float* p = rows + (size_t)i * kBwCols;
  const float4 q0 = load4(p), q1 = load4(p + 4), q2 = load4(p + 8);
  const float r[kBwCols] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                            q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
  return pair_blocks<kCount>(r, w.o, w.d, w.tmin, w.tmax, c) ? kOccluded : kWalking;
}

// One step: a row or a triangle; kWalking, kOccluded or kClear
template <bool kCount>
BDPT_DEV int any_hit_step(AnyHitWalk& w, int* stack, const float* __restrict__ rows,
                          const float* __restrict__ pairs, WalkCounts* c) {
  if (w.node < 0) return any_hit_triangle<kCount>(w, stack, rows, c);
  return w.finite ? walk_row<kCount, true>(w, stack, pairs, w.tmax, c)
                  : walk_row<kCount, false>(w, stack, pairs, w.tmax, c);
}

// Any hit in (tmin, tmax), no culling, over the two-box rows `pairs` and
// the Baldwin-Weber rows `rows`: the whole walk of one ray
template <bool kCount>
BDPT_DEV bool bvh_any_hit(const float* __restrict__ rows, const float* __restrict__ pairs, V3 o,
                          V3 d, float tmin, float tmax, WalkCounts* c) {
  AnyHitWalk w;
  int stack[kStackSize];
  if (!any_hit_begin(w, o, d, tmin, tmax)) return false;
  int s;
  do {
    s = any_hit_step<kCount>(w, stack, rows, pairs, c);
  } while (s == kWalking);
  return s == kOccluded;
}

// ------------------------------------------------------------ closest hit
// One ray's closest-hit walk, resumable a step at a time as AnyHitWalk;
// its stack, int[kStackSize], is passed beside it.  t is the best t so
// far (tmax until a valid pair), best its id (-1) and u, v its
// barycentrics (0 until a hit).
struct ClosestWalk {
  V3 o, d, inv;
  float tmin, tmax, t, u, v;
  int node, sp, best;
  bool finite, cull;
};

// Set up the walk of a ray; false for a ray that misses before the walk
// starts (a NaN component, tmax <= tmin), whose answer w already holds.
BDPT_DEV bool closest_begin(ClosestWalk& w, V3 o, V3 d, float tmin, float tmax, bool cull) {
  w.t = tmax;
  w.u = 0.0f;
  w.v = 0.0f;
  w.best = -1;
  if (!ray_live(o, d, tmin, tmax)) return false;
  w.o = o;
  w.d = d;
  w.inv = inverse(d);
  w.tmin = tmin;
  w.tmax = tmax;
  w.node = 0;
  w.sp = 0;
  w.finite = ray_finite(o, w.inv);
  w.cull = cull;
  return true;
}

// One triangle of a leaf: the pair test of intersect.cuh closest_hit (and
// bvh.cuh bvh_closest_hit), with or without back-face culling, which
// lowers the best (t, id) when the pair is valid and comes first by it.
template <bool kCount>
BDPT_DEV int closest_triangle(ClosestWalk& w, const int* stack, const float* __restrict__ rows,
                              WalkCounts* c) {
  const int leaf = ~w.node;
  if ((leaf & 7) == 0) return pop(w, stack);
  const int i = leaf >> 3;
  w.node = ~(((i + 1) << 3) | ((leaf & 7) - 1));
  const float* p = rows + (size_t)i * kBwCols;
  const float4 q0 = load4(p), q1 = load4(p + 4), q2 = load4(p + 8);
  const float r[kBwCols] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                            q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
  if (kCount) c->s1++;
  const V3 o = w.o, d = w.d;
  const float ndir = dot3_<true>(r[0], r[1], r[2], d.x, d.y, d.z);
  const bool dir_ok = w.cull ? (ndir < -1e-9f) : (fabsf(ndir) > 1e-9f);
  if (!dir_ok) return kWalking;
  if (kCount) c->s2++;
  const float t = sub_<true>(r[3], dot3_<true>(r[0], r[1], r[2], o.x, o.y, o.z)) / ndir;
  if (!(t > w.tmin && t < w.tmax && t <= w.t)) return kWalking;
  if (kCount) c->s3++;
  float u, v;
  hit_uv<true>(r, o, d, t, u, v);
  if (u >= 0.0f && v >= 0.0f && add_<true>(u, v) <= 1.0f && (t < w.t || i < w.best)) {
    w.t = t;
    w.best = i;
    w.u = u;
    w.v = v;
  }
  return kWalking;
}

// One step: a row or a triangle; kWalking or kClear
template <bool kCount>
BDPT_DEV int closest_step(ClosestWalk& w, int* stack, const float* __restrict__ rows,
                          const float* __restrict__ pairs, WalkCounts* c) {
  if (w.node < 0) return closest_triangle<kCount>(w, stack, rows, c);
  return w.finite ? walk_row<kCount, true>(w, stack, pairs, w.t, c)
                  : walk_row<kCount, false>(w, stack, pairs, w.t, c);
}

// Closest hit in (tmin, tmax) over the two-box rows `pairs` and the
// Baldwin-Weber rows `rows`, the whole walk of one ray: the lowest (t,
// id), its id returned with t, u and v, or -1 with t = tmax, u = v = 0.
template <bool kCount>
BDPT_DEV int bvh_closest_pairs(const float* __restrict__ rows, const float* __restrict__ pairs,
                               V3 o, V3 d, float tmin, float tmax, bool cull, float& t,
                               float& u, float& v, WalkCounts* c) {
  ClosestWalk w;
  int stack[kStackSize];
  if (closest_begin(w, o, d, tmin, tmax, cull))
    while (closest_step<kCount>(w, stack, rows, pairs, c) == kWalking) {
    }
  t = w.t;
  u = w.u;
  v = w.v;
  return w.best;
}

}  // namespace bdpt
