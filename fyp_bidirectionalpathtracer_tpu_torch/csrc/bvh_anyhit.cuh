// The any-hit walk of the BVH any-hit kernel (bvh.cu bvh_occluded_*), which
// replaces the TPU's cluster and HBM any-hit tiers K4f and K4i.  Plain C++
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
// a leaf's triangles take a step each; the ray stops at its first valid
// pair.  The stack holds at most one entry for
// each inner node on the path from the root, so kStackSize bounds the
// tree's depth: the bake raises on a deeper tree, and no walk overflows.
//
// The answer is bit for bit the dense one (intersect.cuh occluded<true>):
// whether any pair is valid does not depend on the order of the walk; the
// pair test is intersect.cuh's with rounded single operations, and the
// culling is bvh.cuh's (slab_box: padded boxes, the kSlabEps widening, its
// NaN rules), conservative, so no box that holds a valid pair is culled.
// The root's own box is not tested, which only visits more.
#pragma once

#include "bvh.cuh"

#ifdef __CUDACC__
BDPT_DEV float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
#endif

namespace bdpt {

constexpr int kPairCols = 16;
constexpr int kStackSize = 32;
enum { kWalking = 0, kOccluded = 1, kClear = 2 };

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

BDPT_DEV int any_hit_pop(AnyHitWalk& w, const int* stack) {
  if (w.sp == 0) return kClear;
  w.node = stack[--w.sp];
  return kWalking;
}

// One two-box row (w.node >= 0): go on into the nearer child that may hold
// a pair, push the other if both may; kClear when the stack runs out.
// kCount counts the rows read (two slab tests each) in `c`.
template <bool kCount, bool kFinite>
BDPT_DEV int any_hit_row(AnyHitWalk& w, int* stack, const float* __restrict__ pairs,
                         WalkCounts* c) {
  const float* nd = pairs + (size_t)w.node * kPairCols;
  const float4 a = load4(nd), b = load4(nd + 4), e = load4(nd + 8), l = load4(nd + 12);
  if (kCount) c->nodes++;
  const float lo0[3] = {a.x, a.y, a.z}, hi0[3] = {a.w, b.x, b.y};
  const float lo1[3] = {b.z, b.w, e.x}, hi1[3] = {e.y, e.z, e.w};
  float t0, t1;
  const bool h0 = slab_box<kFinite>(lo0, hi0, w.o, w.inv, w.tmin, w.tmax, t0);
  const bool h1 = slab_box<kFinite>(lo1, hi1, w.o, w.inv, w.tmin, w.tmax, t1);
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
  if (!h0 && !h1) return any_hit_pop(w, stack);
  w.node = h0 ? c0 : c1;
  return kWalking;
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
  if ((leaf & 7) == 0) return any_hit_pop(w, stack);
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
  return w.finite ? any_hit_row<kCount, true>(w, stack, pairs, c)
                  : any_hit_row<kCount, false>(w, stack, pairs, c);
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

}  // namespace bdpt
