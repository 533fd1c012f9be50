// The port's one ray-triangle test and winner decode, shared by the
// wavefront's dense intersectors K4 (intersect.cu), the BVH walk (bvh.cuh)
// of the BVH kernels (bvh.cu) and of the frame megakernel K1
// (frame_program.cuh), and K1's hit decode.
//
// The test is the Baldwin-Weber form of the TPU lane kernels
// (accel/pallas_lane.py:_pair_test): each triangle is 12 floats (n, n.v0,
// r1, r1.v0, r2, r2.v0), the first 12 columns of the [T_pad, 48] pack
// (accel/tri_pack.py).  Its products and sums follow the order of the plain
// version's torch expression (accel/intersect.py:_pair_test).  With kExact
// (every pair test) each is a rounded single operation, so a kernel finds
// the same t, u and v, bit for bit, as its plain version; K1's decode of
// the winner's attributes passes false and lets the compiler contract
// them into FMAs, as the rest of its shading arithmetic.  Each loop drops
// a pair at its first failed test (`continue`).
#pragma once

#include "common.cuh"

#ifndef __CUDACC__
#include <string.h>
#endif

namespace bdpt {

constexpr int kPackCols = 48;
constexpr int kBwCols = 12;

// u, v of a hit at distance t from a triangle's row `r` (its 12
// Baldwin-Weber floats, the first columns of its pack row): the pair test
// computes them, and the closest-hit kernels recompute the winner's, as
// the TPU kernels do after their one-hot fetch of the winner's row.
template <bool kExact>
BDPT_DEV void hit_uv(const float* __restrict__ r, V3 o, V3 d, float t, float& u, float& v) {
  u = add_<kExact>(sub_<kExact>(dot3_<kExact>(r[4], r[5], r[6], o.x, o.y, o.z), r[7]),
                   mul_<kExact>(t, dot3_<kExact>(r[4], r[5], r[6], d.x, d.y, d.z)));
  v = add_<kExact>(sub_<kExact>(dot3_<kExact>(r[8], r[9], r[10], o.x, o.y, o.z), r[11]),
                   mul_<kExact>(t, dot3_<kExact>(r[8], r[9], r[10], d.x, d.y, d.z)));
}

// Closest hit over the rows `bw` (kBwCols floats a triangle) in
// (tmin, tmax): the lowest t wins, and at equal t the lowest triangle id,
// by the strict < of the TPU kernels' chunk chain
// (accel/pallas_lane.py:281-292).  A pair is valid when dir_ok (n.d <
// -1e-9 with culling, else |n.d| > 1e-9), t in range, u >= 0, v >= 0 and
// u + v <= 1, so a ray with a NaN component never hits.  Returns the id,
// or -1 with t_best = tmax.
template <bool kExact>
BDPT_DEV int closest_hit(const float* bw, int n_tris, V3 o, V3 d, float tmin, float tmax,
                         bool cull_backface, float& t_best) {
  t_best = tmax;
  int best = -1;
  for (int i = 0; i < n_tris; ++i) {
    const float* r = bw + kBwCols * i;
    float ndir = dot3_<kExact>(r[0], r[1], r[2], d.x, d.y, d.z);
    bool dir_ok = cull_backface ? (ndir < -1e-9f) : (fabsf(ndir) > 1e-9f);
    if (!dir_ok) continue;
    float t = sub_<kExact>(r[3], dot3_<kExact>(r[0], r[1], r[2], o.x, o.y, o.z)) / ndir;
    if (!(t > tmin && t < t_best)) continue;
    float u, v;
    hit_uv<kExact>(r, o, d, t, u, v);
    if (u >= 0.0f && v >= 0.0f && add_<kExact>(u, v) <= 1.0f) {
      t_best = t;
      best = i;
    }
  }
  return best;
}

// Four floats of a row, read at once: a 16-byte load of 16-byte-aligned
// rows on the device (a shared-memory broadcast when a warp's lanes read
// the same row), a memcpy on the CPU.
struct Row4 {
  float x, y, z, w;
};
BDPT_DEV Row4 row4(const float* p) {
  Row4 r;
#ifdef __CUDACC__
  const float4 q = *reinterpret_cast<const float4*>(p);
  r.x = q.x;
  r.y = q.y;
  r.z = q.z;
  r.w = q.w;
#else
  memcpy(&r, p, sizeof(r));
#endif
  return r;
}

// closest_hit<true> of R rays at once, for the dense closest and shaded
// kernels: each row `bw` (16-byte aligned) is read once for all R, as
// (n, n.v0), then (r1, r1.v0) and (r2, r2.v0) only for a ray whose t
// passes.  Each ray's operations are closest_hit<true>'s, in its order, with
// the same strict < over ascending ids, so its t (in t_best, which holds
// tmax on entry) and its id (in best, -1 on a miss) are closest_hit's bits.
template <int R>
BDPT_DEV void closest_hit_rays(const float* bw, int n_tris, const V3 (&o)[R], const V3 (&d)[R],
                               const float (&tmin)[R], bool cull_backface, float (&t_best)[R],
                               int (&best)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) best[k] = -1;
  for (int i = 0; i < n_tris; ++i) {
    const float* r = bw + kBwCols * i;
    const Row4 n = row4(r);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float ndir = dot3_<true>(n.x, n.y, n.z, d[k].x, d[k].y, d[k].z);
      const bool dir_ok = cull_backface ? (ndir < -1e-9f) : (fabsf(ndir) > 1e-9f);
      if (!dir_ok) continue;
      const float t =
          sub_<true>(n.w, dot3_<true>(n.x, n.y, n.z, o[k].x, o[k].y, o[k].z)) / ndir;
      if (!(t > tmin[k] && t < t_best[k])) continue;
      const Row4 a = row4(r + 4), b = row4(r + 8);
      const float u =
          add_<true>(sub_<true>(dot3_<true>(a.x, a.y, a.z, o[k].x, o[k].y, o[k].z), a.w),
                     mul_<true>(t, dot3_<true>(a.x, a.y, a.z, d[k].x, d[k].y, d[k].z)));
      const float v =
          add_<true>(sub_<true>(dot3_<true>(b.x, b.y, b.z, o[k].x, o[k].y, o[k].z), b.w),
                     mul_<true>(t, dot3_<true>(b.x, b.y, b.z, d[k].x, d[k].y, d[k].z)));
      if (u >= 0.0f && v >= 0.0f && add_<true>(u, v) <= 1.0f) {
        t_best[k] = t;
        best[k] = i;
      }
    }
  }
}

// Any hit in (tmin, tmax), no culling; stops at the first hit.
template <bool kExact>
BDPT_DEV bool occluded(const float* bw, int n_tris, V3 o, V3 d, float tmin, float tmax) {
  for (int i = 0; i < n_tris; ++i) {
    const float* r = bw + kBwCols * i;
    float ndir = dot3_<kExact>(r[0], r[1], r[2], d.x, d.y, d.z);
    if (!(fabsf(ndir) > 1e-9f)) continue;
    float t = sub_<kExact>(r[3], dot3_<kExact>(r[0], r[1], r[2], o.x, o.y, o.z)) / ndir;
    if (!(t > tmin && t < tmax)) continue;
    float u, v;
    hit_uv<kExact>(r, o, d, t, u, v);
    if (u >= 0.0f && v >= 0.0f && add_<kExact>(u, v) <= 1.0f) return true;
  }
  return false;
}

// w a[k] + u a[k + stride] + v a[k + 2 stride]: a vertex attribute at the
// hit (w = 1 - u - v)
template <bool kExact>
BDPT_DEV float bary_mix(const float* __restrict__ a, int k, float u, float v, float w,
                        int stride) {
  return add_<kExact>(add_<kExact>(mul_<kExact>(w, a[k]), mul_<kExact>(u, a[k + stride])),
                      mul_<kExact>(v, a[k + 2 * stride]));
}

// ---------------------------------------- the wavefront kernels' rays and fields
constexpr int kOutW = 32;    // field-major rows of the shaded output
constexpr int kAttrLo = 12;  // pack columns 12..44: attributes
constexpr int kMatLo = 27;   // pack columns 27..44 -> fields 9..26

struct Ray {
  V3 o, d;
  float tmin, tmax;
};

// ray i of the eight structure-of-arrays rows [8, n] (ox oy oz dx dy dz
// tmin tmax), so a warp's loads coalesce
BDPT_DEV Ray load_ray(const float* __restrict__ rows, size_t n, size_t i) {
  Ray r;
  r.o = mk3(rows[i], rows[n + i], rows[2 * n + i]);
  r.d = mk3(rows[3 * n + i], rows[4 * n + i], rows[5 * n + i]);
  r.tmin = rows[6 * n + i];
  r.tmax = rows[7 * n + i];
  return r;
}

// The closest and shaded kernels' schedule: block b of `blocks` takes the
// tiles b, b + blocks, ... of threads x R rays, and its thread j the rays
// j, j + threads, ..., R of them, of each tile, so a warp's loads and
// stores coalesce.  The R rays go through closest_hit_rays together (a ray
// at or past n as the empty ray: o = d = 0, t in (0, 0), which no row's
// direction test passes), then answer(i, o, d, t, id) answers each ray of
// the batch, one at a time.
template <int R, typename Answer>
BDPT_DEV void closest_tiles(const float* __restrict__ rows, size_t n, const float* bw,
                            int n_tris, bool cull_backface, size_t b, size_t blocks, size_t j,
                            size_t threads, Answer answer) {
  const size_t tile = threads * R;
  for (size_t i0 = b * tile + j; i0 < n; i0 += blocks * tile) {
    V3 o[R], d[R];
    float tmin[R], t[R];
    int id[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const size_t i = i0 + k * threads;
      Ray r;
      if (i < n) {
        r = load_ray(rows, n, i);
      } else {
        r.o = r.d = mk3(0.0f, 0.0f, 0.0f);
        r.tmin = r.tmax = 0.0f;
      }
      o[k] = r.o;
      d[k] = r.d;
      tmin[k] = r.tmin;
      t[k] = r.tmax;
    }
    closest_hit_rays<R>(bw, n_tris, o, d, tmin, cull_backface, t, id);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const size_t i = i0 + k * threads;
      if (i < n) answer(i, o[k], d[k], t[k], id[k]);
    }
  }
}

// The shaded kernels' 32 fields of a ray's closest hit (accel/intersect.py
// has the table): t, id, u, v, the interpolated normal and uv, the 18
// material floats of the winner's pack row; a miss (id -1) leaves every
// field but t and the id 0.
BDPT_DEV void hit_fields(const float* __restrict__ tris, int id, float t, V3 o, V3 d,
                         float* f) {
#pragma unroll
  for (int k = 0; k < kOutW; ++k) f[k] = 0.0f;
  f[0] = t;
  f[1] = (float)id;
  if (id < 0) return;
  const float* a = tris + (size_t)id * kPackCols;
  float u, v;
  hit_uv<true>(a, o, d, t, u, v);
  const float w = sub_<true>(sub_<true>(1.0f, u), v);
  f[2] = u;
  f[3] = v;
#pragma unroll
  for (int k = 0; k < 3; ++k) f[4 + k] = bary_mix<true>(a, kAttrLo + k, u, v, w, 3);
#pragma unroll
  for (int k = 0; k < 2; ++k) f[7 + k] = bary_mix<true>(a, 21 + k, u, v, w, 2);
#pragma unroll
  for (int k = 0; k < 18; ++k) f[9 + k] = a[kMatLo + k];
}

struct Surf {  // decoded shading data of a hit
  V3 pos, n, v, dif, spec, emissive;
  float lrough, rough, opacity, ior;
  // the deferred-texture record (K1's textured variant; dead code
  // elsewhere): uv, the base-colour and emissive slots, the base constant
  float tu, tv, bslot, eslot;
  V3 base;
};

// The winner's attributes from its pack row, then the untextured
// ShadingData decode (ops.shading.shading_from_fields), for K1.
BDPT_DEV Surf decode_hit(const float* __restrict__ tris, int id, float t, V3 o, V3 d,
                         V3 view_origin) {
  const float* a = tris + (size_t)id * kPackCols;
  float u, v;
  hit_uv<false>(a, o, d, t, u, v);
  float w = 1.0f - u - v;
  V3 n_raw = mk3(bary_mix<false>(a, 12, u, v, w, 3), bary_mix<false>(a, 13, u, v, w, 3),
                 bary_mix<false>(a, 14, u, v, w, 3));
  Surf s;
  s.pos = add3(o, scale3(d, t));
  float b0 = a[27], b1 = a[28], b2 = a[29];
  float s0 = a[31], s1 = a[32], s2 = a[33], s3 = a[34];
  bool metal_rough = a[39] == 0.0f;
  float metal = s2;
  s.dif = metal_rough ? mk3(b0 * (1.0f - metal), b1 * (1.0f - metal), b2 * (1.0f - metal))
                      : mk3(b0, b1, b2);
  s.spec = metal_rough ? mk3(0.04f * (1.0f - metal) + b0 * metal,
                             0.04f * (1.0f - metal) + b1 * metal,
                             0.04f * (1.0f - metal) + b2 * metal)
                       : mk3(s0, s1, s2);
  s.lrough = jmax(0.08f, metal_rough ? s1 : 1.0f - s3);
  s.rough = s.lrough * s.lrough;
  V3 n = normed(n_raw);
  s.v = normed(sub3(view_origin, s.pos));
  bool flip = dot3(n, s.v) <= 0.0f && a[40] > 0.5f;
  s.n = flip ? neg3(n) : n;
  s.emissive = mk3(a[35], a[36], a[37]);
  s.opacity = a[30];
  s.ior = a[38];
  s.tu = bary_mix<false>(a, 21, u, v, w, 2);
  s.tv = bary_mix<false>(a, 22, u, v, w, 2);
  s.bslot = a[41];
  s.eslot = a[43];
  s.base = mk3(b0, b1, b2);
  return s;
}

}  // namespace bdpt
