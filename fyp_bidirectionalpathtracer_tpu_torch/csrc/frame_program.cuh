// The per-pixel BDPT frame program of kernel K1 (see frame.cu).
//
// A scalar transcription of the TPU kernel accel/pallas_frame.py:frame_kernel
// and of the plain version accel/frame.py:frame_plain, draw for draw: the
// same TEA/LCG sequence, the same estimator order, the same float
// expressions.  Where the TPU kernel computes a value for every lane and
// masks it away, this program skips the work when the skip cannot change
// an output (a missed primary ray, a terminated subpath, a zero throughput
// or a splat that is already dead).
//
// The Textured instantiation is the TPU kernel's textured=True program
// (pallas_frame.py:803-828, 885-944, 986-988, 1012-1052): it shades with
// each material's mean albedo and, instead of the own-pixel result, stores
// each vertex's texture record and each raw estimator part to its
// field-major output row as soon as it exists, so no record stays in a
// register; accel/frame.py:textured_replay applies the texel ratios.
//
// The ray queries (the primary hit, the subpath extensions, the NEE,
// connection and light-to-camera shadow rays) go through closest() and
// any_hit() below over the 12-float Baldwin-Weber rows `bw`, which the
// kernel (frame_launch.cuh) stages in shared memory.  The textured
// instantiations walk the bake's BVH (bvh.cuh) over the node table
// `nodes`, staged beside the rows; the walk's pair test is exact (rounded
// single operations), so for a given ray K1 finds the hit its plain
// version finds, bit for bit, and frame_textured.cu builds them without
// FMA contraction, so their rays are the plain version's too but for the
// transcendentals.  The untextured instantiations (frame.cu) keep the
// dense pair loop over every triangle, FMA-contracted like the rest of
// their arithmetic: on Cornell's 34 triangles it measured faster than the
// walk (PERF.md).
#pragma once

#include "bvh.cuh"

namespace bdpt {

struct FrameParams {  // mirrored by accel/frame.py:_FrameParams
  float scal[32];
  uint32_t bdpt_frame;
  uint32_t gbuf_frame;
  int light_count;
  int n_tris;
  int width;
  int height;
  int mat_model;
  int faithful_rng;
  int reference_quirks;
  int enable_e1;
  int enable_e2;
  int enable_e3;
  int connection_weight;  // 0 uniform, 1 power, 2 balance
  int use_thin_lens;
  int splat_rgb8e;
  float min_t;
  float clamp_upper;
  int pix0;   // the global index of the launch's first pixel (a shard's rows)
  int n_sub;  // the launch's pixels, pix0 .. pix0 + n_sub - 1: the outputs' row stride
};

// Closest hit and any hit of a ray query: the BVH walk when kWalk (the
// textured instantiations), else the dense loop over the p.n_tris rows.
template <bool kWalk>
BDPT_DEV int closest(const float* bw, const float* nodes, int n_tris, V3 o, V3 d, float tmin,
                     float tmax, bool cull_backface, float& t) {
  if constexpr (kWalk)
    return bvh_closest_hit<false, kBwCols>(bw, nodes, o, d, tmin, tmax, cull_backface, t,
                                           nullptr);
  else
    return closest_hit<false>(bw, n_tris, o, d, tmin, tmax, cull_backface, t);
}

template <bool kWalk>
BDPT_DEV bool any_hit(const float* bw, const float* nodes, int n_tris, V3 o, V3 d, float tmin,
                      float tmax) {
  if constexpr (kWalk)
    return bvh_occluded<false, kBwCols>(bw, nodes, o, d, tmin, tmax, nullptr);
  else
    return occluded<false>(bw, n_tris, o, d, tmin, tmax);
}

struct FrameOutPtrs {
  float* res;         // [4, N] (not textured)
  float* gbuf;        // [20, N]
  int* splat_pix;     // [D, N]
  int* splat_pay;     // [D, N] rgb8e (splat_rgb8e)
  float* splat_rgba;  // [D, 4, N] (otherwise)
  // textured only (accel/frame.py:FrameOut has the row tables)
  float* vrec;        // [14 D + 1, N] vertex records, then the emissive slot
  float* e1;          // [6 D, N] est-1 raw parts (enable_e1)
  float* e3;          // [4 P, N] est-3 raw shade + mask
};

// the deferred-texture record of a vertex: uv, base-colour slot and
// constant; a zero vertex has slot -1 (ratio 1) and constant 1
struct TexRec {
  float u, v, slot;
  V3 base;
};
constexpr int kRecRows = 7;  // u, v, slot, is_spec, base rgb

BDPT_DEV TexRec zero_rec() {
  TexRec r;
  r.u = r.v = 0.0f;
  r.slot = -1.0f;
  r.base = mk3(1.0f, 1.0f, 1.0f);
  return r;
}

BDPT_DEV TexRec surf_rec(const Surf& s) {
  TexRec r;
  r.u = s.tu;
  r.v = s.tv;
  r.slot = s.bslot;
  r.base = s.base;
  return r;
}

BDPT_DEV void store_rec(float* rows, size_t N, int lin, int vtx, const TexRec& r,
                        float is_spec) {
  float* o = rows + (size_t)vtx * kRecRows * N + lin;
  o[0] = r.u;
  o[N] = r.v;
  o[2 * N] = r.slot;
  o[3 * N] = is_spec;
  o[4 * N] = r.base.x;
  o[5 * N] = r.base.y;
  o[6 * N] = r.base.z;
}

BDPT_DEV void store3(float* rows, size_t N, int lin, int row, V3 c) {
  rows[(size_t)row * N + lin] = c.x;
  rows[(size_t)(row + 1) * N + lin] = c.y;
  rows[(size_t)(row + 2) * N + lin] = c.z;
}

// scalar-row layout (accel/frame.py)
enum {
  C_POS = 0, C_U = 3, C_V = 6, C_W = 9, C_N = 12, C_IU2 = 15, C_IV2 = 16,
  C_IW2 = 17, C_JX = 18, C_JY = 19, C_ENV = 20, C_LCNT = 23, C_LENSR = 24,
  C_FOCAL = 25, C_UN = 26, C_VN = 29
};
constexpr int kLightRow = 13;

struct Vtx {
  V3 color, pos, n, v, dif, spec;
  float rough, is_spec, pdf;
};

BDPT_DEV Vtx zero_vtx() {
  Vtx z;
  z.color = z.pos = z.n = z.v = z.dif = z.spec = mk3(0.0f, 0.0f, 0.0f);
  z.rough = z.is_spec = z.pdf = 0.0f;
  return z;
}

BDPT_DEV V3 perpendicular(V3 u) {
  float ax = fabsf(u.x), ay = fabsf(u.y), az = fabsf(u.z);
  bool xm = (ax - ay) < 0.0f && (ax - az) < 0.0f;
  bool ym = !xm && (ay - az) < 0.0f;
  bool zm = !(xm || ym);
  float bx = xm ? 1.0f : 0.0f, by = ym ? 1.0f : 0.0f, bz = zm ? 1.0f : 0.0f;
  return mk3(u.y * bz - u.z * by, u.z * bx - u.x * bz, u.x * by - u.y * bx);
}

// tangent = cross(bitangent, n), bitangent = normalize(perpendicular(n))
BDPT_DEV void build_onb(V3 n, V3& t, V3& b) {
  b = normalize_eps(perpendicular(n), 1e-20f);
  t = mk3(b.y * n.z - b.z * n.y, b.z * n.x - b.x * n.z, b.x * n.y - b.y * n.x);
}

BDPT_DEV float luminance(V3 c) { return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z; }

// acos by the Hastings polynomial of the TPU kernel (|err| < 7e-5 rad)
BDPT_DEV float acos_approx(float x) {
  float ax = fabsf(x);
  float p = sqrtf(jmax(0.0f, 1.0f - ax)) *
            (1.5707288f + ax * (-0.2121144f + ax * (0.0742610f + ax * -0.0187293f)));
  return x >= 0.0f ? p : kPi - p;
}

// --------------------------------------------------------------- samplers
struct BrdfSample {
  uint32_t seed;
  V3 w, l;
  float pdf;
  bool is_spec;
};

// sampleBRDF (accel/pallas_subpath.py:_sample_brdf_tiles)
BDPT_DEV BrdfSample sample_brdf(uint32_t seed, V3 n, V3 v, V3 dif, V3 spec, float rough,
                                int mat_model) {
  BrdfSample out;
  float u_lobe = 0.0f;
  if (mat_model == 0) u_lobe = next_rand(seed);  // the lobe pick is GGX-only
  float su0 = next_rand(seed);
  float su1 = next_rand(seed);
  out.seed = seed;
  V3 t, b;
  build_onb(n, t, b);
  float r_ = sqrtf(su0);
  float phi = 2.0f * kPi * su1;
  float cphi = cosf(phi), sphi = sinf(phi);
  float zc = sqrtf(jmax(0.0f, 1.0f - su0));
  V3 ld = mk3(t.x * (r_ * cphi) + b.x * (r_ * sphi) + n.x * zc,
              t.y * (r_ * cphi) + b.y * (r_ * sphi) + n.y * zc,
              t.z * (r_ * cphi) + b.z * (r_ * sphi) + n.z * zc);
  if (mat_model != 0) {  // Lambertian
    out.w = dif;
    out.l = ld;
    out.pdf = saturate(n.x * ld.x + n.y * ld.y + n.z * ld.z) * kInvPi;
    out.is_spec = false;
    return out;
  }
  float lum_d = jmax(0.01f, luminance(dif));
  float lum_s = jmax(0.01f, luminance(spec));
  float prob_diff = lum_d / (lum_d + lum_s);
  bool choose_diff = u_lobe < prob_diff;
  float a2 = rough * rough;
  float cos_th = sqrtf(jmax(0.0f, (1.0f - su0) / ((a2 - 1.0f) * su0 + 1.0f)));
  float sin_th = sqrtf(jmax(0.0f, 1.0f - cos_th * cos_th));
  float phi_h = su1 * kPi * 2.0f;
  float cph = cosf(phi_h), sph = sinf(phi_h);
  V3 h = mk3(t.x * (sin_th * cph) + b.x * (sin_th * sph) + n.x * cos_th,
             t.y * (sin_th * cph) + b.y * (sin_th * sph) + n.y * cos_th,
             t.z * (sin_th * cph) + b.z * (sin_th * sph) + n.z * cos_th);
  float vdh = v.x * h.x + v.y * h.y + v.z * h.z;
  V3 sd = normalize_eps(mk3(2.0f * vdh * h.x - v.x, 2.0f * vdh * h.y - v.y,
                            2.0f * vdh * h.z - v.z), 1e-20f);
  V3 l = choose_diff ? ld : sd;
  float ndl_any = n.x * l.x + n.y * l.y + n.z * l.z;
  bool below = ndl_any <= 0.0f;
  float ndl = saturate(ndl_any);
  float ndv_c = saturate(n.x * v.x + n.y * v.y + n.z * v.z);
  float pdf_diff = ndl * kInvPi * prob_diff;
  float ndh = saturate(n.x * h.x + n.y * h.y + n.z * h.z);
  float ldh = saturate(sd.x * h.x + sd.y * h.y + sd.z * h.z);
  float ndl_s = saturate(n.x * sd.x + n.y * sd.y + n.z * sd.z);
  float dd = (ndh * a2 - ndh) * ndh + 1.0f;
  float big_d = a2 / jmax(0.001f, dd * dd * kPi);
  float k = rough * rough / 2.0f;
  float big_g = (ndv_c / (ndv_c * (1.0f - k) + k)) * (ndl_s / (ndl_s * (1.0f - k) + k));
  float f5 = powf(jmax(0.0f, 1.0f - ldh), 5.0f);
  float ggx_prob = big_d * ndh / (4.0f * ldh);
  float gterm = big_d * big_g / (4.0f * ndl_s * ndv_c);
  float scale = ndl_s / (ggx_prob * (1.0f - prob_diff));
  V3 ws = mk3(scale * gterm * (spec.x + (1.0f - spec.x) * f5),
              scale * gterm * (spec.y + (1.0f - spec.y) * f5),
              scale * gterm * (spec.z + (1.0f - spec.z) * f5));
  out.pdf = choose_diff ? pdf_diff : ggx_prob * (1.0f - prob_diff);
  out.w = choose_diff ? mk3(dif.x / prob_diff, dif.y / prob_diff, dif.z / prob_diff) : ws;
  if (below) {
    out.pdf = 0.0f;
    out.w = mk3(0.0f, 0.0f, 0.0f);
  }
  out.l = l;
  out.is_spec = !choose_diff;
  return out;
}

// cosine-weighted direction about n (2 draws)
BDPT_DEV V3 cos_hemisphere(uint32_t& seed, V3 n) {
  float u0 = next_rand(seed);
  float u1 = next_rand(seed);
  V3 t, b;
  build_onb(n, t, b);
  float r = sqrtf(u0);
  float phi = 2.0f * kPi * u1;
  float rc = r * cosf(phi), rs = r * sinf(phi);
  float zc = sqrtf(jmax(0.0f, 1.0f - u0));
  return mk3(t.x * rc + b.x * rs + n.x * zc, t.y * rc + b.y * rs + n.y * zc,
             t.z * rc + b.z * rs + n.z * zc);
}

// rejection sample in the unit ball: at most 24 rounds of 3 draws, then (0,0,1)
BDPT_DEV V3 unit_sphere(uint32_t& seed) {
  for (int it = 0; it < 24; ++it) {
    float x = next_rand(seed);
    float y = next_rand(seed);
    float z = next_rand(seed);
    V3 p = mk3(x * 2.0f - 1.0f, y * 2.0f - 1.0f, z * 2.0f - 1.0f);
    if (dot3(p, p) <= 1.0f) return p;
  }
  return mk3(0.0f, 0.0f, 1.0f);
}

// ---------------------------------------------------------------- shading
// ops.brdf.ggx_lighting's colour term
BDPT_DEV V3 ggx_spec(V3 h, V3 l, V3 n, float n_dot_l, float n_dot_v, float rough, V3 spec) {
  float n_dot_h = saturate(dot3(n, h));
  float l_dot_h = saturate(dot3(l, h));
  float a2 = rough * rough;
  float dd = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0f;
  float d = a2 / jmax(0.001f, dd * dd * kPi);
  float k = rough * rough / 2.0f;
  float g = (n_dot_v / (n_dot_v * (1.0f - k) + k)) * (n_dot_l / (n_dot_l * (1.0f - k) + k));
  float f5 = powf(jmax(0.0f, 1.0f - l_dot_h), 5.0f);
  float scale = d * g / (4.0f * n_dot_l * n_dot_v);
  return mk3((spec.x + (1.0f - spec.x) * f5) * scale, (spec.y + (1.0f - spec.y) * f5) * scale,
             (spec.z + (1.0f - spec.z) * f5) * scale);
}

// ops.materials.eval_brdf
BDPT_DEV V3 eval_brdf(V3 v, V3 l, V3 n, V3 dif, V3 spec, float rough, bool is_spec,
                      int mat_model) {
  if (mat_model != 0) return dif;  // Lambertian: albedo (the reference omits 1/pi)
  bool below = dot3(n, l) <= 0.0f;
  V3 h = normed(add3(l, v));
  V3 out = is_spec ? ggx_spec(h, l, n, saturate(dot3(n, l)), saturate(dot3(n, v)), rough, spec)
                   : mk3(dif.x * kInvPi, dif.y * kInvPi, dif.z * kInvPi);
  return below ? mk3(0.0f, 0.0f, 0.0f) : out;
}

// ops.materials.nee_shade split into its diffuse-albedo-linear part and
// its specular part (zero for Lambertian), as the textured records need
BDPT_DEV void nee_shade_split(bool vis, V3 l, V3 inten, V3 n, V3 v, V3 dif, V3 spec,
                              float rough, float lcnt, int mat_model, V3& difp, V3& specp) {
  float n_dot_l = saturate(dot3(n, l));
  float sm = vis ? lcnt : 0.0f;
  if (mat_model != 0) {
    difp = mk3(sm * n_dot_l * inten.x * dif.x / kPi, sm * n_dot_l * inten.y * dif.y / kPi,
               sm * n_dot_l * inten.z * dif.z / kPi);
    specp = mk3(0.0f, 0.0f, 0.0f);
    return;
  }
  V3 h = normed(add3(v, l));
  float n_dot_h = saturate(dot3(n, h));
  float l_dot_h = saturate(dot3(l, h));
  float n_dot_v = saturate(dot3(n, v));
  float a2 = rough * rough;
  float dd = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0f;
  float d = a2 / jmax(0.001f, dd * dd * kPi);
  float k = rough * rough / 2.0f;
  float g = (n_dot_l / (n_dot_l * (1.0f - k) + k)) * (n_dot_v / (n_dot_v * (1.0f - k) + k));
  float f5 = powf(jmax(0.0f, 1.0f - l_dot_h), 5.0f);
  float dg4 = d * g / (4.0f * n_dot_v);
  difp = mk3(sm * inten.x * n_dot_l * dif.x * kInvPi, sm * inten.y * n_dot_l * dif.y * kInvPi,
             sm * inten.z * n_dot_l * dif.z * kInvPi);
  specp = mk3(sm * inten.x * (spec.x + (1.0f - spec.x) * f5) * dg4,
              sm * inten.y * (spec.y + (1.0f - spec.y) * f5) * dg4,
              sm * inten.z * (spec.z + (1.0f - spec.z) * f5) * dg4);
}

// ops.materials.nee_shade (diffuse plus specular part)
BDPT_DEV V3 nee_shade(bool vis, V3 l, V3 inten, V3 n, V3 v, V3 dif, V3 spec, float rough,
                      float lcnt, int mat_model) {
  V3 difp, specp;
  nee_shade_split(vis, l, inten, n, v, dif, spec, rough, lcnt, mat_model, difp, specp);
  return mat_model != 0 ? difp : add3(difp, specp);
}

struct LightEval {
  V3 l, inten;
  float dist;
};

// scene.lights.eval_light for one [13]-float light row
BDPT_DEV LightEval eval_light(const float* L, V3 surf) {
  V3 lpos = mk3(L[0], L[1], L[2]), ldir = mk3(L[3], L[4], L[5]), linten = mk3(L[6], L[7], L[8]);
  float coso = L[10], open = L[11], pen = L[12];
  V3 to_l = sub3(lpos, surf);
  float dist_sq = dot3(to_l, to_l);
  bool valid = dist_sq > 1e-5f;
  float dist_pt = valid ? sqrtf(jmax(dist_sq, 1e-20f)) : 0.0f;
  float inv = 1.0f / jmax(dist_pt, 1e-20f);
  V3 l_pt = valid ? scale3(to_l, inv) : mk3(inv * 0.0f, inv * 0.0f, inv * 0.0f);
  float falloff = 1.0f / (0.0001f + dist_sq);
  float cos_theta = -dot3(l_pt, ldir);
  if (cos_theta < coso) falloff = 0.0f;
  float pen_scale = saturate(((open - acos_approx(clip(cos_theta, -1.0f, 1.0f))) - pen) /
                             jmax(pen, 1e-9f));
  if (pen > 0.0f) falloff = falloff * pen_scale;
  V3 diff = sub3(surf, lpos);
  float dist_dir = sqrtf(jmax(dot3(diff, diff), 0.0f));
  bool is_dir = L[9] == 1.0f;  // LIGHT_DIRECTIONAL
  LightEval e;
  e.l = is_dir ? neg3(ldir) : l_pt;
  e.inten = is_dir ? linten : scale3(linten, falloff);
  V3 dvec = sub3(is_dir ? sub3(surf, scale3(ldir, dist_dir)) : lpos, surf);
  e.dist = sqrtf(jmax(dot3(dvec, dvec), 0.0f));
  return e;
}

// ------------------------------------------------------- corrected MIS
BDPT_DEV float mis_cos(const Vtx& x, V3 dn) {
  return dot3(x.n, x.n) < 0.5f ? 1.0f : fabsf(dot3(x.n, dn));
}

BDPT_DEV float log_pdf_g(const Vtx& a, const Vtx& b) {
  V3 vec = sub3(b.pos, a.pos);
  float d2 = jmax(dot3(vec, vec), 1e-30f);
  V3 dn = scale3(vec, 1.0f / sqrtf(d2));
  return logf(jmax(mis_cos(a, dn) * mis_cos(b, dn), 0.0f)) - logf(d2);
}

template <int D>
BDPT_DEV void cum_logpdf(const Vtx* path, float* lp) {
  lp[0] = logf(jmax(path[0].pdf, 0.0f));
  for (int k = 1; k <= D; ++k)
    lp[k] = lp[k - 1] + logf(jmax(path[k].pdf, 0.0f)) + log_pdf_g(path[k - 1], path[k]);
}

// max-subtracted softmax over the splits of one total length
BDPT_DEV float mis_weight(const float* lc, const float* ll, int sx, int tx, int total_len,
                          float power) {
  float m = lc[0] + ll[total_len];
  for (int i = 1; i <= total_len; ++i) m = jmax(m, lc[i] + ll[total_len - i]);
  float denom = 0.0f;
  for (int i = 0; i <= total_len; ++i) denom = denom + expf(power * ((lc[i] + ll[total_len - i]) - m));
  float cur = lc[sx] + ll[tx];
  float w = expf(power * (cur - m)) / jmax(denom, 1e-30f);
  bool finite = cur == cur && cur > -kBig && cur < kBig;
  return finite ? w : 0.0f;
}

// ------------------------------------------------------------ subpaths
struct PathState {
  Vtx vtx;     // the vertex the state records (stale after a miss)
  TexRec rec;  // its texture record (textured; stale after a miss)
  V3 o, d;
  uint32_t seed;
  bool term;
};

// passes.bdpt.shoot_ray: extend one bounce; a miss zeroes the colour and
// keeps the stale vertex; the seed advances only on a hit (and never
// under faithful_rng)
template <bool kWalk>
BDPT_DEV void shoot(PathState& s, const FrameParams& p, const float* bw, const float* nodes,
                    const float* __restrict__ tris) {
  if (s.term) return;
  float t;
  int id = closest<kWalk>(bw, nodes, p.n_tris, s.o, s.d, p.min_t, kBig, false, t);
  if (id < 0) {
    s.vtx.color = mk3(0.0f, 0.0f, 0.0f);
    s.term = true;
    return;
  }
  Surf sd = decode_hit(tris, id, t, s.o, s.d, s.o);
  BrdfSample bs = sample_brdf(s.seed, sd.n, sd.v, sd.dif, sd.spec, sd.rough, p.mat_model);
  if (!p.faithful_rng) s.seed = bs.seed;
  s.vtx.color = mul3(s.vtx.color, bs.w);
  s.vtx.pos = sd.pos;
  s.vtx.n = sd.n;
  s.vtx.v = sd.v;
  s.vtx.dif = sd.dif;
  s.vtx.spec = sd.spec;
  s.vtx.rough = sd.rough;
  s.vtx.is_spec = bs.is_spec ? 1.0f : 0.0f;
  s.vtx.pdf = bs.pdf;
  s.rec = surf_rec(sd);
  s.o = sd.pos;
  s.d = bs.l;
}

// the number of (s, t) pairs of the est-3 loop (accel/frame.py:e3_pair_list)
template <int D>
BDPT_DEV int n_e3_pairs(bool enable_e3) {
  int n = 0;
  for (int total_len = 2; enable_e3 && total_len <= D; ++total_len)
    for (int sx = 1; sx < D; ++sx) n += (total_len - sx >= 0 && total_len - sx <= D);
  return n;
}

// ---------------------------------------------------------------- program
template <int D, bool Textured>
BDPT_DEV void frame_pixel(const FrameParams& p, const float* __restrict__ lights,
                          const float* bw, const float* nodes, const float* __restrict__ tris,
                          int lin, const FrameOutPtrs& out) {
  // lin: the pixel's column in the outputs, whose rows hold the launch's
  // n_sub pixels; gpix: its index in the W x H image, which places its
  // primary ray and seeds its RNG streams, so a shard draws the numbers of
  // the whole-image launch
  const float* sc = p.scal;
  const int W = p.width, H = p.height;
  const size_t N = (size_t)p.n_sub;
  const int gpix = p.pix0 + lin;
  const int dead = W * H;  // the splat pixel of a dead splat (K2 drops it)
  const int n_e2 = p.enable_e2 ? D : 0;
  const int n_e1_rows = Textured && p.enable_e1 ? 6 * D : 0;
  V3 cam_pos = mk3(sc[C_POS], sc[C_POS + 1], sc[C_POS + 2]);
  V3 cam_u = mk3(sc[C_U], sc[C_U + 1], sc[C_U + 2]);
  V3 cam_v = mk3(sc[C_V], sc[C_V + 1], sc[C_V + 2]);
  V3 cam_w = mk3(sc[C_W], sc[C_W + 1], sc[C_W + 2]);
  V3 cam_n = mk3(sc[C_N], sc[C_N + 1], sc[C_N + 2]);
  V3 env = mk3(sc[C_ENV], sc[C_ENV + 1], sc[C_ENV + 2]);
  float jx = sc[C_JX], jy = sc[C_JY], lcnt_f = sc[C_LCNT];
  V3 zero = mk3(0.0f, 0.0f, 0.0f);

  // ---------------- primary ray (G-buffer, lightProbeGBuffer.rt.hlsl) ----
  float xf = (float)(gpix % W), yf = (float)(gpix / W);
  float ndc_x = (2.0f * xf / (float)W - 1.0f) + 2.0f * jx / (float)W;
  float ndc_y = (-2.0f * yf / (float)H + 1.0f) - 2.0f * jy / (float)H;
  float inv_wlen = 1.0f / sqrtf(cam_w.x * cam_w.x + cam_w.y * cam_w.y + cam_w.z * cam_w.z);
  V3 d_raw = scale3(mk3(ndc_x * cam_u.x + ndc_y * cam_v.x + cam_w.x,
                        ndc_x * cam_u.y + ndc_y * cam_v.y + cam_w.y,
                        ndc_x * cam_u.z + ndc_y * cam_v.z + cam_w.z), inv_wlen);
  V3 origin0 = cam_pos, prim_dir;
  if (p.use_thin_lens) {
    // lens origin from the G-buffer pass's own RNG stream
    uint32_t gseed = tea16((uint32_t)gpix, p.gbuf_frame);
    float u0 = next_rand(gseed);
    float u1 = next_rand(gseed);
    float theta = 2.0f * kPi * u0;
    float r = sc[C_LENSR] * u1;
    float lx = r * cosf(theta), ly = r * sinf(theta);
    origin0 = mk3(cam_pos.x + lx * sc[C_UN] + ly * sc[C_VN],
                  cam_pos.y + lx * sc[C_UN + 1] + ly * sc[C_VN + 1],
                  cam_pos.z + lx * sc[C_UN + 2] + ly * sc[C_VN + 2]);
    V3 focal_pt = add3(cam_pos, scale3(d_raw, sc[C_FOCAL]));
    prim_dir = normed(sub3(focal_pt, origin0));
  } else {
    prim_dir = normed(d_raw);
  }
  float t0;
  int id0 = closest<Textured>(bw, nodes, p.n_tris, origin0, prim_dir, 0.0f, kBig, true, t0);
  if (id0 < 0) {  // background: (env, 1), no splats
    const float bg[4] = {env.x, env.y, env.z, 1.0f};
    const float gb[20] = {0, 0, 0, 0, 0, 0, 0, 0, env.x, env.y, env.z, 1,
                          0, 0, 0, 0, 0, 0, 0, 0};
    if constexpr (Textured) {  // zero records, emissive slot -1, no parts
      for (int k = 0; k < 2 * D; ++k) store_rec(out.vrec, N, lin, k, zero_rec(), 0.0f);
      out.vrec[(size_t)2 * D * kRecRows * N + lin] = -1.0f;
      for (int r = 0; r < n_e1_rows; ++r) out.e1[r * N + lin] = 0.0f;
      for (int r = 0; r < 4 * n_e3_pairs<D>(p.enable_e3); ++r) out.e3[r * N + lin] = 0.0f;
    } else {
      for (int r = 0; r < 4; ++r) out.res[r * N + lin] = bg[r];
    }
    for (int r = 0; r < 20; ++r) out.gbuf[r * N + lin] = gb[r];
    for (int i = 0; i < n_e2; ++i) {
      out.splat_pix[i * N + lin] = dead;
      if (p.splat_rgb8e) {
        out.splat_pay[i * N + lin] = 0;
      } else {
        for (int c = 0; c < 4; ++c) out.splat_rgba[(i * 4 + c) * N + lin] = 0.0f;
      }
    }
    return;
  }
  Surf sd = decode_hit(tris, id0, t0, origin0, prim_dir, cam_pos);
  V3 world_pos = sd.pos, world_norm = sd.n, dif = sd.dif, spc = sd.spec, emis = sd.emissive;
  float lrough = sd.lrough;
  float rough = lrough * lrough;
  // the camera vertex's view vector uses the pinhole even under thin lens
  V3 v0 = normed(sub3(cam_pos, world_pos));
  uint32_t seed = tea16((uint32_t)gpix, p.bdpt_frame);

  // ---------------- camera subpath ----------------
  Vtx cam[D + 1];
  cam[0] = zero_vtx();
  cam[0].pos = cam_pos;
  cam[0].n = cam_n;
  cam[0].color = mk3(1.0f, 1.0f, 1.0f);
  cam[0].pdf = 1.0f;
  BrdfSample bs0 = sample_brdf(seed, world_norm, v0, dif, spc, rough, p.mat_model);
  if (!p.faithful_rng) seed = bs0.seed;
  cam[1].color = bs0.w;
  cam[1].pos = world_pos;
  cam[1].n = world_norm;
  cam[1].v = v0;
  cam[1].dif = dif;
  cam[1].spec = spc;
  cam[1].rough = rough;
  cam[1].is_spec = bs0.is_spec ? 1.0f : 0.0f;
  cam[1].pdf = bs0.pdf;
  if constexpr (Textured) {
    store_rec(out.vrec, N, lin, 0, surf_rec(sd), cam[1].is_spec);
    out.vrec[(size_t)2 * D * kRecRows * N + lin] = sd.eslot;
  }
  PathState st;
  st.vtx = zero_vtx();
  st.vtx.color = bs0.w;
  st.vtx.pos = world_pos;
  st.rec = zero_rec();
  st.o = world_pos;
  st.d = bs0.l;
  st.seed = seed;
  st.term = false;
#pragma unroll
  for (int depth = 1; depth < D; ++depth) {
    bool was_active = !st.term;
    shoot<Textured>(st, p, bw, nodes, tris);
    cam[depth + 1] = was_active ? st.vtx : zero_vtx();
    if constexpr (Textured)
      store_rec(out.vrec, N, lin, depth, was_active ? st.rec : zero_rec(), cam[depth + 1].is_spec);
  }
  seed = st.seed;

  // ---------------- light subpath (sample_light, BDPTUtils.hlsli:140-152)
  float u_pick = next_rand(seed);
  int lidx = (int)(u_pick * lcnt_f);
  lidx = lidx < p.light_count - 1 ? lidx : p.light_count - 1;
  const float* L0 = lights + lidx * kLightRow;
  V3 l_origin = mk3(L0[0], L0[1], L0[2]);
  V3 l_inten = mk3(L0[6], L0[7], L0[8]);
  V3 axis = L0[9] == 1.0f ? mk3(L0[3], L0[4], L0[5]) : unit_sphere(seed);
  V3 l_dir0 = cos_hemisphere(seed, axis);
  Vtx lig[D + 1];
  bool take[D + 1];
  lig[0] = zero_vtx();
  lig[0].pos = l_origin;
  lig[0].color = l_inten;
  lig[0].pdf = 1.0f / lcnt_f;
  st.vtx = zero_vtx();
  st.vtx.color = l_inten;
  st.vtx.pos = l_origin;
  st.rec = zero_rec();
  st.o = l_origin;
  st.d = l_dir0;
  st.seed = seed;
  st.term = false;
#pragma unroll
  for (int depth = 0; depth < D; ++depth) {
    bool was_active = !st.term;
    shoot<Textured>(st, p, bw, nodes, tris);
    lig[depth + 1] = was_active ? st.vtx : zero_vtx();
    take[depth + 1] = was_active ? !st.term : true;
    if constexpr (Textured)
      store_rec(out.vrec, N, lin, D + depth, was_active ? st.rec : zero_rec(),
                lig[depth + 1].is_spec);
  }
  seed = st.seed;

  // ---------------- accumulate own pixel ----------------
  V3 acc = (emis.x > 0.0f || emis.y > 0.0f || emis.z > 0.0f) ? emis : zero;
  float acc_a = 0.0f;

  // --- estimator 1: path tracing with NEE (BDPTMain:161-167) ---
  if (p.enable_e1) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float u = next_rand(seed);
      int idx = (int)(u * lcnt_f);
      idx = idx < p.light_count - 1 ? idx : p.light_count - 1;
      acc_a = acc_a + 1.0f;
      // a zero throughput makes the term 0 (or NaN, guarded to 0) whatever
      // the shadow ray says
      if (is_zero3(cam[i].color)) {
        if constexpr (Textured)
          for (int r = 0; r < 6; ++r) out.e1[(6 * i + r) * N + lin] = 0.0f;
        continue;
      }
      const Vtx& x = cam[i + 1];
      LightEval le = eval_light(lights + idx * kLightRow, x.pos);
      bool occ = any_hit<Textured>(bw, nodes, p.n_tris, x.pos, le.l, p.min_t, le.dist);
      if constexpr (Textured) {
        // raw parts x the camera throughput (pallas_frame.py:821-828)
        V3 difp, specp;
        nee_shade_split(!occ, le.l, le.inten, x.n, x.v, x.dif, x.spec, x.rough, lcnt_f,
                        p.mat_model, difp, specp);
        store3(out.e1, N, lin, 6 * i, mul3(cam[i].color, difp));
        store3(out.e1, N, lin, 6 * i + 3, mul3(cam[i].color, specp));
        continue;
      }
      V3 direct = nee_shade(!occ, le.l, le.inten, x.n, x.v, x.dif, x.spec, x.rough, lcnt_f,
                            p.mat_model);
      V3 shade = nan_guard3(clip3(scale3(mul3(cam[i].color, direct), 1.0f / (float)(i + 2)),
                                  p.clamp_upper));
      acc = add3(acc, shade);
    }
  }

  // --- estimator 3: s,t connections (BDPTMain:212-233) ---
  if (p.enable_e3) {
    float lc[D + 1], ll[D + 1];
    float mis_power = p.connection_weight == 1 ? 2.0f : 1.0f;
    if (p.connection_weight != 0) {
      cum_logpdf<D>(cam, lc);
      cum_logpdf<D>(lig, ll);
    }
    int pair = 0;  // the textured parts' pair index
#pragma unroll
    for (int total_len = 2; total_len <= D; ++total_len) {
#pragma unroll
      for (int sx = 1; sx < D; ++sx) {
        const int tx = total_len - sx;
        if (tx < 0 || tx > D) continue;
        V3 vec = sub3(lig[tx].pos, cam[sx].pos);
        float length_ab = sqrtf(jmax(dot3(vec, vec), 1e-30f));
        V3 dir_ab = scale3(vec, 1.0f / length_ab);
        // interval shortened by min_t to exclude far-endpoint self-hits
        bool occ = any_hit<Textured>(bw, nodes, p.n_tris, cam[sx].pos, dir_ab, p.min_t,
                                     length_ab - p.min_t);
        const int pi = pair++;
        if (occ) {
          if constexpr (Textured)
            for (int r = 0; r < 4; ++r) out.e3[(4 * pi + r) * N + lin] = 0.0f;
          continue;
        }
        V3 shade = zero;
        if (tx >= 1) {
          // evalGWithoutV (BDPTUtils.hlsli:172-184)
          float inv_len = 1.0f / sqrtf(jmax(dot3(vec, vec), 1e-30f));
          V3 dd = scale3(vec, inv_len);
          const Vtx& ce = cam[sx];
          const Vtx& le = lig[tx];
          float g = fabsf(dot3(ce.n, dd)) * fabsf(dot3(le.n, dd)) * inv_len * inv_len;
          V3 a_e = cam[sx - 1].color;
          V3 a_l = p.reference_quirks ? lig[sx - 1].color : lig[tx - 1].color;
          V3 connect_dir = normed(sub3(ce.pos, le.pos));
          V3 wo_l = normed(sub3(lig[tx - 1].pos, le.pos));
          V3 fs_l = eval_brdf(connect_dir, wo_l, le.n, le.dif, le.spec, le.rough,
                              le.is_spec > 0.5f, p.mat_model);
          V3 wo_e = normed(sub3(cam[sx - 1].pos, ce.pos));
          V3 fs_e = eval_brdf(neg3(connect_dir), wo_e, ce.n, ce.dif, ce.spec, ce.rough,
                              ce.is_spec > 0.5f, p.mat_model);
          shade = mk3(a_l.x * (fs_l.x * g * fs_e.x) * a_e.x,
                      a_l.y * (fs_l.y * g * fs_e.y) * a_e.y,
                      a_l.z * (fs_l.z * g * fs_e.z) * a_e.z);
          // textured: the raw shade (pallas_frame.py:939-944)
          if constexpr (!Textured) {
            if (p.connection_weight != 0)
              shade = scale3(shade, mis_weight(lc, ll, sx, tx, total_len, mis_power));
            else
              shade = scale3(shade, 1.0f / (float)total_len);
            shade = nan_guard3(clip3(shade, p.clamp_upper));
          }
        }
        if constexpr (Textured) {
          store3(out.e3, N, lin, 4 * pi, shade);
          out.e3[(4 * pi + 3) * N + lin] = 1.0f;
          continue;
        }
        acc = mk3(saturate(acc.x + shade.x), saturate(acc.y + shade.y), saturate(acc.z + shade.z));
        acc_a = saturate(acc_a + 1.0f);
      }
    }
  }

  // --- estimator 2: light-tracing splats (BDPTMain:171-208) ---
  bool take_cum = true;
  for (int i = 0; i < n_e2; ++i) {
    take_cum = take_cum && take[i + 1];
    const Vtx& last = lig[i + 1];
    V3 to_cam = sub3(cam_pos, last.pos);
    float dis = sqrtf(jmax(dot3(to_cam, to_cam), 1e-30f));
    V3 dir_to_cam = scale3(to_cam, 1.0f / dis);
    bool ok = take_cum && dot3(cam_n, dir_to_cam) < 0.0f;
    // project_dir_to_pixel (BDPTUtils.hlsli:129-138)
    float d1 = dot3(dir_to_cam, cam_u) * sc[C_IU2];
    float d2 = dot3(dir_to_cam, cam_v) * sc[C_IV2];
    float d3 = dot3(dir_to_cam, cam_w) * sc[C_IW2];
    float px = ((d1 / d3) * 0.5f + 0.5f) * (float)W - jx;
    float py = ((-d2 / d3) * 0.5f + 0.5f) * (float)H - jy;
    float rx = rintf(px), ry = rintf(py);  // half to even
    ok = ok && rx >= 0.0f && rx < (float)W && ry >= 0.0f && ry < (float)H;
    ok = ok && !any_hit<Textured>(bw, nodes, p.n_tris, last.pos, dir_to_cam, p.min_t, dis);
    V3 shade = zero;
    if (ok) {
      float theta1 = saturate(fabsf(dot3(dir_to_cam, cam_n)));
      float theta2 = saturate(fabsf(dot3(dir_to_cam, last.n)));
      float g = theta1 * theta2 / (dis * dis);
      V3 brdf = eval_brdf(last.v, dir_to_cam, last.n, last.dif, last.spec, last.rough,
                          last.is_spec > 0.5f, p.mat_model);
      V3 lc0 = lig[i].color;
      shade = mk3(lc0.x * brdf.x * g, lc0.y * brdf.y * g, lc0.z * brdf.z * g);
      // textured: the raw shade (pallas_frame.py:986-988)
      if constexpr (!Textured)
        shade = nan_guard3(clip3(scale3(shade, 1.0f / (float)(i + 2)), p.clamp_upper));
    }
    out.splat_pix[i * N + lin] = ok ? (int)ry * W + (int)rx : dead;
    if (!Textured && p.splat_rgb8e) {
      out.splat_pay[i * N + lin] = pack_rgb8e(shade.x, shade.y, shade.z);
    } else {
      out.splat_rgba[(i * 4 + 0) * N + lin] = shade.x;
      out.splat_rgba[(i * 4 + 1) * N + lin] = shade.y;
      out.splat_rgba[(i * 4 + 2) * N + lin] = shade.z;
      out.splat_rgba[(i * 4 + 3) * N + lin] = ok ? 1.0f : 0.0f;
    }
  }

  // ---------------- outputs ----------------
  if constexpr (!Textured) {  // textured: the replay computes it
    out.res[0 * N + lin] = acc.x;
    out.res[1 * N + lin] = acc.y;
    out.res[2 * N + lin] = acc.z;
    out.res[3 * N + lin] = acc_a;
  }
  V3 dvec = sub3(world_pos, cam_pos);
  const float gb[20] = {world_pos.x, world_pos.y, world_pos.z, 1.0f,
                        world_norm.x, world_norm.y, world_norm.z,
                        sqrtf(jmax(dot3(dvec, dvec), 0.0f)),
                        dif.x, dif.y, dif.z, sd.opacity,
                        spc.x, spc.y, spc.z, lrough,
                        sd.ior, emis.x, emis.y, emis.z};
  for (int r = 0; r < 20; ++r) out.gbuf[r * N + lin] = gb[r];
}

}  // namespace bdpt
