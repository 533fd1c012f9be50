// The per-ray program of kernel K6 (see subpath.cu): a transcription of
// the TPU kernel accel/pallas_subpath.py:subpath_kernel and of the plain
// version accel/subpath.py:subpath_plain, operation for operation (compile
// it without FMA contraction to keep that so).
#pragma once

#include "frame_program.cuh"

namespace bdpt {

constexpr int kVertRows = 24;   // a bounce's vertex record rows
constexpr int kStateRows = 12;  // o3 d3 colour3 terminated seed-bits min_t

// Ray `lane` of the field-major state [12, N]: n_bounces of closest hit
// over the Baldwin-Weber rows `bw` (K6's own test: no back-face cull,
// t = (n.v0 - n.o) * (1 / n.d), t > min_t and strictly below the best so
// far, so the lowest id wins a tie), the winner's decode from its pack row,
// sampleBRDF and the vertex record [24 n_bounces, N]; then the final state.
BDPT_DEV void subpath_ray(const float* __restrict__ state, size_t N, int lane,
                          const float* bw, const float* __restrict__ tris, int n_tris,
                          int n_bounces, int mat_model, int faithful_rng,
                          float* __restrict__ verts, float* __restrict__ final_state) {
  const float* s = state + lane;
  V3 o = mk3(s[0], s[N], s[2 * N]);
  V3 d = mk3(s[3 * N], s[4 * N], s[5 * N]);
  V3 col = mk3(s[6 * N], s[7 * N], s[8 * N]);
  bool term = s[9 * N] > 0.5f;
  uint32_t seed = __float_as_uint(s[10 * N]);
  const float min_t = s[11 * N];
  const V3 zero = mk3(0.0f, 0.0f, 0.0f);
  V3 p_pos = o, p_n = zero, p_v = zero, p_dif = zero, p_spec = zero;
  float p_rough = 0.0f, p_isspec = 0.0f, p_pdf = 0.0f;

  for (int bounce = 0; bounce < n_bounces; ++bounce) {
    const bool active = !term;
    bool got = false;
    if (active) {
      float best_t = 1e30f;
      int best = -1;
      for (int i = 0; i < n_tris; ++i) {
        const float* r = bw + kBwCols * i;
        const float ndir = r[0] * d.x + r[1] * d.y + r[2] * d.z;
        const bool dir_ok = fabsf(ndir) > 1e-9f;
        if (!dir_ok) continue;
        const float tt = (r[3] - (r[0] * o.x + r[1] * o.y + r[2] * o.z)) * (1.0f / ndir);
        if (!(tt > min_t && tt < best_t)) continue;
        const float u = (r[4] * o.x + r[5] * o.y + r[6] * o.z - r[7]) +
                        tt * (r[4] * d.x + r[5] * d.y + r[6] * d.z);
        const float v = (r[8] * o.x + r[9] * o.y + r[10] * o.z - r[11]) +
                        tt * (r[8] * d.x + r[9] * d.y + r[10] * d.z);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
          best_t = tt;
          best = i;
        }
      }
      if (best < 0) {  // a miss zeroes the colour and keeps the stale vertex
        col = zero;
        term = true;
      } else {
        got = true;
        const float* a = tris + (size_t)best * kPackCols;
        const float u = (a[4] * o.x + a[5] * o.y + a[6] * o.z - a[7]) +
                        best_t * (a[4] * d.x + a[5] * d.y + a[6] * d.z);
        const float v = (a[8] * o.x + a[9] * o.y + a[10] * o.z - a[11]) +
                        best_t * (a[8] * d.x + a[9] * d.y + a[10] * d.z);
        const float w = 1.0f - u - v;
        const V3 pos = mk3(o.x + best_t * d.x, o.y + best_t * d.y, o.z + best_t * d.z);
        V3 nrm = normalize_eps(mk3(w * a[12] + u * a[15] + v * a[18],
                                   w * a[13] + u * a[16] + v * a[19],
                                   w * a[14] + u * a[17] + v * a[20]), 1e-20f);
        const V3 view = mk3(-d.x, -d.y, -d.z);  // normalize(origin - hit), unit d
        const bool metal_rough = a[39] == 0.0f;  // SHADING_METAL_ROUGH
        const float metal = a[33];
        const V3 b = mk3(a[27], a[28], a[29]);
        const V3 dif = metal_rough ? mk3(b.x * (1.0f - metal), b.y * (1.0f - metal),
                                         b.z * (1.0f - metal))
                                   : b;
        const V3 spc = metal_rough ? mk3(0.04f * (1.0f - metal) + b.x * metal,
                                         0.04f * (1.0f - metal) + b.y * metal,
                                         0.04f * (1.0f - metal) + b.z * metal)
                                   : mk3(a[31], a[32], a[33]);
        const float lr = jmax(metal_rough ? a[32] : 1.0f - a[34], 0.08f);
        const float rough = lr * lr;
        if (nrm.x * view.x + nrm.y * view.y + nrm.z * view.z <= 0.0f && a[40] > 0.5f)
          nrm = neg3(nrm);
        const BrdfSample bs = sample_brdf(seed, nrm, view, dif, spc, rough, mat_model);
        if (!faithful_rng) seed = bs.seed;
        col = mul3(col, bs.w);
        p_pos = pos;
        p_n = nrm;
        p_v = view;
        p_dif = dif;
        p_spec = spc;
        p_rough = rough;
        p_isspec = bs.is_spec ? 1.0f : 0.0f;
        p_pdf = bs.pdf;
        o = pos;
        d = bs.l;
      }
    }
    // the vertex record; a lane inactive before this bounce writes its
    // fields times 0 and take 1 (pallas_subpath.py:331-350)
    const float af = active ? 1.0f : 0.0f;
    const float fields[22] = {col.x,   col.y,   col.z,    p_pos.x,  p_pos.y,  p_pos.z,
                              p_n.x,   p_n.y,   p_n.z,    p_v.x,    p_v.y,    p_v.z,
                              p_dif.x, p_dif.y, p_dif.z,  p_spec.x, p_spec.y, p_spec.z,
                              p_rough, p_isspec, p_pdf,   got ? 1.0f : 0.0f};
    float* out = verts + (size_t)bounce * kVertRows * N + lane;
#pragma unroll
    for (int k = 0; k < 22; ++k) out[k * N] = fields[k] * af;
    out[22 * N] = active ? (term ? 0.0f : 1.0f) : 1.0f;
    out[23 * N] = 0.0f;
  }
  float* f = final_state + lane;
  const float fin[kStateRows] = {o.x,   o.y,   o.z,   d.x, d.y, d.z, col.x, col.y,
                                 col.z, term ? 1.0f : 0.0f, __uint_as_float(seed), min_t};
#pragma unroll
  for (int k = 0; k < kStateRows; ++k) f[k * N] = fin[k];
}

}  // namespace bdpt
