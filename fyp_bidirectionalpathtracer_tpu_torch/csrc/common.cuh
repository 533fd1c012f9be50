// Shared device helpers of the port's kernels: 3-vectors, jnp-style float
// min/max/clip (NaN-propagating, as jnp.maximum / jnp.clip are), the
// reference's TEA/LCG RNG in uint32 arithmetic, and the rgb8e splat payload.
//
// Everything here is plain C++ apart from the BDPT_DEV qualifier, so the
// helpers read the same as the plain PyTorch versions beside the kernels.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef BDPT_DEV
#define BDPT_DEV __device__ __forceinline__
#endif

namespace bdpt {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kBig = 1e30f;

struct V3 {
  float x, y, z;
};

BDPT_DEV V3 mk3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
// Products and sums for code that is held bit for bit against a plain
// PyTorch expression: with kExact each is a rounded single operation that
// the compiler never contracts into an FMA; without it, plain operators the
// compiler may contract (as the rest of the frame program's arithmetic).
template <bool kExact>
BDPT_DEV float mul_(float a, float b) {
#ifdef __CUDACC__
  if (kExact) return __fmul_rn(a, b);
#endif
  return a * b;
}
template <bool kExact>
BDPT_DEV float add_(float a, float b) {
#ifdef __CUDACC__
  if (kExact) return __fadd_rn(a, b);
#endif
  return a + b;
}
template <bool kExact>
BDPT_DEV float sub_(float a, float b) {
#ifdef __CUDACC__
  if (kExact) return __fsub_rn(a, b);
#endif
  return a - b;
}
// a.x*b.x + a.y*b.y + a.z*b.z, summed left to right as torch evaluates it
template <bool kExact>
BDPT_DEV float dot3_(float ax, float ay, float az, float bx, float by, float bz) {
  return add_<kExact>(add_<kExact>(mul_<kExact>(ax, bx), mul_<kExact>(ay, by)),
                      mul_<kExact>(az, bz));
}

BDPT_DEV V3 add3(V3 a, V3 b) { return mk3(a.x + b.x, a.y + b.y, a.z + b.z); }
BDPT_DEV V3 sub3(V3 a, V3 b) { return mk3(a.x - b.x, a.y - b.y, a.z - b.z); }
BDPT_DEV V3 mul3(V3 a, V3 b) { return mk3(a.x * b.x, a.y * b.y, a.z * b.z); }
BDPT_DEV V3 scale3(V3 a, float s) { return mk3(a.x * s, a.y * s, a.z * s); }
BDPT_DEV V3 neg3(V3 a) { return mk3(-a.x, -a.y, -a.z); }
BDPT_DEV float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
BDPT_DEV bool is_zero3(V3 a) { return a.x == 0.0f && a.y == 0.0f && a.z == 0.0f; }

// jnp.maximum / jnp.minimum: a NaN in either operand gives NaN
BDPT_DEV float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
BDPT_DEV float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
BDPT_DEV float clip(float x, float lo, float hi) { return jmin(jmax(x, lo), hi); }
BDPT_DEV float saturate(float x) { return clip(x, 0.0f, 1.0f); }
BDPT_DEV V3 clip3(V3 c, float upper) {
  return mk3(clip(c.x, 0.0f, upper), clip(c.y, 0.0f, upper), clip(c.z, 0.0f, upper));
}
// a NaN in any channel zeroes all three (the reference's NaN guard)
BDPT_DEV V3 nan_guard3(V3 c) {
  return (c.x != c.x || c.y != c.y || c.z != c.z) ? mk3(0.0f, 0.0f, 0.0f) : c;
}

// x * rsqrt(|x|^2 + eps), with an IEEE 1/sqrt (rsqrtf is approximate)
BDPT_DEV V3 normalize_eps(V3 a, float eps) {
  float inv = 1.0f / sqrtf(a.x * a.x + a.y * a.y + a.z * a.z + eps);
  return scale3(a, inv);
}
BDPT_DEV V3 normed(V3 a) { return normalize_eps(a, 0.0f); }

// ------------------------------------------------------------------- RNG
// 16-round TEA hash (initRand, BDPTUtils.hlsli:91-103)
BDPT_DEV uint32_t tea16(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0u;
  for (int i = 0; i < 16; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

// LCG draw (nextRand, BDPTUtils.hlsli:106-110)
BDPT_DEV float next_rand(uint32_t& s) {
  s = 1664525u * s + 1013904223u;
  return (float)(s & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

// ----------------------------------------------------------------- rgb8e
BDPT_DEV float exp2i(int e) { return __int_as_float((e + 127) << 23); }

// non-negative (r, g, b) -> 3 x 8-bit mantissas sharing a 5-bit exponent;
// rintf rounds half to even, as jnp.round does
BDPT_DEV int pack_rgb8e(float r, float g, float b) {
  float mx = jmax(jmax(r, g), b);
  int eb = (__float_as_int(mx) >> 23) & 0xFF;
  int e = eb - 126;
  e = e < -16 ? -16 : (e > 15 ? 15 : e);
  float scale = exp2i(8 - e);
  int qr = (int)clip(rintf(r * scale), 0.0f, 255.0f);
  int qg = (int)clip(rintf(g * scale), 0.0f, 255.0f);
  int qb = (int)clip(rintf(b * scale), 0.0f, 255.0f);
  return qr | (qg << 8) | (qb << 16) | ((e + 16) << 24);
}

BDPT_DEV void unpack_rgb8e(int p, float& r, float& g, float& b) {
  float inv = exp2i(((p >> 24) & 0x1F) - 16 - 8);
  r = (float)(p & 0xFF) * inv;
  g = (float)((p >> 8) & 0xFF) * inv;
  b = (float)((p >> 16) & 0xFF) * inv;
}

}  // namespace bdpt
