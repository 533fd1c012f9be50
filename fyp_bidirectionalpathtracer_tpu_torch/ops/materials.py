"""Material model: evalBRDF / evalPdf / sampleBRDF and the NEE shading
halves, over [..., 3] tensors.

Port of `fyp_bidirectionalpathtracer_tpu/ops/materials.py`
(MaterialUtils.hlsli:87-329).  `mat_model` is 0 (GGX diffuse + specular)
or 1 (Lambertian).  Division hazards keep their inf/nan flows: the
estimators' NaN guards handle them, as in the reference.

Every sampler returns the advanced seed; `faithful_rng` (passes/bdpt.py)
discards it to reproduce the reference's by-value seed.

The light table is the [L, 13] `scene.lights.light_rows` on the device plus
the light count, where the JAX functions take a LightArray; the NEE
functions (`lambertian_direct`, `ggx_direct`, `eval_direct`) take the
`shadow_fn(origin, direction, t_min, t_max) -> visible` of JAX's.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.samplers import cos_hemisphere_sample, ggx_microfacet_sample
from ..core.vecmath import M_1_PI, M_PI, dot, luminance, normalize, saturate
from ..scene.lights import eval_light
from .brdf import ggx_lighting, ggx_normal_distribution, ggx_schlick_masking, schlick_fresnel

GGX = 0
LAMBERTIAN = 1


def clamp_vec(v, upper):
    """Per-channel clamp to [0, gClampUpper] (MaterialUtils.hlsli:15-18)."""
    return torch.clamp(v, 0.0, upper)


def probability_to_sample_diffuse(dif, spec):
    """Lobe pick probability by luminance ratio (MaterialUtils.hlsli:22-27)."""
    lum_d = torch.clamp(luminance(dif), min=0.01)
    lum_s = torch.clamp(luminance(spec), min=0.01)
    return lum_d / (lum_d + lum_s)


def pick_light(seed, light_count: int):
    """index = min(int(u * N), N - 1) (BDPTUtils.hlsli:142)."""
    seed, u = rng.next_rand(seed)
    idx = torch.clamp((u * float(light_count)).to(torch.int32), max=light_count - 1)
    return seed, idx


# --------------------------------------------------------------------- GGX
def eval_ggx_brdf(v, l, n, no_normal_n, dif, spec, rough, is_specular):
    """evalGGXBRDF (MaterialUtils.hlsli:186-207)."""
    below = dot(no_normal_n, l) <= 0.0
    diffuse = dif * M_1_PI
    h = normalize(l + v)
    spec_col, _ = ggx_lighting(h, l, n, saturate(dot(n, l)), saturate(dot(n, v)),
                               rough, spec)
    out = torch.where(is_specular[..., None], spec_col, diffuse)
    return torch.where(below[..., None], torch.zeros_like(out), out)


def eval_ggx_pdf(v, l, n, no_normal_n, dif, spec, rough, is_specular):
    """evalGGXPdf (MaterialUtils.hlsli:254-279)."""
    prob_diffuse = probability_to_sample_diffuse(dif, spec)
    below = dot(no_normal_n, l) <= 0.0
    n_dot_l = saturate(dot(n, l))
    pdf_diffuse = (n_dot_l * M_1_PI) * prob_diffuse
    h = normalize(l + v)
    _, ggx_prob = ggx_lighting(h, l, n, n_dot_l, saturate(dot(n, v)), rough, spec)
    out = torch.where(is_specular, ggx_prob * (1.0 - prob_diffuse), pdf_diffuse)
    return torch.where(below, torch.zeros_like(out), out)


def sample_ggx_brdf(seed, n, no_normal_n, v, dif, spec, rough):
    """sampleGGXBRDF (MaterialUtils.hlsli:209-252): (seed, weight [..., 3],
    L [..., 3], pdf, is_specular).  One lobe draw, then the same two draws
    feed both lobes' samplers, as the HLSL consumes them."""
    prob_diffuse = probability_to_sample_diffuse(dif, spec)
    seed, u_lobe = rng.next_rand(seed)
    choose_diffuse = u_lobe < prob_diffuse
    n_dot_v = saturate(dot(n, v))

    seed_d, l_diff = cos_hemisphere_sample(seed, n)
    _, h = ggx_microfacet_sample(seed, rough, n)
    seed = seed_d
    l_spec = normalize(2.0 * dot(v, h)[..., None] * h - v)

    l = torch.where(choose_diffuse[..., None], l_diff, l_spec)
    below = dot(no_normal_n, l) <= 0.0
    n_dot_l = saturate(dot(n, l))

    pdf_diff = (n_dot_l * M_1_PI) * prob_diffuse
    w_diff = dif / prob_diffuse[..., None]
    ggx_term, ggx_prob = ggx_lighting(h, l_spec, n, n_dot_l, n_dot_v, rough, spec)
    pdf_spec = ggx_prob * (1.0 - prob_diffuse)
    w_spec = (n_dot_l / (ggx_prob * (1.0 - prob_diffuse)))[..., None] * ggx_term

    pdf = torch.where(choose_diffuse, pdf_diff, pdf_spec)
    weight = torch.where(choose_diffuse[..., None], w_diff, w_spec)
    pdf = torch.where(below, torch.zeros_like(pdf), pdf)
    weight = torch.where(below[..., None], torch.zeros_like(weight), weight)
    return seed, weight, l, pdf, ~choose_diffuse


def nee_pick(seed, light_rows, light_count: int, pos):
    """The light pick and light eval of evalDirect (one draw):
    (seed, l, intensity, dist); the shadow query follows."""
    seed, idx = pick_light(seed, light_count)
    l, intensity, dist, _ = eval_light(light_rows, idx, pos)
    return seed, l, intensity, dist


def ggx_direct_shade(vis, l, intensity, n, v, dif, spec, rough, light_count: int):
    """The shading half of ggxDirect given visibility (MaterialUtils:160-183);
    NdotL cancels against the denominator as in the reference."""
    n_dot_l = saturate(dot(n, l))
    shadow_mult = torch.where(vis, float(light_count), 0.0)
    h = normalize(v + l)
    n_dot_h = saturate(dot(n, h))
    l_dot_h = saturate(dot(l, h))
    n_dot_v = saturate(dot(n, v))
    d = ggx_normal_distribution(n_dot_h, rough)
    g = ggx_schlick_masking(n_dot_l, n_dot_v, rough)
    f = schlick_fresnel(spec, l_dot_h)
    ggx_term = f * (d * g / (4.0 * n_dot_v))[..., None]
    return shadow_mult[..., None] * intensity * (
        ggx_term + (n_dot_l[..., None] * dif) * M_1_PI)


def lambertian_direct_shade(vis, l, intensity, n, dif, light_count: int):
    """The shading half of lambertianDirect (MaterialUtils:299-306)."""
    l_dot_n = saturate(dot(n, l))
    shadow_mult = torch.where(vis, float(light_count), 0.0)
    return (shadow_mult * l_dot_n)[..., None] * intensity * dif / M_PI


def nee_shade(vis, l, intensity, n, v, dif, spec, rough, light_count: int,
              mat_model: int):
    if mat_model == GGX:
        return ggx_direct_shade(vis, l, intensity, n, v, dif, spec, rough, light_count)
    return lambertian_direct_shade(vis, l, intensity, n, dif, light_count)


def ggx_direct(seed, shadow_fn, light_rows, light_count: int, min_t, pos, n, v, dif, spec,
               rough):
    """ggxDirect: one-light NEE with xN compensation (MaterialUtils:149-184).
    `shadow_fn(origin, direction, t_min, t_max)` is True where visible."""
    seed, l, intensity, dist = nee_pick(seed, light_rows, light_count, pos)
    vis = shadow_fn(pos, l, min_t, dist)
    return seed, ggx_direct_shade(vis, l, intensity, n, v, dif, spec, rough, light_count)


# --------------------------------------------------------------- Lambertian
def eval_lambertian_brdf(dif):
    """evalLambertianBRDF returns the albedo (MaterialUtils.hlsli:309-314;
    the reference omits the 1/pi here, kept for parity)."""
    return dif


def eval_lambertian_pdf(n, l):
    return saturate(dot(n, l) * M_1_PI)


def sample_lambertian_brdf(seed, n, dif):
    seed, l = cos_hemisphere_sample(seed, n)
    pdf = saturate(dot(n, l)) * M_1_PI
    return seed, dif, l, pdf, torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device)


def lambertian_direct(seed, shadow_fn, light_rows, light_count: int, min_t, pos, n, dif):
    """lambertianDirect (MaterialUtils.hlsli:288-307)."""
    seed, l, intensity, dist = nee_pick(seed, light_rows, light_count, pos)
    vis = shadow_fn(pos, l, min_t, dist)
    return seed, lambertian_direct_shade(vis, l, intensity, n, dif, light_count)


# ----------------------------------------------------------------- dispatch
def eval_brdf(v, l, n, no_normal_n, dif, spec, rough, is_specular, mat_model: int):
    if mat_model == GGX:
        return eval_ggx_brdf(v, l, n, no_normal_n, dif, spec, rough, is_specular)
    return eval_lambertian_brdf(dif)


def eval_pdf(v, l, n, no_normal_n, dif, spec, rough, is_specular, mat_model: int):
    if mat_model == GGX:
        return eval_ggx_pdf(v, l, n, no_normal_n, dif, spec, rough, is_specular)
    return eval_lambertian_pdf(n, l)


def sample_brdf(seed, n, no_normal_n, v, dif, spec, rough, mat_model: int):
    if mat_model == GGX:
        return sample_ggx_brdf(seed, n, no_normal_n, v, dif, spec, rough)
    return sample_lambertian_brdf(seed, n, dif)


def eval_direct(seed, shadow_fn, light_rows, light_count: int, min_t, pos, n, v, dif, spec,
                rough, mat_model: int):
    if mat_model == GGX:
        return ggx_direct(seed, shadow_fn, light_rows, light_count, min_t, pos, n, v, dif, spec,
                          rough)
    return lambertian_direct(seed, shadow_fn, light_rows, light_count, min_t, pos, n, dif)
