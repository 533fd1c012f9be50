"""GGX microfacet math over [..., 3] tensors.

Port of `fyp_bidirectionalpathtracer_tpu/ops/brdf.py` (BRDFUtils.hlsli).
`rough` throughout is alpha = linearRoughness^2, as in the reference.
"""
from __future__ import annotations

import torch

from ..core.vecmath import M_PI, dot, saturate


def ggx_normal_distribution(n_dot_h, rough):
    """GGX NDF D (BRDFUtils.hlsli:5-10)."""
    a2 = rough * rough
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / torch.clamp(d * d * M_PI, min=0.001)


def ggx_schlick_masking(n_dot_l, n_dot_v, rough):
    """Schlick-GGX masking G with k = alpha/2 (BRDFUtils.hlsli:15-30)."""
    k = rough * rough / 2.0
    g_v = n_dot_v / (n_dot_v * (1.0 - k) + k)
    g_l = n_dot_l / (n_dot_l * (1.0 - k) + k)
    return g_v * g_l


def schlick_fresnel(f0, u):
    """Schlick Fresnel F (BRDFUtils.hlsli:35-38); f0 [..., 3], u [...]."""
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - u, min=0.0), 5.0)[..., None]


def ggx_lighting(h, l, n, n_dot_l, n_dot_v, rough, spec):
    """Cook-Torrance eval and NDF-sampling pdf (BRDFUtils.hlsli:63-73):
    (brdf [..., 3], ggx_prob = D NdotH / (4 LdotH)).  Divisions by zero give
    inf/nan as in the HLSL; the estimators' NaN guards handle them."""
    n_dot_h = saturate(dot(n, h))
    l_dot_h = saturate(dot(l, h))
    d = ggx_normal_distribution(n_dot_h, rough)
    g = ggx_schlick_masking(n_dot_l, n_dot_v, rough)
    f = schlick_fresnel(spec, l_dot_h)
    ggx_prob = d * n_dot_h / (4.0 * l_dot_h)
    brdf = f * (d * g / (4.0 * n_dot_l * n_dot_v))[..., None]
    return brdf, ggx_prob
