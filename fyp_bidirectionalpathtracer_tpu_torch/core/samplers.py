"""Pixel jitter, direction and lens samplers.

Port of `fyp_bidirectionalpathtracer_tpu/core/samplers.py`: `msaa8_jitter`
and the [..., 3] wavefront samplers (`cos_hemisphere_sample`,
`ggx_microfacet_sample`, `unit_sphere_sample`, `lens_sample`, `:49-126`),
plus the megakernel's per-lane forms `_cos_hemisphere` / `_unit_sphere`
(`accel/pallas_frame.py:193-229`).  Each sampler consumes LCG draws
exactly as the HLSL does, so sequences stay bit-comparable.
"""
from __future__ import annotations

import torch

from . import rng
from .vecmath import M_PI, build_onb, build_onb3, dot, dot3, vec3, where3

# The 8-frame D3D MSAA-8 pattern in 1/16-pixel units (BDPTPass.cpp:20).
MSAA8_PATTERN = (
    (1, -3), (-1, 3), (5, 1), (-3, -5), (-5, 5), (-7, -1), (3, 7), (7, -7),
)


def msaa8_jitter(frame) -> torch.Tensor:
    """Per-frame subpixel offset kMSAA[frame % 8] * 0.0625 (float32 [2])."""
    tbl = torch.tensor(MSAA8_PATTERN, dtype=torch.float32) * 0.0625
    return tbl[int(frame) % 8]


def cos_hemisphere_sample(seed, n):
    """Cosine-weighted direction about n [..., 3] (2 draws,
    MaterialUtils.hlsli:41-54): T*(r cos phi) + B*(r sin phi) + N*sqrt(1-u0)."""
    seed, u0, u1 = rng.next_rand2(seed)
    tangent, bitangent = build_onb(n)
    r = torch.sqrt(u0)
    phi = 2.0 * M_PI * u1
    d = (tangent * (r * torch.cos(phi))[..., None]
         + bitangent * (r * torch.sin(phi))[..., None]
         + n * torch.sqrt(torch.clamp(1.0 - u0, min=0.0))[..., None])
    return seed, d


def ggx_microfacet_sample(seed, roughness, n):
    """GGX NDF half-vector sample (2 draws, BRDFUtils.hlsli:44-61)."""
    seed, u0, u1 = rng.next_rand2(seed)
    t, b = build_onb(n)
    a2 = roughness * roughness
    cos_th = torch.sqrt(torch.clamp((1.0 - u0) / ((a2 - 1.0) * u0 + 1.0), min=0.0))
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    phi = u1 * M_PI * 2.0
    h = (t * (sin_th * torch.cos(phi))[..., None]
         + b * (sin_th * torch.sin(phi))[..., None]
         + n * cos_th[..., None])
    return seed, h


def unit_sphere_sample(seed, max_iters: int = 24):
    """Masked rejection sample in the unit ball, [..., 3] (MaterialUtils.hlsli:
    56-63): a lane stops drawing once accepted; after `max_iters` rounds an
    unaccepted lane takes (0, 0, 1)."""
    p = torch.full(seed.shape + (3,), 2.0, dtype=torch.float32, device=seed.device)
    done = torch.zeros(seed.shape, dtype=torch.bool, device=seed.device)
    for _ in range(max_iters):
        seed_n, x = rng.next_rand(seed)
        seed_n, y = rng.next_rand(seed_n)
        seed_n, z = rng.next_rand(seed_n)
        cand = vec3(x * 2.0 - 1.0, y * 2.0 - 1.0, z * 2.0 - 1.0)
        p = torch.where(done[..., None], p, cand)
        seed = torch.where(done, seed, seed_n)
        done = done | (dot(p, p) <= 1.0)
    # filled on the device (no host copy, which a CUDA graph's capture refuses)
    z_axis = torch.zeros(3, dtype=torch.float32, device=seed.device)
    z_axis[2:].fill_(1.0)
    return seed, torch.where(done[..., None], p, z_axis)


def lens_sample(seed, lens_radius):
    """Uniform polar lens sample (r cos theta, r sin theta), r = radius * u
    (lightProbeGBuffer.rt.hlsl:134-135; not sqrt(u), as the reference)."""
    seed, u0, u1 = rng.next_rand2(seed)
    theta = 2.0 * M_PI * u0
    r = lens_radius * u1
    return seed, r * torch.cos(theta), r * torch.sin(theta)


def cos_hemisphere3(seed, n):
    """Cosine-weighted direction about n (2 draws, MaterialUtils.hlsli:41-54)."""
    seed, u0 = rng.next_rand(seed)
    seed, u1 = rng.next_rand(seed)
    t, b = build_onb3(n)
    r = torch.sqrt(u0)
    phi = 2.0 * M_PI * u1
    rc = r * torch.cos(phi)
    rs = r * torch.sin(phi)
    zc = torch.sqrt(torch.clamp(1.0 - u0, min=0.0))
    d = tuple(t[k] * rc + b[k] * rs + n[k] * zc for k in range(3))
    return seed, d


def unit_sphere3(seed, max_iters: int = 24):
    """Masked rejection sample in the unit ball: a lane stops drawing once
    accepted; after `max_iters` rounds an unaccepted lane takes (0,0,1)."""
    p = tuple(torch.full(seed.shape, 2.0, dtype=torch.float32,
                         device=seed.device) for _ in range(3))
    done = torch.zeros(seed.shape, dtype=torch.bool, device=seed.device)
    for _ in range(max_iters):
        seed_n, x = rng.next_rand(seed)
        seed_n, y = rng.next_rand(seed_n)
        seed_n, z = rng.next_rand(seed_n)
        p = where3(done, p, (x * 2.0 - 1.0, y * 2.0 - 1.0, z * 2.0 - 1.0))
        seed = torch.where(done, seed, seed_n)
        done = done | (dot3(p, p) <= 1.0)
    zero = torch.zeros_like(p[0])
    p = where3(done, p, (zero, zero, zero + 1.0))
    return seed, p
