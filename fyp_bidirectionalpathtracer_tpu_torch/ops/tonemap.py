"""Tone-mapping operators (Falcor Data/Effects/ToneMapping.ps.slang).

Port of `fyp_bidirectionalpathtracer_tpu/ops/tonemap.py`: the seven
operators of ToneMapping.h:51-59, Clamp (the BDPT app's default,
SimpleToneMappingPass.cpp:39), Linear, Reinhard, ReinhardModified,
HejiHableAlu, HableUc2 and Aces.  Exposure uses the shader's key /
average-luminance model, the average taken from the frame (a log mean)
unless the caller supplies it.  Plain torch, as JAX's is jnp.
"""
from __future__ import annotations

import torch

CLAMP = 0
LINEAR = 1
REINHARD = 2
REINHARD_MOD = 3
HEJI_HABLE_ALU = 4
HABLE_UC2 = 5
ACES = 6

OPERATOR_NAMES = {
    "clamp": CLAMP,
    "linear": LINEAR,
    "reinhard": REINHARD,
    "reinhard_mod": REINHARD_MOD,
    "heji_hable": HEJI_HABLE_ALU,
    "hable_uc2": HABLE_UC2,
    "aces": ACES,
}


def calc_luminance(c):
    """BT.601 weights, as the shader uses (ToneMapping.ps.slang:43-46)."""
    return 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]


def _reinhard(c):
    lum = calc_luminance(c)
    r = lum / (lum + 1.0)
    return c * (r / lum)[..., None]


def _reinhard_mod(c, max_white):
    lum = calc_luminance(c)
    r = lum * (1.0 + lum / (max_white * max_white)) * (1.0 + lum)
    return c * (r / lum)[..., None]


def _heji_hable(c):
    c = torch.clamp(c - 0.004, min=0.0)
    c = (c * (6.2 * c + 0.5)) / (c * (6.2 * c + 1.7) + 0.06)
    return torch.pow(c, 2.2)  # includes sRGB, as the shader's does


def _uc2_curve(c):
    a, b, cc, d, e, f = 0.22, 0.3, 0.1, 0.2, 0.01, 0.3
    return ((c * (a * c + cc * b) + d * e) / (c * (a * c + b) + d * f)) - e / f


def _hable_uc2(c, white_scale):
    c = _uc2_curve(2.0 * c)
    return c / _uc2_curve(torch.tensor(white_scale, dtype=torch.float32, device=c.device))


def _aces(c):
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e), 0.0, 1.0)


def tone_map(color: torch.Tensor, operator: int = CLAMP, exposure_key: float = 0.042,
             max_white_luminance: float = 1.0, white_scale: float = 11.2,
             avg_luminance=None) -> torch.Tensor:
    """Exposure and the selected operator on [..., 3] linear colour."""
    if operator == CLAMP:
        return torch.clamp(color, 0.0, 1.0)
    if avg_luminance is None:
        lum = calc_luminance(color)
        avg_luminance = torch.exp(torch.mean(torch.log(torch.clamp(lum, min=1e-4))))
    exposed = color * (exposure_key / avg_luminance)
    if operator == LINEAR:
        out = exposed
    elif operator == REINHARD:
        out = _reinhard(exposed)
    elif operator == REINHARD_MOD:
        out = _reinhard_mod(exposed, max_white_luminance)
    elif operator == HEJI_HABLE_ALU:
        out = _heji_hable(exposed)
    elif operator == HABLE_UC2:
        out = _hable_uc2(exposed, white_scale)
    elif operator == ACES:
        out = _aces(exposed)
    else:
        raise ValueError(f"unknown tone-map operator {operator}")
    return torch.clamp(out, 0.0, 1.0)
