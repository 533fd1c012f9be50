"""Environment (light-probe) map lookup of the G-buffer's miss rays.

Port of `fyp_bidirectionalpathtracer_tpu/ops/envmap.py`: the reference's
miss shader writes gEnvMap[uint2(uv * res)], a nearest lat-long fetch
(lightProbeGBuffer.rt.hlsl:64-74); bilinear is the quality option.  A 1x1
probe is a broadcast of its texel, with no gather.  The lookups are torch
gathers on the map's device (JAX's are XLA gathers: no TPU kernel).
"""
from __future__ import annotations

import torch

from .. import cuda
from ..core.vecmath import ws_vector_to_latlong


def _texel(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    rgb = env_map[0, 0, :3].to(device=direction.device, dtype=torch.float32)
    return rgb.expand(direction.shape[:-1] + (3,))


def eval_env_nearest(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """env_map [H, W, 4], direction [..., 3] -> [..., 3] rgb."""
    h, w = env_map.shape[0], env_map.shape[1]
    if h == 1 and w == 1:
        return _texel(env_map, direction)
    u, v = ws_vector_to_latlong(direction)
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return env_map[y, x, :3]


def procedural_env(color=(0.517, 0.569, 0.761), res: int = 128,
                   device="cuda") -> torch.Tensor:
    """The sky-blue fallback probe: a res x res constant map
    (ResourceManager.cpp:77-111), on the card unless `device` names
    another."""
    rgba = torch.tensor(tuple(color) + (1.0,), dtype=torch.float32,
                        device=cuda.resolve_device(device))
    return rgba.expand(res, res, 4)


def eval_env_bilinear(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long fetch: wraps in u (longitude), clamps in v
    (latitude)."""
    h, w = env_map.shape[0], env_map.shape[1]
    if h == 1 and w == 1:
        return _texel(env_map, direction)
    u, v = ws_vector_to_latlong(direction)
    x = u * w - 0.5
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    top = env_map[y0i, x0i, :3] * (1 - fx) + env_map[y0i, x1i, :3] * fx
    bot = env_map[y1i, x0i, :3] * (1 - fx) + env_map[y1i, x1i, :3] * fx
    return top * (1 - fy) + bot * fy
