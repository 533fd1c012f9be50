"""Environment map lookup of the G-buffer's miss rays.

Port of `fyp_bidirectionalpathtracer_tpu/ops/envmap.py` for the constant
(1x1) probe the slice supports: nearest (the reference's miss shader,
lightProbeGBuffer.rt.hlsl:64-74) and bilinear both return the one texel.
A larger map raises: lat-long maps come with ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import torch

_ENV_ITEM = "ROADMAP Queue 1 item 10 (env maps)"


def _constant(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    h, w = env_map.shape[0], env_map.shape[1]
    if (h, w) != (1, 1):
        raise NotImplementedError(f"env map of shape {tuple(env_map.shape)}; see {_ENV_ITEM}")
    rgb = env_map[0, 0, :3].to(device=direction.device, dtype=torch.float32)
    return rgb.expand(direction.shape[:-1] + (3,))


def eval_env_nearest(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """env_map [H, W, 4], direction [..., 3] -> [..., 3] rgb."""
    return _constant(env_map, direction)


def eval_env_bilinear(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long fetch; on a 1x1 probe, the texel."""
    return _constant(env_map, direction)
