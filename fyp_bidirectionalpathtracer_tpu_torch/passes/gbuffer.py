"""Per-frame camera jitter of the G-buffer and BDPT passes.

Port of `pixel_jitter_for_frame` in `fyp_bidirectionalpathtracer_tpu/
passes/gbuffer.py` (`:25-39`).  The primary hit and G-buffer rows
themselves come from the frame program (`accel/frame.py`).
"""
from __future__ import annotations

import torch

from ..core import rng, samplers


def pixel_jitter_for_frame(frame_count, mode: str = "msaa8") -> torch.Tensor:
    """Subpixel jitter in [0,1]^2 pixel units (float32 [2]).  msaa8 is
    kMSAA[frame % 8] / 16 + 0.5 (LightProbeGBufferPass.cpp:131-140)."""
    if mode == "none":
        return torch.tensor([0.5, 0.5], dtype=torch.float32)
    if mode == "msaa8":
        return samplers.msaa8_jitter(frame_count) + 0.5
    if mode == "random":
        seed = rng.tea_init(int(frame_count) & 0xFFFFFFFF, 0xDEAD)
        seed, u0, u1 = rng.next_rand2(seed)
        return torch.stack([u0, u1])
    raise ValueError(mode)
