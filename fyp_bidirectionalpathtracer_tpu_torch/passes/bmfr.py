"""BMFR denoiser state and its disabled passthrough.

Port of `BMFRState.create` and the mDoDenoise gate of `bmfr_pass` in
`fyp_bidirectionalpathtracer_tpu/passes/bmfr.py` (`:52-65`, `:803-804`).
The denoiser itself is ROADMAP Queue 1 item 8; an enabled BMFR raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import cuda


@dataclass(frozen=True)
class BMFRState:
    """History textures (DenoisePass.h mInputTex) and the frame counter."""

    prev_pos: torch.Tensor       # [H,W,4]
    prev_norm: torch.Tensor      # [H,W,4]
    prev_noisy: torch.Tensor     # [H,W,4]
    prev_filtered: torch.Tensor  # [H,W,4]
    frame_number: torch.Tensor   # [] int32

    @classmethod
    def create(cls, height: int, width: int, device="cuda") -> "BMFRState":
        device = cuda.resolve_device(device)
        z = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
        return cls(prev_pos=z, prev_norm=z, prev_noisy=z, prev_filtered=z,
                   frame_number=torch.zeros((), dtype=torch.int32, device=device))


def bmfr_pass(state: BMFRState, channels: dict, camera, cfg):
    """Disabled (the reference's default): a plain blit of Accumulated."""
    if not cfg.enabled or not (cfg.preprocess or cfg.regression or cfg.postprocess):
        return state, channels["Accumulated"]
    raise NotImplementedError(
        "BMFR denoising is not ported yet; see ROADMAP Queue 1 item 8")
