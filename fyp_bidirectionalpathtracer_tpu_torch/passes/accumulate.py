"""Temporal accumulation pass (SimpleAccumulationPass rebuild).

Port of `fyp_bidirectionalpathtracer_tpu/passes/accumulate.py`: running
average (N*prev + cur)/(N+1) capped at max_accum_count
(accumulate.ps.hlsl:29-41), reset when the camera moves
(SimpleAccumulationPass.cpp:96-117).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import cuda


@dataclass(frozen=True)
class AccumState:
    last_frame: torch.Tensor   # [H,W,4] float32
    count: torch.Tensor        # [] int32, on the same device

    @classmethod
    def create(cls, height: int, width: int, device="cuda") -> "AccumState":
        """Zero history on `device` (the card unless named)."""
        device = cuda.resolve_device(device)
        return cls(
            last_frame=torch.zeros((height, width, 4), dtype=torch.float32,
                                   device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    @classmethod
    def from_arrays(cls, arrays: dict, device="cuda") -> "AccumState":
        """From {"last_frame": np [H,W,4], "count": np []} (the JAX
        AccumState's fields as numpy arrays), on the card unless named."""
        device = cuda.resolve_device(device)
        return cls(
            last_frame=torch.tensor(np.asarray(arrays["last_frame"], np.float32),
                                    device=device),
            count=torch.tensor(np.asarray(arrays["count"], np.int32), device=device),
        )


def accumulate(state: AccumState, cur_frame, max_accum_count: int,
               reset: bool = False):
    """Returns (new_state, output)."""
    count = torch.zeros_like(state.count) if reset else state.count
    capped = count >= max_accum_count
    n = count.to(torch.float32)
    out = torch.where(capped, state.last_frame,
                      (n * state.last_frame + cur_frame) / (n + 1.0))
    new_count = torch.where(capped, count, count + 1)
    return AccumState(last_frame=out, count=new_count), out


def camera_moved(prev_view_mat, view_mat) -> bool:
    """View-matrix inequality test (SimpleAccumulationPass.cpp:106-113)."""
    return not torch.equal(prev_view_mat, view_mat)
