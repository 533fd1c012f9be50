"""Analytic light table construction.

Port of `make_light_array` in `fyp_bidirectionalpathtracer_tpu/scene/
lights.py`.  Light evaluation lives in the frame program
(`accel/frame.py`), as it does in the JAX megakernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import DEFAULT_MAX_LIGHTS, LIGHT_DIRECTIONAL, LIGHT_POINT, LightArray


def make_light_array(lights: list[dict], capacity: int | None = None) -> LightArray:
    """Bake light dicts {type: 'point'|'dir', pos, dir, intensity,
    opening_angle?, penumbra_angle?} into a fixed-capacity table."""
    n = len(lights)
    cap = capacity or max(DEFAULT_MAX_LIGHTS, n)
    pos = np.zeros((cap, 3), np.float32)
    dirw = np.tile(np.asarray([0.0, -1.0, 0.0], np.float32), (cap, 1))
    inten = np.zeros((cap, 3), np.float32)
    typ = np.zeros(cap, np.int32)
    opening = np.full(cap, np.pi, np.float32)
    penumbra = np.zeros(cap, np.float32)
    for i, light in enumerate(lights):
        kind = light.get("type", "point")
        typ[i] = (LIGHT_DIRECTIONAL if kind in ("dir", "dir_light", "directional")
                  else LIGHT_POINT)
        pos[i] = np.asarray(light.get("pos", (0, 0, 0)), np.float32)
        d = np.asarray(light.get("dir", (0, -1, 0)), np.float32)
        nrm = np.linalg.norm(d)
        dirw[i] = d / nrm if nrm > 0 else d
        inten[i] = np.asarray(light.get("intensity", (1, 1, 1)), np.float32)
        opening[i] = np.float32(light.get("opening_angle", np.pi))
        penumbra[i] = np.float32(light.get("penumbra_angle", 0.0))
    return LightArray(
        pos_w=torch.from_numpy(pos),
        dir_w=torch.from_numpy(dirw),
        intensity=torch.from_numpy(inten),
        type=torch.from_numpy(typ),
        opening_angle=torch.from_numpy(opening),
        cos_opening_angle=torch.from_numpy(np.cos(opening)),
        penumbra_angle=torch.from_numpy(penumbra),
        count=n,
    )


def light_rows(lights: LightArray) -> torch.Tensor:
    """[L, 13] float32 rows in the frame kernel's layout: pos 0:3, dir 3:6,
    intensity 6:9, type 9, cos(opening) 10, opening 11, penumbra 12
    (the JAX `_frame_out` light_rows)."""
    return torch.cat([
        lights.pos_w, lights.dir_w, lights.intensity,
        lights.type.to(torch.float32)[:, None],
        lights.cos_opening_angle[:, None],
        lights.opening_angle[:, None],
        lights.penumbra_angle[:, None],
    ], dim=-1).to(torch.float32).contiguous()
