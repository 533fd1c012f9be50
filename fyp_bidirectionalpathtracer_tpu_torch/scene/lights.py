"""Analytic light table construction and evaluation.

Port of `fyp_bidirectionalpathtracer_tpu/scene/lights.py`:
`make_light_array` and the wavefront's `eval_light` (`:55`).  The frame
program (`accel/frame.py`) keeps its own per-lane form, as the JAX
megakernel does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.vecmath import dot, saturate
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


def eval_light(rows: torch.Tensor, index, surface_pos):
    """Evaluate light `index` ([...] int) at `surface_pos` ([..., 3]).

    `rows` is the [L, 13] table of `light_rows` (the bake keeps it on the
    device): the packed row the JAX function gathers from its LightArray.
    Returns (to_light [..., 3], intensity [..., 3], dist [...],
    light_pos [..., 3]).  Point lights: 1/(0.01^2 + d^2) falloff with the
    spot cutoff (Lights.slang:74-100); directional: L = -dirW and the
    pseudo position surfacePos - dirW |surfacePos - lightPos|
    (Lights.slang:62-71)."""
    from ..ops.lookup import table_lookup

    row = table_lookup(rows, index)
    lpos, ldir, linten = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    ltype = row[..., 9].to(torch.int32)
    cos_open, opening, penumbra = row[..., 10], row[..., 11], row[..., 12]

    to_l = lpos - surface_pos
    dist_sq = dot(to_l, to_l)
    valid = dist_sq > 1e-5
    zero = torch.zeros_like(dist_sq)
    dist_pt = torch.where(valid, torch.sqrt(torch.clamp(dist_sq, min=1e-20)), zero)
    l_pt = torch.where(valid[..., None],
                       to_l / torch.clamp(dist_pt, min=1e-20)[..., None],
                       torch.zeros_like(to_l))
    falloff = 1.0 / (0.0001 + dist_sq)
    cos_theta = -dot(l_pt, ldir)
    falloff = torch.where(cos_theta < cos_open, zero, falloff)
    pen_scale = saturate(
        ((opening - torch.acos(torch.clamp(cos_theta, -1.0, 1.0))) - penumbra)
        / torch.clamp(penumbra, min=1e-9))
    falloff = torch.where(penumbra > 0, falloff * pen_scale, falloff)
    inten_pt = linten * falloff[..., None]

    diff = surface_pos - lpos
    dist_dir = torch.sqrt(torch.clamp(dot(diff, diff), min=0.0))
    pos_dir = surface_pos - ldir * dist_dir[..., None]

    is_dir = (ltype == LIGHT_DIRECTIONAL)[..., None]
    to_light = torch.where(is_dir, -ldir, l_pt)
    intensity = torch.where(is_dir, linten, inten_pt)
    light_pos = torch.where(is_dir, pos_dir, lpos.expand_as(surface_pos))
    dvec = light_pos - surface_pos
    dist = torch.sqrt(torch.clamp(dot(dvec, dvec), min=0.0))
    return to_light, intensity, dist, light_pos
