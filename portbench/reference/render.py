"""Frames of a camera sequence, as a viewer of the app sees them.

`frames(scene, camera, cfg, poses, first_index, history)` renders one
frame a pose from a fresh accumulation, frame i at BDPT frame count
0x1337 + first_index + i: the frame's image, its running mean with the
frames before it at the same pose (at most `max_accum_count`, restarted
where the pose changes), and, where BMFR runs, the denoised output and
the history it leaves.  The previous view-projection matrix BMFR reads is
the frame's own: the app rolls it when the camera is moved, before the
frame (Camera::beginFrame after the pose), as the JAX package does.

`control()` is the correctness check's control: inside it every floating
result of a torch function is rounded to bfloat16, as if the reference
were computed in bfloat16.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from . import bdpt, bmfr
from .scene import Camera

BDPT_FRAME_INIT = 0x1337


def frames(scene, camera: dict, cfg: dict, poses, first_index: int,
           history: bmfr.History | None = None, denoise: bool = False) -> dict:
    """The last frame's channels: `Accumulated`, and with `denoise`
    `PipelineOutput` and `history` (what BMFR leaves), from `history`
    (fresh where None)."""
    width, height = cfg["width"], cfg["height"]
    dev, dt = scene.v0.device, scene.v0.dtype
    mean, count, last_pose = None, 0, None
    out = {}
    for k, pose in enumerate(poses):
        cam = Camera.at(camera, pose, width / height, dev, dt)
        if pose != last_pose:
            count = 0
        last_pose = pose
        count_f = (BDPT_FRAME_INIT + first_index + k) & 0xFFFFFFFF
        image, gbuf = bdpt.frame(scene, cam, width, height, count_f, cfg["max_depth"])
        if count < cfg["max_accum_count"]:
            mean = image if count == 0 else (count * mean + image) / (count + 1)
            count += 1
        out = {"Accumulated": mean}
        if denoise:
            if history is None:
                history = bmfr.History.fresh(height, width, dev, dt)
            result, history = bmfr.step(history, gbuf["WorldPosition"], gbuf["WorldNormal"],
                                        gbuf["MaterialDiffuse"], mean, cam.view_proj)
            out.update(PipelineOutput=result, history=history)
    return out


class _Bfloat16(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name == "__setitem__" or (name.endswith("_") and not name.endswith("__")):
            target = args[0]
            if isinstance(target, torch.Tensor) and target.is_floating_point():
                target.copy_(target.to(torch.bfloat16))
            return out
        return _round(out)


def _round(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    if type(x) is tuple:
        return tuple(_round(v) for v in x)
    return x


def control() -> TorchFunctionMode:
    """The reference as if computed in bfloat16."""
    return _Bfloat16()
