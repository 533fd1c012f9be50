"""Render-state checkpoint and resume.

Port of `fyp_bidirectionalpathtracer_tpu/utils/checkpoint.py`, in the same
format: `<path>.npz` with the same keys, dtypes and shapes (the
accumulation buffer and counter, the BMFR history and frame number, the
camera pose and prevViewProj) and `<path>.json` with the same fields
(frame index, time, width, height).  So a checkpoint written by the JAX
package resumes in the port, and one written by the port resumes in JAX.

A renderer on a row mesh (`parallel/sharding.py`) saves the whole image's
state: every rank hands in its rows and rank 0 writes the files; on
resume each rank takes its rows of them.

The reference has no training-style checkpointing; its persistent state is
the accumulation buffer + counter and the BMFR history textures (SURVEY.md
§5).  The reset semantics (camera move, resize, option change) live in the
passes.
"""
from __future__ import annotations

import json
from dataclasses import replace

import numpy as np
import torch

from ..passes.accumulate import AccumState
from ..passes.bmfr import BMFRState
from .image import _numpy

_BMFR_FIELDS = ("prev_pos", "prev_norm", "prev_noisy", "prev_filtered", "frame_number")


def save_render_state(path: str, renderer) -> None:
    """Write the renderer's state to <path>.npz + <path>.json.  On a mesh
    every rank calls it (it gathers the rows) and rank 0 writes."""
    st = renderer.state
    mesh = renderer.mesh

    def rows(x):  # the whole image's field from every rank's rows
        return _numpy(x if mesh is None or x.dim() == 0 else mesh.gather_rows(x))

    arrays = {
        "accum_last": rows(st.accum.last_frame),
        "accum_count": rows(st.accum.count),
        **{f"bmfr_{name}": rows(getattr(st.bmfr, name)) for name in _BMFR_FIELDS},
        "camera_pos": _numpy(renderer.camera.pos_w),
        "camera_target": _numpy(renderer.camera.target),
        "camera_up": _numpy(renderer.camera.up),
        "prev_view_proj": _numpy(renderer.camera.prev_view_proj),
    }
    if mesh is not None and mesh.rank != 0:
        return
    np.savez_compressed(path + ".npz", **arrays)
    meta = {
        "frame_index": st.frame_index,
        "time": st.time,
        "width": renderer.cfg.width,
        "height": renderer.cfg.height,
    }
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh)


def load_render_state(path: str, renderer) -> None:
    """Restore state saved by save_render_state (either package's) into a
    renderer of the same resolution: the accumulation and BMFR histories
    on the renderer's device (on a mesh, the rank's rows of them), the
    camera on the host."""
    with open(path + ".json") as fh:
        meta = json.load(fh)
    if (meta["width"], meta["height"]) != (renderer.cfg.width, renderer.cfg.height):
        raise ValueError(
            f"checkpoint resolution {meta['width']}x{meta['height']} != "
            f"renderer {renderer.cfg.width}x{renderer.cfg.height}"
        )
    dev = renderer.baked.device
    mesh = renderer.mesh

    def rows(x):  # the renderer's rows of an image-shaped field
        return x if mesh is None or x.ndim == 0 else mesh.shard_rows(x)

    with np.load(path + ".npz") as z:
        renderer.state.accum = AccumState.from_arrays(
            {"last_frame": rows(z["accum_last"]), "count": z["accum_count"]}, device=dev)
        renderer.state.bmfr = BMFRState.from_arrays(
            {name: rows(z[f"bmfr_{name}"]) for name in _BMFR_FIELDS}, device=dev)
        pose = (z["camera_pos"], z["camera_target"], z["camera_up"])
        prev_view_proj = z["prev_view_proj"]
    renderer.state.frame_index = int(meta["frame_index"])
    renderer.state.time = float(meta["time"])
    renderer.set_camera_pose(*pose)
    renderer.camera = replace(renderer.camera, prev_view_proj=torch.tensor(
        np.asarray(prev_view_proj, np.float32)))
    renderer._prev_view_proj = renderer.camera.view_proj
