"""Splat accumulation: scatter-add of non-negative rgba contributions.

Port of `fyp_bidirectionalpathtracer_tpu/ops/splat.py` for the modes the
renderer runs: `direct` (`scatter_add_rgba_direct`, `:18`), the tiled
modes `tiled`, `tiled_bf16`, `tiled_bf16w`, `tiled_rgb8e` and `auto`
(`scatter_add_rgba`, `:161`), and the in-kernel-packed
`scatter_add_rgba_prepacked` (`:203`).

On a CUDA device the tiled modes group the updates by pixel with a stable
sort and sum them with a hand-written kernel: `tiled_rgb8e` through K2
(compaction) + sort + K3, every other tiled reduction through K5
(`ops/splat_tile.py`).  'auto' is `tiled_rgb8e` when alpha is a count
(the estimator-2 splat, as on the TPU) and `tiled_bf16w` otherwise; on the
CPU it is `direct`.  The timing-attribution modes `tiled_sortonly` and
`skip` and the TPU scatter workarounds `sorted`, `packed` and `complex`
raise.
"""
from __future__ import annotations

import torch

from .splat_tile import scatter_add_rgba_tiled, scatter_add_rgba_tiled_prepacked

_NOT_PORTED = "ROADMAP 'Not ported now' (splat modes)"
_PACKS = {"tiled": "f32", "tiled_bf16": "bf16", "tiled_bf16w": "bf16",
          "tiled_rgb8e": "rgb8e"}


def scatter_add_rgba_direct(lin, rgb, alpha, n_targets: int) -> torch.Tensor:
    """Four flat scatter-adds in update order.  lin [U] (outside
    [0, n_targets) dropped), rgb [U, 3], alpha [U] -> [n_targets, 4]."""
    keep = (lin >= 0) & (lin < n_targets)
    idx = lin[keep].long()
    vals = torch.cat([rgb, alpha[:, None]], dim=1)[keep]
    out = torch.zeros((n_targets, 4), dtype=torch.float32, device=lin.device)
    return out.index_add_(0, idx, vals)


def scatter_add_rgba_prepacked(lin, packed, n_targets: int, *,
                               plain: bool = False) -> torch.Tensor:
    """rgb8e splat of updates packed in the frame kernel: lin [U] int32
    targets (outside [0, n_targets) dropped), packed [U] int32 rgb8e ->
    [n_targets, 4], alpha = update count: K2 + sort + K3 (`plain=True`:
    their plain versions)."""
    return scatter_add_rgba_tiled_prepacked(lin, packed, n_targets, plain=plain)


def resolve_mode(mode: str, on_cuda: bool, alpha_is_count: bool) -> str:
    """The mode 'auto' stands for: on a CUDA device `tiled_rgb8e` for a
    count alpha and `tiled_bf16w` otherwise (JAX `ops/splat.py:176-178`
    on the TPU), `direct` elsewhere; any other mode is itself."""
    if mode != "auto":
        return mode
    if on_cuda:
        return "tiled_rgb8e" if alpha_is_count else "tiled_bf16w"
    return "direct"


def scatter_add_rgba(mode: str, lin, rgb, alpha, n_targets: int,
                     alpha_is_count: bool = False, *,
                     plain: bool = False) -> torch.Tensor:
    """Dispatch by mode (see the module doc); rgb8e needs non-negative rgb.
    `plain=True` runs the kernels' plain versions.

    The wavefront's and the textured megakernel's estimator-2 splats come
    here with unpacked rows; the untextured megakernel packs in K1 and
    calls `scatter_add_rgba_prepacked` itself."""
    mode = resolve_mode(mode, lin.is_cuda, alpha_is_count)
    if mode == "direct":
        return scatter_add_rgba_direct(lin, rgb, alpha, n_targets)
    if mode in _PACKS:
        return scatter_add_rgba_tiled(
            lin, rgb, alpha, n_targets, alpha_is_count, pack=_PACKS[mode],
            mxu_bf16=mode in ("tiled_bf16w", "tiled_rgb8e"), plain=plain)
    raise NotImplementedError(f"splat mode {mode!r}; see {_NOT_PORTED}")
