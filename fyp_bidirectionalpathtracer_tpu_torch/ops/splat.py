"""Splat accumulation: scatter-add of non-negative rgba contributions.

Port of `fyp_bidirectionalpathtracer_tpu/ops/splat.py` for the modes the
slice runs: `direct` (`scatter_add_rgba_direct`, `:18`), `tiled_rgb8e`
and `auto` (`scatter_add_rgba`, `:161`), and the in-kernel-packed
`scatter_add_rgba_prepacked` (`:203`).  Other modes raise.
"""
from __future__ import annotations

import torch

from .compact import compact_live, compact_plain
from .splat_tile import TILE, pack_rgb8e, reduce_sorted_plain, splat_reduce

_MODES_ITEM = "ROADMAP Queue 2 item K5 (tiled splat modes)"


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
    [n_targets, 4], alpha = update count.

    K2 compacts the live updates, a stable sort groups them by pixel (the
    JAX package sorts with XLA outside any Pallas kernel), and K3 sums each
    pixel's run.  Sorting only the live prefix needs the live count on the
    host: one scalar read, and so one host sync, per frame.  `plain=True`
    runs the plain versions of K2 and K3 on any device."""
    compact, reduce = ((compact_plain, reduce_sorted_plain) if plain
                       else (compact_live, splat_reduce))
    sent = ((max(n_targets, 1) + TILE - 1) // TILE) * TILE
    keys = torch.where(lin < 0, sent, torch.clamp(lin, max=sent)).to(torch.int32)
    keys_c, pay_c, n_live = compact(keys, packed.contiguous(), n_targets, sent)
    n = int(n_live.item())
    ls, order = torch.sort(keys_c[:n], stable=True)
    return reduce(ls, pay_c[:n][order].contiguous(), n_targets)


def scatter_add_rgba(mode: str, lin, rgb, alpha, n_targets: int,
                     alpha_is_count: bool = False, *, plain: bool = False) -> torch.Tensor:
    """Dispatch by mode; 'auto' is 'tiled_rgb8e' on a CUDA device when alpha
    is a count (as on the TPU) and 'direct' elsewhere.  rgb8e needs
    non-negative rgb.

    The wavefront's estimator-2 splat comes here with unpacked rows: on a
    CUDA device 'auto' packs them and runs K2 + sort + K3 (`plain=True`:
    their plain versions).  The megakernel packs in K1 and calls
    `scatter_add_rgba_prepacked` itself."""
    if mode == "auto":
        mode = "tiled_rgb8e" if (lin.is_cuda and alpha_is_count) else "direct"
    if mode == "direct":
        return scatter_add_rgba_direct(lin, rgb, alpha, n_targets)
    if mode == "tiled_rgb8e":
        if not alpha_is_count:
            raise ValueError("mode 'tiled_rgb8e' requires alpha_is_count")
        packed = pack_rgb8e(rgb[:, 0], rgb[:, 1], rgb[:, 2])
        return scatter_add_rgba_prepacked(lin.to(torch.int32), packed, n_targets,
                                          plain=plain)
    raise NotImplementedError(f"splat mode {mode!r}; see {_MODES_ITEM}")
