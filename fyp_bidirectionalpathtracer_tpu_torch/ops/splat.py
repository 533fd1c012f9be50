"""Splat accumulation: scatter-add of non-negative rgba contributions.

Port of `fyp_bidirectionalpathtracer_tpu/ops/splat.py`, every mode of its
`scatter_add_rgba` (`:161`) and the in-kernel-packed
`scatter_add_rgba_prepacked` (`:203`):

- `direct` (`:18`): four flat scatter-adds in update order;
- `sorted` (`:30`): a stable sort by pixel, segment totals as the float32
  prefix sum minus the prefix carried to each segment's start (`cummax`,
  valid because the values are >= 0), one add a pixel;
- `packed` (`:62`): each value quantized to int32 fixed point at 2^-18,
  int32 prefix sums whose differences are exact under 32-bit wraparound
  (computed in int64 and wrapped as XLA's int32 wraps), a scatter-max of
  each pixel's segment end and two gathers; alpha the count when it is;
- `complex` (`:134`): two scatter-adds of (r, g) and (b, alpha) pairs, the
  float-pair form of JAX's two complex64 scatter-adds;
- the tiled modes `tiled`, `tiled_bf16`, `tiled_bf16w`, `tiled_rgb8e` and
  `tiled_sortonly` (`ops/splat_tile.py`), and `auto`;
- `skip`: zeros (timing attribution: the reduction is left out).

JAX computes `sorted`, `packed`, `complex` and `skip` in jnp outside any
Pallas kernel, so they are plain torch here.  On a CUDA device the tiled
modes group the updates by pixel with a stable sort and sum them with a
hand-written kernel: `tiled_rgb8e` through K2 (compaction) + sort + K3,
every other tiled reduction through K5 (`ops/splat_tile.py`);
`tiled_sortonly` keeps the sort and runs no reduction.  'auto' is
`tiled_rgb8e` when alpha is a count (the estimator-2 splat, as on the TPU)
and `tiled_bf16w` otherwise; on the CPU it is `direct`.
"""
from __future__ import annotations

import torch

from .splat_tile import scatter_add_rgba_tiled, scatter_add_rgba_tiled_prepacked

_PACKS = {"tiled": "f32", "tiled_bf16": "bf16", "tiled_bf16w": "bf16",
          "tiled_rgb8e": "rgb8e", "tiled_sortonly": "f32"}
PACKED_SCALE_BITS = 18  # fixed point: a 2^-18 quantum, 8192 the largest pixel total


def scatter_add_rgba_direct(lin, rgb, alpha, n_targets: int) -> torch.Tensor:
    """Four flat scatter-adds in update order.  lin [U] (outside
    [0, n_targets) dropped), rgb [U, 3], alpha [U] -> [n_targets, 4]."""
    keep = (lin >= 0) & (lin < n_targets)
    idx = lin[keep].long()
    vals = torch.cat([rgb, alpha[:, None]], dim=1)[keep]
    out = torch.zeros((n_targets, 4), dtype=torch.float32, device=lin.device)
    return out.index_add_(0, idx, vals)


def _sorted_by_pixel(lin, cols, n_targets: int):
    """The keys min(lin, n_targets) stable-sorted, and `cols` [U, C] in
    that order (every dropped update shares the key n_targets)."""
    keys = torch.clamp(lin, max=n_targets)
    ls, order = torch.sort(keys, stable=True)
    return ls, cols[order]


def _bounds(ls):
    """is_first, is_last [U] of the runs of equal sorted keys."""
    step = ls[1:] != ls[:-1]
    one = torch.ones(1, dtype=torch.bool, device=ls.device)
    return torch.cat([one, step]), torch.cat([step, one])


def scatter_add_rgba_sorted(lin, rgb, alpha, n_targets: int) -> torch.Tensor:
    """Stable sort by pixel, segment totals by cumsum minus cummax, and one
    add a pixel (JAX `scatter_add_rgba_sorted`).  Exact up to the rounding
    of the float32 prefix sums.  Negative targets are JAX's wrapped
    indices, so callers pass them >= 0 or dropped as >= n_targets."""
    ls, vals = _sorted_by_pixel(lin, torch.cat([rgb, alpha[:, None]], 1), n_targets)
    is_first, is_last = _bounds(ls)
    vals = vals.T.contiguous()  # [4, U]: each scan runs along a row
    cs = torch.cumsum(vals, 1)
    # the prefix just before each segment's start, carried forward; cummax
    # holds because the values are >= 0 (the prefix sums do not decrease)
    start = torch.where(is_first, cs - vals, torch.zeros_like(cs))
    tot = cs - torch.cummax(start, 1).values
    keep = is_last & (ls >= 0) & (ls < n_targets)
    out = torch.zeros((n_targets, 4), dtype=torch.float32, device=lin.device)
    return out.index_add_(0, ls[keep].long(), tot[:, keep].T)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its low 32 bits as int32, two's complement (XLA's wrap)."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: saturating, NaN -> 0."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64).to(torch.int32)


def scatter_add_rgba_packed(lin, rgb, alpha, n_targets: int,
                            alpha_is_count: bool = False) -> torch.Tensor:
    """Stable sort, int32 fixed-point prefix sums, a scatter-max of each
    pixel's segment end and two gathers (JAX `scatter_add_rgba_packed`):
    a pixel's total is the wrap-exact difference of two prefixes, so the
    only deviation from the exact sum is the 2^-18 quantization of each
    value (while a pixel's channel total stays below 2^13).  With
    `alpha_is_count` alpha is the pixel's update count."""
    n = lin.shape[0]
    dev = lin.device
    cols = rgb if alpha_is_count else torch.cat([rgb, alpha[:, None]], 1)
    ls, vals = _sorted_by_pixel(lin, cols, n_targets)
    is_first, _ = _bounds(ls)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    # [C, U]: each scan runs along a row
    vi = _to_int32(torch.round(vals.T * float(1 << PACKED_SCALE_BITS))).to(torch.int64)
    incl = _wrap32(torch.cumsum(vi, 1)).to(torch.int64)
    excl = _wrap32(incl - vi).to(torch.int64)
    seg_start = torch.cummax(torch.where(is_first, iota, 0), 0).values
    keep = (ls >= 0) & (ls < n_targets)
    pos = torch.full((n_targets,), -1, dtype=torch.int64, device=dev)
    pos.scatter_reduce_(0, ls[keep].long(), iota[keep], "amax")
    empty = pos < 0
    pos_c = torch.where(empty, 0, pos)
    start = seg_start[pos_c] if n else pos_c
    if n:
        tot = (_wrap32(incl[:, pos_c] - excl[:, start]).T.to(torch.float32)
               / float(1 << PACKED_SCALE_BITS))
    else:
        tot = torch.zeros((n_targets, cols.shape[1]), dtype=torch.float32, device=dev)
    if alpha_is_count:
        tot = torch.cat([tot, (pos_c - start + 1).to(torch.float32)[:, None]], 1)
    return torch.where(empty[:, None], torch.zeros_like(tot), tot)


def scatter_add_rgba_complex(lin, rgb, alpha, n_targets: int) -> torch.Tensor:
    """Two scatter-adds of float pairs, (r, g) and (b, alpha): the
    componentwise sum of JAX's two complex64 scatter-adds (`:134`)."""
    keep = (lin >= 0) & (lin < n_targets)
    idx = lin[keep].long()
    pairs = []
    for a, b in ((rgb[:, 0], rgb[:, 1]), (rgb[:, 2], alpha)):
        out = torch.zeros((n_targets, 2), dtype=torch.float32, device=lin.device)
        pairs.append(out.index_add_(0, idx, torch.stack([a, b], 1)[keep]))
    return torch.cat(pairs, 1)


MODES = {
    "direct": scatter_add_rgba_direct,
    "sorted": scatter_add_rgba_sorted,
    "complex": scatter_add_rgba_complex,
}


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
                     alpha_is_count: bool = False, segments: int = 1, *,
                     plain: bool = False) -> torch.Tensor:
    """Dispatch by mode (see the module doc); rgb8e needs non-negative rgb.
    `segments` (the tiled modes): the updates are S runs of U/S, one a
    light-tracing depth, each sorted on its own (`ops/splat_tile.py`).
    `plain=True` runs the kernels' plain versions.

    The wavefront's and the textured megakernel's estimator-2 splats come
    here with unpacked rows; the untextured megakernel packs in K1 and
    calls `scatter_add_rgba_prepacked` itself."""
    mode = resolve_mode(mode, lin.is_cuda, alpha_is_count)
    if mode == "skip":  # timing attribution only: no reduction
        return torch.zeros((n_targets, 4), dtype=torch.float32,
                           device=lin.device) + rgb[0, 0] * 0.0
    if mode in _PACKS:
        return scatter_add_rgba_tiled(
            lin, rgb, alpha, n_targets, alpha_is_count, pack=_PACKS[mode],
            mxu_bf16=mode in ("tiled_bf16w", "tiled_rgb8e"),
            sort_only=mode == "tiled_sortonly", segments=segments, plain=plain)
    if mode == "packed":
        return scatter_add_rgba_packed(lin, rgb, alpha, n_targets, alpha_is_count)
    if mode not in MODES:
        raise ValueError(f"unknown splat mode {mode!r}")
    return MODES[mode](lin, rgb, alpha, n_targets)
