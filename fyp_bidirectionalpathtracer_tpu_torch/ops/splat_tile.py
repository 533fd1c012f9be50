"""Per-pixel reductions of pixel-sorted splat updates: kernels K3 and K5.

Port of `fyp_bidirectionalpathtracer_tpu/ops/splat_tile.py`:
`_pack_rgb8e` / `_unpack_rgb8e` (`:227-246`), `_pack2bf16` /
`_unpack2bf16` (`:249-265`), `scatter_add_rgba_tiled` (`:370`),
`scatter_add_rgba_tiled_prepacked` (`:319`) and the two tile kernels.

K3 replaces the TPU kernel `ops/splat_tile.py:_kernel_packed` (`:119`); its
CUDA source is `csrc/splat_rows.cu`, where it is K5's kernel with an rgb8e
payload.  Given the stable-sorted live rgb8e updates it writes
[n_targets, 4] rgba, alpha = the number of updates of the pixel.

K5 replaces the TPU kernel `ops/splat_tile.py:_kernel` (`:44`, launched by
`_tile_call` `:268`); its CUDA source is `csrc/splat_rows.cu`.  It sums
unpacked value rows ([3 or 4, M], float32 or bfloat16) of the stable-sorted
updates, each pixel's run in sorted (= source) order.  JAX's
`splat_segments` (each depth sorted on its own, a TPU sort-cost knob) is
accepted and ignored: a stable sort of the depth-concatenated updates gives
each pixel the same order, so the sums are the same bit for bit.

Both kernels sum a pixel's updates in that order, one float32 add at a
time, so the sums are deterministic and their plain versions here equal
them bit for bit.  The TPU kernels' one-hot MXU matmul over 1024-pixel
tiles, their K=2048 DMA blocks and double buffers, and the capacity ladder
are devices of the TPU and are not carried over.

rgb8e: non-negative (r, g, b) -> one int32 of three 8-bit mantissas that
share a 5-bit exponent (bits 24:29); error <= 2^-8 of the update's
largest channel.  bf16x2: two float32 -> one int32 holding their bfloat16
bits (round to nearest even), high half first.
"""
from __future__ import annotations

import torch

from .. import cuda
from .compact import compact_live, compact_plain

TILE = 1024  # the sentinel key is n_targets rounded up to TILE, as in JAX


def sentinel(n_targets: int) -> int:
    """The key of a dropped update: n_targets rounded up to TILE."""
    return ((max(n_targets, 1) + TILE - 1) // TILE) * TILE


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e (float32) for integer e in [-126, 127]."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def pack_rgb8e(r, g, b) -> torch.Tensor:
    """Non-negative float32 (r, g, b) -> int32 rgb8e (rounds half to even)."""
    mx = torch.maximum(torch.maximum(r, g), b)
    eb = (mx.contiguous().view(torch.int32) >> 23) & 0xFF
    e = torch.clamp(eb - 126, -16, 15)           # floor(log2(mx)) + 1
    scale = _exp2i(8 - e)

    def q(c):
        return torch.clamp(torch.round(c * scale), 0.0, 255.0).to(torch.int32)

    return q(r) | (q(g) << 8) | (q(b) << 16) | ((e + 16) << 24).to(torch.int32)


def unpack_rgb8e(p: torch.Tensor):
    """int32 rgb8e -> float32 (r, g, b)."""
    inv = _exp2i(((p >> 24) & 0x1F) - 16 - 8)
    return tuple(((p >> sh) & 0xFF).to(torch.float32) * inv for sh in (0, 8, 16))


def pack2bf16(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Two float32 -> one int32 carrying (bf16(x) << 16) | bf16(y)."""
    def bits(c):
        return c.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF

    return (bits(x) << 16) | bits(y)


def unpack2bf16(p: torch.Tensor):
    """int32 bf16x2 -> the two float32 values (exact: bf16 widens)."""
    return ((p & -0x10000).view(torch.float32),
            (p << 16).view(torch.float32))


# --------------------------------------------------------------------- K3
def reduce_sorted_plain(keys: torch.Tensor, pay: torch.Tensor,
                        n_targets: int) -> torch.Tensor:
    """Plain K3: searchsorted run bounds plus a segment sum -> [n_targets, 4]."""
    bounds = torch.arange(n_targets + 1, dtype=keys.dtype, device=keys.device)
    off = torch.searchsorted(keys, bounds)
    counts = off[1:] - off[:-1]
    rgb = torch.stack(unpack_rgb8e(pay), dim=1)  # [M, 3]
    sums = torch.segment_reduce(rgb, "sum", lengths=counts, axis=0, unsafe=True)
    return torch.cat([sums, counts.to(torch.float32)[:, None]], dim=1)


def splat_reduce(keys: torch.Tensor, pay: torch.Tensor, n_targets: int) -> torch.Tensor:
    """K3 wrapper.  keys: int32 [M] sorted ascending, all in [0, n_targets)
    (the kernel also drops keys >= n_targets at the end, as K5 does); pay:
    int32 [M] rgb8e.  Returns float32 [n_targets, 4]."""
    cuda.check_tensor("keys", keys, torch.int32, keys.device)
    cuda.check_tensor("pay", pay, torch.int32, keys.device)
    if keys.dim() != 1 or pay.shape != keys.shape:
        raise ValueError(f"keys/pay must be equal 1-D shapes, got "
                         f"{tuple(keys.shape)} / {tuple(pay.shape)}")
    if keys.device.type == "cpu":
        return reduce_sorted_plain(keys, pay, n_targets)
    out = torch.empty((n_targets, 4), dtype=torch.float32, device=keys.device)
    cuda.check_launch("splat_tile", cuda.library().bdpt_splat_reduce(
        cuda.ptr(keys), cuda.ptr(pay), keys.numel(), n_targets, cuda.ptr(out),
        cuda.stream(keys.device)))
    return out


def scatter_add_rgba_tiled_prepacked(lin, packed, n_targets: int, *,
                                     plain: bool = False) -> torch.Tensor:
    """rgb8e splat of packed updates: lin [U] targets (outside
    [0, n_targets) dropped), packed [U] int32 rgb8e -> [n_targets, 4],
    alpha = update count.

    K2 compacts the live updates, a stable sort groups them by pixel (the
    JAX package sorts with XLA outside any Pallas kernel), and K3 sums each
    pixel's run.  Sorting only the live prefix needs the live count on the
    host: one scalar read, and so one host sync, per call.  `plain=True`
    runs the plain versions of K2 and K3 on any device."""
    compact, reduce = ((compact_plain, reduce_sorted_plain) if plain
                       else (compact_live, splat_reduce))
    sent = sentinel(n_targets)
    keys = torch.where(lin < 0, sent, torch.clamp(lin, max=sent)).to(torch.int32)
    keys_c, pay_c, n_live = compact(keys, packed.contiguous(), n_targets, sent)
    n = int(n_live.item())
    ls, order = torch.sort(keys_c[:n], stable=True)
    return reduce(ls, pay_c[:n][order].contiguous(), n_targets)


# --------------------------------------------------------------------- K5
def reduce_rows_plain(keys: torch.Tensor, vals: torch.Tensor, n_targets: int) -> torch.Tensor:
    """Plain K5: each pixel's updates summed one float32 add at a time, in
    stable-sorted order; round r adds every pixel's r-th update (one add a
    pixel a round)."""
    rows = vals.to(torch.float32)
    ks, order = torch.sort(keys, stable=True)
    live = ks < n_targets
    ks, order = ks[live], order[live]
    rank = torch.arange(ks.numel(), device=ks.device) - torch.searchsorted(ks, ks)
    out = torch.zeros((n_targets, 4), dtype=torch.float32, device=keys.device)
    for r in range(int(rank.max()) + 1 if ks.numel() else 0):
        sel = rank == r
        upd = rows[:, order[sel]].T
        if rows.shape[0] == 3:  # alpha counts the updates
            upd = torch.cat([upd, torch.ones_like(upd[:, :1])], 1)
        out.index_add_(0, ks[sel].long(), upd)
    return out


def splat_reduce_rows(keys: torch.Tensor, vals: torch.Tensor, n_targets: int) -> torch.Tensor:
    """K5 wrapper.  keys: int32 [M] sorted ascending (keys >= n_targets are
    dropped updates); vals: float32 or bfloat16 [4, M] rows r, g, b, alpha,
    or [3, M] when alpha is the count of updates.  Returns float32
    [n_targets, 4]."""
    cuda.check_tensor("keys", keys, torch.int32, keys.device)
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    cuda.check_tensor("vals", vals, vals.dtype, keys.device)
    m = keys.numel()
    if keys.dim() != 1 or vals.dim() != 2 or vals.shape[0] not in (3, 4) \
            or vals.shape[1] != m:
        raise ValueError(f"keys [M] and vals [3 or 4, M] expected, got "
                         f"{tuple(keys.shape)} / {tuple(vals.shape)}")
    if keys.device.type == "cpu":
        return reduce_rows_plain(keys, vals, n_targets)
    out = torch.empty((n_targets, 4), dtype=torch.float32, device=keys.device)
    bf16 = vals.dtype == torch.bfloat16
    cuda.check_launch("splat_rows", cuda.library().bdpt_splat_rows(
        cuda.ptr(keys), cuda.ptr(vals), int(bf16), vals.shape[0], m, n_targets,
        cuda.ptr(out), cuda.stream(keys.device)))
    return out


def scatter_add_rgba_tiled(lin, rgb, alpha, n_targets: int, alpha_is_count: bool = False,
                           pack: str = "f32", mxu_bf16: bool = False, segments: int = 1, *,
                           plain: bool = False) -> torch.Tensor:
    """lin [U] targets (outside [0, n_targets) dropped), rgb [U, 3],
    alpha [U] -> [n_targets, 4] (JAX `scatter_add_rgba_tiled`).

    `pack` trades per-update input precision for sort payload (the sums
    stay float32): 'f32' exact; 'bf16' (r, g) [and (b, alpha) unless alpha
    is a count] as bf16x2 words; 'rgb8e' (alpha_is_count only) one word,
    through K2 + sort + K3 (`scatter_add_rgba_tiled_prepacked`), as JAX
    takes `_kernel_packed`.  `mxu_bf16` casts the value rows to bfloat16
    before K5, as JAX's bf16 MXU path does.  `segments` is accepted and
    ignored (see the module doc).  `plain=True` runs the kernels' plain
    versions."""
    del segments
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    if pack == "rgb8e":
        if not alpha_is_count:
            raise ValueError("pack='rgb8e' requires alpha_is_count")
        return scatter_add_rgba_tiled_prepacked(lin, pack_rgb8e(r, g, b), n_targets,
                                                plain=plain)
    if pack not in ("f32", "bf16"):
        raise ValueError(f"unknown pack {pack!r}")
    sent = sentinel(n_targets)
    keys = torch.where(lin < 0, sent, torch.clamp(lin, max=sent)).to(torch.int32)
    ls, order = torch.sort(keys, stable=True)
    if pack == "f32":
        rows = [c[order] for c in ((r, g, b) if alpha_is_count else (r, g, b, alpha))]
    elif alpha_is_count:
        rows = [*unpack2bf16(pack2bf16(r, g)[order]), b[order]]
    else:
        rows = [*unpack2bf16(pack2bf16(r, g)[order]), *unpack2bf16(pack2bf16(b, alpha)[order])]
    vals = torch.stack(rows).to(torch.bfloat16 if mxu_bf16 else torch.float32)
    reduce = reduce_rows_plain if plain else splat_reduce_rows
    return reduce(ls, vals.contiguous(), n_targets)
