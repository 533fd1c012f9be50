"""Per-pixel reduction of pixel-sorted rgb8e splat updates: kernel K3.

Port of `fyp_bidirectionalpathtracer_tpu/ops/splat_tile.py`:
`_pack_rgb8e` / `_unpack_rgb8e` (`:227-246`) and the payload-direct tile
kernel `_kernel_packed` (`:119`, launched by `_flat_reduce_packed`).

K3 replaces the TPU kernel `ops/splat_tile.py:_kernel_packed`; its CUDA
source is `csrc/splat_tile.cu`.  Given the stable-sorted live updates
(every key < n_targets) it writes [n_targets, 4] rgba, alpha = the number
of updates of the pixel.  Each pixel's updates are summed in sorted order,
which is source order (depth-major), so the sums are deterministic.  The
TPU kernel's one-hot MXU matmul and its capacity ladder are static-shape
devices of the TPU and are not carried over.

rgb8e: non-negative (r, g, b) -> one int32 of three 8-bit mantissas that
share a 5-bit exponent (bits 24:29); error <= 2^-8 of the update's
largest channel.
"""
from __future__ import annotations

import torch

from .. import cuda

TILE = 1024  # the sentinel key is n_targets rounded up to TILE, as in JAX


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
    """K3 wrapper.  keys: int32 [M] sorted ascending, all in [0, n_targets);
    pay: int32 [M] rgb8e.  Returns float32 [n_targets, 4]."""
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
