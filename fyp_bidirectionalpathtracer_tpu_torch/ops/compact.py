"""Stable stream compaction of splat updates: kernel K2.

Port of `fyp_bidirectionalpathtracer_tpu/ops/compact.py` (`compact_live`,
`:171`).  Only ~15% of the estimator-2 updates are live on the Cornell
frame; compacting them first lets the sort that groups them by pixel run
on the live ones only.

K2 replaces the TPU kernel `ops/compact.py:_kernel`; its CUDA source is
`csrc/compact.cu`: one pass with decoupled look-back.  A block takes a tile
of the updates by an atomic ticket, counts its live ones, publishes the
count, finds the live updates before its tile from its predecessors'
status words (the scan of the tile counts, which JAX runs in XLA outside
its Pallas kernel, happens inside the one launch), and writes its live
pairs in source order and its dead ones, as sentinel keys with zero
payloads, from the end of the output backwards.  The output is exact: the live (key, payload) pairs in
source order, then sentinel keys with zero payloads, plus the live count.
A call is two launches (the scratch's memset, the kernel) and no host
sync.  The TPU version's <=127-element sentinel gaps at its 16K-chunk
seams are a VMEM device and are not copied.
"""
from __future__ import annotations

import torch

from .. import cuda

TILE_ITEMS = 4096  # updates a tile (256 threads x 16), csrc/compact.cu kTileItems


def compact_plain(keys: torch.Tensor, pay: torch.Tensor, n_targets: int,
                  sent: int):
    """Plain K2: a torch.nonzero stable partition."""
    idx = torch.nonzero(keys < n_targets).reshape(-1)
    n_live = idx.numel()
    out_k = torch.full_like(keys, sent)
    out_p = torch.zeros_like(pay)
    out_k[:n_live] = keys[idx]
    out_p[:n_live] = pay[idx]
    return out_k, out_p, torch.tensor([n_live], dtype=torch.int32, device=keys.device)


def compact_live(keys: torch.Tensor, pay: torch.Tensor, n_targets: int, sent: int):
    """K2 wrapper.  keys, pay: int32 [U]; an update is live iff its key is
    < n_targets.  Returns (keys_c [U], pay_c [U], n_live int32 [1])."""
    cuda.check_tensor("keys", keys, torch.int32, keys.device)
    cuda.check_tensor("pay", pay, torch.int32, keys.device)
    if keys.dim() != 1 or pay.shape != keys.shape:
        raise ValueError(f"keys/pay must be equal 1-D shapes, got "
                         f"{tuple(keys.shape)} / {tuple(pay.shape)}")
    if keys.device.type == "cpu":
        return compact_plain(keys, pay, n_targets, sent)
    u = keys.numel()
    dev = keys.device
    n_tiles = max(1, (u + TILE_ITEMS - 1) // TILE_ITEMS)
    # the ticket counter and a status word a tile, zeroed by the launch
    scratch = torch.empty((n_tiles + 1,), dtype=torch.int64, device=dev)
    out_k = torch.empty_like(keys)
    out_p = torch.empty_like(pay)
    n_live = torch.empty((1,), dtype=torch.int32, device=dev)
    cuda.check_launch("compact", cuda.library().bdpt_compact(
        cuda.ptr(keys), cuda.ptr(pay), u, n_targets, sent, cuda.ptr(scratch), n_tiles,
        cuda.ptr(out_k), cuda.ptr(out_p), cuda.ptr(n_live), cuda.stream(dev)))
    return out_k, out_p, n_live
