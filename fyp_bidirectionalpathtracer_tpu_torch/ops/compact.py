"""Stable stream compaction of splat updates: kernel K2.

Port of `fyp_bidirectionalpathtracer_tpu/ops/compact.py` (`compact_live`,
`:171`).  Only ~15% of the estimator-2 updates are live on the Cornell
frame; compacting them first lets the sort that groups them by pixel run
on the live ones only.

K2 replaces the TPU kernel `ops/compact.py:_kernel`; its CUDA source is
`csrc/compact.cu`: per-block live counts, an exclusive scan of the block
counts (`torch.cumsum`, as JAX scans its chunk counts in XLA outside the
Pallas kernel), then an in-block scan and scatter.  The output is exact:
the live (key, payload) pairs in source order, then sentinel keys with
zero payloads, plus the live count.  The TPU version's <=127-element
sentinel gaps at its 16K-chunk seams are a VMEM device and are not copied.
"""
from __future__ import annotations

import torch

from .. import cuda

BLOCK_ITEMS = 1024  # updates per CUDA block (256 threads x 4), csrc/compact.cu


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
    n_blocks = max(1, (u + BLOCK_ITEMS - 1) // BLOCK_ITEMS)
    lib = cuda.library()
    stream = cuda.stream(dev)
    counts = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    cuda.check_error("compact", lib.bdpt_compact_count(
        cuda.ptr(keys), u, n_targets, cuda.ptr(counts), stream))
    # exclusive block offsets plus the total at [n_blocks]
    offs = torch.zeros((n_blocks + 1,), dtype=torch.int32, device=dev)
    offs[1:] = torch.cumsum(counts, 0)
    out_k = torch.empty_like(keys)
    out_p = torch.empty_like(pay)
    cuda.check_launch("compact", lib.bdpt_compact_scatter(
        cuda.ptr(keys), cuda.ptr(pay), u, n_targets, sent, cuda.ptr(offs),
        cuda.ptr(out_k), cuda.ptr(out_p), stream))
    return out_k, out_p, offs[n_blocks:]
