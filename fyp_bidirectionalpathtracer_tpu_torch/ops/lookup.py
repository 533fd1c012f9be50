"""Small-table row lookup.

Port of `fyp_bidirectionalpathtracer_tpu/ops/lookup.py`.  The JAX function
looks rows of a table of at most 64 rows up by a one-hot matmul, because a
gather is slow on the TPU; a one-hot product of exact 0/1 weights picks the
same row, so the port gathers.
"""
from __future__ import annotations

import torch


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [M, K], idx [...] int -> [..., K] (idx on table's device)."""
    return table[idx.long()]
