"""Per-lane TEA/LCG RNG, bit-exact with the reference's shader RNG.

Port of `fyp_bidirectionalpathtracer_tpu/core/rng.py`: each pixel is seeded
with a 16-round TEA hash of (pixelIndex, frameCount) and draws floats from
the Numerical-Recipes LCG (BDPTUtils.hlsli:91-110).

Torch has no full uint32 arithmetic, so a seed is an int64 tensor holding a
value in [0, 2^32).  Every sum and product is masked back to 32 bits, and
right shifts of non-negative int64 values are logical, as the uint32
originals are (an int32 `>> 5` would be arithmetic and wrong).
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def tea_init(val0, val1, backoff: int = 16) -> torch.Tensor:
    """16-round TEA hash of two uint32 values -> int64 seed in [0, 2^32).

    Matches initRand (BDPTUtils.hlsli:91-103)."""
    v0 = torch.as_tensor(val0, dtype=torch.int64) & _MASK
    v1 = torch.as_tensor(val1, dtype=torch.int64) & _MASK
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s0 = torch.zeros_like(v0)
    for _ in range(backoff):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & _MASK)
                    ^ ((v1 + s0) & _MASK)
                    ^ (((v1 >> 5) + 0xC8013EA4) & _MASK))) & _MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & _MASK)
                    ^ ((v0 + s0) & _MASK)
                    ^ (((v0 >> 5) + 0x7E95761E) & _MASK))) & _MASK
    return v0


def pixel_seeds(width: int, height: int, frame, backoff: int = 16,
                row0: int = 0, sub_height: int | None = None,
                device=None) -> torch.Tensor:
    """Seed grid [H, W]: initRand(x + y*W, frameCount, 16)
    (BDPTMain.rt.hlsl:73); rows [row0, row0 + sub_height) of the full
    image with global pixel ids.  `frame` is an int or an int64 scalar
    tensor on `device` (a CUDA graph's input, `pipeline/graphs.py`): the
    same seeds."""
    sub_h = height if sub_height is None else sub_height
    xs = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    ys = torch.arange(sub_h, dtype=torch.int64, device=device)[:, None] + row0
    lin = (ys * width + xs) & _MASK
    if isinstance(frame, torch.Tensor):
        return tea_init(lin, (frame & _MASK).expand_as(lin), backoff)
    return tea_init(lin, torch.full_like(lin, int(frame) & _MASK), backoff)


def next_rand(seed: torch.Tensor):
    """LCG step (BDPTUtils.hlsli:106-110): s = 1664525*s + 1013904223,
    value = (s & 0xFFFFFF) / 0x1000000.  Returns (seed, float32 in [0,1))."""
    seed = (seed * 1664525 + 1013904223) & _MASK
    u = (seed & 0x00FFFFFF).to(torch.float32) * (1.0 / 0x01000000)
    return seed, u


def next_rand2(seed: torch.Tensor):
    seed, u0 = next_rand(seed)
    seed, u1 = next_rand(seed)
    return seed, u0, u1
