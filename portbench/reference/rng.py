"""The app's random numbers, a stream a pixel (BDPTUtils.hlsli:91-110).

A pixel's seed is a 16-round TEA hash of its linear index and the frame
count; each draw steps the Numerical Recipes LCG and takes its low 24 bits
as a float in [0, 1).  Held in int64 tensors masked to 32 bits, so the
integers are exact on every device.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def tea(v0: torch.Tensor, v1: torch.Tensor, rounds: int = 16) -> torch.Tensor:
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4)) & MASK)) & MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761E)) & MASK)) & MASK
    return v0


class Stream:
    """One LCG state a lane.  `draw` advances the lanes of `where` (all by
    default) and returns their floats; `peek` returns the next k floats
    without advancing, and `advance` commits k draws on a mask."""

    def __init__(self, seed: torch.Tensor, dtype=torch.float64):
        self.s = seed
        self.dtype = dtype

    @staticmethod
    def _step(s):
        return (s * 1664525 + 1013904223) & MASK

    def _float(self, s):
        return (s & 0xFFFFFF).to(self.dtype) / float(1 << 24)

    def draw(self, where: torch.Tensor | None = None) -> torch.Tensor:
        nxt = self._step(self.s)
        self.s = nxt if where is None else torch.where(where, nxt, self.s)
        return self._float(nxt)

    def peek(self, k: int) -> list[torch.Tensor]:
        out, s = [], self.s
        for _ in range(k):
            s = self._step(s)
            out.append(self._float(s))
        return out

    def advance(self, k: int, where: torch.Tensor) -> None:
        s = self.s
        for _ in range(k):
            s = self._step(s)
        self.s = torch.where(where, s, self.s)


def pixel_stream(width: int, height: int, frame_count: int, device,
                 dtype=torch.float64) -> Stream:
    lin = torch.arange(width * height, dtype=torch.int64, device=device)
    frame = torch.full_like(lin, frame_count & MASK)
    return Stream(tea(lin, frame), dtype)
