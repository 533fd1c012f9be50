"""Per-pass wall timing: the analogue of Falcor's hierarchical Profiler +
GpuTimer (Utils/Profiler.h:40-120) and RenderingPipeline's per-pass
ProfilerEvent wrapping / extractProfilingData scraping
(RenderingPipeline.cpp:666-682, 846-883).

Port of `fyp_bidirectionalpathtracer_tpu/utils/profiler.py`.  A scope
records the host's wall clock (`time.perf_counter`), not CUDA events: it
waits for the device work of its outputs (`_force`) before the end
timestamp, so that work is attributed to the scope.  Events nest; each
keeps an exponential moving average like Falcor's smoothed GUI times.
Enable or disable at run time (the reference toggles with the P key).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


def _tensors(tree):
    """The tensors of a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def _force(sync) -> None:
    """Block until the device work behind `sync` (a tensor or a nest of
    them) is done: `torch.cuda.synchronize` on each CUDA device it names.
    A CPU tensor is computed when its op returns: nothing to wait for."""
    devices = {t.device for t in _tensors(sync) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


@dataclass
class _Event:
    total: float = 0.0
    count: int = 0
    ema: float = 0.0
    depth: int = 0

    def record(self, dt: float):
        self.total += dt
        self.count += 1
        self.ema = dt if self.count == 1 else 0.9 * self.ema + 0.1 * dt


@dataclass
class Profiler:
    enabled: bool = True
    events: dict = field(default_factory=dict)
    _stack: list = field(default_factory=list)

    @contextmanager
    def event(self, name: str, sync=None):
        """Time a scope; `sync` (optional tensor or nest) is waited for
        before the end timestamp so its device work is attributed to the
        scope.  Yields a one-element list: scopes whose sync value is only
        known inside the block set `holder[0] = out` before exiting."""
        holder = [sync]
        if not self.enabled:
            yield holder
            return
        self._stack.append(name)
        key = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            if holder[0] is not None:
                _force(holder[0])
            dt = time.perf_counter() - t0
            ev = self.events.setdefault(key, _Event(depth=len(self._stack) - 1))
            ev.record(dt)
            self._stack.pop()

    def report(self) -> str:
        """Formatted per-event table (extractProfilingData analogue)."""
        lines = ["event                              avg_ms    ema_ms   count"]
        for key, ev in sorted(self.events.items()):
            name = "  " * ev.depth + key.split("/")[-1]
            avg = ev.total / max(ev.count, 1) * 1e3
            lines.append(f"{name:<32} {avg:>8.2f} {ev.ema * 1e3:>8.2f} {ev.count:>6}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            k: {"avg_ms": v.total / max(v.count, 1) * 1e3, "count": v.count}
            for k, v in self.events.items()
        }
