"""Per-pass wall timing and the frame's spans: the analogue of Falcor's
hierarchical Profiler + GpuTimer (Utils/Profiler.h:40-120) and
RenderingPipeline's per-pass ProfilerEvent wrapping / extractProfilingData
scraping (RenderingPipeline.cpp:666-682, 846-883).

Port of `fyp_bidirectionalpathtracer_tpu/utils/profiler.py`, grown into the
port's one span system.  `span(name)` marks a stretch of host code in any
layer, with no tracer passed down the calls; `Profiler.event(name, sync)`
is a span that can also wait for the device.  Spans nest; a span's path is
the names of the spans open around it, outermost first
(`frame/megakernel/splat/read_live`).  A span does one or both of:

- while `torch.profiler` records, it opens a `record_function` range named
  by its path, so the spans sit on the profiler's clock beside the device
  operations they launch;
- while a `Profiler` is active (inside one of its enabled events, or in
  `with prof:`), it adds its host-clock time (`time.perf_counter`) to that
  Profiler's event of its path: the total, the self time (the total less
  the time of the child spans) and the count, in memory.

With neither, `span` returns a shared do-nothing context: no
`record_function` call, no allocation, no clock read.

While a CUDA graph capture (`pipeline/graphs.py`) runs `splitting`, the
span of a stage that it makes a graph of its own is the capture's split
instead, and a replay opens the span around the stage's graph.

An enabled Profiler's events, with `wait=True` (the default), wait for the
device work of their outputs (`_force`) before their end time, so that
work is attributed to the pass (attribution only: the waits serialise
what overlaps in a real frame).  A `span` never waits, and with
`wait=False` neither do the events.  Each event also keeps an exponential
moving average like Falcor's smoothed GUI times.  Enable or disable at run
time (the reference toggles with the P key).  The tracer's state is the
module's: spans are opened and closed on one thread.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

_active = None   # the Profiler that spans report to, while one is active
_path = []       # the names of the open spans, outermost first
_split = None    # a CUDA graph capture's splitter, while one captures
_stages = ()     # the span names it splits at
_OFF = nullcontext()


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


def span(name: str):
    """A context that marks a stretch of host code as the span `name`
    under the spans open around it (see the module doc)."""
    if _split is not None and name in _stages:
        return _split(name)
    if _active is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, _active, None, False)


def recording() -> bool:
    """Whether a span would record: a Profiler active or torch.profiler on."""
    return _active is not None or _autograd_profiler._is_profiler_enabled


@contextmanager
def splitting(split, stages):
    """While open, `span(name)` of a name in `stages` returns `split(name)`:
    a CUDA graph capture's context that ends the graph under way where it
    opens and where it closes."""
    global _split, _stages
    outer = _split, _stages
    _split, _stages = split, tuple(stages)
    try:
        yield
    finally:
        _split, _stages = outer


class _OffEvent:
    """A disabled event with no tracer on: yields a shared holder, which it
    empties on exit so that it keeps no tensor alive."""

    holder = [None]

    def __enter__(self):
        return self.holder

    def __exit__(self, *exc):
        self.holder[0] = None
        return False


_OFF_EVENT = _OffEvent()


class _Span:
    __slots__ = ("name", "prof", "holder", "wait", "outer", "range", "inner", "t0")

    def __init__(self, name: str, prof, holder, wait: bool):
        self.name, self.prof, self.holder, self.wait = name, prof, holder, wait

    def __enter__(self):
        global _active
        self.outer, _active = _active, self.prof
        _path.append(self.name)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function("/".join(_path))
            self.range.__enter__()
        self.inner = 0.0
        if self.prof is not None:
            self.prof._open.append(self)
        self.t0 = time.perf_counter()
        return self.holder

    def __exit__(self, *exc):
        global _active
        prof = self.prof
        try:
            if self.wait and self.holder[0] is not None:
                _force(self.holder[0])
            if prof is not None:
                dt = time.perf_counter() - self.t0
                key = "/".join(_path)
                ev = prof.events.get(key)
                if ev is None:
                    ev = prof.events[key] = _Event(depth=len(_path) - 1)
                ev.record(dt, dt - self.inner)
                if len(prof._open) > 1:
                    prof._open[-2].inner += dt
        finally:  # a failed wait still closes the span
            if prof is not None:
                prof._open.pop()
            _path.pop()
            _active = self.outer
            if self.range is not None:
                self.range.__exit__(None, None, None)
        return False


@dataclass
class _Event:
    total: float = 0.0
    self_total: float = 0.0
    count: int = 0
    ema: float = 0.0
    depth: int = 0

    def record(self, dt: float, self_dt: float):
        self.total += dt
        self.self_total += self_dt
        self.count += 1
        self.ema = dt if self.count == 1 else 0.9 * self.ema + 0.1 * dt


@dataclass
class Profiler:
    enabled: bool = True
    wait: bool = True
    events: dict = field(default_factory=dict)
    _open: list = field(default_factory=list)
    _outer: list = field(default_factory=list)

    def event(self, name: str, sync=None):
        """A span that, enabled, makes this Profiler the active one while it
        is open and, with `wait`, waits for `sync` (optional tensor or nest)
        before the end timestamp so its device work is attributed to the
        scope.  Yields a one-element list: scopes whose sync value is only
        known inside the block set `holder[0] = out` before exiting."""
        if self.enabled:
            return _Span(name, self, [sync], self.wait)
        if _active is None and not _autograd_profiler._is_profiler_enabled:
            return _OFF_EVENT
        return _Span(name, _active, [sync], False)

    def __enter__(self):
        """Make this Profiler, if enabled, the active one until the block
        ends: every span inside reports to it."""
        global _active
        self._outer.append(_active)
        if self.enabled:
            _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = self._outer.pop()
        return False

    def report(self) -> str:
        """Formatted per-event table (extractProfilingData analogue)."""
        lines = ["event                              avg_ms    ema_ms   count"]
        for key, ev in sorted(self.events.items()):
            name = "  " * ev.depth + key.split("/")[-1]
            avg = ev.total / max(ev.count, 1) * 1e3
            lines.append(f"{name:<32} {avg:>8.2f} {ev.ema * 1e3:>8.2f} {ev.count:>6}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        """By path: the mean total and self milliseconds an occurrence, and
        the count."""
        return {
            k: {"avg_ms": v.total / max(v.count, 1) * 1e3,
                "self_ms": v.self_total / max(v.count, 1) * 1e3, "count": v.count}
            for k, v in self.events.items()
        }
