"""The port's own spans and host-read counter, read in a stretch of frames
after a `--trace 1` run's check.

The metrics `host_ms.<layer>`, `sync_ms`, `host_reads_per_frame`,
`host_ms.bmfr` and `device_ms.bmfr` read what the port's tracer
(`utils/profiler`: `span`, `Profiler`) and its counter
(`cuda.READS["host_reads"]`) record.  The first of their readers to run
calls `of(ctx)`, which renders the cell again, from the run's seed
(`ctx.seed`, else its command line's `--seed`, else 0, which it logs) on
the run's device (`ctx.dev`, else the card unless the run's device trace
is empty), and keeps the results on the run's context for the others:

- `TRACE_SECONDS` of frames as the mix sends them (`run.FrameLoop`) with a
  `Profiler(enabled=True, wait=False)` active and no `torch.profiler`
  running: each span's host-clock milliseconds by path, with no device
  wait, and the host reads the frames made;
- where BMFR runs, `TRACE_SECONDS` more under `torch.profiler` recording the
  host and the device: each device operation's time is charged to the spans
  open around the host operator that launched it (the operator's `kernels`
  and its `cpu_parent` chain), which gives each span's device time with no
  wait.

A program without the tracer (no `span` in `utils/profiler`, no
`cuda.READS`) gives `None`: no stretch runs and every reader returns
nothing.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from dataclasses import dataclass

TRACE_SECONDS = 2.0


@dataclass
class Stretch:
    frames: int              # frames of the span stretch
    events: dict             # path -> Profiler.as_dict() entry
    host_reads: int          # cuda.READS["host_reads"] over the span stretch
    device_frames: int = 0   # frames of the device-traced stretch (0: none)
    device_us: dict = None   # span path -> device microseconds there

    def host_ms(self, last=None, prefix=None, path=None):
        """Host ms a frame of the spans whose path is `path`, or whose last
        name is `last` or starts with `prefix`; None where none ran."""
        total, seen = 0.0, False
        for key, ev in self.events.items():
            name = key.split("/")[-1]
            if (key == path or name == last
                    or (prefix is not None and name.startswith(prefix))):
                total += ev["avg_ms"] * ev["count"]
                seen = seen or ev["count"] > 0
        return total / self.frames if seen and self.frames else None

    def device_ms(self, path: str):
        """Device ms a frame of the operations launched inside `path`."""
        if not self.device_frames or not self.device_us or path not in self.device_us:
            return None
        return self.device_us[path] / 1e3 / self.device_frames


def of(ctx):
    """The run's Stretch (measured once, kept on `ctx`), or None."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = measure(ctx)
    return ctx.program_spans


def span_device_us(events) -> dict:
    """Device microseconds by span path: each host operator's device
    operations (`kernels`), charged to every span open around it, found
    through its `cpu_parent` chain.  A span is a `record_function` range
    (`is_user_annotation`; where the profiler lacks the flag, a name with no
    `::` that is no CUDA runtime call) other than the benchmark's own
    `portbench.` ranges; a range's own `kernels` are its copy on the
    device's timeline, no operation.  The port's kernels, launched through
    ctypes, have no operator and count for no span."""
    by_path = defaultdict(float)
    for e in events:
        kernels = getattr(e, "kernels", None)
        if not kernels or _is_range(e):
            continue
        us = sum(k.duration for k in kernels)
        parent = e.cpu_parent
        while parent is not None:
            if _is_range(parent) and not parent.name.startswith("portbench."):
                by_path[parent.name] += us
            parent = parent.cpu_parent
    return dict(by_path)


def _is_range(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag)
    return "::" not in e.name and not e.name.startswith("cuda")


def _run_seed(ctx):
    """The run's seed: `ctx.seed` where the run keeps it there, else its
    command line's `--seed`, else None."""
    seed = getattr(ctx, "seed", None)
    if seed is None:
        ap = argparse.ArgumentParser(add_help=False)
        ap.add_argument("--seed", type=int, default=None)
        seed = ap.parse_known_args(sys.argv[1:])[0].seed
    return seed


def _run_device(torch, ctx) -> str:
    """The run's device: `ctx.dev` where the run keeps it there, else the
    card where there is one, unless the run's device-traced stretch found no
    device operation (a run on the CPU)."""
    dev = getattr(ctx, "dev", None)
    if dev is not None:
        return str(dev)
    if not torch.cuda.is_available():
        return "cpu"
    if getattr(ctx, "traced_frames", 0) and not getattr(ctx, "device", None):
        return "cpu"
    return "cuda"


def measure(ctx, seconds: float = TRACE_SECONDS, device=None):
    import torch

    from fyp_bidirectionalpathtracer_tpu_torch import cuda
    from fyp_bidirectionalpathtracer_tpu_torch.utils import profiler

    if not hasattr(profiler, "span") or not hasattr(cuda, "READS"):
        return None
    import run
    import scenes
    from traffic import Plan

    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.utils import config as port_config

    dev = torch.device(device or _run_device(torch, ctx))
    seed = _run_seed(ctx)
    if seed is None:
        seed = 0
        run._log("span stretch: the run's seed is on neither its context nor its command "
                 "line; the stretch renders seed 0's views")
    run._log(f"span stretch: seed {seed} on {dev}")
    cfg, mix, w, h = ctx.config, ctx.traffic, ctx.width, ctx.height
    plan = Plan(cfg, mix, seed)
    baked = Scene.from_built(scenes.port_scene(scenes.load_arrays(cfg)),
                             aspect=w / h).bake(device=dev)
    renderer = Renderer(baked, run.render_config(port_config, cfg, mix, w, h))
    renderer.state.frame_index = plan.first_index
    loop = run.FrameLoop(torch, renderer, plan, mix, dev)
    for _ in range(int(mix["warmup_frames"])):
        loop.frame()
    loop.sync()

    prof = profiler.Profiler(enabled=True, wait=False)
    cuda.reset_launch_counts()
    with prof:
        frames, _ = loop.window(seconds)
    stretch = Stretch(frames=frames, events=prof.as_dict(),
                      host_reads=cuda.READS["host_reads"])
    if loop.bmfr:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=activities) as traced:
            stretch.device_frames, _ = loop.window(seconds)
        stretch.device_us = span_device_us(traced.events())
    return stretch
