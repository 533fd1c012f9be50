"""The benchmark of the PyTorch and CUDA port, `fyp_bidirectionalpathtracer_tpu_torch`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with a CUDA card.  A cell of
`BENCHMARK.json` names a configuration (`configs/<name>.json`: its scene
inline as `quads`, or as `geometry` from a builder, `geometry/<name>.py`)
and a traffic mix (`traffic/<name>.json`); the harness finds each of
them, and every metric's reader (`metrics/<name>.py`), by name.

A run: the port's scene built from the configuration's arrays and baked on the card
(`Scene.from_built(...).bake`), a `Renderer` at the configuration's size,
depth and accumulation cap, its first frame index from the seed, a few
warm-up frames of the mix's own poses (set-up ends at the first timed
frame), then `--seconds` of frames as the mix sends them: still views of
100 frames enqueued back to back, or a walk of a pose a frame with BMFR on,
each frame tone-mapped by `Renderer.display` and at most two frames in
flight.  One sync ends the window.  Then, with the port's state freed, the
sampled frames are rendered again by the plain reference and compared
(`check.py`).  `--trace 1` adds, after the same window, a stretch under `torch.profiler`
recording the device alone (the idle share, the device operations, the
rooflines), a stretch recording the host too (to name the idle gaps by
the host call under way) and, where BMFR runs, a stretch of
`Renderer.render_frame_profiled`, and prints the per-layer metrics.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `check`: each compared number beside its limit); the
same numbers end standard error.  No card, fewer cards than the cell asks
for, a checkout without the port, or JAX loaded by the time the window
closes: no result and a non-zero exit.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)
# caches of anything that compiles, at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "portbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "portbench",
                                                           "torch_extensions"))
os.environ["USE_FLAX"] = "0"

PORT = "fyp_bidirectionalpathtracer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "fyp_bidirectionalpathtracer_tpu")
TRACE_SECONDS = 2.0      # each profiled stretch of a --trace 1 run
PROFILED_FRAMES = 8      # the stretch of render_frame_profiled
TOP = 10


class BenchError(RuntimeError):
    """A run that can print no result."""


def load_manifest() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json beside {HERE}")
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"BENCHMARK.json has no workload {name!r}")


def metrics_of(manifest: dict, kind: str, cell: str) -> list[dict]:
    """The cell's metrics of `kind` ('end_to_end' or 'per_layer')."""
    return [m for m in manifest[kind] if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def render_config(c, cfg: dict, mix: dict, width: int, height: int):
    """The configuration and mix as the port's RenderConfig (`c` is its
    `utils/config`)."""
    return c.RenderConfig(
        width=width, height=height, bdpt=c.BDPTConfig(max_depth=cfg["max_depth"]),
        accumulate=c.AccumulateConfig(max_accum_count=cfg["max_accum_count"]),
        bmfr=c.BMFRConfig(**mix["bmfr"]) if mix["bmfr"] else c.BMFRConfig())


class Sampler:
    """A reservoir of `k` snapshots drawn from the seed among the
    candidate frames the window offers."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self.rng = random.Random(seed * 7919 + 17)

    def offer(self, make):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = make()


class FrameLoop:
    """Frames of a plan through a Renderer, as the mix sends them."""

    def __init__(self, torch, renderer, plan, mix, device):
        from check import Snapshot

        self.snapshot = Snapshot
        self.torch, self.r, self.plan, self.mix = torch, renderer, plan, mix
        self.cuda = device.type == "cuda"
        self.in_flight = int(mix["frames_in_flight"]) if self.cuda else 0
        self.bmfr = bool(mix["bmfr"])
        self.next = 0
        self.host_s, self.starts, self.events = [], [], []

    def _span(self, name):
        return self.torch.profiler.record_function("portbench." + name)

    def frame(self, sampler=None, prof=None):
        torch, r, i = self.torch, self.r, self.next
        if self.in_flight and len(self.events) >= self.in_flight:
            with self._span("wait"):
                self.events[-self.in_flight].synchronize()
        t0 = time.perf_counter()
        if self.plan.moves(i):
            with self._span("set_camera_pose"):
                r.set_camera_pose(*self.plan.pose(i))
        before = r.state.bmfr
        t1 = time.perf_counter()
        with self._span("render_frame"):
            r.render_frame(prof)
        self.host_s.append(time.perf_counter() - t1)
        after = r.state.bmfr
        if self.mix["display"]:
            with self._span("display"):
                r.display()
        if self.in_flight:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)
        self.starts.append(t0)
        if sampler is not None and self._candidate(i):
            ch = r.channels
            sampler.offer(lambda: self.snapshot(
                run_frame=i, view_start=self.plan.view_start(i), accumulated=ch["Accumulated"],
                output=ch["PipelineOutput"] if self.bmfr else None,
                bmfr_before=before if self.bmfr else None,
                bmfr_after=after if self.bmfr else None))
        self.next += 1

    def _candidate(self, i: int) -> bool:
        if self.plan.mode == "views":
            return i - self.plan.view_start(i) == self.mix["check_view_frame"]
        return True

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def window(self, seconds: float, sampler=None):
        """Frames for `seconds`, then one sync: (frames, wall seconds)."""
        self.host_s, self.starts, self.events = [], [], []
        self.sync()
        anchor, t_anchor = None, None
        if self.in_flight:
            anchor = self.torch.cuda.Event(enable_timing=True)
            t_anchor = time.perf_counter()
            anchor.record()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.frame(sampler)
            n += 1
        self.sync()
        wall = time.perf_counter() - t0
        if self.in_flight:
            self.latencies = [t_anchor + anchor.elapsed_time(e) / 1e3 - s
                              for e, s in zip(self.events, self.starts)]
        else:
            self.latencies = []
        return n, wall


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        size: tuple[int, int] | None = None, t_start: float | None = None,
        manifest: dict | None = None, control: bool = False) -> tuple[dict, dict]:
    """One run of a cell: (result line, check report).  `size` (width,
    height) and `device` other than the card serve the tests only;
    `control` (`calibrate.py`) also reads the control's numbers on the same
    sampled frames, into the report's `control` entry."""
    import torch

    import check
    import devtrace
    import scenes
    from traffic import Plan, load_traffic

    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.utils import config as port_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = T_START if t_start is None else t_start
    manifest = load_manifest() if manifest is None else manifest
    cell = find_cell(manifest, workload)
    cfg = scenes.load_config(cell["config"])
    mix = load_traffic(cell["traffic"])
    limits = check.load_limits(workload)
    width, height = size or (cfg["width"], cfg["height"])
    dev = torch.device(device)
    plan = Plan(cfg, mix, seed)
    arrays = scenes.load_arrays(cfg)

    # ---- set-up: bake on the card, warm up the mix's own frames
    baked = Scene.from_built(scenes.port_scene(arrays), aspect=width / height).bake(device=dev)
    n_tris, n_lights = baked.n_tris, int(baked.light_rows.shape[0])
    renderer = Renderer(baked, render_config(port_config, cfg, mix, width, height))
    renderer.state.frame_index = plan.first_index
    loop = FrameLoop(torch, renderer, plan, mix, dev)
    sampler = Sampler(int(mix.get("check_views", mix.get("check_frames", 1))), seed)
    first = []
    for k in range(int(mix["warmup_frames"])):
        loop.frame()
        if k == 0 and loop.bmfr:  # BMFR's start: the first frame, fresh history
            ch = renderer.channels
            first.append(check.Snapshot(run_frame=0, view_start=0,
                                        accumulated=ch["Accumulated"],
                                        output=ch["PipelineOutput"], bmfr_before=None,
                                        bmfr_after=renderer.state.bmfr))
    loop.sync()
    setup_s = time.time() - t_start

    # ---- the window
    _log(f"set-up {setup_s:.3f} s ({n_tris} triangles, first frame index {plan.first_index})")
    host0 = _host_reading()
    frames, wall = loop.window(seconds, sampler)
    _log(f"window {wall:.3f} s, {frames} frames; host {_host_note(host0, _host_reading())}")
    host_frame_s = list(loop.host_s)
    latencies = list(loop.latencies)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    ctx = SimpleNamespace(
        config=cfg, traffic=mix, width=width, height=height, depth=cfg["max_depth"],
        n_tris=n_tris, n_lights=n_lights, setup_s=setup_s, frames=frames, wall_s=wall,
        latencies_s=latencies, host_frame_s=host_frame_s, device=[], host=[],
        window=(0.0, 0.0), traced_frames=0, pass_ms={})
    result_device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        from torch.profiler import ProfilerActivity

        cuda = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
        # the device alone: the idle share, the device operations, the rooflines
        ctx.device, _, ctx.window, ctx.traced_frames = _traced(torch, loop, cuda, seconds)
        # the host too, which slows it: only to name the idle gaps
        named_device, named_host, named_window, _ = _traced(
            torch, loop, [ProfilerActivity.CPU] + cuda[:1] * (dev.type == "cuda"), seconds)
        if loop.bmfr:
            from fyp_bidirectionalpathtracer_tpu_torch.utils.profiler import Profiler

            passes = Profiler(enabled=True)
            for _ in range(PROFILED_FRAMES):
                loop.frame(prof=passes)
            loop.sync()
            ctx.pass_ms = passes.as_dict()
        w0, w1 = ctx.window
        busy = devtrace.busy_us([(max(s, w0), min(e, w1)) for _, s, e in ctx.device
                                 if e > w0 and s < w1])
        result_device["busy_s"] = busy / 1e6
        result_device["window_s"] = (w1 - w0) / 1e6
        breakdown = {
            "device_ops": [[n, s] for n, s in devtrace.top_ops(ctx.device, ctx.window)[:TOP]],
            "idle_gaps": [[n, s] for n, s in devtrace.name_gaps(
                devtrace.idle_gaps(named_device, named_window), named_host)[:TOP]]}
        del named_device, named_host

    # ---- free the port, then the reference's check
    snapshots = first + sampler.kept
    del renderer, baked, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rcfg = dict(cfg, width=width, height=height)
    t_check = time.perf_counter()
    numbers, per_frame = check.compare(snapshots, rcfg, plan, arrays, dev)
    _log(f"check: {len(snapshots)} sampled frames, frames {[s.run_frame for s in snapshots]}, "
         f"{time.perf_counter() - t_check:.1f} s")
    correct, report = check.judge(numbers, limits)
    failed = sum(1 for found in per_frame if not check.judge(found, limits)[0])
    if control:
        report = dict(report, control=check.compare(snapshots, rcfg, plan, arrays, dev,
                                                    control=True)[0])

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(manifest, kind, workload):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": frames, "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = report
    return result, report


def _traced(torch, loop, activities, seconds):
    """A stretch of frames under torch.profiler, which starts and ends with a
    sync: (device ops, host events, the window in the trace's microseconds,
    frames).  Without host events the window runs from the first device
    operation to the last: the host's first enqueue, some microseconds of
    the 2 s, is left out."""
    import devtrace
    from torch.profiler import profile

    loop.sync()
    with profile(activities=activities) as prof:
        with torch.profiler.record_function("portbench.window"):
            traced, _ = loop.window(min(TRACE_SECONDS, seconds))
    t_read = time.perf_counter()
    device, host = devtrace.collect(prof)
    _log(f"trace of {[str(a).split('.')[-1] for a in activities]}: {traced} frames, "
         f"{len(device)} device and {len(host)} host events read in "
         f"{time.perf_counter() - t_read:.1f} s")
    spans = [h for h in host if h[0] == "portbench.window"]
    if spans:
        window = (spans[0][1], spans[0][2])
    elif device:  # the device alone: from its first operation to its last
        window = (device[0][1], max(e for _, _, e in device))
    else:
        window = (0.0, 0.0)
    return device, host, window, traced


def _host_reading():
    """What the host gave this process: CPU seconds, involuntary context
    switches, and the machine's steal and total jiffies (/proc/stat)."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    steal = total = 0
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
        steal, total = (cpu[7] if len(cpu) > 7 else 0), sum(cpu)
    except OSError:
        pass
    return time.process_time(), use.ru_nivcsw, steal, total, time.perf_counter()


def _host_note(a, b) -> str:
    """The window's host conditions, for reading a run's spread."""
    wall = max(b[4] - a[4], 1e-9)
    jiffies = max(b[3] - a[3], 1)
    try:
        load = open("/proc/loadavg").read().split()[0]
    except OSError:
        load = "?"
    return (f"cpu {(b[0] - a[0]) / wall:.3f} of the wall, {b[1] - a[1]} involuntary switches, "
            f"steal {100.0 * (b[2] - a[2]) / jiffies:.2f}%, load {load}")


def _log(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list[str]:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        manifest = load_manifest()
        cell = find_cell(manifest, args.workload)
        import torch

        torch.set_num_threads(1)  # one process, one host thread: steadier host times

        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise BenchError(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                             f"this machine has {torch.cuda.device_count()}")
        if importlib.util.find_spec(PORT) is None:
            raise BenchError(f"no {PORT} package beside {HERE}: run from a checkout of the repo")
        result, report = run(args.workload, args.seed, args.seconds, bool(args.trace),
                             manifest=manifest)
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = loaded_forbidden()
    if found:
        print(f"portbench: JAX modules loaded in the benchmark's process: {found}",
              file=sys.stderr)
        return 3
    smi = _nvidia_smi()
    if smi:
        result["device"]["nvidia_smi"] = smi
        result["check"] = result.pop("check")
    for name, entry in report.items():
        print(f"check {name}: {entry['value']} limit {entry['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
