"""The readers of the port's own spans and counter, on synthetic contexts,
the device-time attribution on synthetic profiler events, and one short
stretch of the port on the CPU."""
from types import SimpleNamespace

import pytest

import programspans
import run
import scenes
from fyp_bidirectionalpathtracer_tpu_torch.utils import profiler
from programspans import Stretch
from traffic import load_traffic

EVENTS = {
    "camera": {"avg_ms": 0.2, "self_ms": 0.2, "count": 20},
    "frame": {"avg_ms": 3.0, "self_ms": 0.1, "count": 10},
    "frame/megakernel": {"avg_ms": 2.0, "self_ms": 0.3, "count": 10},
    "frame/megakernel/frame_args": {"avg_ms": 0.25, "self_ms": 0.25, "count": 10},
    "frame/megakernel/k1": {"avg_ms": 0.05, "self_ms": 0.05, "count": 10},
    "frame/megakernel/splat": {"avg_ms": 1.4, "self_ms": 0.5, "count": 10},
    "frame/megakernel/splat/read_live": {"avg_ms": 0.9, "self_ms": 0.9, "count": 10},
    "frame/bmfr": {"avg_ms": 12.0, "self_ms": 0.5, "count": 10},
    "display": {"avg_ms": 0.1, "self_ms": 0.1, "count": 10},
}


def _ctx(**kw):
    stretch = Stretch(frames=10, events=EVENTS, host_reads=10, device_frames=8,
                      device_us={"frame/bmfr": 8 * 6500.0, "frame": 8 * 7000.0}, **kw)
    return SimpleNamespace(program_spans=stretch)


@pytest.mark.parametrize("name, want", [
    ("host_ms.camera", 0.4), ("host_ms.frame_args", 0.25), ("host_ms.splat", 1.4),
    ("sync_ms", 0.9), ("host_reads_per_frame", 1.0), ("host_ms.bmfr", 12.0),
    ("device_ms.bmfr", 6.5)])
def test_the_readers(name, want):
    assert run.reader(name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["host_ms.camera", "host_ms.frame_args", "host_ms.splat",
                                  "sync_ms", "host_reads_per_frame", "host_ms.bmfr",
                                  "device_ms.bmfr"])
def test_a_program_without_the_tracer_reads_nothing(name, monkeypatch):
    """The parent's program: no `span`, no stretch, every reader None."""
    monkeypatch.delattr(profiler, "span")
    ctx = SimpleNamespace(config=None, traffic=None, width=8, height=8)
    assert run.reader(name)(ctx) is None
    assert ctx.program_spans is None


def test_spans_that_did_not_run_read_nothing():
    ctx = SimpleNamespace(program_spans=Stretch(frames=10, events={}, host_reads=0))
    for name in ("host_ms.camera", "host_ms.frame_args", "host_ms.splat", "sync_ms",
                 "host_ms.bmfr", "device_ms.bmfr"):
        assert run.reader(name)(ctx) is None
    assert run.reader("host_reads_per_frame")(ctx) == 0.0


def _event(name, parent=None, kernels=(), annotation=None):
    e = SimpleNamespace(name=name, cpu_parent=parent,
                        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])
    if annotation is not None:
        e.is_user_annotation = annotation
    return e


@pytest.mark.parametrize("flagged", [True, False])
def test_device_time_goes_to_every_span_around_its_launch(flagged):
    """An operator's kernels count for each span open around it; a range's
    own device copy and the benchmark's `portbench.` ranges count for
    nothing."""
    def ev(name, parent=None, kernels=(), span=False):
        return _event(name, parent, kernels, annotation=span if flagged else None)

    window = ev("portbench.window", span=True)
    frame = ev("frame", window, [("frame", 900.0)], span=True)
    bmfr = ev("frame/bmfr", frame, [("frame/bmfr", 500.0)], span=True)
    reg = ev("frame/bmfr/regression", bmfr, span=True)
    mul = ev("aten::mul", reg, [("elementwise_kernel", 30.0)])
    to = ev("aten::to", bmfr)
    copy = ev("aten::copy_", to, [("Memcpy HtoD", 2.0), ("copy_kernel", 3.0)])
    k1 = ev("aten::empty", frame, [("frame_kernel", 600.0)])
    launch = ev("cudaLaunchKernel", mul)
    got = programspans.span_device_us([window, frame, bmfr, reg, mul, to, copy, k1, launch])
    assert got == {"frame": 635.0, "frame/bmfr": 35.0, "frame/bmfr/regression": 30.0}


def test_a_short_stretch_of_the_port_on_the_cpu():
    """The stretch itself, at 24x14 on the CPU: every span of the frame
    read, no host read (CPU tensors), BMFR's device time absent (no
    device)."""
    cfg = scenes.load_config("cornell")
    ctx = SimpleNamespace(config=cfg, traffic=load_traffic("interactive"), width=24, height=14)
    stretch = programspans.measure(ctx, seconds=0.3, device="cpu")
    assert stretch.frames > 0 and stretch.host_reads == 0
    assert {"camera", "display", "frame", "frame/megakernel/frame_args",
            "frame/bmfr", "frame/bmfr/regression"} <= set(stretch.events)
    assert stretch.host_ms(last="camera") > 0.0 and stretch.device_ms("frame/bmfr") is None
    assert profiler._active is None and profiler._path == []


def test_the_stretch_takes_the_runs_seed_and_device(monkeypatch):
    """The run's own seed and device, from its context where it keeps them
    there, else from its command line and its device trace."""
    import torch

    ctx = SimpleNamespace(seed=12345678901, dev="cpu")
    assert programspans._run_seed(ctx) == 12345678901
    assert programspans._run_device(torch, ctx) == "cpu"
    monkeypatch.setattr(programspans.sys, "argv", ["run.py", "--workload", "w", "--seed", "7"])
    assert programspans._run_seed(SimpleNamespace()) == 7
    monkeypatch.setattr(programspans.sys, "argv", ["calibrate.py"])
    assert programspans._run_seed(SimpleNamespace()) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert programspans._run_device(torch, SimpleNamespace(traced_frames=5, device=[])) == "cpu"
    on_card = SimpleNamespace(traced_frames=5, device=[("k", 0.0, 1.0)])
    assert programspans._run_device(torch, on_card) == "cuda"

