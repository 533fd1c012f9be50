"""The port's tracer (`utils/profiler`: `span`, `Profiler`) and its host-read
counter (`cuda.READS`), on the CPU, plus `cuda`-marked cases for the card.

Off (no Profiler active, no torch.profiler recording) a span is one shared
do-nothing context and a frame makes no `record_function` call; under
torch.profiler the spans are ranges named by their paths, nested as the
frame's layers; an active Profiler keeps each path's total and self time;
`wait=False` never waits for the device.  On the card:

    python -m pytest tests/test_torch_trace.py -q -m cuda --noconftest
"""
import contextlib
import itertools
import warnings
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.passes import bmfr
from fyp_bidirectionalpathtracer_tpu_torch.pipeline import frame_profile
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils import profiler
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, BMFRConfig, RenderConfig
from fyp_bidirectionalpathtracer_tpu_torch.utils.profiler import Profiler, span
from torch_threads import one_intra_op_thread  # noqa: F401

# every span a megakernel frame with BMFR makes, and the camera's and the
# display's outside it
FRAME_SPANS = {
    "frame", "frame/megakernel", "frame/megakernel/frame_args", "frame/megakernel/k1",
    "frame/megakernel/splat", "frame/megakernel/splat/read_live", "frame/accumulate",
    "frame/bmfr", "frame/bmfr/preprocess", "frame/bmfr/regression", "frame/bmfr/postprocess",
}
OUTER_SPANS = {"camera", "display"}


def _renderer(device="cpu", size=24, plain=True):
    """Cornell at `size`, the megakernel route with the packed splat (K2, the
    sort and K3, their plain versions on the CPU) and BMFR's three stages."""
    cfg = RenderConfig(width=size, height=size, bdpt=BDPTConfig(splat_mode="tiled_rgb8e"),
                       bmfr=BMFRConfig(enabled=True, regression=True, half_screen_debug=False))
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake(device=device)
    return Renderer(replace(baked, plain=plain), cfg)


def _frame(r, pose):
    r.set_camera_pose(*pose)
    out = r.render_frame()
    return out, r.display()


POSES = [((0.0, 0.5, -1.3), (0.0, 0.5, 0.0)), ((0.05, 0.5, -1.3), (0.0, 0.45, 0.0))]


def test_off_spans_are_one_shared_context():
    assert profiler._active is None and profiler._path == []
    assert span("a") is span("b") is profiler._OFF
    off = Profiler(enabled=False)
    assert off.event("a") is off.event("b", sync=torch.ones(1))
    with off.event("a") as h:
        h[0] = torch.ones(1)
    assert h[0] is None and off.events == {}  # the shared holder keeps nothing


def test_an_untraced_frame_makes_no_record_function_call(monkeypatch):
    """With no tracer and no profiler a frame calls no record_function;
    traced either way, it renders the same bits."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    r_off, r_prof, r_torch = _renderer(), _renderer(), _renderer()
    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        off = [_frame(r_off, p) for p in POSES]
    prof = Profiler(enabled=True, wait=False)
    with prof:
        on = [_frame(r_prof, p) for p in POSES]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        traced = [_frame(r_torch, p) for p in POSES]
    for a, b, c in zip(off, on, traced):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
            np.testing.assert_array_equal(x.numpy(), z.numpy())
    for key in r_off.channels:
        np.testing.assert_array_equal(r_off.channels[key].numpy(),
                                      r_prof.channels[key].numpy(), key)
    assert set(prof.events) == FRAME_SPANS | OUTER_SPANS
    assert prof.as_dict()["frame"]["count"] == len(POSES)
    assert profiler._active is None and profiler._path == []


def test_spans_are_torch_profiler_ranges_nested_as_the_frame():
    from torch.profiler import ProfilerActivity, profile

    r = _renderer()
    r.render_frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(r, POSES[0])
    ranges = {e.name: e for e in prof.events() if e.name in FRAME_SPANS | OUTER_SPANS}
    assert set(ranges) == FRAME_SPANS | OUTER_SPANS
    for path, e in ranges.items():
        parent = e.cpu_parent.name if e.cpu_parent is not None else None
        assert parent == ("/".join(path.split("/")[:-1]) or None), (path, parent)
    # the device read sits inside the splat, the splat inside K1's pass
    splat = ranges["frame/megakernel/splat"].time_range
    read = ranges["frame/megakernel/splat/read_live"].time_range
    assert splat.start <= read.start <= read.end <= splat.end


def test_self_time_is_the_total_less_the_children():
    clock = itertools.count()
    prof = Profiler(enabled=True, wait=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiler.time, "perf_counter", lambda: float(next(clock)))
        with prof:
            with span("frame"):        # enter at 0
                with span("a"):        # 1 .. 2
                    pass
                with span("b"):        # 3 .. 6
                    with span("c"):    # 4 .. 5
                        pass
            with span("frame"):        # 8 .. 9
                pass
    ev = prof.events
    assert (ev["frame"].total, ev["frame"].self_total, ev["frame"].count) == (8.0, 4.0, 2)
    assert (ev["frame/b"].total, ev["frame/b"].self_total) == (3.0, 2.0)
    assert (ev["frame/a"].self_total, ev["frame/b/c"].self_total) == (1.0, 1.0)
    d = prof.as_dict()
    assert d["frame"]["avg_ms"] == 4e3 and d["frame"]["self_ms"] == 2e3


def test_self_times_of_a_frame_sum_to_its_total():
    r = _renderer()
    prof = Profiler(enabled=True, wait=False)
    with prof:
        _frame(r, POSES[0])
    d = prof.as_dict()
    for key, ev in d.items():
        children = [k for k in d if k.rsplit("/", 1)[0] == key and k != key]
        want = ev["avg_ms"] * ev["count"] - sum(d[k]["avg_ms"] * d[k]["count"]
                                                for k in children)
        assert ev["self_ms"] * ev["count"] == pytest.approx(want, rel=1e-9, abs=1e-9), key
        assert ev["self_ms"] >= 0.0


def test_wait_false_never_waits(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("waited for the device")

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    r = _renderer()
    with monkeypatch.context() as mp:
        mp.setattr(profiler, "_force", refuse)
        r.render_frame_profiled(Profiler(enabled=True, wait=False))
        with Profiler(enabled=True, wait=False) as prof:
            _frame(r, POSES[1])
    assert "frame/bmfr" in prof.events
    # the default waits on each of its pass events, and on nothing else
    monkeypatch.setattr(profiler, "_force", lambda sync: calls.append(sync))
    waited = Profiler()
    r.render_frame_profiled(waited)
    assert len(calls) == 4  # frame, megakernel, accumulate, bmfr
    assert set(waited.events) == FRAME_SPANS | {"camera"}


def test_a_profiler_is_active_only_inside_its_scope():
    outer, inner = Profiler(wait=False), Profiler(wait=False)
    with outer:
        with span("x"):
            pass
        with pytest.raises(RuntimeError):
            with inner.event("y"):
                with span("z"):
                    raise RuntimeError("inside")
        with span("x"):
            pass
    assert profiler._active is None and profiler._path == []
    assert set(outer.events) == {"x"} and outer.events["x"].count == 2
    assert set(inner.events) == {"y", "y/z"}
    with span("x"):
        pass
    assert outer.events["x"].count == 2
    with Profiler(enabled=False):
        assert span("x") is profiler._OFF


def test_a_failed_wait_closes_its_span(monkeypatch):
    """A wait that raises (a device error surfacing at the sync) still
    closes the span: the spans after it nest and time as before."""
    from torch.profiler import ProfilerActivity, profile

    def fail(sync):
        raise RuntimeError("device error")

    monkeypatch.setattr(profiler, "_force", fail)
    prof = Profiler()  # wait=True: its events wait
    with profile(activities=[ProfilerActivity.CPU]) as traced:
        with prof:
            with span("frame"):
                with pytest.raises(RuntimeError, match="device error"):
                    with prof.event("pass", sync=torch.ones(1)):
                        pass
                with span("next"):
                    pass
    assert profiler._active is None and profiler._path == [] and prof._open == []
    assert set(prof.events) == {"frame", "frame/next"}
    assert prof.events["frame"].self_total == pytest.approx(
        prof.events["frame"].total - prof.events["frame/next"].total)
    ranges = {e.name: e for e in traced.events() if e.name in ("frame", "frame/pass", "frame/next")}
    assert set(ranges) == {"frame", "frame/pass", "frame/next"}
    assert ranges["frame/next"].cpu_parent.name == "frame"
    assert ranges["frame/pass"].time_range.end <= ranges["frame/next"].time_range.start


def test_host_reads_count_only_cuda_tensors():
    cuda.reset_launch_counts()
    assert cuda.read_host(torch.tensor(7)) == 7
    assert cuda.READS == {"host_reads": 0}
    cuda.READS["host_reads"] = 3
    cuda.reset_launch_counts()
    assert cuda.READS == {"host_reads": 0}


def test_stage_self_ms_are_the_spans_self_times():
    r = _renderer()
    r.render_frame()
    stages = frame_profile.stage_self_ms(r, 2)
    assert set(stages) == FRAME_SPANS | {"camera"}
    assert all(v >= 0.0 for v in stages.values())
    assert frame_profile.stage_self_ms(r, 0) == {}


def test_device_operations_leave_out_the_spans_ranges():
    """The device timeline's copies of the spans' ranges (user annotations)
    are no device operations: `profile_calls` counts and times the kernels,
    copies and memsets alone."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, device_type, annotation):
        return SimpleNamespace(name=name, device_type=device_type, is_user_annotation=annotation)

    kernel = ev("bdpt::frame_kernel", DeviceType.CUDA, False)
    copy = ev("Memcpy HtoD", DeviceType.CUDA, False)
    events = [ev("frame", DeviceType.CPU, True), ev("frame", DeviceType.CUDA, True),
              ev("frame/megakernel", DeviceType.CUDA, True), kernel,
              ev("aten::copy_", DeviceType.CPU, False), copy]
    assert frame_profile.device_operations(events) == [kernel, copy]


# ------------------------------------------------------- the wavefront route
# spans a wavefront frame makes on the BVH tier: the passes, the BDPT pass's
# two stages, each query (`trace`) and each incoherent batch's sort
WAVEFRONT_SPANS = {
    "frame", "frame/gbuffer", "frame/gbuffer/trace", "frame/bdpt", "frame/bdpt/subpaths",
    "frame/bdpt/subpaths/trace", "frame/bdpt/subpaths/trace/sort", "frame/bdpt/shadows",
    "frame/bdpt/shadows/trace", "frame/bdpt/shadows/trace/sort", "frame/accumulate",
    "frame/bmfr",
}
BVH_WRAPPERS = {"bvh_closest": "bvh_closest", "bvh_shaded_fm": "bvh_shaded",
                "bvh_occluded": "bvh_occluded"}


def _wavefront_renderer(width=16, height=12, device="cpu"):
    """Cornell with a 5,120-triangle icosphere: above the megakernel gate's
    2,048 triangles, so the frame takes the wavefront route and the BVH
    tier (the plain versions of its kernels on the CPU)."""
    from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import icosphere

    built = cornell_box()
    built.meshes.append(icosphere((0.5, 0.35, 0.45), 0.2, 0, subdivisions=4))
    cfg = RenderConfig(width=width, height=height)
    baked = Scene.from_built(built, aspect=width / height).bake(device=device)
    assert baked.n_tris > 2048
    return Renderer(baked, cfg)


def _spy_bvh_wrappers(monkeypatch, sizes):
    """Record each BVH wrapper's batch size by kernel, then call it."""
    from fyp_bidirectionalpathtracer_tpu_torch.accel import cluster

    for fn, kernel in BVH_WRAPPERS.items():
        def spy(*args, _orig=getattr(cluster, fn), _kernel=kernel, **kw):
            origin = kw["origin"] if "origin" in kw else args[
                4 if _kernel == "bvh_shaded" else 3]
            sizes[_kernel] += origin.numel() // 3
            return _orig(*args, **kw)
        monkeypatch.setattr(cluster, fn, spy)


@pytest.mark.parametrize("recorder", ["profiler", "torch.profiler"])
def test_a_wavefront_frame_records_its_spans(recorder):
    """The BDPT pass's `subpaths` and `shadows`, each query's `trace` and
    each incoherent batch's `sort`, as Profiler paths and as torch.profiler
    ranges nested as their paths."""
    r = _wavefront_renderer()
    r.render_frame()
    if recorder == "profiler":
        prof = Profiler(enabled=True, wait=False)
        with prof:
            r.render_frame()
        assert set(prof.events) == WAVEFRONT_SPANS | {"camera"}
        d = prof.as_dict()
        assert d["frame/bdpt/subpaths/trace"]["count"] == 6 - 1  # 2 camera + 3 light
        assert d["frame/bdpt/shadows/trace"]["count"] == 3       # est-1, est-3, est-2
        assert d["frame/gbuffer/trace"]["count"] == 1
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as traced:
            r.render_frame()
        ranges = {e.name: e for e in traced.events() if e.name in WAVEFRONT_SPANS}
        assert set(ranges) == WAVEFRONT_SPANS
        for path, e in ranges.items():
            parent = e.cpu_parent.name if e.cpu_parent is not None else None
            assert parent == ("/".join(path.split("/")[:-1]) or None), (path, parent)
    assert profiler._active is None and profiler._path == []


def test_rays_count_the_batches_handed_to_each_bvh_wrapper(monkeypatch):
    """`cuda.RAYS` adds each BVH wrapper's batch on the host: over a frame it
    equals the sizes the wrappers were handed, kernel by kernel, and the
    BDPT algorithm's count at depth 3 (the G-buffer, 2 camera and 3 light
    extensions, 3 + 4 + 3 shadow rays a pixel)."""
    r = _wavefront_renderer()
    sizes = dict.fromkeys(cuda.RAYS, 0)
    _spy_bvh_wrappers(monkeypatch, sizes)
    cuda.reset_launch_counts()
    r.render_frame()
    n = r.cfg.width * r.cfg.height
    assert cuda.RAYS == sizes
    assert cuda.RAYS == {"bvh_closest": 0, "bvh_shaded": 6 * n, "bvh_occluded": 10 * n}
    assert sum(cuda.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_rays_reset_with_the_launch_counts():
    cuda.RAYS["bvh_occluded"] = 5
    cuda.LAUNCHES["bvh_occluded"] = 2
    cuda.reset_launch_counts()
    assert set(cuda.RAYS.values()) == {0} and cuda.LAUNCHES["bvh_occluded"] == 0


def test_wavefront_spans_off_are_the_shared_context(monkeypatch):
    """With no tracer a wavefront frame opens no range and each span is the
    shared do-nothing context; traced, it renders the same bits and makes
    the same host reads."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    opened = []
    real_span = profiler.span

    def spy(name):
        ctx = real_span(name)
        opened.append(ctx)
        return ctx

    r_off, r_on = _wavefront_renderer(), _wavefront_renderer()
    from fyp_bidirectionalpathtracer_tpu_torch.accel import traverse
    from fyp_bidirectionalpathtracer_tpu_torch.ops import shading
    from fyp_bidirectionalpathtracer_tpu_torch.passes import bdpt

    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        for module in (bdpt, traverse, shading):
            mp.setattr(module, "span", spy)
        cuda.reset_launch_counts()
        off = r_off.render_frame()
        reads_off = cuda.READS["host_reads"]
    assert len(opened) >= 2 + 1 + 5 + 3  # the stages, then a span a query at least
    assert all(ctx is profiler._OFF for ctx in opened)
    cuda.reset_launch_counts()
    with Profiler(enabled=True, wait=False):
        on = r_on.render_frame()
    assert cuda.READS["host_reads"] == reads_off
    np.testing.assert_array_equal(off.numpy(), on.numpy())
    for key in r_off.channels:
        np.testing.assert_array_equal(r_off.channels[key].numpy(),
                                      r_on.channels[key].numpy(), key)


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_a_progressive_frame_reads_the_device_once():
    """One frame of the megakernel route on the card: one host read (the
    splat's live count), and one synchronizing call by torch's sync debug
    mode, inside the span `read_live`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _renderer("cuda", 128, plain=False)
    r.render_frame()
    r.set_camera_pose(*POSES[0])
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught, _sync_debug():
        warnings.simplefilter("always")
        with Profiler(enabled=True, wait=False) as prof:
            r.render_frame()
            r.display()
    torch.cuda.synchronize()
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert cuda.READS["host_reads"] == 1 == len(syncs), [str(w.message) for w in syncs]
    assert prof.events["frame/megakernel/splat/read_live"].count == 1
    assert cuda.LAUNCHES["frame"] == 1 and cuda.LAUNCHES["compact"] == 1


@pytest.mark.cuda
def test_an_interactive_frame_fits_bmfr_in_one_launch(monkeypatch):
    """The benchmark's interactive mix on the card (a pose a frame, BMFR's
    three stages on the full screen, `qr`, the f32 history, `display`):
    each frame launches the fit kernel once, never runs the plain fit, and
    reads the device once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = RenderConfig(width=256, height=144, bmfr=BMFRConfig(
        enabled=True, preprocess=True, regression=True, postprocess=True,
        half_screen_debug=False, regression_solver="qr", history_pack="f32"))
    r = Renderer(Scene.from_built(cornell_box(), aspect=256 / 144).bake(device="cuda"), cfg)
    r.render_frame()

    def refuse(*a, **k):
        raise AssertionError("the plain fit ran on the card")

    monkeypatch.setattr(bmfr, "regression_plain", refuse)
    monkeypatch.setattr(bmfr, "_fit_window", refuse)
    for pose in POSES:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        r.set_camera_pose(*pose)
        r.render_frame()
        r.display()
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["bmfr_fit"] == 1 and cuda.READS["host_reads"] == 1


@pytest.mark.cuda
def test_a_wavefront_frame_on_the_card_reads_the_device_once():
    """A wavefront frame on the BVH tier on the card: one host read (the
    splat's live count), a launch of the shaded kernel a closest query and
    of the any-hit kernel a shadow batch, and `cuda.RAYS` the BDPT
    algorithm's count, with the spans on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _wavefront_renderer(128, 72, device="cuda")
    r.render_frame()
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with Profiler(enabled=True, wait=False) as prof:
        r.render_frame()
    torch.cuda.synchronize()
    n = 128 * 72
    assert cuda.READS["host_reads"] == 1
    assert cuda.LAUNCHES["bvh_shaded"] == 6 and cuda.LAUNCHES["bvh_occluded"] == 3
    assert cuda.RAYS == {"bvh_closest": 0, "bvh_shaded": 6 * n, "bvh_occluded": 10 * n}
    assert set(prof.events) >= WAVEFRONT_SPANS


@contextlib.contextmanager
def _sync_debug():
    torch.cuda.set_sync_debug_mode("warn")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_profile_calls_counts_the_same_with_spans_on_and_off(monkeypatch):
    """`profile_calls` of an interactive frame (BMFR on) counts the same
    device operations a frame whether the spans open their ranges or not,
    and the spans' ranges add nothing to the device's busy time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _renderer("cuda", 256, plain=False)
    for _ in range(3):
        r.render_frame()
    on = frame_profile.profile_calls(r.render_frame, 3)
    assert any(e.name == "frame/bmfr/regression" for e in on[4].events())
    with monkeypatch.context() as mp:  # the spans as with no profiler recording
        mp.setattr(profiler, "_autograd_profiler", SimpleNamespace(_is_profiler_enabled=False))
        off = frame_profile.profile_calls(r.render_frame, 3)
    assert not any(e.name.startswith("frame") for e in off[4].events())
    assert on[2] == off[2]
    assert not any(name.startswith("frame") for name in on[3])
    assert on[1] <= 1.25 * off[1] and off[1] <= 1.25 * on[1]

