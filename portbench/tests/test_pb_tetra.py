"""The `tetra` configuration (SPD's Sierpinski tetrahedron, `geometry/
tetra.py`) and its cell: the builder's triangles, the committed
configuration's runs on the CPU (the wavefront route, correct against the
reference), its new metrics' readers, and `bvh_roofline`'s ray count held
against the rays the port hands its BVH wrappers (`cuda.RAYS`).

A CPU frame of 16,384 triangles runs the BVH kernels' plain versions,
which test every triangle: ~3 s a frame at 16x9 and ~17 s at 32x18, so
the runs here are 16x9, with a window of two frames (the view's frame 1,
which `progressive` checks, is the second)."""
import importlib.util
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import programspans
import run
import scenes
from programspans import Stretch

from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.pipeline import renderer as renderer_mod
from fyp_bidirectionalpathtracer_tpu_torch.utils import profiler

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDER = os.path.join(PORTBENCH, "geometry", "tetra.py")
SIZE = (16, 9)
SEEDS = [2**31 + 4099, 3_000_000_019]
CORNERS = np.asarray([[1, 1, 1], [-1, -1, 1], [-1, 1, -1], [1, -1, -1]], np.float64)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _build(depth, **kw):
    return _module(BUILDER, "tetra_builder").build(dict(depth=depth, **kw))


def _lattice(depth):
    """The Sierpinski tetrahedron's vertices at `depth`, from the corners by
    the four maps x -> (x + corner) / 2."""
    points = {tuple(c) for c in CORNERS}
    for _ in range(depth):
        points = {tuple((np.asarray(p) + c) / 2) for p in points for c in CORNERS}
    return points


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_the_builder_makes_the_sierpinski_tetrahedron(depth):
    (mesh,) = _build(depth, size=2.0, center=(0.0, 0.0, 0.0))
    n = 4 ** (depth + 1)
    tri = mesh["positions"].astype(np.float64)[mesh["indices"]]          # [n, 3, 3]
    assert tri.shape == (n, 3, 3) and mesh["indices"].dtype == np.int32
    assert {tuple(p) for p in tri.reshape(-1, 3)} == _lattice(depth)
    # each tetrahedron's four faces wound outwards, the normals flat and unit
    face_n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centre = np.repeat(tri.reshape(-1, 12, 3).mean(1), 4, axis=0)
    assert ((face_n * (tri.mean(1) - centre)).sum(-1) > 0).all()
    unit = face_n / np.linalg.norm(face_n, axis=1, keepdims=True)
    np.testing.assert_allclose(mesh["normals"].reshape(n, 3, 3),
                               np.repeat(unit[:, None], 3, axis=1), atol=1e-6)
    assert mesh["uvs"].shape == (3 * n, 2) and mesh["material"] == 0


def test_the_builder_is_deterministic_and_imports_only_what_builders_may():
    a, b = _build(3), _build(3)
    for key in ("positions", "normals", "uvs", "indices"):
        assert a[0][key].tobytes() == b[0][key].tobytes()
    assert scenes.builder_imports(BUILDER) <= scenes.BUILDER_IMPORTS


def test_the_committed_configuration():
    cfg = scenes.load_config("tetra")
    arrays = scenes.load_arrays(cfg)
    assert sum(len(m["indices"]) for m in arrays["meshes"]) == 16384
    manifest = run.load_manifest()
    (entry,) = [c for c in manifest["configs"] if c["name"] == "tetra"]
    assert "StandardProceduralDatabases" in entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"] and set(cfg["reduced"]) <= set(cfg)
    assert all(any(a.startswith(k + ":") for a in cfg["assumed"]) for k in cfg["reduced"])
    cell = run.find_cell(manifest, "tetra.progressive")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("tetra", "progressive", 1)


def _two_frame_window(self, seconds, sampler=None):
    """`FrameLoop.window` with two frames, whatever they take."""
    self.host_s, self.starts, self.events = [], [], []
    t0 = time.perf_counter()
    for _ in range(2):
        self.frame(sampler)
    self.latencies = []
    return 2, time.perf_counter() - t0


@pytest.mark.parametrize("seed", SEEDS)
def test_the_cell_runs_the_wavefront_route_and_is_correct(seed, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the megakernel ran a scene above its gate")

    monkeypatch.setattr(renderer_mod, "render_frame_megakernel", refuse)
    monkeypatch.setattr(run.FrameLoop, "window", _two_frame_window)
    cuda.reset_launch_counts()
    result, report = run.run("tetra.progressive", seed, 0.0, False, device="cpu", size=SIZE)
    assert result["correct"] and result["failed"] == 0, report
    assert cuda.RAYS["bvh_shaded"] > 0 and cuda.RAYS["bvh_occluded"] > 0


def test_a_wavefront_fault_is_caught(monkeypatch):
    """The BDPT pass's image altered where it is produced: not correct."""
    def altered(*args, _orig=renderer_mod.bdpt_pass, **kw):
        return _orig(*args, **kw) * 1.02

    monkeypatch.setattr(renderer_mod, "bdpt_pass", altered)
    monkeypatch.setattr(run.FrameLoop, "window", _two_frame_window)
    result, report = run.run("tetra.progressive", SEEDS[0], 0.0, False, device="cpu", size=SIZE)
    assert not result["correct"], report


def test_the_roofline_s_rays_are_the_rays_the_port_traces():
    """`bvh_roofline` counts a frame's rays from the BDPT algorithm; one
    wavefront frame of the committed configuration on the CPU hands the
    BVH wrappers as many, closest and any-hit alike."""
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.utils import config as port_config
    from traffic import load_traffic

    roofline = _module(os.path.join(PORTBENCH, "metrics", "bvh_roofline.py"), "bvh_roofline")
    cfg, mix = scenes.load_config("tetra"), load_traffic("progressive")
    w, h = SIZE
    baked = Scene.from_built(scenes.port_scene(scenes.load_arrays(cfg)),
                             aspect=w / h).bake(device="cpu")
    r = Renderer(baked, run.render_config(port_config, cfg, mix, w, h))
    cuda.reset_launch_counts()
    r.render_frame()
    want = roofline.frame_rays(w, h, cfg["max_depth"])
    assert cuda.RAYS["bvh_closest"] + cuda.RAYS["bvh_shaded"] == want["closest"]
    assert cuda.RAYS["bvh_occluded"] == want["any_hit"]


def test_the_roofline_s_bytes():
    roofline = _module(os.path.join(PORTBENCH, "metrics", "bvh_roofline.py"), "bvh_roofline")
    assert [roofline.connections(d) for d in (1, 2, 3, 4)] == [0, 1, 4, 8]
    rays = roofline.frame_rays(1280, 720, 3)
    n = 1280 * 720
    assert (rays["closest"], rays["any_hit"]) == (6 * n, 10 * n)
    scene = 16384 * 36 + 4095 * 56
    assert roofline.frame_bytes(1280, 720, 3, 16384) == 6 * n * 48 + 10 * n * 33 + 9 * scene


def _trace_ctx(device):
    return SimpleNamespace(device=device, window=(0.0, 1e6), traced_frames=4, width=1280,
                           height=720, depth=3, n_tris=16384)


def test_the_bvh_readers_on_a_synthetic_trace():
    device = [("void bvh_closest_kernel<true>(...)", 0.0, 1000.0),
              ("void bvh_fields_kernel(...)", 1000.0, 1500.0),
              ("void bvh_occluded_kernel(...)", 2000.0, 4500.0),
              ("void frame_kernel<3>(...)", 5000.0, 9000.0)]
    ctx = _trace_ctx(device)
    assert run.reader("bvh_ms")(ctx) == pytest.approx(4000.0 / 1e3 / 4)
    roofline = _module(os.path.join(PORTBENCH, "metrics", "bvh_roofline.py"), "bvh_roofline")
    bound_ms = roofline.frame_bytes(1280, 720, 3, 16384) / 3.35e12 * 1e3
    assert run.reader("bvh_roofline")(ctx) == pytest.approx(100.0 * bound_ms / 1.0)
    for name in ("bvh_ms", "bvh_roofline"):
        assert run.reader(name)(_trace_ctx(device[-1:])) is None


def test_the_bdpt_span_readers():
    events = {"frame/bdpt": {"avg_ms": 50.0, "self_ms": 5.0, "count": 10},
              "frame/bdpt/subpaths": {"avg_ms": 20.0, "self_ms": 4.0, "count": 10},
              "frame/bdpt/subpaths/trace": {"avg_ms": 3.0, "self_ms": 3.0, "count": 50},
              "frame/bdpt/shadows": {"avg_ms": 12.0, "self_ms": 2.0, "count": 10}}
    ctx = SimpleNamespace(program_spans=Stretch(frames=10, events=events, host_reads=10))
    assert run.reader("host_ms.subpaths")(ctx) == pytest.approx(20.0)
    assert run.reader("host_ms.shadows")(ctx) == pytest.approx(12.0)
    megakernel = SimpleNamespace(program_spans=Stretch(frames=10, events={}, host_reads=10))
    for name in ("host_ms.subpaths", "host_ms.shadows"):
        assert run.reader(name)(megakernel) is None


@pytest.mark.parametrize("name", ["host_ms.subpaths", "host_ms.shadows"])
def test_a_program_without_the_tracer_reads_nothing(name, monkeypatch):
    monkeypatch.delattr(profiler, "span")
    ctx = SimpleNamespace(config=None, traffic=None, width=8, height=8)
    assert run.reader(name)(ctx) is None
    assert ctx.program_spans is None and programspans.of(ctx) is None

