"""The port's entry point (pipeline/app.py), checkpoint and resume
(utils/checkpoint.py), profiler (utils/profiler.py) and
`Renderer.render_frame_profiled` on the CPU, against the JAX package's
where the two share a format: the checkpoint written by either package
resumes in the other with every field bit for bit (no JAX render: the JAX
Renderer's state is filled with seeded arrays), and the CLI parser has
JAX's options, defaults and choices.  test_extras.py's profiler, profiled
frame, CLI and SampleTest cases run on the port at 16x16 or 24x24, and
the CLI's .fscene, .obj, --animate (with --checkpoint / --resume),
--export-scene and --shard 2 routes at 16x16 against Renderer on the same
scene."""
import contextlib
import io
import json
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box as jcornell_box
from fyp_bidirectionalpathtracer_tpu.pipeline import app as japp
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer as JRenderer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils import checkpoint as jcheckpoint
from fyp_bidirectionalpathtracer_tpu.utils.config import RenderConfig as JRenderConfig
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.pipeline import app
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    Renderer,
    make_cornell_renderer,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.utils import checkpoint
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig
from fyp_bidirectionalpathtracer_tpu_torch.utils.image import read_png, write_png
from fyp_bidirectionalpathtracer_tpu_torch.utils.profiler import Profiler
from test_torch_textured import jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

H, W = 20, 28
SMALL = ["--scene", "cornell", "--width", "16", "--height", "16"]


# ------------------------------------------------------------ checkpoints
@pytest.fixture(scope="module")
def renderers():
    """A JAX Renderer (never rendered) and a port Renderer on the CPU, on
    the same bake, at 28x20."""
    jb = JScene.from_built(jcornell_box(), aspect=W / H).bake()
    pb = baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")
    return (lambda: JRenderer(jb, JRenderConfig(width=W, height=H)),
            lambda: Renderer(pb, RenderConfig(width=W, height=H)))


def _seeded_state(seed: int) -> dict:
    rs = np.random.RandomState(seed)
    img = lambda: rs.normal(size=(H, W, 4)).astype(np.float32)  # noqa: E731
    return {"accum_last": img(), "accum_count": np.int32(rs.randint(1, 99)),
            "bmfr_prev_pos": img(), "bmfr_prev_norm": img(), "bmfr_prev_noisy": img(),
            "bmfr_prev_filtered": img(), "bmfr_frame_number": np.int32(rs.randint(1, 99)),
            "camera_pos": rs.uniform(-1, 1, 3).astype(np.float32),
            "camera_target": rs.uniform(-1, 1, 3).astype(np.float32) + 2.0,
            "camera_up": np.float32([0.1, 1.0, 0.05]),
            "prev_view_proj": rs.normal(size=(4, 4)).astype(np.float32),
            "frame_index": int(rs.randint(1, 999)), "time": float(rs.uniform(0, 9))}


def _fill_jax(r, s):
    r.state.accum = r.state.accum.replace(last_frame=jnp.asarray(s["accum_last"]),
                                          count=jnp.asarray(s["accum_count"]))
    r.state.bmfr = r.state.bmfr.replace(**{k: jnp.asarray(s["bmfr_" + k]) for k in (
        "prev_pos", "prev_norm", "prev_noisy", "prev_filtered", "frame_number")})
    r.state.frame_index, r.state.time = s["frame_index"], s["time"]
    r.set_camera_pose(s["camera_pos"], s["camera_target"], s["camera_up"])
    r.camera = r.camera.replace(prev_view_proj=jnp.asarray(s["prev_view_proj"]))


def _fill_port(r, s):
    r.state.accum = AccumState.from_arrays(
        {"last_frame": s["accum_last"], "count": s["accum_count"]}, device="cpu")
    r.state.bmfr = BMFRState.from_arrays({k: s["bmfr_" + k] for k in (
        "prev_pos", "prev_norm", "prev_noisy", "prev_filtered", "frame_number")}, device="cpu")
    r.state.frame_index, r.state.time = s["frame_index"], s["time"]
    r.set_camera_pose(s["camera_pos"], s["camera_target"], s["camera_up"])
    r.camera = replace(r.camera, prev_view_proj=torch.from_numpy(s["prev_view_proj"]))


def _fields(r) -> dict:
    """Every checkpointed field of either package's Renderer, as numpy."""
    n = lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    st, cam = r.state, r.camera
    return {"accum_last": n(st.accum.last_frame), "accum_count": n(st.accum.count),
            **{"bmfr_" + k: n(getattr(st.bmfr, k)) for k in (
                "prev_pos", "prev_norm", "prev_noisy", "prev_filtered", "frame_number")},
            "camera_pos": n(cam.pos_w), "camera_target": n(cam.target), "camera_up": n(cam.up),
            "prev_view_proj": n(cam.prev_view_proj), "frame_index": st.frame_index,
            "time": st.time}


def _assert_fields_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        g = got[k]
        if isinstance(v, (int, float)):
            assert g == v and type(g) is type(v), k
        else:
            assert g.dtype == v.dtype and g.shape == v.shape, (k, g.dtype, v.dtype)
            np.testing.assert_array_equal(g.view(np.int32), v.view(np.int32), err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(renderers, tmp_path, direction):
    """The writer's state, saved by its package's save_render_state, loads
    through the other package's load_render_state with every field bit for
    bit, the camera where that package keeps it (host tensors in the port,
    the accumulation and BMFR histories on the renderer's device)."""
    make_jax, make_port = renderers
    s = _seeded_state(1 if direction == "jax_to_port" else 2)
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        writer, reader = make_jax(), make_port()
        _fill_jax(writer, s)
        jcheckpoint.save_render_state(path, writer)
        checkpoint.load_render_state(path, reader)
        assert reader.camera.pos_w.device.type == "cpu"
        assert reader.state.accum.last_frame.device == reader.baked.device
    else:
        writer, reader = make_port(), make_jax()
        _fill_port(writer, s)
        checkpoint.save_render_state(path, writer)
        jcheckpoint.load_render_state(path, reader)
    want = _fields(writer)
    _assert_fields_equal(_fields(reader), want)
    for k, v in s.items():  # the writer held the seeded state
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(v), err_msg=k)
    with np.load(path + ".npz") as z:
        assert set(z.files) == {k for k in s if k not in ("frame_index", "time")}
    with open(path + ".json") as fh:
        assert json.load(fh) == {"frame_index": s["frame_index"], "time": s["time"],
                                 "width": W, "height": H}


def test_checkpoint_refuses_another_resolution(renderers, tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_render_state(path, renderers[1]())
    other = make_cornell_renderer(16, device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        checkpoint.load_render_state(path, other)


def test_checkpoint_roundtrip(tmp_path):
    """JAX's test_checkpoint_roundtrip on the port: 3 frames, save, load
    into a new renderer; both continue bit for bit."""
    r1 = make_cornell_renderer(24, device="cpu")
    r1.render(3)
    path = str(tmp_path / "ckpt")
    checkpoint.save_render_state(path, r1)
    r2 = make_cornell_renderer(24, device="cpu")
    checkpoint.load_render_state(path, r2)
    assert r2.state.frame_index == 3
    _assert_fields_equal(_fields(r2), _fields(r1))
    np.testing.assert_array_equal(r1.render_frame().numpy(), r2.render_frame().numpy())
    assert int(r2.state.accum.count) == 4  # the pose was restored: no reset


# --------------------------------------------------- profiler, profiled frame
def test_profiler_report():
    prof = Profiler()
    with prof.event("frame"):
        with prof.event("gbuffer"):
            pass
        with prof.event("bdpt", sync=torch.ones(3)):
            pass
    rep = prof.report()
    assert "frame" in rep and "gbuffer" in rep
    d = prof.as_dict()
    assert d["frame"]["count"] == 1 and d["frame/bdpt"]["count"] == 1
    off = Profiler(enabled=False)
    with off.event("frame") as h:
        h[0] = torch.ones(1)
    assert off.events == {}


@pytest.mark.parametrize("megakernel", ["auto", "off"])
def test_profiled_render_matches_fused(megakernel):
    """render_frame_profiled (each pass waited for by its event) gives
    render_frame's frames bit for bit and records the per-pass events."""
    cfg = {"bdpt": BDPTConfig(megakernel=megakernel)}
    r1 = make_cornell_renderer(24, device="cpu", **cfg)
    r2 = make_cornell_renderer(24, device="cpu", **cfg)
    prof = Profiler()
    for _ in range(2):
        a = r1.render_frame()
        b = r2.render_frame_profiled(prof)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for key in r1.channels:
        np.testing.assert_array_equal(r1.channels[key].numpy(), r2.channels[key].numpy(), key)
    # the passes' events, the spans under the megakernel (the CPU's splat
    # mode 'direct' has none) or under the wavefront's passes (its stages and
    # each query; the dense tier sorts no batch), and the camera's, outside
    # the frame
    stages = ({"megakernel", "megakernel/frame_args", "megakernel/k1"} if megakernel == "auto"
              else {"gbuffer", "gbuffer/trace", "bdpt", "bdpt/subpaths", "bdpt/subpaths/trace",
                    "bdpt/shadows", "bdpt/shadows/trace"})
    assert set(prof.events) == {"camera", "frame"} | {f"frame/{s}" for s in
                                                      stages | {"accumulate", "bmfr"}}
    assert prof.as_dict()["frame"]["count"] == 2
    assert r1.state.frame_index == r2.state.frame_index == 2


# ------------------------------------------------------------------ the CLI
def test_cli_app_smoke(tmp_path):
    res = app.main(SMALL + ["--frames", "2", "--ssframes", "1", "--outputdir", str(tmp_path),
                            "--output", "final.png"], device="cpu")
    assert os.path.exists(res["output"])
    assert read_png(res["output"]).shape == (16, 16, 3)
    assert len(res["screenshots"]) == 1
    assert os.path.exists(os.path.join(str(tmp_path), "results.json"))
    assert len(res["frame_times"]) == 2 and res["sec_per_frame"] > 0


def test_sampletest_measurement_tasks(tmp_path):
    """SampleTest parity (SampleTest.h:58-62): load-time, perf-range and
    memory-range tasks record measurements and verdicts in results.json."""
    res = app.main(SMALL + [
        "--frames", "4", "--outputdir", str(tmp_path),
        "--loadtime", "600", "--perfframes", "1:3", "--perfrange", "0:600",
        "--memframes", "0:3", "--memrange", "100000", "--profile",
    ], device="cpu")
    with open(tmp_path / "results.json") as fh:
        disk = json.load(fh)
    for r in (res, disk):
        assert r["load_time"] > 0
        assert r["perf_ranges"][0]["frames"] == [1, 3]
        assert r["perf_ranges"][0]["avg"] > 0
        assert r["memory_ranges"][0]["end_mb"] > 0
        assert r["tests"]["passed"] is True
        assert r["tests"]["load_time"]["passed"] is True
        assert r["profile"]["frame"]["count"] == 4

    # failing thresholds produce failing verdicts
    res = app.main(SMALL + [
        "--frames", "2", "--outputdir", str(tmp_path),
        "--loadtime", "0.000001", "--memframes", "0:1", "--memrange", "0.0000001",
    ], device="cpu")
    assert res["tests"]["load_time"]["passed"] is False
    assert res["tests"]["passed"] is False


def test_cli_resume_continues_bit_for_bit(tmp_path):
    """--checkpoint after 2 frames, then --resume to 4: the final image and
    state equal an unbroken 4-frame run's."""
    ck, whole = str(tmp_path / "ck"), str(tmp_path / "whole")
    app.main(SMALL + ["--frames", "2", "--checkpoint", ck, "--outputdir", str(tmp_path / "a")],
             device="cpu")
    res = app.main(SMALL + ["--frames", "4", "--checkpoint", ck, "--resume",
                            "--outputdir", str(tmp_path / "a")], device="cpu")
    assert len(res["frame_times"]) == 2
    ref = app.main(SMALL + ["--frames", "4", "--checkpoint", whole,
                            "--outputdir", str(tmp_path / "b")], device="cpu")
    with open(res["output"], "rb") as a, open(ref["output"], "rb") as b:
        assert a.read() == b.read()
    with np.load(ck + ".npz") as a, np.load(whole + ".npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_probe_route(tmp_path):
    """--envmap with an 8x16 PNG (read_image) and --probe: the LightProbe at
    the demo sizes, probe_lit_pass, the tone map, probe_lit.png."""
    env = np.random.RandomState(3).uniform(0, 1, (8, 16, 3)).astype(np.float32)
    write_png(str(tmp_path / "env.png"), env)
    res = app.main(SMALL + ["--frames", "1", "--envmap", str(tmp_path / "env.png"),
                            "--env-bilinear", "--probe", "--tonemap", "aces",
                            "--outputdir", str(tmp_path)], device="cpu")
    assert res["probe_lit"] == os.path.join(str(tmp_path), "probe_lit.png")
    lit = read_png(res["probe_lit"])
    assert lit.shape == (16, 16, 3) and lit.max() > 0


def _actions(parser) -> list:
    return [(a.option_strings, a.dest, a.default, a.choices, a.type, a.nargs, a.const,
             a.required, type(a).__name__, a.metavar) for a in parser._actions]


def test_parser_matches_jax():
    assert _actions(app.build_arg_parser()) == _actions(japp.build_arg_parser())
    assert app._parse_ranges("1:3, 5:9,") == japp._parse_ranges("1:3, 5:9,") == [(1, 3), (5, 9)]
    assert app._rss_mb() > 0


def _write_scene_files(folder) -> dict:
    """A Cornell .fscene with a camera path (tests/test_torch_animation.py)
    and Cornell's geometry as an OBJ (save_obj)."""
    from fyp_bidirectionalpathtracer_tpu_torch.models.obj import save_obj
    from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
    from test_torch_animation import cornell_fscene

    built = cornell_box()
    save_obj(os.path.join(folder, "mesh.obj"), built.meshes, built.materials)
    return {"fscene": cornell_fscene(folder), "obj": os.path.join(folder, "mesh.obj")}


def _direct_png(tmp_path, scene, frames, animate=False) -> bytes:
    """The PNG of `frames` frames through Renderer on app.load_scene's
    scene, as the CLI renders it (max_lights 16, the default config)."""
    r = Renderer(app.load_scene(scene).bake(max_lights=16, device="cpu"),
                 RenderConfig(width=16, height=16))
    for _ in range(frames):
        if animate:
            r.animate(1.0 / 60.0)
        r.render_frame()
    path = str(tmp_path / "direct.png")
    write_png(path, r.display())
    return open(path, "rb").read()


@pytest.mark.parametrize("flags,item", [
    (["--scene", "room.fscene"], "12c"),
    (["--scene", "mesh.obj"], "12c"),
    (["--animate"], "12c"),
    (["--export-scene", "out.fscene"], "12c"),
    (["--shard", "2"], "13"),
], ids=["fscene", "obj", "animate", "export-scene", "shard"])
def test_unported_flags_raise(tmp_path, flags, item):
    """The flags of ROADMAP items 12c and 13 run at 16x16 and their output
    equals Renderer's on the same scene: an .fscene scene, an .obj scene,
    --animate over an .fscene's camera path (2 frames), --export-scene
    (the exported file loads to the same triangles and renders the same
    image), and --shard 2 (two ranks on the CPU, rank 0 writing; the
    frame's splat image is summed over the ranks, so the PNG is within one
    8-bit step of Renderer's)."""
    argv = SMALL + ["--frames", "2", "--outputdir", str(tmp_path / "out")]
    if item == "13":
        with contextlib.redirect_stdout(io.StringIO()):
            res = app.main(argv + flags, device="cpu")
        assert len(res["frame_times"]) == 2 and os.path.exists(tmp_path / "out" / "results.json")
        got = read_png(res["output"])
        _direct_png(tmp_path, "cornell", 2)
        want = read_png(str(tmp_path / "direct.png"))
        assert got.shape == (16, 16, 3) and np.abs(got - want).max() <= 1.0 / 255 + 1e-6
        return
    files = _write_scene_files(str(tmp_path))
    exported = str(tmp_path / "export" / "out.fscene")
    if flags[0] == "--scene":
        scene = files["fscene" if flags[1].endswith(".fscene") else "obj"]
        argv += ["--scene", scene]
    elif flags[0] == "--animate":
        argv += ["--scene", files["fscene"], "--animate"]
    else:
        argv += ["--export-scene", exported]
    with contextlib.redirect_stdout(io.StringIO()):
        res = app.main(argv, device="cpu")
    assert len(res["frame_times"]) == 2 and read_png(res["output"]).shape == (16, 16, 3)
    got = open(res["output"], "rb").read()
    if flags[0] == "--scene":
        assert got == _direct_png(tmp_path, scene, 2)
    elif flags[0] == "--animate":
        assert got == _direct_png(tmp_path, files["fscene"], 2, animate=True)
        assert got != _direct_png(tmp_path, files["fscene"], 2)  # the camera moved
    else:
        assert got == _direct_png(tmp_path, "cornell", 2)
        assert os.path.exists(str(tmp_path / "export" / "out.obj"))
        assert app.load_scene(exported).n_triangles() == app.load_scene("cornell").n_triangles()
        with contextlib.redirect_stdout(io.StringIO()):
            again = app.main(["--scene", exported] + SMALL[2:] + [
                "--frames", "2", "--outputdir", str(tmp_path / "again")], device="cpu")
        assert read_png(again["output"]).shape == (16, 16, 3)


def test_cli_animate_resume_continues_bit_for_bit(tmp_path):
    """--animate over camera and object paths (a re-bake every frame):
    --checkpoint after 2 frames, then --resume to 4, restores `time` and
    poses the objects as the unbroken run did: the final PNG and state
    equal an unbroken 4-frame run's."""
    from test_torch_animation import cornell_fscene

    scene = cornell_fscene(str(tmp_path), camera_path=True, object_path=True)
    base = ["--scene", scene] + SMALL[2:] + ["--animate", "--fixedtimedelta", "0.03"]
    ck, whole = str(tmp_path / "ck"), str(tmp_path / "whole")
    with contextlib.redirect_stdout(io.StringIO()):
        app.main(base + ["--frames", "2", "--checkpoint", ck, "--outputdir",
                         str(tmp_path / "a")], device="cpu")
        with open(ck + ".json") as fh:
            assert json.load(fh)["time"] == 0.06
        res = app.main(base + ["--frames", "4", "--checkpoint", ck, "--resume",
                               "--outputdir", str(tmp_path / "a")], device="cpu")
        ref = app.main(base + ["--frames", "4", "--checkpoint", whole,
                               "--outputdir", str(tmp_path / "b")], device="cpu")
    assert len(res["frame_times"]) == 2
    with open(res["output"], "rb") as a, open(ref["output"], "rb") as b:
        assert a.read() == b.read()
    with np.load(ck + ".npz") as a, np.load(whole + ".npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(ck + ".json") as a, open(whole + ".json") as b:
        assert json.load(a) == json.load(b)


def test_main_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(SMALL + ["--frames", "1", "--outputdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_cornell_renderer(8)
    with pytest.raises(ValueError, match="unknown scene"):
        app.load_scene("nowhere")
