"""Row sharding (parallel/sharding.py) on the CPU, against the port's
single-device frame and the JAX package's sharded functions.

Every run of the port on two ranks shares one launch of two gloo ranks on
the CPU (the `ranks` fixture: ~12 s, most of it the frames), and the app's
three --shard runs each launch their own; the whole file takes ~60 s
serially, alone.  This process and the ranks run one intra-op thread each
(`torch_threads.one_intra_op_thread`): in a parallel test run, the default
of one a core in every process made the file take ~670 s.  It holds:

- (a) `frame_plain` over 2 and 3 row shards (`FrameArgs.pix0`,
  `sub_pixels`), side by side, bit for bit against the whole-image call:
  the own-pixel result, the G-buffer rows, the splat pixels with the
  W*H dead sentinel and the splat rows (Cornell 32x48, packed and not;
  the deferred-texture variant's records and parts on the textured room);
- (b) `ray_traced_gbuffer(row0=, sub_height=)` over 2 shards bit for bit
  against the whole image, and against JAX's `ray_traced_gbuffer` with the
  same rows within tests/test_torch_wavefront.py's G-buffer bound (1% of
  pixels over 1e-3), pinhole and thin lens;
- (c) `bmfr_pass(mesh=)` on 2 ranks (tests/test_parallel.py's inputs: 3
  frames of motion across the shard boundary) at 64 rows a rank (the halo
  exchange everywhere), 24 rows a rank (the gather-all fallback
  everywhere: the history window's 48 rows and the regression's 40-row
  bottom halo exceed a rank's rows) and 64 rows a rank with the bf16
  history pack: against the port's one-device pass within JAX's own
  sharded-vs-single bounds (atol 1e-5 with float32 history, 1e-3 with
  bf16; tests/test_parallel.py), and against JAX's `bmfr_pass` under
  `shard_map` on `make_mesh(2)` within atol 1e-4 (float32 history) and
  5e-3 (bf16), the differences of the two packages' one-device passes
  (their regressions sum in other orders; bf16 rounding reaches the fit:
  measured 2.2e-5 and 2.6e-3).  JAX's 8 rows a rank on 2 devices is a
  16-row image, shorter than the regression's halo, which JAX refuses, so
  the fallback runs at 24;
- (d) `Renderer(mesh=)` on its three routes (megakernel, wavefront, BMFR
  on) against the single-device `Renderer`, 2 frames: G-buffer channels
  bit for bit, `PipelineOutput` within atol 2e-5 (JAX's bound,
  tests/test_parallel.py), equal accumulation counts; the shards' pixel
  counts (24 x 32 = 768) are no multiple of 128, which JAX's megakernel
  needs and the port's K1 does not;
- (e) the port's `sharded_wavefront_step` against JAX's on `make_mesh(2)`
  at 12x48, within the single-device wavefront bounds of
  tests/test_torch_wavefront.py;
- (f) `app.main(["--shard", "2", ...])` at 16x16: the checkpoint's
  accumulator within 2e-5 of the unsharded run's, the PNG written, and a
  sharded --resume at 8 frames bit for bit against the unbroken sharded
  16;
- the row collectives bit for bit (-0.0 and NaN included), the mesh's
  checks, and the backend rule.
"""
import contextlib
import dataclasses
import io
import types

import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box, textured_room
from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu_torch.parallel import sharding
from fyp_bidirectionalpathtracer_tpu_torch.passes import bmfr as bmfr_mod
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import (
    pixel_jitter_for_frame,
    ray_traced_gbuffer,
)
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    BDPT_FRAME_INIT,
    GBUF_FRAME_INIT,
    Renderer,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
    BDPTConfig,
    BMFRConfig,
    RenderConfig,
)
from torch_threads import one_intra_op_thread  # noqa: F401

GBUF_KEYS = ("WorldPosition", "WorldNormal", "MaterialDiffuse",
             "MaterialSpecRough", "MaterialExtraParams", "Emissive")
RW, RH = 24, 64          # (d): the Renderer routes
WF_W, WF_H = 48, 12      # (e): the wavefront step against JAX's
BMFR_W = 96
BMFR_CASES = {"64": (64, "f32"), "24": (24, "f32"), "bf16": (64, "bf16")}
ROUTES = ("megakernel", "wavefront", "bmfr")


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _bit_equal(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------- (a) K1's shards
@pytest.mark.parametrize("scene,n,packed", [("cornell", 2, False), ("cornell", 3, True),
                                            ("textured", 2, False)],
                         ids=["cornell-2", "cornell-3-rgb8e", "textured-2"])
def test_frame_plain_shards_equal_whole_frame(scene, n, packed):
    w, h = 32, 48
    textured = scene == "textured"
    built = textured_room() if textured else cornell_box()
    baked = Scene.from_built(built, aspect=w / h).bake(device="cpu")
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig(defer_textures=textured))
    args = frame_mod.frame_args(baked, w, h, BDPT_FRAME_INIT, pixel_jitter_for_frame(7), cfg,
                                gbuf_frame=GBUF_FRAME_INIT, splat_rgb8e=packed)
    assert args.textured == textured and args.n_sub == w * h
    whole = frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack)
    sub = h // n * w
    shards = [frame_mod.frame_plain(dataclasses.replace(args, pix0=r * sub, sub_pixels=sub),
                                    baked.light_rows, baked.tri_pack) for r in range(n)]
    for name, want in vars(whole).items():
        if want is not None:
            assert all(getattr(s, name).shape[-1] == sub for s in shards), name
            assert _bit_equal(torch.cat([getattr(s, name) for s in shards], -1), want), name
    dead = whole.splat_pix == w * h
    assert 0 < int(dead.sum()) < dead.numel()


def test_frame_args_refuse_pixels_outside_the_image():
    baked = Scene.from_built(cornell_box()).bake(device="cpu")
    args = frame_mod.frame_args(baked, 16, 8, 1, pixel_jitter_for_frame(1),
                                RenderConfig(width=16, height=8), pix0=64, sub_pixels=128)
    with pytest.raises(ValueError, match="outside"):
        frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack, baked.bvh_nodes)


# ------------------------------------------------------ (b) the G-buffer
@pytest.mark.parametrize("thin_lens", [False, True], ids=["pinhole", "thin-lens"])
def test_gbuffer_rows_equal_whole_and_jax(thin_lens):
    import jax.numpy as jnp

    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box as jcornell_box
    from fyp_bidirectionalpathtracer_tpu.ops.shading import make_shaded_tracer as jtracer
    from fyp_bidirectionalpathtracer_tpu.passes import gbuffer as jgbuffer
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
    from test_torch_wavefront import jax_scene_arrays

    w, h = 32, 24
    jb = JScene.from_built(jcornell_box(), aspect=w / h).bake()
    pb = baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")
    kw = dict(use_thin_lens=thin_lens, lens_radius=1.5 / 16.0 if thin_lens else 0.0,
              focal_len=1.5)
    jit = pixel_jitter_for_frame(BDPT_FRAME_INIT)
    whole = ray_traced_gbuffer(pb, make_shaded_tracer(pb), w, h, GBUF_FRAME_INIT, jit, **kw)
    jtrace = jtracer(jb)
    for row0 in (0, h // 2):
        got = ray_traced_gbuffer(pb, make_shaded_tracer(pb), w, h, GBUF_FRAME_INIT, jit,
                                 row0=row0, sub_height=h // 2, **kw)
        want = jgbuffer.ray_traced_gbuffer(jb, jtrace, w, h, jnp.uint32(GBUF_FRAME_INIT),
                                           jnp.asarray(jit.numpy()), row0=row0,
                                           sub_height=h // 2, **kw)
        for key in GBUF_KEYS:
            assert _bit_equal(got[key], whole[key][row0:row0 + h // 2]), key
            frac = (np.abs(np.asarray(want[key]) - got[key].numpy()).max(-1) > 1e-3).mean()
            assert frac <= 0.01, (key, frac)


# ------------------------------------- the port's runs on two gloo ranks
def _bmfr_cfg(pack):
    return BMFRConfig(enabled=True, preprocess=True, regression=True, postprocess=True,
                      half_screen_debug=False, history_pack=pack)


def _route_cfg(route):
    if route == "wavefront":
        return RenderConfig(width=RW, height=RH, bdpt=BDPTConfig(megakernel="off"))
    if route == "bmfr":
        return RenderConfig(width=RW, height=RH, bmfr=_bmfr_cfg("f32"))
    return RenderConfig(width=RW, height=RH)


def _route_frames(route, mesh, frames=2):
    """`frames` frames of Cornell through Renderer (on `mesh`, or one
    device): the channels a frame and the accumulation count."""
    r = Renderer(Scene.from_built(cornell_box(), aspect=RW / RH).bake(device="cpu"),
                 _route_cfg(route), mesh=mesh)
    out = []
    for _ in range(frames):
        r.render_frame()
        out.append(dict(r.channels))
    return out, int(r.state.accum.count)


def _wavefront_cfg():
    return RenderConfig(width=WF_W, height=WF_H, bdpt=BDPTConfig(megakernel="off"))


def _rank_work(rank, mesh, bmfr_inputs, wf_arrays):
    """Everything this file runs on a rank; CPU tensors by name."""
    out = {}
    # the row collectives on values whose bits a float sum would change
    x = torch.tensor([[-0.0, float("nan"), 1.5 + rank], [3.0, -2.0, 0.25]])
    out["gathered"] = mesh.gather_rows(x)
    above, below = mesh.exchange_rows(x[:1] + 10 * rank, x[1:] + 10 * rank)
    out["above"], out["below"] = above, below
    out["sum"] = mesh.all_reduce(torch.full((3,), float(rank + 1)))
    # (c) BMFR on synthetic channels
    for case, (rows, pack) in BMFR_CASES.items():
        frames = bmfr_inputs[case]
        state = bmfr_mod.BMFRState.create(rows, BMFR_W, device="cpu")
        outs = []
        for channels, pvp in frames:
            ch = {k: mesh.shard_rows(torch.from_numpy(v)) for k, v in channels.items()}
            cam = types.SimpleNamespace(prev_view_proj=torch.from_numpy(pvp))
            state, o = bmfr_mod.bmfr_pass(state, ch, cam, _bmfr_cfg(pack), mesh=mesh)
            outs.append(o)
        out[f"bmfr_{case}"] = (outs, state.prev_filtered, int(state.frame_number))
    # (d) the Renderer's routes
    for route in ROUTES:
        out[route] = _route_frames(route, mesh)
    # (e) the wavefront step on JAX's bake
    baked = baked_scene_from_arrays(wf_arrays, device="cpu")
    cfg = _wavefront_cfg()
    step = sharding.sharded_wavefront_step(cfg, mesh)
    ch, accum, _ = step(baked, baked.data.camera, AccumState.create(WF_H // 2, WF_W, "cpu"),
                        bmfr_mod.BMFRState.create(WF_H // 2, WF_W, "cpu"), GBUF_FRAME_INIT,
                        BDPT_FRAME_INIT, False)
    out["wavefront_step"] = (ch, int(accum.count))
    return out


@pytest.fixture(scope="module")
def jax_wavefront_bake():
    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box as jcornell_box
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene

    return JScene.from_built(jcornell_box(), aspect=WF_W / WF_H).bake()


@pytest.fixture(scope="module")
def bmfr_inputs():
    """tests/test_parallel.py's `_bmfr_frame_inputs`, 3 frames a case, as
    numpy ({channel: [H, W, 4]}, prev_view_proj [4, 4])."""
    from test_parallel import _bmfr_frame_inputs

    out = {}
    for case, (rows, _) in BMFR_CASES.items():
        frames = [_bmfr_frame_inputs(2 * rows, BMFR_W, f, shift_rows=1 + f) for f in range(3)]
        out[case] = [({k: np.asarray(v, np.float32) for k, v in ch.items()},
                      np.asarray(pvp, np.float32)) for ch, pvp in frames]
    return out


@pytest.fixture(scope="module")
def ranks(bmfr_inputs, jax_wavefront_bake):
    from test_torch_wavefront import jax_scene_arrays

    return sharding.launch(_rank_work, 2, bmfr_inputs, jax_scene_arrays(jax_wavefront_bake),
                           device="cpu")


def _rows(ranks, get):
    return torch.cat([get(r) for r in ranks], 0)


def test_row_collectives_are_exact(ranks):
    x = [torch.tensor([[-0.0, float("nan"), 1.5 + r], [3.0, -2.0, 0.25]]) for r in (0, 1)]
    for r in (0, 1):
        assert _bit_equal(ranks[r]["gathered"], torch.cat(x))
        assert torch.equal(ranks[r]["sum"], torch.full((3,), 3.0))
    # rank 0 hands its first row up (to no one) and its last row down
    assert ranks[0]["above"] is None and ranks[1]["below"] is None
    assert _bit_equal(ranks[0]["below"], x[1][:1] + 10)
    assert _bit_equal(ranks[1]["above"], x[0][1:])


@pytest.mark.parametrize("case", list(BMFR_CASES))
def test_bmfr_sharded_matches_single_device_and_jax_shard_map(ranks, bmfr_inputs, case):
    """The rows of the 2 ranks against the port's one-device pass within
    JAX's own sharded-vs-single bounds, and against JAX's `bmfr_pass` under
    `shard_map`: atol 1e-4 with float32 history (measured 2.2e-5: the two
    packages sum the regression's 1,024 products in other orders) and 5e-3
    with bf16 (measured 2.6e-3, as between the two packages' one-device
    passes: the bf16 history's rounding reaches the fit)."""
    import jax
    import jax.numpy as jnp

    from fyp_bidirectionalpathtracer_tpu.parallel import sharding as jsharding
    from fyp_bidirectionalpathtracer_tpu.passes import bmfr as jbmfr
    from fyp_bidirectionalpathtracer_tpu.utils.config import BMFRConfig as JBMFRConfig
    from test_parallel import _sharded_bmfr_step

    rows, pack = BMFR_CASES[case]
    h = 2 * rows
    assert len(jax.devices()) >= 2
    jcfg = JBMFRConfig(enabled=True, preprocess=True, regression=True, postprocess=True,
                       half_screen_debug=False, history_pack=pack)
    step = _sharded_bmfr_step(jcfg, jsharding.make_mesh(2), 2, h)
    jstate = jbmfr.BMFRState.create(h, BMFR_W)
    state = bmfr_mod.BMFRState.create(h, BMFR_W, device="cpu")
    atol = 1e-3 if pack == "bf16" else 1e-5
    jax_atol = 5e-3 if pack == "bf16" else 1e-4
    for f, (channels, pvp) in enumerate(bmfr_inputs[case]):
        jstate, want = step(jstate, {k: jnp.asarray(v) for k, v in channels.items()},
                            jnp.asarray(pvp))
        cam = types.SimpleNamespace(prev_view_proj=torch.tensor(pvp))
        state, single = bmfr_mod.bmfr_pass(
            state, {k: torch.tensor(v) for k, v in channels.items()}, cam, _bmfr_cfg(pack))
        got = _rows(ranks, lambda r: r[f"bmfr_{case}"][0][f])
        torch.testing.assert_close(got, single, atol=atol, rtol=0, msg=f"frame {f}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=jax_atol, rtol=0,
                                   err_msg=f"frame {f}")
    got_hist = _rows(ranks, lambda r: r[f"bmfr_{case}"][1])
    torch.testing.assert_close(got_hist, state.prev_filtered, atol=atol, rtol=0)
    np.testing.assert_allclose(got_hist.numpy(), np.asarray(jstate.prev_filtered),
                               atol=jax_atol, rtol=0)
    assert [r[f"bmfr_{case}"][2] for r in ranks] == [3, 3]


@pytest.mark.parametrize("route", ROUTES)
def test_renderer_routes_match_single_device(ranks, route):
    want, count = _route_frames(route, None)
    for f in range(len(want)):
        for key in GBUF_KEYS:
            assert _bit_equal(_rows(ranks, lambda r: r[route][0][f][key]), want[f][key]), key
        got = _rows(ranks, lambda r: r[route][0][f]["PipelineOutput"])
        torch.testing.assert_close(got, want[f]["PipelineOutput"], atol=2e-5, rtol=0)
    assert [r[route][1] for r in ranks] == [count, count] == [2, 2]


def test_sharded_wavefront_step_matches_jax(ranks, jax_wavefront_bake):
    import jax.numpy as jnp

    from fyp_bidirectionalpathtracer_tpu.parallel import sharding as jsharding
    from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState as JAccum
    from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState as JBMFR
    from fyp_bidirectionalpathtracer_tpu.utils import config as jconfig

    jb = jax_wavefront_bake
    jcfg = jconfig.RenderConfig(width=WF_W, height=WF_H,
                                bdpt=jconfig.BDPTConfig(megakernel="off"))
    step = jsharding.sharded_wavefront_step(jcfg, jsharding.make_mesh(2))
    want, jaccum, _ = step(jb, jb.data.camera, JAccum.create(WF_H, WF_W),
                           JBMFR.create(WF_H, WF_W), jnp.uint32(GBUF_FRAME_INIT),
                           jnp.uint32(BDPT_FRAME_INIT), jnp.asarray(False))
    got = {k: _rows(ranks, lambda r: r["wavefront_step"][0][k]).numpy() for k in want}
    for key in GBUF_KEYS:
        frac = (np.abs(np.asarray(want[key]) - got[key]).max(-1) > 1e-3).mean()
        assert frac <= 0.01, (key, frac)
    for key in ("BDPT", "PipelineOutput"):
        w = np.asarray(want[key])
        d = np.abs(w - got[key])
        frac = (d.max(-1) > 1e-3).mean()
        mad, dmean = d.mean(), abs(w[..., :3].mean() - got[key][..., :3].mean())
        assert frac <= 0.02 and mad < 5e-3 and dmean < 2e-3, (key, frac, mad, dmean)
    assert [r["wavefront_step"][1] for r in ranks] == [int(jaccum.count)] * 2


# ------------------------------------------------------------- (f) the app
def _app(argv):
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline import app

    with contextlib.redirect_stdout(io.StringIO()):
        return app.main(["--scene", "cornell", "--width", "16", "--height", "16"] + argv,
                        device="cpu")


def test_app_shard_checkpoint_and_resume(tmp_path):
    from fyp_bidirectionalpathtracer_tpu_torch.utils.image import read_png

    def run(name, frames, *extra):
        return _app(["--frames", str(frames), "--outputdir", str(tmp_path / name),
                     "--checkpoint", str(tmp_path / name / "state"), *extra])

    def accum(name):
        with np.load(tmp_path / name / "state.npz") as z:
            return z["accum_last"], int(z["accum_count"])

    run("single", 16)
    res = run("sharded", 16, "--shard", "2")
    assert len(res["frame_times"]) == 16
    assert read_png(res["output"]).shape == (16, 16, 3)
    assert (tmp_path / "sharded" / "results.json").exists()
    (a, na), (b, nb) = accum("sharded"), accum("single")
    assert na == nb == 16
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    run("resumed", 8, "--shard", "2")
    res_r = run("resumed", 16, "--shard", "2", "--resume")
    assert len(res_r["frame_times"]) == 8
    c, nc = accum("resumed")
    assert nc == 16 and np.array_equal(c.view(np.int32), a.view(np.int32))
    assert (tmp_path / "resumed" / "render.png").read_bytes() == \
        (tmp_path / "sharded" / "render.png").read_bytes()


# ------------------------------------------------- the mesh and the launch
def test_mesh_checks_and_backend_rule():
    mesh = sharding.make_mesh(device="cpu")  # no process group: one rank
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    assert mesh.row_range(10) == (0, 10) and mesh.shard_rows(np.zeros((10, 2))).shape == (10, 2)
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_rows(x) is x and mesh.all_reduce(x) is x
    with pytest.raises(ValueError, match="launch"):
        sharding.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="divisible by 4"):
        sharding.RowMesh(4, 0, torch.device("cpu")).row_range(10)
    assert sharding.RowMesh(4, 3, torch.device("cpu")).row_range(8) == (6, 2)
    assert torch.equal(sharding.RowMesh(4, 3, torch.device("cpu")).shard_rows(
        torch.arange(8)), torch.tensor([6, 7]))
    with pytest.raises(TypeError):
        sharding.RowMesh(2, 0, torch.device("cpu")).gather_rows(torch.zeros(2, dtype=torch.int64))
    assert sharding.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert sharding.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert sharding.choose_backend(["cpu", "cpu"]) == "gloo"
    assert sharding._rank_devices(3, torch.device("cuda", 0)) == ["cuda:0"] * 3


def test_launch_and_app_shard_refuse_a_missing_card(monkeypatch):
    """No rank falls back to the CPU: asked for the card where there is
    none, the launch raises before it starts any rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.launch(_rank_work, 2, {}, {})
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline import app

    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--shard", "2", "--frames", "1"])
