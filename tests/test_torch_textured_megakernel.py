"""The port's deferred-texture megakernel path (K1's textured variant as
its plain version, `textured_replay`, the splat) against the JAX package on
the CPU.

The reference is JAX `accel/pallas_frame.py`: `_frame_out` and
`render_frame_megakernel` run the Pallas frame kernel in interpret mode,
`_textured_replay` is plain jnp.  Both packages read the same baked arrays
of `models/procedural.textured_room` (the port's parameter carry), seeds
and frame ids.  Bounds:
- the gate equals JAX's;
- the port's replay on JAX's own kernel rows (mapped into the port's
  `FrameOut`, so a layout slip cannot hide behind a matching kernel) equals
  JAX's replay to rtol 1e-6 / atol 1e-7 (measured: bit for bit);
- the plain textured rows equal JAX's rows with the bounds
  tests/test_torch_frame.py holds untextured rows to: G-buffer and vertex
  records <= 1% of pixels off by more than 1e-3, estimator rows <= 2%.  The
  port writes 0 in the estimator rows of lanes that trace nothing (JAX
  writes the unmasked product there, which the replay's masks and NaN guard
  drop), so est-1 rows are compared on valid lanes with NaN read as 0 and
  est-3 rows where both visibility masks are set;
- the whole frame within the same-path image bounds of test_torch_frame.py
  (2% of pixels, mean |d| 5e-3, mean radiance 2e-3);
- against the port's own wavefront, JAX's megakernel-vs-wavefront bounds of
  tests/test_frame_kernel_textured.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.accel import pallas_frame as jframe
from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.passes import gbuffer as jgbuffer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils import config as jconfig
from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    BDPT_FRAME_INIT,
    GBUF_FRAME_INIT,
    render_frame_fn,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig
from test_torch_textured import jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

W, H = 32, 24
GBUF_KEYS = ("WorldPosition", "WorldNormal", "MaterialDiffuse", "MaterialSpecRough",
             "MaterialExtraParams", "Emissive")


def _emissive_room(mod):
    """tests/test_frame_kernel_textured.py's variant: an LDR emissive
    texture on the glow material, so base colour and emissive are textured
    and the bake builds only the combined u8 table (`atlas.packed` None)."""
    built = mod.textured_room()
    glow = built.materials[3]
    glow.emissive = (1.0, 0.9, 0.7)
    glow.emissive_image = mod.checkerboard(32, (1.0, 0.9, 0.7), (0.4, 0.35, 0.2), 4)
    return built


@functools.lru_cache(maxsize=None)
def _bakes(variant="room"):
    """(JAX bake, the port's bake of JAX's arrays) at W x H."""
    built = jprocedural.textured_room() if variant == "room" else _emissive_room(jprocedural)
    jb = JScene.from_built(built, aspect=W / H).bake()
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


def _jcfg(bcfg_kw, w=W, h=H):
    return jconfig.RenderConfig(width=w, height=h,
                                bdpt=jconfig.BDPTConfig(defer_textures=True, **bcfg_kw))


def _cfg(bcfg_kw, w=W, h=H):
    return RenderConfig(width=w, height=h, bdpt=BDPTConfig(defer_textures=True, **bcfg_kw))


def _jitter():
    return jgbuffer.pixel_jitter_for_frame(jnp.uint32(BDPT_FRAME_INIT), "msaa8")


@functools.lru_cache(maxsize=None)
def _jax_rows(d):
    """JAX's textured kernel rows [R, N] (interpret mode) and its replay."""
    jb, _ = _bakes()
    cfg = _jcfg({"max_depth": d})
    out, n_sub, *_ = jframe._frame_out(jb, W, H, jnp.uint32(BDPT_FRAME_INIT), _jitter(), cfg,
                                       interpret=True, gbuf_frame=jnp.uint32(GBUF_FRAME_INIT))
    flat = np.asarray(out).reshape(out.shape[0], -1)[:, :n_sub]
    assert flat.shape[0] == jframe.out_rows(d, True, True, True) == frame_mod.out_rows(
        d, True, True, True)
    replay = jframe._textured_replay(jnp.asarray(flat), n_sub, cfg.bdpt, jb.data.textures)
    return flat, replay


def _as_frame_out(flat, d) -> frame_mod.FrameOut:
    """JAX's rows by their offsets (`_textured_replay`: gb, xt, e1_base,
    e3_base) in the port's FrameOut."""
    gb = 4 + 5 * d
    xt = gb + frame_mod.N_GBUF_ROWS
    e1 = xt + 14 * d + 1
    e3 = e1 + 6 * d
    flat = np.array(flat)
    splat = torch.from_numpy(flat[4:gb]).reshape(d, 5, -1)
    return frame_mod.FrameOut(
        res=None, gbuf=torch.from_numpy(flat[gb:xt]),
        splat_pix=splat[:, 0].to(torch.int32), splat_pay=None,
        splat_rgba=splat[:, 1:5].contiguous(), vrec=torch.from_numpy(flat[xt:e1]),
        e1_parts=torch.from_numpy(flat[e1:e3]), e3_parts=torch.from_numpy(flat[e3:]))


def _port_rows(d):
    _, pb = _bakes()
    args = frame_mod.frame_args(pb, W, H, BDPT_FRAME_INIT, pixel_jitter_for_frame(BDPT_FRAME_INIT),
                                _cfg({"max_depth": d}), gbuf_frame=GBUF_FRAME_INIT)
    assert args.textured and not args.splat_rgb8e
    return frame_mod.frame_plain(args, pb.light_rows, pb.tri_pack)


# ------------------------------------------------------------------ gate
@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("weight", ["uniform", "power", "balance"])
def test_gate_matches_jax(defer, weight):
    """supports_megakernel on textured_room over depth 1..5: only deferred
    texturing, depth <= 4 and uniform weights qualify."""
    jb, pb = _bakes()
    for d in range(1, 6):
        kw = {"max_depth": d, "connection_weight": weight, "defer_textures": defer}
        want = jframe.supports_megakernel(
            jb, jconfig.RenderConfig(width=W, height=H, bdpt=jconfig.BDPTConfig(**kw)))
        got = frame_mod.supports_megakernel(
            pb, RenderConfig(width=W, height=H, bdpt=BDPTConfig(**kw)))
        assert got == want, (d, weight, defer)
        assert got == (defer and d <= 4 and weight == "uniform")


# ---------------------------------------------------------------- replay
@pytest.mark.parametrize("d", [2, 3])
def test_replay_on_jax_rows_matches_jax(d):
    flat, (res4, splats, dif_ratio1, em3) = _jax_rows(d)
    _, pb = _bakes()
    got = frame_mod.textured_replay(_as_frame_out(flat, d), _cfg({"max_depth": d}).bdpt,
                                    pb.atlas)
    for name, g, w in (("res4", got[0], res4), ("dif_ratio1", got[2], dif_ratio1),
                       ("em3", got[3], em3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=name)
    assert len(got[1]) == len(splats) == d
    for i, ((gl, grgb, ga), (wl, wrgb, wa)) in enumerate(zip(got[1], splats)):
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl), err_msg=f"splat {i} lin")
        np.testing.assert_allclose(grgb.numpy(), np.asarray(wrgb), rtol=1e-6, atol=1e-7,
                                   err_msg=f"splat {i} rgb")
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa), err_msg=f"splat {i} alpha")
    assert float(res4[:, :3].sum()) > 0 and sum(int((np.asarray(s[2]) > 0).sum())
                                                 for s in splats) > 0


# ------------------------------------------------- K1's textured rows (plain)
def _frac_off(got, want, lanes=None):
    """Share of pixels with any row off by more than 1e-3 (NaN equal to
    NaN), among `lanes`."""
    g, w = got.numpy(), want
    off = (np.abs(g - w) > 1e-3) & ~(np.isnan(g) & np.isnan(w))
    off |= np.isnan(g) != np.isnan(w)
    per_pixel = off.any(0)
    return float(per_pixel[lanes].mean() if lanes is not None else per_pixel.mean())


@pytest.mark.parametrize("d", [2, 3])
def test_plain_textured_rows_match_jax(d):
    flat, _ = _jax_rows(d)
    want = _as_frame_out(flat, d)
    got = _port_rows(d)
    assert got.res is None and got.splat_pay is None
    for name in ("gbuf", "vrec"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        assert _frac_off(g, w.numpy()) <= 0.01, name
    assert _frac_off(got.splat_rgba.reshape(4 * d, -1),
                     want.splat_rgba.reshape(4 * d, -1).numpy()) <= 0.02
    assert (got.splat_pix == want.splat_pix).float().mean() >= 0.98
    valid = want.gbuf[3].numpy() > 0
    # est-1: valid lanes, NaN as 0 (the replay's guard makes them equal)
    e1 = torch.nan_to_num(want.e1_parts, nan=0.0).numpy()
    assert got.e1_parts.shape == want.e1_parts.shape
    assert _frac_off(torch.nan_to_num(got.e1_parts, nan=0.0), e1, valid) <= 0.02
    # est-3: masks, then the shade where both masks are set
    n_pairs = want.e3_parts.shape[0] // 4
    gm, wm = got.e3_parts.reshape(n_pairs, 4, -1), want.e3_parts.reshape(n_pairs, 4, -1)
    assert float((gm[:, 3] == wm[:, 3]).float().mean()) >= 0.98
    both = ((gm[:, 3] > 0.5) & (wm[:, 3] > 0.5))[:, None].expand(-1, 3, -1)
    shade = torch.where(both, wm[:, :3], 0.0).reshape(3 * n_pairs, -1).numpy()
    assert _frac_off(torch.where(both, gm[:, :3], 0.0).reshape(3 * n_pairs, -1), shade) <= 0.02
    assert int(both.sum()) > 0
    # the zero-vertex defaults and the emissive slot row
    rec = got.vrec[:14 * d].reshape(2 * d, 7, -1)
    dead = rec[:, 2] < 0
    assert bool(dead.any()) and bool((rec[:, 4:7][dead[:, None].expand(-1, 3, -1)] > 0).all())
    assert torch.equal(got.vrec[14 * d] < 0, want.vrec[14 * d] < 0)


# -------------------------------------------------------------- the frame
def _port_frame(pb, cfg):
    ch, _, _ = render_frame_fn(pb, pb.data.camera, AccumState.create(cfg.height, cfg.width,
                                                                     device="cpu"),
                               BMFRState.create(cfg.height, cfg.width, device="cpu"),
                               GBUF_FRAME_INIT, BDPT_FRAME_INIT, False, cfg)
    return ch


def _stats(a, b):
    d = np.abs(a - b)
    return (float((d.max(-1) > 1e-3).mean()), float(d.mean()),
            float(abs(a[..., :3].mean() - b[..., :3].mean())))


def test_frame_matches_jax():
    """render_frame_fn on the CPU (K1's plain version, the replay, the
    'direct' splat) against JAX render_frame_megakernel in interpret mode,
    depth 3; the frame is the megakernel's, not the wavefront's."""
    jb, pb = _bakes()
    jch, jimg = jframe.render_frame_megakernel(
        jb, W, H, jnp.uint32(BDPT_FRAME_INIT), _jitter(), _jcfg({"max_depth": 3}),
        interpret=True, gbuf_frame=jnp.uint32(GBUF_FRAME_INIT))
    cfg = _cfg({"max_depth": 3})
    assert frame_mod.supports_megakernel(pb, cfg)
    ch = _port_frame(pb, cfg)
    _, mk = frame_mod.render_frame_megakernel(pb, W, H, BDPT_FRAME_INIT,
                                              pixel_jitter_for_frame(BDPT_FRAME_INIT), cfg,
                                              gbuf_frame=GBUF_FRAME_INIT)
    assert torch.equal(ch["BDPT"], mk)
    frac, mad, dmean = _stats(ch["BDPT"].numpy(), np.asarray(jimg))
    assert frac <= 0.02, frac
    assert mad < 5e-3, mad
    assert dmean < 2e-3, dmean
    for key in GBUF_KEYS:
        d = np.abs(ch[key].numpy() - np.asarray(jch[key])).max(-1)
        assert (d > 1e-3).mean() <= 0.01, key


def test_frame_splat_modes_agree():
    """The textured frame's splat through K5's plain version ('tiled',
    exact float32 rows) equals the 'direct' scatter to float32
    re-association; 'tiled_bf16w' within bfloat16's 2^-8 of each update."""
    _, pb = _bakes()
    imgs = {}
    for mode in ("direct", "tiled", "tiled_bf16w"):
        cfg = _cfg({"max_depth": 3, "splat_mode": mode})
        imgs[mode] = frame_mod.render_frame_megakernel(
            pb, W, H, BDPT_FRAME_INIT, pixel_jitter_for_frame(BDPT_FRAME_INIT), cfg,
            gbuf_frame=GBUF_FRAME_INIT)[1]
    torch.testing.assert_close(imgs["tiled"], imgs["direct"], rtol=1e-6, atol=1e-6)
    assert float((imgs["tiled_bf16w"] - imgs["direct"]).abs().max()) <= 3 * 2.0 ** -8


def test_emissive_textured_replay_and_combined_fallback():
    """Base colour and emissive textured: the bake builds only the combined
    u8 table, so the replay taps the float32 atlas with four gathers.  The
    port's frame against JAX's megakernel frame (the same-path bounds and
    the Emissive channel, which carries the texture), then against the
    port's own wavefront with the JAX test's bounds (the wavefront taps the
    u8 table)."""
    jb, pb = _bakes("emissive")
    assert pb.atlas.packed is None and pb.atlas.combined is not None
    assert pb.atlas.any_base and pb.atlas.any_emissive and pb.tex_defer_ok
    jch, jimg = jframe.render_frame_megakernel(
        jb, W, H, jnp.uint32(BDPT_FRAME_INIT), _jitter(), _jcfg({"max_depth": 2}),
        interpret=True, gbuf_frame=jnp.uint32(GBUF_FRAME_INIT))
    ch = _port_frame(pb, _cfg({"max_depth": 2}))
    frac, mad, dmean = _stats(ch["BDPT"].numpy(), np.asarray(jimg))
    assert frac <= 0.02 and mad < 5e-3 and dmean < 2e-3, (frac, mad, dmean)
    em = ch["Emissive"][..., :3].numpy()
    np.testing.assert_allclose(em, np.asarray(jch["Emissive"])[..., :3], rtol=1e-5, atol=1e-6)
    # the JAX test's comparison, at its 64x48, on the port's own bake; its
    # wavefront taps the texture at every vertex (JAX's test builds the
    # tracer without `bounce_tex_mean`)
    room = Scene.from_built(_emissive_room(procedural), aspect=64 / 48).bake(device="cpu")
    mk, wf = (_port_frame(room, _cfg({"max_depth": 2, "megakernel": m,
                                      "bounce_tex_mean": False}, 64, 48))
              for m in ("auto", "off"))
    em_mk, em_wf = mk["Emissive"][..., :3].numpy(), wf["Emissive"][..., :3].numpy()
    assert em_wf.std() > 0.01
    assert (np.abs(em_mk - em_wf).max(-1) > 0.02).mean() < 0.02
    d = np.abs(mk["BDPT"].numpy() - wf["BDPT"].numpy())
    assert (d.max(-1) > 2e-2).mean() < 0.10, (d.max(-1) > 2e-2).mean()
    assert d.mean() < 0.02
    assert abs(mk["BDPT"][..., :3].mean() - wf["BDPT"][..., :3].mean()) < 5e-3


def test_uniform_texture_matches_own_wavefront():
    """A uniform texture (texel == mean): the deferred ratios are 1, so the
    megakernel frame equals the port's wavefront frame but on edge ties
    (tests/test_frame_kernel_textured.py's bounds, 64x48, depth 2)."""
    built = procedural.textured_room()
    for m in built.materials:
        if m.base_color_image is not None:
            m.base_color_image = np.full_like(np.asarray(m.base_color_image), 0.62)
    pb = Scene.from_built(built, aspect=64 / 48).bake(device="cpu")
    assert pb.tex_defer_ok
    imgs = [_port_frame(pb, _cfg({"max_depth": 2, "megakernel": mk, "bounce_tex_mean": False},
                                 64, 48))["BDPT"].numpy()
            for mk in ("auto", "off")]
    d = np.abs(imgs[0] - imgs[1]).max(-1)
    assert (d > 1e-3).mean() < 0.06, (d > 1e-3).mean()
    assert abs(imgs[0][..., :3].mean() - imgs[1][..., :3].mean()) < 2e-3
