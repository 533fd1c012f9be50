"""The port's alpha-tested transparency (ops/alpha.py) against the JAX
package's on the CPU: the alpha test, the restarting intersector and
tracer, the megakernel gate, and a whole frame of the alpha panel scene.

Both packages read the same baked arrays (the port's parameter carry).
JAX's CPU intersector is jnp Moller-Trumbore, the port's the plain
versions of its Baldwin-Weber kernels, so t agrees within rtol 1e-5 and
u, v within 1e-5; the triangle ids are equal but on ties and on rays
that graze an edge.  The cutout's alpha is exactly 0 or 1 and the
bilinear taps cross 0.5 at the tile edges, so one ulp of u or v can flip
a decision there: ids and decisions are held by the share that differs
(at most 1% of the lanes).  The kernel branches are held
against JAX's `force_fused=True` (Pallas in interpret mode, one restart
loop), the gather branch against JAX's CPU default (the restarting
intersector inside the restarting tracer).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.accel.traverse import make_intersector as jmake_intersector
from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.ops import alpha as jalpha
from fyp_bidirectionalpathtracer_tpu.ops import shading as jshading
from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState as JAccumState
from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState as JBMFRState
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import render_frame_fn as jrender_frame_fn
from fyp_bidirectionalpathtracer_tpu.scene.camera import camera_ray_dirs as jcamera_ray_dirs
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils import config as jconfig
from fyp_bidirectionalpathtracer_tpu_torch.accel.frame import supports_megakernel
from fyp_bidirectionalpathtracer_tpu_torch.accel.intersect import HitRecord
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import alpha_panel_scene, cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.ops import alpha
from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    BDPT_FRAME_INIT,
    GBUF_FRAME_INIT,
    Renderer,
    render_frame_fn,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
    BDPTConfig,
    GBufferConfig,
    RenderConfig,
)
from test_torch_textured import jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

W, H = 64, 48
T_MIN = 1e-3
GBUF_KEYS = ("WorldPosition", "WorldNormal", "MaterialDiffuse",
             "MaterialSpecRough", "MaterialExtraParams", "Emissive")
# rays whose answers part at edges: the cutout's tile edges (alpha
# decisions) and the open edges of the room's quads (Moller-Trumbore
# against Baldwin-Weber); the G-buffer's 1% bound
FLIP_SHARE = 1e-2


@pytest.fixture(scope="module")
def bakes():
    """(JAX bake of the alpha panel scene, the port's bake of its arrays)."""
    jb = JScene.from_built(jprocedural.alpha_panel_scene(), aspect=W / H).bake()
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


def _rays(jb):
    """(origin, direction, t_max) numpy: the camera's rays through a 64x48
    image, random rays inside the room, and shadow-like rays with finite
    t_max (20% of them empty)."""
    rs = np.random.RandomState(11)
    cam = jb.data.camera
    d_g = np.array(jcamera_ray_dirs(cam, W, H, jnp.asarray([0.5, 0.5]))).reshape(-1, 3)
    d_g /= np.linalg.norm(d_g, axis=1, keepdims=True)
    o_g = np.broadcast_to(np.asarray(cam.pos_w), d_g.shape)
    n = 1024
    o_r = rs.uniform(0.02, 0.98, (n, 3))
    d_r = rs.normal(size=(n, 3))
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    tm = np.concatenate([np.full(len(d_g), 1e30), np.where(rs.rand(n) < 0.2, 0.0,
                                                            rs.uniform(0.1, 1.5, n))])
    f32 = lambda *xs: np.ascontiguousarray(np.concatenate(xs).astype(np.float32))  # noqa: E731
    return f32(o_g, o_r), f32(d_g, d_r), f32(tm)


def _assert_hits(got, want, min_hits=500):
    """Ids equal but on ties (both hit at t within rtol 1e-5: a quad's
    diagonal) and on at most FLIP_SHARE of the lanes (a mesh's open edge,
    where the two tests part, and the cutout's tile edges); where equal, t
    within rtol 1e-5 and u, v within 1e-5; misses at t = 1e30.  Returns
    the lanes with equal hits."""
    gt, wt = got.tri.numpy(), np.asarray(want.tri)
    g_t, w_t = got.t.numpy(), np.asarray(want.t)
    differs = gt != wt
    tie = differs & (gt >= 0) & (wt >= 0) & np.isclose(g_t, w_t, rtol=1e-5, atol=1e-7)
    assert (differs & ~tie).mean() <= FLIP_SHARE, (differs & ~tie).mean()
    hit = ~differs & (gt >= 0)
    assert hit.sum() >= min_hits
    np.testing.assert_allclose(g_t[hit], w_t[hit], rtol=1e-5, atol=1e-7)
    for name in ("bary_u", "bary_v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hit],
                                   np.asarray(getattr(want, name))[hit], atol=1e-5)
    assert (g_t[gt < 0] == 1e30).all()
    return hit


def _port_hit(jhit) -> HitRecord:
    return HitRecord(*(torch.from_numpy(np.asarray(getattr(jhit, f)).copy())
                       for f in ("t", "tri", "bary_u", "bary_v")))


def test_alpha_fails_matches_jax(bakes):
    """_alpha_fails on the same hits (JAX's closest hits of the rays, with
    no restarts): the decisions agree but for tile-edge flips."""
    jb, pb = bakes
    o, d, _ = _rays(jb)
    jhit = jmake_intersector(jb.data.bvh, jb.tris, 512, materials=jb.data.materials)(
        jnp.asarray(o), jnp.asarray(d), T_MIN)
    want = np.asarray(jalpha._alpha_fails(jb.tris, jb.data.materials, jb.data.textures, jhit,
                                          jnp.asarray(o), jnp.asarray(d)))
    got = alpha._alpha_fails(pb.tris, pb.data.materials, pb.atlas, _port_hit(jhit),
                             torch.from_numpy(o), torch.from_numpy(d)).numpy()
    assert want.any() and (~want & np.asarray(jhit.tri >= 0)).any()
    assert (got != want).mean() <= FLIP_SHARE


@pytest.mark.parametrize("query", ["closest", "shadow"])
def test_wrap_intersector_matches_jax(bakes, query):
    """baked.intersector(): closest hits past failed cutouts, and shadow
    queries (closest=False with a per-lane t_max), which the restarts turn
    into closest-hit queries."""
    jb, pb = bakes
    o, d, tm = _rays(jb)
    closest = query == "closest"
    tmax = None if closest else tm
    want = jb.intersector()(jnp.asarray(o), jnp.asarray(d), T_MIN,
                            None if closest else jnp.asarray(tm), closest=closest)
    got = pb.intersector()(torch.from_numpy(o), torch.from_numpy(d), T_MIN,
                           None if tmax is None else torch.from_numpy(tmax), closest=closest)
    if closest:
        _assert_hits(got, want)
    else:
        g, w = got.hit.numpy(), np.asarray(want.hit)
        assert w.any() and (~w).any()
        assert (g != w).mean() <= FLIP_SHARE


@pytest.mark.parametrize("branch", ["kernel", "gather"])
def test_wrap_tracer_matches_jax(bakes, branch):
    """make_shaded_tracer in the restarts: the port's kernel branch (the
    shaded kernel's plain version, one restart loop) against JAX's
    force_fused=True (its Pallas shaded kernel in interpret mode); the
    port's gather branch (force_fused=False: the restarting intersector in
    the restarting tracer) against JAX's CPU default.  Every HitRecord and
    ShadingData field, where the ids agree."""
    jb, pb = bakes
    o, d, _ = _rays(jb)
    n = W * H  # the camera's rays: the Pallas kernel in interpret mode is slow
    o, d = o[:n], d[:n]
    jtrace = jshading.make_shaded_tracer(jb, force_fused=(branch == "kernel") or None)
    ptrace = make_shaded_tracer(pb, force_fused=None if branch == "kernel" else False)
    view = np.asarray(jb.data.camera.pos_w, np.float32)
    jhit, jsd = jtrace(jnp.asarray(o), jnp.asarray(d), 0.0, jnp.asarray(view),
                       cull_backface=True)
    phit, psd = ptrace(torch.from_numpy(o), torch.from_numpy(d), 0.0, torch.from_numpy(view.copy()),
                       cull_backface=True)
    hit = _assert_hits(phit, jhit)
    through = hit & (phit.t.numpy() > 1.2)
    assert through.sum() > 50  # rays that passed a cutout and hit the back wall
    for f in dataclasses.fields(psd):
        g, w = getattr(psd, f.name).numpy(), np.asarray(getattr(jsd, f.name))
        np.testing.assert_allclose(g[hit], w[hit].astype(g.dtype), rtol=0, atol=1e-5,
                                   err_msg=f.name)


# ------------------------------------------- test_alpha.py's cases, on the port
@pytest.fixture(scope="module")
def panel():
    return Scene.from_built(alpha_panel_scene()).bake(device="cpu")


def _panel_rays():
    """Rays straight at the panel's 4x4 tile centres; the checker (even
    tile sum) is opaque."""
    centers = 0.1 + (np.arange(4) + 0.5) * 0.2
    xs, ys = np.meshgrid(centers, centers, indexing="xy")
    o = np.stack([xs.reshape(-1), ys.reshape(-1), np.full(16, -0.5)], -1).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (16, 1)).astype(np.float32)
    tile_ix = ((xs - 0.1) // 0.2).astype(int).reshape(-1)
    tile_iy = ((ys - 0.1) // 0.2).astype(int).reshape(-1)
    return torch.from_numpy(o), torch.from_numpy(d), tile_ix, tile_iy


def test_bake_sets_has_alpha(panel):
    assert panel.has_alpha
    assert not Scene.from_built(cornell_box()).bake(device="cpu").has_alpha


def test_closest_hit_skips_transparent_tiles(panel):
    o, d, tix, tiy = _panel_rays()
    t = panel.intersector()(o, d, 1e-3).t.numpy()
    assert (t < 1e9).all()  # the panel or the back wall (z = 1, t = 1.5)
    through = t > 1.2
    blocked = np.abs(t - 1.0) < 0.05
    assert through.any() and blocked.any()
    assert (through != blocked).all()
    checker = (tix + tiy) % 2
    assert len({int(c) for c, th in zip(checker, through) if th}) == 1


def test_shadow_rays_respect_cutouts(panel):
    o, d, _, _ = _panel_rays()
    intersect = panel.intersector()
    occ = intersect(o, d, 1e-3, t_max=torch.full((16,), 1.2), closest=False).hit.numpy()
    through = intersect(o, d, 1e-3).t.numpy() > 1.2
    np.testing.assert_array_equal(occ, ~through)


def test_shaded_tracer_alpha(panel):
    o, d, _, _ = _panel_rays()
    hit, sd = make_shaded_tracer(panel)(o, d, 1e-3, o)
    through = hit.t.numpy() > 1.2
    assert (sd.material_id.numpy()[through] == 0).all()   # the white back wall
    assert (sd.material_id.numpy()[~through] == 1).all()  # the panel


def test_render_frame_with_alpha_scene(panel):
    """A whole frame (the wavefront: the megakernel gate declines it)."""
    cfg = RenderConfig(width=W, height=H)
    assert not supports_megakernel(panel, cfg)
    ch, _, _ = render_frame_fn(panel, panel.data.camera, AccumState.create(H, W, "cpu"),
                               BMFRState.create(H, W, "cpu"), GBUF_FRAME_INIT,
                               BDPT_FRAME_INIT, False, cfg)
    out = ch["PipelineOutput"].numpy()
    assert np.isfinite(out).all() and out[..., :3].mean() > 0.01


# ------------------------------------------------- the gate and the routing
def _env_scene():
    s = Scene.from_built(cornell_box(), aspect=1.0)
    s.env_map = np.random.RandomState(2).uniform(0, 1, (32, 64, 4)).astype(np.float32)
    return s


@pytest.mark.parametrize("make", [lambda: Scene.from_built(alpha_panel_scene(), aspect=1.0),
                                  _env_scene], ids=["alpha", "env32x64"])
def test_megakernel_gate_refuses_alpha_and_env_maps(make):
    """supports_megakernel is false for an alpha scene (K1 has no alpha
    test: the repair) and for a 32x64 env map, under 'auto' and 'on'; 'on'
    then renders the same frame as 'off', as JAX routes it."""
    baked = make().bake(device="cpu")
    frames = {}
    for mk in ("auto", "on", "off"):
        cfg = RenderConfig(width=16, height=16, bdpt=BDPTConfig(megakernel=mk))
        assert not supports_megakernel(baked, cfg)
        r = Renderer(baked, cfg)
        r.render_frame()
        frames[mk] = r.channels
    for mk in ("auto", "on"):
        for key, value in frames["off"].items():
            assert torch.equal(frames[mk][key], value), (mk, key)
    opaque = Scene.from_built(cornell_box(), aspect=1.0).bake(device="cpu")
    assert supports_megakernel(opaque, RenderConfig(width=16, height=16))


# --------------------------------------------------------- the whole frame
def render_both(jb, pb, n_frames, bkw=None, gkw=None):
    """Both packages' render_frame_fn at W x H over n_frames (JAX eager, its
    CPU wavefront), state carried: [(jax channels, port channels)] numpy."""
    bkw, gkw = bkw or {}, gkw or {}
    jcfg = jconfig.RenderConfig(width=W, height=H, bdpt=jconfig.BDPTConfig(**bkw),
                                gbuffer=jconfig.GBufferConfig(**gkw))
    pcfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(**bkw),
                        gbuffer=GBufferConfig(**gkw))
    ja, jbm = JAccumState.create(H, W), JBMFRState.create(H, W)
    pa, pbm = AccumState.create(H, W, "cpu"), BMFRState.create(H, W, "cpu")
    out = []
    for i in range(n_frames):
        jch, ja, jbm = jrender_frame_fn(jb, jb.data.camera, ja, jbm,
                                        jnp.uint32(GBUF_FRAME_INIT + i),
                                        jnp.uint32(BDPT_FRAME_INIT + i), jnp.asarray(False),
                                        jcfg)
        pch, pa, pbm = render_frame_fn(pb, pb.data.camera, pa, pbm, GBUF_FRAME_INIT + i,
                                       BDPT_FRAME_INIT + i, False, pcfg)
        out.append(({k: np.asarray(v) for k, v in jch.items()},
                    {k: v.numpy() for k, v in pch.items()}))
    assert int(pa.count) == int(ja.count) == n_frames
    return out


def assert_frames_within_bounds(frames, mad_max=5e-3, dmean_max=2e-3):
    """test_torch_wavefront.py's bounds: frame 0's G-buffer channels at most
    1% of pixels over 1e-3; frame 0's BDPT and the last Accumulated at most
    2% over 1e-3, mean |d| < mad_max, |mean radiance difference| <
    dmean_max (5e-3 and 2e-3 by default)."""
    want, got = frames[0]
    for key in GBUF_KEYS:
        frac = (np.abs(want[key] - got[key]).max(-1) > 1e-3).mean()
        assert frac <= 0.01, (key, frac)
    for (want, got), key in ((frames[0], "BDPT"), (frames[-1], "Accumulated")):
        d = np.abs(want[key] - got[key])
        frac, mad = (d.max(-1) > 1e-3).mean(), d.mean()
        dmean = abs(want[key][..., :3].mean() - got[key][..., :3].mean())
        assert frac <= 0.02 and mad < mad_max and dmean < dmean_max, (key, frac, mad, dmean)
        assert np.isfinite(got[key]).all()


def test_alpha_frame_matches_jax(bakes):
    """The alpha panel scene, 2 frames at 64x48 through both Renderers'
    frame function: the port's kernel branch in one restart loop, JAX's
    gather branch in nested ones (a flat panel needs one restart, so both
    see the same surfaces)."""
    jb, pb = bakes
    frames = render_both(jb, pb, 2)
    assert_frames_within_bounds(frames)
    miss_through = frames[0][1]["WorldPosition"][..., 2] > 0.9  # the back wall
    assert miss_through.mean() > 0.05

