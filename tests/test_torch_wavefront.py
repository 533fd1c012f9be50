"""The port's per-bounce wavefront path (megakernel='off') against the JAX
package's on the CPU: its modules one by one, the whole frame, and the
goldens.

JAX's wavefront on the CPU traces with jnp Moller-Trumbore and decodes with
prepare_shading_data; the port's runs the plain versions of its K4 kernels
(Baldwin-Weber, the shaded kernel's field decode).  Both read the same baked
arrays (the port's parameter carry), seeds and frame ids.  What differs is
float rounding that flips edge ties, so the frame bounds are statistical:
PR 1's same-path bounds, G-buffer channels at most 1% of pixels over 1e-3,
the BDPT frame at most 2% of pixels over 1e-3, mean |d| < 5e-3, mean
radiance difference < 2e-3.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.core import rng as jrng
from fyp_bidirectionalpathtracer_tpu.core import samplers as jsamplers
from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu.ops import materials as jmat
from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState as JAccumState
from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState as JBMFRState
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import render_frame_fn as jrender_frame_fn
from fyp_bidirectionalpathtracer_tpu.scene import camera as jcamera
from fyp_bidirectionalpathtracer_tpu.scene.lights import eval_light as jeval_light
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils import config as jconfig
from fyp_bidirectionalpathtracer_tpu.utils.image import psnr, read_png, to_u8
from fyp_bidirectionalpathtracer_tpu.utils.testing import GOLDEN_DIR
from fyp_bidirectionalpathtracer_tpu_torch.core import samplers
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box as pcornell_box
from fyp_bidirectionalpathtracer_tpu_torch.ops import materials as mat
from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import (
    pixel_jitter_for_frame,
    ray_traced_gbuffer,
)
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    BDPT_FRAME_INIT,
    GBUF_FRAME_INIT,
    Renderer,
    render_frame_fn,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene import camera
from fyp_bidirectionalpathtracer_tpu_torch.scene.lights import eval_light
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
    BDPTConfig,
    GBufferConfig,
    RenderConfig,
)
from torch_threads import one_intra_op_thread  # noqa: F401

W = H = 32
GBUF_KEYS = ("WorldPosition", "WorldNormal", "MaterialDiffuse",
             "MaterialSpecRough", "MaterialExtraParams", "Emissive")


def jax_scene_arrays(jb) -> dict:
    out = {f"tris.{f.name}": np.asarray(getattr(jb.tris, f.name))
           for f in dataclasses.fields(jb.tris)}
    for group in ("geometry", "bvh", "materials", "lights", "camera"):
        obj = getattr(jb.data, group)
        out.update({f"{group}.{f.name}": np.asarray(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)})
    atlas = jb.data.textures
    out.update({f"textures.{k}": np.asarray(getattr(atlas, k))
                for k in ("data", "sizes", "packed", "combined") if getattr(atlas, k) is not None})
    out["env_map"] = np.asarray(jb.data.env_map)
    return out


@pytest.fixture(scope="module")
def jax_bake():
    return JScene.from_built(cornell_box(), aspect=W / H).bake()


@pytest.fixture(scope="module")
def port_bake(jax_bake):
    return baked_scene_from_arrays(jax_scene_arrays(jax_bake), device="cpu")


# ------------------------------------------------------------- modules
def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _seeds():
    js = jrng.pixel_seeds(16, 16, jnp.uint32(0x1337)).reshape(-1)
    return js, torch.from_numpy(np.asarray(js).astype(np.int64))


def _close(got, want, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol,
                               equal_nan=True)


def test_samplers_match_jax():
    """cos_hemisphere_sample, ggx_microfacet_sample, unit_sphere_sample and
    lens_sample: seeds bit-equal, samples within 1e-6."""
    rs = np.random.RandomState(1)
    n = _unit(rs, 256)
    rough = rs.uniform(0.01, 1.0, 256).astype(np.float32)
    js, ts = _seeds()
    for jfn, tfn, args in (
        (jsamplers.cos_hemisphere_sample, samplers.cos_hemisphere_sample, (n,)),
        (jsamplers.ggx_microfacet_sample, samplers.ggx_microfacet_sample, (rough, n)),
        (jsamplers.unit_sphere_sample, samplers.unit_sphere_sample, ()),
        (jsamplers.lens_sample, samplers.lens_sample, (0.25,)),
    ):
        want = jfn(js, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
        got = tfn(ts, *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
        for g, w in zip(got[1:], want[1:]):
            _close(g, w)


def test_camera_rays_and_projection_match_jax(jax_bake, port_bake):
    jit = np.asarray([0.3125, 0.6875], np.float32)
    want = np.asarray(jcamera.camera_ray_dirs(jax_bake.data.camera, 24, 16, jnp.asarray(jit)))
    got = camera.camera_ray_dirs(port_bake.data.camera, 24, 16, torch.from_numpy(jit))
    _close(got, want)
    d = _unit(np.random.RandomState(2), 4096)
    d[:, 2] = -np.abs(d[:, 2])  # mostly in front of the camera
    wx, wy = jcamera.project_dir_to_pixel(jax_bake.data.camera, jnp.asarray(d), (W, H),
                                          jnp.asarray(jit))
    gx, gy = camera.project_dir_to_pixel(port_bake.data.camera, torch.from_numpy(d), (W, H),
                                         torch.from_numpy(jit))
    assert gx.dtype == torch.int32
    inside = (np.abs(np.asarray(wx)) < 1e6) & (np.abs(np.asarray(wy)) < 1e6)
    # round() of float32 pixel centres: equal but for ulp flips at .5
    assert (gx.numpy()[inside] == np.asarray(wx)[inside]).mean() > 0.999
    assert (gy.numpy()[inside] == np.asarray(wy)[inside]).mean() > 0.999


LIGHTS = [
    {"type": "point", "pos": (0.5, 0.9, 0.5), "intensity": (2.0, 1.5, 1.0)},
    {"type": "point", "pos": (0.2, 0.8, 0.3), "dir": (0.1, -1.0, 0.2),
     "intensity": (1.0, 1.0, 3.0), "opening_angle": 0.6, "penumbra_angle": 0.2},
    {"type": "dir", "pos": (0.5, 2.0, 0.5), "dir": (0.13, -0.9, 0.27),
     "intensity": (0.9, 0.8, 0.7)},
]


def test_eval_light_matches_jax():
    """A point light, a spot light with a penumbra and a directional light,
    from the light rows (the JAX function's packed table)."""
    from fyp_bidirectionalpathtracer_tpu.scene.lights import make_light_array as jmake
    from fyp_bidirectionalpathtracer_tpu_torch.scene.lights import light_rows, make_light_array

    rs = np.random.RandomState(3)
    pos = rs.uniform(0.0, 1.0, (512, 3)).astype(np.float32)
    idx = rs.randint(0, len(LIGHTS), 512).astype(np.int32)
    want = jeval_light(jmake(LIGHTS), jnp.asarray(idx), jnp.asarray(pos))
    got = eval_light(light_rows(make_light_array(LIGHTS)), torch.from_numpy(idx),
                     torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5, rtol=1e-5)
    assert 0 < float((got[1] == 0).all(-1).float().mean()) < 1  # the spot's cone cuts


@pytest.mark.parametrize("mat_model", [0, 1], ids=["ggx", "lambertian"])
def test_materials_match_jax(mat_model):
    """sample_brdf, eval_brdf, eval_pdf and nee_shade on the same inputs."""
    rs = np.random.RandomState(4 + mat_model)
    m = 256
    n = _unit(rs, m)
    v = _unit(rs, m)
    v = np.where((v * n).sum(-1, keepdims=True) < 0, -v, v)
    l = _unit(rs, m)
    dif = rs.uniform(0, 1, (m, 3)).astype(np.float32)
    spec = rs.uniform(0, 1, (m, 3)).astype(np.float32)
    rough = rs.uniform(0.05, 0.9, m).astype(np.float32)
    is_spec = rs.rand(m) < 0.5
    inten = rs.uniform(0, 5, (m, 3)).astype(np.float32)
    vis = rs.rand(m) < 0.7
    js, ts = _seeds()
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want = jmat.sample_brdf(js, J(n), J(n), J(v), J(dif), J(spec), J(rough), mat_model)
    got = mat.sample_brdf(ts, T(n), T(n), T(v), T(dif), T(spec), T(rough), mat_model)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, atol=1e-5, rtol=1e-5)
    for name in ("eval_brdf", "eval_pdf"):
        w = getattr(jmat, name)(J(v), J(l), J(n), J(n), J(dif), J(spec), J(rough),
                                J(is_spec), mat_model)
        g = getattr(mat, name)(T(v), T(l), T(n), T(n), T(dif), T(spec), T(rough),
                               T(is_spec), mat_model)
        _close(g, w, atol=1e-5, rtol=1e-5)
    w = jmat.nee_shade(J(vis), J(l), J(inten), J(n), J(v), J(dif), J(spec), J(rough),
                       jnp.int32(3), mat_model)
    g = mat.nee_shade(T(vis), T(l), T(inten), T(n), T(v), T(dif), T(spec), T(rough), 3,
                      mat_model)
    _close(g, w, atol=1e-5, rtol=1e-5)


def test_fused_and_unfused_tracers_agree(port_bake):
    """make_shaded_tracer's shaded-kernel branch and its closest-hit +
    prepare_shading_data branch give the same G-buffer."""
    jit = pixel_jitter_for_frame(BDPT_FRAME_INIT)
    chans = [ray_traced_gbuffer(port_bake, make_shaded_tracer(port_bake, force_fused=f),
                                W, H, GBUF_FRAME_INIT, jit) for f in (None, False)]
    for key in GBUF_KEYS:
        np.testing.assert_allclose(chans[0][key].numpy(), chans[1][key].numpy(), atol=1e-6)


# ------------------------------------------------------- the whole frame
def _cfgs(bkw, gkw):
    return (jconfig.RenderConfig(width=W, height=H,
                                 bdpt=jconfig.BDPTConfig(megakernel="off", **bkw),
                                 gbuffer=jconfig.GBufferConfig(**gkw)),
            RenderConfig(width=W, height=H, bdpt=BDPTConfig(megakernel="off", **bkw),
                         gbuffer=GBufferConfig(**gkw)))


def _render(jax_bake, port_bake, bkw, gkw, n_frames):
    """Both packages' render_frame_fn over n_frames, state carried; returns
    the channel dicts (numpy) of both, frame by frame."""
    jcfg, pcfg = _cfgs(bkw, gkw)
    ja, jb = JAccumState.create(H, W), JBMFRState.create(H, W)
    pa, pb = AccumState.create(H, W, device="cpu"), BMFRState.create(H, W, device="cpu")
    out = []
    for i in range(n_frames):
        jch, ja, jb = jrender_frame_fn(jax_bake, jax_bake.data.camera, ja, jb,
                                       jnp.uint32(GBUF_FRAME_INIT + i),
                                       jnp.uint32(BDPT_FRAME_INIT + i), jnp.asarray(False),
                                       jcfg)
        pch, pa, pb = render_frame_fn(port_bake, port_bake.data.camera, pa, pb,
                                      GBUF_FRAME_INIT + i, BDPT_FRAME_INIT + i, False, pcfg)
        out.append(({k: np.asarray(v) for k, v in jch.items()},
                    {k: v.numpy() for k, v in pch.items()}))
    assert int(pa.count) == int(ja.count) == n_frames
    return out


def _assert_image_bounds(want, got):
    d = np.abs(want - got)
    frac = (d.max(-1) > 1e-3).mean()
    mad, dmean = d.mean(), abs(want[..., :3].mean() - got[..., :3].mean())
    assert frac <= 0.02 and mad < 5e-3 and dmean < 2e-3, (frac, mad, dmean)


def _assert_frame0(want, got):
    for key in GBUF_KEYS:
        assert got[key].shape == (H, W, 4) and got[key].dtype == np.float32
        frac = (np.abs(want[key] - got[key]).max(-1) > 1e-3).mean()
        assert frac <= 0.01, (key, frac)
    _assert_image_bounds(want["BDPT"], got["BDPT"])


def test_default_frame_matches_jax_over_3_frames(jax_bake, port_bake):
    """Frame 0 (G-buffer and BDPT), then Accumulated and PipelineOutput
    after 3 frames."""
    frames = _render(jax_bake, port_bake, {}, {}, 3)
    _assert_frame0(*frames[0])
    for key in ("Accumulated", "PipelineOutput"):
        _assert_image_bounds(frames[-1][0][key], frames[-1][1][key])


VARIANTS = {
    "depth1": ({"max_depth": 1}, {}),
    "depth5": ({"max_depth": 5}, {}),
    "lambertian": ({"mat_model": 1}, {}),
    "faithful-rng": ({"faithful_rng": True}, {}),
    "no-quirks": ({"reference_quirks": False}, {}),
    "power-mis": ({"connection_weight": "power"}, {}),
    "balance-mis": ({"connection_weight": "balance"}, {}),
    "parallel-subpaths": ({"parallel_subpaths": True}, {}),
    "no-e1": ({"enable_path_tracing": False}, {}),
    "no-e2": ({"enable_light_tracing": False}, {}),
    "no-e3": ({"enable_connections": False}, {}),
    "thin-lens": ({}, {"use_thin_lens": True, "f_stop": 8.0, "focal_length_gui": 1.5}),
    # JAX's frame options: grazing hits may flip under the reversed shadow
    # rays; the stubs break both images the same way; the merged batch and
    # the segmented tiled splat change no bit (test below).  The extension
    # stub is held with the shadow stub: alone, its repeated vertices send
    # grazing rays along Cornell's walls, where the packages' ray tests
    # answer apart (test_stub_extensions_visibility_differs_on_grazing_rays)
    "reverse-shadows": ({"reverse_shadows": True}, {}),
    "merge-shadows": ({"merge_shadow_batches": True}, {}),
    "stub-shadows": ({"debug_stub_shadows": True}, {}),
    "stub-extensions": ({"debug_stub_extensions": True, "debug_stub_shadows": True}, {}),
    "splat-segments": ({"splat_mode": "tiled", "splat_segments": True}, {}),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_frame_matches_jax(jax_bake, port_bake, variant):
    _assert_frame0(*_render(jax_bake, port_bake, *VARIANTS[variant], 1)[0])


def test_frame_options_bit_equal_to_their_plain_counterparts():
    """The frame options that reorder work change no bit of the port's
    frame: on pink_room with 2 subdivisions (2,866 triangles, the BVH tier)
    the sorted batches (the defaults) against sort_bounces and sort_shadows
    off, and the merged shadow batch against the three batches; on Cornell
    the tiled splat with one sorted run a depth against the flat sort.  The
    timing stubs do change it (they are meant to)."""
    from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room

    room = Scene.from_built(pink_room(asset_dir="", subdivisions=2), aspect=1.6).bake(device="cpu")
    assert room.n_tris > 2048

    def frame(baked, w, h, **kw):
        r = Renderer(baked, RenderConfig(width=w, height=h, bdpt=BDPTConfig(**kw)))
        r.render_frame()
        return {k: v.contiguous().view(torch.int32) for k, v in r.channels.items()}

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    base = frame(room, 16, 10)
    assert same(base, frame(room, 16, 10, sort_bounces=False, sort_shadows=False))
    assert same(base, frame(room, 16, 10, merge_shadow_batches=True))
    assert not same(base, frame(room, 16, 10, debug_stub_shadows=True))
    flat = frame(port_cornell(), W, H, megakernel="off", splat_mode="tiled")
    assert same(flat, frame(port_cornell(), W, H, megakernel="off", splat_mode="tiled",
                            splat_segments=True))


def test_stub_extensions_visibility_differs_on_grazing_rays(jax_bake, port_bake):
    """Under debug_stub_extensions alone every camera vertex is the primary
    hit and every light vertex the light's sample point, so the shadow
    batches repeat rays that run along Cornell's axis-aligned walls (a
    direction component under 1e-6).  There JAX's Moller-Trumbore test and
    the port's Baldwin-Weber test may answer apart, as on any grazing ray
    (PARITY.md); the frame then differs from JAX's beyond the bounds above
    (measured: 1.7% of pixels over 1e-3, mean |d| 7.6e-3, where the bound
    is 5e-3).  Here each batch the port's pass traces, replayed through
    JAX's jnp intersector: every answer agrees but on such grazing rays,
    and those are fewer than 2% of the live rays."""
    from fyp_bidirectionalpathtracer_tpu.accel.traverse import intersect_brute

    from fyp_bidirectionalpathtracer_tpu_torch.passes.bdpt import bdpt_pass

    traced = []
    intersect = port_bake.intersector()

    def recording(o, d, tmin, tmax=None, **kw):
        hit = intersect(o, d, tmin, tmax, **kw)
        traced.append((o, d, tmin, tmax, hit.hit))
        return hit

    jit = pixel_jitter_for_frame(BDPT_FRAME_INIT)
    ch = ray_traced_gbuffer(port_bake, make_shaded_tracer(port_bake), W, H, GBUF_FRAME_INIT,
                            jit)
    bdpt_pass(port_bake, recording, ch, BDPT_FRAME_INIT, jit,
              BDPTConfig(megakernel="off", debug_stub_extensions=True))
    assert len(traced) == 3
    apart = 0
    for o, d, tmin, tmax, hit in traced:
        want = intersect_brute(jax_bake.tris, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                               tmin, jnp.asarray(tmax.numpy()), closest=False)
        diff = (np.asarray(want.tri) >= 0) != hit.numpy()
        grazing = d.abs().min(-1).values.numpy() < 1e-6
        assert not (diff & ~grazing).any()
        apart += int(diff.sum())
        assert diff.sum() <= 0.02 * int((tmax > tmin).sum())
    assert apart > 0


def port_cornell():
    return Scene.from_built(pcornell_box(), aspect=W / H).bake(device="cpu")


# ------------------------------------------------------------- goldens
GOLDENS = {
    "cornell_bdpt_8f_64": ({}, 8),
    "cornell_depth1_4f_64": ({"max_depth": 1}, 4),
    "cornell_lambertian_4f_64": ({"mat_model": 1}, 4),
    "cornell_faithful_rng_4f_64": ({"faithful_rng": True}, 4),
}


@pytest.fixture(scope="module")
def golden_bake():
    return Scene.from_built(pcornell_box(), aspect=1.0).bake(device="cpu")


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_through_the_wavefront(golden_bake, name):
    """64x64 through megakernel='off' against the checked-in PNG (read
    only), at the JAX package's 38 dB bar."""
    bkw, n_frames = GOLDENS[name]
    r = Renderer(golden_bake, RenderConfig(width=64, height=64,
                                           bdpt=BDPTConfig(megakernel="off", **bkw)))
    r.render(n_frames)
    img = r.display().numpy()
    assert np.isfinite(img).all()
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    value = psnr(to_u8(np.clip(img, 0.0, 1.0)).astype(np.float32) / 255.0, golden)
    assert value >= 38.0, value
