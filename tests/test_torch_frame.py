"""The port's frame (K1's plain version, `direct` splats) against the JAX
package on the CPU.

The reference is JAX `render_frame_fn` with megakernel='on', which runs the
Pallas frame kernel in interpret mode.  It is computed once, in a module
fixture, for the default config over 3 frames; both packages read the same
baked arrays (the port's parameter carry), seeds and frame ids.

The RNG is bit-exact, so what differs is transcendental and fusion
rounding that flips closest-hit ties on triangle edges; a tie pixel may
differ arbitrarily, all others tightly.  Measured at 32x32 on the CPU:
1/1024 G-buffer pixels differ by more than 1e-3, 0.29% of BDPT pixels,
mean |diff| 1.2e-3, mean radiance 2.3e-4.  The bounds below are the port's
(1%; 2%, 5e-3, 2e-3), inside the JAX package's own megakernel-vs-wavefront
bounds (tests/test_frame_kernel.py: 8%, 0.02, 5e-3), which the variant
sweep uses against JAX's jnp wavefront path.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu.passes import bdpt as jbdpt
from fyp_bidirectionalpathtracer_tpu.passes import gbuffer as jgbuffer
from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState as JAccumState
from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState as JBMFRState
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import render_frame_fn as jrender_frame_fn
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils.config import (
    BDPTConfig,
    GBufferConfig,
    RenderConfig,
)
from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat_tile import pack_rgb8e
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    BDPT_FRAME_INIT,
    GBUF_FRAME_INIT,
    render_frame_fn,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import baked_scene_from_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

W = H = 32
N_FRAMES = 3
GBUF_KEYS = ("WorldPosition", "WorldNormal", "MaterialDiffuse",
             "MaterialSpecRough", "MaterialExtraParams", "Emissive")


def jax_scene_arrays(jb) -> dict:
    """A JAX BakedScene as the flat numpy dict the port's carry takes."""
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


def _frames(fn, baked, accum, bmfr, to_np):
    cfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(megakernel="on"))
    frames = []
    for i in range(N_FRAMES):
        ch, accum, bmfr = fn(baked, baked.data.camera, accum, bmfr,
                             GBUF_FRAME_INIT + i, BDPT_FRAME_INIT + i, False, cfg)
        frames.append({k: to_np(v) for k, v in ch.items()})
    return frames, int(accum.count)


@pytest.fixture(scope="module")
def jax_frames(jax_bake):
    """JAX render_frame_fn, megakernel='on' (interpret mode), 3 frames."""
    def fn(baked, cam, accum, bmfr, g, b, reset, cfg):
        return jrender_frame_fn(baked, cam, accum, bmfr, jnp.uint32(g),
                                jnp.uint32(b), jnp.asarray(reset), cfg)
    return _frames(fn, jax_bake, JAccumState.create(H, W),
                   JBMFRState.create(H, W), np.asarray)


@pytest.fixture(scope="module")
def port_frames(port_bake):
    return _frames(render_frame_fn, port_bake, AccumState.create(H, W, device="cpu"),
                   BMFRState.create(H, W, device="cpu"), lambda t: t.numpy())


def _image_stats(a, b):
    d = np.abs(a - b).max(-1)
    return ((d > 1e-3).mean(), np.abs(a - b).mean(),
            abs(a[..., :3].mean() - b[..., :3].mean()))


@pytest.mark.parametrize("key", GBUF_KEYS)
def test_frame0_gbuffer_matches_jax(jax_frames, port_frames, key):
    want, got = jax_frames[0][0][key], port_frames[0][0][key]
    assert got.shape == want.shape == (H, W, 4) and got.dtype == np.float32
    frac = (np.abs(want - got).max(-1) > 1e-3).mean()
    assert frac <= 0.01, (key, frac)


def test_frame0_bdpt_matches_jax(jax_frames, port_frames):
    frac, mad, dmean = _image_stats(jax_frames[0][0]["BDPT"], port_frames[0][0]["BDPT"])
    assert frac <= 0.02, frac
    assert mad < 5e-3, mad
    assert dmean < 2e-3, dmean


@pytest.mark.parametrize("key", ["Accumulated", "PipelineOutput"])
def test_accumulated_matches_jax_after_3_frames(jax_frames, port_frames, key):
    assert port_frames[1] == jax_frames[1] == N_FRAMES
    frac, mad, dmean = _image_stats(jax_frames[0][-1][key], port_frames[0][-1][key])
    assert frac <= 0.02, frac
    assert mad < 5e-3, mad
    assert dmean < 2e-3, dmean


def _args(port_bake, cfg, splat_rgb8e):
    return frame_mod.frame_args(
        port_bake, W, H, BDPT_FRAME_INIT, pixel_jitter_for_frame(BDPT_FRAME_INIT),
        cfg, gbuf_frame=GBUF_FRAME_INIT, splat_rgb8e=splat_rgb8e)


def test_in_frame_rgb8e_payload_is_pack_of_unpacked_rows(port_bake):
    """splat_mode='tiled_rgb8e': the frame's payload ints are pack_rgb8e of
    its own unpacked splat rows (pack_rgb8e is bit-equal to JAX's,
    tests/test_torch_splat.py), and the splat targets are the same."""
    cfg = RenderConfig(width=W, height=H)
    unpacked = frame_mod.frame_plain(_args(port_bake, cfg, False),
                                     port_bake.light_rows, port_bake.tri_pack)
    packed = frame_mod.frame_plain(_args(port_bake, cfg, True),
                                   port_bake.light_rows, port_bake.tri_pack)
    torch.testing.assert_close(packed.splat_pix, unpacked.splat_pix, rtol=0, atol=0)
    rgba = unpacked.splat_rgba
    want = pack_rgb8e(rgba[:, 0], rgba[:, 1], rgba[:, 2])
    assert torch.equal(packed.splat_pay, want)
    assert int((rgba[:, 3] > 0).sum()) > 0
    assert torch.equal(packed.res, unpacked.res) and torch.equal(packed.gbuf, unpacked.gbuf)


def test_rgb8e_frame_within_envelope_of_direct(port_bake):
    """The whole CPU frame with the rgb8e splat chain (K2, sort, K3 plain
    versions) against 'direct': splat sums differ by at most 2^-8 of each
    update's largest channel, <= 2^-8 * 0.9 * 3 updates per pixel."""
    imgs = {}
    for mode in ("direct", "tiled_rgb8e"):
        cfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(splat_mode=mode))
        _, imgs[mode] = frame_mod.render_frame_megakernel(
            port_bake, W, H, BDPT_FRAME_INIT, pixel_jitter_for_frame(BDPT_FRAME_INIT),
            cfg, gbuf_frame=GBUF_FRAME_INIT)
    diff = (imgs["direct"] - imgs["tiled_rgb8e"]).abs()
    assert float(diff.max()) <= 3 * 0.9 * 2.0 ** -8 + 1e-6


VARIANTS = [
    (BDPTConfig(enable_light_tracing=False, enable_connections=False), GBufferConfig()),
    (BDPTConfig(enable_connections=False), GBufferConfig()),
    (BDPTConfig(enable_light_tracing=False), GBufferConfig()),
    (BDPTConfig(max_depth=2), GBufferConfig()),
    (BDPTConfig(mat_model=1), GBufferConfig()),
    (BDPTConfig(faithful_rng=True), GBufferConfig()),
    (BDPTConfig(reference_quirks=False), GBufferConfig()),
    (BDPTConfig(connection_weight="power"), GBufferConfig()),
    (BDPTConfig(connection_weight="balance", reference_quirks=False), GBufferConfig()),
    (BDPTConfig(), GBufferConfig(use_thin_lens=True, f_stop=8.0, focal_length_gui=1.5)),
]
VARIANT_IDS = ["e1-only", "no-e3", "no-e2", "depth2", "lambertian", "faithful-rng",
               "no-quirks", "power-mis", "balance-mis", "thin-lens"]


@pytest.mark.parametrize("bcfg,gcfg", VARIANTS, ids=VARIANT_IDS)
def test_variants_match_jax_wavefront(jax_bake, port_bake, bcfg, gcfg):
    """Each output-affecting flag against JAX's jnp wavefront path
    (gbuffer.ray_traced_gbuffer + bdpt.bdpt_pass), with the JAX package's
    own megakernel-vs-wavefront bounds (8% of pixels, mean 0.02, mean
    radiance 5e-3)."""
    frame, gframe = BDPT_FRAME_INIT, GBUF_FRAME_INIT
    jit = jgbuffer.pixel_jitter_for_frame(jnp.uint32(frame), "msaa8")
    trace = make_shaded_tracer(jax_bake)
    lens_radius = gcfg.focal_length_gui / (2.0 * gcfg.f_stop)
    ch = jgbuffer.ray_traced_gbuffer(
        jax_bake, trace, W, H, jnp.uint32(gframe), jit,
        use_thin_lens=gcfg.use_thin_lens, lens_radius=lens_radius,
        focal_len=gcfg.focal_length_gui)
    want = np.asarray(jbdpt.bdpt_pass(jax_bake, jax_bake.intersector(), ch,
                                      jnp.uint32(frame), jit, bcfg, trace=trace))
    cfg = RenderConfig(width=W, height=H, bdpt=bcfg, gbuffer=gcfg)
    pch, got = frame_mod.render_frame_megakernel(
        port_bake, W, H, frame, pixel_jitter_for_frame(frame), cfg, gbuf_frame=gframe)
    frac, mad, dmean = _image_stats(want, got.numpy())
    assert frac < 0.08, frac
    assert mad < 0.02, mad
    assert dmean < 5e-3, dmean
    for key in ("WorldPosition", "WorldNormal"):
        d = np.abs(np.asarray(ch[key]) - pch[key].numpy()).max(-1)
        assert (d > 1e-3).mean() < 0.02, (key, (d > 1e-3).mean())
