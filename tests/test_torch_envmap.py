"""The port's lat-long environment maps (ops/envmap.py, core/vecmath.py's
lat-long helpers) against the JAX package's on the CPU: the helpers, the
nearest and bilinear lookups, the env-mapped open scene's frame, its
golden and test_envmap.py's behaviour cases that need no image I/O.

atan2 and acos differ by ulps between XLA and torch, so `(u * w)` can
land one texel over at a boundary: nearest lookups are held by share (at
most 0.1% of the directions differ, each by at most one texel index),
bilinear ones within atol 1e-5 on maps up to 64 texels wide.  The same
ulps of u move the texel coordinate u * w by w times as much, so on a
wider map the bound grows with the width: 1e-5 * w / 64 (a random map's
neighbouring texels differ by up to 1).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.core import vecmath as jvecmath
from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.ops import envmap as jenvmap
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils.image import psnr, read_png, to_u8
from fyp_bidirectionalpathtracer_tpu.utils.testing import GOLDEN_DIR
from fyp_bidirectionalpathtracer_tpu_torch.accel.frame import supports_megakernel
from fyp_bidirectionalpathtracer_tpu_torch.core import vecmath
from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
from fyp_bidirectionalpathtracer_tpu_torch.ops import envmap
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import BDPT_FRAME_INIT, Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import camera_ray_dirs
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
    BDPTConfig,
    GBufferConfig,
    RenderConfig,
)
from test_torch_alpha import H, W, assert_frames_within_bounds, render_both
from test_torch_textured import jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

SIZE = 64


def _dirs(n=4096, seed=0):
    """Unit directions: random, the six axes, and the lat-long seam
    (x = 0, z > 0) and poles."""
    rs = np.random.RandomState(seed)
    d = rs.normal(size=(n, 3))
    d[:6] = np.eye(3).repeat(2, 0) * np.tile([1, -1], 3)[:, None]
    d[6:12] = [[0, 0, 1], [1e-7, 0.3, 1], [-1e-7, 0.3, 1], [0, 1, 1e-7], [0, -1, 1e-7],
               [1e-6, 0.999999, 0]]
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_vector_helpers_match_jax():
    """ws_vector_to_latlong and reflect within atol 1e-6."""
    d = _dirs()
    n = _dirs(seed=1)
    want_u, want_v = jvecmath.ws_vector_to_latlong(jnp.asarray(d))
    got_u, got_v = vecmath.ws_vector_to_latlong(torch.from_numpy(d))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)
    want = jvecmath.reflect(jnp.asarray(d), jnp.asarray(n))
    got = vecmath.reflect(torch.from_numpy(d), torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert vecmath.M_PI == jvecmath.M_PI


def _index_map(h, w, seed=3):
    """A [h, w, 4] map whose red and green channels are the texel's x and y,
    so a lookup's value says which texel it read."""
    env = np.random.RandomState(seed).uniform(0, 1, (h, w, 4)).astype(np.float32)
    env[..., 0] = np.arange(w)[None, :]
    env[..., 1] = np.arange(h)[:, None]
    return env


@pytest.mark.parametrize("shape", [(32, 64), (512, 1024), (17, 33), (1, 1)],
                         ids=["32x64", "512x1024", "17x33", "1x1"])
def test_nearest_lookup_matches_jax(shape):
    env = _index_map(*shape)
    d = _dirs(16384)
    want = np.asarray(jenvmap.eval_env_nearest(jnp.asarray(env), jnp.asarray(d)))
    got = envmap.eval_env_nearest(torch.from_numpy(env), torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == (16384, 3)
    differs = (got != want).any(-1)
    assert differs.mean() <= 1e-3, differs.mean()
    assert (np.abs(got[differs, :2] - want[differs, :2]) <= 1.0).all()


@pytest.mark.parametrize("shape", [(32, 64), (512, 1024), (17, 33), (1, 1)],
                         ids=["32x64", "512x1024", "17x33", "1x1"])
def test_bilinear_lookup_matches_jax(shape):
    env = np.random.RandomState(4).uniform(0, 1, shape + (4,)).astype(np.float32)
    d = _dirs(16384)
    want = np.asarray(jenvmap.eval_env_bilinear(jnp.asarray(env), jnp.asarray(d)))
    got = envmap.eval_env_bilinear(torch.from_numpy(env), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, shape[1] / 64))


def test_procedural_env_matches_jax():
    want = np.asarray(jenvmap.procedural_env(res=16))
    got = envmap.procedural_env(res=16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if not torch.cuda.is_available():  # the card unless the caller names another
        with pytest.raises(RuntimeError, match="CUDA"):
            envmap.procedural_env(res=2)


# ------------------------------------------------------ the open scene
def latlong_gradient(h=32, w=64):
    """test_envmap.py's probe: hue with longitude, brightness with latitude."""
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    return np.stack([u, 1.0 - u, v, np.ones_like(u)], -1).astype(np.float32)


def open_scene(mod, scene_cls, env, aspect=1.0):
    """test_envmap.py's floor quad and point light under the sky, with
    `mod`'s procedural helpers and `scene_cls` (either package's)."""
    s = mod.BuiltScene(materials=[mod.MaterialDesc("floor", base_color=(0.7, 0.7, 0.7, 1.0))])
    s.meshes.append(mod.quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2), 0))
    s.lights = [{"type": "point", "pos": (0.0, 2.0, 0.0), "intensity": (3.0, 3.0, 3.0)}]
    s.camera = {"pos": (0.0, 0.5, -3.0), "target": (0.0, 1.2, 0.0),
                "up": (0.0, 1.0, 0.0), "focal_length": 21.0, "aspect": 1.0}
    sc = scene_cls.from_built(s, aspect=aspect)
    sc.env_map = env
    return sc


@pytest.fixture(scope="module")
def env_bakes():
    jb = open_scene(jprocedural, JScene, latlong_gradient(), aspect=W / H).bake()
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


@pytest.mark.parametrize("bilinear", [False, True], ids=["nearest", "bilinear"])
def test_env_frame_matches_jax(env_bakes, bilinear):
    """The open scene at 64x48, 2 frames, against JAX's frame function: the
    sky in MaterialDiffuse's miss pixels and the frame within
    test_torch_wavefront.py's bounds."""
    jb, pb = env_bakes
    frames = render_both(jb, pb, 2, gkw={"env_bilinear": bilinear})
    assert_frames_within_bounds(frames)
    pos = frames[0][1]["WorldPosition"]
    assert (pos[..., 3] == 0).mean() > 0.3  # the sky is visible


def test_env_bake_matches_jax():
    """The port's own bake of the open scene: the same arrays as JAX's, the
    map on the bake's device."""
    env = latlong_gradient()
    jb = open_scene(jprocedural, JScene, env).bake()
    pb = open_scene(procedural, Scene, env).bake(device="cpu")
    np.testing.assert_array_equal(pb.env_map.numpy(), np.asarray(jb.data.env_map))
    assert pb.env_map.device == pb.device
    assert not supports_megakernel(pb, RenderConfig(width=8, height=8))


# --------------------------------------------- test_envmap.py's cases
def test_env_map_routes_to_wavefront_and_shows_in_miss():
    env = latlong_gradient()
    baked = open_scene(procedural, Scene, env).bake(device="cpu")
    assert not supports_megakernel(baked, RenderConfig(width=SIZE, height=SIZE,
                                                       bdpt=BDPTConfig(megakernel="on")))
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    r.render(2)
    pos = r.channels["WorldPosition"].numpy()
    dif = r.channels["MaterialDiffuse"].numpy()
    miss = pos[..., 3] == 0
    assert miss.mean() > 0.3
    sky = dif[miss][:, :3]
    assert sky.std() > 0.05 and (sky >= 0).all() and (sky <= 1.0).all()
    # frame 1 was the last one rendered
    jit = pixel_jitter_for_frame(BDPT_FRAME_INIT + 1, "msaa8")
    dirs = vecmath.normalize(camera_ray_dirs(r.camera, SIZE, SIZE, jit))
    want = envmap.eval_env_nearest(torch.from_numpy(env), dirs).numpy()
    np.testing.assert_allclose(dif[miss][:, :3], want[miss], atol=1e-5)


def test_env_map_golden():
    """env_open_4f_64 through the port (read only), at the JAX package's
    38 dB bar."""
    baked = open_scene(procedural, Scene, latlong_gradient()).bake(device="cpu")
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    r.render(4)
    img = r.display().numpy()
    golden = read_png(os.path.join(GOLDEN_DIR, "env_open_4f_64.png"))
    value = psnr(to_u8(np.clip(img, 0.0, 1.0)).astype(np.float32) / 255.0, golden)
    assert value >= 38.0, value


def test_env_bilinear_option():
    baked = open_scene(procedural, Scene, latlong_gradient()).bake(device="cpu")
    out = {}
    for bilinear in (False, True):
        r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE,
                                         gbuffer=GBufferConfig(env_bilinear=bilinear)))
        r.render(1)
        out[bilinear] = r.channels["MaterialDiffuse"].numpy()[..., :3]
    d = np.abs(out[True] - out[False])
    assert d.max() > 1e-4 and d.mean() < 0.05
