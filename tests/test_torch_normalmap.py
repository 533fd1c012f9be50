"""The port's tangent-space normal maps (ops/shading.apply_normal_mapping,
the G-buffer's primary hits) against the JAX package's on the CPU: the
bake of a normal-mapped scene, the tangent pack, the perturbation on the
same hits with test_passes.py's flat and tilted maps (atol 1e-5), a whole
frame of the normal-mapped Cornell box, and test_passes.py's two
normal-map cases on the port.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.ops import shading as jshading
from fyp_bidirectionalpathtracer_tpu.scene.camera import camera_ray_dirs as jcamera_ray_dirs
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu_torch.accel.frame import supports_megakernel
from fyp_bidirectionalpathtracer_tpu_torch.accel.intersect import HitRecord
from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
from fyp_bidirectionalpathtracer_tpu_torch.ops import shading
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import ray_traced_gbuffer
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import (
    Scene,
    baked_scene_arrays,
    baked_scene_from_arrays,
)
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig
from test_torch_alpha import H, W, assert_frames_within_bounds, render_both
from test_torch_textured import jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401


def _map(kind):
    """test_passes.py's 8x8 tangent-space maps: flat (0.5, 0.5, 1) or
    leaning toward +tangent (0.75, 0.5, 1)."""
    img = np.zeros((8, 8, 4), np.float32)
    img[..., 0] = 0.75 if kind == "tilt" else 0.5
    img[..., 1] = 0.5
    img[..., 2:] = 1.0
    return img


def _mapped(mod, kind):
    built = mod.cornell_box()
    built.materials[0].normal_map_image = _map(kind)
    return built


def _bakes(kind):
    jb = JScene.from_built(_mapped(jprocedural, kind), aspect=W / H).bake()
    return kind, jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


@pytest.fixture(scope="module", params=["flat", "tilt"])
def bakes(request):
    return _bakes(request.param)


def test_normal_mapped_bake_matches_jax(bakes):
    """The port's own bake: the same arrays as JAX's (the map in the atlas
    and its per-texture packed table, the slot in normal_tex), the same
    flags; no deferred-texture megakernel for it."""
    kind, jb, _ = bakes
    pb = Scene.from_built(_mapped(procedural, kind), aspect=W / H).bake(device="cpu")
    want, got = jax_scene_arrays(jb), baked_scene_arrays(pb)
    assert set(want) == set(got) and "textures.packed" in got
    for key, w in want.items():
        if key.startswith("camera."):
            np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert pb.has_normal_maps == jb.has_normal_maps is True
    assert pb.tex_defer_ok == jb.tex_defer_ok is False
    assert not pb.has_alpha
    cfg = RenderConfig(width=8, height=8, bdpt=BDPTConfig(defer_textures=True))
    assert not supports_megakernel(pb, cfg)


def test_tangent_pack_matches_jax(bakes):
    _, jb, pb = bakes
    want = np.asarray(jshading._tangent_pack(jb.tris))
    got = shading._tangent_pack(pb.tris).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[:, 3] != 0).any()


def test_apply_normal_mapping_matches_jax(bakes):
    """On JAX's primary hits and ShadingData at 64x48: atol 1e-5; the flat
    map leaves the normals as they are."""
    kind, jb, pb = bakes
    cam = jb.data.camera
    d = jcamera_ray_dirs(cam, W, H, jnp.asarray([0.5, 0.5]))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam.pos_w, d.shape)
    jhit, jsd = jshading.make_shaded_tracer(jb)(o, d, 0.0, o, cull_backface=True)
    want = jshading.apply_normal_mapping(jb, jhit, jsd)
    hit = HitRecord(*(torch.from_numpy(np.asarray(getattr(jhit, f)).copy())
                      for f in ("t", "tri", "bary_u", "bary_v")))
    sd = shading.ShadingData(**{f.name: torch.from_numpy(np.asarray(getattr(jsd, f.name)).copy())
                                for f in dataclasses.fields(shading.ShadingData)})
    got = shading.apply_normal_mapping(pb, hit, sd)
    valid = np.asarray(jhit.tri) >= 0
    for name in ("n", "n_dot_v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[valid],
                                   np.asarray(getattr(want, name))[valid], atol=1e-5,
                                   err_msg=name)
    moved = np.abs(got.n.numpy() - sd.n.numpy()).max(-1)[valid]
    if kind == "flat":
        assert moved.max() <= 1e-5
    else:
        assert moved.max() > 0.1


@pytest.mark.parametrize("kind", ["flat", "tilt"])
def test_normal_mapped_frame_matches_jax(kind):
    """The normal-mapped Cornell box, 2 frames at 64x48, against JAX's frame
    function.  The flat map (the normal-map path on, the normals as they
    are) within the same-path bounds.  The tilted map within 2% of pixels
    over 1e-3 and mean |d|, mean radiance difference < 1e-2: its shading
    normals send many first bounces and shadow rays below the geometric
    surface, where Moller-Trumbore (JAX's CPU path) and Baldwin-Weber (the
    port's, and JAX's Pallas kernel's) part on grazing hits, and the
    fireflies there move the means.  JAX's two intersectors alone put
    frames 0-2 of this scene 14-19 pixels, mean |d| 2.0e-3-3.3e-3 and mean
    radiance 2.2e-3-3.7e-3 apart (bdpt_pass with force_fused=True against
    its default); the port is 30-35 pixels, 4.6e-3-6.6e-3 and
    3.8e-3-7.0e-3 from JAX's default."""
    _, jb, pb = _bakes(kind)
    frames = render_both(jb, pb, 2)
    if kind == "flat":
        assert_frames_within_bounds(frames)
    else:
        assert_frames_within_bounds(frames, mad_max=1e-2, dmean_max=1e-2)


# ------------------------------------------- test_passes.py's two cases
def _gbuffer_normals(built, size=32):
    bk = Scene.from_built(built, aspect=1.0).bake(device="cpu")
    ch = ray_traced_gbuffer(bk, shading.make_shaded_tracer(bk), size, size, 0,
                            torch.tensor([0.5, 0.5]))
    return ch["WorldNormal"].numpy()[..., :3], ch["WorldPosition"].numpy()[..., 3] != 0, bk


def test_normal_mapping_flat_map_is_identity():
    n_ref, valid, bk0 = _gbuffer_normals(procedural.cornell_box())
    assert not bk0.has_normal_maps
    n_flat, _, bk1 = _gbuffer_normals(_mapped(procedural, "flat"))
    assert bk1.has_normal_maps
    np.testing.assert_allclose(n_flat[valid], n_ref[valid], atol=1e-5)


def test_normal_mapping_perturbs_and_stays_unit():
    n_tilt, valid, _ = _gbuffer_normals(_mapped(procedural, "tilt"))
    n_ref, _, _ = _gbuffer_normals(procedural.cornell_box())
    np.testing.assert_allclose(np.linalg.norm(n_tilt[valid], axis=-1), 1.0, atol=1e-4)
    assert np.abs(n_tilt[valid] - n_ref[valid]).max() > 0.1
