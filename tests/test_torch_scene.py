"""The port's scene bake, triangle pack and parameter carry against the JAX
package on the CPU, plus the scope gate and what the slice refuses."""
import dataclasses

import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.accel.pallas_lane import pack_shaded_tris_lane
from fyp_bidirectionalpathtracer_tpu.models.procedural import (
    MaterialDesc,
    cornell_box,
    icosphere,
    many_light_scene,
)
from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState as JAccumState
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils.config import BDPTConfig, BMFRConfig, RenderConfig
from fyp_bidirectionalpathtracer_tpu_torch.accel.frame import supports_megakernel
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat import scatter_add_rgba
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import (
    Scene,
    baked_scene_arrays,
    baked_scene_from_arrays,
)


def jax_scene_arrays(jb) -> dict:
    """A JAX BakedScene as the flat numpy dict the port's carry takes."""
    out = {f"tris.{f.name}": np.asarray(getattr(jb.tris, f.name))
           for f in dataclasses.fields(jb.tris)}
    for group in ("geometry", "materials", "lights", "camera"):
        obj = getattr(jb.data, group)
        out.update({f"{group}.{f.name}": np.asarray(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)})
    out["env_map"] = np.asarray(jb.data.env_map)
    return out


def _built(name):
    if name == "cornell":
        return cornell_box()
    if name == "many_light":
        return many_light_scene()
    b = cornell_box()  # 34 + 1280 triangles: beyond one 1024-row tile
    b.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    return b


SCENES = ["cornell", "cornell_icosphere", "many_light"]


@pytest.fixture(scope="module", params=SCENES)
def both_bakes(request):
    aspect = 16.0 / 9.0
    return (JScene.from_built(_built(request.param), aspect=aspect).bake(),
            Scene.from_built(_built(request.param), aspect=aspect).bake())


def test_bake_equals_jax_bake(both_bakes):
    """Every baked array equal; camera fields (float32 trig and 4x4 math
    in another library) within 1e-6 relative."""
    jb, pb = both_bakes
    want, got = jax_scene_arrays(jb), baked_scene_arrays(pb)
    assert set(want) == set(got)
    for key, w in want.items():
        g = got[key]
        assert w.shape == g.shape, key
        if key.startswith("camera."):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=key)


def test_tri_pack_matches_jax(both_bakes):
    """The [T_pad, 48] pack within 1e-6 relative (float32 cross products
    and one division computed by another library)."""
    jb, pb = both_bakes
    want = np.asarray(pack_shaded_tris_lane(jb.tris, jb.data.materials))
    got = pb.tri_pack.numpy()
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scope_gate(both_bakes):
    _, pb = both_bakes
    cfg = RenderConfig(width=32, height=32)
    assert supports_megakernel(pb, cfg)
    assert not supports_megakernel(pb, cfg, max_tris=pb.n_tris - 1)
    assert not supports_megakernel(pb, cfg.with_(bdpt=BDPTConfig(max_depth=9)))


def test_parameter_carry_round_trips(both_bakes):
    jb, _ = both_bakes
    arrays = jax_scene_arrays(jb)
    carried = baked_scene_from_arrays(arrays)
    back = baked_scene_arrays(carried)
    for key, w in arrays.items():
        np.testing.assert_array_equal(back[key], w.astype(back[key].dtype), err_msg=key)
    np.testing.assert_allclose(
        carried.tri_pack.numpy(),
        np.asarray(pack_shaded_tris_lane(jb.tris, jb.data.materials)),
        rtol=1e-6, atol=1e-6)


def test_accum_state_carry():
    js = JAccumState.create(4, 5)
    js = JAccumState(last_frame=js.last_frame + 0.25, count=js.count + 3)
    ps = AccumState.from_arrays({"last_frame": np.asarray(js.last_frame),
                                 "count": np.asarray(js.count)})
    np.testing.assert_array_equal(ps.last_frame.numpy(), np.asarray(js.last_frame))
    assert int(ps.count) == 3 and ps.count.dtype == torch.int32


def _textured():
    b = cornell_box()
    b.materials[0] = MaterialDesc("tex", base_color_image=np.ones((4, 4, 4), np.float32))
    return b


def _alpha():
    b = cornell_box()
    b.materials[0] = MaterialDesc("cutout", base_color=(0.5, 0.5, 0.5, 0.1))
    return b


@pytest.mark.parametrize("make", [_textured, _alpha], ids=["texture", "alpha"])
def test_bake_refuses_out_of_scope_scenes(make):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scene.from_built(make()).bake()


def test_env_map_refused():
    s = Scene.from_built(cornell_box())
    s.env_map = np.ones((8, 16, 4), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.bake()


@pytest.mark.parametrize("cfg", [
    RenderConfig(width=8, height=8, bdpt=BDPTConfig(megakernel="off")),
    RenderConfig(width=8, height=8, bmfr=BMFRConfig(enabled=True)),
    RenderConfig(width=8, height=8, tone_map_operator="aces"),
], ids=["megakernel-off", "bmfr", "tonemap"])
def test_pipeline_refuses_unported_options(cfg):
    r = Renderer(Scene.from_built(cornell_box(), aspect=1.0).bake(), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.render_frame()
        r.display()


def test_unported_splat_mode_raises():
    lin = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scatter_add_rgba("sorted", lin, torch.zeros(4, 3), torch.ones(4), 8)
