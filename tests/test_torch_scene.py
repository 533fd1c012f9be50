"""The port's scene bake, triangle pack and parameter carry against the JAX
package on the CPU, the port's own copies of the JAX package's numpy-only
modules, the device defaults, plus the scope gate and what the slice
refuses;
the scenes and options earlier slices refused (normal maps, alpha-tested
materials, lat-long env maps, tone maps) bake or render and match JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.accel import bvh as jbvh
from fyp_bidirectionalpathtracer_tpu.accel.pallas_lane import pack_shaded_tris_lane
from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.ops import tonemap as jtonemap
from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState as JAccumState
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils import config as jconfig
from fyp_bidirectionalpathtracer_tpu_torch.accel import bvh
from fyp_bidirectionalpathtracer_tpu_torch.accel.frame import supports_megakernel
from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import MaterialDesc, cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat import scatter_add_rgba
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import (
    Scene,
    baked_scene_arrays,
    baked_scene_from_arrays,
)
from fyp_bidirectionalpathtracer_tpu_torch.utils import config
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig
from torch_threads import one_intra_op_thread  # noqa: F401


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


def _built(name, mod=procedural):
    """A scene from `mod`: the port's procedural module or the JAX one."""
    if name == "cornell":
        return mod.cornell_box()
    if name == "many_light":
        return mod.many_light_scene()
    b = mod.cornell_box()  # 34 + 1280 triangles: beyond one 1024-row tile
    b.meshes.append(mod.icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    return b


SCENES = ["cornell", "cornell_icosphere", "many_light"]


@pytest.fixture(scope="module", params=SCENES)
def both_bakes(request):
    aspect = 16.0 / 9.0
    return (JScene.from_built(_built(request.param, jprocedural), aspect=aspect).bake(),
            Scene.from_built(_built(request.param), aspect=aspect).bake(device="cpu"))


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
    carried = baked_scene_from_arrays(arrays, device="cpu")
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
                                 "count": np.asarray(js.count)}, device="cpu")
    np.testing.assert_array_equal(ps.last_frame.numpy(), np.asarray(js.last_frame))
    assert int(ps.count) == 3 and ps.count.dtype == torch.int32


def _textured(mod):
    """A normal-map texture on material 0."""
    b = mod.cornell_box()
    b.materials[0] = mod.MaterialDesc("tex", normal_map_image=np.ones((4, 4, 4), np.float32))
    return b


def _alpha(mod):
    """A constant alpha of 0.1 under the 0.5 threshold on material 0."""
    b = mod.cornell_box()
    b.materials[0] = mod.MaterialDesc("cutout", base_color=(0.5, 0.5, 0.5, 0.1))
    return b


def _assert_bake_equals_jax(pb, jb):
    want, got = jax_scene_arrays(jb), baked_scene_arrays(pb)
    assert set(want) == set(got)
    for key, w in want.items():
        if key.startswith("camera."):
            np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert (pb.has_alpha, pb.has_normal_maps, pb.tex_defer_ok) == (
        jb.has_alpha, jb.has_normal_maps, jb.tex_defer_ok)


@pytest.mark.parametrize("make", [_textured, _alpha], ids=["texture", "alpha"])
def test_bake_refuses_out_of_scope_scenes(make):
    """The scenes earlier slices refused (a normal map, an alpha-tested
    material) bake as JAX bakes them, flags included, and the megakernel
    gate sends them to the wavefront."""
    pb = Scene.from_built(make(procedural)).bake(device="cpu")
    _assert_bake_equals_jax(pb, JScene.from_built(make(jprocedural)).bake())
    assert pb.has_alpha or pb.has_normal_maps
    cfg = RenderConfig(width=8, height=8, bdpt=BDPTConfig(defer_textures=True))
    assert not supports_megakernel(pb, cfg)


def test_env_map_refused():
    """An 8x16 env map (refused by earlier slices) bakes as JAX bakes it, on
    the bake's device, and keeps the scene off the megakernel."""
    env = np.random.RandomState(0).uniform(0, 1, (8, 16, 4)).astype(np.float32)
    scenes = []
    for mod, cls in ((procedural, Scene), (jprocedural, JScene)):
        s = cls.from_built(mod.cornell_box())
        s.env_map = env
        scenes.append(s)
    pb = scenes[0].bake(device="cpu")
    _assert_bake_equals_jax(pb, scenes[1].bake())
    np.testing.assert_array_equal(pb.env_map.numpy(), env)
    assert not supports_megakernel(pb, RenderConfig(width=8, height=8))


def _base_textured():
    """Only base colour textured: JAX's deferred-texture megakernel takes it
    when defer_textures is on (tex_defer_ok)."""
    b = cornell_box()
    b.materials[0] = MaterialDesc("tex", base_color_image=np.ones((4, 4, 4), np.float32))
    return b


@pytest.mark.parametrize("cfg,built", [
    (RenderConfig(width=8, height=8, bdpt=BDPTConfig(defer_textures=True,
                                                     splat_mode="tiled_sortonly")),
     _base_textured),
    (RenderConfig(width=8, height=8, bdpt=BDPTConfig(splat_mode="sorted")), cornell_box),
    (RenderConfig(width=8, height=8, tone_map_operator="aces"), cornell_box),
], ids=["defer-textures", "splat-sorted", "tonemap"])
def test_pipeline_refuses_unported_options(cfg, built):
    """Options of earlier slices' refusals, now ported.  defer-textures: the
    deferred-texture megakernel runs, and its splat in the timing-attribution
    mode `tiled_sortonly` gives zeros, so the frame equals the one with the
    splat skipped bit for bit and differs from the one with splats.
    splat-sorted: the megakernel frame with the sorted splat is within
    1e-5 of the frame with the direct splat (prefix-sum rounding).  tonemap:
    the frame renders and `display` applies the ACES operator as JAX's
    `tone_map` does, within atol 1e-6."""
    baked = Scene.from_built(built(), aspect=1.0).bake(device="cpu")
    r = Renderer(baked, cfg)
    r.render_frame()
    if cfg.tone_map_operator != "clamp":
        out = r.channels["PipelineOutput"][..., :3].numpy()
        want = jtonemap.tone_map(out, jtonemap.OPERATOR_NAMES[cfg.tone_map_operator])
        np.testing.assert_allclose(r.display().numpy(), np.asarray(want), atol=1e-6)
        return

    def frame(mode):
        other = Renderer(baked, dataclasses.replace(
            cfg, bdpt=dataclasses.replace(cfg.bdpt, splat_mode=mode)))
        other.render_frame()
        return other.channels["BDPT"]

    got = r.channels["BDPT"]
    if cfg.bdpt.splat_mode == "tiled_sortonly":
        assert torch.equal(got.view(torch.int32), frame("skip").view(torch.int32))
        assert not torch.equal(got, frame("direct"))
    else:
        torch.testing.assert_close(got, frame("direct"), atol=1e-5, rtol=0)


def test_unported_splat_mode_raises():
    """Every splat mode of JAX's runs now ('sorted' within the prefix
    sums' rounding of 'direct'); a mode JAX does not have raises."""
    lin = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    rgb = torch.rand(4, 3, generator=torch.Generator().manual_seed(1))
    got = scatter_add_rgba("sorted", lin, rgb, torch.ones(4), 8)
    torch.testing.assert_close(got, scatter_add_rgba("direct", lin, rgb, torch.ones(4), 8),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="unknown splat mode"):
        scatter_add_rgba("sorted_by_depth", lin, rgb, torch.ones(4), 8)


# ------------------------------------------------ the port's own copies
def _mesh_arrays(m):
    return [np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)
            if f.name != "name"]


@pytest.mark.parametrize("fn", ["cornell_box", "icosphere", "many_light_scene"])
def test_procedural_copy_equals_jax(fn):
    """models/procedural.py: the same meshes, materials, lights and camera."""
    args = ((0.3, 0.4, 0.5), 0.25, 1) if fn == "icosphere" else ()
    want, got = getattr(jprocedural, fn)(*args), getattr(procedural, fn)(*args)
    if fn == "icosphere":
        want, got = jprocedural.BuiltScene(meshes=[want]), procedural.BuiltScene(meshes=[got])
    assert len(got.meshes) == len(want.meshes) > 0
    for gm, wm in zip(got.meshes, want.meshes):
        for g, w in zip(_mesh_arrays(gm), _mesh_arrays(wm), strict=True):
            np.testing.assert_array_equal(g, w)
    assert [dataclasses.astuple(m) for m in got.materials] == \
        [dataclasses.astuple(m) for m in want.materials]
    assert repr(got.lights) == repr(want.lights) and got.camera == want.camera


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("scene", SCENES)
def test_build_bvh_copy_equals_jax(monkeypatch, scene, impl):
    """accel/bvh.py and accel/native.py: equal node arrays and tri_order,
    through the checked-in native library and through numpy."""
    if impl == "numpy":
        monkeypatch.setattr(jbvh, "build_sah_native", lambda *a: None)
        monkeypatch.setattr(bvh, "build_sah_native", lambda *a: None)
    else:
        assert bvh.build_sah_native(np.zeros((3, 3), np.float32),
                                    np.asarray([[0, 1, 2]]), 4) is not None
    meshes = _built(scene).meshes
    pos = np.concatenate([m.positions for m in meshes]).astype(np.float32)
    offs = np.cumsum([0] + [len(m.positions) for m in meshes[:-1]])
    idx = np.concatenate([np.asarray(m.indices, np.int64) + o for m, o in zip(meshes, offs)])
    want, got = jbvh.build_bvh(pos, idx, leaf_size=4), bvh.build_bvh(pos, idx, leaf_size=4)
    assert set(got) == set(want) and len(got["tri_order"]) == len(idx)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", ["BDPTConfig", "GBufferConfig", "AccumulateConfig",
                                  "BMFRConfig", "RenderConfig"])
def test_config_copy_equals_jax(name):
    """utils/config.py: the same fields, in order, with the same defaults."""
    def spec(cls):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]
    got, want = spec(getattr(config, name)), spec(getattr(jconfig, name))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[1] for g in got] == [w[1] for w in want]
    assert getattr(config, name)() == _as_port(getattr(jconfig, name)())


def _as_port(obj):
    """A JAX config dataclass rebuilt as the port's same-named one."""
    cls = getattr(config, type(obj).__name__)
    return cls(**{f.name: (_as_port(getattr(obj, f.name))
                           if dataclasses.is_dataclass(getattr(obj, f.name))
                           else getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("entry", ["Scene.bake", "baked_scene_from_arrays",
                                   "AccumState.create", "AccumState.from_arrays",
                                   "BMFRState.create"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Called without a device on a machine without a card, each entry point
    raises; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = {"last_frame": np.zeros((2, 2, 4), np.float32), "count": np.asarray(0)}
    calls = {
        "Scene.bake": lambda: Scene.from_built(cornell_box()).bake(),
        "baked_scene_from_arrays": lambda: baked_scene_from_arrays(
            baked_scene_arrays(Scene.from_built(cornell_box()).bake(device="cpu"))),
        "AccumState.create": lambda: AccumState.create(2, 2),
        "AccumState.from_arrays": lambda: AccumState.from_arrays(arrays),
        "BMFRState.create": lambda: BMFRState.create(2, 2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
