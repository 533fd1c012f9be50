"""Textured scenes and pink_room on the port's wavefront against the JAX
package on the CPU: the copy of models/pink_room.py (with procedural
textures, and with a folder of PNG and JPEG maps under JAX's names, which
the port decodes without PIL), the textured bake, the
texture taps, the shaded tracer's BVH branch with textures, a pink_room
frame, and the pink_room golden.

Bounds: the bake and the texel tables equal array for array; taps within
1e-6 (integers equal); the tracer's hits within the K4 bounds of
test_torch_cluster.py and its shading within their field bound, 2e-4 (the
JAX cluster kernel computes t, u and v in another order; measured 1.2e-4
at most, on emissive texels); the frame within
test_torch_wavefront.py's image bounds; the golden at the JAX package's
38 dB.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.models import pink_room as jpink
from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.ops import alpha as jalpha
from fyp_bidirectionalpathtracer_tpu.ops import shading as jshading
from fyp_bidirectionalpathtracer_tpu.ops import texture as jtexture
from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState as JAccumState
from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState as JBMFRState
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import render_frame_fn as jrender_frame_fn
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils import config as jconfig
from fyp_bidirectionalpathtracer_tpu.utils.image import psnr, read_png, to_u8
from fyp_bidirectionalpathtracer_tpu.utils.testing import GOLDEN_DIR
from fyp_bidirectionalpathtracer_tpu_torch.models import pink_room as pink
from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
from fyp_bidirectionalpathtracer_tpu_torch.ops import alpha, shading, texture
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    BDPT_FRAME_INIT,
    GBUF_FRAME_INIT,
    Renderer,
    render_frame_fn,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import (
    Scene,
    baked_scene_arrays,
    baked_scene_from_arrays,
)
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig
from torch_threads import one_intra_op_thread  # noqa: F401

T_MIN = 1e-3


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


def _pink(mod, **kw):
    return mod.pink_room(asset_dir="", **kw)


# ------------------------------------------------------- the model's copy
def _assert_scenes_equal(got, want):
    assert len(got.meshes) == len(want.meshes) > 0
    for gm, wm in zip(got.meshes, want.meshes):
        for f in dataclasses.fields(wm):
            np.testing.assert_array_equal(np.asarray(getattr(gm, f.name)),
                                          np.asarray(getattr(wm, f.name)), err_msg=f.name)
    assert len(got.materials) == len(want.materials)
    for gm, wm in zip(got.materials, want.materials):
        for f in dataclasses.fields(wm):
            g, w = getattr(gm, f.name), getattr(wm, f.name)
            if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
                np.testing.assert_array_equal(g, w, err_msg=f.name)
            else:
                assert g == w, f.name
    assert repr(got.lights) == repr(want.lights) and got.camera == want.camera


@pytest.mark.parametrize("kw", [{}, {"subdivisions": 4}, {"use_fscene_lights": False}],
                         ids=["default", "subdivisions4", "no-fscene-lights"])
def test_pink_room_copy_equals_jax(kw):
    """models/pink_room.py: the same meshes, materials (textures included),
    lights and camera."""
    _assert_scenes_equal(_pink(pink, **kw), _pink(jpink, **kw))


def pink_texture_names(monkeypatch, mod) -> list:
    """The texture files pink_room loads, in order (read off its loader)."""
    names = []
    with monkeypatch.context() as m:
        m.setattr(mod, "_load_texture", lambda d, name, fallback: names.append(name) or fallback)
        mod.pink_room(asset_dir="")
    return names


def write_pink_textures(folder, names) -> None:
    """Seeded maps under pink_room's names, written by PIL: the .jpg ones
    as a baseline and a progressive JPEG, the .png ones in turn as RGB,
    RGBA, L, LA and P files of a few sizes; the last PNG truncated."""
    from PIL import Image

    rs = np.random.RandomState(21)
    pngs = [n for n in names if n.endswith(".png")]
    for i, name in enumerate(names):
        h, w = 12 + 3 * (i % 4), 16 + 2 * (i % 5)
        pic = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
        path = os.path.join(folder, name)
        if name.endswith(".jpg"):
            Image.fromarray(pic[..., :3]).save(path, quality=85, progressive=i % 2 == 1)
            continue
        mode = ("RGB", "RGBA", "L", "LA", "P")[i % 5]
        img = {"RGB": lambda: Image.fromarray(pic[..., :3]), "RGBA": lambda: Image.fromarray(pic),
               "L": lambda: Image.fromarray(pic[..., 0]),
               "LA": lambda: Image.fromarray(pic[..., :2], "LA"),
               "P": lambda: Image.fromarray(pic[..., :3]).quantize(9)}[mode]()
        img.save(path)
        if name == pngs[-1]:
            data = open(path, "rb").read()
            open(path, "wb").write(data[:len(data) // 2])


def test_pink_room_texture_folder_equals_jax(tmp_path, monkeypatch):
    """pink_room(asset_dir=folder) with PNG and JPEG maps under JAX's names:
    the same scene in both packages (every texture PIL's convert("RGBA")
    bit for bit), the truncated file's procedural fallback in both."""
    names = pink_texture_names(monkeypatch, pink)
    assert names == pink_texture_names(monkeypatch, jpink)
    assert {"Abstract.jpg", "Fabric.jpg"} <= set(names) and len(set(names)) == len(names)
    write_pink_textures(str(tmp_path), names)
    got, want = pink.pink_room(asset_dir=str(tmp_path)), jpink.pink_room(asset_dir=str(tmp_path))
    _assert_scenes_equal(got, want)
    stand_in = pink.pink_room(asset_dir="")
    by_name = {m.name: (m, s) for m, s in zip(got.materials, stand_in.materials)}
    for mat in ("abstract", "fabric", "walls"):
        m, s = by_name[mat]
        assert m.base_color_image.shape != s.base_color_image.shape, mat
    truncated = [n for n in names if n.endswith(".png")][-1]  # Light_Emissive.png
    assert truncated == "Light_Emissive.png"
    np.testing.assert_array_equal(by_name["light_fixture"][0].emissive_image,
                                  by_name["light_fixture"][1].emissive_image)


# ------------------------------------------------------------- the bake
SCENES = {"pink_room": lambda mod: _pink(mod), "textured_room": lambda mod: mod.textured_room()}


@pytest.fixture(scope="module", params=list(SCENES))
def both_bakes(request):
    """(JAX bake, the port's own bake, the port's bake of JAX's arrays)."""
    jmod, pmod = {"pink_room": (jpink, pink),
                  "textured_room": (jprocedural, procedural)}[request.param]
    jb = JScene.from_built(SCENES[request.param](jmod), aspect=1.5).bake()
    pb = Scene.from_built(SCENES[request.param](pmod), aspect=1.5).bake(device="cpu")
    return jb, pb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


def test_textured_bake_equals_jax(both_bakes):
    """Atlas data, sizes, packed and combined tables, material constants
    with their texture means, BVH and geometry equal; the static flags
    equal (pink_room: three kinds textured, so a combined table and no
    packed one; textured_room: base colour only, the reverse)."""
    jb, pb, _ = both_bakes
    want, got = jax_scene_arrays(jb), baked_scene_arrays(pb)
    assert set(want) == set(got)
    for key, w in want.items():
        g = got[key]
        assert w.shape == g.shape, key
        assert w.dtype == g.dtype or not key.startswith(("textures.", "bvh.")), key
        if key.startswith("camera."):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    ja, pa = jb.data.textures, pb.data.textures
    assert (pa.any_base, pa.any_spec, pa.any_emissive) == (ja.any_base, ja.any_spec,
                                                          ja.any_emissive)
    assert (pa.combined is None) == (ja.combined is None) != (pa.packed is None)
    assert pb.tex_defer_ok == jb.tex_defer_ok
    assert not jb.has_alpha and not jb.has_normal_maps
    assert (pb.has_alpha, pb.has_normal_maps) == (jb.has_alpha, jb.has_normal_maps)


def test_has_alpha_materials_matches_jax():
    """The bake-time alpha check on constant and textured alpha; the bake
    sets `has_alpha` from it, as JAX's does."""
    built = jprocedural.alpha_panel_scene()
    jb = JScene.from_built(built).bake()
    assert jb.has_alpha
    assert alpha.has_alpha_materials(jb.data.materials, jb.data.textures)
    for b in (_pink(jpink), jprocedural.cornell_box()):
        data = JScene.from_built(b).bake().data
        assert not jalpha.has_alpha_materials(data.materials, data.textures)
        assert not alpha.has_alpha_materials(data.materials, data.textures)
    assert Scene.from_built(procedural.alpha_panel_scene()).bake(device="cpu").has_alpha


# ------------------------------------------------------------- the taps
def _taps_inputs(atlas, n_mat, seed=5):
    rs = np.random.RandomState(seed)
    n = 4096
    uv = rs.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:16] = np.asarray([[0, 0], [1, 1], [-1, 0.5], [0.999999, 0]] * 4, np.float32)
    t = int(np.asarray(atlas.data).shape[0])
    slot = rs.randint(-1, t, n).astype(np.int32)
    mat = rs.randint(-1, n_mat, n).astype(np.int32)
    const = rs.uniform(0, 1, (n, 4)).astype(np.float32)
    return uv, slot, mat, const


def test_texture_taps_match_jax(both_bakes):
    """sample_combined (pink_room), sample_atlas_bilinear and the packed
    tap (on a packed table of the atlas), sample_or_constant with each
    static switch, and _u32_rgba's integers, on uv outside [0, 1] and
    negative and slots including -1."""
    jb, _, pc = both_bakes
    ja, pa = jb.data.textures, pc.data.textures
    uv, slot, mat, const = _taps_inputs(ja, int(jb.data.materials.ior.shape[0]))
    J, T = jnp.asarray, torch.from_numpy  # noqa: N806
    close = lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,  # noqa: E731
                                                    atol=1e-6)
    if ja.combined is not None:
        for g, w in zip(texture.sample_combined(pa, T(mat), T(uv)),
                        jtexture.sample_combined(ja, J(mat), J(uv))):
            close(g, w)
        words = np.asarray(ja.combined)[::997]
        np.testing.assert_array_equal(texture._u32_rgba(T(words.view(np.int32))).numpy(),
                                      np.asarray(jtexture._u32_rgba(J(words))))
    close(texture.sample_atlas_bilinear(pa.data, T(slot), T(uv)),
          jtexture.sample_atlas_bilinear(ja.data, J(slot), J(uv)))
    data = np.asarray(ja.data)
    rx = np.roll(data, -1, axis=2)
    packed = np.concatenate([data, rx, np.roll(data, -1, axis=1), np.roll(rx, -1, axis=1)], -1)
    close(texture.sample_atlas_bilinear_packed(T(packed), T(slot), T(uv)),
          jtexture.sample_atlas_bilinear_packed(J(packed), J(slot), J(uv)))
    for used in (True, False):
        close(texture.sample_or_constant(pa, T(slot), T(uv), T(const), static_used=used),
              jtexture.sample_or_constant(ja, J(slot), J(uv), J(const), static_used=used))
    close(texture.sample_base_color(pa, pc.data.materials, T(mat), T(uv)),
          jtexture.sample_base_color(ja, jb.data.materials, J(mat), J(uv)))


# ------------------------------------------------- the shaded tracer
def _textured_sphere_grid(mod):
    """tests/test_torch_cluster.py's icosphere grid (2560 triangles) with
    checkerboard base, specular and emissive textures."""
    s = (JScene if mod is jprocedural else Scene)()
    cb = mod.checkerboard
    s.materials = [
        mod.MaterialDesc("a", base_color=(0.8, 0.3, 0.3, 1.0), base_color_image=cb(16),
                         specular_image=cb(8, (0.2, 0.5, 0.1), (0.6, 0.2, 0.3), 2)),
        mod.MaterialDesc("b", base_color=(0.3, 0.8, 0.3, 1.0), specular=(0, 0.4, 0.6, 0),
                         shading_model=0, emissive=(0.5, 0.4, 0.3),
                         emissive_image=cb(8, (1.0, 0.5, 0.2), (0.1, 0.2, 0.4), 4)),
        mod.MaterialDesc("c", base_color=(0.5, 0.5, 0.5, 1.0)),
    ]
    for i in range(4):
        for j in range(2):
            s.meshes.append(mod.icosphere((i * 1.5, j * 1.5, 2.0 + 0.3 * ((i + j) % 3)), 0.5,
                                          (i + j) % 3, subdivisions=2))
    s.lights = [{"type": "point", "pos": (2.0, 4.0, -2.0), "intensity": (10.0, 10.0, 10.0)}]
    return s.apply_default_fixups()


@pytest.fixture(scope="module")
def sphere_bakes():
    jb = _textured_sphere_grid(jprocedural).bake(atlas_res=32)
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


def _bounce_rays(n=1200, seed=9):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-1.0, 4.0, (n, 3)).astype(np.float32)
    d = (rs.uniform((-0.5, -0.5, 1.5), (5.0, 2.0, 3.0), (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.ascontiguousarray(o), np.ascontiguousarray(d)


LEAN_FIELDS = ("pos_w", "n", "v", "diffuse", "specular", "linear_roughness", "roughness",
               "n_dot_v")


@pytest.mark.parametrize("lean,mean", [(False, False), (True, False), (False, True),
                                       (True, True)],
                         ids=["exact", "lean", "mean-primary", "lean-mean"])
def test_shaded_tracer_matches_jax_cluster_branch(sphere_bakes, lean, mean):
    """The port's tracer (the BVH branch: 2560 triangles) against JAX's
    cluster branch (force_cluster, lean_bf16 off).  JAX's unsorted cluster
    branch taps the full atlas on every trace (ops/shading.py:647-655), so
    `bounce_tex_mean` shows only through its sorted branch, the TPU default
    (sort_bounces): the lean-mean case is held against sort_divergent=True
    with coherent=False, on the fields a lean trace promises."""
    jb, pb = sphere_bakes
    o, d = _bounce_rays()
    sort = lean and mean
    jtrace = jshading.make_shaded_tracer(jb, force_cluster=True, sort_divergent=sort,
                                         lean_bf16=False, bounce_tex_mean=mean)
    ptrace = shading.make_shaded_tracer(pb, bounce_tex_mean=mean)
    view = np.asarray([1.0, 0.5, -2.0], np.float32)
    jhit, jsd = jtrace(jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(view),
                       coherent=not sort, lean=lean)
    phit, psd = ptrace(torch.from_numpy(o), torch.from_numpy(d), T_MIN, torch.from_numpy(view),
                       coherent=not sort, lean=lean)
    gt, wt = phit.tri.numpy(), np.asarray(jhit.tri)
    g_t, w_t = phit.t.numpy(), np.asarray(jhit.t)
    np.testing.assert_array_equal(gt >= 0, wt >= 0)
    # t = (n.v0 - n.o) / n.d cancels for an origin near a surface: one ulp
    # of n.o at |o| ~ 4 over a grazing n.d is ~5e-7 (two such rays here)
    np.testing.assert_allclose(g_t, w_t, rtol=1e-5, atol=1e-6)
    hit = gt >= 0
    if not sort:  # the sorted lean branch carries t and a hit flag, not ids
        assert ((gt == wt) | ~hit).mean() > 0.99
        hit &= gt == wt
    assert hit.sum() > 300
    names = LEAN_FIELDS if sort else [f.name for f in dataclasses.fields(psd)]
    for name in names:
        g, w = getattr(psd, name).numpy(), np.asarray(getattr(jsd, name))
        np.testing.assert_allclose(g[hit], w[hit].astype(g.dtype), rtol=0, atol=2e-4,
                                   err_msg=name)
    textured = np.asarray(pb.data.materials.base_color_tex)[psd.material_id.numpy()[hit]] >= 0
    assert textured.any() and (~textured).any()


# ------------------------------------------------------------ the frame
W, H = 32, 20


@pytest.fixture(scope="module")
def pink_bakes():
    jb = JScene.from_built(_pink(jpink), aspect=W / H).bake()
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


def test_pink_room_frame_matches_jax(pink_bakes):
    """render_frame_fn on pink_room at 32x20 with bounce_tex_mean=False:
    JAX's CPU wavefront (jnp intersect_bvh with Moller-Trumbore, the
    gather decode over the full atlas) against the port's (the BVH
    branch's plain versions, Baldwin-Weber): edge ties differ, so the
    bounds are test_torch_wavefront.py's statistical ones."""
    jb, pb = pink_bakes
    bkw = {"bounce_tex_mean": False}
    jcfg = jconfig.RenderConfig(width=W, height=H, bdpt=jconfig.BDPTConfig(**bkw))
    pcfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(**bkw))
    jch, _, _ = jrender_frame_fn(jb, jb.data.camera, JAccumState.create(H, W),
                                 JBMFRState.create(H, W), jnp.uint32(GBUF_FRAME_INIT),
                                 jnp.uint32(BDPT_FRAME_INIT), jnp.asarray(False), jcfg)
    pch, _, _ = render_frame_fn(pb, pb.data.camera, AccumState.create(H, W, device="cpu"),
                                BMFRState.create(H, W, device="cpu"), GBUF_FRAME_INIT,
                                BDPT_FRAME_INIT, False, pcfg)
    for key in ("WorldPosition", "WorldNormal", "MaterialDiffuse", "MaterialSpecRough",
                "Emissive"):
        frac = (np.abs(np.asarray(jch[key]) - pch[key].numpy()).max(-1) > 1e-3).mean()
        assert frac <= 0.01, (key, frac)
    want, got = np.asarray(jch["BDPT"]), pch["BDPT"].numpy()
    assert np.isfinite(got).all() and got[..., :3].mean() > 0.005
    d = np.abs(want - got)
    frac = (d.max(-1) > 1e-3).mean()
    mad, dmean = d.mean(), abs(want[..., :3].mean() - got[..., :3].mean())
    assert frac <= 0.02 and mad < 5e-3 and dmean < 2e-3, (frac, mad, dmean)


def test_pink_room_golden_through_the_port():
    """pink_room_fallback_2f_64x40 (read only) through Renderer with
    bounce_tex_mean=False, which is what JAX's CPU path renders (its gather
    decode taps the full atlas at every vertex).  chip_smoke.py phase 6
    also reads the default config's dB on the card."""
    baked = Scene.from_built(_pink(pink), aspect=64 / 40).bake(device="cpu")
    r = Renderer(baked, RenderConfig(width=64, height=40,
                                     bdpt=BDPTConfig(bounce_tex_mean=False)))
    r.render(2)
    img = r.display().numpy()
    assert np.isfinite(img).all()
    golden = read_png(os.path.join(GOLDEN_DIR, "pink_room_fallback_2f_64x40.png"))
    value = psnr(to_u8(np.clip(img, 0.0, 1.0)).astype(np.float32) / 255.0, golden)
    assert value >= 38.0, value
