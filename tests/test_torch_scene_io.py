"""The port's scene I/O against the JAX package's on the CPU, with no JAX
render: `scene/animation.py` (Path.sample with the loop wrap and the
clamp, rigid_transform_at, at 50 seeded times), `models/obj.py` (OBJ + MTL
with RGBA, grey + tRNS and palette + tRNS PNG maps, and JPEG, TGA and BMP
maps, decoded bit for bit as JAX's PIL decodes them), `models/fbx.py` (files written by each package
read by the other, versions 7400 and 7500), `scene/fscene.py` (load_fscene
on a file that covers every branch, save_fscene both ways) and the bake of
a loaded scene.

Bounds: host arrays, images, paths, lights and camera poses bit for bit;
the camera's derived fields (float32 trig and 4x4 math in another
library) within 1e-6, as tests/test_torch_scene.py holds the bake's.
test_scene.py's runnable fscene cases and test_fbx.py's five runnable
cases run on the port too."""
import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from fyp_bidirectionalpathtracer_tpu.models import fbx as jfbx
from fyp_bidirectionalpathtracer_tpu.models import obj as jobj
from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.scene import animation as janimation
from fyp_bidirectionalpathtracer_tpu.scene import fscene as jfscene
from fyp_bidirectionalpathtracer_tpu_torch.models import fbx, obj, procedural
from fyp_bidirectionalpathtracer_tpu_torch.scene import animation, fscene
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import (
    Scene,
    baked_scene_arrays,
    baked_scene_from_arrays,
)
from fyp_bidirectionalpathtracer_tpu_torch.utils.image import read_rgba, write_png
from test_torch_image import _encode_png
from test_torch_scene import _assert_bake_equals_jax, jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

CAMERA_POSE = ("pos_w", "target", "up")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _assert_meshes_equal(got, want):
    assert len(got) == len(want) > 0
    for k, (gm, wm) in enumerate(zip(got, want)):
        for f in dataclasses.fields(wm):
            g, w = getattr(gm, f.name), getattr(wm, f.name)
            if isinstance(w, np.ndarray):
                _assert_same(g, w, f"mesh {k} {f.name}")
            else:
                assert g == w and type(g) is type(w), (k, f.name, g, w)


def _assert_materials_equal(got, want):
    assert len(got) == len(want) > 0
    for k, (gm, wm) in enumerate(zip(got, want)):
        for f in dataclasses.fields(wm):
            g, w = getattr(gm, f.name), getattr(wm, f.name)
            if w is None or isinstance(w, np.ndarray):
                assert (g is None) == (w is None), (k, f.name)
                if w is not None:
                    _assert_same(g, w, f"material {k} {f.name}")
            else:
                assert g == w and repr(g) == repr(w), (k, f.name, g, w)


def _assert_paths_equal(got, want):
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert (gp.name, gp.loop, gp.attached) == (wp.name, wp.loop, wp.attached)
        assert len(gp.frames) == len(wp.frames)
        for gf, wf in zip(gp.frames, wp.frames):
            assert gf.time == wf.time
            for key in ("pos", "target", "up"):
                _assert_same(getattr(gf, key), getattr(wf, key), key)


def _assert_camera_equal(got, want):
    for f in dataclasses.fields(got):
        g = getattr(got, f.name).numpy()
        w = np.asarray(getattr(want, f.name))
        if f.name in CAMERA_POSE or f.name in ("focal_length", "aspect", "near_z", "far_z"):
            _assert_same(g, w, f.name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f.name)


def _assert_scenes_equal(got, want):
    _assert_meshes_equal(got.meshes, want.meshes)
    _assert_materials_equal(got.materials, want.materials)
    assert repr(got.lights) == repr(want.lights)
    _assert_camera_equal(got.camera, want.camera)
    _assert_paths_equal(got.camera_paths, want.camera_paths)
    _assert_paths_equal(got.object_paths, want.object_paths)
    assert (got.env_map is None) == (want.env_map is None)
    if want.env_map is not None:
        _assert_same(got.env_map, want.env_map, "env_map")
    for key in ("env_map_file", "lighting_scale", "camera_speed", "name"):
        assert getattr(got, key) == getattr(want, key), key


# ------------------------------------------------------------ animation
def _path_doc(loop=True, n=4, seed=0):
    rs = np.random.RandomState(seed)
    times = np.sort(rs.uniform(0.0, 5.0, n)).round(3)
    return {"name": f"p{seed}", "loop": loop, "frames": [
        {"time": float(t), "pos": rs.uniform(-3, 3, 3).tolist(),
         "target": rs.uniform(-3, 3, 3).tolist(), "up": rs.uniform(-1, 1, 3).tolist()}
        for t in times[::-1]]}  # unsorted in the file: path_from_dict sorts


@pytest.mark.parametrize("loop,n", [(True, 4), (False, 4), (True, 1), (False, 2)])
def test_path_sample_and_rigid_transform_bit_equal(loop, n):
    """50 seeded times, below the first keyframe, inside, past the end (the
    loop wrap or the clamp): the same float32 bits as JAX."""
    doc = _path_doc(loop, n, seed=n)
    got, want = animation.path_from_dict(doc), janimation.path_from_dict(doc)
    _assert_paths_equal([got], [want])
    ts = np.random.RandomState(7).uniform(-2.0, 14.0, 50).tolist() + [0.0, got.duration]
    for t in ts:
        for g, w in zip(got.sample(t), want.sample(t)):
            _assert_same(g, w, f"sample({t})")
        for g, w in zip(animation.rigid_transform_at(got, t),
                        janimation.rigid_transform_at(want, t)):
            _assert_same(g, w, f"rigid_transform_at({t})")


def test_rigid_transform_degenerate_poses():
    """pos == target (identity), and a view along up (the z fallback)."""
    for target, up in (([1.0, 2.0, 3.0], [0, 1, 0]), ([1.0, 5.0, 3.0], [0, 1, 0])):
        doc = {"frames": [{"time": 0.0, "pos": [1, 2, 3], "target": target, "up": up}]}
        for g, w in zip(animation.rigid_transform_at(animation.path_from_dict(doc), 0.3),
                        janimation.rigid_transform_at(janimation.path_from_dict(doc), 0.3)):
            _assert_same(g, w, "degenerate")


def test_animation_path_interpolation():
    """test_scene.py's case on the port."""
    p = animation.path_from_dict({"name": "p", "loop": True, "frames": [
        {"time": 0.0, "pos": [0, 0, 0], "target": [1, 0, 0], "up": [0, 1, 0]},
        {"time": 2.0, "pos": [2, 0, 0], "target": [3, 0, 0], "up": [0, 1, 0]}]})
    pos, _, _ = p.sample(1.0)
    np.testing.assert_allclose(pos, [1, 0, 0], atol=1e-6)
    pos, _, _ = p.sample(3.0)  # loops: 3 % 2 = 1
    np.testing.assert_allclose(pos, [1, 0, 0], atol=1e-6)


# ------------------------------------------------------------ PNG maps, OBJ
def _add_trns(path, payload: bytes):
    data = open(path, "rb").read()
    at = data.index(b"IDAT") - 4
    chunk = (struct.pack(">I", len(payload)) + b"tRNS" + payload
             + struct.pack(">I", zlib.crc32(b"tRNS" + payload) & 0xFFFFFFFF))
    with open(path, "wb") as fh:
        fh.write(data[:at] + chunk + data[at:])


def write_maps(folder) -> dict:
    """Seeded 8-bit PNG maps: RGBA (a cutout alpha), grey + alpha, RGB,
    grey + tRNS, RGB + tRNS, palette + tRNS (per-entry alphas) and palette
    with one transparent entry."""
    rs = np.random.RandomState(11)
    out = {}

    def put(name, samples, ctype, palette=None, trns=None):
        path = os.path.join(folder, name)
        _encode_png(path, samples, ctype, 8, palette)
        if trns is not None:
            _add_trns(path, trns)
        out[name] = path

    rgba = rs.randint(0, 256, (12, 10, 4)).astype(np.uint8)
    rgba[..., 3] = np.where(rs.uniform(size=(12, 10)) < 0.4, 0, 255)
    put("rgba.png", rgba, 6)
    put("grey_alpha.png", rs.randint(0, 256, (7, 9, 2)).astype(np.uint8), 4)
    put("rgb.png", rs.randint(0, 256, (5, 6, 3)).astype(np.uint8), 2)
    grey = rs.randint(0, 256, (8, 8, 1)).astype(np.uint8)
    grey[::3, ::2] = 77
    put("grey_trns.png", grey, 0, trns=struct.pack(">H", 77))
    rgb = rs.randint(0, 256, (6, 7, 3)).astype(np.uint8)
    rgb[::2, ::3] = (10, 20, 30)
    rgb[1, 1] = (10, 20, 31)
    put("rgb_trns.png", rgb, 2, trns=struct.pack(">HHH", 10, 20, 30))
    pal = rs.randint(0, 40, (9, 11, 1)).astype(np.uint8)  # indices past the PLTE too
    put("palette_trns.png", pal, 3, rs.randint(0, 256, (32, 3)),
        bytes(rs.randint(0, 256, 20).astype(np.uint8)))
    put("palette_one.png", pal, 3, rs.randint(0, 256, (40, 3)), b"\xff\xff\x00\xff")
    return out


@pytest.mark.parametrize("name", ["rgba.png", "grey_alpha.png", "rgb.png", "grey_trns.png",
                                  "rgb_trns.png", "palette_trns.png", "palette_one.png"])
def test_png_rgba_decode_equals_pil(tmp_path, name):
    path = write_maps(str(tmp_path))[name]
    got = read_rgba(path)
    want = jobj._load_image(path)  # PIL's convert("RGBA") / 255
    _assert_same(got, want, name)
    if name != "rgb.png":
        assert (got[..., 3] < 1).any(), name


OBJ_TEXT = """mtllib {mtl}
# a quad with normals and uvs, a pentagon without normals (flat normals
# generated), a triangle by negative indices, faces in every corner format
v -1 0 -1
v -1 0 1
v 1 0 1
v 1 0 -1
v 0 1 0
v 0.5 1.5 0.25
v -0.5 1.25 0.5
vn 0 1 0
vn 0.3 0.9 0.1
vt 0 0
vt 0 4
vt 4 4
vt 4 0
vt 0.5
usemtl floor
f 1/1/1 2/2/1 3/3/2 4/4/1
usemtl cutout
f 1/1 3/3 5/5 6/2 7/4
usemtl bumpy
f -3//-1 -2//-2 -1//-1
usemtl grey
f 2 4 6
usemtl nosuch
f 1 5 7
"""

MTL_TEXT = """newmtl floor
Kd 0.7 0.6 0.5
Ks 0.1 0.1 0.1
Ns 100
Ni 1.33
newmtl cutout
Kd 0.9 0.9 0.9
d 0.75
Ke 0.5 0.25 0.0
map_Kd rgba.png
newmtl bumpy
Kd 0.2 0.8 0.3
map_Kd palette_trns.png
map_bump palette_one.png
newmtl grey
Kd 0.5 0.5 0.5
map_Kd grey_trns.png
bump rgb_trns.png
newmtl missing
map_Kd nowhere.png
norm nowhere_either.png
"""


def write_obj(folder, name="room") -> str:
    write_maps(folder)
    with open(os.path.join(folder, f"{name}.mtl"), "w") as fh:
        fh.write(MTL_TEXT)
    path = os.path.join(folder, f"{name}.obj")
    with open(path, "w") as fh:
        fh.write(OBJ_TEXT.format(mtl=f"{name}.mtl"))
    return path


def test_load_obj_and_mtl_bit_equal(tmp_path):
    """Meshes (fan triangulation, corner formats, flat normals) and
    materials (every key, the PNG maps as PIL's RGBA; a missing map None)
    equal to JAX's."""
    path = write_obj(str(tmp_path))
    (gm, gmat), (wm, wmat) = obj.load_obj(path), jobj.load_obj(path)
    _assert_meshes_equal(gm, wm)
    _assert_materials_equal(gmat, wmat)
    names = [m.name for m in gmat]
    assert names == ["default", "floor", "cutout", "bumpy", "grey", "missing"]
    assert gmat[2].base_color_image is not None and (gmat[2].base_color_image[..., 3] == 0).any()
    assert gmat[3].normal_map_image is not None and gmat[4].normal_map_image is not None
    assert gmat[5].base_color_image is None and gmat[5].normal_map_image is None
    _assert_materials_equal(list(obj.load_mtl(path[:-3] + "mtl").values()),
                            list(jobj.load_mtl(path[:-3] + "mtl").values()))
    assert obj.load_mtl(str(tmp_path / "none.mtl")) == {} == jobj.load_mtl(
        str(tmp_path / "none.mtl"))


def test_texture_maps_refused_or_missing(tmp_path):
    """JAX's answers: a garbage .jpg, a truncated PNG and a missing map give
    None; an interlaced PNG decodes as PIL decodes it.  What PIL reads and
    the port refuses (a TIFF map) raises, naming the file and the format,
    where JAX reads it."""
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded here")
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n truncated")
    rs = np.random.RandomState(3)
    _encode_png(str(tmp_path / "laced.png"), rs.randint(0, 256, (6, 5, 3)), 2, 8, interlace=1)
    (tmp_path / "m.mtl").write_text("newmtl a\nmap_Kd a.jpg\nmap_bump laced.png\n"
                                    "newmtl b\nmap_Kd b.jpg\nmap_bump bad.png\n")
    got, want = obj.load_mtl(str(tmp_path / "m.mtl")), jobj.load_mtl(str(tmp_path / "m.mtl"))
    assert got["a"].base_color_image is None and got["a"].normal_map_image is not None
    assert got["b"].base_color_image is None and got["b"].normal_map_image is None
    _assert_materials_equal(list(got.values()), list(want.values()))
    Image.fromarray(rs.randint(0, 256, (4, 4, 3)).astype(np.uint8)).save(tmp_path / "t.tif")
    (tmp_path / "t.mtl").write_text("newmtl t\nmap_Kd t.tif\n")
    with pytest.raises(NotImplementedError, match=r"t\.tif: TIFF"):
        obj.load_mtl(str(tmp_path / "t.mtl"))
    assert jobj.load_mtl(str(tmp_path / "t.mtl"))["t"].base_color_image.shape == (4, 4, 4)


def test_jpeg_tga_bmp_maps_equal_jax(tmp_path):
    """An MTL whose maps are a progressive 4:2:0 JPEG, a baseline JPEG, a
    32-bit RLE TGA cutout, a grey TGA, a palette BMP and a 16-bit BMP (the
    checked-in fixtures of tests/torch_images/): load_mtl's materials equal
    JAX's, every map PIL's convert("RGBA") bit for bit."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_images")
    maps = {"progressive_420.jpg": "map_Kd", "baseline_420.jpg": "map_Kd",
            "cutout_rle32.tga": "map_Kd", "grey_rle.tga": "map_bump",
            "palette8.bmp": "map_Kd", "rgb565.bmp": "bump"}
    text = ""
    for i, (name, key) in enumerate(maps.items()):
        with open(os.path.join(fixtures, name), "rb") as src:
            (tmp_path / name).write_bytes(src.read())
        text += f"newmtl m{i}\nKd 0.5 0.5 0.5\n{key} {name}\n"
    (tmp_path / "maps.mtl").write_text(text)
    got = obj.load_mtl(str(tmp_path / "maps.mtl"))
    want = jobj.load_mtl(str(tmp_path / "maps.mtl"))
    _assert_materials_equal(list(got.values()), list(want.values()))
    for i, (name, key) in enumerate(maps.items()):
        img = (got[f"m{i}"].base_color_image if key == "map_Kd"
               else got[f"m{i}"].normal_map_image)
        assert img is not None and img.shape[-1] == 4, name
    assert (got["m2"].base_color_image[..., 3] == 0).any()  # the TGA's cutout


def _scene_meshes(mod):
    b = mod.cornell_box()
    b.meshes.append(mod.icosphere((0.3, 0.4, 0.5), 0.2, 2, subdivisions=1))
    b.materials[1].emissive = (0.1, 0.2, 0.3)
    return b.meshes, b.materials


def test_save_obj_both_ways(tmp_path):
    """save_obj / save_mtl write the same bytes in both packages, and each
    package's file loads to equal meshes in both."""
    meshes, mats = _scene_meshes(procedural)
    jmeshes, jmats = _scene_meshes(jprocedural)
    obj.save_obj(str(tmp_path / "p.obj"), meshes, mats)
    jobj.save_obj(str(tmp_path / "j.obj"), jmeshes, jmats)
    for ext in ("obj", "mtl"):
        p, j = (tmp_path / f"p.{ext}").read_text(), (tmp_path / f"j.{ext}").read_text()
        assert p.replace("p.mtl", "j.mtl") == j, ext
    for name in ("p.obj", "j.obj"):
        (gm, gmat), (wm, wmat) = obj.load_obj(str(tmp_path / name)), jobj.load_obj(
            str(tmp_path / name))
        _assert_meshes_equal(gm, wm)
        _assert_materials_equal(gmat, wmat)


# ------------------------------------------------------------ FBX
def _quad_mesh(mat=1, mod=procedural):
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return mod.MeshData(pos, nrm, uv, idx, mat)


def _mats(mod=procedural):
    return [mod.MaterialDesc(),
            mod.MaterialDesc(name="red", base_color=(0.8, 0.1, 0.1, 1.0),
                             specular=(0.2, 0.2, 0.2, 0.5), emissive=(0.0, 1.0, 0.0))]


@pytest.mark.parametrize("version", [7400, 7500])
def test_fbx_written_by_each_read_by_both(tmp_path, version):
    """Cornell + an icosphere + a quad: the port's save_fbx writes JAX's
    bytes; the file loads to equal meshes and materials in both, and
    parse_fbx gives the same tree."""
    meshes, mats = _scene_meshes(procedural)
    jmeshes, jmats = _scene_meshes(jprocedural)
    meshes.append(_quad_mesh())
    jmeshes.append(_quad_mesh(mod=jprocedural))
    p, j = str(tmp_path / "p.fbx"), str(tmp_path / "j.fbx")
    fbx.save_fbx(p, meshes, mats, version=version)
    jfbx.save_fbx(j, jmeshes, jmats, version=version)
    assert open(p, "rb").read() == open(j, "rb").read()
    for path in (p, j):
        (gm, gmat), (wm, wmat) = fbx.load_fbx(path), jfbx.load_fbx(path)
        _assert_meshes_equal(gm, wm)
        _assert_materials_equal(gmat, wmat)
    (groot, gver), (wroot, wver) = fbx.parse_fbx(p), jfbx.parse_fbx(p)
    assert gver == wver == version
    assert repr(groot) == repr(wroot)


def _rewrite(path, root, version, out):
    buf = bytearray(fbx._MAGIC + struct.pack("<I", version))
    off = len(buf)
    for top in root.children:
        blob = fbx._render_tree(top, off, version >= 7500)
        buf += blob
        off += len(blob)
    buf += bytes(25 if version >= 7500 else 13) + bytes(16)
    with open(out, "wb") as fh:
        fh.write(bytes(buf))


@pytest.mark.parametrize("variant", ["transform", "by_vertex_index", "by_polygon", "no_layers"])
def test_fbx_layer_variants_and_transforms_equal_jax(tmp_path, variant):
    """A Model transform chain (translation, rotation, scaling,
    PreRotation, a parent model), IndexToDirect normals mapped ByVertex, a
    ByPolygon material layer over two materials, and geometry without
    normal or UV layers: the port's load_fbx equals JAX's."""
    path = str(tmp_path / "q.fbx")
    meshes = [_quad_mesh(), _quad_mesh(0)]
    meshes[1].positions = meshes[1].positions + np.float32(2.0)
    fbx.save_fbx(path, meshes, _mats(), version=7500)
    root, version = fbx.parse_fbx(path)
    objects = root.child("Objects")
    geo = objects.all("Geometry")[0]
    if variant == "transform":
        model = objects.all("Model")[0]
        p70 = model.child("Properties70")
        for name, vals in (("Lcl Translation", (5.0, -1.0, 2.0)),
                           ("Lcl Rotation", (10.0, 20.0, 90.0)),
                           ("Lcl Scaling", (2.0, 1.5, 0.5)),
                           ("PreRotation", (0.0, 45.0, 0.0))):
            p70.children.append(fbx.FBXNode("P", [name, name, "", "A", *vals]))
        parent_uid = 99999
        parent = fbx.FBXNode("Model", [parent_uid, "parent\x00\x01Model", "Null"])
        parent.children.append(fbx.FBXNode("Properties70", [], [fbx.FBXNode(
            "P", ["Lcl Translation", "Lcl Translation", "", "A", 0.0, 3.0, 0.0])]))
        objects.children.append(parent)
        conns = root.child("Connections")
        for c in conns.all("C"):
            if c.props[1] == model.props[0] and c.props[2] == 0:
                c.props[2] = parent_uid
    elif variant == "by_vertex_index":
        ln = geo.child("LayerElementNormal")
        ln.child("MappingInformationType").props[0] = "ByVertice"
        ln.child("ReferenceInformationType").props[0] = "IndexToDirect"
        ln.child("Normals").props[0] = np.asarray(
            [[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64).reshape(-1)
        ln.children.append(fbx.FBXNode("NormalsIndex", [np.asarray([2, 1, 0, 1], np.int64)]))
    elif variant == "by_polygon":
        lm = geo.child("LayerElementMaterial")
        lm.child("MappingInformationType").props[0] = "ByPolygon"
        lm.child("Materials").props[0] = np.asarray([0, 1], np.int64)
        model_uid = objects.all("Model")[0].props[0]
        mat_uids = [n.props[0] for n in objects.all("Material")]
        root.child("Connections").children.append(fbx.FBXNode("C", ["OO", mat_uids[0],
                                                                    model_uid]))
    else:
        geo.children = [c for c in geo.children if not c.name.startswith("LayerElement")]
    out = str(tmp_path / "q2.fbx")
    _rewrite(path, root, version, out)
    (gm, gmat), (wm, wmat) = fbx.load_fbx(out), jfbx.load_fbx(out)
    _assert_meshes_equal(gm, wm)
    _assert_materials_equal(gmat, wmat)
    if variant == "by_polygon":
        assert len(gm) == 3  # the first quad split by its two materials


@pytest.mark.parametrize("version", [7400, 7500])
def test_fbx_roundtrip_versions(tmp_path, version):
    """test_fbx.py's case on the port."""
    path = os.path.join(tmp_path, f"quad_{version}.fbx")
    fbx.save_fbx(path, [_quad_mesh()], _mats(), version=version)
    meshes, mats = fbx.load_fbx(path)
    assert len(meshes) == 1
    m, src = meshes[0], _quad_mesh()
    for key in ("positions", "normals", "uvs"):
        np.testing.assert_allclose(getattr(m, key)[m.indices.reshape(-1)],
                                   getattr(src, key)[src.indices.reshape(-1)], atol=1e-6)
    red = mats[m.material]
    np.testing.assert_allclose(red.base_color[:3], (0.8, 0.1, 0.1), atol=1e-6)
    np.testing.assert_allclose(red.emissive, (0.0, 1.0, 0.0), atol=1e-6)
    assert abs(red.specular[3] - 0.5) < 1e-6


def test_fbx_roundtrip_cornell_geometry(tmp_path):
    built = procedural.cornell_box()
    path = os.path.join(tmp_path, "cornell.fbx")
    fbx.save_fbx(path, built.meshes, built.materials)
    meshes, _ = fbx.load_fbx(path)
    assert len(meshes) == len(built.meshes)
    assert sum(len(m.indices) for m in meshes) == sum(len(m.indices) for m in built.meshes)
    for src, rt in zip(built.meshes, meshes):
        np.testing.assert_allclose(rt.positions[rt.indices.reshape(-1)],
                                   np.asarray(src.positions)[np.asarray(src.indices).reshape(-1)],
                                   atol=1e-5)


def test_fbx_model_transform_applied(tmp_path):
    path = os.path.join(tmp_path, "quad_t.fbx")
    fbx.save_fbx(path, [_quad_mesh()], _mats())
    root, version = fbx.parse_fbx(path)
    p70 = root.child("Objects").all("Model")[0].child("Properties70")
    for name, vals in (("Lcl Translation", (5.0, -1.0, 2.0)), ("Lcl Rotation", (0.0, 0.0, 90.0)),
                       ("Lcl Scaling", (2.0, 2.0, 2.0))):
        p70.children.append(fbx.FBXNode("P", [name, name, "", "A", *vals]))
    path2 = os.path.join(tmp_path, "quad_t2.fbx")
    _rewrite(path, root, version, path2)
    meshes, _ = fbx.load_fbx(path2)
    got = meshes[0].positions[meshes[0].indices[0]]
    np.testing.assert_allclose(got, [[5, -1, 2], [5, 1, 2], [3, 1, 2]], atol=1e-5)
    np.testing.assert_allclose(meshes[0].normals[0], [0, 0, 1], atol=1e-6)


def test_fbx_layer_mapping_by_vertex(tmp_path):
    path = os.path.join(tmp_path, "quad_bv.fbx")
    fbx.save_fbx(path, [_quad_mesh()], _mats())
    root, version = fbx.parse_fbx(path)
    ln = root.child("Objects").all("Geometry")[0].child("LayerElementNormal")
    ln.child("MappingInformationType").props[0] = "ByVertex"
    per_vertex = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)
    ln.child("Normals").props[0] = per_vertex.reshape(-1)
    path2 = os.path.join(tmp_path, "quad_bv2.fbx")
    _rewrite(path, root, version, path2)
    m = fbx.load_fbx(path2)[0][0]
    np.testing.assert_allclose(m.normals[m.indices[0]], per_vertex[[0, 1, 2]], atol=1e-6)


def test_fscene_loads_fbx_model(tmp_path):
    fbx.save_fbx(os.path.join(tmp_path, "box.fbx"), [_quad_mesh()], _mats())
    doc = {"version": 2, "models": [{"file": "box.fbx", "name": "box", "instances": [
        {"name": "inst0", "translation": [0, 0, 0], "scaling": [1, 1, 1],
         "rotation": [0, 0, 0]}]}],
        "lights": [{"name": "pt", "type": "point_light", "intensity": [1.0, 1.0, 1.0],
                    "pos": [0.5, 0.5, 2.0], "direction": [0.0, 0.0, -1.0]}],
        "cameras": [{"name": "cam", "pos": [0.5, 0.5, 3.0], "target": [0.5, 0.5, 0.0]}],
        "active_camera": "cam"}
    path = os.path.join(tmp_path, "box.fscene")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    scene = fscene.load_fscene(path)
    assert sum(len(m.indices) for m in scene.meshes) == 2
    assert scene.apply_default_fixups().bake(device="cpu").n_tris == 2


# ------------------------------------------------------------ .fscene
def write_fscene(folder, with_fbx=True) -> str:
    """An .fscene that covers the loader: a missing model (the Cornell
    stand-in), an OBJ with PNG maps in two instances (translation,
    scaling, rotation), an FBX (written by JAX's save_fbx) rotated,
    point, directional and spot lights, two cameras and active_camera,
    camera, object and light paths (one attached to the camera and an
    instance both), lighting scale, camera speed and a PNG env map."""
    write_obj(folder, "props")
    models = [
        {"file": "missing_room.fbx", "name": "room"},
        {"file": "props.obj", "name": "props", "instances": [
            {"name": "propsA", "translation": [0.1, 0.2, 0.3], "scaling": [0.2, 0.3, 0.25],
             "rotation": [10.0, 33.0, -12.5]},
            {"name": "propsB", "translation": [-0.3, 0.05, 0.6], "scaling": [0.1, 0.1, 0.1],
             "rotation": [0.0, 90.0, 0.0]}]},
    ]
    if with_fbx:
        jfbx.save_fbx(os.path.join(folder, "quad.fbx"), [_quad_mesh(mod=jprocedural)],
                      _mats(jprocedural), version=7500)
        models.append({"file": "quad.fbx", "instances": [
            {"name": "quadA", "translation": [0.5, 0.5, 0.5], "scaling": [0.3, 0.3, 0.3],
             "rotation": [45.0, 0.0, 30.0]}]})
    env = np.random.RandomState(5).uniform(0, 1, (8, 16, 3)).astype(np.float32)
    write_png(os.path.join(folder, "sky.png"), env)
    frames = [{"time": t, "pos": [0.5 + 0.1 * k, 0.5, -1.2 - 0.05 * k],
               "target": [0.5, 0.45 + 0.02 * k, 0.5], "up": [0.0, 1.0, 0.05 * k]}
              for k, t in enumerate((0.0, 0.4, 1.0))]
    doc = {
        "version": 2, "camera_speed": 1.5, "lighting_scale": 2.0, "active_camera": "Main",
        "models": models,
        "lights": [
            {"name": "key", "type": "point_light", "pos": [0.5, 0.95, 0.5],
             "intensity": [1.2, 1.1, 1.0], "direction": [0, -1, 0]},
            {"name": "sun", "type": "dir_light", "direction": [0.3, -0.5, 0.8],
             "intensity": [1, 1, 0.9]},
            {"name": "spot", "type": "point_light", "pos": [0.2, 0.9, 0.3],
             "direction": [0.1, -1.0, 0.2], "intensity": [2, 2, 2],
             "opening_angle": 35.0, "penumbra_angle": 5.5},
        ],
        "cameras": [
            {"name": "Other", "pos": [0, 0, -9], "target": [0, 0, 0]},
            {"name": "Main", "pos": [0.5, 0.5, -1.2], "target": [0.5, 0.5, 0.5],
             "up": [0, 1, 0], "focal_length": 24.0, "depth_range": [0.05, 500.0],
             "aspect_ratio": 1.3333},
        ],
        "paths": [
            {"name": "cam", "loop": True, "frames": frames},
            {"name": "cam2", "loop": False, "attached_objects": [{"type": "camera",
                                                                   "name": "Main"}],
             "frames": frames[:2]},
            {"name": "mover", "loop": True, "attached_objects": [
                {"type": "model_instance", "name": "propsA"}, {"type": "light", "name": "key"}],
             "frames": [{"time": 0.0, "pos": [0.3, 0.2, 0.4], "target": [0.3, 0.2, 0.0]},
                        {"time": 0.5, "pos": [0.6, 0.3, 0.5], "target": [0.9, 0.3, 0.2],
                         "up": [0.1, 1.0, 0.0]}]},
            {"name": "both", "loop": True, "attached_objects": [
                {"type": "camera"}, {"type": "model_instance", "name": "quadA"}],
             "frames": frames},
        ],
        "user_defined": {"env_map": "sky.png"},
    }
    path = os.path.join(folder, "animated.fscene")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


@pytest.fixture(scope="module")
def fscene_file(tmp_path_factory):
    return write_fscene(str(tmp_path_factory.mktemp("fscene")))


def test_load_fscene_bit_equal(fscene_file):
    got, want = fscene.load_fscene(fscene_file), jfscene.load_fscene(fscene_file)
    _assert_scenes_equal(got, want)
    assert len(got.camera_paths) == 3 and len(got.object_paths) == 2
    assert {m.name for m in got.meshes} == {"room", "propsA", "propsB", "quadA"}
    assert got.lights[2]["opening_angle"] == float(np.deg2rad(35.0))
    assert got.env_map.shape == (8, 16, 4) and got.env_map_file == "sky.png"


def test_load_fscene_refuses_missing_models(fscene_file):
    for loader in (fscene.load_fscene, jfscene.load_fscene):
        with pytest.raises(FileNotFoundError, match="missing_room"):
            loader(fscene_file, allow_missing_models=False)
    bad = os.path.join(os.path.dirname(fscene_file), "v3.fscene")
    with open(bad, "w") as fh:
        json.dump({"version": 3}, fh)
    with pytest.raises(ValueError, match="version"):
        fscene.load_fscene(bad)


def test_pink_room_stand_in(tmp_path):
    """A missing pink_room.fbx becomes the stand-in room without its own
    lights (the .fscene's are used); the default fixups add a light and a
    camera to a file that names none."""
    path = str(tmp_path / "pink.fscene")
    with open(path, "w") as fh:
        json.dump({"version": 2, "models": [{"file": "pink_room.fbx"}]}, fh)
    got, want = fscene.load_fscene(path), jfscene.load_fscene(path)
    _assert_scenes_equal(got, want)
    assert got.n_triangles() == 10546 and got.lights[0]["type"] == "dir"


def test_bake_of_a_loaded_scene_equals_jax(fscene_file):
    """The port's bake of its loaded scene equals JAX's bake of JAX's,
    carried across (baked_scene_from_arrays), with the host scene kept on
    the bake and left out of the carried arrays."""
    ps, js = fscene.load_fscene(fscene_file), jfscene.load_fscene(fscene_file)
    pb, jb = ps.bake(device="cpu"), js.bake()
    _assert_bake_equals_jax(pb, jb)
    carried = baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")
    ours = baked_scene_arrays(pb)
    for key, value in baked_scene_arrays(carried).items():
        if key.startswith("camera.") and key[7:] not in CAMERA_POSE:
            np.testing.assert_allclose(ours[key], value, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            _assert_same(ours[key], value, key)
    assert torch.equal(pb.tri_pack, carried.tri_pack)
    assert pb.host is ps and carried.host is None
    assert pb.with_camera(pb.data.camera).host is ps
    assert not any(k.startswith("host") for k in baked_scene_arrays(pb))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_fscene_both_ways(tmp_path, fscene_file, writer):
    """save_fscene of a loaded scene (after the default fixups, as the
    app's --export-scene): the port's and JAX's writers make the same
    .fscene, .obj and .mtl files, and each package loads the other's file
    to equal scenes."""
    ps, js = fscene.load_fscene(fscene_file), jfscene.load_fscene(fscene_file)
    out = {}
    for name, mod, sc in (("port", fscene, ps), ("jax", jfscene, js)):
        sc.apply_default_fixups()
        out[name] = str(tmp_path / name / "scene.fscene")
        mod.save_fscene(sc, out[name])
    for ext in ("fscene", "obj", "mtl"):
        a = open(out["port"][:-6] + ext).read()
        b = open(out["jax"][:-6] + ext).read()
        assert a == b, ext
    # the env map's file name is carried, its image not copied: both
    # loaders need it beside the export
    os.link(os.path.join(os.path.dirname(fscene_file), "sky.png"),
            os.path.join(os.path.dirname(out[writer]), "sky.png"))
    _assert_scenes_equal(fscene.load_fscene(out[writer]), jfscene.load_fscene(out[writer]))


def test_fscene_loader(tmp_path):
    """test_scene.py's case on the port."""
    doc = {
        "version": 2, "camera_speed": 1.0, "lighting_scale": 2.0, "active_camera": "Cam",
        "models": [],
        "lights": [
            {"type": "point_light", "pos": [1, 2, 3], "intensity": [1, 1, 1],
             "direction": [0, -1, 0], "opening_angle": 180.0},
            {"type": "dir_light", "direction": [0.3, -0.5, 0.8], "intensity": [1, 1, 0.9]}],
        "cameras": [{"name": "Cam", "pos": [0, 1, -3], "target": [0, 1, 0], "up": [0, 1, 0],
                     "focal_length": 21.0, "depth_range": [0.1, 10000.0],
                     "aspect_ratio": 1.0}],
        "paths": [{"name": "P", "loop": True, "frames": [
            {"time": 0.0, "pos": [0, 0, 0], "target": [0, 0, 1], "up": [0, 1, 0]}]}],
    }
    f = tmp_path / "test.fscene"
    f.write_text(json.dumps(doc))
    scene = fscene.load_fscene(str(f))
    assert len(scene.lights) == 2
    assert scene.lights[0]["opening_angle"] == pytest.approx(np.pi)
    assert scene.camera is not None and len(scene.camera_paths) == 1
    baked = scene.bake(device="cpu")
    assert float(baked.data.lights.intensity[0, 0]) == pytest.approx(2.0)


def test_fscene_save_load_roundtrip(tmp_path):
    """test_scene.py's case on the port: geometry, materials, lights,
    camera and paths survive save -> load."""
    src = Scene.from_built(procedural.cornell_box())
    src.apply_default_fixups()
    src.camera_paths.append(animation.Path(name="orbit", loop=True, frames=[
        animation.Keyframe(0.0, np.zeros(3), np.ones(3), np.asarray([0., 1., 0.])),
        animation.Keyframe(2.0, np.ones(3), np.zeros(3), np.asarray([0., 1., 0.]))]))
    path = str(tmp_path / "export" / "scene.fscene")
    fscene.save_fscene(src, path)
    dst = fscene.load_fscene(path, allow_missing_models=False)
    assert sum(len(m.indices) for m in dst.meshes) == src.n_triangles()
    assert len(dst.lights) == len(src.lights)
    np.testing.assert_allclose(dst.camera.pos_w.numpy(), src.camera.pos_w.numpy(), atol=1e-4)
    assert len(dst.camera_paths) == 1 and dst.camera_paths[0].frames[1].time == 2.0
    kinds = {tuple(np.round(m.base_color[:3], 3)) for m in dst.materials}
    assert (0.0, 1.0, 0.0) in kinds or any(
        abs(c[1] - max(c)) < 1e-3 and c[1] > 0.4 for c in kinds)


def test_fscene_without_models_gets_jax_default_camera(tmp_path):
    """A scene with no meshes has JAX's bounds (0, 1), so the default
    camera and light are JAX's."""
    path = str(tmp_path / "empty.fscene")
    with open(path, "w") as fh:
        json.dump({"version": 2}, fh)
    got, want = fscene.load_fscene(path), jfscene.load_fscene(path)
    assert got.meshes == [] and repr(got.lights) == repr(want.lights)
    _assert_camera_equal(got.camera, want.camera)
