"""The port's animation against the JAX package's on the CPU:
`Renderer.animate` over camera and object paths (the camera, `state.time`
and each re-bake against JAX's, with no JAX render), the slice as a whole
(2 animated frames of a Cornell .fscene, rendered by both packages),
`scene/controllers.py` on the same event sequences, and `ops/skinning.py`;
test_animation_objects.py's and test_controllers.py's behaviour tests run
on the port.

Bounds: the camera pose, `state.time` and the re-baked arrays bit for bit;
the camera's derived fields (float32 trig and 4x4 math in another
library) within 1e-6, as tests/test_torch_scene.py holds the bake's, and
its inverse matrix within 1e-5 relative (measured 1.3e-6 on a moved pose:
the inverse of entries up to 13 amplifies the last-bit differences); the
rendered frames within test_torch_wavefront.py's image bounds (at most 2%
of pixels over 1e-3, mean |d| < 5e-3, mean radiance difference < 2e-3:
both packages trace the wavefront, and float rounding flips edge ties);
the controllers' float64 host maths rounded to float32 within 1e-6;
skinning within 1e-6 (the port sums the influences by gather, JAX by
one-hot matmuls, in another order)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.ops import skinning as jskinning
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer as JRenderer
from fyp_bidirectionalpathtracer_tpu.scene import camera as jcamera
from fyp_bidirectionalpathtracer_tpu.scene import controllers as jcontrollers
from fyp_bidirectionalpathtracer_tpu.scene import fscene as jfscene
from fyp_bidirectionalpathtracer_tpu.utils import config as jconfig
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.ops.skinning import bone_matrices, skin_vertices
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene import fscene
from fyp_bidirectionalpathtracer_tpu_torch.scene.animation import (
    Keyframe,
    Path,
    rigid_transform_at,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import make_camera
from fyp_bidirectionalpathtracer_tpu_torch.scene.controllers import (
    FirstPersonCameraController,
    KeyEvent,
    MouseEvent,
    OrbitCameraController,
    SixDoFCameraController,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig
from test_torch_scene import _assert_bake_equals_jax
from test_torch_wavefront import _assert_image_bounds
from torch_threads import one_intra_op_thread  # noqa: F401

CAMERA_POSE = ("pos_w", "target", "up")
DT = 1.0 / 60.0


def cornell_fscene(folder, camera_path=True, object_path=False, name="cornell") -> str:
    """A Cornell .fscene: its model file missing (the cornell_box()
    stand-in, instance `box`), Cornell's light (named `key`) and camera, a
    looping 4-keyframe camera path swinging around the box, and an object
    path that carries `box` and moves `key`."""
    paths = []
    if camera_path:
        paths.append({"name": "swing", "loop": True, "frames": [
            {"time": t, "pos": [0.5 + x, 0.5 + y, -1.35], "target": [0.5, 0.5, 0.5],
             "up": [0.0, 1.0, 0.0]}
            for t, x, y in ((0.0, 0.0, 0.0), (0.05, 0.12, 0.03), (0.1, -0.1, 0.06),
                            (0.2, 0.0, 0.0))]})
    if object_path:
        paths.append({"name": "carry", "loop": True, "attached_objects": [
            {"type": "model_instance", "name": "box"}, {"type": "light", "name": "key"}],
            "frames": [{"time": 0.0, "pos": [0.0, 0.0, 0.0], "target": [0.0, 0.0, -1.0]},
                       {"time": 0.1, "pos": [0.02, 0.01, 0.0], "target": [0.1, 0.0, -1.0]},
                       {"time": 0.3, "pos": [0.0, 0.03, 0.02], "target": [0.0, 0.05, -1.0]}]})
    doc = {"version": 2, "camera_speed": 1.0, "lighting_scale": 1.0, "active_camera": "cam",
           "models": [{"file": "cornell_missing.fbx",
                       "instances": [{"name": "box"}]}],
           "lights": [{"name": "key", "type": "point_light", "pos": [0.5, 0.93, 0.5],
                       "intensity": [18.0, 18.0, 18.0]}],
           "cameras": [{"name": "cam", "pos": [0.5, 0.5, -1.35], "target": [0.5, 0.5, 0.5],
                        "up": [0, 1, 0], "focal_length": 21.0, "aspect_ratio": 1.0}],
           "paths": paths}
    path = os.path.join(folder, f"{name}.fscene")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def _assert_camera_equal(got, want):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if f.name in CAMERA_POSE:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=f.name)
        else:
            rtol = 1e-5 if f.name == "inv_view_proj" else 1e-6
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6, err_msg=f.name)


# ------------------------------------------------------------ Renderer.animate
@pytest.mark.parametrize("camera_path,object_path", [(True, False), (False, True), (True, True)],
                         ids=["camera", "object", "camera+object"])
def test_animate_equals_jax(tmp_path, camera_path, object_path):
    """5 animate steps on both packages' renderers over the same file: the
    time, the camera and (object paths) every re-baked array equal JAX's;
    the re-bake stays on the renderer's device with JAX's light capacity."""
    path = cornell_fscene(str(tmp_path), camera_path, object_path)
    cfg = RenderConfig(width=16, height=12)
    port = Renderer(fscene.load_fscene(path).bake(max_lights=16, device="cpu"), cfg)
    jax_r = JRenderer(jfscene.load_fscene(path).bake(max_lights=16),
                      jconfig.RenderConfig(width=16, height=12))
    first = port.baked
    for step in range(5):
        dt = DT * (1 + step % 2)
        port.animate(dt)
        jax_r.animate(dt)
        assert port.state.time == jax_r.state.time and type(port.state.time) is float
        _assert_camera_equal(port.camera, jax_r.camera)
        if object_path:
            assert port.baked is not first and port.baked.host is first.host
            _assert_bake_equals_jax(port.baked, jax_r.baked)
            assert port.baked.device.type == "cpu" and port.baked.data.lights.pos_w.shape[0] == 16
        else:
            assert port.baked is first
    assert port.state.time == pytest.approx(7 * DT)


def test_animated_accumulation_resets_on_camera_moves_only(tmp_path):
    """A camera path resets the accumulation every frame
    (test_features.py's animated case); an object path alone does not
    (camera_moved compares view_proj only, as JAX's)."""
    cfg = RenderConfig(width=16, height=16)
    cam = Renderer(fscene.load_fscene(cornell_fscene(str(tmp_path), True, False, "a")).bake(
        device="cpu"), cfg)
    obj = Renderer(fscene.load_fscene(cornell_fscene(str(tmp_path), False, True, "b")).bake(
        device="cpu"), cfg)
    poses = []
    for _ in range(3):
        for r in (cam, obj):
            r.animate(DT)
            r.render_frame()
        poses.append(cam.camera.pos_w.clone())
    assert int(cam.state.accum.count) == 1 and int(obj.state.accum.count) == 3
    assert not torch.equal(poses[0], poses[1])


def test_animated_frames_match_jax(tmp_path):
    """The slice as a whole: the same Cornell .fscene loaded, baked and
    rendered by both packages for 2 animated frames at 32x24 (the camera
    path moves every frame): each frame's BDPT image and the last
    Accumulated within the wavefront bounds."""
    path = cornell_fscene(str(tmp_path))
    w, h = 32, 24
    port = Renderer(fscene.load_fscene(path).bake(device="cpu"),
                    RenderConfig(width=w, height=h, bdpt=BDPTConfig(megakernel="off")))
    jax_r = JRenderer(jfscene.load_fscene(path).bake(),
                      jconfig.RenderConfig(width=w, height=h,
                                           bdpt=jconfig.BDPTConfig(megakernel="off")))
    for _ in range(2):
        port.animate(DT)
        jax_r.animate(DT)
        port.render_frame()
        jax_r.render_frame()
        _assert_image_bounds(np.asarray(jax_r.channels["BDPT"]), port.channels["BDPT"].numpy())
    _assert_image_bounds(np.asarray(jax_r.channels["Accumulated"]),
                         port.channels["Accumulated"].numpy())
    assert int(port.state.accum.count) == 1 and port.state.time == jax_r.state.time


# ------------------------------------------------------------ object paths, skinning
def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0, s], [0, 1, 0], [-c * 0 - s, 0, c]], np.float32)


def test_skinning_single_rigid_bone_is_exact():
    rng = np.random.RandomState(0)
    v = 64
    pos = torch.from_numpy(rng.uniform(-1, 1, (v, 3)).astype(np.float32))
    nrm_raw = rng.normal(size=(v, 3))
    nrm = torch.from_numpy((nrm_raw / np.linalg.norm(nrm_raw, axis=-1, keepdims=True))
                           .astype(np.float32))
    r = _rot_y(0.7)
    t = np.asarray([0.3, -0.2, 1.5], np.float32)
    palette = bone_matrices(torch.from_numpy(r)[None], torch.from_numpy(t)[None])
    ids = torch.zeros((v, 4), dtype=torch.int32)
    w = torch.cat([torch.ones((v, 1)), torch.zeros((v, 3))], -1)
    p2, n2 = skin_vertices(pos, nrm, ids, w, palette)
    np.testing.assert_allclose(p2.numpy(), pos.numpy() @ r.T + t, atol=1e-5)
    np.testing.assert_allclose(n2.numpy(), nrm.numpy() @ r.T, atol=1e-5)


def test_skinning_blend_interpolates_translations():
    pos = torch.zeros((4, 3))
    nrm = torch.tensor([[0.0, 1.0, 0.0]]).repeat(4, 1)
    palette = bone_matrices(torch.eye(3)[None].repeat(2, 1, 1),
                            torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]]))
    ids = torch.tensor([[0, 1]], dtype=torch.int32).repeat(4, 1)
    w = torch.tensor([[1.0, 0.0], [0.75, 0.25], [0.5, 0.5], [0.0, 1.0]])
    p2, _ = skin_vertices(pos, nrm, ids, w, palette)
    np.testing.assert_allclose(p2.numpy()[:, 0], [0.0, 0.5, 1.0, 2.0], atol=1e-6)


def test_skin_vertices_matches_jax():
    """A seeded rig: 500 vertices, 4 influences each over 7 bones (repeats
    allowed), rotations from random axes."""
    rs = np.random.RandomState(4)
    v, b, k = 500, 7, 4
    pos = rs.uniform(-2, 2, (v, 3)).astype(np.float32)
    nrm = rs.normal(size=(v, 3)).astype(np.float32)
    rots = []
    for _ in range(b):
        q = rs.normal(size=4)
        q /= np.linalg.norm(q)
        w_, x, y, z = q
        rots.append([[1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)],
                     [2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)],
                     [2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)]])
    rots = np.asarray(rots, np.float32)
    trans = rs.uniform(-1, 1, (b, 3)).astype(np.float32)
    ids = rs.randint(0, b, (v, k)).astype(np.int32)
    wts = rs.uniform(0, 1, (v, k)).astype(np.float32)
    wts /= wts.sum(1, keepdims=True)
    jp, jn = jskinning.skin_vertices(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(ids),
                                     jnp.asarray(wts), jskinning.bone_matrices(
                                         jnp.asarray(rots), jnp.asarray(trans)))
    palette = bone_matrices(torch.from_numpy(rots), torch.from_numpy(trans))
    np.testing.assert_array_equal(palette.numpy(), np.asarray(
        jskinning.bone_matrices(jnp.asarray(rots), jnp.asarray(trans))))
    pp, pn = skin_vertices(torch.from_numpy(pos), torch.from_numpy(nrm), torch.from_numpy(ids),
                           torch.from_numpy(wts), palette)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)


def _two_frame_path(attached):
    return Path(name="p", loop=False, attached=attached, frames=[
        Keyframe(0.0, np.asarray([0.0, 0.0, 0.0], np.float32),
                 np.asarray([0.0, 0.0, -1.0], np.float32), np.asarray([0.0, 1.0, 0.0], np.float32)),
        Keyframe(1.0, np.asarray([2.0, 0.0, 0.0], np.float32),
                 np.asarray([2.0, 0.0, -1.0], np.float32), np.asarray([0.0, 1.0, 0.0], np.float32)),
    ])


def test_rigid_transform_identity_orientation():
    r, t = rigid_transform_at(_two_frame_path([("model_instance", "box")]), 0.5)
    np.testing.assert_allclose(r, np.eye(3), atol=1e-6)  # rest forward = -z
    np.testing.assert_allclose(t, [1.0, 0.0, 0.0], atol=1e-6)


def test_scene_object_path_moves_mesh_and_rebakes():
    sc = Scene.from_built(cornell_box(), aspect=1.0)
    sc.meshes[0].name = "box"
    rest = sc.meshes[0].positions.copy()
    sc.object_paths.append(_two_frame_path([("model_instance", "box")]))
    assert sc.update_objects(0.5)
    np.testing.assert_allclose(sc.meshes[0].positions, rest + np.asarray([1.0, 0.0, 0.0]),
                               atol=1e-5)
    assert sc.update_objects(1.0)  # from rest each time, not cumulative
    np.testing.assert_allclose(sc.meshes[0].positions, rest + np.asarray([2.0, 0.0, 0.0]),
                               atol=1e-5)
    assert sc.bake(device="cpu").n_tris > 0


def test_light_path_moves_light():
    sc = Scene.from_built(cornell_box(), aspect=1.0)
    sc.lights[0]["name"] = "keylight"
    sc.object_paths.append(_two_frame_path([("light", "keylight")]))
    assert sc.update_objects(1.0)
    np.testing.assert_allclose(sc.lights[0]["pos"], [2.0, 0.0, 0.0], atol=1e-6)


# ------------------------------------------------------------ controllers
def _cam(mod=None):
    kw = dict(pos=(0.5, 0.5, -1.5), target=(0.5, 0.5, 0.5), up=(0, 1, 0), aspect=1.0)
    return (mod or make_camera)(**kw)


def test_orbit_initial_pose_and_zoom():
    c = OrbitCameraController(center=(0.5, 0.5, 0.5), radius=1.0, distance_in_radii=3.0)
    cam, dirty = c.update(_cam())
    assert dirty
    np.testing.assert_allclose(cam.pos_w.numpy(), [0.5, 0.5, 3.5], atol=1e-5)
    np.testing.assert_allclose(cam.target.numpy(), [0.5, 0.5, 0.5], atol=1e-6)
    assert c.on_mouse_event(MouseEvent("wheel", wheel=1.0))  # 0.2 radii a tick
    cam, _ = c.update(cam)
    np.testing.assert_allclose(cam.pos_w.numpy(), [0.5, 0.5, 3.3], atol=1e-5)


def test_orbit_drag_rotates_at_constant_distance():
    c = OrbitCameraController(center=(0.5, 0.5, 0.5), radius=1.0, distance_in_radii=3.0)
    cam, _ = c.update(_cam())
    c.on_mouse_event(MouseEvent("left_down", pos=(0.5, 0.5)))
    c.on_mouse_event(MouseEvent("move", pos=(0.6, 0.5)))
    cam2, dirty = c.update(cam)
    assert dirty
    p1, p2 = cam.pos_w.numpy() - 0.5, cam2.pos_w.numpy() - 0.5
    assert np.linalg.norm(p1 - p2) > 1e-3
    np.testing.assert_allclose(np.linalg.norm(p1), np.linalg.norm(p2), rtol=1e-5)


def test_first_person_wasd_moves_along_view():
    c = FirstPersonCameraController(speed=1.0)
    cam = _cam()
    assert c.on_key_event(KeyEvent("w", pressed=True))
    cam2, dirty = c.update(cam, dt=0.5)
    assert dirty
    np.testing.assert_allclose(cam2.pos_w.numpy() - cam.pos_w.numpy(), [0, 0, 0.5], atol=1e-5)
    c.on_key_event(KeyEvent("w", pressed=True, shift=True))  # shift: 10x
    cam3, _ = c.update(cam2, dt=0.5)
    np.testing.assert_allclose(cam3.pos_w.numpy() - cam2.pos_w.numpy(), [0, 0, 5.0], atol=1e-4)


def test_first_person_look_keeps_up_y():
    c = FirstPersonCameraController()
    cam = _cam()
    c.on_mouse_event(MouseEvent("left_down", pos=(0.5, 0.5)))
    c.on_mouse_event(MouseEvent("move", pos=(0.55, 0.48)))
    cam2, dirty = c.update(cam, dt=0.016)
    assert dirty
    np.testing.assert_allclose(cam2.pos_w.numpy(), cam.pos_w.numpy())
    v1 = cam.target.numpy() - cam.pos_w.numpy()
    v2 = cam2.target.numpy() - cam2.pos_w.numpy()
    assert np.linalg.norm(v1 / np.linalg.norm(v1) - v2 / np.linalg.norm(v2)) > 1e-4


def test_six_dof_roll():
    c = SixDoFCameraController()
    cam = _cam()
    c.on_mouse_event(MouseEvent("right_down", pos=(0.5, 0.5)))
    c.on_mouse_event(MouseEvent("move", pos=(0.6, 0.5)))
    cam2, dirty = c.update(cam, dt=0.016)
    assert dirty
    up2 = cam2.up.numpy()
    assert abs(up2[0]) > 1e-3
    np.testing.assert_allclose(np.linalg.norm(up2), 1.0, atol=1e-5)
    np.testing.assert_allclose(cam2.target.numpy(), cam.target.numpy(), atol=1e-6)


def _events(mod):
    """A sequence of mouse and key events, with update() after each group."""
    return [
        [mod.MouseEvent("left_down", pos=(0.5, 0.5)), mod.MouseEvent("move", pos=(0.62, 0.44))],
        [mod.MouseEvent("move", pos=(0.7, 0.41)), mod.KeyEvent("w"), mod.KeyEvent("d")],
        [mod.MouseEvent("left_up"), mod.KeyEvent("w", pressed=False), mod.KeyEvent("e",
                                                                                  ctrl=True)],
        [mod.MouseEvent("right_down", pos=(0.3, 0.6)), mod.MouseEvent("move", pos=(0.35, 0.7)),
         mod.KeyEvent("q", shift=True), mod.KeyEvent("x")],
        [mod.MouseEvent("wheel", wheel=-1.5), mod.MouseEvent("right_up")],
        [mod.MouseEvent("left_down", pos=(0.95, 0.05)), mod.MouseEvent("move", pos=(0.05, 0.95))],
    ]


@pytest.mark.parametrize("kind", ["OrbitCameraController", "FirstPersonCameraController",
                                  "SixDoFCameraController"])
def test_controllers_match_jax(kind):
    """The same event sequence into each package's controller: the same
    event answers and dirty flags; every camera field within 1e-6, the
    inverse matrix 1e-5 relative (the host maths is float64 numpy in both,
    the camera's derivation float32 in another library)."""
    from fyp_bidirectionalpathtracer_tpu_torch.scene import controllers

    ours, theirs = getattr(controllers, kind)(), getattr(jcontrollers, kind)()
    cam, jcam = _cam(), _cam(jcamera.make_camera)
    for group, jgroup in zip(_events(controllers), _events(jcontrollers)):
        for ev, jev in zip(group, jgroup):
            fn = "on_key_event" if isinstance(ev, KeyEvent) else "on_mouse_event"
            if hasattr(ours, fn):
                assert getattr(ours, fn)(ev) == getattr(theirs, fn)(jev), (kind, ev)
        (cam, dirty), (jcam, jdirty) = ours.update(cam, 0.05), theirs.update(jcam, 0.05)
        assert dirty == jdirty
        for f in dataclasses.fields(cam):
            rtol = 1e-5 if f.name == "inv_view_proj" else 1e-6
            np.testing.assert_allclose(getattr(cam, f.name).numpy(),
                                       np.asarray(getattr(jcam, f.name)), rtol=rtol, atol=1e-6,
                                       err_msg=f.name)
    assert cam.pos_w.dtype == torch.float32 and cam.pos_w.device.type == "cpu"
