""".fscene (v2 JSON) loader and writer.

The port's own copy of `fyp_bidirectionalpathtracer_tpu/scene/fscene.py`,
building the port's `Scene`: fed the same file, `load_fscene` gives the
JAX loader's meshes, materials, lights, camera pose and paths bit for bit
(`tests/test_torch_scene_io.py`).  It parses the reference's scene format
(SceneImporter.cpp:102-1316): models with instances (translation, scaling,
rotation), point, directional and spot lights (angles in degrees in the
file, radians in the scene), cameras, paths routed by their
attached_objects into camera and object paths, lighting scale, camera
speed and the user_defined env map.  Model geometry comes from
`models/obj.load_obj` or `models/fbx.load_fbx` by suffix; a model file
that is missing is replaced, unless `allow_missing_models` is False, by a
procedural stand-in: the pink_room interior for a file named like it,
else the Cornell box.

Loader fixups follow SceneLoaderWrapper.cpp:56-102: a default directional
light when the scene has none, a default camera from the scene bounds,
instancing flattened (RemoveInstancing).  `save_fscene` (the SceneExporter
analogue) writes the geometry as an OBJ + MTL pair beside the scene file.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..models.fbx import load_fbx
from ..models.obj import load_obj, save_obj
from ..models.pink_room import pink_room
from ..models.procedural import MaterialDesc, MeshData, cornell_box
from ..utils.image import read_image
from . import animation
from .camera import make_camera
from .scene import Scene


def _rotation_matrix(rot_deg) -> np.ndarray:
    """Falcor applies yaw (Y), pitch (X), roll (Z) euler angles in degrees."""
    rx, ry, rz = (np.deg2rad(float(a)) for a in rot_deg)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.asarray([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.asarray([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (my @ mx @ mz).astype(np.float32)


def _instance_mesh(mesh: MeshData, translation, scaling, rotation) -> MeshData:
    r = _rotation_matrix(rotation)
    s = np.asarray(scaling, np.float32)
    t = np.asarray(translation, np.float32)
    pos = (mesh.positions * s) @ r.T + t
    # normals: inverse-transpose of diag(s)@R -> R @ diag(1/s)
    nrm = (mesh.normals / np.maximum(s, 1e-20)) @ r.T
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-20
    return MeshData(pos.astype(np.float32), nrm.astype(np.float32), mesh.uvs, mesh.indices, mesh.material)


def load_fscene(path: str, allow_missing_models: bool = True) -> Scene:
    with open(path, "r") as fh:
        doc = json.load(fh)
    if int(doc.get("version", 2)) != 2:
        raise ValueError(f"unsupported fscene version {doc.get('version')}")

    base = os.path.dirname(os.path.abspath(path))
    scene = Scene(name=os.path.basename(path))
    scene.lighting_scale = float(doc.get("lighting_scale", 1.0))
    scene.camera_speed = float(doc.get("camera_speed", 1.0))

    # ---- models ----
    for model in doc.get("models", []):
        fname = model.get("file", "")
        full = os.path.join(base, fname)
        meshes: list[MeshData] = []
        mats: list[MaterialDesc] = []
        if fname.lower().endswith(".obj") and os.path.exists(full):
            meshes, mats = load_obj(full)
        elif fname.lower().endswith(".fbx") and os.path.exists(full):
            meshes, mats = load_fbx(full)
        elif allow_missing_models:
            if "pink_room" in fname.lower():
                # the authored stand-in for the packman-fetched FBX, with
                # the reference textures when present (models.pink_room);
                # lights and camera come from the .fscene itself below
                built = pink_room(use_fscene_lights=False)
            else:
                built = cornell_box()
            meshes, mats = built.meshes, built.materials
        else:
            raise FileNotFoundError(f"cannot import model {full}")
        mat_off = len(scene.materials)
        scene.materials.extend(mats)
        for inst in model.get("instances", [{}]):
            for m in meshes:
                mi = _instance_mesh(
                    m,
                    inst.get("translation", (0, 0, 0)),
                    inst.get("scaling", (1, 1, 1)),
                    inst.get("rotation", (0, 0, 0)),
                )
                mi.material = m.material + mat_off
                mi.name = inst.get("name", model.get("name", fname))
                scene.meshes.append(mi)

    # ---- lights ----
    for l in doc.get("lights", []):
        kind = l.get("type", "point_light")
        entry = {
            "type": "dir" if kind == "dir_light" else "point",
            "name": l.get("name", ""),
            "pos": tuple(l.get("pos", (0, 0, 0))),
            "dir": tuple(l.get("direction", (0, -1, 0))),
            "intensity": tuple(l.get("intensity", (1, 1, 1))),
        }
        if "opening_angle" in l:
            entry["opening_angle"] = float(np.deg2rad(l["opening_angle"]))
        if "penumbra_angle" in l:
            entry["penumbra_angle"] = float(np.deg2rad(l["penumbra_angle"]))
        scene.lights.append(entry)

    # ---- cameras ----
    active = doc.get("active_camera")
    for cam in doc.get("cameras", []):
        if active is not None and cam.get("name") != active:
            continue
        depth_range = cam.get("depth_range", (0.1, 1000.0))
        scene.camera = make_camera(
            pos=cam.get("pos", (0, 0, -5)),
            target=cam.get("target", (0, 0, 0)),
            up=cam.get("up", (0, 1, 0)),
            focal_length=float(cam.get("focal_length", 21.0)),
            aspect=float(cam.get("aspect_ratio", 16.0 / 9.0)),
            near_z=float(depth_range[0]),
            far_z=float(depth_range[1]),
        )
        break

    # ---- paths ----
    # route by attached_objects (SceneImporter.cpp:776): camera attachments
    # (or none — legacy default) drive the camera, the rest animate objects
    for p in doc.get("paths", []):
        parsed = animation.path_from_dict(p)
        kinds = {k for k, _ in parsed.attached}
        if not parsed.attached or "camera" in kinds:
            scene.camera_paths.append(parsed)
        if kinds - {"camera"}:
            scene.object_paths.append(parsed)

    # ---- user-defined: env map ----
    # The reference manages env maps as user content through the
    # ResourceManager / RenderingPipeline env-map UI (ResourceManager.cpp:
    # 77-111, RenderingPipeline.cpp:70-117); .fscene has no standard key, so
    # we read it from the user_defined dict (the v2 extension point,
    # SceneImporter.cpp:1124) as a path relative to the scene file.
    ud = doc.get("user_defined", {})
    env_file = ud.get("env_map") if isinstance(ud, dict) else None
    if env_file:
        scene.env_map = read_image(os.path.join(base, env_file))
        scene.env_map_file = env_file

    scene.apply_default_fixups()
    return scene


def save_fscene(scene: Scene, path: str) -> None:
    """.fscene (v2 JSON) writer, the SceneExporter analogue (Falcor
    Graphics/Scene/SceneExporter.cpp).  A scene's meshes are written as
    an OBJ + MTL sidecar referenced by a single identity-instanced model
    entry (the reference references its source FBX), so save ->
    load_fscene round trips the scene: geometry to save_obj's 6 decimals,
    the camera paths, not the object paths."""
    base = os.path.dirname(os.path.abspath(path))
    os.makedirs(base, exist_ok=True)
    stem = os.path.splitext(os.path.basename(path))[0]
    doc: dict = {
        "version": 2,
        "camera_speed": float(scene.camera_speed),
        "lighting_scale": float(scene.lighting_scale),
        "active_camera": "Camera0",
    }

    if scene.meshes:
        obj_name = stem + ".obj"
        save_obj(os.path.join(base, obj_name), scene.meshes, scene.materials)
        doc["models"] = [
            {
                "file": obj_name,
                "name": stem,
                "instances": [
                    {
                        "name": stem + "0",
                        "translation": [0.0, 0.0, 0.0],
                        "scaling": [1.0, 1.0, 1.0],
                        "rotation": [0.0, 0.0, 0.0],
                    }
                ],
            }
        ]

    lights = []
    for l in scene.lights:
        is_dir = l.get("type") == "dir"
        entry: dict = {
            "name": f"{'dirLight' if is_dir else 'pointLight'}{len(lights)}",
            "type": "dir_light" if is_dir else "point_light",
            "intensity": [float(x) for x in l.get("intensity", (1, 1, 1))],
            "direction": [float(x) for x in l.get("dir", (0, -1, 0))],
        }
        if not is_dir:
            entry["pos"] = [float(x) for x in l.get("pos", (0, 0, 0))]
            entry["opening_angle"] = float(
                np.rad2deg(l.get("opening_angle", np.pi))
            )
            entry["penumbra_angle"] = float(
                np.rad2deg(l.get("penumbra_angle", 0.0))
            )
        lights.append(entry)
    doc["lights"] = lights

    if scene.camera is not None:
        cam = scene.camera
        doc["cameras"] = [
            {
                "name": "Camera0",
                "pos": [float(x) for x in np.asarray(cam.pos_w)],
                "target": [float(x) for x in np.asarray(cam.target)],
                "up": [float(x) for x in np.asarray(cam.up)],
                "focal_length": float(cam.focal_length),
                "depth_range": [float(cam.near_z), float(cam.far_z)],
                "aspect_ratio": float(cam.aspect),
            }
        ]

    if scene.camera_paths:
        doc["paths"] = [
            {
                "name": p.name,
                "loop": bool(p.loop),
                "attached_objects": [
                    {"type": "camera", "name": "Camera0"}
                ],
                "frames": [
                    {
                        "time": float(f.time),
                        "pos": [float(x) for x in f.pos],
                        "target": [float(x) for x in f.target],
                        "up": [float(x) for x in f.up],
                    }
                    for f in p.frames
                ],
            }
            for p in scene.camera_paths
        ]

    if getattr(scene, "env_map_file", None):
        doc["user_defined"] = {"env_map": scene.env_map_file}

    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
