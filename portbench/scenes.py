"""Load a configuration and build its scene.

`load_config(name)` reads `configs/<name>.json`; `load_arrays(cfg)` builds
from its `quads` the plain dict both sides start from: one mesh a quad
(two triangles, the normal from its winding, float32 as a bake takes
them), its materials, lights and camera.  `port_scene(arrays)` makes of it
the port's `BuiltScene`, which the harness hands to `Scene.from_built`;
the reference (`reference/scene.py`) reads the same dict.
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
UVS = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
QUAD = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def quad_mesh(corners, material: int, name: str = "") -> dict:
    p = np.asarray(corners, np.float32)
    n = np.cross(p[1] - p[0], p[3] - p[0])
    n = (n / (np.linalg.norm(n) + 1e-20)).astype(np.float32)
    return {"positions": p, "normals": np.tile(n, (4, 1)), "uvs": UVS.copy(),
            "indices": QUAD.copy(), "material": int(material), "name": name}


def load_arrays(cfg: dict) -> dict:
    meshes = [quad_mesh(q["corners"], q["material"], q.get("name", "")) for q in cfg["quads"]]
    return {"meshes": meshes, "materials": [dict(m) for m in cfg["materials"]],
            "lights": cfg["lights"], "camera": cfg["camera"]}


def port_scene(arrays: dict):
    """The port's BuiltScene of the configuration's arrays."""
    from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import (
        BuiltScene,
        MaterialDesc,
        MeshData,
    )

    built = BuiltScene()
    built.meshes = [MeshData(positions=m["positions"], normals=m["normals"], uvs=m["uvs"],
                             indices=m["indices"], material=m["material"], name=m["name"])
                    for m in arrays["meshes"]]
    built.materials = [MaterialDesc(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in m.items()}) for m in arrays["materials"]]
    built.lights = [{k: tuple(v) if isinstance(v, list) else v for k, v in light.items()}
                    for light in arrays["lights"]]
    built.camera = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in arrays["camera"].items()}
    return built
