"""Load a configuration and build its scene.

`load_config(name)` reads `configs/<name>.json`; `load_arrays(cfg)` builds
the plain dict both sides start from: the meshes, float32 as a bake takes
them, and the configuration's materials, lights and camera.  The meshes
come from one of two keys:

- `quads`: the scene inline, one mesh a quad (two triangles, the normal
  from its winding);
- `geometry`: `{"builder": "<name>", ...params}`, a builder found by name,
  `geometry/<name>.py`, whose `build(params)` (the dict without `builder`)
  returns the meshes as a deterministic function of the parameters, each
  a dict of `positions` [n, 3], `normals` [n, 3], `uvs` [n, 2], `indices`
  [k, 3], `material` and `name`.  A builder imports only what
  `BUILDER_IMPORTS` names, so both sides start from data that nothing of
  the port has prepared.

`port_scene(arrays)` makes of the dict the port's `BuiltScene`, which the
harness hands to `Scene.from_built`; the reference (`reference/scene.py`)
reads the same dict.
"""
from __future__ import annotations

import ast
import importlib.util
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


BUILDER_IMPORTS = {"__future__", "math", "numpy"}


def builder_imports(path: str) -> set[str]:
    """The top-level names a builder's source imports, with `.` for a
    relative import and `__import__` for a call of it."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0] if node.level == 0 and node.module else ".")
        elif isinstance(node, ast.Name) and node.id == "__import__":
            names.add(node.id)
    return names


def built_meshes(geometry: dict) -> list[dict]:
    """The meshes of `geometry/<builder>.py`'s `build(params)`."""
    name = geometry["builder"]
    path = os.path.join(HERE, "geometry", f"{name}.py")
    if os.path.dirname(os.path.relpath(path, HERE)) != "geometry":
        raise ValueError(f"geometry builder {name!r} is not a file of geometry/")
    if builder_imports(path) - BUILDER_IMPORTS:
        raise ValueError(f"geometry/{name}.py imports {sorted(builder_imports(path))}; "
                         f"a builder imports only {sorted(BUILDER_IMPORTS)}")
    spec = importlib.util.spec_from_file_location("portbench_geometry_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    params = {k: v for k, v in geometry.items() if k != "builder"}
    return [{"positions": np.asarray(m["positions"], np.float32).reshape(-1, 3),
             "normals": np.asarray(m["normals"], np.float32).reshape(-1, 3),
             "uvs": np.asarray(m["uvs"], np.float32).reshape(-1, 2),
             "indices": np.asarray(m["indices"], np.int32).reshape(-1, 3),
             "material": int(m["material"]), "name": str(m.get("name", ""))}
            for m in module.build(params)]


def load_arrays(cfg: dict) -> dict:
    if "geometry" in cfg:
        if "quads" in cfg:
            raise ValueError(f"configuration {cfg.get('name')!r} gives both quads and geometry")
        meshes = built_meshes(cfg["geometry"])
    else:
        meshes = [quad_mesh(q["corners"], q["material"], q.get("name", ""))
                  for q in cfg["quads"]]
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
