"""The harness finds a configuration, a traffic mix, a metric and a limit
by the names a cell gives, with no edit to a file that is there: a
throwaway copy of the benchmark's data folders gains one file of each, and
a run of the new cell reads them.  The configuration is the Cornell box
again; or the box from a geometry builder of its own, each quad cut into
a grid, more triangles than the megakernel takes, so the port renders it
on the wavefront route.  A builder that imports anything but what
`scenes.BUILDER_IMPORTS` names is refused."""
import json
import os
import shutil

import pytest

import check
import run
import scenes
import traffic
from traffic import load_traffic

from fyp_bidirectionalpathtracer_tpu_torch.accel.frame import MAX_TRIS, supports_megakernel
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene as PortScene
from fyp_bidirectionalpathtracer_tpu_torch.utils import config as port_config

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (32, 18)
GRID_BOX = '''"""The quads of `quads`, each cut into cells x cells quads of two triangles."""
import numpy as np


def build(params):
    n = int(params["cells"])
    s = np.linspace(0.0, 1.0, n + 1)
    meshes = []
    for q in params["quads"]:
        p = np.asarray(q["corners"], np.float64)
        a = p[0] + s[:, None, None] * (p[1] - p[0])            # along the first side
        b = p[3] + s[:, None, None] * (p[2] - p[3])
        grid = (a + s[None, :, None] * (b - a)).reshape(-1, 3)  # [(n + 1)^2, 3]
        k = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
        c0, c1, c2, c3 = k, k + n + 1, k + n + 2, k + 1
        idx = np.stack([np.stack([c0, c1, c2], -1), np.stack([c0, c2, c3], -1)], 2)
        normal = np.cross(p[1] - p[0], p[3] - p[0])
        normal = normal / np.linalg.norm(normal)
        meshes.append({"positions": grid, "normals": np.tile(normal, (grid.shape[0], 1)),
                       "uvs": np.zeros((grid.shape[0], 2)), "indices": idx.reshape(-1, 3),
                       "material": q["material"], "name": q.get("name", "")})
    return meshes
'''


def _box(tmp_path, case):
    """The case's configuration `box_<case>` in the throwaway folder."""
    cfg = json.loads((tmp_path / "configs" / "cornell.json").read_text())
    cfg["name"] = f"box_{case}"
    if case == "grid":
        (tmp_path / "geometry").mkdir()
        (tmp_path / "geometry" / "grid_box.py").write_text(GRID_BOX)
        cfg["geometry"] = {"builder": "grid_box", "cells": 8, "quads": cfg.pop("quads")}
    (tmp_path / "configs" / f"box_{case}.json").write_text(json.dumps(cfg))
    return cfg


@pytest.mark.parametrize("case", ["copy", "grid"])
def test_a_new_cell_is_found_by_name(case, tmp_path, monkeypatch):
    for folder in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(PORTBENCH, folder), tmp_path / folder)
    cfg = _box(tmp_path, case)
    mix = json.loads((tmp_path / "traffic" / "progressive.json").read_text())
    mix.update(name="short_views", frames_per_view=4)
    (tmp_path / "traffic" / "short_views.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "frames_done.py").write_text(
        '"""frames_done: frames in the window."""\n\n\ndef read(ctx):\n    return ctx.frames\n')
    workload = f"box_{case}.short_views"
    (tmp_path / "limits" / f"{workload}.json").write_text(
        json.dumps({"accum_px": 0.01, "accum_mad": 0.001}))
    for module in (run, scenes, traffic, check):
        monkeypatch.setattr(module, "HERE", str(tmp_path))
    with open(os.path.join(os.path.dirname(PORTBENCH), "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": cfg["name"], "source": "-", "why": "-", "reduced": [],
                                "file": f"portbench/configs/{cfg['name']}.json"})
    manifest["workloads"].append({"name": workload, "config": cfg["name"],
                                  "traffic": "short_views", "chips": 1, "why": "-"})
    manifest["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                   "bound": 0.1, "source": "host_clock",
                                   "workloads": [workload]})
    seconds = 10.0 if case == "grid" else 1.0   # the wavefront on the CPU: ~1 s a frame
    result, _ = run.run(workload, 11, seconds, False, device="cpu", size=SIZE, manifest=manifest)
    assert result["metrics"]["frames_done"]["value"] == result["attempted"] > 4
    assert result["correct"], result["check"]
    if case == "grid":
        arrays = scenes.load_arrays(scenes.load_config(cfg["name"]))
        baked = PortScene.from_built(scenes.port_scene(arrays), aspect=SIZE[0] / SIZE[1]).bake(
            device="cpu")
        rc = run.render_config(port_config, cfg, load_traffic("short_views"), *SIZE)
        assert baked.n_tris == 17 * 8 * 8 * 2 > MAX_TRIS
        assert not supports_megakernel(baked, rc)


@pytest.mark.parametrize("source", [
    "from fyp_bidirectionalpathtracer_tpu_torch.models import procedural\n",
    "import numpy as np\nimport torch\n",
    "from . import grid_box\n",
    "np = __import__('numpy')\n",
])
def test_a_builder_that_imports_more_is_refused(source, tmp_path, monkeypatch):
    (tmp_path / "geometry").mkdir()
    (tmp_path / "geometry" / "grid_box.py").write_text(GRID_BOX)
    (tmp_path / "geometry" / "leaky.py").write_text(source + "\n\ndef build(params):\n    return []\n")
    monkeypatch.setattr(scenes, "HERE", str(tmp_path))
    assert scenes.builder_imports(str(tmp_path / "geometry" / "grid_box.py")) <= \
        scenes.BUILDER_IMPORTS
    for name in ("leaky", "../geometry/leaky", "sub/leaky"):
        with pytest.raises(ValueError):
            scenes.built_meshes({"builder": name})
