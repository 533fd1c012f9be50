"""The port imports nothing of JAX, nothing of the JAX package and no PIL
(which the machine with the card lacks): neither in its source (a static
check of every import statement) nor at run time (a subprocess that
refuses those imports renders the Cornell box through both paths and with
the BMFR denoiser on, pink_room built from a folder of PNG and JPEG
textures under its names, which it decodes, not checkerboards (its
incoherent batches walked in the order of
ops/raysort.py, whose functions it also calls) and the textured room
through the deferred-texture megakernel with both splat kernels' plain versions, the alpha panel scene
(the restarts), an env-mapped normal-mapped Cornell box with a tone map
and the probe-lit pass, runs the fused subpath builder, imports every
module of the entry point (app, image I/O, golden harness, checkpoint,
profiler, video) and runs the CLI at 16x16 with a PNG env map, --probe,
--profile and --checkpoint, and the output passes and a GIF, and the scene
I/O and animation modules: an .obj with a PNG texture, an .fbx, an
.fscene animated and exported, a camera controller and skinning), and the
row sharding of parallel/ on two CPU ranks, each refusing those imports."""
import ast
import os
import subprocess
import sys
from pathlib import Path
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "fyp_bidirectionalpathtracer_tpu_torch"
JAX_PACKAGE = "fyp_bidirectionalpathtracer_tpu"
FORBIDDEN = ("jax", "flax", "jaxlib", JAX_PACKAGE, "PIL")
REFUSED_AT_RUN_TIME = FORBIDDEN


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_nothing_of_jax():
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                      for n in names if _forbidden(n)]
    assert len(_port_sources()) > 30
    assert not found, found


_BLOCKED_RUN = f"""
import importlib.abc
import sys

FORBIDDEN = {REFUSED_AT_RUN_TIME!r}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("refused: " + name)
        return None


sys.meta_path.insert(0, Refuse())
from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
    BDPTConfig,
    BMFRConfig,
    RenderConfig,
)

baked = Scene.from_built(cornell_box(), aspect=1.0).bake(device="cpu")
for mk in ("on", "off"):
    out = Renderer(baked, RenderConfig(width=16, height=16,
                                       bdpt=BDPTConfig(megakernel=mk))).render_frame()
    assert tuple(out.shape) == (16, 16, 4) and bool(out.isfinite().all()), mk
    print(mk, "ok")
bmfr = BMFRConfig(enabled=True, regression=True, half_screen_debug=False)
out = Renderer(baked, RenderConfig(width=16, height=16, bmfr=bmfr)).render_frame()
assert tuple(out.shape) == (16, 16, 4) and bool(out.isfinite().all())
print("bmfr", "ok")
import shutil
import tempfile
import numpy as np
from fyp_bidirectionalpathtracer_tpu_torch.models import pink_room as pink_mod
from fyp_bidirectionalpathtracer_tpu_torch.utils import image
names = []
real_loader = pink_mod._load_texture
pink_mod._load_texture = lambda d, name, fallback: names.append(name) or fallback
stand_in = pink_room(asset_dir="")
pink_mod._load_texture = real_loader
tex_dir = tempfile.mkdtemp()
jpegs = iter(["baseline_420.jpg", "progressive_420.jpg"])
for i, name in enumerate(names):
    if name.endswith(".jpg"):
        shutil.copy("tests/torch_images/" + next(jpegs), tex_dir + "/" + name)
    else:
        pixels = np.random.RandomState(i).uniform(0, 1, (8 + i, 12, 3))
        image.write_png(tex_dir + "/" + name, pixels)
built = pink_room(asset_dir=tex_dir)
kinds = ("base_color_image", "specular_image", "emissive_image")
maps = [getattr(m, f) for m in built.materials for f in kinds if getattr(m, f) is not None]
assert len(maps) == len(names) and not any(m.shape == (64, 64, 4) for m in maps)
assert np.array_equal(built.materials[12].base_color_image,
                      image.read_rgba(tex_dir + "/Abstract.jpg"))
assert (built.materials[12].base_color_image.shape
        != stand_in.materials[12].base_color_image.shape)
room = Scene.from_built(built, aspect=1.6).bake(device="cpu")
out = Renderer(room, RenderConfig(width=16, height=10)).render_frame()
assert tuple(out.shape) == (10, 16, 4) and bool(out.isfinite().all())
print("pink_room", "ok")
import torch
from fyp_bidirectionalpathtracer_tpu_torch.ops import raysort
o = torch.rand(64, 3) * 4.0 - 2.0
d = torch.nn.functional.normalize(torch.randn(64, 3), dim=-1)
order = raysort.sort_order(o, d, 1e-3, torch.rand(64), room.sort_bounds)
assert sorted(order.tolist()) == list(range(64))
assert raysort.ray_sort_keys(o, d, *raysort.scene_bounds(room.tris)).dtype == torch.int32
hit = room.intersector()(o, d, 1e-3, torch.rand(64) * 5.0, closest=False, coherent=False)
assert tuple(hit.t.shape) == (64,)
print("raysort", "ok")
import torch
from fyp_bidirectionalpathtracer_tpu_torch.accel.subpath import build_subpath
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import textured_room
tex = Scene.from_built(textured_room(), aspect=1.0).bake(device="cpu")
for mode in ("auto", "tiled"):
    cfg = RenderConfig(width=16, height=16, bdpt=BDPTConfig(defer_textures=True, splat_mode=mode))
    out = Renderer(tex, cfg).render_frame()
    assert tuple(out.shape) == (16, 16, 4) and bool(out.isfinite().all()), mode
print("textured", "ok")
n = 64
verts, final = build_subpath(baked.tri_pack, baked.n_tris, torch.full((n, 3), 0.5),
                             torch.nn.functional.normalize(torch.randn(n, 3), dim=-1),
                             torch.ones(n, 3), torch.arange(n), torch.zeros(n, dtype=torch.bool),
                             1e-3, 2, 0, False)
assert len(verts) == 2 and bool(verts[0]["hit"].any()) and final["seed"].shape == (n,)
print("subpath", "ok")
import numpy as np
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import alpha_panel_scene
from fyp_bidirectionalpathtracer_tpu_torch.ops.lightprobe import LightProbe
from fyp_bidirectionalpathtracer_tpu_torch.passes.extras import probe_lit_pass
panel = Scene.from_built(alpha_panel_scene(), aspect=1.0).bake(device="cpu")
out = Renderer(panel, RenderConfig(width=16, height=16)).render_frame()
assert panel.has_alpha and bool(out.isfinite().all())
print("alpha", "ok")
built = cornell_box()
built.materials[0].normal_map_image = np.tile(np.float32([0.6, 0.5, 1.0, 1.0]), (8, 8, 1))
env_scene = Scene.from_built(built, aspect=1.0)
env_scene.env_map = np.random.RandomState(0).uniform(0, 1, (16, 32, 4)).astype(np.float32)
lit = env_scene.bake(device="cpu")
r = Renderer(lit, RenderConfig(width=16, height=16, tone_map_operator="aces"))
r.render_frame()
assert lit.has_normal_maps and bool(r.display().isfinite().all())
probe = LightProbe(lit.env_map, diff_samples=16, spec_samples=8, diff_size=4, spec_size=4,
                   spec_mips=2)
assert bool(probe_lit_pass(lit, lit.intersector(), r.channels, probe).isfinite().all())
print("env", "ok")
import contextlib
import io
import tempfile
from fyp_bidirectionalpathtracer_tpu_torch.passes import extras
from fyp_bidirectionalpathtracer_tpu_torch.pipeline import app
from fyp_bidirectionalpathtracer_tpu_torch.utils import checkpoint, image, profiler, testing, video
out = tempfile.mkdtemp()
image.write_png(out + "/env.png", np.random.RandomState(1).uniform(0, 1, (8, 16, 3)))
with contextlib.redirect_stdout(io.StringIO()):
    res = app.main(["--width", "16", "--height", "16", "--frames", "2", "--envmap",
                    out + "/env.png", "--probe", "--profile", "--checkpoint", out + "/ck",
                    "--outputdir", out], device="cpu")
assert image.read_png(res["probe_lit"]).shape == (16, 16, 3)
for name in ("ambient_occlusion_pass", "lambertian_shadows_pass", "diffuse_gi_pass"):
    img = getattr(extras, name)(lit, lit.intersector(), r.channels, 0)
    assert bool(img.isfinite().all()), name
rec = video.VideoRecorder()
rec.add_frame(r.display())
assert rec.save(out + "/clip.gif").endswith(".gif")
print("app", "ok")
from fyp_bidirectionalpathtracer_tpu_torch.models import fbx, obj
from fyp_bidirectionalpathtracer_tpu_torch.ops.skinning import bone_matrices, skin_vertices
from fyp_bidirectionalpathtracer_tpu_torch.scene import animation, controllers, fscene
tex = np.random.RandomState(2).uniform(0, 1, (8, 8, 3))
image.write_png(out + "/tex.png", tex)
with open(out + "/quad.mtl", "w") as fh:
    fh.write("newmtl m\\nKd 0.5 0.5 0.5\\nmap_Kd tex.png\\n")
with open(out + "/quad.obj", "w") as fh:
    fh.write("mtllib quad.mtl\\nv 0 0 0\\nv 1 0 0\\nv 1 1 0\\nv 0 1 0\\nvt 0 0\\nvt 1 0\\n"
             "vt 1 1\\nvt 0 1\\nusemtl m\\nf 1/1 2/2 3/3 4/4\\n")
meshes, mats = obj.load_obj(out + "/quad.obj")
assert mats[1].base_color_image.shape == (8, 8, 4) and len(meshes[0].indices) == 2
fbx.save_fbx(out + "/quad.fbx", meshes, mats, version=7500)
assert len(fbx.load_fbx(out + "/quad.fbx")[0]) == 1
import json
frames = [dict(time=0.0, pos=[0.5, 0.5, 2.0], target=[0.5, 0.5, 0.0]),
          dict(time=1.0, pos=[0.6, 0.5, 2.0], target=[0.5, 0.5, 0.0])]
attached = [dict(type="camera"), dict(type="model_instance", name="q")]
with open(out + "/s.fscene", "w") as fh:
    json.dump(dict(version=2, models=[dict(file="quad.obj", instances=[dict(name="q")]),
                                      dict(file="quad.fbx")],
                   paths=[dict(loop=True, attached_objects=attached, frames=frames)]), fh)
anim = Renderer(fscene.load_fscene(out + "/s.fscene").bake(device="cpu"),
                RenderConfig(width=16, height=16))
anim.animate(0.25)
assert bool(anim.render_frame().isfinite().all()) and anim.state.time == 0.25
fscene.save_fscene(anim.baked.host, out + "/export/s.fscene")
cam, _ = controllers.OrbitCameraController().update(anim.camera)
pos, _ = skin_vertices(torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4, 1, dtype=torch.int32),
                       torch.ones(4, 1), bone_matrices(torch.eye(3)[None], torch.ones(1, 3)))
assert bool((pos == 1).all()) and animation.Path().duration == 0.0
print("io", "ok")
assert not [m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
"""


def test_port_renders_with_jax_imports_refused():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["on", "ok", "off", "ok", "bmfr", "ok", "pink_room", "ok",
                                   "raysort", "ok", "textured", "ok", "subpath", "ok",
                                   "alpha", "ok", "env", "ok", "app", "ok", "io", "ok"], proc.stdout


_SHARDED_RUN = f"""
import importlib.abc
import sys

FORBIDDEN = {REFUSED_AT_RUN_TIME!r}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("refused: " + name)
        return None


# at the top level, so every spawned rank, which imports this file first,
# refuses them too
sys.meta_path.insert(0, Refuse())


def forbidden_loaded():
    return [m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]


def rank_fn(rank, mesh):
    from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
        BDPTConfig, BMFRConfig, RenderConfig)

    baked = Scene.from_built(cornell_box(), aspect=0.25).bake(device="cpu")
    for mk, bmfr in (("on", False), ("off", False), ("on", True)):
        cfg = RenderConfig(width=16, height=64, bdpt=BDPTConfig(megakernel=mk),
                           bmfr=BMFRConfig(enabled=bmfr, regression=bmfr))
        out = Renderer(baked, cfg, mesh=mesh).render_frame()
        assert out.shape == (32, 16, 4) and bool(out.isfinite().all())
    assert not forbidden_loaded()
    return "rank" + str(rank)


if __name__ == "__main__":
    import contextlib
    import io

    from fyp_bidirectionalpathtracer_tpu_torch.parallel import sharding
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline import app

    print(*sharding.launch(rank_fn, 2, device="cpu"))
    with contextlib.redirect_stdout(io.StringIO()):
        res = app.main(["--width", "16", "--height", "16", "--frames", "1", "--shard", "2",
                        "--outputdir", sys.argv[1]], device="cpu")
    assert len(res["frame_times"]) == 1
    assert not forbidden_loaded()
    print("app", "ok")
"""


def test_sharded_port_with_jax_imports_refused(tmp_path):
    """Row sharding (parallel/) on two CPU ranks, every rank refusing JAX,
    the JAX package and PIL as the run above does: Renderer(mesh=) on the
    megakernel, wavefront and BMFR-on routes, and app.main --shard 2."""
    script = tmp_path / "sharded_run.py"
    script.write_text(_SHARDED_RUN)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "out")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["rank0", "rank1", "app", "ok"], proc.stdout
