"""The port's fused subpath builder (K6's plain version behind
`accel/subpath.build_subpath`) against the JAX package on the CPU.

The reference is JAX `accel/pallas_subpath.build_subpath`, whose Pallas
kernel runs in interpret mode: on the 2-triangle floor of
tests/test_subpath_kernel.py, two bounces with `mat_model` 0 and 1 and
`faithful_rng` off and on, and on the Cornell box (34 triangles), one
bounce (its interpret-mode compile unrolls every triangle and takes ~90 s
a bounce on the CPU).  Both packages read the same baked arrays
(the port's parameter carry) and seeds.  Bounds: the vertex fields within
atol 5e-4 on the lanes active before each bounce (the JAX test's bound);
`hit`, `take`, the final `terminated` and `seed` exact.

As in tests/test_subpath_kernel.py, the port's kernel is also held against
the port's own per-bounce path (`passes/bdpt.shoot_ray` over the shaded
tracer), whose hit test differs (K6 has no back-face cull) but agrees on
the floor.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.accel.pallas_shaded import pack_shaded_triangles
from fyp_bidirectionalpathtracer_tpu.accel.pallas_subpath import build_subpath as jbuild_subpath
from fyp_bidirectionalpathtracer_tpu.core import rng as jrng
from fyp_bidirectionalpathtracer_tpu.models import procedural as jprocedural
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.accel import subpath
from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu_torch.passes import bdpt as bdpt_mod
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig
from test_torch_textured import jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

FIELDS = ("color", "pos", "n", "v", "dif", "spec", "rough", "pdf")
EXACT = ("hit", "take", "is_spec")


def _floor():
    floor = jprocedural.quad((-5, 0, -5), (-5, 0, 5), (5, 0, 5), (5, 0, -5), 0)
    return JScene(meshes=[floor],
                  materials=[jprocedural.MaterialDesc(base_color=(0.6, 0.5, 0.4, 1.0),
                                                      specular=(0.2, 0.2, 0.2, 0.7))],
                  lights=[{"type": "point", "pos": (0, 3, 0), "intensity": (5, 5, 5)}])


SCENES = {"floor": _floor, "cornell": lambda: JScene.from_built(jprocedural.cornell_box())}


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX bake, the port's bake of JAX's arrays, rays)."""
    jb = SCENES[name]().bake()
    pb = baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")
    n = 256
    rs = np.random.RandomState(0)
    if name == "floor":
        o = rs.uniform([-2, 1, -2], [2, 3, 2], (n, 3)).astype(np.float32)
        d = rs.normal(size=(n, 3)).astype(np.float32)
        d[:, 1] = -np.abs(d[:, 1])  # most rays hit the floor
    else:  # inside the box, every direction: some rays escape, some start in a block
        o = rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
        d = rs.normal(size=(n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    seed = np.asarray(jrng.tea_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(5)))
    term = rs.rand(n) < 0.1  # lanes inactive from the start: take 1, rows 0
    color = rs.uniform(0.5, 1.0, (n, 3)).astype(np.float32)
    return jb, pb, (o, d, color, seed, term)


@pytest.mark.parametrize("name", list(SCENES))
def test_tri_pack_is_jax_pack_transposed(name):
    """build_subpath's [T_pad, 48] pack is JAX's pack_shaded_triangles, the
    kernel's `tri_pack.T`, on the rows of the scene's triangles."""
    jb, pb, _ = _scene(name)
    want = np.asarray(pack_shaded_triangles(jb.tris, jb.data.materials)).T
    np.testing.assert_array_equal(pb.tri_pack[:pb.n_tris].numpy(), want[:pb.n_tris])


def _compare(got, want, active_per_bounce):
    for b, (gv, wv) in enumerate(zip(got[0], want[0])):
        act = active_per_bounce[b]
        for name in EXACT:
            np.testing.assert_array_equal(gv[name].numpy(), np.asarray(wv[name]),
                                          err_msg=f"bounce {b} {name}")
        for name in FIELDS:
            g = np.nan_to_num(gv[name].numpy()[act], nan=-7.0)
            w = np.nan_to_num(np.asarray(wv[name])[act], nan=-7.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-4, err_msg=f"bounce {b} {name}")
    np.testing.assert_array_equal(got[1]["terminated"].numpy(),
                                  np.asarray(want[1]["terminated"]))
    np.testing.assert_array_equal(got[1]["seed"].numpy(),
                                  np.asarray(want[1]["seed"]).astype(np.int64))


# (scene, mat_model, faithful_rng, bounces)
CASES = [("floor", 0, False, 2), ("floor", 1, False, 2), ("floor", 0, True, 2),
         ("floor", 1, True, 2), ("cornell", 0, False, 1)]


@pytest.mark.parametrize("name,mat_model,faithful,n_bounces", CASES,
                         ids=[f"{s}-{'lambertian' if m else 'ggx'}{'-faithful' if f else ''}-b{b}"
                              for s, m, f, b in CASES])
def test_build_subpath_matches_jax(name, mat_model, faithful, n_bounces):
    jb, pb, (o, d, color, seed, term) = _scene(name)
    want = jbuild_subpath(pack_shaded_triangles(jb.tris, jb.data.materials), pb.n_tris,
                          jnp.asarray(o), jnp.asarray(d), jnp.asarray(color),
                          jnp.asarray(seed, jnp.uint32), jnp.asarray(term), 1e-3, n_bounces,
                          mat_model, faithful, interpret=True)
    cuda.reset_launch_counts()
    got = subpath.build_subpath(pb.tri_pack, pb.n_tris, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(color),
                                torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(term),
                                1e-3, n_bounces, mat_model, faithful)
    assert cuda.LAUNCHES["subpath"] == 0  # CPU tensors: the plain version
    active = [~term]
    for b in range(1, n_bounces):
        active.append(active[-1] & np.asarray(want[0][b - 1]["take"]))
    _compare(got, want, active)
    hits = int(got[0][0]["hit"].sum())
    assert 0.3 * len(o) < hits < len(o)
    # inactive lanes: zero rows, take 1
    assert not bool(got[0][0]["color"][torch.from_numpy(term)].any())
    assert bool(got[0][0]["take"][torch.from_numpy(term)].all())


@pytest.mark.parametrize("mat_model", [0, 1])
def test_build_subpath_matches_shoot_ray(mat_model):
    """tests/test_subpath_kernel.py on the port: the floor, 64 rays, two
    bounces of `shoot_ray` over the fused shaded tracer."""
    pb = _scene("floor")[1]
    cfg = BDPTConfig(mat_model=mat_model)
    trace = make_shaded_tracer(pb, force_fused=True)
    n = 64
    rs = np.random.RandomState(0)
    o0 = torch.from_numpy(rs.uniform([-2, 1, -2], [2, 3, 2], (n, 3)).astype(np.float32))
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d0 = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    seeds = torch.from_numpy(
        np.asarray(jrng.tea_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(5))).astype(np.int64))
    color0 = torch.ones((n, 3))
    payload = bdpt_mod.init_payload(o0, d0, color0, seeds)
    ref = []
    for _ in range(2):
        was_active = ~payload.terminated
        payload = bdpt_mod.shoot_ray(payload, trace, cfg)
        ref.append((payload.vertex(), was_active))
    verts, final = subpath.build_subpath(pb.tri_pack, pb.n_tris, o0, d0, color0, seeds,
                                         torch.zeros(n, dtype=torch.bool), cfg.min_t, 2,
                                         mat_model, cfg.faithful_rng)
    for b, (rv, was_active) in enumerate(ref):
        for name in ("color", "pos", "n", "dif", "spec"):
            a = torch.nan_to_num(getattr(rv, name)[was_active], nan=-7.0)
            k = torch.nan_to_num(verts[b][name][was_active], nan=-7.0)
            torch.testing.assert_close(k, a, rtol=0, atol=5e-4, msg=f"bounce{b}.{name}")
    assert torch.equal(payload.terminated, final["terminated"])
    assert torch.equal(payload.seed, final["seed"])


def test_subpath_kernel_checks():
    """The wrapper refuses what the kernel cannot take: a bad state shape,
    more triangles than fit in shared memory, no bounce."""
    pb = _scene("floor")[1]
    state = torch.zeros((subpath.STATE_ROWS, 8))
    with pytest.raises(ValueError):
        subpath.subpath_kernel(state[:11], pb.tri_pack, pb.n_tris, 1, 0, False)
    with pytest.raises(ValueError):
        subpath.subpath_kernel(state, pb.tri_pack, 4096, 1, 0, False)
    with pytest.raises(ValueError):
        subpath.subpath_kernel(state, pb.tri_pack, pb.n_tris, 0, 0, False)
    verts, final = subpath.subpath_kernel(state, pb.tri_pack, pb.n_tris, 3, 0, False)
    assert verts.shape == (3 * subpath.VERT_ROWS, 8) and final.shape == state.shape
