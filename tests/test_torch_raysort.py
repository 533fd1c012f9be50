"""Ray sorting (ops/raysort.py) against the JAX package's on the CPU, and
the BVH tier's sorted batches against its unsorted ones.

The keys, the permutation and the bounds are integer or exact float work,
so they are held bit for bit: on seeded rays with dead lanes (t_max <=
t_min), axis-aligned and negative-zero directions, origins outside the
scene's box, and non-finite lanes (JAX's float -> int32 conversion
saturates and sends NaN to 0, which the port repeats).  On pink_room's bake
(10,546 triangles, the BVH tier; the wrappers run their plain versions on
the CPU) a shaded trace, a gather-branch trace and any-hit and closest
batches with `coherent=False` walk the rays in the sorted order and are
bit-equal to `coherent=True`.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box as jcornell_box
from fyp_bidirectionalpathtracer_tpu.ops import raysort as jraysort
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.accel import cluster
from fyp_bidirectionalpathtracer_tpu_torch.accel.traverse import make_intersector
from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room
from fyp_bidirectionalpathtracer_tpu_torch.ops import raysort
from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import camera_ray_dirs
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

LO = np.float32([-1.0, -0.5, -2.0])
HI = np.float32([3.0, 2.5, 1.0])


def _rays(n=4096, seed=3):
    """Origins over and beyond [LO, HI], unit and unnormalized directions,
    with axis-aligned, negative-zero, infinite and NaN lanes; t_max with
    dead lanes (t_max <= t_min, equal included)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(LO - 0.5, HI + 0.5, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] /= np.linalg.norm(d[: n // 2], axis=1, keepdims=True)
    d[0:60:3] = [1.0, 0.0, 0.0]
    d[1:60:3] = [0.0, -1.0, 0.0]
    d[2:60:3] = [0.0, 0.0, 1.0]
    d[60:120, 0] = -0.0
    d[120:180] = [-0.0, -0.0, -1.0]
    o[180:190, 1] = np.inf
    o[190:200, 2] = -np.inf
    o[200:210, 0] = np.nan
    d[210:220, 1] = np.nan
    o[220:230] = LO   # exactly on the box
    o[230:240] = HI
    t_min = rs.uniform(0.0, 1e-3, n).astype(np.float32)
    t_max = rs.uniform(0.0, 5.0, n).astype(np.float32)
    t_max[rs.rand(n) < 0.3] = 0.0
    t_max[300:340] = t_min[300:340]
    return o, d, t_min, t_max


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_spread4_matches_jax():
    x = np.arange(-40, 40, dtype=np.int32)
    np.testing.assert_array_equal(raysort._spread4(torch.from_numpy(x)).numpy(),
                                  np.asarray(jraysort._spread4(jnp.asarray(x))))


@pytest.mark.parametrize("kind", ["origin_major", "octant_major", "dirq"])
def test_sort_keys_match_jax(kind):
    o, d, _, _ = _rays()
    args_j = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(LO), jnp.asarray(HI))
    args_t = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(LO),
              torch.from_numpy(HI))
    if kind == "dirq":
        want = jraysort.ray_sort_keys_dirq(*args_j)
        got = raysort.ray_sort_keys_dirq(*args_t)
    else:
        major = kind == "octant_major"
        want = jraysort.ray_sort_keys(*args_j, octant_major=major)
        got = raysort.ray_sort_keys(*args_t, octant_major=major)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) >= 64  # the keys spread over many cells


def test_make_permutation_matches_jax():
    rs = np.random.RandomState(4)
    keys = rs.randint(0, 40, 5000).astype(np.int32)  # many ties
    keys[::9] = raysort.DEAD_KEY
    perm, inv = raysort.make_permutation(torch.from_numpy(keys))
    jperm, jinv = jraysort.make_permutation(jnp.asarray(keys))
    assert perm.dtype == inv.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_sort_order_is_jax_sort_wavefront_keys():
    """sort_order: JAX's `sort_wavefront` order (dirq keys, dead lanes
    0x7FFFFFFF when t_max is an array, ties in ray order); a scalar or
    absent t_max marks no lane dead."""
    o, d, t_min, t_max = _rays()
    bounds = torch.from_numpy(np.stack([LO, HI]))
    jkeys = jraysort.ray_sort_keys_dirq(jnp.asarray(o), jnp.asarray(d), jnp.asarray(LO),
                                        jnp.asarray(HI))
    dead = jnp.asarray(t_max) <= jnp.asarray(t_min)
    for tmax, keys in ((t_max, jnp.where(dead, jnp.int32(0x7FFFFFFF), jkeys)),
                       (None, jkeys), (np.float32(2.0), jkeys)):
        want = np.asarray(jraysort.make_permutation(keys)[0])
        tm = torch.from_numpy(np.asarray(tmax)) if tmax is not None else None
        got = raysort.sort_order(torch.from_numpy(o).reshape(64, 64, 3),
                                 torch.from_numpy(d).reshape(64, 64, 3),
                                 torch.from_numpy(t_min).reshape(64, 64),
                                 tm.reshape(64, 64) if tm is not None and tm.dim() else tm,
                                 bounds)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (t_max <= t_min).sum() > 1000


def test_scene_bounds_match_jax(pink):
    """On JAX's Cornell bake and its copy in the port, and on pink_room's
    triangles given to both functions."""
    jb = JScene.from_built(jcornell_box()).bake()
    from test_torch_wavefront import jax_scene_arrays

    pb = baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")
    for jt, pt in ((jb.tris, pb.tris),
                   (types.SimpleNamespace(**{k: jnp.asarray(getattr(pink.tris, k).numpy())
                                             for k in ("v0", "e1", "e2")}), pink.tris)):
        for g, w in zip(raysort.scene_bounds(pt), jraysort.scene_bounds(jt)):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w).view(np.int32))
    # the bake keeps them above 2048 triangles, for the BVH tier's sort
    assert pb.sort_bounds is None
    assert torch.equal(pink.sort_bounds, torch.stack(raysort.scene_bounds(pink.tris)))


@pytest.fixture(scope="module")
def pink():
    return Scene.from_built(pink_room(asset_dir=""), aspect=1.6).bake(device="cpu")


def _bounce_rays(baked, w=40, h=25):
    """Camera rays to the first hits, then scattered bounce directions from
    them: an incoherent batch (the misses' origins stay on the camera)."""
    d = camera_ray_dirs(baked.data.camera, w, h, torch.tensor([0.5, 0.5]))
    o = baked.data.camera.pos_w.expand(d.shape).contiguous()
    hit, sd = make_shaded_tracer(baked)(o, d, 0.0, o)
    g = torch.Generator().manual_seed(2)
    nd = torch.randn(d.shape, generator=g)
    nd = nd / nd.norm(dim=-1, keepdim=True)
    return torch.where(hit.hit[..., None], sd.pos_w, o), nd


def test_bvh_tier_sorted_batches_equal_unsorted(pink):
    """coherent=False on the BVH tier walks the rays in sort_order (a
    permutation far from the identity) and changes no bit: the shaded
    kernel's branch and the gather branch of make_shaded_tracer, and the
    intersector's any-hit batch (dead lanes included) and closest hits,
    culled and not; the plain versions count no launch."""
    o, d = _bounce_rays(pink)
    order = raysort.sort_order(o, d, 1e-3, None, pink.sort_bounds)
    assert not torch.equal(order, torch.arange(order.numel(), dtype=torch.int32))
    cuda.reset_launch_counts()
    for fused in (None, False):
        trace = make_shaded_tracer(pink, force_fused=fused, sort_divergent=True)
        (h0, s0), (h1, s1) = (trace(o, d, 1e-3, o, coherent=c) for c in (True, False))
        for f in dataclasses.fields(h0):
            assert torch.equal(_bits(getattr(h0, f.name)), _bits(getattr(h1, f.name))), f.name
        for f in dataclasses.fields(s0):
            a, b = getattr(s0, f.name), getattr(s1, f.name)
            assert torch.equal(_bits(a), _bits(b)), (fused, f.name)
        assert int(h0.hit.sum()) > 0
    intersect = pink.intersector()
    tmax = torch.rand(o.shape[:-1], generator=torch.Generator().manual_seed(3)) * 3.0
    tmax[::4] = 0.0
    for kw in (dict(closest=False), dict(closest=True), dict(closest=True, cull_backface=True)):
        a, b = (intersect(o, d, 1e-3, tmax, coherent=c, **kw) for c in (True, False))
        assert all(torch.equal(_bits(getattr(a, k)), _bits(getattr(b, k)))
                   for k in ("t", "tri", "bary_u", "bary_v")), kw
        assert 0 < int(a.hit.sum()) < a.hit.numel()
    assert all(v == 0 for v in cuda.LAUNCHES.values())
    assert all(v == 0 for v in cuda.LAUNCHES_BY_VARIANT.values())


def test_order_argument_checks_and_plain_gather(pink):
    """The wrappers' `order`: int32 [N] on the rays' device; a reversed
    order gives the unordered answers; an incoherent BVH batch needs the
    bake's bounds."""
    o, d = _bounce_rays(pink, 16, 10)
    walk = (pink.bw_rows, pink.n_tris, pink.bvh_pairs)
    n = o.numel() // 3
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int32)
    a = cluster.bvh_closest(*walk, o, d, 1e-3)
    b = cluster.bvh_closest(*walk, o, d, 1e-3, order=rev)
    assert torch.equal(a.tri, b.tri) and torch.equal(_bits(a.t), _bits(b.t))
    with pytest.raises(TypeError):
        cluster.bvh_occluded(*walk, o, d, 1e-3, order=rev.long())
    with pytest.raises(ValueError):
        cluster.bvh_occluded(*walk, o, d, 1e-3, order=rev[1:])
    no_bounds = make_intersector(pink.tri_pack, pink.n_tris, pink.bvh_pairs, pink.bw_rows)
    no_bounds(o, d, 1e-3, closest=False)  # a coherent batch needs none
    with pytest.raises(ValueError, match="bounds"):
        no_bounds(o, d, 1e-3, closest=False, coherent=False)
