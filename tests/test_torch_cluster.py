"""The port's BVH intersectors (accel/cluster.py) against every JAX entry
point of the cluster and HBM tiers they replace, K4f-K4j, run in interpret
mode as the JAX package's own tests run them; plus the node table and the
routing above 2048 triangles.

On CPU tensors the wrappers run their plain versions, the dense programs
of accel/intersect.py, which the CUDA kernels equal bit for bit (held on
the card by tests/test_torch_cuda.py and chip_smoke.py).  The scene is the
2560-triangle icosphere grid of tests/test_cluster_kernels.py, whose AABB
culling skips clusters.  The same numpy rays go to both packages: random
rays, camera rays, and rays with finite, 1e30 and empty (t_max = 0) lanes.

Bounds (tests/test_lane_kernels.py:38-68, as in test_torch_intersect.py):
triangle ids equal except on ties, where t agrees to rtol 1e-5 and both
sides hit (the JAX cluster kernels break cross-cluster ties by visit
order); t on agreeing hits to rtol 1e-5; u, v and fields to atol 2e-4;
occlusion bits equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.accel import pallas_cluster as jpc
from fyp_bidirectionalpathtracer_tpu.accel.traverse import intersect_bvh
from fyp_bidirectionalpathtracer_tpu.models.procedural import MaterialDesc as JMaterialDesc
from fyp_bidirectionalpathtracer_tpu.models.procedural import icosphere as jicosphere
from fyp_bidirectionalpathtracer_tpu.scene.camera import camera_ray_dirs
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.accel import cluster
from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect as isect
from fyp_bidirectionalpathtracer_tpu_torch.accel.traverse import make_intersector
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import baked_scene_from_arrays
from fyp_bidirectionalpathtracer_tpu_torch.scene.types import BVHArrays

T_MIN = 1e-3
T_ATOL = 1e-7  # one float32 ulp of n.o near a plane (test_torch_intersect.py)


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


def sphere_grid() -> JScene:
    """tests/test_cluster_kernels.py's 4x2 grid of 320-triangle icospheres."""
    s = JScene()
    s.materials = [JMaterialDesc(base_color=(0.8, 0.3, 0.3, 1.0)),
                   JMaterialDesc(base_color=(0.3, 0.8, 0.3, 1.0), specular=(0, 0.4, 0.6, 0))]
    for i in range(4):
        for j in range(2):
            s.meshes.append(jicosphere((i * 1.5, j * 1.5, 2.0 + 0.3 * ((i + j) % 3)), 0.5,
                                       (i + j) % 2, subdivisions=2))
    s.lights = [{"type": "point", "pos": (2.0, 4.0, -2.0), "intensity": (10.0, 10.0, 10.0)}]
    return s.apply_default_fixups()


@pytest.fixture(scope="module")
def bakes():
    jb = sphere_grid().bake()
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


def _rays(jb):
    """(origin, direction, t_max) numpy: 600 random rays, 600 rays aimed at
    the grid, 24x16 camera rays; t_max per lane: 1e30, finite or 0 (25%
    empty)."""
    rs = np.random.RandomState(0)
    n = 600
    o_r = rs.uniform(-1.0, 4.0, (2 * n, 3)).astype(np.float32)
    d_r = rs.normal(size=(2 * n, 3)).astype(np.float32)
    d_r[n:] = rs.uniform((-0.5, -0.5, 1.5), (5.0, 2.0, 3.0), (n, 3)) - o_r[n:]
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    cam = jb.data.camera
    d_g = np.asarray(camera_ray_dirs(cam, 24, 16, jnp.asarray([0.5, 0.5]))).reshape(-1, 3)
    d_g = d_g / np.linalg.norm(d_g, axis=1, keepdims=True)
    o_g = np.broadcast_to(np.asarray(cam.pos_w), d_g.shape)
    o = np.ascontiguousarray(np.concatenate([o_r, o_g]).astype(np.float32))
    d = np.ascontiguousarray(np.concatenate([d_r, d_g]).astype(np.float32))
    pick = rs.rand(len(o))
    tm = np.where(pick < 0.25, 0.0, np.where(pick < 0.6, rs.uniform(0.5, 8.0, len(o)), 1e30))
    return o, d, tm.astype(np.float32)


def _assert_hits_match(got, want, got_fields=None, want_fields=None):
    """The module docstring's bounds; fields are [N, 32]."""
    gt, wt = got.tri.numpy(), np.asarray(want.tri)
    g_t, w_t = got.t.numpy(), np.asarray(want.t)
    differs = gt != wt
    if differs.any():  # ties: both hit at the same t
        np.testing.assert_allclose(g_t[differs], w_t[differs], rtol=1e-5, atol=T_ATOL)
        assert (gt[differs] >= 0).all() and (wt[differs] >= 0).all()
    hit = (gt >= 0) & ~differs
    assert hit.sum() > 100
    np.testing.assert_allclose(g_t[hit], w_t[hit], rtol=1e-5, atol=T_ATOL)
    assert (g_t[gt < 0] == 1e30).all() and (w_t[wt < 0] == 1e30).all()
    np.testing.assert_allclose(got.bary_u.numpy()[hit], np.asarray(want.bary_u)[hit], atol=2e-4)
    np.testing.assert_allclose(got.bary_v.numpy()[hit], np.asarray(want.bary_v)[hit], atol=2e-4)
    if got_fields is not None:
        gf, wf = got_fields.numpy(), np.asarray(want_fields)
        np.testing.assert_allclose(gf[hit], wf[hit], atol=2e-4)
        # a miss: every field but t and the id is 0 on both sides
        miss = (gt < 0) & (wt < 0)
        assert (gf[miss][:, 2:] == 0.0).all()
        np.testing.assert_array_equal(gf[miss][:, 2:], wf[miss][:, 2:])


@pytest.mark.parametrize("entry", ["occluded_clusters", "occluded_clusters_hbm"])
def test_any_hit_entry_matches_jax(bakes, entry):
    """K4f, K4i: occlusion bits equal, empty lanes unoccluded."""
    jb, pb = bakes
    o, d, tm = _rays(jb)
    want = np.asarray(getattr(jpc, entry)(jb.tris, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                          jnp.asarray(tm)))
    got = getattr(cluster, entry)(pb.bw_rows, pb.n_tris, pb.bvh_pairs, torch.from_numpy(o),
                                  torch.from_numpy(d), T_MIN, torch.from_numpy(tm))
    assert got.dtype == torch.bool and got.shape == (len(o),)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(o) and not want[tm == 0].any()


# each entry once, so that the four JAX kernels compile once each: culling
# on and off, per-lane and absent t_max, over the closest and shaded kernels
@pytest.mark.parametrize("entry,cull,t_max", [
    ("intersect_closest_clusters", False, "lanes"),
    ("intersect_closest_clusters_hbm", True, "none"),
    ("intersect_shaded_clusters", True, "lanes"),
    ("intersect_shaded_clusters_fm", False, "none")])
def test_closest_entry_matches_jax(bakes, entry, cull, t_max):
    """K4h, K4j, K4g (row-major and field-major)."""
    jb, pb = bakes
    o, d, tm = _rays(jb)
    jtm = jnp.asarray(tm) if t_max == "lanes" else None
    ptm = torch.from_numpy(tm) if t_max == "lanes" else None
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    args = (pb.bw_rows, pb.n_tris, pb.bvh_pairs, torch.from_numpy(o), torch.from_numpy(d),
            T_MIN, ptm)
    if not entry.startswith("intersect_shaded"):
        want = getattr(jpc, entry)(jb.tris, jo, jd, T_MIN, jtm, cull)
        _assert_hits_match(getattr(cluster, entry)(*args, cull_backface=cull), want)
        return
    args = (pb.tri_pack, pb.n_tris, pb.bw_rows, pb.bvh_pairs) + args[3:]
    ck = jpc.pick_ck(pb.n_tris)
    pack = jpc.pack_shaded_tris_cluster(jb.tris, jb.data.materials, ck)
    want, wf = getattr(jpc, entry)(jb.tris, pack, jpc.pack_cluster_aabbs(jb.tris, ck), jo, jd,
                                   T_MIN, jtm, cull, ck=ck)
    got, gf = getattr(cluster, entry)(*args, cull_backface=cull)
    if entry.endswith("_fm"):
        assert tuple(gf.shape) == (isect.OUT_W, len(o))
        gf, wf = gf.T, np.asarray(wf).T
    assert tuple(gf.shape) == (len(o), isect.OUT_W)
    _assert_hits_match(got, want, gf, wf)


def test_wrappers_take_the_plain_versions_on_the_cpu(bakes):
    """CPU tensors: the dense plain programs, no launch; the intersector
    above 2048 triangles routes like the dense tier."""
    _, pb = bakes
    o, d, tm = (torch.from_numpy(x) for x in _rays(bakes[0]))
    args = (pb.tri_pack, pb.n_tris, o, d, T_MIN, tm)
    cuda.reset_launch_counts()
    got_hit, got_f = cluster.bvh_shaded_fm(pb.tri_pack, pb.n_tris, pb.bw_rows, pb.bvh_pairs,
                                           *args[2:])
    want_hit, want_f = isect.shaded_plain(*args)
    assert torch.equal(got_f, want_f) and torch.equal(got_hit.tri, want_hit.tri)
    got = cluster.bvh_closest(pb.bw_rows, pb.n_tris, pb.bvh_pairs, *args[2:])
    assert torch.equal(got.t, want_hit.t) and torch.equal(got.tri, want_hit.tri)
    intersect = make_intersector(pb.tri_pack, pb.n_tris, pb.bvh_pairs, pb.bw_rows)
    assert torch.equal(intersect(o, d, T_MIN, tm, closest=False).hit, isect.occluded_plain(*args))
    culled = intersect(o, d, T_MIN, tm, closest=False, cull_backface=True)
    assert torch.equal(culled.tri, isect.closest_plain(*args, cull_backface=True).tri)
    assert all(v == 0 for v in cuda.LAUNCHES.values())


def test_node_table_boxes_hold_their_triangles(bakes):
    """Every leaf's padded box holds its triangles with the margin to spare,
    every inner box its children's, and the links thread the pre-order
    tree; the ints ride in float bits."""
    jb, pb = bakes
    table = pb.bvh_nodes.numpy()
    ints = table[:, 6:].view(np.int32)
    bvh = jb.data.bvh
    lo, hi = np.asarray(bvh.node_min), np.asarray(bvh.node_max)
    pad = table[0, 3:6] - hi[0]
    assert (pad > 0).all() and np.allclose(pad, pad[0], rtol=1e-3)
    np.testing.assert_array_equal(ints[:, 0], np.asarray(bvh.node_miss))
    leaf = ints[:, 1] >= 0
    np.testing.assert_array_equal(leaf, np.asarray(bvh.node_count) > 0)
    v0 = pb.tris.v0.numpy()
    verts = np.stack([v0, v0 + pb.tris.e1.numpy(), v0 + pb.tris.e2.numpy()], 1)
    for i in np.nonzero(leaf)[0]:
        first, count = ints[i, 1] >> 3, ints[i, 1] & 7
        assert 1 <= count <= 4
        v = verts[first:first + count].reshape(-1, 3)
        assert (v >= table[i, 0:3] + 0.5 * pad).all() and (v <= table[i, 3:6] - 0.5 * pad).all()
    inner = np.nonzero(~leaf)[0]
    child = np.asarray(bvh.node_hit)[inner]
    np.testing.assert_array_equal(child, inner + 1)
    assert (table[child, 0:3] >= table[inner, 0:3]).all()
    assert (table[child, 3:6] <= table[inner, 3:6]).all()
    assert ints[:, 1][leaf].max() >> 3 < pb.n_tris


def test_node_table_refuses_an_unthreaded_tree():
    one = np.zeros((3, 3), np.float32)
    bvh = BVHArrays(node_min=torch.from_numpy(one), node_max=torch.from_numpy(one + 1),
                    node_left=torch.zeros(3, dtype=torch.int32),
                    node_count=torch.tensor([0, 1, 1], dtype=torch.int32),
                    node_hit=torch.tensor([2, -1, -1], dtype=torch.int32),  # not next
                    node_miss=torch.tensor([-1, 2, -1], dtype=torch.int32),
                    tri_order=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="threaded"):
        cluster.pack_bvh_nodes(bvh)


def test_tiny_negative_direction_components_hit(bakes):
    """JAX's jnp `intersect_bvh` (its path on the CPU and above 1M
    triangles) guards small direction components with sign(d) 1e12 + 1e12
    (`traverse.py:229`), which is 0 for d in (-1e-12, 0): that axis then
    culls every node, and the ray misses (ROADMAP Queue 3).  The port's
    answer is the dense one; its BVH kernels take IEEE 1/d with a NaN guard
    (csrc/bvh.cuh slab_box; tests/test_torch_cuda.py holds them on such
    rays)."""
    jb, pb = bakes
    o = np.asarray([[0.0, 0.0, 0.0]] * 3, np.float32)
    d = np.asarray([[-1e-13, 0.0, 1.0], [1e-13, 0.0, 1.0], [0.0, -1e-13, 1.0]], np.float32)
    want = intersect_bvh(jb.data.bvh, jb.tris, jnp.asarray(o), jnp.asarray(d), T_MIN)
    got = cluster.bvh_closest(pb.bw_rows, pb.n_tris, pb.bvh_pairs, torch.from_numpy(o),
                              torch.from_numpy(d), T_MIN)
    assert (got.tri >= 0).all()
    np.testing.assert_array_equal(np.asarray(want.tri) >= 0, [False, True, False])
    np.testing.assert_allclose(got.t.numpy()[1], np.asarray(want.t)[1], rtol=1e-5)
