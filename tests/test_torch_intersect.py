"""The port's dense intersectors (the plain versions of the K4 kernels, which
the wrappers run on CPU tensors) against every JAX entry point they replace,
run in interpret mode as the JAX package's own tests run them.

K4a `intersect_pallas`, K4b `occluded_pallas`, K4c `intersect_shaded`,
K4d `occluded_lanes`, K4e `intersect_shaded_lanes` / `_lanes_fm`.  The same
numpy rays go to both packages: random rays, G-buffer rays, and shadow rays
with some empty (t_max = 0) lanes, on the Cornell box (34 triangles) and on
Cornell + icosphere (1314 triangles: six 256-row chunks for K4d/K4e, eleven
128-lane tiles for K4a-K4c, so ties across chunks are exercised).

Bounds (tests/test_lane_kernels.py:38-68): triangle ids equal except on
ties, where t agrees to rtol 1e-5 and both sides hit; t on agreeing hits to
rtol 1e-5 (plus atol 1e-7, see T_ATOL); fields to atol 2e-4; occlusion
bits equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.accel import pallas_intersect as jpi
from fyp_bidirectionalpathtracer_tpu.accel import pallas_lane as jlane
from fyp_bidirectionalpathtracer_tpu.accel import pallas_shaded as jshaded
from fyp_bidirectionalpathtracer_tpu.accel.traverse import intersect_brute
from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box, icosphere
from fyp_bidirectionalpathtracer_tpu.ops import shading as jshading
from fyp_bidirectionalpathtracer_tpu.scene.camera import camera_ray_dirs
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect as isect
from fyp_bidirectionalpathtracer_tpu_torch.accel.traverse import HitRecord, make_intersector
from fyp_bidirectionalpathtracer_tpu_torch.ops import shading
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import baked_scene_from_arrays

T_MIN = 1e-3
# t = (n.v0 - n.o) / n.d cancels for an origin near the plane: one float32
# ulp of n.o (~1) is 6e-8, which JAX's K4a, summing n.o as an XLA matmul in
# another order, reaches (measured 5.1e-8 at t = 2.3e-3, 2.3e-5 relative)
T_ATOL = 1e-7


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


@pytest.fixture(scope="module", params=["cornell", "cornell_icosphere"])
def bakes(request):
    built = cornell_box()
    if request.param == "cornell_icosphere":
        built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    jb = JScene.from_built(built, aspect=1.5).bake()
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")


def _rays(jb):
    """(origin, direction, t_max) numpy [N, 3], [N, 3], [N]: random rays
    (every fifth with an infinite t_max), G-buffer rays through a 24x16
    image, and shadow rays with finite t_max, 30% of them empty."""
    rs = np.random.RandomState(0)
    n = 600
    o_r = rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d_r = rs.normal(size=(n, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    tm_r = np.where(np.arange(n) % 5 == 0, np.inf, 1e30).astype(np.float32)
    cam = jb.data.camera
    d_g = np.asarray(camera_ray_dirs(cam, 24, 16, jnp.asarray([0.5, 0.5]))).reshape(-1, 3)
    d_g = d_g / np.linalg.norm(d_g, axis=1, keepdims=True)
    o_g = np.broadcast_to(np.asarray(cam.pos_w), d_g.shape)
    tm_g = np.full(len(d_g), 1e30, np.float32)
    o_s = rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d_s = rs.normal(size=(n, 3)).astype(np.float32)
    d_s /= np.linalg.norm(d_s, axis=1, keepdims=True)
    tm_s = np.where(rs.rand(n) < 0.3, 0.0, rs.uniform(0.05, 1.5, n)).astype(np.float32)
    cat = lambda *xs: np.ascontiguousarray(np.concatenate(xs).astype(np.float32))  # noqa: E731
    return cat(o_r, o_g, o_s), cat(d_r, d_g, d_s), cat(tm_r, tm_g, tm_s)


def _assert_hits_match(got: HitRecord, want, got_fields=None, want_fields=None):
    """The tolerance table of the module docstring; fields are [N, 32].

    Where t_max is infinite, the JAX kernels turn a miss into a hit of
    triangle 0 at t = 1e30 (their chunk chain starts best_t at t_max, and a
    chunk without a hit offers 1e30 < inf); the port reports the miss
    (ROADMAP Queue 3)."""
    gt, wt = got.tri.numpy(), np.asarray(want.tri)
    g_t, w_t = got.t.numpy(), np.asarray(want.t)
    jax_false_hit = (wt >= 0) & (w_t == 1e30)
    assert (gt[jax_false_hit] == -1).all()
    jax_miss = wt < 0
    wt = np.where(jax_false_hit, -1, wt)
    w_t = np.where(jax_false_hit, np.float32(1e30), w_t)
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
        # a miss: every field but t and the id is 0, as the one-hot fetch
        # gives for a finite t_max (JAX's is NaN where t_max is infinite)
        assert (gf[gt < 0][:, 2:] == 0.0).all()
        finite = jax_miss & np.isfinite(wf).all(-1)
        np.testing.assert_array_equal(gf[finite][:, 2:], wf[finite][:, 2:])
    return int(jax_false_hit.sum())


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
@pytest.mark.parametrize("entry,t_max", [
    ("intersect_pallas", "lanes"), ("intersect_shaded", "lanes"),
    ("intersect_shaded_lanes", "lanes"), ("intersect_shaded_lanes_fm", "lanes"),
    ("intersect_shaded_lanes_fm", "none")])
def test_closest_entry_matches_jax(bakes, entry, cull, t_max):
    """t_max 'lanes': per-lane finite, 1e30, 0 and infinite values (where
    JAX's answer to a miss is a hit at 1e30, see _assert_hits_match);
    'none': t_max omitted."""
    jb, pb = bakes
    o, d, tm = _rays(jb)
    jtm = jnp.asarray(tm) if t_max == "lanes" else None
    ptm = torch.from_numpy(tm) if t_max == "lanes" else None
    jo, jd, po, pd = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    args = (pb.tri_pack, pb.n_tris, po, pd, T_MIN, ptm)
    if entry == "intersect_pallas":
        want = jpi.intersect_pallas(jb.tris, jo, jd, T_MIN, jtm, cull_backface=cull,
                                    interpret=True)
        false_hits = _assert_hits_match(isect.intersect_pallas(*args, cull_backface=cull),
                                        want)
        assert false_hits > 0
        return
    if entry == "intersect_shaded":
        pack = jshaded.pack_shaded_triangles(jb.tris, jb.data.materials)
        want, wf = jshaded.intersect_shaded(jb.tris, pack, jo, jd, T_MIN, jtm, cull,
                                            interpret=True)
    else:
        pack = jlane.pack_shaded_tris_lane(jb.tris, jb.data.materials)
        want, wf = getattr(jlane, entry)(jb.tris, pack, jo, jd, T_MIN, jtm, cull,
                                         interpret=True)
    got, gf = getattr(isect, entry)(*args, cull_backface=cull)
    if entry.endswith("_fm"):
        assert tuple(gf.shape) == (isect.OUT_W, len(o))
        gf, wf = gf.T, np.asarray(wf).T
    false_hits = _assert_hits_match(got, want, gf, wf)
    assert (false_hits > 0) == (t_max == "lanes")


@pytest.mark.parametrize("entry", ["occluded_pallas", "occluded_lanes"])
def test_any_hit_entry_matches_jax(bakes, entry):
    jb, pb = bakes
    o, d, tm = _rays(jb)
    jfn = jpi.occluded_pallas if entry == "occluded_pallas" else jlane.occluded_lanes
    want = np.asarray(jfn(jb.tris, jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(tm),
                          interpret=True))
    got = getattr(isect, entry)(pb.tri_pack, pb.n_tris, torch.from_numpy(o),
                                torch.from_numpy(d), T_MIN, torch.from_numpy(tm))
    assert got.dtype == torch.bool and got.shape == (len(o),)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(o)


def test_make_intersector_routes_like_the_dense_tier(bakes):
    """Any-hit without culling asks the any-hit function; closest hit and
    culled any-hit the closest-hit function (traverse.py:506-509)."""
    jb, pb = bakes
    o, d, tm = (torch.from_numpy(x) for x in _rays(jb))
    cuda.reset_launch_counts()
    intersect = make_intersector(pb.tri_pack, pb.n_tris)
    occ = intersect(o, d, T_MIN, tm, closest=False)
    want = isect.occluded(pb.tri_pack, pb.n_tris, o, d, T_MIN, tm)
    assert torch.equal(occ.hit, want) and torch.equal(occ.t == 0.0, want)
    culled = intersect(o, d, T_MIN, tm, closest=False, cull_backface=True)
    closest = isect.intersect_closest(pb.tri_pack, pb.n_tris, o, d, T_MIN, tm, True)
    assert torch.equal(culled.tri, closest.tri)
    # CPU tensors run the plain versions: no kernel launched
    assert all(v == 0 for v in cuda.LAUNCHES.values())


def test_nan_and_empty_rays_miss(bakes):
    _, pb = bakes
    o = torch.tensor([[float("nan"), 0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, float("nan"), 1.0], [0.0, 0.0, 1.0]])
    tmax = torch.tensor([10.0, 10.0, 1e-3])  # the last: t_max <= t_min
    hit, fields = isect.intersect_shaded_fm(pb.tri_pack, pb.n_tris, o, d, T_MIN, tmax)
    assert (hit.tri == -1).all() and (hit.t == 1e30).all()
    assert (fields[2:] == 0).all()
    assert not isect.occluded(pb.tri_pack, pb.n_tris, o, d, T_MIN, tmax).any()


def test_dense_tier_refuses_more_than_2048_triangles():
    """The dense kernels stage every triangle in shared memory; above 2048
    triangles the intersector takes the BVH kernels (accel/cluster.py),
    and needs the bake's two-box BVH table and Baldwin-Weber rows for them."""
    pack = torch.zeros((2056, 48))
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="2048"):
        isect.occluded(pack, 2049, o, o, T_MIN)
    with pytest.raises(ValueError, match="two-box BVH table"):
        make_intersector(pack, 2049)


# ------------------------------------------------------------ decode
def _port_hit(jhit) -> HitRecord:
    return HitRecord(*(torch.from_numpy(np.array(getattr(jhit, k)))
                       for k in ("t", "tri", "bary_u", "bary_v")))


def _assert_shading_close(got, want, hit):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, f.name
        np.testing.assert_allclose(g[hit], w[hit].astype(g.dtype), rtol=0, atol=1e-6,
                                   err_msg=f.name)


def test_shading_decodes_match_jax(bakes):
    """shading_from_fields_fm on JAX's K4e fields, and prepare_shading_data
    on JAX's brute-force hits, against JAX's decodes: within 1e-6."""
    jb, pb = bakes
    o, d, _ = _rays(jb)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    view = jb.data.camera.pos_w
    pack = jlane.pack_shaded_tris_lane(jb.tris, jb.data.materials)
    jhit, ffm = jlane.intersect_shaded_lanes_fm(jb.tris, pack, jo, jd, T_MIN, interpret=True)
    hit = np.asarray(jhit.tri) >= 0
    pview = torch.from_numpy(np.array(view))
    want = jshading.shading_from_fields_fm(ffm, jb.data.textures, jhit, jo, jd, view)
    got = shading.shading_from_fields_fm(torch.from_numpy(np.array(ffm)), pb.atlas,
                                         _port_hit(jhit), torch.from_numpy(o),
                                         torch.from_numpy(d), pview)
    _assert_shading_close(got, want, hit)
    bhit = intersect_brute(jb.tris, jo, jd, T_MIN)
    want = jshading.prepare_shading_data(jb.tris, jb.data.materials, jb.data.textures,
                                         bhit, jo, jd, view)
    got = shading.prepare_shading_data(pb.tris, pb.data.materials, pb.atlas, _port_hit(bhit),
                                       torch.from_numpy(o), torch.from_numpy(d), pview)
    _assert_shading_close(got, want, np.asarray(bhit.tri) >= 0)
