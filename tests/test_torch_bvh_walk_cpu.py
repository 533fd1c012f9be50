"""The BVH kernels' two-box walks and their tables, on the CPU.

`csrc/bvh_pairs.cuh` (the any-hit and closest-hit walks of the two-box
table with a short stack) is plain C++ apart from `BDPT_DEV`, two bit-cast
intrinsics and `load4`, its 16-byte read, so a small harness defines those
(`load4` with memcpy) and g++ compiles it (`-O1 -ffp-contract=off`: no FMA
contraction, as the plain versions round every operation) into a shared
library loaded with ctypes.  The tests hold:

- the any-hit walk (`bvh_any_hit` over the bake's two-box table and
  Baldwin-Weber rows) bit for bit against the dense pair loop
  (`occluded<true>`) and the threaded walk it replaces (`bvh_occluded`),
  on pink_room (10,546 triangles) and Cornell + icosphere (1,314):
  axis-aligned rays, rays onto the shared edges of axis-aligned triangles,
  grazing rays, and lanes that need no walk (t_max = 0, t_max < t_min,
  t_max = t_min, NaN origins and directions);
- the closest-hit walk (`bvh_closest_pairs`, nearer child first, pops
  pruned by the best t) on the same rays and on the one-leaf tree, with
  back-face culling on and off: t, id, u and v bit for bit against the
  dense loop (`closest_hit<true>`) and the threaded walk it replaces
  (`bvh_closest_hit`), the (t, id) ties on shared edges included; and on
  pink_room's camera rays it reads fewer rows than the threaded walk
  tests boxes;
- the tables in torch: every leaf triangle reachable from the root exactly
  once, each child box equal to that child's row of `pack_bvh_nodes`, the
  one-leaf tree, and the depth check, which raises on a tree deeper than
  the walk's stack.

The kernel itself needs the card: `tests/test_torch_cuda.py`.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_frame_walk_cpu import _rays

from fyp_bidirectionalpathtracer_tpu_torch.accel import cluster
from fyp_bidirectionalpathtracer_tpu_torch.accel.intersect import MAX_DENSE_TRIS
from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box, icosphere
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.scene.types import BVHArrays

CSRC = (Path(__file__).resolve().parent.parent / "fyp_bidirectionalpathtracer_tpu_torch"
        / "csrc")

HARNESS = r"""
#include <string.h>
#define BDPT_DEV static inline
static inline int __float_as_int(float x) { int i; memcpy(&i, &x, 4); return i; }
static inline float __int_as_float(int i) { float x; memcpy(&x, &i, 4); return x; }
struct float4 { float x, y, z, w; };
static inline float4 load4(const float* p) { float4 r; memcpy(&r, p, 16); return r; }
#include "bvh_pairs.cuh"
using namespace bdpt;

// rays [n, 8]: o, d, tmin, tmax.  walk 0: the dense loop over `bw`; 1 the
// threaded walk over `nodes`; 2 the two-box walk over `pairs`, its counts
// (rows read, pair tests by stage) in counts [n, 4]
extern "C" void any_hit(const float* rays, int n, const float* bw, int n_tris,
                        const float* nodes, const float* pairs, int walk, int* out,
                        int* counts) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 8 * i;
    const V3 o = mk3(r[0], r[1], r[2]), d = mk3(r[3], r[4], r[5]);
    WalkCounts c = {0, 0, 0, 0};
    if (walk == 0)
      out[i] = occluded<true>(bw, n_tris, o, d, r[6], r[7]);
    else if (walk == 1)
      out[i] = bvh_occluded<false, kBwCols>(bw, nodes, o, d, r[6], r[7], nullptr);
    else
      out[i] = bvh_any_hit<true>(bw, pairs, o, d, r[6], r[7], &c);
    counts[4 * i] = c.nodes;
    counts[4 * i + 1] = c.s1;
    counts[4 * i + 2] = c.s2;
    counts[4 * i + 3] = c.s3;
  }
}

// rays [n, 8]: closest hit, with back-face culling if `cull`.  walk 0: the
// dense loop over `bw`; 1 the threaded walk over `nodes`; 2 the two-box
// walk over `pairs`; the winner's u, v as the kernels find them (walks 0
// and 1 recompute them from its row); counts [n, 4] of walks 1 and 2
extern "C" void closest(const float* rays, int n, const float* bw, int n_tris,
                        const float* nodes, const float* pairs, int cull, int walk,
                        float* t_out, int* id_out, float* u_out, float* v_out, int* counts) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 8 * i;
    const V3 o = mk3(r[0], r[1], r[2]), d = mk3(r[3], r[4], r[5]);
    WalkCounts c = {0, 0, 0, 0};
    float t, u = 0.0f, v = 0.0f;
    int id;
    if (walk == 2) {
      id = bvh_closest_pairs<true>(bw, pairs, o, d, r[6], r[7], cull, t, u, v, &c);
    } else {
      id = walk == 0 ? closest_hit<true>(bw, n_tris, o, d, r[6], r[7], cull, t)
                     : bvh_closest_hit<true, kBwCols>(bw, nodes, o, d, r[6], r[7], cull, t, &c);
      if (id >= 0) hit_uv<true>(bw + (size_t)id * kBwCols, o, d, t, u, v);
    }
    t_out[i] = t;
    id_out[i] = id;
    u_out[i] = u;
    v_out[i] = v;
    counts[4 * i] = c.nodes;
    counts[4 * i + 1] = c.s1;
    counts[4 * i + 2] = c.s2;
    counts[4 * i + 3] = c.s3;
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the walk for the CPU")
    tmp = tmp_path_factory.mktemp("bvh_walk")
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "libbvh_walk.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), str(tmp / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    out = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    out.any_hit.argtypes = [p, i, p, i, p, p, i, p, p]
    out.closest.argtypes = [p, i, p, i, p, p, i, i, p, p, p, p, p]
    return out


def _bake(name):
    if name == "pink_room":
        built = pink_room(asset_dir="")
    else:
        built = cornell_box()
        built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    return Scene.from_built(built, aspect=1.6).bake(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """name -> (bake, its two-box walks' tables): the bake's own above 2048
    triangles, made by `pair_tables` below, where the bake has none."""
    out = {}
    for name in ("pink_room", "cornell_icosphere"):
        baked = _bake(name)
        tables = cluster.pair_tables(baked.data.bvh, baked.tri_pack)
        if baked.n_tris > MAX_DENSE_TRIS:
            assert torch.equal(baked.bw_rows, tables[0])
            assert torch.equal(baked.bvh_pairs.view(torch.int32), tables[1].view(torch.int32))
            tables = (baked.bw_rows, baked.bvh_pairs)
        else:
            assert baked.bw_rows is None and baked.bvh_pairs is None
        out[name] = (baked, *tables)
    return out


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _any_hit(lib, scene, rays, walk, pairs=None, rows=None):
    baked, bake_rows, bake_pairs = scene
    n = rays.shape[0]
    out = torch.zeros(n, dtype=torch.int32)
    counts = torch.zeros((n, 4), dtype=torch.int32)
    rows = bake_rows if rows is None else rows
    pairs = bake_pairs if pairs is None else pairs
    lib.any_hit(_ptr(rays), n, _ptr(rows), baked.n_tris, _ptr(baked.bvh_nodes), _ptr(pairs),
                walk, _ptr(out), _ptr(counts))
    return out.bool(), counts


def _no_walk_lanes(rays, rng):
    """Copies of some rays that need no walk: t_max = 0, t_max < t_min,
    t_max = t_min, a NaN in the origin or the direction."""
    picks = rays[torch.from_numpy(rng.integers(0, rays.shape[0], 50))]
    out = []
    for k in range(5):
        r = picks.clone()
        if k == 0:
            r[:, 7] = 0.0
        elif k == 1:
            r[:, 7] = r[:, 6] * 0.5
        elif k == 2:
            r[:, 7] = r[:, 6]
        else:
            r[torch.arange(50), torch.from_numpy(rng.integers(0, 3, 50)) + 3 * (k - 3)] = np.nan
        out.append(r)
    return torch.cat(out)


@pytest.mark.parametrize("name", ["pink_room", "cornell_icosphere"])
@pytest.mark.parametrize("seed", [0, 1])
def test_any_hit_walk_bit_equal_to_dense_loop(lib, scenes, name, seed):
    baked = scenes[name][0]
    rng = np.random.default_rng(seed + 10)
    rays = _rays(baked, seed=seed)
    rays = torch.cat([rays, _no_walk_lanes(rays, rng)]).contiguous()
    dense, _ = _any_hit(lib, scenes[name], rays, 0)
    threaded, _ = _any_hit(lib, scenes[name], rays, 1)
    walk, counts = _any_hit(lib, scenes[name], rays, 2)
    assert torch.equal(walk, dense)
    assert torch.equal(threaded, dense)
    assert 0 < int(dense.sum()) < rays.shape[0]
    no_walk = slice(rays.shape[0] - 250, None)
    assert not walk[no_walk].any() and not counts[no_walk].any()
    c = counts.to(torch.int64).sum(0)
    assert c[0] > 0 and c[1] >= c[2] >= c[3] > 0


def _leaves(pairs):
    """Every leaf link reachable from row 0 -> (first, count) pairs."""
    links = pairs[:, 12:14].contiguous().view(torch.int32).numpy()
    found, todo = [], [0]
    while todo:
        row = todo.pop()
        for link in links[row]:
            if link >= 0:
                todo.append(int(link))
            else:
                found.append((int(~link) >> 3, int(~link) & 7))
    return found


@pytest.mark.parametrize("name", ["pink_room", "cornell_icosphere"])
def test_pair_table_reaches_every_triangle_once(scenes, name):
    baked, rows, pairs = scenes[name]
    assert pairs.dtype == torch.float32 and pairs.shape[1] == cluster.PAIR_COLS
    leaves = _leaves(pairs)
    n_inner = int((baked.data.bvh.node_count == 0).sum())
    assert pairs.shape[0] == n_inner and len(leaves) == n_inner + 1
    ids = np.concatenate([np.arange(first, first + count) for first, count in leaves])
    np.testing.assert_array_equal(np.sort(ids), np.arange(baked.n_tris))
    assert (pairs[:, 14:] == 0).all()
    # the Baldwin-Weber rows: the pack's first 12 columns, 16-byte rows
    assert torch.equal(rows, baked.tri_pack[:, :cluster.BW_COLS])
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 0


@pytest.mark.parametrize("name", ["pink_room", "cornell_icosphere"])
def test_pair_table_boxes_are_the_node_rows(scenes, name):
    """Row r of inner node i holds the boxes of children i + 1 and
    miss[i + 1] exactly as pack_bvh_nodes pads them, and links an inner
    child to its row, a leaf to its triangles."""
    baked, _, pairs = scenes[name]
    bvh = baked.data.bvh
    table = baked.bvh_nodes.numpy()
    count = bvh.node_count.numpy()
    miss = bvh.node_miss.numpy()
    inner = np.nonzero(count == 0)[0]
    rank = {int(i): r for r, i in enumerate(inner)}
    pairs = pairs.numpy()
    links = pairs[:, 12:14].view(np.int32)
    for k, child in enumerate((inner + 1, miss[inner + 1])):
        np.testing.assert_array_equal(pairs[:, 6 * k:6 * k + 6], table[child, :6])
        for r, c in enumerate(child):
            want = rank[int(c)] if count[c] == 0 else ~((int(bvh.node_left[c]) << 3) | int(count[c]))
            assert links[r, k] == want


def _chain_bvh(levels):
    """A tree with `levels` inner nodes on its longest path: each inner node
    has a leaf (one triangle) first and the next inner node second; in
    pre-order I0 L0 I1 L1 ... I(k-1) L(k-1) L(k)."""
    n = 2 * levels + 1
    inner = np.arange(0, 2 * levels, 2)
    leaf = np.setdiff1d(np.arange(n), inner)
    count = np.zeros(n, np.int32)
    count[leaf] = 1
    left = np.zeros(n, np.int32)
    left[leaf] = np.arange(len(leaf))
    miss = np.full(n, -1, np.int32)
    miss[leaf[:-1]] = leaf[:-1] + 1  # a leaf's sibling is the next inner node
    hit = np.where(count > 0, miss, np.arange(n) + 1).astype(np.int32)
    box = np.zeros((n, 3), np.float32)
    return BVHArrays(node_min=torch.from_numpy(box), node_max=torch.from_numpy(box + 1),
                     node_left=torch.from_numpy(left), node_count=torch.from_numpy(count),
                     node_hit=torch.from_numpy(hit), node_miss=torch.from_numpy(miss),
                     tri_order=torch.arange(len(leaf), dtype=torch.int32))


def test_pair_table_refuses_a_tree_deeper_than_the_stack():
    ok = cluster.pack_bvh_pairs(_chain_bvh(cluster.STACK_SIZE))
    assert ok.shape == (cluster.STACK_SIZE, cluster.PAIR_COLS)
    assert sorted(f for f, _ in _leaves(ok)) == list(range(cluster.STACK_SIZE + 1))
    with pytest.raises(ValueError, match="stack"):
        cluster.pack_bvh_pairs(_chain_bvh(cluster.STACK_SIZE + 1))


def _one_leaf_bvh(baked):
    """A tree that is one leaf: the scene's box over its first 3 triangles."""
    lo, hi = baked.data.bvh.node_min[:1], baked.data.bvh.node_max[:1]
    return BVHArrays(node_min=lo, node_max=hi, node_left=torch.zeros(1, dtype=torch.int32),
                     node_count=torch.tensor([3], dtype=torch.int32),
                     node_hit=torch.tensor([-1], dtype=torch.int32),
                     node_miss=torch.tensor([-1], dtype=torch.int32),
                     tri_order=torch.arange(3, dtype=torch.int32))


def test_one_leaf_tree(lib, scenes):
    """A tree that is one leaf: one row, the leaf beside an empty leaf; the
    walk over it equals the dense loop on the leaf's triangles."""
    baked, bake_rows, _ = scenes["cornell_icosphere"]
    pairs = cluster.pack_bvh_pairs(_one_leaf_bvh(baked))
    assert pairs.shape == (1, cluster.PAIR_COLS)
    assert _leaves(pairs) == [(0, 0), (0, 3)] or _leaves(pairs) == [(0, 3), (0, 0)]
    rows = bake_rows[:3].contiguous()
    rays = _rays(baked, seed=3).contiguous()
    n = rays.shape[0]
    dense = torch.zeros(n, dtype=torch.int32)
    counts = torch.zeros((n, 4), dtype=torch.int32)
    lib.any_hit(_ptr(rays), n, _ptr(rows), 3, _ptr(baked.bvh_nodes), _ptr(pairs), 0,
                _ptr(dense), _ptr(counts))
    walk, _ = _any_hit(lib, scenes["cornell_icosphere"], rays, 2, pairs=pairs, rows=rows)
    assert torch.equal(walk, dense.bool()) and int(dense.sum()) > 0


def _closest(lib, tables, rays, cull, walk):
    """(t, id, u, v, counts [n, 4]) of one closest walk over `tables`
    (bake, rows, pairs, nodes, n_tris)."""
    baked, rows, pairs, nodes, n_tris = tables
    n = rays.shape[0]
    t, u, v = (torch.zeros(n, dtype=torch.float32) for _ in range(3))
    ids = torch.zeros(n, dtype=torch.int32)
    counts = torch.zeros((n, 4), dtype=torch.int32)
    lib.closest(_ptr(rays), n, _ptr(rows), n_tris, _ptr(nodes), _ptr(pairs), int(cull), walk,
                _ptr(t), _ptr(ids), _ptr(u), _ptr(v), _ptr(counts))
    return t, ids, u, v, counts


def _closest_tables(scenes, name):
    """(bake, rows, pairs, nodes, n_tris) of a scene, or of the one-leaf
    tree over Cornell + icosphere's first 3 triangles."""
    if name != "one_leaf":
        baked, rows, pairs = scenes[name]
        return baked, rows, pairs, baked.bvh_nodes, baked.n_tris
    baked, rows, _ = scenes["cornell_icosphere"]
    one = _one_leaf_bvh(baked)
    return (baked, rows[:3].contiguous(), cluster.pack_bvh_pairs(one),
            cluster.pack_bvh_nodes(one), 3)


def _float_bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("name", ["pink_room", "cornell_icosphere", "one_leaf"])
def test_closest_walk_bit_equal_to_dense_loop(lib, scenes, name, cull):
    """t, id, u, v of the two-box closest walk equal the dense loop's and
    the threaded walk's bit for bit: axis-aligned rays, the (t, id) ties on
    shared edges, grazing rays, finite and open t_max, and lanes that need
    no walk, which miss with t = t_max and count nothing."""
    tables = _closest_tables(scenes, name)
    rng = np.random.default_rng(20 + int(cull))
    rays = _rays(tables[0], seed=4 + int(cull))
    rays = torch.cat([rays, _no_walk_lanes(rays, rng)]).contiguous()
    dense = _closest(lib, tables, rays, cull, 0)
    for walk in (1, 2):
        got = _closest(lib, tables, rays, cull, walk)
        assert torch.equal(got[1], dense[1]), walk
        for k in (0, 2, 3):
            assert torch.equal(_float_bits(got[k]), _float_bits(dense[k])), (walk, k)
    t, ids, _, _, counts = got
    assert 0 < int((ids >= 0).sum()) < rays.shape[0]
    no_walk = slice(rays.shape[0] - 250, None)
    assert (ids[no_walk] == -1).all() and not counts[no_walk].any()
    assert torch.equal(_float_bits(t[no_walk]), _float_bits(rays[no_walk, 7].contiguous()))
    c = counts.to(torch.int64).sum(0)
    assert c[0] > 0 and c[1] >= c[2] >= c[3] > 0


def test_closest_walk_reads_fewer_rows_than_the_threaded_walk_tests_boxes(lib, scenes):
    """On pink_room's camera rays (back-face culling, as the G-buffer
    traces them) the nearer-first walk with pruned pops reads fewer
    two-box rows, and runs fewer pair tests, than the threaded walk (fixed
    child order) tests boxes and pairs; the answers are the same."""
    from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
    from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import camera_ray_dirs

    tables = _closest_tables(scenes, "pink_room")
    cam = tables[0].data.camera
    d = camera_ray_dirs(cam, 64, 36, pixel_jitter_for_frame(0), device="cpu").reshape(-1, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    o = cam.pos_w.to(torch.float32).expand(d.shape)
    n = d.shape[0]
    rays = torch.cat([o, d, torch.zeros((n, 1)), torch.full((n, 1), 1e30)], 1)
    rays = rays.to(torch.float32).contiguous()
    threaded = _closest(lib, tables, rays, True, 1)
    walk = _closest(lib, tables, rays, True, 2)
    assert torch.equal(walk[1], threaded[1]) and int((walk[1] >= 0).sum()) > n // 2
    rows, box_tests = int(walk[4][:, 0].sum()), int(threaded[4][:, 0].sum())
    pairs, threaded_pairs = int(walk[4][:, 1].sum()), int(threaded[4][:, 1].sum())
    assert rows < box_tests and pairs < threaded_pairs, (rows, box_tests, pairs, threaded_pairs)


def _chain_builder(build):
    """A BVH builder that keeps `build`'s leaf order but threads it as a
    chain: inner node j holds triangle j's leaf first and the rest second,
    so a tree of F triangles has F - 1 inner levels; in pre-order
    I0 L0 I1 L1 ... I(F-2) L(F-2) L(F-1)."""
    def chain(positions, indices, leaf_size=4):
        order = build(positions, indices, leaf_size=leaf_size)["tri_order"]
        v = np.asarray(positions, np.float32)[np.asarray(indices)[order]]
        lo, hi = v.min(1), v.max(1)
        f = len(order)
        inner, leaf = np.arange(0, 2 * f - 2, 2), np.append(np.arange(1, 2 * f - 2, 2), 2 * f - 2)
        node_min, node_max = np.zeros((2 * f - 1, 3), np.float32), np.zeros((2 * f - 1, 3),
                                                                              np.float32)
        node_min[inner] = np.minimum.accumulate(lo[::-1])[::-1][:-1]
        node_max[inner] = np.maximum.accumulate(hi[::-1])[::-1][:-1]
        node_min[leaf], node_max[leaf] = lo, hi
        count = np.zeros(2 * f - 1, np.int32)
        count[leaf] = 1
        left = np.zeros(2 * f - 1, np.int32)
        left[leaf] = np.arange(f)
        miss = np.full(2 * f - 1, -1, np.int32)
        miss[leaf[:-1]] = leaf[:-1] + 1
        hit = np.where(count > 0, miss, np.arange(2 * f - 1) + 1).astype(np.int32)
        return {"node_min": node_min, "node_max": node_max, "node_left": left,
                "node_count": count, "node_hit": hit, "node_miss": miss,
                "tri_order": order.astype(np.int32)}
    return chain


@pytest.mark.parametrize("megakernel", ["auto", "off"])
def test_deep_tree_of_a_dense_tier_scene_bakes_and_renders(monkeypatch, megakernel):
    """Up to 2048 triangles no kernel walks the two-box table, so the bake
    builds none and takes a tree of any depth: the Cornell box threaded as
    a chain of 33 inner levels (more than the stack) renders bit for bit as
    with its own tree, whose leaf order the chain keeps."""
    from fyp_bidirectionalpathtracer_tpu_torch.accel import bvh as bvh_mod
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig

    def render(baked):
        r = Renderer(baked, RenderConfig(width=24, height=16,
                                         bdpt=BDPTConfig(megakernel=megakernel)))
        r.render(2)
        return r.display()

    want = render(Scene.from_built(cornell_box(), aspect=1.5).bake(device="cpu"))
    monkeypatch.setattr(bvh_mod, "build_bvh", _chain_builder(bvh_mod.build_bvh))
    deep = Scene.from_built(cornell_box(), aspect=1.5).bake(device="cpu")
    assert deep.bw_rows is None and deep.bvh_pairs is None
    assert int((deep.data.bvh.node_count == 0).sum()) == deep.n_tris - 1 > cluster.STACK_SIZE
    with pytest.raises(ValueError, match="stack"):
        cluster.pack_bvh_pairs(deep.data.bvh)
    got = render(deep)
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    assert torch.equal(got, want)


def test_deep_tree_of_a_bvh_tier_scene_is_refused(monkeypatch):
    """Above 2048 triangles the bake builds the two-box table, and refuses a
    tree deeper than the any-hit kernel's stack rather than let a walk
    overflow it."""
    from fyp_bidirectionalpathtracer_tpu_torch.accel import bvh as bvh_mod

    built = cornell_box()
    built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=4))
    monkeypatch.setattr(bvh_mod, "build_bvh", _chain_builder(bvh_mod.build_bvh))
    with pytest.raises(ValueError, match="stack"):
        Scene.from_built(built, aspect=1.6).bake(device="cpu")
