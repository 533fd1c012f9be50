"""The BVH any-hit kernel's walk and its tables, on the CPU.

`csrc/bvh_anyhit.cuh` (the two-box walk with a short stack) is plain C++
apart from `BDPT_DEV`, two bit-cast intrinsics and `load4`, its 16-byte
read, so a small harness defines those (`load4` with memcpy) and g++
compiles it (`-O1 -ffp-contract=off`: no FMA contraction, as the plain
versions round every operation) into a shared library loaded with ctypes.
The tests hold:

- the walk (`bvh_any_hit` over the bake's two-box table and Baldwin-Weber
  rows) bit for bit against the dense pair loop (`occluded<true>`) and the
  threaded walk it replaces (`bvh_occluded`), on pink_room (10,546
  triangles) and Cornell + icosphere (1,314): axis-aligned rays, rays onto
  the shared edges of axis-aligned triangles, grazing rays, and lanes that
  need no walk (t_max = 0, t_max < t_min, t_max = t_min, NaN origins and
  directions);
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
#include "bvh_anyhit.cuh"
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
    """name -> (bake, its any-hit tables): the bake's own above 2048
    triangles, made by `any_hit_tables` below, where the bake has none."""
    out = {}
    for name in ("pink_room", "cornell_icosphere"):
        baked = _bake(name)
        tables = cluster.any_hit_tables(baked.data.bvh, baked.tri_pack)
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


def test_one_leaf_tree(lib, scenes):
    """A tree that is one leaf: one row, the leaf beside an empty leaf; the
    walk over it equals the dense loop on the leaf's triangles."""
    baked, bake_rows, _ = scenes["cornell_icosphere"]
    lo, hi = baked.data.bvh.node_min[:1], baked.data.bvh.node_max[:1]
    one = BVHArrays(node_min=lo, node_max=hi, node_left=torch.zeros(1, dtype=torch.int32),
                    node_count=torch.tensor([3], dtype=torch.int32),
                    node_hit=torch.tensor([-1], dtype=torch.int32),
                    node_miss=torch.tensor([-1], dtype=torch.int32),
                    tri_order=torch.arange(3, dtype=torch.int32))
    pairs = cluster.pack_bvh_pairs(one)
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
