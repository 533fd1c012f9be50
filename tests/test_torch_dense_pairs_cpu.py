"""The dense tier's pair loops (`csrc/intersect.cuh`) on the CPU.

The any-hit loop `occluded` runs in the dense any-hit kernel (K4b/K4d)
and in K1's untextured shadow rays; the closest loop `closest_hit` in the
dense closest and shaded kernels and K1's untextured closest queries.  The
header is plain C++ apart from `BDPT_DEV` and two bit-cast intrinsics, so
a small harness compiles it with g++ (`-O1 -ffp-contract=off`: no FMA
contraction, as the plain versions round every operation) into a shared
library loaded with ctypes.  The tests hold, on the Cornell box (34
triangles), the textured room (342) and Cornell + icosphere (1,314):

- `occluded<true>` bit for bit against the plain version
  (`accel/intersect.any_hit_rows`), and `closest_hit<true>` (culling on
  and off) against `accel/intersect.closest_rows`: t, id, u and v.  The
  rays: axis-aligned, onto shared edges (ties), grazing; shadow rays
  between surface points with empty, NaN and dead lanes, as the any-hit
  kernel lists and answers them; and rays whose rounded t on one triangle
  lands exactly on t_min or t_max, or one float beside it;
- the dense closest and shaded kernels' step, `closest_hit_rays<R>` for R
  = 1, 2 and 4 under their schedule `closest_tiles` (tiles of threads x R
  rays over a grid-stride loop of blocks, a ray past the batch traced as
  the empty ray), likewise against `closest_rows`, culling on and off, on
  all those rays at once: a count that is no multiple of R or of a tile,
  over a few small grids;
- that those boundary rays reach the edge: with `>=` and `<=` in place of
  the any-hit test's `>` and `<` on t (a copy of the header patched in the
  test's own directory) some of them get another answer.

The kernels themselves need the card: `tests/test_torch_cuda.py`.
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
from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect as isect
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import (
    cornell_box,
    icosphere,
    textured_room,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from torch_threads import one_intra_op_thread  # noqa: F401

CSRC = (Path(__file__).resolve().parent.parent / "fyp_bidirectionalpathtracer_tpu_torch"
        / "csrc")
RANGE = "if (!(t > tmin && t < tmax)) continue;"
CLOSED_RANGE = "if (!(t >= tmin && t <= tmax)) continue;"

HARNESS = r"""
#include <math.h>
#include <string.h>
#define BDPT_DEV static inline
static inline int __float_as_int(float x) { int i; memcpy(&i, &x, 4); return i; }
static inline float __int_as_float(int i) { float x; memcpy(&x, &i, 4); return x; }
#include "intersect.cuh"
using namespace bdpt;

// rays [n, 8]: o, d, tmin, tmax -> occluded<true>
extern "C" void any_hit(const float* rays, int n, const float* bw, int n_tris, int* out) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 8 * i;
    out[i] = occluded<true>(bw, n_tris, mk3(r[0], r[1], r[2]), mk3(r[3], r[4], r[5]), r[6],
                            r[7]);
  }
}

// rays [n, 8]: closest_hit<true>, back-face culling if `cull`; u, v of the
// winner's row
extern "C" void closest(const float* rays, int n, const float* bw, int n_tris, int cull,
                        float* t_out, int* id_out, float* u_out, float* v_out) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 8 * i;
    const V3 o = mk3(r[0], r[1], r[2]), d = mk3(r[3], r[4], r[5]);
    float t, u = 0.0f, v = 0.0f;
    const int id = closest_hit<true>(bw, n_tris, o, d, r[6], r[7], cull, t);
    if (id >= 0) hit_uv<true>(bw + (size_t)id * kBwCols, o, d, t, u, v);
    t_out[i] = t;
    id_out[i] = id;
    u_out[i] = u;
    v_out[i] = v;
  }
}

// rows [8, n] as the closest and shaded kernels take them: `blocks` blocks
// of `threads` threads in turn, each thread its rays (closest_tiles<R>),
// culling if `cull`; u, v of the winner's row
template <int R>
static void closest_tiles_of(const float* rows, int n, const float* bw, int n_tris, int cull,
                             int threads, int blocks, float* t_out, int* id_out, float* u_out,
                             float* v_out) {
  for (int b = 0; b < blocks; ++b)
    for (int j = 0; j < threads; ++j)
      closest_tiles<R>(rows, (size_t)n, bw, n_tris, cull != 0, b, blocks, j, threads,
                       [&](size_t i, V3 o, V3 d, float t, int id) {
                         float u = 0.0f, v = 0.0f;
                         if (id >= 0) hit_uv<true>(bw + (size_t)id * kBwCols, o, d, t, u, v);
                         t_out[i] = t;
                         id_out[i] = id;
                         u_out[i] = u;
                         v_out[i] = v;
                       });
}

extern "C" void closest_rays(const float* rows, int n, const float* bw, int n_tris, int cull,
                             int r, int threads, int blocks, float* t_out, int* id_out,
                             float* u_out, float* v_out) {
  if (r == 4)
    closest_tiles_of<4>(rows, n, bw, n_tris, cull, threads, blocks, t_out, id_out, u_out, v_out);
  else if (r == 2)
    closest_tiles_of<2>(rows, n, bw, n_tris, cull, threads, blocks, t_out, id_out, u_out, v_out);
  else
    closest_tiles_of<1>(rows, n, bw, n_tris, cull, threads, blocks, t_out, id_out, u_out, v_out);
}
"""


def _build(tmp, include):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the pair loops for the CPU")
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "libdense_loops.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(include), "-I", str(CSRC), str(tmp / "harness.cpp"), "-o",
                    str(so)], check=True, capture_output=True, timeout=300)
    out = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    out.any_hit.argtypes = [p, i, p, i, p]
    out.closest.argtypes = [p, i, p, i, i, p, p, p, p]
    out.closest_rays.argtypes = [p, i, p, i, i, i, i, i, p, p, p, p]
    return out


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dense_loops")
    return _build(tmp, CSRC)


@pytest.fixture(scope="module")
def closed_range_lib(tmp_path_factory):
    """The any-hit loop with `>=` and `<=` in its test of t: a copy of the
    header patched in the test's directory, found first on the include
    path."""
    tmp = tmp_path_factory.mktemp("dense_loops_closed_range")
    src = (CSRC / "intersect.cuh").read_text()
    assert src.count(RANGE) == 1
    (tmp / "intersect.cuh").write_text(src.replace(RANGE, CLOSED_RANGE))
    return _build(tmp, tmp)


def _bake(name):
    if name == "textured_room":
        built = textured_room()
    else:
        built = cornell_box()
        if name == "cornell_icosphere":
            built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    return Scene.from_built(built, aspect=1.6).bake(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return {name: _bake(name) for name in ("cornell", "textured_room", "cornell_icosphere")}


@pytest.fixture(scope="module")
def plain_closest(scenes):
    """closest_rows's (t, id int32, u, v) on `_closest_rays_for`'s rays, by
    (scene, kind, cull), each computed once for the module's tests."""
    cache = {}

    def get(name, kind, cull):
        if (name, kind, cull) not in cache:
            baked = scenes[name]
            o, d, tmin, tmax = _components(_closest_rays_for(baked, kind))
            _, t, ids = isect.closest_rows(baked.tri_pack, baked.n_tris, o, d, tmin, tmax, cull)
            hit = ids >= 0
            u, v = isect.winner_uv(baked.tri_pack[ids.clamp(min=0)], o, d, t)
            cache[name, kind, cull] = (t, ids.to(torch.int32), torch.where(hit, u, 0.0),
                                       torch.where(hit, v, 0.0))
        return cache[name, kind, cull]

    return get


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _bw(baked):
    return baked.tri_pack[:baked.n_tris, :cluster.BW_COLS].contiguous()


def _surface_points(baked, rng, n):
    """Random points inside random triangles [n, 3] (float64) and their ids."""
    tri = rng.integers(0, baked.n_tris, n)
    v0, e1, e2 = (getattr(baked.tris, k).numpy().astype(np.float64)[tri]
                  for k in ("v0", "e1", "e2"))
    a, b = rng.random((2, n, 1)) * 0.98 + 0.01
    flip = a + b > 1.0
    a, b = np.where(flip, 1.0 - a, a), np.where(flip, 1.0 - b, b)
    return v0 + a * e1 + b * e2, tri


def _shadow_rays(baked, seed):
    """Shadow rays between surface points, as the estimators trace them
    (t in (1e-3, length - 1e-3)); 30% of the lanes empty (t_max = 0), and
    dead lanes: t_max < t_min, t_max = t_min, a NaN in the origin or the
    direction."""
    rng = np.random.default_rng(seed)
    a, _ = _surface_points(baked, rng, 1500)
    b, _ = _surface_points(baked, rng, 1500)
    vec = b - a
    length = np.linalg.norm(vec, axis=1, keepdims=True)
    ok = length[:, 0] > 1e-2
    a, vec, length = a[ok], vec[ok], length[ok]
    n = a.shape[0]
    tmax = np.where(rng.random((n, 1)) < 0.3, 0.0, length - 1e-3)
    rays = np.concatenate([a, vec / length, np.full((n, 1), 1e-3), tmax], 1)
    dead = rays[rng.integers(0, n, 200)].copy()
    dead[:50, 7] = dead[:50, 6] * 0.5
    dead[50:100, 7] = dead[50:100, 6]
    dead[np.arange(100, 150), rng.integers(0, 3, 50)] = np.nan
    dead[np.arange(150, 200), rng.integers(3, 6, 50)] = np.nan
    return torch.from_numpy(np.concatenate([rays, dead]).astype(np.float32))


def _boundary_rays(baked, seed):
    """Rays onto points inside random triangles whose t on that triangle,
    rounded as the kernels round it (one float32 operation at a time, in
    their order), is t_min, t_max or one float beside either: the edge of
    the pair test's interval.  Four intervals a ray: (t, inf), (t-, inf), (1e-3, t), (1e-3, t+),
    where t- and t+ are the floats beside t; the first and third exclude
    the pair, the others keep it."""
    rng = np.random.default_rng(seed)
    target, tri = _surface_points(baked, rng, 1500)
    d = rng.standard_normal((1500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = target - d * rng.uniform(0.05, 1.0, (1500, 1))
    o, d = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    r = baked.tri_pack[torch.from_numpy(tri)]
    ndir = r[:, 0] * d[:, 0] + r[:, 1] * d[:, 1] + r[:, 2] * d[:, 2]
    num = r[:, 3] - (r[:, 0] * o[:, 0] + r[:, 1] * o[:, 1] + r[:, 2] * o[:, 2])
    keep = ndir.abs() > 1e-3
    o, d, t = o[keep], d[keep], (num / ndir)[keep]
    assert bool((t > 1e-3).all())
    inf, lo = torch.full_like(t, float("inf")), torch.full_like(t, 1e-3)
    cases = [(t, inf), (torch.nextafter(t, -inf), inf), (lo, t), (lo, torch.nextafter(t, inf))]
    return torch.cat([torch.cat([o, d, a[:, None], b[:, None]], 1) for a, b in cases])


def _rays_for(baked, seed, kind):
    if kind == "boundary":
        return _boundary_rays(baked, seed).contiguous()
    if kind == "shadow":
        return _shadow_rays(baked, seed).contiguous()
    return _rays(baked, seed=seed).contiguous()


def _closest_rays_for(baked, kind):
    """The closest loops' rays of one kind; walk rays over the whole ray
    (t_max 1e30), as K1 asks."""
    rays = _rays_for(baked, 4, kind)
    if kind == "walk":
        rays[:, 7] = 1e30
    return rays


def _any_hit(lib, baked, rays):
    out = torch.zeros(rays.shape[0], dtype=torch.int32)
    bw = _bw(baked)
    lib.any_hit(_ptr(rays), rays.shape[0], _ptr(bw), baked.n_tris, _ptr(out))
    return out.bool()


def _closest(lib, baked, rays, cull):
    n = rays.shape[0]
    t, u, v = (torch.zeros(n, dtype=torch.float32) for _ in range(3))
    ids = torch.zeros(n, dtype=torch.int32)
    bw = _bw(baked)
    lib.closest(_ptr(rays), n, _ptr(bw), baked.n_tris, int(cull), _ptr(t), _ptr(ids), _ptr(u),
                _ptr(v))
    return t, ids, u, v


def _components(rays):
    c = [rays[:, k].contiguous() for k in range(8)]
    return tuple(c[0:3]), tuple(c[3:6]), c[6], c[7]


def _bits(x):
    return x.contiguous().view(torch.int32)


SCENES = ["cornell", "textured_room", "cornell_icosphere"]
KINDS = ["walk", "shadow", "boundary"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_any_hit_loop_bit_equal(lib, scenes, name, kind):
    baked = scenes[name]
    rays = _rays_for(baked, 3, kind)
    got = _any_hit(lib, baked, rays)
    o, d, tmin, tmax = _components(rays)
    assert torch.equal(isect.any_hit_rows(baked.tri_pack, baked.n_tris, o, d, tmin, tmax), got)
    assert 0 < int(got.sum()) < rays.shape[0]


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("kind", ["walk", "boundary"])
@pytest.mark.parametrize("name", SCENES)
def test_closest_loop_bit_equal(lib, scenes, plain_closest, name, kind, cull):
    baked = scenes[name]
    got = _closest(lib, baked, _closest_rays_for(baked, kind), cull)
    want = plain_closest(name, kind, cull)
    assert torch.equal(want[1], got[1])
    for w, g in zip(want[:1] + want[2:], got[:1] + got[2:]):
        assert torch.equal(_bits(w), _bits(g))
    assert 0 < int((want[1] >= 0).sum()) < want[1].numel()


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("r", [1, 2, 4])
def test_closest_rays_step_bit_equal(lib, scenes, plain_closest, r, name, cull):
    """closest_hit_rays<r> under closest_tiles<r>, the closest and shaded
    kernels' schedule, bit for bit against closest_rows on the walk (ties,
    grazing), shadow (empty, dead and NaN lanes) and boundary rays at once:
    4k + 3 rays, no multiple of r or of a tile, over grids of 1-4 blocks of
    3-64 threads, so tiles and threads end part-full and blocks take one
    tile or several; every ray answered once, and nothing written past the
    n rays (64 guard outputs that must keep their fill)."""
    baked = scenes[name]
    kinds = ("walk", "shadow", "boundary")
    rays = torch.cat([_closest_rays_for(baked, kind) for kind in kinds])
    want = [torch.cat(x) for x in zip(*(plain_closest(name, kind, cull) for kind in kinds))]
    n = rays.shape[0] - (rays.shape[0] - 3) % 4
    want = [w[:n] for w in want]
    rows = rays[:n].T.contiguous()
    bw = _bw(baked)
    for threads, blocks in ((3, 1), (5, 2), (6, 3), (7, 4), (64, 1), (64, 3)):
        t, u, v = (torch.full((n + 64,), 7.0) for _ in range(3))
        ids = torch.full((n + 64,), -7, dtype=torch.int32)
        lib.closest_rays(_ptr(rows), n, _ptr(bw), baked.n_tris, int(cull), r, threads, blocks,
                         _ptr(t), _ptr(ids), _ptr(u), _ptr(v))
        assert bool((ids[n:] == -7).all()) and all(bool((x[n:] == 7.0).all()) for x in (t, u, v))
        assert torch.equal(want[1], ids[:n])
        for w, g in zip(want[:1] + want[2:], (t, u, v)):
            assert torch.equal(_bits(w), _bits(g[:n]))
    hit = want[1] >= 0
    assert 0 < int(hit.sum()) < n and bool(torch.isnan(rows[:6]).any())


def test_boundary_rays_reach_the_edge(lib, closed_range_lib, scenes):
    """With `>=` and `<=` in its test of t the any-hit loop takes pairs
    whose rounded t is t_min or t_max, and some answers on the boundary
    rays change."""
    changed = 0
    for name in SCENES:
        baked = scenes[name]
        rays = _boundary_rays(baked, 5).contiguous()
        changed += int((_any_hit(closed_range_lib, baked, rays)
                        != _any_hit(lib, baked, rays)).sum())
    assert changed > 0
