"""K1's device program and the BVH walk of its textured variant, on the CPU.

`csrc/frame_program.cuh` and `csrc/bvh.cuh` are plain C++ apart from the
`BDPT_DEV` qualifier and two bit-cast intrinsics, so a small harness
compiles them with g++ (`-O1 -ffp-contract=off`: no FMA contraction, as
the plain versions round every operation) into a shared library loaded with
ctypes.  The tests hold:

- `frame_pixel<3, true>` (every ray query through the walk) on the
  textured room and `frame_pixel<3, false>` (the dense pair loop) on
  Cornell + icosphere (1,314 triangles) against `accel/frame.frame_plain`
  on the same `FrameArgs`, in two cases:
  - "rounded": both sides take their elementary functions (sqrt, sin, cos,
    exp, log, pow) in float64 rounded to float32, so both round them alike;
    then every output is equal bit for bit, NaN where the plain version has
    NaN, apart from the sign of zero: where a camera throughput is zero the
    program stores +0 for the estimator-1 parts (its zero-throughput guard)
    and the plain version the product, -0 on some pixels;
  - "native": each side its own functions.  torch's CPU sqrt is not
    correctly rounded (sqrt(2.586596f) gives 1.6082897, where the correctly
    rounded value, sqrtf's, is 1.6082898), and torch's sin, cos, exp, log
    and pow differ from the C library's in the last bit for some arguments;
    the G-buffer's distance row takes the first on 4 of 768 textured-room
    pixels, the sampled directions the second, and the later bounces carry
    them on.  So every float row is held within rtol 1e-4, atol 1e-6, and
    the hits bit for bit: splat pixel ids, rgb8e payloads, the records'
    texture slots and lobes and the G-buffer's valid row;
- the program over the rows of 2 and 3 shards (`FrameParams.pix0`,
  `n_sub`: global pixel ids, outputs of the shard's pixels, the dead
  splat W*H): each shard bit for bit against the plain version's shard
  ("rounded"), and the shards side by side bit for bit against the
  whole-image launch;
- the walk (`bvh_closest_hit`, `bvh_occluded` over the 12-float rows)
  against the dense pair loops (`closest_hit<true>`, `occluded<true>`) on
  axis-aligned and grazing rays of both scenes: t, ids and occlusion bit for
  bit.

The kernels themselves need the card: `tests/test_torch_cuda.py`.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import (
    cornell_box,
    icosphere,
    textured_room,
)
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig
from torch_threads import one_intra_op_thread  # noqa: F401

CSRC = (Path(__file__).resolve().parent.parent / "fyp_bidirectionalpathtracer_tpu_torch"
        / "csrc")
W, H, D = 32, 24, 3
FRAME = 0x1337

HARNESS = r"""
#include <math.h>
#include <string.h>
// the program's elementary functions: the C library's, or (rounded 1)
// float64 rounded to float32, as the "rounded" case gives the plain version
static int rounded = 0;
static inline float h_sqrtf(float x) { return rounded ? (float)sqrt((double)x) : sqrtf(x); }
static inline float h_sinf(float x) { return rounded ? (float)sin((double)x) : sinf(x); }
static inline float h_cosf(float x) { return rounded ? (float)cos((double)x) : cosf(x); }
static inline float h_expf(float x) { return rounded ? (float)exp((double)x) : expf(x); }
static inline float h_logf(float x) { return rounded ? (float)log((double)x) : logf(x); }
static inline float h_powf(float x, float y) {
  return rounded ? (float)pow((double)x, (double)y) : powf(x, y);
}
#define sqrtf h_sqrtf
#define sinf h_sinf
#define cosf h_cosf
#define expf h_expf
#define logf h_logf
#define powf h_powf
#define BDPT_DEV static inline
static inline int __float_as_int(float x) { int i; memcpy(&i, &x, 4); return i; }
static inline float __int_as_float(int i) { float x; memcpy(&x, &i, 4); return x; }
#include "frame_program.cuh"
using namespace bdpt;

// frame_pixel<d, textured> on every pixel of the launch (n_sub from pix0):
// d = 3 textured, 1..3 untextured
extern "C" void frame_pixels(const FrameParams* p, int d, int textured, int rn,
                             const float* lights, const float* bw, const float* nodes,
                             const float* tris, float* res, float* gbuf, int* splat_pix,
                             int* splat_pay, float* splat_rgba, float* vrec, float* e1,
                             float* e3) {
  rounded = rn;
  const FrameOutPtrs out = {res, gbuf, splat_pix, splat_pay, splat_rgba, vrec, e1, e3};
  for (int lin = 0; lin < p->n_sub; ++lin) {
    if (textured)
      frame_pixel<3, true>(*p, lights, bw, nodes, tris, lin, out);
    else if (d == 1)
      frame_pixel<1, false>(*p, lights, bw, nodes, tris, lin, out);
    else if (d == 2)
      frame_pixel<2, false>(*p, lights, bw, nodes, tris, lin, out);
    else
      frame_pixel<3, false>(*p, lights, bw, nodes, tris, lin, out);
  }
}

// rays [n, 8]: o, d, tmin, tmax; mode 0 closest, 1 closest with back-face
// culling, 2 any hit; walk 1 the BVH walk, 0 the dense loop
extern "C" void trace(const float* rays, int n, const float* bw, int n_tris,
                      const float* nodes, int mode, int walk, float* t_out, int* id_out) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 8 * i;
    const V3 o = mk3(r[0], r[1], r[2]), d = mk3(r[3], r[4], r[5]);
    float t = 0.0f;
    int id;
    if (mode == 2)
      id = walk ? bvh_occluded<false, kBwCols>(bw, nodes, o, d, r[6], r[7], nullptr)
                : occluded<true>(bw, n_tris, o, d, r[6], r[7]);
    else if (walk)
      id = bvh_closest_hit<false, kBwCols>(bw, nodes, o, d, r[6], r[7], mode == 1, t, nullptr);
    else
      id = closest_hit<true>(bw, n_tris, o, d, r[6], r[7], mode == 1, t);
    t_out[i] = t;
    id_out[i] = id;
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the device program for the CPU")
    tmp = tmp_path_factory.mktemp("frame_walk")
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "libframe_walk.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), str(tmp / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    out = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    out.frame_pixels.argtypes = [p, i, i, i] + [p] * 12
    out.trace.argtypes = [p, i, p, i, p, i, i, p, p]
    return out


def _bake(name):
    if name == "textured_room":
        built = textured_room()
    else:
        built = cornell_box()
        built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    return Scene.from_built(built, aspect=W / H).bake(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return {name: _bake(name) for name in ("textured_room", "cornell_icosphere")}


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _bw(baked):
    return baked.tri_pack[:baked.n_tris, :frame_mod.BW_COLS].contiguous()


ROUNDED = ("sqrt", "sin", "cos", "exp", "log", "pow")


def _device_frame(lib, args, baked, rounded, monkeypatch):
    """frame_pixel<d_max, textured> on every pixel, into zeroed rows shaped as
    frame_plain's outputs; `rounded`: both sides' elementary functions in
    float64 rounded to float32."""
    if rounded:
        for name in ROUNDED:
            fn = getattr(torch, name)
            monkeypatch.setattr(torch, name,
                                lambda x, *a, fn=fn: fn(x.double(), *a).to(torch.float32))
    want = frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack)
    monkeypatch.undo()
    got = frame_mod.FrameOut(**{k: None if v is None else torch.zeros_like(v)
                                for k, v in vars(want).items()})
    params, bw = frame_mod._params(args), _bw(baked)  # bw lives through the call
    lib.frame_pixels(ctypes.byref(params), args.d_max, int(args.textured), int(rounded),
                     _ptr(baked.light_rows), _ptr(bw), _ptr(baked.bvh_nodes),
                     _ptr(baked.tri_pack),
                     *(_ptr(getattr(got, k)) for k in ("res", "gbuf", "splat_pix", "splat_pay",
                                                      "splat_rgba", "vrec", "e1_parts",
                                                      "e3_parts")))
    return got, want


def _bit_equal(a, b):
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_rows_match(got, want, rounded, exact_rows):
    """Integer outputs bit for bit.  Rounded: every float output bit for
    bit, NaN where the plain version has NaN, a zero of either sign where it
    has zero.  Native: every float row within rtol 1e-4, atol 1e-6 (NaN
    where NaN) and the rows `exact_rows` (name -> row indices) bit for bit."""
    for name, w in vars(want).items():
        if w is None:
            continue
        g = getattr(got, name)
        if w.dtype != torch.float32:
            assert torch.equal(g, w), name
        elif rounded:
            same = ((g.view(torch.int32) == w.view(torch.int32)) | ((g == 0) & (w == 0))
                    | (g.isnan() & w.isnan()))
            assert bool(same.all()), (name, int((~same).sum()))
        else:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6, equal_nan=True, msg=name)
            rows = exact_rows.get(name, [])
            assert _bit_equal(g[rows], w[rows]), name


@pytest.mark.parametrize("rounded", [False, True], ids=["native", "rounded"])
def test_textured_program_with_walk_matches_plain(lib, scenes, rounded, monkeypatch):
    baked = scenes["textured_room"]
    cfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(max_depth=D, defer_textures=True))
    args = frame_mod.frame_args(baked, W, H, FRAME, pixel_jitter_for_frame(FRAME), cfg)
    assert args.textured and args.n_tris == 342
    got, want = _device_frame(lib, args, baked, rounded, monkeypatch)
    # per vertex record: u, v, base-colour slot, is_spec, base rgb; then the
    # primary hit's emissive slot
    slots = [r for k in range(2 * D) for r in (7 * k + 2, 7 * k + 3)] + [14 * D]
    _assert_rows_match(got, want, rounded, {"gbuf": [3], "vrec": slots})
    assert int((want.splat_pix < args.n_pix).sum()) > 0


@pytest.mark.parametrize("rounded", [False, True], ids=["native", "rounded"])
def test_untextured_program_matches_plain(lib, scenes, rounded, monkeypatch):
    baked = scenes["cornell_icosphere"]
    cfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(max_depth=D))
    args = frame_mod.frame_args(baked, W, H, FRAME, pixel_jitter_for_frame(FRAME), cfg,
                                splat_rgb8e=True)
    assert not args.textured and args.n_tris == 1314
    got, want = _device_frame(lib, args, baked, rounded, monkeypatch)
    _assert_rows_match(got, want, rounded, {"gbuf": [3]})
    assert int((want.splat_pix < args.n_pix).sum()) > 0


@pytest.mark.parametrize("d", [1, 2])
def test_untextured_program_matches_plain_at_low_depth(lib, scenes, d, monkeypatch):
    """The untextured program at d = 1 and 2 (one or two light vertices, no
    or one est-3 connection), "rounded": bit for bit as at d = 3."""
    baked = scenes["cornell_icosphere"]
    cfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(max_depth=d))
    args = frame_mod.frame_args(baked, W, H, FRAME, pixel_jitter_for_frame(FRAME), cfg,
                                splat_rgb8e=True)
    assert args.d_max == d
    got, want = _device_frame(lib, args, baked, True, monkeypatch)
    _assert_rows_match(got, want, True, {})
    assert int((want.splat_pix < args.n_pix).sum()) > 0


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", ["textured_room", "cornell_icosphere"])
def test_program_shards_match_whole_frame(lib, scenes, name, n, monkeypatch):
    """The program over n row shards ("rounded"): each shard's outputs
    equal the plain version's shard (as the whole frame's do), and the
    shards side by side equal the whole-image launch bit for bit."""
    from dataclasses import replace

    baked = scenes[name]
    textured = name == "textured_room"
    cfg = RenderConfig(width=W, height=H, bdpt=BDPTConfig(max_depth=D, defer_textures=textured))
    args = frame_mod.frame_args(baked, W, H, FRAME, pixel_jitter_for_frame(FRAME), cfg,
                                splat_rgb8e=not textured)
    whole, _ = _device_frame(lib, args, baked, True, monkeypatch)
    sub = H // n * W
    shards = []
    for r in range(n):
        got, want = _device_frame(lib, replace(args, pix0=r * sub, sub_pixels=sub), baked,
                                  True, monkeypatch)
        _assert_rows_match(got, want, True, {})
        shards.append(got)
    for name_, w in vars(whole).items():
        if w is not None:
            assert _bit_equal(torch.cat([getattr(s, name_) for s in shards], -1), w), name_
    dead = whole.splat_pix == args.n_pix
    assert 0 < int(dead.sum()) < dead.numel()


def _rays(baked, seed):
    """[n, 8] rays inside the scene's box: axis-aligned (the six axis
    directions, from random origins, from origins on the box's faces, and
    onto the edge midpoints and vertices of the triangles whose plane is
    axis-aligned, where neighbours tie in t and the lowest id must win),
    and grazing (directions within ~1e-4 rad of a triangle's plane, from
    points on that triangle's edges and inside it); t in (1e-3, 1e30) or
    up to a random t_max."""
    rng = np.random.default_rng(seed)
    lo = baked.data.bvh.node_min[0].numpy().astype(np.float64)
    hi = baked.data.bvh.node_max[0].numpy().astype(np.float64)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    o_in = lo + (hi - lo) * rng.random((300, 3))
    o_face = lo + (hi - lo) * rng.random((300, 3))
    k = rng.integers(0, 3, 300)
    o_face[np.arange(300), k] = np.where(rng.random(300) < 0.5, lo[k], hi[k])
    o_ax = np.concatenate([o_in, o_face])
    d_ax = axes[rng.integers(0, 6, o_ax.shape[0])]
    # onto the shared edges and corners of axis-aligned triangles, along
    # the plane's axis from a quarter of the box away
    v0, e1, e2 = (getattr(baked.tris, k).numpy().astype(np.float64) for k in ("v0", "e1", "e2"))
    nrm = np.cross(e1, e2)
    flat = (np.abs(nrm) > 0).sum(1) == 1
    axis = np.abs(nrm[flat]).argmax(1)
    a0, a1, a2 = v0[flat], v0[flat] + e1[flat], v0[flat] + e2[flat]
    targets = np.concatenate([(a0 + a1) / 2, (a1 + a2) / 2, (a2 + a0) / 2, a0, a1, a2])
    axis = np.tile(axis, 6)
    side = np.where(rng.random(axis.shape[0]) < 0.5, -1.0, 1.0)
    d_tie = np.zeros_like(targets)
    d_tie[np.arange(axis.shape[0]), axis] = side
    o_tie = targets - d_tie * 0.25 * (hi - lo).max()
    o_ax, d_ax = np.concatenate([o_ax, o_tie]), np.concatenate([d_ax, d_tie])
    # grazing: pick triangles, a point on an edge or inside, a direction in
    # the plane tilted by a tiny angle
    tri = rng.integers(0, baked.n_tris, 600)
    v0, e1, e2 = v0[tri], e1[tri], e2[tri]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    a, b = rng.random((2, 600, 1))
    on_edge = rng.random((600, 1)) < 0.5
    a = np.where(on_edge, a, a * (1 - b))
    b = np.where(on_edge, 1 - a, b)
    pts = v0 + a * e1 + b * e2
    in_plane = np.cross(n, rng.standard_normal((600, 3)))
    in_plane /= np.linalg.norm(in_plane, axis=1, keepdims=True)
    tilt = rng.choice([0.0, 1e-6, -1e-6, 1e-4, -1e-4], (600, 1))
    d_gr = in_plane + tilt * n
    # back off along the direction so the ray crosses the triangle's plane
    o_gr = pts - d_gr * rng.random((600, 1)) * 0.3
    o = np.concatenate([o_ax, o_gr])
    d = np.concatenate([d_ax, d_gr])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full((o.shape[0], 1), 1e-3)
    tmax = np.where(rng.random((o.shape[0], 1)) < 0.5, 1e30,
                    rng.random((o.shape[0], 1)) * float(np.linalg.norm(hi - lo)))
    return torch.from_numpy(np.concatenate([o, d, tmin, tmax], 1).astype(np.float32))


@pytest.mark.parametrize("name", ["textured_room", "cornell_icosphere"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_walk_bit_equal_to_dense_loop(lib, scenes, name, mode):
    baked = scenes[name]
    rays = _rays(baked, seed=mode).contiguous()
    if mode != 2:  # closest hit over the whole ray
        rays[:, 7] = 1e30
    n, bw = rays.shape[0], _bw(baked)
    out = []
    for walk in (1, 0):
        t = torch.zeros(n, dtype=torch.float32)
        ids = torch.zeros(n, dtype=torch.int32)
        lib.trace(_ptr(rays), n, _ptr(bw), baked.n_tris, _ptr(baked.bvh_nodes), mode, walk,
                  _ptr(t), _ptr(ids))
        out.append((t, ids))
    (tw, iw), (td, idd) = out
    assert torch.equal(iw, idd)
    assert _bit_equal(tw, td)
    hits = int((idd > 0).sum() if mode == 2 else (idd >= 0).sum())
    assert 0 < hits < n
