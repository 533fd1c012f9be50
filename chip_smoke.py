"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds every hand-written kernel from `fyp_bidirectionalpathtracer_tpu_
torch/csrc/` (one nvcc process a source, in parallel): K1 (frame
megakernel, and its textured variant `frame_textured`, whose ray queries
walk the BVH of `csrc/bvh.cuh`), K2 (splat compaction), K3 (splat tile
reduction of rgb8e updates) and K5 (`splat_rows`, the tiled splat
reduction of unpacked rows), one kernel template in `csrc/splat_rows.cu`,
the dense K4 intersectors (closest, shaded, any-hit), the BVH kernels that
replace the cluster and HBM tiers K4f-K4j (bvh_closest, bvh_shaded and
bvh_occluded, which walk the two-box BVH of `csrc/bvh_pairs.cuh`) and K6
(`subpath`, the fused subpath builder).  Holds each against its plain
PyTorch version at the shapes its path gives it (K1 also at every depth the
gate admits; K3 bit for bit against a sequential sum; the BVH kernels bit
for bit, on pink_room at 10,546, 41,266 and 164,146 triangles), then
drives the paths through their
entry points at 1280x720, depth 3, BMFR off: on the Cornell box the
megakernel main path (K1 -> K2 -> sort -> K3) and the per-bounce wavefront
(`megakernel="off"`: G-buffer and subpath extensions through the shaded
kernel, three shadow batches through the any-hit kernel, the estimator-2
splat through K2 -> sort -> K3); pink_room (`models/pink_room`, procedural
textures, default config), which the megakernel gate sends to the
wavefront: the BVH shaded kernel with the texture taps, the BVH any-hit
kernel, the splat chain (and, at 41,266 and 164,146 triangles, the BVH
closest kernel with the attribute and texture gathers); the textured room
(`models/procedural.textured_room`) with `defer_textures=True`, the
deferred-texture megakernel (K1's textured variant, the replay, and the
splat through K2 -> sort -> K3 with "auto" or K5 with "tiled"), beside its
wavefront; and `accel/subpath.build_subpath` (K6) on 921,600 Cornell rays.
Each path is run with the launch counts set to 0 just before it and read
just after; two renders of one frame must be bit-identical, the wavefront
frames must agree with their plain chains (Cornell also with the
megakernel frame, the textured room with both of its megakernel frames),
and small renders must match the checked-in goldens.

K1's bound counts the ray queries of the rays its plain version traces as
the kernel runs them: the textured variant's walk (node slab tests and
pair tests by stage, from the BVH kernels' counting walk), the untextured
dense loops' pair tests; the other count is printed beside it.  The BVH
kernels' bounds count their two-box walks (the closest kernels' on the
G-buffer rays and, as `extension_bound_ms`, on an extension batch), with
the threaded walk's count beside them.  K3 and K5 are printed beside
`index_add_` of the same rows, each timed as eager calls (`ms`,
`library_ms`, as every kernel is) and as CUDA-graph replays (`graph_ms`,
`library_graph_ms`), which leave out the host's cost of each call; K3 also
with that host cost (`host_us`, `library_host_us`).

Exits nonzero on any failure and without a CUDA device.  The last line of
standard output is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the line before that lists the kernels
with their launch counts, errors, times and bounds.
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time
import zlib
from dataclasses import replace
from functools import partial

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, DEPTH = 1280, 720, 3
RAYS_PER_PIXEL = 16      # bench.py's accounting at depth 3
LIVE_FRAC = 0.15         # est-2 live share on the Cornell frame
GOLDEN = os.path.join(REPO, "tests", "golden", "cornell_bdpt_8f_64.png")
MIN_PSNR = 38.0          # the JAX package's golden bar
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# mul/add/sub/div of a Baldwin-Weber pair test (csrc/intersect.cuh) by the
# stage it reaches: n.d; t where dir_ok; u, v and u + v where t is in range
STAGE_FLOPS = (5, 7, 27)
MIN_T = 1e-3                 # BDPTConfig.min_t
# operations of one slab test of the BVH walk (csrc/bvh.cuh slab_visit):
# per axis 2 sub, 2 mul, a min and a max; 2 max and 2 min across the axes;
# the widening's 2 abs, 2 mul, 2 add; 3 compares
SLAB_FLOPS = 31
PINK_SAMPLE = 14             # every 14th ray of a 1280x720 batch: 65,829 rays
GOLDEN_PINK = os.path.join(REPO, "tests", "golden", "pink_room_fallback_2f_64x40.png")


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call on the device, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int = 20) -> float:
    """Mean ms per call on the device of `iters` calls captured in one CUDA
    graph and replayed: for kernels of ~20 us, which eager calls leave
    waiting on the host's cost of each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, 5) / iters


def bound(n_bytes: float, flops: float) -> dict:
    """The least time of a function: bytes over the memory rate or flops
    over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def pair_flops(isect, tris, o, d, tmin, tmax, cull: bool, closest: bool) -> int:
    """Operations the kernels' pair loop needs on rays [N] (component
    tuples o, d; tmin, tmax [N]) against the triangle rows `tris`, by the
    stage each pair reaches (STAGE_FLOPS): closest hit visits every
    triangle and takes the third stage where t lies between tmin and the
    best t of the lower ids so far; any-hit stops at its first hit and
    takes the third stage where t lies in (tmin, tmax).  Counted in
    [rays x tris] chunks from the plain pair test."""
    n_tris = tris.shape[0]
    ids = torch.arange(n_tris, device=tris.device)
    s1, s2, s3 = STAGE_FLOPS
    total = 0
    for sl in isect._ray_chunks(tmin.shape[0], n_tris):
        oc, dc = tuple(c[sl] for c in o), tuple(c[sl] for c in d)
        lo, hi = tmin[sl, None], tmax[sl, None]
        valid, t = isect._pair_test(tris, oc, dc, tmin[sl], tmax[sl], cull)
        ndir = (tris[None, :, 0] * dc[0][:, None] + tris[None, :, 1] * dc[1][:, None]
                + tris[None, :, 2] * dc[2][:, None])
        dir_ok = ndir < -1e-9 if cull else ndir.abs() > 1e-9
        if closest:
            best = torch.where(valid, t, torch.inf).cummin(1).values
            limit = torch.minimum(torch.cat([hi, best[:, :-1]], 1), hi)
            visited = torch.ones_like(valid)
        else:
            limit = hi
            first = torch.where(valid.any(1), valid.to(torch.uint8).argmax(1), n_tris - 1)
            visited = ids[None] <= first[:, None]
        reached = visited & dir_ok
        total += (s1 * int(visited.sum()) + s2 * int(reached.sum())
                  + s3 * int((reached & (t > lo) & (t < limit)).sum()))
    return total


def read_png_rgb8(path: str) -> np.ndarray:
    """Minimal reader for 8-bit RGB, non-interlaced PNG -> float32 [H,W,3]
    in [0,1] (what utils.image.read_png returns for the goldens)."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, typ = struct.unpack(">I", data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        if typ == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        elif typ == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype != 2 or interlace:
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are read")
    raw, stride = zlib.decompress(idat), w * 3
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f = raw[y * (stride + 1)]
        cur = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1).astype(np.int64)
        for x in range(stride):
            a = cur[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            if f == 1:
                cur[x] += a
            elif f == 2:
                cur[x] += b
            elif f == 3:
                cur[x] += (a + b) // 2
            elif f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[x] += a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[x] &= 0xFF
        out[y], prev = cur, cur
    return out.reshape(h, w, 3).astype(np.float32) / 255.0


def psnr_u8(img: np.ndarray, golden: np.ndarray) -> float:
    """utils.testing.golden_compare's metric: 8-bit quantise, then PSNR."""
    got = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).astype(np.float32) / 255.0
    mse = float(np.mean((got.astype(np.float64) - golden.astype(np.float64)) ** 2))
    return float("inf") if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def image_stats(a, b, frac_max=0.02, mad_max=5e-3, dmean_max=2e-3):
    """(share of pixels off by > 1e-3, mean |d|, mean radiance difference,
    ok); the defaults are the same-path CPU parity bounds."""
    d = (a - b).abs()
    frac = float((d.amax(-1) > 1e-3).float().mean())
    mad, dmean = float(d.mean()), abs(float(a[..., :3].mean() - b[..., :3].mean()))
    return frac, mad, dmean, frac <= frac_max and mad < mad_max and dmean < dmean_max


def gbuffer_rays(bk, w, h, dev):
    """The camera's jittered rays [h, w] of the main path's first frame."""
    from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import BDPT_FRAME_INIT
    from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import camera_ray_dirs

    d = camera_ray_dirs(bk.data.camera, w, h, pixel_jitter_for_frame(BDPT_FRAME_INIT),
                        device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    return bk.data.camera.pos_w.to(dev).expand(d.shape).contiguous(), d.contiguous()


def k4_rays(bk, w, h, dev, shaded=None):
    """The shapes the wavefront gives the intersectors: G-buffer rays
    [H, W] (cull on); one extension batch [H, W] (cull off): BRDF samples
    from the G-buffer hits; an est-3-shaped shadow batch [4, H, W] from the
    hits toward random points of the scene's box, 30% of the lanes empty
    (t_max = 0), as the pre-masking leaves them.  `shaded` traces the
    G-buffer (the dense kernel by default, or the BVH one)."""
    from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect as isect
    from fyp_bidirectionalpathtracer_tpu_torch.core import rng
    from fyp_bidirectionalpathtracer_tpu_torch.core.samplers import cos_hemisphere_sample
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import BDPT_FRAME_INIT

    o_g, d_g = gbuffer_rays(bk, w, h, dev)
    hit, fields = (shaded or isect.intersect_shaded_fm)(
        bk.tri_pack, bk.n_tris, origin=o_g, direction=d_g, t_min=0.0, cull_backface=True)
    pos = o_g + hit.t[..., None] * d_g
    nrm = torch.movedim(fields[4:7], 0, -1)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp(min=1e-20)
    seed = rng.pixel_seeds(w, h, BDPT_FRAME_INIT, device=dev)
    _, l_dir = cos_hemisphere_sample(seed, nrm)
    gen = torch.Generator(device=dev).manual_seed(3)
    lo = bk.data.bvh.node_min[0].to(dev)
    hi = bk.data.bvh.node_max[0].to(dev)
    target = lo + (hi - lo) * torch.rand((4, h, w, 3), generator=gen, device=dev)
    vec = target - pos
    length = vec.norm(dim=-1)
    empty = torch.rand((4, h, w), generator=gen, device=dev) < 0.3
    tmax = torch.where(empty | ~hit.hit, 0.0, length - MIN_T)
    o_s = pos.expand(4, h, w, 3).contiguous()
    return ((o_g, d_g), (pos.contiguous(), l_dir.contiguous()),
            (o_s, (vec / length[..., None]).contiguous(), tmax))


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of `fn` takes, by the CPU clock over `calls`
    calls without a sync (the launches queue on the device meanwhile)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from fyp_bidirectionalpathtracer_tpu_torch import cuda
    from fyp_bidirectionalpathtracer_tpu_torch.accel import cluster
    from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
    from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect as isect
    from fyp_bidirectionalpathtracer_tpu_torch.accel import subpath
    from fyp_bidirectionalpathtracer_tpu_torch.core import rng
    from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room
    from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import (
        cornell_box,
        icosphere,
        many_light_scene,
        textured_room,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.ops import compact, splat_tile
    from fyp_bidirectionalpathtracer_tpu_torch.ops import splat as splat_mod
    from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
    from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
    from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
    from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import (
        pixel_jitter_for_frame,
        ray_traced_gbuffer,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
        BDPT_FRAME_INIT,
        GBUF_FRAME_INIT,
        Renderer,
        render_frame_fn,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import camera_ray_dirs
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda.build()
    cuda.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    kernels = {}
    n_pix = WIDTH * HEIGHT

    # ---- phase 2: K2 at the main path's shape ----------------------------
    u = DEPTH * n_pix
    sent = ((n_pix + 1023) // 1024) * 1024
    g = torch.Generator().manual_seed(0)
    live = torch.rand(u, generator=g) < LIVE_FRAC
    keys = torch.where(live, torch.randint(0, n_pix, (u,), generator=g),
                       torch.full((u,), n_pix)).to(torch.int32)
    rgb = torch.rand(u, 3, generator=g) * 0.9
    pay = splat_tile.pack_rgb8e(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    keys_d, pay_d = keys.to(dev), pay.to(dev)
    kk, kp, kn = compact.compact_live(keys_d, pay_d, n_pix, sent)
    pk, pp, pn = compact.compact_plain(keys_d, pay_d, n_pix, sent)
    torch.cuda.synchronize()
    n_live = int(pn.item())
    if not (torch.equal(kk, pk) and torch.equal(kp, pp) and torch.equal(kn, pn)):
        raise AssertionError("K2 differs from its plain version")
    k2_ms = time_ms(lambda: compact.compact_live(keys_d, pay_d, n_pix, sent), 20)
    k2_plain = time_ms(lambda: compact.compact_plain(keys_d, pay_d, n_pix, sent), 5)
    # one PyTorch call that groups the updates by pixel as K2 + sort do
    k2_lib = time_ms(lambda: torch.sort(keys_d, stable=True), 20)
    log(f"K2 compaction U={u} live={n_live}: bit-equal; kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain:.4f} ms, torch.sort(stable) of all U {k2_lib:.4f} ms")
    # bytes: keys and payloads read once and written once
    kernels["compact"] = dict(max_abs_err=0.0, ms=k2_ms, plain_ms=k2_plain,
                              library_ms=k2_lib, **bound(16.0 * u, 0.0))

    # ---- phase 3: K3 on the sorted live prefix ---------------------------
    ls, order = torch.sort(kk[:n_live], stable=True)
    p8 = kp[:n_live][order].contiguous()
    out_k = splat_tile.splat_reduce(ls, p8, n_pix)
    out_p = splat_tile.reduce_sorted_plain(ls, p8, n_pix)
    # a sequential sum in sorted order: K5's plain version of the unpacked
    # rows with a count alpha, which K3 must equal bit for bit
    out_seq = splat_tile.reduce_rows_plain(ls, torch.stack(splat_tile.unpack_rgb8e(p8)), n_pix)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 3], out_p[:, 3]):
        raise AssertionError("K3 counts differ from its plain version")
    torch.testing.assert_close(out_k[:, :3], out_p[:, :3], rtol=1e-5, atol=1e-6)
    if not torch.equal(out_k.view(torch.int32), out_seq.view(torch.int32)):
        raise AssertionError("K3 is not bit-equal to the sequential sum in sorted order")
    k3_err = float((out_k - out_p).abs().max())
    # K3, K5 and their index_add_ yardsticks: `ms` and `library_ms` of eager
    # calls, as every kernel's; `graph_ms` and `library_graph_ms` of CUDA-graph
    # replays of 20 calls, device time without the host's cost of each call;
    # `host_us` and `library_host_us` the host's cost of one call
    k3_ms = time_ms(lambda: splat_tile.splat_reduce(ls, p8, n_pix), 20)
    k3_graph = time_graph_ms(lambda: splat_tile.splat_reduce(ls, p8, n_pix))
    k3_host = host_us(lambda: splat_tile.splat_reduce(ls, p8, n_pix))
    k3_plain = time_ms(lambda: splat_tile.reduce_sorted_plain(ls, p8, n_pix), 5)
    rows4 = torch.cat([torch.stack(splat_tile.unpack_rgb8e(p8), 1),
                       torch.ones((n_live, 1), device=dev)], 1)
    idx = ls.long()

    def k3_lib_call():
        return torch.zeros((n_pix, 4), device=dev).index_add_(0, idx, rows4)

    k3_lib, k3_lib_graph = time_ms(k3_lib_call, 20), time_graph_ms(k3_lib_call)
    k3_lib_host = host_us(k3_lib_call)
    log(f"K3 reduction M={n_live}: counts equal, bit-equal to the sequential sum, rgb max "
        f"|err| {k3_err:.3e} against the segment sum (rtol 1e-5, atol 1e-6); kernel "
        f"{k3_ms:.4f} ms (graph {k3_graph:.4f} ms, host {k3_host:.2f} us a call), plain "
        f"{k3_plain:.4f} ms; beside index_add_ of the same rows {k3_lib:.4f} ms (graph "
        f"{k3_lib_graph:.4f} ms, host {k3_lib_host:.2f} us): K3 takes {k3_ms / k3_lib:.3f}x "
        f"its time (graph {k3_graph / k3_lib_graph:.3f}x)")
    kernels["splat_tile"] = dict(max_abs_err=k3_err, bit_equal_sequential=True, ms=k3_ms,
                                 graph_ms=k3_graph, host_us=k3_host, plain_ms=k3_plain,
                                 library_ms=k3_lib, library_graph_ms=k3_lib_graph,
                                 library_host_us=k3_lib_host,
                                 **bound(8.0 * n_live + 16.0 * n_pix, 0.0))

    # ---- phase 3b: K5 on all U sorted updates (the 'tiled' modes) ---------
    # what scatter_add_rgba_tiled hands K5 on the main path's shape: the U
    # keys sorted (the sentinel n_pix rounded up to 1024 for a dead update)
    # and the gathered value rows; float32 rows with a real alpha ('tiled'),
    # bfloat16 rows ('tiled_bf16w'), float32 rgb with a count alpha (the
    # estimator-2 splat, 'tiled')
    sent_keys = torch.where(keys_d < n_pix, keys_d, sent)
    ks5, order5 = torch.sort(sent_keys, stable=True)
    vals_all = torch.cat([rgb.T.to(dev), torch.rand((1, u), generator=g).to(dev)], 0)
    vals_all = vals_all[:, order5].contiguous()
    k5 = {}
    for label, vals in (("f32", vals_all), ("bf16", vals_all.to(torch.bfloat16)),
                        ("f32 count", vals_all[:3].contiguous())):
        got = splat_tile.splat_reduce_rows(ks5, vals, n_pix)
        want = splat_tile.reduce_rows_plain(ks5, vals, n_pix)
        torch.cuda.synchronize()
        count = vals.shape[0] == 3
        if count and not torch.equal(got[:, 3], want[:, 3]):
            raise AssertionError("K5 counts differ from its plain version")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        err = float((got - want).abs().max())
        bit_eq = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        if not bit_eq:
            raise AssertionError(f"K5 ({label}) is not bit-equal to its plain version")
        ms = time_ms(lambda: splat_tile.splat_reduce_rows(ks5, vals, n_pix), 20)
        graph_ms = time_graph_ms(lambda: splat_tile.splat_reduce_rows(ks5, vals, n_pix))
        plain_ms = time_ms(lambda: splat_tile.reduce_rows_plain(ks5, vals, n_pix), 3)
        # one PyTorch call for the same sums: index_add_ of the live rows
        # (the sorted prefix of n_live keys below n_pix) into the pixels
        src = vals[:, :n_live].T.float()
        if count:
            src = torch.cat([src, torch.ones((n_live, 1), device=dev)], 1)
        src = src.contiguous()
        idx5 = ks5[:n_live].long()

        def lib_call():
            return torch.zeros((n_pix, 4), device=dev).index_add_(0, idx5, src)

        lib_ms, lib_graph_ms = time_ms(lib_call, 20), time_graph_ms(lib_call)
        # bytes: the live keys and value rows read once (the dropped updates
        # sort past the last run and are never read), [n_pix, 4] float32
        # written
        bd = bound((4.0 + vals.element_size() * vals.shape[0]) * n_live + 16.0 * n_pix, 0.0)
        k5[label] = dict(max_abs_err=err, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_graph_ms=lib_graph_ms, **bd)
        log(f"K5 rows {label} U={u} ({n_live} live): counts exact, max |err| {err:.3e} "
            f"(rtol 1e-6), bit-equal {bit_eq}; kernel {ms:.4f} ms (graph {graph_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, index_add_ of the live rows {lib_ms:.4f} ms (graph "
            f"{lib_graph_ms:.4f} ms), bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    kernels["splat_rows"] = dict(k5["f32 count"], variants={
        k: {f: v[f] for f in ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
                              "bound_ms", "max_abs_err")}
        for k, v in k5.items()})
    # the whole splat of the estimator-2 updates (unpacked rows, count
    # alpha) by mode: exact float32 rows through sort + K5 against the rgb8e
    # payload through K2 + live-count sync + sort + K3; host clock with a
    # sync, as a frame pays it
    lin_all, rgb_all = keys_d, rgb.to(dev)
    ones_u = torch.ones(u, device=dev)
    splat_ms = {}
    for mode in ("tiled", "tiled_bf16", "tiled_rgb8e"):
        def run(mode=mode):
            return splat_mod.scatter_add_rgba(mode, lin_all, rgb_all, ones_u, n_pix,
                                              alpha_is_count=True)
        run()
        torch.cuda.synchronize()
        t_h = time.perf_counter()
        for _ in range(10):
            run()
        torch.cuda.synchronize()
        splat_ms[mode] = ((time.perf_counter() - t_h) * 100.0, time_ms(run, 10))
    log("splat of U={} updates by mode (host ms with a sync, device ms): {}".format(
        u, {k: (round(a, 4), round(b, 4)) for k, (a, b) in splat_ms.items()}))

    # ---- phase 4: K1 against its plain version ---------------------------
    def scene(name, w, h):
        built = many_light_scene() if name == "many_light" else cornell_box()
        if name == "cornell_icosphere":
            built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
        return Scene.from_built(built, aspect=w / h).bake(device=dev)

    def cfg_for(w, h, megakernel="auto", **bdpt_kw):
        return RenderConfig(width=w, height=h,
                            bdpt=BDPTConfig(max_depth=DEPTH, megakernel=megakernel, **bdpt_kw))

    def room(w, h):
        return Scene.from_built(textured_room(), aspect=w / h).bake(device=dev)

    jitter = pixel_jitter_for_frame(BDPT_FRAME_INIT)

    # three scenes at 256x144; one size that is no multiple of the 128-thread
    # block, so the kernel's tail runs; the main path's 1280x720
    k1_err = k1_frac = 0.0
    for name, w, h in (("cornell", 256, 144), ("cornell_icosphere", 256, 144),
                       ("many_light", 256, 144), ("cornell", 250, 143),
                       ("cornell", WIDTH, HEIGHT)):
        baked = scene(name, w, h)
        args = frame_mod.frame_args(baked, w, h, BDPT_FRAME_INIT, jitter, cfg_for(w, h),
                                    gbuf_frame=GBUF_FRAME_INIT, splat_rgb8e=True)
        ko = frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack, baked.bvh_nodes)
        po = frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack)
        torch.cuda.synchronize()
        d_gb = (ko.gbuf - po.gbuf).abs().max(0).values
        frac_gb = float((d_gb > 1e-3).float().mean())
        frac_img, mad, dmean, img_ok = image_stats(ko.res.T, po.res.T)
        live_k, live_p = ko.splat_pix < args.n_pix, po.splat_pix < args.n_pix
        either, both = live_k | live_p, live_k & live_p
        pix_eq = float((ko.splat_pix[either] == po.splat_pix[either]).float().mean())
        pay_eq = float((ko.splat_pay[both] == po.splat_pay[both]).float().mean())
        k1_err = max(k1_err, float((ko.res - po.res).abs().max()), float(d_gb.max()))
        k1_frac = max(k1_frac, frac_img, frac_gb)
        log(f"K1 {name} ({baked.n_tris} tris, {int(baked.data.lights.count)} lights) "
            f"{w}x{h}: G-buffer frac>1e-3 {frac_gb:.4f} (<= 0.01), image frac>1e-3 "
            f"{frac_img:.4f} (<= 0.02), mean|d| {mad:.2e} (< 5e-3), mean radiance "
            f"d {dmean:.2e} (< 2e-3), splat pixel ids equal on {pix_eq:.4f} of "
            f"{int(either.sum())} lanes live on either side (>= 0.98), payload equal "
            f"on {pay_eq:.4f} of {int(both.sum())} lanes live on both (>= 0.98)")
        if not (frac_gb <= 0.01 and img_ok and pix_eq >= 0.98 and pay_eq >= 0.98
                and int(both.sum()) > 0):
            raise AssertionError(f"K1 differs from its plain version on {name} {w}x{h}")
    # `args` and `baked` are the 1280x720 Cornell frame's now
    cornell = baked
    # every depth the gate admits (accel/frame.supports_megakernel), on
    # Cornell at 64x48, with the same bounds
    small = scene("cornell", 64, 48)
    for d in range(1, 9):
        dargs = frame_mod.frame_args(small, 64, 48, BDPT_FRAME_INIT, jitter,
                                     RenderConfig(width=64, height=48,
                                                  bdpt=BDPTConfig(max_depth=d)),
                                     gbuf_frame=GBUF_FRAME_INIT, splat_rgb8e=True)
        ko = frame_mod.frame_kernel(dargs, small.light_rows, small.tri_pack, small.bvh_nodes)
        po = frame_mod.frame_plain(dargs, small.light_rows, small.tri_pack)
        torch.cuda.synchronize()
        frac_gb = float(((ko.gbuf - po.gbuf).abs().max(0).values > 1e-3).float().mean())
        frac_img, mad, dmean, img_ok = image_stats(ko.res.T, po.res.T)
        live_k, live_p = ko.splat_pix < dargs.n_pix, po.splat_pix < dargs.n_pix
        either, both = live_k | live_p, live_k & live_p
        pix_eq = float((ko.splat_pix[either] == po.splat_pix[either]).float().mean())
        pay_eq = float((ko.splat_pay[both] == po.splat_pay[both]).float().mean())
        log(f"K1 Cornell 64x48 d={d}: G-buffer frac>1e-3 {frac_gb:.4f} (<= 0.01), image "
            f"frac>1e-3 {frac_img:.4f} (<= 0.02), mean|d| {mad:.2e}, mean radiance d "
            f"{dmean:.2e}, splat pixel ids equal {pix_eq:.4f}, payload equal {pay_eq:.4f} "
            f"(>= 0.98)")
        if not (frac_gb <= 0.01 and img_ok and pix_eq >= 0.98 and pay_eq >= 0.98):
            raise AssertionError(f"K1 differs from its plain version at d={d}")
    k1_ms = time_ms(lambda: frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack,
                                                   baked.bvh_nodes), 10)
    k1_plain = time_ms(lambda: frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack),
                       1, warmup=1)
    log(f"K1 alone at {WIDTH}x{HEIGHT} Cornell: kernel {k1_ms:.4f} ms, plain {k1_plain:.2f} ms")
    # bound: bytes: the four output rows plus 20 G-buffer rows (float32) and
    # two int32 splat rows a depth; operations: the ray queries of the rays
    # the plain frame traces (those the kernel traces), as the kernel runs
    # them: the untextured instantiations' dense loops by the stage each
    # pair reaches, the textured ones' BVH walks as the BVH kernels' bound
    # counts them (each node's slab test and each pair test by stage); the
    # other count is printed beside it.  The shading arithmetic is left
    # out, so the bound is low.
    def frame_flops(fargs, bk):
        """(dense pair-test operations, walk operations, walk counts [node
        slab tests, pair tests by stage]) of the rays frame_plain traces."""
        dense, walk = 0, [0, 0, 0, 0]
        closest_rows, any_hit_rows = frame_mod.closest_rows, frame_mod.any_hit_rows

        def count_walk(o, d, tmin, tmax, mode):
            c = cluster.bvh_walk_counts(bk.tri_pack, bk.n_tris, bk.bvh_nodes,
                                        torch.stack(o, -1), torch.stack(d, -1), tmin, tmax,
                                        mode)
            for k, v in enumerate(c.to(torch.int64).sum(1).tolist()):
                walk[k] += v

        def counted_closest(tris, n_tris, o, d, tmin, tmax, cull_backface):
            nonlocal dense
            dense += pair_flops(isect, tris[:n_tris], o, d, tmin, tmax, cull_backface, True)
            count_walk(o, d, tmin, tmax, "closest_cull" if cull_backface else "closest")
            return closest_rows(tris, n_tris, o, d, tmin, tmax, cull_backface)

        def counted_any_hit(tris, n_tris, o, d, tmin, tmax):
            nonlocal dense
            dense += pair_flops(isect, tris[:n_tris], o, d, tmin, tmax, False, False)
            count_walk(o, d, tmin, tmax, "any")
            return any_hit_rows(tris, n_tris, o, d, tmin, tmax)

        frame_mod.closest_rows, frame_mod.any_hit_rows = counted_closest, counted_any_hit
        try:
            frame_mod.frame_plain(fargs, bk.light_rows, bk.tri_pack)
        finally:
            frame_mod.closest_rows, frame_mod.any_hit_rows = closest_rows, any_hit_rows
        s1, s2, s3 = STAGE_FLOPS
        return dense, SLAB_FLOPS * walk[0] + s1 * walk[1] + s2 * walk[2] + s3 * walk[3], walk

    def frame_bound(n_bytes, fargs, bk, label):
        dense, walk_ops, walk = frame_flops(fargs, bk)
        dense_bd, walk_bd = bound(n_bytes, float(dense)), bound(n_bytes, float(walk_ops))
        bd = walk_bd if fargs.textured else dense_bd
        log(f"{label} bound: {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {n_bytes:.0f} bytes "
            f"{bd['bytes_ms']:.4f} ms); the dense loops: {dense} pair-test operations, bound "
            f"{dense_bd['bound_ms']:.4f} ms; the walk: {walk[0]} slab tests, pairs by stage "
            f"{walk[1:]}, {walk_ops} operations, bound {walk_bd['bound_ms']:.4f} ms; the kernel "
            f"runs the {'walk' if fargs.textured else 'dense loops'}")
        return dict(bd, walk_counts=walk, walk_flops=walk_ops, dense_pair_flops=dense,
                    walk_bound_ms=walk_bd["bound_ms"], dense_bound_ms=dense_bd["bound_ms"])

    k1_bd = frame_bound(n_pix * 4.0 * (4 + 20 + 2 * DEPTH), args, baked, "K1")
    # max_abs_err includes the edge-tie pixels the statistical bounds admit;
    # max_frac_over_1e-3 is the worst share of pixels off by more than 1e-3
    kernels["frame"] = dict(max_abs_err=k1_err, max_frac_over_1e_3=k1_frac,
                            ms=k1_ms, plain_ms=k1_plain, library_ms=None, **k1_bd)

    # the whole frame after the splats: K1 + K2 + sort + K3 against the
    # plain chain, through `render_frame_megakernel`
    for w, h in ((250, 143), (WIDTH, HEIGHT)):
        cb = scene("cornell", w, h)
        got = [frame_mod.render_frame_megakernel(
            replace(cb, plain=plain), w, h, BDPT_FRAME_INIT, jitter, cfg_for(w, h),
            gbuf_frame=GBUF_FRAME_INIT)[1] for plain in (False, True)]
        frac_img, mad, dmean, img_ok = image_stats(*got)
        log(f"frame with splats {w}x{h}, kernels vs plain chain: frac>1e-3 "
            f"{frac_img:.4f} (<= 0.02), mean|d| {mad:.2e} (< 5e-3), mean radiance "
            f"d {dmean:.2e} (< 2e-3)")
        if not img_ok:
            raise AssertionError(f"the frame with splats differs from the plain chain "
                                 f"at {w}x{h}")

    # ---- phase 4f: K1's textured variant against its plain version --------
    def rows_off(a, b):
        """Share of pixels with a row off by more than 1e-3 (NaN as 0)."""
        a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
        return float(((a - b).abs().max(0).values > 1e-3).float().mean())

    tex_err = tex_frac = 0.0
    for w, h in ((250, 143), (WIDTH, HEIGHT)):
        bk = room(w, h)
        targs = frame_mod.frame_args(bk, w, h, BDPT_FRAME_INIT, jitter,
                                     cfg_for(w, h, defer_textures=True),
                                     gbuf_frame=GBUF_FRAME_INIT)
        ko = frame_mod.frame_kernel(targs, bk.light_rows, bk.tri_pack, bk.bvh_nodes)
        po = frame_mod.frame_plain(targs, bk.light_rows, bk.tri_pack)
        torch.cuda.synchronize()
        fr = {name: rows_off(getattr(ko, name), getattr(po, name))
              for name in ("gbuf", "vrec", "e1_parts", "e3_parts")}
        fr["splat_rgba"] = rows_off(ko.splat_rgba.reshape(-1, targs.n_pix),
                                    po.splat_rgba.reshape(-1, targs.n_pix))
        live_k, live_p = ko.splat_pix < targs.n_pix, po.splat_pix < targs.n_pix
        either = live_k | live_p
        pix_eq = float((ko.splat_pix[either] == po.splat_pix[either]).float().mean())
        bits = float(torch.cat([(a.view(torch.int32) == b.view(torch.int32)).all(0)[None]
                                for a, b in ((ko.gbuf, po.gbuf), (ko.vrec, po.vrec),
                                             (ko.e1_parts, po.e1_parts),
                                             (ko.e3_parts, po.e3_parts))]).all(0)
                     .float().mean())
        for name in ("gbuf", "vrec", "e1_parts", "e3_parts"):
            tex_err = max(tex_err, float(torch.nan_to_num(
                (getattr(ko, name) - getattr(po, name)).abs(), nan=0.0).max()))
        tex_frac = max(tex_frac, *fr.values())
        log(f"K1 textured {bk.n_tris} tris {w}x{h} d={DEPTH}: rows off by > 1e-3 on "
            f"{ {k: round(v, 5) for k, v in fr.items()} } of pixels (G-buffer and records "
            f"<= 0.01, estimator and splat rows <= 0.02), splat ids equal on {pix_eq:.4f} "
            f"of {int(either.sum())} lanes live on either side (>= 0.98), pixels with every "
            f"row bit-equal {bits:.4f}")
        if not (fr["gbuf"] <= 0.01 and fr["vrec"] <= 0.01 and fr["e1_parts"] <= 0.02
                and fr["e3_parts"] <= 0.02 and fr["splat_rgba"] <= 0.02 and pix_eq >= 0.98
                and int(either.sum()) > 0):
            raise AssertionError(f"K1's textured variant differs from its plain version at "
                                 f"{w}x{h}")
    tex_main = bk
    tk_ms = time_ms(lambda: frame_mod.frame_kernel(targs, bk.light_rows, bk.tri_pack,
                                                   bk.bvh_nodes), 10)
    tk_plain = time_ms(lambda: frame_mod.frame_plain(targs, bk.light_rows, bk.tri_pack),
                       1, warmup=1)
    # bytes: the G-buffer, record, estimator-part and splat rows written
    tk_rows = (frame_mod.N_GBUF_ROWS + 2 * frame_mod.N_REC_ROWS * DEPTH + 1 + 6 * targs.n_e1
               + 4 * targs.n_pairs + 5 * DEPTH)
    log(f"K1 textured alone at {WIDTH}x{HEIGHT}: kernel {tk_ms:.4f} ms, plain {tk_plain:.2f} ms "
        f"({tk_rows} rows written)")
    tk_bd = frame_bound(4.0 * tk_rows * n_pix, targs, bk, "K1 textured")
    kernels["frame_textured"] = dict(max_abs_err=tex_err, max_frac_over_1e_3=tex_frac,
                                     ms=tk_ms, plain_ms=tk_plain, library_ms=None, **tk_bd)
    # the whole deferred-texture frame: K1 textured, the replay and the
    # splat through K2 + sort + K3 ('auto') or K5 ('tiled'), against the
    # plain chain
    for mode in ("auto", "tiled"):
        bk = room(250, 143)
        got = [frame_mod.render_frame_megakernel(
            replace(bk, plain=plain), 250, 143, BDPT_FRAME_INIT, jitter,
            cfg_for(250, 143, defer_textures=True, splat_mode=mode),
            gbuf_frame=GBUF_FRAME_INIT)[1] for plain in (False, True)]
        frac_img, mad, dmean, img_ok = image_stats(*got)
        log(f"textured frame with splats ({mode}) 250x143, kernels vs plain chain: frac>1e-3 "
            f"{frac_img:.4f} (<= 0.02), mean|d| {mad:.2e} (< 5e-3), mean radiance d "
            f"{dmean:.2e} (< 2e-3)")
        if not img_ok:
            raise AssertionError(f"the textured frame ({mode}) differs from the plain chain")

    # ---- phase 4g: K6, the fused subpath builder -----------------------------
    # 921,600 camera subpaths of the Cornell box at 1280x720: the camera's
    # jittered rays, the frame's pixel seeds, 3 bounces
    o6, d6 = (x.reshape(-1, 3).contiguous() for x in (
        cornell.data.camera.pos_w.to(dev).expand(HEIGHT, WIDTH, 3),
        camera_ray_dirs(cornell.data.camera, WIDTH, HEIGHT, jitter, device=dev)))
    d6 = (d6 / d6.norm(dim=-1, keepdim=True)).contiguous()
    seed6 = rng.pixel_seeds(WIDTH, HEIGHT, BDPT_FRAME_INIT, device=dev).reshape(-1)
    c6 = torch.ones_like(o6)
    t6 = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    sp_args = (cornell.tri_pack, cornell.n_tris, o6, d6, c6, seed6, t6, MIN_T, DEPTH, 0, False)
    kv, kf = subpath.build_subpath(*sp_args)
    pv, pf = subpath.build_subpath(*sp_args, plain=True)
    torch.cuda.synchronize()
    active, k6_err, k6_ok = ~t6, 0.0, True
    lanes_eq = torch.ones(n_pix, dtype=torch.bool, device=dev)
    for b in range(DEPTH):
        for name in ("hit", "take", "is_spec"):
            k6_ok &= bool(torch.equal(kv[b][name], pv[b][name]))
        for name in ("color", "pos", "n", "v", "dif", "spec", "rough", "pdf"):
            a, c = kv[b][name], pv[b][name]
            diff = torch.nan_to_num((a - c).abs(), nan=0.0)
            diff = diff if diff.dim() == 1 else diff.amax(-1)
            k6_err = max(k6_err, float(diff[active].max()))
            same = (a.view(torch.int32) == c.view(torch.int32))
            lanes_eq &= same if same.dim() == 1 else same.all(-1)
        active = active & pv[b]["take"]
    k6_ok &= (k6_err <= 5e-4 and bool(torch.equal(kf["terminated"], pf["terminated"]))
              and bool(torch.equal(kf["seed"], pf["seed"])))
    share = float(lanes_eq.float().mean())
    hits = [int(v["hit"].sum()) for v in kv]
    log(f"K6 subpath {n_pix} Cornell rays, {DEPTH} bounces: fields max |err| {k6_err:.3e} on "
        f"active lanes (<= 5e-4), hit/take/is_spec/terminated/seed exact {k6_ok}, lanes "
        f"bit-equal in every field {share:.6f}, hits by bounce {hits}")
    if not k6_ok:
        raise AssertionError("K6 differs from its plain version")
    state6 = torch.cat([o6.T, d6.T, c6.T, t6.float()[None], subpath._seed_bits(seed6)[None],
                        torch.full((1, n_pix), MIN_T, device=dev)]).contiguous()
    k6_ms = time_ms(lambda: subpath.subpath_kernel(state6, cornell.tri_pack, cornell.n_tris,
                                                   DEPTH, 0, False), 10)
    k6_plain = time_ms(lambda: subpath.subpath_plain(state6, cornell.tri_pack,
                                                     cornell.n_tris, DEPTH, 0, False), 1)
    # operations: the pair tests of the rays each bounce traces (K6's test:
    # no cull, t in (min_t, best so far)), counted by stage on the plain
    # version's rays bounce by bounce; bytes: the state read, the vertex
    # rows and the final state written
    k6_flops, st = 0, state6
    tris6 = cornell.tri_pack[:cornell.n_tris]
    for _ in range(DEPTH):
        live = st[9] < 0.5
        o_b, d_b = tuple(st[k][live] for k in range(3)), tuple(st[k][live] for k in range(3, 6))
        nl = int(live.sum())
        k6_flops += pair_flops(isect, tris6, o_b, d_b, torch.full((nl,), MIN_T, device=dev),
                               torch.full((nl,), 1e30, device=dev), False, True)
        _, st = subpath.subpath_plain(st, cornell.tri_pack, cornell.n_tris, 1, 0, False)
    k6_bd = bound(4.0 * n_pix * (2 * subpath.STATE_ROWS + subpath.VERT_ROWS * DEPTH)
                  + 48.0 * 4 * cornell.n_tris, float(k6_flops))
    log(f"K6 alone: kernel {k6_ms:.4f} ms, plain {k6_plain:.2f} ms, bound "
        f"{k6_bd['bound_ms']:.4f} ms ({k6_bd['bound_by']}; {k6_flops} pair-test operations, "
        f"bytes {k6_bd['bytes_ms']:.4f} ms)")
    kernels["subpath"] = dict(max_abs_err=k6_err, lanes_bit_equal=share, ms=k6_ms,
                              plain_ms=k6_plain, library_ms=None, **k6_bd)

    # ---- phase 4b: the K4 intersectors against their plain versions ------
    def hits_within_bounds(k, p, kf=None, pf=None):
        """The K4 bounds (tests/test_torch_intersect.py): ids equal but on
        ties (both hit, t within rtol 1e-5), t within rtol 1e-5, fields
        within atol 2e-4.  Returns (ok, max |err|, share bit-equal)."""
        differs = k.tri != p.tri
        t_ok = bool(torch.isclose(k.t, p.t, rtol=1e-5, atol=1e-7).all())
        ties_ok = bool(((k.tri >= 0) & (p.tri >= 0))[differs].all())
        err = float((k.t - p.t).abs()[~differs].max()) if bool((~differs).any()) else 0.0
        same_bits = float((k.t.view(torch.int32) == p.t.view(torch.int32)).float().mean())
        fields_ok = True
        if kf is not None:
            df = (kf - pf).abs()[:, ~differs]
            err = max(err, float(df.max()))
            fields_ok = bool((df <= 2e-4).all())
        return t_ok and ties_ok and fields_ok, err, same_bits

    def check_k4(bk, w, h, record: bool):
        (o_g, d_g), (o_e, d_e), (o_s, d_s, tm_s) = k4_rays(bk, w, h, dev)
        args = (bk.tri_pack, bk.n_tris)
        n = w * h
        results = {}
        for label, (o, d, tmin, cull) in (("G-buffer", (o_g, d_g, 0.0, True)),
                                          ("extension", (o_e, d_e, MIN_T, False))):
            kh, kf = isect.intersect_shaded_fm(*args, o, d, tmin, None, cull)
            ph, pf = isect.shaded_plain(*args, o, d, tmin, None, cull)
            ok_s, err_s, bits_s = hits_within_bounds(kh, ph, kf, pf)
            kc = isect.intersect_closest(*args, o, d, tmin, None, cull)
            pc = isect.closest_plain(*args, o, d, tmin, None, cull)
            ok_c, err_c, bits_c = hits_within_bounds(kc, pc)
            torch.cuda.synchronize()
            log(f"K4 {bk.n_tris} tris {w}x{h} {label} rays (cull {cull}): shaded within "
                f"bounds {ok_s}, max |err| {err_s:.3e}, t bit-equal on {bits_s:.6f}; closest "
                f"within bounds {ok_c}, max |err| {err_c:.3e}, t bit-equal on {bits_c:.6f}; "
                f"hits {int(kh.hit.sum())} of {n}")
            if not (ok_s and ok_c):
                raise AssertionError(f"K4 differs from its plain version ({label}, "
                                     f"{bk.n_tris} tris, {w}x{h})")
            results.setdefault("shaded", []).append((err_s, (o, d, tmin, cull)))
            results.setdefault("closest", []).append((err_c, (o, d, tmin, cull)))
        ko = isect.occluded(*args, o_s, d_s, MIN_T, tm_s)
        po = isect.occluded_plain(*args, o_s, d_s, MIN_T, tm_s)
        torch.cuda.synchronize()
        eq = bool(torch.equal(ko, po))
        log(f"K4 any-hit {bk.n_tris} tris [4, {h}, {w}] shadow batch, "
            f"{int((tm_s > 0).sum())} live lanes: bits equal {eq}, occluded {int(ko.sum())}")
        if not eq:
            raise AssertionError(f"K4 any-hit differs from its plain version "
                                 f"({bk.n_tris} tris, {w}x{h})")
        # times on the G-buffer rays (shaded, closest) and the shadow batch
        lib = cuda.library()
        stream = cuda.stream(dev)
        rows_g, _ = isect.rays(o_g, d_g, 0.0, None)
        rows_s, _ = isect.rays(o_s, d_s, MIN_T, tm_s)
        ns = rows_s.shape[1]
        fields = torch.empty((isect.OUT_W, n), device=dev)
        t_ = torch.empty(n, device=dev)
        id_ = torch.empty(n, dtype=torch.int32, device=dev)
        u_, v_ = torch.empty_like(t_), torch.empty_like(t_)
        occ = torch.empty(ns, dtype=torch.bool, device=dev)
        p = cuda.ptr
        launches = {
            "shaded": lambda: lib.bdpt_intersect_shaded(p(rows_g), n, p(bk.tri_pack), bk.n_tris,
                                                        1, p(fields), stream),
            "closest": lambda: lib.bdpt_intersect_closest(p(rows_g), n, p(bk.tri_pack),
                                                          bk.n_tris, 1, p(t_), p(id_), p(u_),
                                                          p(v_), stream),
            "occluded": lambda: lib.bdpt_occluded(p(rows_s), ns, p(bk.tri_pack), bk.n_tris,
                                                  p(occ), stream),
        }
        plains = {
            "shaded": lambda: isect.shaded_plain(*args, o_g, d_g, 0.0, None, True),
            "closest": lambda: isect.closest_plain(*args, o_g, d_g, 0.0, None, True),
            "occluded": lambda: isect.occluded_plain(*args, o_s, d_s, MIN_T, tm_s),
        }
        # bytes: the eight float32 ray rows in; out 32 float32 fields
        # (shaded), t id u v (closest), one byte (any-hit); operations: the
        # pair tests these rays need (pair_flops)
        out_bytes = {"shaded": 4.0 * isect.OUT_W, "closest": 16.0, "occluded": 1.0}
        tris = bk.tri_pack[:bk.n_tris]
        o_g_, d_g_, tmin_g, tmax_g = isect.components(rows_g)
        o_s_, d_s_, tmin_s, tmax_s = isect.components(rows_s)
        flops_g = pair_flops(isect, tris, o_g_, d_g_, tmin_g, tmax_g, True, True)
        flops = {"shaded": flops_g, "closest": flops_g,
                 "occluded": pair_flops(isect, tris, o_s_, d_s_, tmin_s, tmax_s, False, False)}
        for name in ("shaded", "closest", "occluded"):
            rays = ns if name == "occluded" else n
            ms = time_ms(lambda: cuda.check_error(name, launches[name]()), 20)
            plain_ms = time_ms(plains[name], 3)
            bd = bound(rays * (32.0 + out_bytes[name]) + 48.0 * 4 * bk.n_tris,
                       float(flops[name]))
            log(f"K4 {name} {bk.n_tris} tris, {rays} rays: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; "
                f"{flops[name]} pair-test operations)")
            if record:
                err = (max(e for e, _ in results[name]) if name in results else 0.0)
                kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     library_ms=None, **bd)

    check_k4(cornell, WIDTH, HEIGHT, record=True)
    check_k4(scene("cornell_icosphere", 256, 144), 256, 144, record=False)

    # the closest kernel on its path: the unfused tracer's G-buffer
    # (make_intersector closest hit + prepare_shading_data) against the
    # fused tracer's, at a size that is no multiple of the block
    cb = scene("cornell", 250, 143)
    cuda.reset_launch_counts()
    unfused = ray_traced_gbuffer(cb, make_shaded_tracer(cb, force_fused=False), 250, 143,
                                 GBUF_FRAME_INIT, jitter)
    torch.cuda.synchronize()
    kernels["closest"]["launches"] = cuda.LAUNCHES["closest"]
    fused = ray_traced_gbuffer(cb, make_shaded_tracer(cb), 250, 143, GBUF_FRAME_INIT, jitter)
    worst = max(float(((fused[k] - unfused[k]).abs().amax(-1) > 1e-3).float().mean())
                for k in fused)
    log(f"closest-hit G-buffer path 250x143 (make_shaded_tracer(force_fused=False)) vs "
        f"the fused tracer: worst channel frac>1e-3 {worst:.4f} (<= 0.01), closest "
        f"launches {kernels['closest']['launches']}")
    if not (worst <= 0.01 and kernels["closest"]["launches"] >= 1):
        raise AssertionError("the closest-hit G-buffer differs from the fused one")

    # ---- phase 4c: the wavefront frame against its plain chain ------------
    wcb = scene("cornell", 250, 143)
    frames = []
    for plain in (False, True):
        ch, _, _ = render_frame_fn(replace(wcb, plain=plain), wcb.data.camera,
                                   AccumState.create(143, 250, dev),
                                   BMFRState.create(143, 250, dev), GBUF_FRAME_INIT,
                                   BDPT_FRAME_INIT, False, cfg_for(250, 143, "off"))
        frames.append(ch["BDPT"])
    frac_img, mad, dmean, img_ok = image_stats(*frames)
    log(f"wavefront frame 250x143, kernels vs plain chain: frac>1e-3 {frac_img:.4f} "
        f"(<= 0.02), mean|d| {mad:.2e} (< 5e-3), mean radiance d {dmean:.2e} (< 2e-3)")
    if not img_ok:
        raise AssertionError("the wavefront frame differs from its plain chain")

    # ---- phase 4d: the BVH kernels against their plain versions -----------
    def pink(sub, w, h):
        built = pink_room(asset_dir="", subdivisions=sub)
        return Scene.from_built(built, aspect=w / h).bake(device=dev)

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def pick(x, step, width=3):
        """Every step-th ray of rays [..., 3] (width 1: of values [...])."""
        return x.reshape(-1, width)[::step].squeeze(-1).contiguous()

    def walk_flops(bk, o, d, tmin, tmax, mode):
        """Operations of the threaded walk (a node row is one slab test)."""
        c = cluster.bvh_walk_counts(bk.tri_pack, bk.n_tris, bk.bvh_nodes, o, d, tmin, tmax,
                                    mode).to(torch.int64).sum(1).tolist()
        s1, s2, s3 = STAGE_FLOPS
        return SLAB_FLOPS * c[0] + s1 * c[1] + s2 * c[2] + s3 * c[3], c

    def pair_walk_flops(bk, o, d, tmin, tmax, mode):
        """Operations of a two-box walk (a row is two slab tests)."""
        c = cluster.bvh_pair_walk_counts(bk.bw_rows, bk.n_tris, bk.bvh_pairs, o, d, tmin,
                                         tmax, mode).to(torch.int64).sum(1).tolist()
        s1, s2, s3 = STAGE_FLOPS
        return 2 * SLAB_FLOPS * c[0] + s1 * c[1] + s2 * c[2] + s3 * c[3], c

    bvh_stats = {}

    def check_bvh(bk, step, label):
        """Bit-equality of the three BVH kernels and their plain versions on
        every step-th ray of the 1280x720 batches, then each kernel's time
        on the whole batch, its bound (bytes, and the walk's operations
        counted by its counting instantiation) and the plain version's time
        on the checked rays."""
        walk = (bk.bw_rows, bk.n_tris, bk.bvh_pairs)
        (o_g, d_g), (o_e, d_e), (o_s, d_s, tm_s) = k4_rays(
            bk, WIDTH, HEIGHT, dev, partial(cluster.bvh_shaded_fm, rows=walk[0], pairs=walk[2]))
        tn_g, tn_e, tn_s = 0.0, MIN_T, MIN_T
        args = (bk.tri_pack, bk.n_tris)
        for name, o, d, tmin, cull in (("G-buffer", o_g, d_g, tn_g, True),
                                       ("extension", o_e, d_e, tn_e, False)):
            o, d = pick(o, step), pick(d, step)
            kh, kf = cluster.bvh_shaded_fm(*args, walk[0], walk[2], o, d, tmin, None, cull)
            ph, pf = isect.shaded_plain(*args, o, d, tmin, None, cull)
            kc = cluster.bvh_closest(*walk, o, d, tmin, None, cull)
            pc = isect.closest_plain(*args, o, d, tmin, None, cull)
            torch.cuda.synchronize()
            equal = all(torch.equal(bits(a), bits(b)) for a, b in (
                (kf, pf), (kh.t, ph.t), (kc.t, pc.t), (kc.tri, pc.tri), (kc.bary_u, pc.bary_u),
                (kc.bary_v, pc.bary_v)))
            log(f"BVH {label} {bk.n_tris} tris, {name} rays ({o.shape[0]} of every {step}): "
                f"shaded and closest bit-equal to the plain versions {equal} (t, ids, u, v, "
                f"32 fields); hits {int(kh.hit.sum())}")
            if not equal:
                raise AssertionError(f"a BVH kernel differs from its plain version ({label}, "
                                     f"{name} rays)")
        os_, ds_, ts_ = pick(o_s, step), pick(d_s, step), pick(tm_s, step, 1)
        ko = cluster.bvh_occluded(*walk, os_, ds_, tn_s, ts_)
        po = isect.occluded_plain(*args, os_, ds_, tn_s, ts_)
        torch.cuda.synchronize()
        eq = bool(torch.equal(ko, po))
        log(f"BVH {label} any-hit, shadow rays ({os_.shape[0]}, {int((ts_ > 0).sum())} live): "
            f"bits equal {eq}, occluded {int(ko.sum())}")
        if not eq:
            raise AssertionError(f"the BVH any-hit kernel differs from its plain version "
                                 f"({label})")
        # each kernel's `ms` is its launch on the packed rays (the ray
        # counter's memset and the kernel; the shaded kernel's two passes),
        # with a preallocated counter, as `wrapper_ms` of the any-hit row is
        # the wrapper's whole call (packing the rays included).  Bounds from
        # the two-box walk's counts over the Baldwin-Weber rows and the
        # two-box table (the shaded kernel also reads the pack); the
        # threaded walk's count, which the kernels ran before, beside them
        lib, stream, p = cuda.library(), cuda.stream(dev), cuda.ptr
        rows_g, _ = isect.rays(o_g, d_g, tn_g, None)
        rows_e, _ = isect.rays(o_e, d_e, tn_e, None)
        n, ns = rows_g.shape[1], tm_s.numel()
        fields = torch.empty((isect.OUT_W, n), device=dev)
        t_ = torch.empty(n, device=dev)
        id_ = torch.empty(n, dtype=torch.int32, device=dev)
        u_, v_ = torch.empty_like(t_), torch.empty_like(t_)
        counter = torch.empty(1, dtype=torch.int32, device=dev)
        bw, pairs = p(bk.bw_rows), p(bk.bvh_pairs)
        runs = {
            "bvh_shaded": lambda rows, cull: lib.bdpt_bvh_shaded(
                p(rows), n, p(bk.tri_pack), bw, pairs, cull, p(fields), p(counter), stream),
            "bvh_closest": lambda rows, cull: lib.bdpt_bvh_closest(
                p(rows), n, bw, pairs, cull, p(t_), p(id_), p(u_), p(v_), p(counter), stream),
        }
        out = {}
        walk_bytes = 4.0 * (bk.bw_rows.numel() + bk.bvh_pairs.numel())
        table_bytes = {"bvh_shaded": walk_bytes + 4.0 * bk.tri_pack.numel(),
                       "bvh_closest": walk_bytes}
        pack_bytes = 4.0 * (bk.tri_pack.numel() + bk.bvh_nodes.numel())
        out_bytes = {"bvh_shaded": 4.0 * isect.OUT_W, "bvh_closest": 16.0}
        o_c, d_c = pick(o_g, step), pick(d_g, step)
        plains = {"bvh_shaded": lambda: isect.shaded_plain(*args, o_c, d_c, 0.0, None, True),
                  "bvh_closest": lambda: isect.closest_plain(*args, o_c, d_c, 0.0, None, True),
                  "bvh_occluded": lambda: isect.occluded_plain(*args, os_, ds_, tn_s, ts_)}
        flops, c = pair_walk_flops(bk, o_g, d_g, tn_g, None, "closest_cull")
        flops_e, c_e = pair_walk_flops(bk, o_e, d_e, tn_e, None, "closest")
        old_flops, old_c = walk_flops(bk, o_g, d_g, tn_g, None, "closest_cull")
        old_flops_e, old_c_e = walk_flops(bk, o_e, d_e, tn_e, None, "closest")
        for name in ("bvh_shaded", "bvh_closest"):
            ms = time_ms(lambda: cuda.check_error(name, runs[name](rows_g, 1)), 10)
            ms_e = time_ms(lambda: cuda.check_error(name, runs[name](rows_e, 0)), 10)
            ray_bytes = n * (32.0 + out_bytes[name])
            bd = bound(ray_bytes + table_bytes[name], float(flops))
            bd_e = bound(ray_bytes + table_bytes[name], float(flops_e))
            old_bd = bound(ray_bytes + pack_bytes, float(old_flops))
            old_bd_e = bound(ray_bytes + pack_bytes, float(old_flops_e))
            out[name] = dict(ms=ms, extension_ms=ms_e, plain_ms=time_ms(plains[name], 1),
                             plain_rays=o_c.shape[0], walk_counts=c, walk_flops=flops,
                             threaded_walk_counts=old_c, threaded_walk_flops=old_flops,
                             threaded_bound_ms=old_bd["bound_ms"],
                             extension_bound_ms=bd_e["bound_ms"],
                             extension_bound_by=bd_e["bound_by"],
                             extension_walk_counts=c_e,
                             extension_threaded_walk_counts=old_c_e,
                             extension_threaded_bound_ms=old_bd_e["bound_ms"], **bd)
            log(f"BVH {name} {label} {bk.n_tris} tris, {n} G-buffer rays: kernel {ms:.4f} ms "
                f"(extension rays {ms_e:.4f} ms), plain {out[name]['plain_ms']:.2f} ms on "
                f"{o_c.shape[0]} rays, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; bytes "
                f"{bd['bytes_ms']:.4f} ms, two-box walk {c[0]} rows ({2 * c[0]} slab tests), "
                f"pairs by stage {c[1:]}, {flops} operations {bd['operations_ms']:.4f} ms), "
                f"extension bound {bd_e['bound_ms']:.4f} ms ({c_e[0]} rows, pairs {c_e[1:]}); "
                f"the threaded walk: {old_c[0]} slab tests, pairs {old_c[1:]}, bound "
                f"{old_bd['bound_ms']:.4f} ms; extension {old_c_e[0]} slab tests, pairs "
                f"{old_c_e[1:]}, bound {old_bd_e['bound_ms']:.4f} ms")
        rows_s, _ = isect.rays(o_s, d_s, tn_s, tm_s)
        occ = torch.empty(ns, dtype=torch.bool, device=dev)
        ms = time_ms(lambda: cuda.check_error("bvh_occluded", lib.bdpt_bvh_occluded(
            p(rows_s), ns, bw, pairs, p(occ), p(counter), stream)), 10)
        wrapper_ms = time_ms(lambda: cluster.bvh_occluded(*walk, o_s, d_s, tn_s, tm_s), 10)
        flops, c = pair_walk_flops(bk, o_s, d_s, tn_s, tm_s, "any")
        bd = bound(ns * 33.0 + walk_bytes, float(flops))
        old_flops, old_c = walk_flops(bk, o_s, d_s, tn_s, tm_s, "any")
        old_bd = bound(ns * 33.0 + pack_bytes, float(old_flops))
        out["bvh_occluded"] = dict(ms=ms, wrapper_ms=wrapper_ms,
                                   plain_ms=time_ms(plains["bvh_occluded"], 1),
                                   plain_rays=os_.shape[0], walk_counts=c, walk_flops=flops,
                                   threaded_walk_counts=old_c, threaded_walk_flops=old_flops,
                                   threaded_bound_ms=old_bd["bound_ms"], **bd)
        log(f"BVH bvh_occluded {label} {bk.n_tris} tris, [4, {HEIGHT}, {WIDTH}] shadow batch: "
            f"kernel {ms:.4f} ms (the wrapper's call {wrapper_ms:.4f} ms), plain "
            f"{out['bvh_occluded']['plain_ms']:.2f} ms on {os_.shape[0]} rays, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; bytes "
            f"{bd['bytes_ms']:.4f} ms, two-box walk {c[0]} rows ({2 * c[0]} slab tests), pairs "
            f"by stage {c[1:]}, {flops} operations {bd['operations_ms']:.4f} ms); the threaded "
            f"walk: {old_c[0]} slab tests, pairs by stage {old_c[1:]}, {old_flops} operations, "
            f"bound {old_bd['bound_ms']:.4f} ms")
        bvh_stats[label] = out

    pink_main = pink(3, WIDTH, HEIGHT)
    check_bvh(pink_main, 1, "pink_room")
    for sub in (4, 5):
        big = pink(sub, WIDTH, HEIGHT)
        check_bvh(big, PINK_SAMPLE, f"pink_room subdivisions={sub}")
        del big
    # Cornell + icosphere (1314 triangles): the BVH kernels against the dense
    # K4 kernels, bit for bit, as well as against the plain versions
    ci = scene("cornell_icosphere", 256, 144)
    (o_g, d_g), (o_e, d_e), (o_s, d_s, tm_s) = k4_rays(ci, 256, 144, dev)
    ci_rows, ci_pairs = cluster.pair_tables(ci.data.bvh, ci.tri_pack)  # none at 1314 tris
    same = []
    for o, d, tmin, cull in ((o_g, d_g, 0.0, True), (o_e, d_e, MIN_T, False)):
        bh, bf = cluster.bvh_shaded_fm(ci.tri_pack, ci.n_tris, ci_rows, ci_pairs, o, d, tmin,
                                       None, cull)
        dh, df = isect.intersect_shaded_fm(ci.tri_pack, ci.n_tris, o, d, tmin, None, cull)
        _, pf = isect.shaded_plain(ci.tri_pack, ci.n_tris, o, d, tmin, None, cull)
        bc = cluster.bvh_closest(ci_rows, ci.n_tris, ci_pairs, o, d, tmin, None, cull)
        dc = isect.intersect_closest(ci.tri_pack, ci.n_tris, o, d, tmin, None, cull)
        same += [torch.equal(bits(bf), bits(df)), torch.equal(bits(bf), bits(pf)),
                 torch.equal(bits(bc.t), bits(dc.t)), torch.equal(bc.tri, dc.tri)]
    bo = cluster.bvh_occluded(ci_rows, ci.n_tris, ci_pairs, o_s, d_s, MIN_T, tm_s)
    same.append(torch.equal(bo, isect.occluded(ci.tri_pack, ci.n_tris, o_s, d_s, MIN_T, tm_s)))
    torch.cuda.synchronize()
    log(f"BVH on Cornell + icosphere ({ci.n_tris} tris) 256x144: equal to the dense K4 kernels "
        f"and the plain versions bit for bit: {all(same)} ({same})")
    if not all(same):
        raise AssertionError("the BVH kernels differ from the dense K4 kernels")

    # ---- phase 4e: the textured wavefront frame against its plain chain -----
    pk = pink(3, 256, 144)
    frames = []
    for plain in (False, True):
        ch, _, _ = render_frame_fn(replace(pk, plain=plain), pk.data.camera,
                                   AccumState.create(144, 256, dev),
                                   BMFRState.create(144, 256, dev), GBUF_FRAME_INIT,
                                   BDPT_FRAME_INIT, False, cfg_for(256, 144))
        frames.append(ch["BDPT"])
    frac_img, mad, dmean, _ = image_stats(*frames)
    identical = bool(torch.equal(*frames))
    log(f"pink_room wavefront frame 256x144, kernels vs plain chain: identical {identical} "
        f"(frac>1e-3 {frac_img:.4f}, mean|d| {mad:.2e}, mean radiance d {dmean:.2e})")
    if not identical:
        raise AssertionError("the pink_room wavefront frame differs from its plain chain")

    # ---- phase 5: the two paths at 1280x720 ---------------------------------
    def drive(megakernel, baked=None, label=None, **bdpt_kw):
        """3 warm-up and 10 timed frames through Renderer on a new
        accumulation, counts from 0 (the Cornell box unless `baked`)."""
        baked = cornell if baked is None else baked
        label = label or f"{megakernel} path"
        renderer = Renderer(baked, cfg_for(WIDTH, HEIGHT, megakernel, **bdpt_kw))
        warmup, frames = 3, 10
        cuda.reset_launch_counts()
        for _ in range(warmup):
            renderer.render_frame()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        for _ in range(frames):
            out = renderer.render_frame()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / frames
        launches = dict(cuda.LAUNCHES)
        ms = start.elapsed_time(end) / frames
        mrays = n_pix * RAYS_PER_PIXEL / (ms * 1e-3) / 1e6
        log(f"{label} {WIDTH}x{HEIGHT} d={DEPTH}: {ms:.4f} ms/frame, "
            f"{mrays:.1f} Mrays/s ({RAYS_PER_PIXEL} rays/pixel; host clock {host_ms:.4f} "
            f"ms/frame), launches in {warmup + frames} frames {launches}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label} output is not finite")
        if (tuple(out.shape) != (HEIGHT, WIDTH, 4)
                or int(renderer.state.accum.count) != warmup + frames):
            raise AssertionError(f"{label} output has the wrong shape or count")
        twice = []
        for _ in range(2):
            r = Renderer(baked, cfg_for(WIDTH, HEIGHT, megakernel, **bdpt_kw))
            r.render_frame()
            twice.append({k: v.clone() for k, v in r.channels.items()})
        if not all(torch.equal(twice[0][k], twice[1][k]) for k in twice[0]):
            raise AssertionError(f"the same frame rendered twice differs ({label})")
        log(f"{label}: the same frame rendered twice is bit-identical")
        return launches, warmup + frames, twice[0]["BDPT"], ms

    mk_launches, n_frames, mk_frame, _ = drive("auto")
    for key in ("frame", "compact", "splat_tile"):
        if mk_launches[key] != n_frames:
            raise AssertionError(f"kernel {key} launched {mk_launches[key]} times in "
                                 f"{n_frames} megakernel frames")
    wf_launches, n_frames, wf_frame, _ = drive("off")
    # shaded: the G-buffer, DEPTH - 1 camera and DEPTH light extensions;
    # any-hit: the est-1, est-3 and est-2 shadow batches
    per_frame = {"shaded": 1 + (DEPTH - 1) + DEPTH, "occluded": 3, "compact": 1,
                 "splat_tile": 1, "frame": 0, "closest": 0}
    for key, want in per_frame.items():
        if wf_launches[key] != want * n_frames:
            raise AssertionError(f"kernel {key} launched {wf_launches[key]} times in "
                                 f"{n_frames} wavefront frames, want {want} a frame")
    log(f"wavefront launches a frame: {per_frame} (as required)")
    frac_img, mad, dmean, img_ok = image_stats(wf_frame, mk_frame, 0.08, 0.02, 5e-3)
    log(f"wavefront vs megakernel frame {WIDTH}x{HEIGHT}, same seeds: frac>1e-3 "
        f"{frac_img:.4f} (<= 0.08), mean|d| {mad:.2e} (< 0.02), mean radiance d "
        f"{dmean:.2e} (< 5e-3)")
    if not img_ok:
        raise AssertionError("the wavefront frame differs from the megakernel frame")
    # pink_room, the default config: the megakernel gate refuses the textured
    # scene, so Renderer takes the wavefront and its BVH kernels
    pk_launches, pk_frames, _, _ = drive("auto", pink_main, "pink_room (default config)")
    per_frame_pk = {"bvh_shaded": 1 + (DEPTH - 1) + DEPTH, "bvh_occluded": 3, "compact": 1,
                    "splat_tile": 1, "frame": 0, "shaded": 0, "occluded": 0, "closest": 0,
                    "bvh_closest": 0}
    for key, want in per_frame_pk.items():
        if pk_launches[key] != want * pk_frames:
            raise AssertionError(f"kernel {key} launched {pk_launches[key]} times in "
                                 f"{pk_frames} pink_room frames, want {want} a frame")
    log(f"pink_room launches a frame: {per_frame_pk} (as required)")
    # ---- phase 5b: pink_room at 41,266 and 164,146 triangles ---------------
    # above 32768 triangles the shaded tracer takes the BVH closest kernel
    # and gathers the attributes and texels (JAX ops/shading.py:699-713)
    big_launches = {}
    for sub in (4, 5):
        big = pink(sub, WIDTH, HEIGHT)
        big_launches[sub], n_big, _, _ = drive("auto", big, f"pink_room subdivisions={sub} "
                                               f"({big.n_tris} tris)")
        for key, want in (("bvh_closest", 1 + (DEPTH - 1) + DEPTH), ("bvh_occluded", 3),
                          ("bvh_shaded", 0)):
            if big_launches[sub][key] != want * n_big:
                raise AssertionError(f"kernel {key} launched {big_launches[sub][key]} times in "
                                     f"{n_big} frames at subdivisions={sub}")
        del big

    # ---- phase 5c: the textured room's deferred-texture megakernel ----------
    # with splat_mode "auto" (K2 + sort + K3) and "tiled" (K5), beside the
    # textured room's wavefront; the wavefront taps the textures at every
    # vertex (bounce_tex_mean off), as the JAX package's textured test does
    tex_runs = {}
    others = ("frame", "shaded", "occluded", "closest", "bvh_shaded", "bvh_occluded",
              "bvh_closest", "subpath")
    for mode, want in (("auto", {"frame_textured": 1, "compact": 1, "splat_tile": 1,
                                 "splat_rows": 0}),
                       ("tiled", {"frame_textured": 1, "splat_rows": 1, "compact": 0,
                                  "splat_tile": 0})):
        want.update({k: 0 for k in others})
        tl, tn, tframe, tms = drive("auto", tex_main, f"textured room megakernel ({mode})",
                                    defer_textures=True, splat_mode=mode)
        for key, per in want.items():
            if tl[key] != per * tn:
                raise AssertionError(f"kernel {key} launched {tl[key]} times in {tn} textured "
                                     f"megakernel frames ({mode}), want {per} a frame")
        log(f"textured room megakernel ({mode}) launches a frame: {want} (as required)")
        tex_runs[mode] = (tl, tn, tframe, tms)
    twl, twn, twframe, twms = drive("off", tex_main, "textured room wavefront",
                                    defer_textures=True, bounce_tex_mean=False)
    for key, per in (("shaded", 1 + (DEPTH - 1) + DEPTH), ("occluded", 3), ("compact", 1),
                     ("splat_tile", 1), ("frame_textured", 0), ("splat_rows", 0)):
        if twl[key] != per * twn:
            raise AssertionError(f"kernel {key} launched {twl[key]} times in {twn} textured "
                                 f"wavefront frames, want {per} a frame")
    for mode, (_, _, tframe, tms) in tex_runs.items():
        # tests/test_frame_kernel_textured.py's megakernel-vs-wavefront bounds
        d_img = (tframe - twframe).abs()
        frac = float((d_img.amax(-1) > 1e-2).float().mean())
        mad = float(d_img.mean())
        dmean = abs(float(tframe[..., :3].mean() - twframe[..., :3].mean()))
        log(f"textured room megakernel ({mode}) {tms:.4f} ms/frame vs wavefront {twms:.4f} "
            f"ms/frame; frames: frac>1e-2 {frac:.4f} (< 0.10), mean|d| {mad:.2e} (< 0.02), "
            f"mean radiance d {dmean:.2e} (< 5e-3)")
        if not (frac < 0.10 and mad < 0.02 and dmean < 5e-3):
            raise AssertionError(f"the textured megakernel frame ({mode}) differs from the "
                                 f"wavefront frame")

    # ---- phase 5d: the fused subpath builder's entry point ----------------
    cuda.reset_launch_counts()
    verts6, final6 = subpath.build_subpath(*sp_args)
    torch.cuda.synchronize()
    sp_launches = dict(cuda.LAUNCHES)
    if not (sp_launches["subpath"] == 1 and all(bool(torch.isfinite(v["pos"]).all())
                                                for v in verts6)
            and tuple(final6["seed"].shape) == (n_pix,)):
        raise AssertionError(f"build_subpath did not run K6 once with finite vertices: "
                             f"{sp_launches}")
    log(f"build_subpath {n_pix} rays x {DEPTH} bounces: launches {sp_launches}")

    launches = {"frame": mk_launches["frame"], "compact": mk_launches["compact"],
                "splat_tile": mk_launches["splat_tile"], "shaded": wf_launches["shaded"],
                "occluded": wf_launches["occluded"],
                "bvh_shaded": pk_launches["bvh_shaded"],
                "bvh_occluded": pk_launches["bvh_occluded"],
                "bvh_closest": big_launches[4]["bvh_closest"],
                "frame_textured": tex_runs["auto"][0]["frame_textured"],
                "splat_rows": tex_runs["tiled"][0]["splat_rows"],
                "subpath": sp_launches["subpath"]}
    launches["closest"] = kernels["closest"].pop("launches")
    # the run each kernel's launch count comes from
    paths = {name: f"megakernel {WIDTH}x{HEIGHT}, {n_frames} frames"
             for name in ("frame", "compact", "splat_tile")}
    paths.update({name: f"wavefront {WIDTH}x{HEIGHT}, {n_frames} frames"
                  for name in ("shaded", "occluded")})
    paths["closest"] = "gbuffer force_fused=False 250x143, 1 frame"
    paths.update({name: f"pink_room wavefront {WIDTH}x{HEIGHT}, {pk_frames} frames"
                  for name in ("bvh_shaded", "bvh_occluded")})
    paths["bvh_closest"] = f"pink_room subdivisions=4 wavefront {WIDTH}x{HEIGHT}, {n_big} frames"
    paths["frame_textured"] = (f"textured room megakernel (defer_textures, auto) "
                               f"{WIDTH}x{HEIGHT}, {tex_runs['auto'][1]} frames")
    paths["splat_rows"] = (f"textured room megakernel (defer_textures, splat_mode tiled) "
                           f"{WIDTH}x{HEIGHT}, {tex_runs['tiled'][1]} frames")
    paths["subpath"] = f"build_subpath, {n_pix} Cornell camera rays x {DEPTH} bounces, 1 call"
    for name in ("bvh_shaded", "bvh_closest", "bvh_occluded"):
        kernels[name] = dict(max_abs_err=0.0, library_ms=None,
                             **{k: v for k, v in bvh_stats["pink_room"][name].items()})

    # ---- phase 6: goldens ---------------------------------------------------
    golden = read_png_rgb8(GOLDEN)
    for mk in ("auto", "off"):
        small = Renderer(scene("cornell", 64, 64),
                         RenderConfig(width=64, height=64, bdpt=BDPTConfig(megakernel=mk)))
        small.render(8)
        value = psnr_u8(small.display().cpu().numpy(), golden)
        log(f"golden cornell_bdpt_8f_64 (megakernel {mk}): PSNR {value:.2f} dB "
            f"(>= {MIN_PSNR})")
        if not value >= MIN_PSNR:
            raise AssertionError(f"golden image mismatch (megakernel {mk})")

    # the pink_room golden: with exact taps at every vertex (what JAX's CPU
    # path renders) at the JAX package's bar; the default config's
    # mean-albedo bounce decodes beside it
    golden = read_png_rgb8(GOLDEN_PINK)
    small = pink(3, 64, 40)
    for mean in (False, True):
        r = Renderer(small, RenderConfig(width=64, height=40,
                                         bdpt=BDPTConfig(bounce_tex_mean=mean)))
        r.render(2)
        value = psnr_u8(r.display().cpu().numpy(), golden)
        log(f"golden pink_room_fallback_2f_64x40 (bounce_tex_mean={mean}): PSNR {value:.2f} dB"
            + ("" if mean else f" (>= {MIN_PSNR})"))
        if not mean and not value >= MIN_PSNR:
            raise AssertionError("pink_room golden image mismatch")

    pkg = "fyp_bidirectionalpathtracer_tpu_torch/csrc/"
    cl = "fyp_bidirectionalpathtracer_tpu/accel/pallas_cluster.py"
    meta = {
        "frame": ("frame.cu", "fyp_bidirectionalpathtracer_tpu/accel/pallas_frame.py:550"),
        "compact": ("compact.cu", "fyp_bidirectionalpathtracer_tpu/ops/compact.py:100"),
        "splat_tile": ("splat_rows.cu", "fyp_bidirectionalpathtracer_tpu/ops/splat_tile.py:119"),
        "closest": ("intersect.cu", "fyp_bidirectionalpathtracer_tpu/accel/pallas_intersect.py:109"),
        "shaded": ("intersect.cu", "fyp_bidirectionalpathtracer_tpu/accel/pallas_lane.py:259"),
        "occluded": ("intersect.cu", "fyp_bidirectionalpathtracer_tpu/accel/pallas_lane.py:205"),
        "bvh_shaded": ("bvh.cu", cl + ":799"),
        "bvh_closest": ("bvh.cu", cl + ":893"),
        "bvh_occluded": ("bvh.cu", cl + ":502"),
        "frame_textured": ("frame_textured.cu",
                           "fyp_bidirectionalpathtracer_tpu/accel/pallas_frame.py:550"),
        "splat_rows": ("splat_rows.cu", "fyp_bidirectionalpathtracer_tpu/ops/splat_tile.py:44"),
        "subpath": ("subpath.cu", "fyp_bidirectionalpathtracer_tpu/accel/pallas_subpath.py:191"),
    }
    # the HBM tier's kernels that the same walk replaces
    also = {"bvh_closest": [cl + ":602"], "bvh_occluded": [cl + ":546"]}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": pkg + meta[name][0],
         "replaces": meta[name][1], "launches": launches[name], "path": paths[name],
         **({"also_replaces": also[name]} if name in also else {}), **kernels[name]}
        for name in ("frame", "compact", "splat_tile", "shaded", "closest", "occluded",
                     "bvh_shaded", "bvh_closest", "bvh_occluded", "frame_textured",
                     "splat_rows", "subpath")]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
