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
gate admits; K3 bit for bit against a sequential sum; the dense K4
kernels also on Cornell + icosphere and the textured room, whose times
and bounds the kernels line keeps under `*_textured_room` keys, the
shaded kernel's on an extension batch too (culling off, `extension_*`
keys); the BVH
kernels bit for bit, on pink_room at 10,546, 41,266 and 164,146
triangles), then
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
wavefront; `accel/subpath.build_subpath` (K6) on 921,600 Cornell rays;
and the Cornell megakernel path with the BMFR denoiser on (every stage,
the full screen: `bench.py`'s BMFR cell), beside the BMFR-off frame, with
one pass's stages timed by solver ('qr', 'normal'), their device
operations counted and the card's pass held against the port's CPU pass
on the same 1280x720 inputs; the 'qr' regression is BMFR's fit kernel
(`csrc/bmfr_fit.cu`, one launch a frame asserted), timed eager and
graph-replayed beside its host cost a call, its plain version and its
bound, and held against the plain version on the same card inputs.  Phase 6 drives, through `Renderer` at the
default config, the scenes the megakernel gate sends to the wavefront:
the alpha panel room (6a, 8 triangles: the dense shaded kernel with the
alpha restarts and the closest kernel on the alpha shadow batches, which
become closest-hit queries with a per-lane t_max) and the same room with
a 5,120-triangle icosphere in the cutout material (6b: `bvh_shaded` and
`bvh_closest` under restarts), each restart round's batch recorded as the
kernel receives it and held bit for bit against the plain version with
equal alpha decisions; the open scene under a 1024x512 lat-long probe
(6c, nearest and bilinear); Cornell with a tilted normal map (6d); and
the Cornell G-buffer lit by `passes/extras.probe_lit_pass` with a
`LightProbe` at its default sizes built from 6c's probe (6e: the build's
integrals timed, the card's held against the CPU's at a small size, the
result tone-mapped with 'aces' and 'clamp').  Each of 6a-6d is held
against the same scene baked with `plain=True` on the card, and profiled
(busy, idle, ms by kernel) after every timing; its numbers are the line
{"phase6": ...}.  Each path is run with the launch counts set
to 0 just before it and read just after; two renders of one frame must be
bit-identical, the wavefront frames must agree with their plain chains
(Cornell also with the megakernel frame, the textured room with both of
its megakernel frames), and small renders must match the checked-in
goldens.

K1's bound counts the ray queries of the rays its plain version traces as
the kernel runs them: the textured variant's walk (node slab tests and
pair tests by stage, from the BVH kernels' counting walk), the untextured
dense loops' pair tests; the other count is printed beside it.  The BVH
kernels' bounds count their two-box walks (the closest kernels' on the
G-buffer rays and, as `extension_bound_ms`, on an extension batch), with
the threaded walk's count beside them.  K3 and K5 are printed beside
`index_add_` of the same rows, and K2 beside `torch.sort(stable=True)` of
all its updates, each timed as eager calls (`ms`, `library_ms`, as every
kernel is) and as CUDA-graph replays (`graph_ms`, `library_graph_ms`),
which leave out the host's cost of each call; K2 and K3 also with that
host cost (`host_us`; K3's `library_host_us`).  K1's and the dense
any-hit kernel's registers, stack and spills (`ptxas`) come from the
`-Xptxas=-v` report of the build.

Exits nonzero on any failure and without a CUDA device.  The last line of
standard output is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, the line before that lists the kernels with
their launch counts, errors, times and bounds, and the line before that
is the BMFR phase's {"bmfr": {...}}: ms/frame on and off, the stage times
and device operations by solver, the card-vs-CPU errors, the regression's
bound and the fit kernel's times, registers and errors.  Before it come {"phase6": {...}}, {"phase8": {...}},
{"phase9": {...}}, {"phase10": {...}}, {"phase11": {...}} and
{"phase12": {...}}.

Phase 9 drives scene I/O and animation at 1280x720, every file written
by the port's own writers into a temporary folder: 9a, an .fscene whose
model file is missing (the Cornell stand-in) with a looping camera path,
through `app.main --animate`, 16 frames (16 launches each of K1, K2 and
K3), equal to Renderer + animate and resumed from a checkpoint at frame 8
bit for bit; 9b, the animated flagship, pink_room's stand-in from an
.fscene with the reference's lights and camera, a camera path inside the
room, a ball (ball.obj) on an object path and a point light on a light
path, 8 frames through Renderer.animate with a re-bake each frame (its
host ms beside each frame's CUDA-event ms), only the ball's triangles and
the lamp's row changing between frames, and the BVH kernels held on every
4th lane of every batch of the first and the last frame against their
plain versions; 9c, the alpha panel room as OBJ + MTL with an RGBA PNG
cutout map_Kd and a PNG map_bump, through `--scene x.obj`: the dense
kernels bit-equal under the alpha restarts; 9d, Cornell's geometry
through save_fbx and an .fscene, then `--export-scene` and the exported
file, each frame against the built-in Cornell box's.

Phase 10 (before phase 5e's profiler, as phases 6, 8 and 9) drives row
sharding (`parallel/sharding.py`) at 1280x720: 10a, K1 over 2 and 4 row
shards (pix0, n_sub), Cornell and the deferred textured room, every
column bit for bit against the whole-image launch; 10b / 10c, two ranks
on this card (gloo, as NCCL refuses two ranks on one device) through
`Renderer(mesh=)`: the megakernel route on Cornell (4 frames) and the
deferred textured room (2), the wavefront on Cornell and pink_room (2
each, the BVH kernels on pink_room), and BMFR on over Cornell with the
camera moved a few pixels a frame (3), each against the single-device
frames (G-buffer bit for bit, PipelineOutput within 2e-5, each rank's
launches a frame asserted), ms a frame by CUDA events on each rank and
the host clock, and the splat image's all-reduce alone (14.7 MB of f32
rgba); 10d, `app.main --shard 2`, 4 frames and a checkpoint resumed to 8,
the PNG written and the accumulator against 8 single-device frames.  The
ranks share the card, so their times show the collectives' overhead, not
scaling.  Its numbers are the line {"phase10": ...}, after
{"phase9": ...}; the kernels line gives each kernel's launches a rank in
each sharded run (`sharded_launches_per_rank`).

Phase 11 (after 10, before 5e) drives JAX's frame options at 1280x720:
11a, pink_room's wavefront with `sort_bounces` and `sort_shadows` on (the
defaults: the extensions and the est-1 and est-2 shadow batches walked in
the direction-sorted order of `ops/raysort.py`; est-3's always is) and off,
3 frames each, bit for bit, ms a frame; each BVH kernel's launch with and
without a ray `order` on pink_room's G-buffer, extension and shadow
batches (answers bit for bit), beside `sort_order`'s own time and the
kernel's bound from phase 4d; 11b, Cornell (dense tier) and pink_room (BVH
tier) under `reverse_shadows` (within the image bounds of the full
frame), `merge_shadow_batches` (bit for bit, one any-hit launch a frame)
and each timing stub and both, 4 timed frames each, every option twice in
turns (the list, then reversed), ms a frame beside the full frame's and
the launches a frame; 11c, every splat mode on one Cornell
wavefront frame's estimator-2 updates against 'direct' (each within its
mode's bound, ms a call), the tiled modes with `segments=3` bit-equal to
the flat sort, K5 with segments on the frame's rows against K5 on the flat
sort and its plain version, and a frame with `splat_segments` (rgb8e
decoded into K5, run by run) bit-equal to the frame without.  Its numbers
are the line {"phase11": ...}, after {"phase10": ...}; the kernels line
gains the variants `bvh_shaded[order]`, `bvh_closest[order]`,
`bvh_occluded[order]` (the ordered launch on the batch the main path
orders: extensions, the shadow batch) and `splat_rows[segments]`, each with
the launches of the main path's run (`cuda.LAUNCHES_BY_VARIANT`).

Phase 12 (after 11, before 5e) drives the image decoders, which this
machine needs, having no PIL: 12a, every fixture of `tests/torch_images/`
(JPEG baseline, progressive, 4:4:4 / 4:2:2 / 4:2:0, restarts, grey, EXIF;
PNG at 2, 4 and 16 bits, Adam7; TGA raw, RLE, colour-mapped, 16-bit; BMP
palettes, 16 / 24 / 32 bits, bit fields) decoded bit-equal to PIL's
decode checked in beside it, host ms a file and a megapixel (best of 3);
12b, the alpha panel as OBJ + MTL with its cutout map_Kd a 32-bit RLE TGA
and the walls' map_Kd a progressive 4:2:0 JPEG, through `app.main
--scene`, its launches equal to and its image bit-equal to the same scene
with PNG maps of the same pixels; 12c, `--envmap` with the 1024x512
baseline JPEG and `--probe` (phase 8d's route and launches), render and
probe_lit bit-equal to its PNG twin's; 12d, pink_room built from the
fixtures under its 28 texture names, its atlas and frames bit-equal to
those of a folder of their PNG twins and unlike the checkerboard build's,
the launches of the twins' route.  Each with ms a frame by CUDA events;
its numbers are the line {"phase12": ...}, after {"phase11": ...}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
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
PACK_ID_COL = 44             # the material id's column of the triangle pack (accel/tri_pack)


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
    takes the third stage where t lies in (tmin, tmax).  A dead ray (tmax
    <= tmin, or NaN) needs no pair.  Counted in [rays x tris] chunks from
    the plain pair test."""
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
        visited &= hi > lo
        reached = visited & dir_ok
        total += (s1 * int(visited.sum()) + s2 * int(reached.sum())
                  + s3 * int((reached & (t > lo) & (t < limit)).sum()))
    return total


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


def ptxas_report(log: str) -> dict:
    """Each kernel's registers, stack frame and spill bytes, by its mangled
    name, from the `-Xptxas=-v` lines of a verbose build's log."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and props in out:
            out[props].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m[1])
    return out


def build_report(cuda) -> dict:
    """Build the kernels of a checkout (`cuda`, its module) and return the
    ptxas report of the build that made its library: the nvcc log the
    module keeps beside the library, or, for a checkout whose module keeps
    none, the output of a verbose build this call makes ({} where the
    library was built before)."""
    if hasattr(cuda, "BUILD_LOG"):
        return ptxas_report((cuda.build().parent / cuda.BUILD_LOG).read_text())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cuda.build(verbose=True)
    return ptxas_report(buf.getvalue())


def kernel_ptxas(report: dict, key: str) -> dict:
    """The report's entry of the kernel whose mangled name holds `key`
    (e.g. "frame_kernelILi3ELb0E": frame_kernel<3, false>), or {}."""
    hits = [v for k, v in report.items() if key in k]
    return hits[0] if len(hits) == 1 else {}


def alpha_bvh_scene(procedural):
    """Phase 6b's scene: the alpha panel room (`models/procedural.
    alpha_panel_scene`) and an icosphere of 5,120 triangles
    (subdivisions 4) in the panel's cutout material behind the panel."""
    built = procedural.alpha_panel_scene()
    built.meshes.append(procedural.icosphere((0.5, 0.45, 0.75), 0.2, 1, subdivisions=4))
    return built


def latlong_probe_gradient(height: int = 32, width: int = 64) -> np.ndarray:
    """tests/test_envmap.py's lat-long probe [h, w, 4]: hue with longitude,
    brightness with latitude (the env-map golden's)."""
    v, u = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    return np.stack([u, 1.0 - u, v, np.ones_like(u)], -1).astype(np.float32)


def latlong_probe(height: int = 512, width: int = 1024, seed: int = 0) -> np.ndarray:
    """Phase 6c's lat-long probe: the gradient plus noise from a fixed seed."""
    env = latlong_probe_gradient(height, width)
    env[..., :3] += np.random.RandomState(seed).uniform(0.0, 0.2, (height, width, 3))
    return env


def open_scene(procedural, scene_cls, env, aspect: float):
    """tests/test_envmap.py's open scene (a floor quad and a point light,
    most primary rays missing into the sky) with `env` as its probe."""
    s = procedural.BuiltScene(materials=[procedural.MaterialDesc(
        "floor", base_color=(0.7, 0.7, 0.7, 1.0))])
    s.meshes.append(procedural.quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2), 0))
    s.lights = [{"type": "point", "pos": (0.0, 2.0, 0.0), "intensity": (3.0, 3.0, 3.0)}]
    s.camera = {"pos": (0.0, 0.5, -3.0), "target": (0.0, 1.2, 0.0),
                "up": (0.0, 1.0, 0.0), "focal_length": 21.0, "aspect": 1.0}
    sc = scene_cls.from_built(s, aspect=aspect)
    sc.env_map = env
    return sc


def normal_mapped_cornell(procedural):
    """Phase 6d's scene: Cornell with tests/test_passes.py's tilted
    tangent-space normal map (0.75, 0.5, 1) on material 0."""
    built = procedural.cornell_box()
    tilt = np.zeros((8, 8, 4), np.float32)
    tilt[..., 0], tilt[..., 1], tilt[..., 2:] = 0.75, 0.5, 1.0
    built.materials[0].normal_map_image = tilt
    return built


def write_png_rgba(path: str, rgba: np.ndarray) -> None:
    """An 8-bit RGBA PNG (colour type 6, filter 0) of float [H, W, 4] in
    [0, 1]: the cutout map of phase 9c, which `utils/image.write_png`
    (RGB or grey) cannot write."""
    u8 = np.clip(np.rint(np.asarray(rgba, np.float32) * 255.0), 0, 255).astype(np.uint8)
    h, w = u8.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fh.write(chunk(b"IEND", b""))


def write_tga_rle32(path: str, rgba: np.ndarray) -> None:
    """A 32-bit RLE TGA (type 10, top-left origin) of float [H, W, 4] in
    [0, 1], rounded as `write_png_rgba` rounds: phase 12b's cutout map.
    Each row is runs of equal pixels and raw packets, 128 pixels at most."""
    u8 = np.clip(np.rint(np.asarray(rgba, np.float32) * 255.0), 0, 255).astype(np.uint8)
    h, w = u8.shape[:2]
    out = bytearray(struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 32, 0x28))
    for row in u8[..., [2, 1, 0, 3]]:
        px = [p.tobytes() for p in row]
        x = 0
        while x < w:
            n = 1
            while x + n < w and n < 128 and px[x + n] == px[x]:
                n += 1
            if n > 1:
                out += bytes([0x80 | (n - 1)]) + px[x]
            else:
                while x + n < w and n < 128 and px[x + n] != px[x + n - 1]:
                    n += 1
                out += bytes([n - 1]) + b"".join(px[x:x + n])
            x += n
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def write_json(path: str, doc: dict) -> str:
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def cornell_fscene_doc(model_file: str, camera_path: bool) -> dict:
    """Phase 9a's and 9d's .fscene: the Cornell box's light and camera
    (`models/procedural.cornell_box`), one model file (missing: the
    loader's cornell_box() stand-in), and a looping camera path of 4
    keyframes swinging around the box."""
    doc = {"version": 2, "active_camera": "cam",
           "models": [{"file": model_file, "instances": [{"name": "box"}]}],
           "lights": [{"name": "key", "type": "point_light", "pos": [0.5, 0.93, 0.5],
                       "intensity": [18.0, 18.0, 18.0]}],
           "cameras": [{"name": "cam", "pos": [0.5, 0.5, -1.35], "target": [0.5, 0.5, 0.5],
                        "up": [0.0, 1.0, 0.0], "focal_length": 21.0, "aspect_ratio": 1.0}]}
    if camera_path:
        doc["paths"] = [{"name": "swing", "loop": True, "frames": [
            {"time": t, "pos": [0.5 + x, 0.5 + y, -1.35], "target": [0.5, 0.5, 0.5],
             "up": [0.0, 1.0, 0.0]}
            for t, x, y in ((0.0, 0.0, 0.0), (0.08, 0.12, 0.03), (0.16, -0.1, 0.06),
                            (0.3, 0.0, 0.0))]}]
    return doc


def pink_fscene_doc(room) -> dict:
    """Phase 9b's .fscene: a missing pink_room.fbx (the loader's stand-in
    room), a ball from ball.obj (instance `ball`, radius 0.18), the
    reference's lights and camera (`room`: models/pink_room.pink_room with
    the .fscene's lights), a looping camera path inside the room (x in
    [-5, 0]), an object path carrying the ball over the coffee table and a
    light path moving the second point light `lamp2`."""
    kinds = {"directional": "dir_light", "dir": "dir_light", "point": "point_light"}
    lights = []
    for k, light in enumerate(room.lights):
        entry = {"name": ("sun", "lamp1", "lamp2")[k], "type": kinds[light["type"]],
                 "intensity": list(light["intensity"])}
        if "dir" in light:
            entry["direction"] = list(light["dir"])
        if "pos" in light:
            entry["pos"] = list(light["pos"])
        lights.append(entry)
    cam = room.camera
    p0, tgt = np.asarray(cam["pos"]), np.asarray(cam["target"])

    def key(t, dp, dt=(0.0, 0.0, 0.0)):
        return {"time": t, "pos": (p0 + dp).tolist(), "target": (tgt + dt).tolist(),
                "up": list(cam["up"])}

    lamp = np.asarray(room.lights[2]["pos"])
    return {
        "version": 2, "active_camera": "cam",
        "models": [{"file": "pink_room.fbx", "name": "room"},
                   {"file": "ball.obj", "instances": [{"name": "ball",
                                                       "scaling": [0.18, 0.18, 0.18]}]}],
        "lights": lights,
        "cameras": [{"name": "cam", "pos": list(cam["pos"]), "target": list(cam["target"]),
                     "up": list(cam["up"]), "focal_length": cam["focal_length"],
                     "aspect_ratio": cam["aspect"]}],
        "paths": [
            {"name": "walk", "loop": True, "frames": [
                key(0.0, (0.0, 0.0, 0.0)), key(0.05, (0.25, 0.05, 0.1), (0.1, 0.0, 0.0)),
                key(0.1, (-0.2, 0.1, 0.15), (-0.1, 0.05, 0.0)), key(0.2, (0.0, 0.0, 0.0))]},
            {"name": "ball", "loop": True,
             "attached_objects": [{"type": "model_instance", "name": "ball"}],
             "frames": [{"time": 0.0, "pos": [-2.5, 0.9, -1.5], "target": [-2.5, 0.9, -2.5]},
                        {"time": 0.1, "pos": [-2.2, 1.05, -1.3], "target": [-1.9, 1.0, -2.2]},
                        {"time": 0.2, "pos": [-2.6, 0.95, -1.7], "target": [-2.6, 0.95, -2.7]}]},
            {"name": "lamp", "loop": True,
             "attached_objects": [{"type": "light", "name": "lamp2"}],
             "frames": [{"time": 0.0, "pos": lamp.tolist(), "target": (lamp - [0, 1, 0]).tolist()},
                        {"time": 0.1, "pos": (lamp + [-0.3, 0.12, 0.2]).tolist(),
                         "target": (lamp + [-0.3, -0.88, 0.2]).tolist()},
                        {"time": 0.2, "pos": (lamp + [0.1, -0.08, -0.15]).tolist(),
                         "target": (lamp + [0.1, -1.08, -0.15]).tolist()}]},
        ],
    }


# ---- phase 10's runs: row sharding over ranks sharing the card ----------
# (label, scene, BDPTConfig keywords, BMFR on, frames, camera moved); the
# single-device references render the same runs
P10_RUNS = (
    ("10b megakernel Cornell", "cornell", {}, False, 4, False),
    ("10b megakernel textured room (deferred)", "textured", {"defer_textures": True}, False, 2,
     False),
    ("10c wavefront Cornell", "cornell", {"megakernel": "off"}, False, 2, False),
    ("10c wavefront pink_room", "pink_room", {}, False, 2, False),
    ("10c BMFR on Cornell (camera moved)", "cornell", {}, True, 3, True),
)
P10_GBUF = ("WorldPosition", "WorldNormal", "MaterialDiffuse", "MaterialSpecRough",
            "MaterialExtraParams", "Emissive")
P10_ALL_REDUCES = 10


def p10_renderer(run, device, mesh=None):
    """Renderer of one of P10_RUNS at WIDTH x HEIGHT, depth DEPTH (on
    `mesh`, this rank's rows)."""
    from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room
    from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box, textured_room
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
        BDPTConfig,
        BMFRConfig,
        RenderConfig,
    )

    _, name, bdpt_kw, bmfr, _, _ = run
    built = {"cornell": cornell_box, "textured": textured_room,
             "pink_room": lambda: pink_room(asset_dir="", subdivisions=3)}[name]()
    baked = Scene.from_built(built, aspect=WIDTH / HEIGHT).bake(max_lights=16, device=device)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, bdpt=BDPTConfig(max_depth=DEPTH, **bdpt_kw),
                       bmfr=BMFRConfig(enabled=bmfr, regression=bmfr, half_screen_debug=False))
    # eager on one device too (no CUDA graphs), as the sharded steps are:
    # the graphs' camera lives on the card, whose |W| may round otherwise
    return Renderer(baked, cfg, mesh=mesh, graphs=False)


def p10_frames(run, renderer):
    """Render a run's frames, the camera moved a few pixels a frame where
    the run says (BMFR's reprojection crosses the shard boundary, within
    its 64-row margin): [(channels, CUDA-event ms, host ms)] a frame."""
    moved = run[5]
    p0, t0, u0 = (renderer.camera.pos_w.clone(), renderer.camera.target.clone(),
                  renderer.camera.up.clone())
    out = []
    for i in range(run[4]):
        if moved and i:
            renderer.set_camera_pose(p0 + torch.tensor([0.004 * i, 0.003 * i, 0.0]), t0, u0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        renderer.render_frame()
        end.record()
        torch.cuda.synchronize()
        out.append((dict(renderer.channels), start.elapsed_time(end),
                    (time.perf_counter() - t_host) * 1e3))
    return out


def p10_digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def p10_rank(rank, mesh):
    """Phase 10 on one rank: every run of P10_RUNS on this rank's rows (the
    G-buffer channels' digests, PipelineOutput's rows, ms a frame, the
    launches of the run), then the frame's collective alone: the sum of a
    full-size f32 rgba splat image over the ranks, timed."""
    from fyp_bidirectionalpathtracer_tpu_torch import cuda

    out = {"device": str(mesh.device), "backend": mesh.backend, "runs": {}}
    for run in P10_RUNS:
        renderer = p10_renderer(run, mesh.device, mesh)
        cuda.reset_launch_counts()
        frames = p10_frames(run, renderer)
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        out["runs"][run[0]] = {
            "gbuf": [{k: p10_digest(ch[k]) for k in P10_GBUF} for ch, _, _ in frames],
            "output": [ch["PipelineOutput"].cpu() for ch, _, _ in frames],
            "finite": all(bool(torch.isfinite(ch["PipelineOutput"]).all()) for ch, _, _ in frames),
            "ms": [ms for _, ms, _ in frames], "host_ms": [h for _, _, h in frames],
            "launches": launches, "count": int(renderer.state.accum.count),
            "rows": list(mesh.row_range(HEIGHT))}
        del renderer, frames
    splat = torch.zeros(WIDTH * HEIGHT * 4, dtype=torch.float32, device=mesh.device)
    for _ in range(2):
        mesh.all_reduce(splat)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    start.record()
    for _ in range(P10_ALL_REDUCES):
        mesh.all_reduce(splat)
    end.record()
    torch.cuda.synchronize()
    out["all_reduce"] = {"bytes": splat.numel() * 4,
                         "ms": start.elapsed_time(end) / P10_ALL_REDUCES,
                         "host_ms": (time.perf_counter() - t_host) * 1e3 / P10_ALL_REDUCES}
    return out


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
    from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
    from fyp_bidirectionalpathtracer_tpu_torch.ops import alpha as alpha_mod
    from fyp_bidirectionalpathtracer_tpu_torch.ops import compact, lightprobe, splat_tile, tonemap
    from fyp_bidirectionalpathtracer_tpu_torch.ops import splat as splat_mod
    from fyp_bidirectionalpathtracer_tpu_torch.ops.raysort import sort_order
    from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import (
        make_shaded_tracer,
        shading_from_fields_fm,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
    from fyp_bidirectionalpathtracer_tpu_torch.passes import bmfr as bmfr_mod
    from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
    from fyp_bidirectionalpathtracer_tpu_torch.passes import extras
    from fyp_bidirectionalpathtracer_tpu_torch.passes.extras import probe_lit_pass
    from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import (
        pixel_jitter_for_frame,
        ray_traced_gbuffer,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline import app
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
        BDPT_FRAME_INIT,
        GBUF_FRAME_INIT,
        Renderer,
        render_frame_fn,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import camera_ray_dirs
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.frame_profile import (
        device_operations,
        profile_calls,
        profile_renderer,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.scene.types import on_device
    from fyp_bidirectionalpathtracer_tpu_torch.utils.config import (
        BDPTConfig,
        BMFRConfig,
        GBufferConfig,
        RenderConfig,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.utils.image import psnr, read_png, to_u8, write_png
    from fyp_bidirectionalpathtracer_tpu_torch.utils.testing import GOLDEN_DIR

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    ptxas = build_report(cuda)
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
    def k2_call():
        return compact.compact_live(keys_d, pay_d, n_pix, sent)

    def k2_lib_call():  # one PyTorch call that groups the updates by pixel as K2 + sort do
        return torch.sort(keys_d, stable=True)

    # eager calls (`ms`, as every kernel's), CUDA-graph replays of 20 calls
    # (`graph_ms`, without the host's cost of a call) and that host cost
    k2_ms, k2_graph, k2_host = time_ms(k2_call, 20), time_graph_ms(k2_call), host_us(k2_call)
    k2_plain = time_ms(lambda: compact.compact_plain(keys_d, pay_d, n_pix, sent), 5)
    k2_lib, k2_lib_graph = time_ms(k2_lib_call, 20), time_graph_ms(k2_lib_call)
    log(f"K2 compaction U={u} live={n_live}: bit-equal; kernel {k2_ms:.4f} ms (graph "
        f"{k2_graph:.4f} ms, host {k2_host:.2f} us a call), plain {k2_plain:.4f} ms, "
        f"torch.sort(stable) of all U {k2_lib:.4f} ms (graph {k2_lib_graph:.4f} ms)")
    # bytes: every key read, the live updates' payloads read, both outputs
    # written (a dead update's payload is not read)
    kernels["compact"] = dict(max_abs_err=0.0, ms=k2_ms, graph_ms=k2_graph, host_us=k2_host,
                              plain_ms=k2_plain, library_ms=k2_lib,
                              library_graph_ms=k2_lib_graph,
                              **bound(12.0 * u + 4.0 * n_live, 0.0))

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

    def cfg_for(w, h, megakernel="auto", bmfr=BMFRConfig(), gbuffer=GBufferConfig(), **bdpt_kw):
        return RenderConfig(width=w, height=h, bmfr=bmfr, gbuffer=gbuffer,
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
    # Cornell's instantiation: the small scenes' (frame_launch.cuh)
    k1_ptxas = kernel_ptxas(ptxas, f"frame_kernelILi{DEPTH}ELb0ELi4E")
    log(f"K1 frame_kernel<{DEPTH}, false, 4> ptxas: "
        f"{k1_ptxas or 'not reported (built earlier)'}; frame_kernel<{DEPTH}, false, 1>: "
        f"{kernel_ptxas(ptxas, f'frame_kernelILi{DEPTH}ELb0ELi1E') or 'not reported'}")
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
                            ms=k1_ms, plain_ms=k1_plain, library_ms=None, ptxas=k1_ptxas,
                            **k1_bd)

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

    def check_k4(bk, w, h, record=None):
        """The K4 kernels on `bk`'s rays against their plain versions, then
        timed; `record`: the suffix of the kernels line's keys for these
        times ("" for the main keys; None records nothing)."""
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
        rows_e, _ = isect.rays(o_e, d_e, MIN_T, None)
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
            # an extension batch: culling off, t_min = MIN_T
            "shaded extension": lambda: lib.bdpt_intersect_shaded(
                p(rows_e), n, p(bk.tri_pack), bk.n_tris, 0, p(fields), stream),
            "closest": lambda: lib.bdpt_intersect_closest(p(rows_g), n, p(bk.tri_pack),
                                                          bk.n_tris, 1, p(t_), p(id_), p(u_),
                                                          p(v_), stream),
            "occluded": lambda: lib.bdpt_occluded(p(rows_s), ns, p(bk.tri_pack), bk.n_tris,
                                                  p(occ), stream),
        }
        plains = {
            "shaded": lambda: isect.shaded_plain(*args, o_g, d_g, 0.0, None, True),
            "shaded extension": lambda: isect.shaded_plain(*args, o_e, d_e, MIN_T, None, False),
            "closest": lambda: isect.closest_plain(*args, o_g, d_g, 0.0, None, True),
            "occluded": lambda: isect.occluded_plain(*args, o_s, d_s, MIN_T, tm_s),
        }
        # bytes: the eight float32 ray rows in (tmin and tmax alone for a
        # dead ray, tmax <= tmin); out 32 float32 fields (shaded), t id u v
        # (closest), one byte (any-hit); operations: the pair tests these
        # rays need (pair_flops)
        out_bytes = {"shaded": 4.0 * isect.OUT_W, "shaded extension": 4.0 * isect.OUT_W,
                     "closest": 16.0, "occluded": 1.0}
        tris = bk.tri_pack[:bk.n_tris]
        o_g_, d_g_, tmin_g, tmax_g = isect.components(rows_g)
        o_e_, d_e_, tmin_e, tmax_e = isect.components(rows_e)
        o_s_, d_s_, tmin_s, tmax_s = isect.components(rows_s)
        flops_g = pair_flops(isect, tris, o_g_, d_g_, tmin_g, tmax_g, True, True)
        flops = {"shaded": flops_g, "closest": flops_g,
                 "shaded extension": pair_flops(isect, tris, o_e_, d_e_, tmin_e, tmax_e, False,
                                                True),
                 "occluded": pair_flops(isect, tris, o_s_, d_s_, tmin_s, tmax_s, False, False)}
        live = {"shaded": int((tmax_g > tmin_g).sum()), "shaded extension":
                int((tmax_e > tmin_e).sum()), "occluded": int((tmax_s > tmin_s).sum())}
        live["closest"] = live["shaded"]
        for name in ("shaded", "shaded extension", "closest", "occluded"):
            rays, n_live = (ns if name == "occluded" else n), live[name]
            ms = time_ms(lambda: cuda.check_error(name.split()[0], launches[name]()), 20)
            plain_ms = time_ms(plains[name], 3)
            bd = bound(n_live * 24.0 + rays * (8.0 + out_bytes[name]) + 48.0 * 4 * bk.n_tris,
                       float(flops[name]))
            log(f"K4 {name} {bk.n_tris} tris, {rays} rays ({n_live} live): kernel {ms:.4f} "
                f"ms, plain {plain_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; "
                f"{flops[name]} pair-test operations)")
            if name == "shaded extension":
                # beside the G-buffer launch's keys of the shaded kernel
                if record is not None:
                    kernels["shaded"].update({f"{k}{record}": v for k, v in dict(
                        extension_ms=ms, extension_plain_ms=plain_ms,
                        extension_bound_ms=bd["bound_ms"],
                        extension_bound_by=bd["bound_by"]).items()})
                continue
            err = max(e for e, _ in results[name]) if name in results else 0.0
            if record == "":
                kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     library_ms=None, **bd)
            elif record is not None and name != "closest":
                kernels[name].update({f"{k}{record}": v for k, v in dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, tris=bk.n_tris,
                    bound_ms=bd["bound_ms"], bound_by=bd["bound_by"]).items()})

    check_k4(cornell, WIDTH, HEIGHT, record="")
    kernels["occluded"]["ptxas"] = kernel_ptxas(ptxas, "15occluded_kernel")
    log(f"K4 any-hit occluded_kernel ptxas: {kernels['occluded']['ptxas'] or 'not reported'}")
    check_k4(scene("cornell_icosphere", 256, 144), 256, 144)
    # the textured room (342 triangles): the dense any-hit kernel on its
    # shadow batch and the shaded kernel on its G-buffer, beside Cornell's
    check_k4(room(WIDTH, HEIGHT), WIDTH, HEIGHT, record="_textured_room")

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
                p(rows), n, p(bk.tri_pack), bw, pairs, cull, p(fields), p(counter), None,
                stream),
            "bvh_closest": lambda rows, cull: lib.bdpt_bvh_closest(
                p(rows), n, bw, pairs, cull, p(t_), p(id_), p(u_), p(v_), p(counter), None,
                stream),
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
            p(rows_s), ns, bw, pairs, p(occ), p(counter), None, stream)), 10)
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
    host_ms_of = {}

    def drive(megakernel, baked=None, label=None, bmfr=BMFRConfig(), gbuffer=GBufferConfig(),
              **bdpt_kw):
        """3 warm-up and 10 timed frames through Renderer on a new
        accumulation, counts from 0 (the Cornell box unless `baked`)."""
        baked = cornell if baked is None else baked
        label = label or f"{megakernel} path"
        renderer = Renderer(baked, cfg_for(WIDTH, HEIGHT, megakernel, bmfr, gbuffer, **bdpt_kw))
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
        host_ms_of[label] = host_ms
        launches = {**cuda.LAUNCHES, **cuda.LAUNCHES_BY_VARIANT}
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
            r = Renderer(baked, cfg_for(WIDTH, HEIGHT, megakernel, bmfr, gbuffer, **bdpt_kw))
            r.render_frame()
            twice.append({k: v.clone() for k, v in r.channels.items()})
        if not all(torch.equal(twice[0][k], twice[1][k]) for k in twice[0]):
            raise AssertionError(f"the same frame rendered twice differs ({label})")
        log(f"{label}: the same frame rendered twice is bit-identical")
        return launches, warmup + frames, twice[0]["BDPT"], ms

    mk_launches, n_frames, mk_frame, mk_ms = drive("auto")
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
    # the extensions and the three shadow batches walk their rays in the
    # direction-sorted order (sort_bounces, sort_shadows: the defaults)
    for key, want in (("bvh_shaded[order]", DEPTH - 1 + DEPTH), ("bvh_occluded[order]", 3)):
        if pk_launches[key] != want * pk_frames:
            raise AssertionError(f"kernel {key} launched {pk_launches[key]} times in "
                                 f"{pk_frames} pink_room frames, want {want} a frame")
    log(f"pink_room launches a frame: {per_frame_pk} (as required), of them ordered "
        f"{ {k: v // pk_frames for k, v in pk_launches.items() if '[order]' in k} }")
    # ---- phase 5b: pink_room at 41,266 and 164,146 triangles ---------------
    # above 32768 triangles the shaded tracer takes the BVH closest kernel
    # and gathers the attributes and texels (JAX ops/shading.py:699-713)
    big_launches = {}
    for sub in (4, 5):
        big = pink(sub, WIDTH, HEIGHT)
        big_launches[sub], n_big, _, _ = drive("auto", big, f"pink_room subdivisions={sub} "
                                               f"({big.n_tris} tris)")
        for key, want in (("bvh_closest", 1 + (DEPTH - 1) + DEPTH), ("bvh_occluded", 3),
                          ("bvh_shaded", 0), ("bvh_closest[order]", DEPTH - 1 + DEPTH),
                          ("bvh_occluded[order]", 3)):
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

    # ---- phase 6: alpha, lat-long env maps, normal maps, the light probe -----
    # the scenes the megakernel gate sends to the wavefront for them, at
    # 1280x720, depth 3, the default config; timed before phase 5e's
    # profiler (CUPTI slows every launch after it has traced) and profiled
    # after it (`p6_renderers`)
    p6 = {"device": smi, "size": f"{WIDTH}x{HEIGHT}", "depth": DEPTH, "runs": {}}
    p6_renderers = {}
    p6_kernels = {}

    def alpha_restarts(bk, label, step=1):
        """The batches the alpha restarts hand the kernels on `bk`: its
        1280x720 G-buffer trace through make_shaded_tracer's restarts and
        an est-3-shaped shadow batch through baked.intersector()'s (a
        closest-hit query with a per-lane t_max), recorded as the kernels
        receive them; on every step-th ray of each round the kernel bit for
        bit against its plain version and the alpha decisions at both hits
        equal; each round's kernel timed on the whole batch (the wrapper's
        call) and its live lanes (t_min < t_max: not inert) counted."""
        opaque = replace(bk, has_alpha=False)  # the same kernels, unwrapped
        kernel_trace, kernel_query = make_shaded_tracer(opaque), opaque.intersector()
        traced, queried = [], []

        def record_trace(o, d, tmin, view, cull_backface=False, coherent=True):
            traced.append((o, d, tmin, None, cull_backface))
            return kernel_trace(o, d, tmin, view, cull_backface)

        def record_query(o, d, tmin, tmax=None, closest=True, cull_backface=False,
                         coherent=True):
            queried.append((o, d, tmin, tmax, cull_backface))
            return kernel_query(o, d, tmin, tmax, closest, cull_backface)

        dense = bk.n_tris <= isect.MAX_DENSE_TRIS
        args = (bk.tri_pack, bk.n_tris)
        if dense:
            shaded_k, closest_k = (partial(isect.intersect_shaded_fm, *args),
                                   partial(isect.intersect_closest, *args))
            k_names = ("shaded", "closest")
        else:
            shaded_k = partial(cluster.bvh_shaded_fm, *args, bk.bw_rows, bk.bvh_pairs)
            closest_k = partial(cluster.bvh_closest, bk.bw_rows, bk.n_tris, bk.bvh_pairs)
            k_names = ("bvh_shaded", "bvh_closest")
        (o_g, d_g), _, (o_s, d_s, tm_s) = k4_rays(
            bk, WIDTH, HEIGHT, dev,
            None if dense else partial(cluster.bvh_shaded_fm, rows=bk.bw_rows,
                                       pairs=bk.bvh_pairs))
        alpha_mod.wrap_tracer(bk, record_trace)(o_g, d_g, 0.0, o_g, cull_backface=True)
        alpha_mod.wrap_intersector(bk, record_query)(o_s, d_s, MIN_T, tm_s, closest=False)
        mats, tris = on_device(bk.data.materials, dev), on_device(bk.tris, dev)
        stats = {}
        for name, kernel, batches in ((k_names[0], shaded_k, traced),
                                      (k_names[1], closest_k, queried)):
            rounds = []
            for r, (o, d, tmin, tmax, cull) in enumerate(batches):
                tmin = torch.broadcast_to(torch.as_tensor(tmin, device=dev), o.shape[:-1])
                tmax_full = torch.full_like(tmin, 1e30) if tmax is None else tmax
                os_, ds_, ts_ = pick(o, step), pick(d, step), pick(tmin, step, 1)
                tx_ = None if tmax is None else pick(tmax, step, 1)
                if tmax is None:
                    kh, kf = kernel(os_, ds_, ts_, None, cull)
                    ph, pf = isect.shaded_plain(*args, os_, ds_, ts_, None, cull)
                    equal = all(torch.equal(bits(a), bits(b)) for a, b in (
                        (kf, pf), (kh.t, ph.t), (kh.tri, ph.tri)))
                    fails = [alpha_mod._fails(bk.atlas, mats, h, sd.material_id, sd.uv)
                             for h, sd in ((kh, shading_from_fields_fm(kf, bk.atlas, kh, os_,
                                                                       ds_, os_)),
                                           (ph, shading_from_fields_fm(pf, bk.atlas, ph, os_,
                                                                       ds_, os_)))]
                    plain = partial(isect.shaded_plain, *args, os_, ds_, ts_, None, cull)
                    full = partial(kernel, o, d, tmin, None, cull)
                else:
                    kc = kernel(os_, ds_, ts_, tx_, cull)
                    pc = isect.closest_plain(*args, os_, ds_, ts_, tx_, cull)
                    equal = all(torch.equal(bits(a), bits(b)) for a, b in (
                        (kc.t, pc.t), (kc.tri, pc.tri), (kc.bary_u, pc.bary_u),
                        (kc.bary_v, pc.bary_v)))
                    fails = [alpha_mod._alpha_fails(tris, mats, bk.atlas, h, os_, ds_)
                             for h in (kc, pc)]
                    plain = partial(isect.closest_plain, *args, os_, ds_, ts_, tx_, cull)
                    full = partial(kernel, o, d, tmin, tmax, cull)
                decisions = bool(torch.equal(*fails))
                torch.cuda.synchronize()
                rounds.append(dict(
                    round=r, rays=int(tmin.numel()), checked_rays=int(ts_.numel()),
                    live=int((tmin < tmax_full).sum()), failed_alpha=int(fails[0].sum()),
                    bit_equal=equal, decisions_equal=decisions, ms=time_ms(full, 5),
                    plain_ms=time_ms(plain, 1)))
                if not (equal and decisions):
                    raise AssertionError(f"{name} differs from its plain version on the alpha "
                                         f"restart batch {r} of {label}")
            total = sum(x["ms"] for x in rounds)
            stats[name] = {"scene": label, "tris": bk.n_tris, "rounds": rounds,
                           "ms": total, "restart_share": (total - rounds[0]["ms"]) / total,
                           "max_abs_err": 0.0}
            log(f"alpha restarts {label}, {name} ({len(rounds)} rounds, {rounds[0]['rays']} "
                f"rays, every {step} checked): bit-equal to the plain version, alpha "
                f"decisions equal; live lanes by round {[x['live'] for x in rounds]}, ms by "
                f"round {[round(x['ms'], 4) for x in rounds]}, restart rounds' share "
                f"{stats[name]['restart_share']:.3f}")
        return stats

    def p6_run(label, bk, per_frame, plain_size=(WIDTH, HEIGHT), gbuffer=GBufferConfig()):
        """`bk` through Renderer at 1280x720 (drive: counts from 0, two
        renders of one frame bit-identical), each kernel's launches a frame
        as `per_frame` says, and the kernel frame within the image bounds of
        the same scene baked with plain=True on the card at `plain_size`."""
        launches, n, _, ms = drive("auto", bk, label, gbuffer=gbuffer)
        for key in cuda.LAUNCHES:
            if launches[key] != per_frame.get(key, 0) * n:
                raise AssertionError(f"{label}: kernel {key} launched {launches[key]} times in "
                                     f"{n} frames, want {per_frame.get(key, 0)} a frame")
        w, h = plain_size
        frames = []
        for plain in (False, True):
            ch, _, _ = render_frame_fn(replace(bk, plain=plain), bk.data.camera,
                                       AccumState.create(h, w, dev), BMFRState.create(h, w, dev),
                                       GBUF_FRAME_INIT, BDPT_FRAME_INIT, False,
                                       cfg_for(w, h, gbuffer=gbuffer))
            frames.append(ch["BDPT"])
        frac, mad, dmean, ok = image_stats(*frames)
        identical = bool(torch.equal(*frames))
        log(f"{label} {w}x{h}, kernels vs plain chain: identical {identical}, frac>1e-3 "
            f"{frac:.4f} (<= 0.02), mean|d| {mad:.2e} (< 5e-3), mean radiance d {dmean:.2e} "
            f"(< 2e-3); launches a frame {per_frame} (as required)")
        if not ok:
            raise AssertionError(f"{label}: the kernel frame differs from its plain chain")
        p6["runs"][label] = {"tris": bk.n_tris, "ms_per_frame": ms,
                             "host_ms_per_frame": host_ms_of[label], "frames": n,
                             "launches_per_frame": {k: v // n for k, v in launches.items() if v},
                             "vs_plain": {"size": f"{w}x{h}", "identical": identical,
                                          "frac": frac, "mad": mad, "dmean": dmean}}
        p6_renderers[label] = (bk, cfg_for(WIDTH, HEIGHT, gbuffer=gbuffer))
        return launches

    wave = {"compact": 1, "splat_tile": 1}
    traces = 1 + (DEPTH - 1) + DEPTH  # the G-buffer, the camera and light extensions
    restarts = 1 + alpha_mod.MAX_RESTARTS
    # 6a: the alpha panel room (8 triangles): the dense tier
    panel = Scene.from_built(procedural.alpha_panel_scene(),
                             aspect=WIDTH / HEIGHT).bake(device=dev)
    if not (panel.has_alpha and not frame_mod.supports_megakernel(panel, cfg_for(64, 48))):
        raise AssertionError("the alpha panel room must take the wavefront")
    p6_kernels.update(alpha_restarts(panel, "6a alpha panel"))
    p6_run("6a alpha panel (dense)", panel,
           {"shaded": traces * restarts, "closest": 3 * restarts, **wave})
    # 6b: the same room and a 5,120-triangle icosphere in the cutout: the
    # BVH tier (the plain chain at 640x360: 5,128 triangles in torch)
    panel_bvh = Scene.from_built(alpha_bvh_scene(procedural),
                                 aspect=WIDTH / HEIGHT).bake(device=dev)
    if not (panel_bvh.has_alpha and panel_bvh.n_tris > isect.MAX_DENSE_TRIS):
        raise AssertionError("6b's scene must be alpha-tested and above the dense tier")
    p6_kernels.update(alpha_restarts(panel_bvh, "6b alpha panel + icosphere", step=4))
    p6_run("6b alpha panel + icosphere (BVH)", panel_bvh,
           {"bvh_shaded": traces * restarts, "bvh_closest": 3 * restarts, **wave},
           plain_size=(640, 360))
    # 6c: the open scene under a 1024x512 lat-long probe, nearest and bilinear
    probe_map = latlong_probe()
    env_bk = open_scene(procedural, Scene, probe_map, WIDTH / HEIGHT).bake(device=dev)
    if frame_mod.supports_megakernel(env_bk, cfg_for(64, 48, "on")):
        raise AssertionError("supports_megakernel must refuse a 1024x512 env map")
    for bilinear in (False, True):
        p6_run(f"6c env map 1024x512 ({'bilinear' if bilinear else 'nearest'})", env_bk,
               {"shaded": traces, "occluded": 3, **wave},
               gbuffer=GBufferConfig(env_bilinear=bilinear))
    # 6d: Cornell with the tilted normal map on material 0
    nm_bk = Scene.from_built(normal_mapped_cornell(procedural),
                             aspect=WIDTH / HEIGHT).bake(device=dev)
    if not (nm_bk.has_normal_maps and not frame_mod.supports_megakernel(nm_bk, cfg_for(64, 48))):
        raise AssertionError("the normal-mapped Cornell box must take the wavefront")
    p6_run("6d Cornell normal map", nm_bk, {"shaded": traces, "occluded": 3, **wave})
    # 6e: the Cornell G-buffer lit by probe_lit_pass, the probe at its default
    # sizes from 6c's map; the build's integrals timed one by one
    probe_env = torch.from_numpy(probe_map).to(dev)
    build = {}
    for name, fn in (("diffuse", lambda: lightprobe.integrate_diffuse_ld(probe_env)),
                     ("specular", lambda: lightprobe.integrate_specular_ld(probe_env)),
                     ("dfg", lambda: lightprobe.integrate_dfg(device=dev))):
        torch.cuda.synchronize()
        t_build = time.perf_counter()
        build[name] = fn()
        torch.cuda.synchronize()
        build[f"{name}_ms"] = (time.perf_counter() - t_build) * 1e3
    probe = lightprobe.LightProbe.__new__(lightprobe.LightProbe)  # the maps built above
    probe.origin, probe.diffuse, probe.specular, probe.dfg = (
        probe_env, build["diffuse"], build["specular"], build["dfg"])
    if not all(bool(torch.isfinite(m).all()) and bool((m >= 0).all())
               for m in (probe.diffuse, probe.specular, probe.dfg)):
        raise AssertionError("the light probe's maps are not finite and non-negative")
    # the card's integrals against the CPU's on a small probe
    small_env = latlong_probe(32, 64, seed=1)
    vs_cpu = {}
    for name, fn in (("diffuse", partial(lightprobe.integrate_diffuse_ld, size=16,
                                         sample_count=64)),
                     ("specular", partial(lightprobe.integrate_specular_ld, size=16,
                                          sample_count=64, mip_count=3))):
        on_card = fn(torch.from_numpy(small_env).to(dev)).cpu()
        on_cpu = fn(torch.from_numpy(small_env))
        vs_cpu[name] = float((on_card - on_cpu).abs().max())
        if not torch.allclose(on_card, on_cpu, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"the card's {name} integral differs from the CPU's")
    cb = scene("cornell", WIDTH, HEIGHT)
    ch = ray_traced_gbuffer(cb, make_shaded_tracer(cb), WIDTH, HEIGHT, GBUF_FRAME_INIT, jitter)
    cuda.reset_launch_counts()
    lit = probe_lit_pass(cb, cb.intersector(), ch, probe)
    torch.cuda.synchronize()
    pass_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    if pass_launches != {"occluded": int(cb.data.lights.count)}:
        raise AssertionError(f"probe_lit_pass launched {pass_launches}")
    pass_ms = time_ms(lambda: probe_lit_pass(cb, cb.intersector(), ch, probe), 5)
    shown = {}
    for name in ("aces", "clamp"):
        img = tonemap.tone_map(lit[..., :3], tonemap.OPERATOR_NAMES[name])
        shown[name] = {"mean": float(img.mean()), "min": float(img.min()),
                       "max": float(img.max())}
        if not (bool(torch.isfinite(img).all()) and shown[name]["min"] >= 0.0
                and shown[name]["max"] <= 1.0 and shown[name]["mean"] > 0.0):
            raise AssertionError(f"the probe-lit image tone-mapped with {name} is off")
    p6["probe"] = {"source": "1024x512 lat-long (6c)", "sizes": "LightProbe defaults: "
                   "diffuse 128 x 4096 samples, specular 1024 x 1024 samples x 8 mips, "
                   "DFG 128 x 128 samples",
                   **{f"{k}_ms": build[f"{k}_ms"] for k in ("diffuse", "specular", "dfg")},
                   "card_vs_cpu_max_abs_err": vs_cpu, "pass_ms": pass_ms,
                   "pass_launches": pass_launches, "tone_mapped": shown}
    log(f"6e light probe (default sizes, 1024x512 source): diffuse "
        f"{build['diffuse_ms']:.1f} ms, specular {build['specular_ms']:.1f} ms, DFG "
        f"{build['dfg_ms']:.1f} ms (host clock with a sync); card vs CPU at 16 texels "
        f"{vs_cpu}; probe_lit_pass {WIDTH}x{HEIGHT} {pass_ms:.4f} ms, launches "
        f"{pass_launches}; tone-mapped {shown}")
    del probe, build, lit, ch

    # ---- phase 8: the app's entry point and the output passes ----------------
    # before phase 5e's profiler, as phase 6; the app's printed lines are kept
    # out of this script's output
    p8 = {"device": smi, "size": f"{WIDTH}x{HEIGHT}"}
    app_scene = ["--scene", "cornell", "--width", str(WIDTH), "--height", str(HEIGHT)]

    def run_app(argv):
        """app.main on the card with the counts set to 0 just before it:
        (results, launches)."""
        cuda.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            res = app.main(app_scene + argv, device=dev)
        torch.cuda.synchronize()
        return res, {k: v for k, v in cuda.LAUNCHES.items() if v}

    def same_file(a, b):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            return fa.read() == fb.read()

    with tempfile.TemporaryDirectory() as tmp8:
        # 8a: 16 Cornell frames (the megakernel path), profiled, with the
        # SampleTest tasks; the kernels are built, so load_time is the bake
        # and the first frame
        res_a, launches_a = run_app([
            "--frames", "16", "--ssframes", "8", "--profile", "--loadtime",
            "--perfframes", "2:15", "--memframes", "1:15", "--outputdir", f"{tmp8}/a",
            "--checkpoint", f"{tmp8}/a/state"])
        if launches_a != {"frame": 16, "compact": 16, "splat_tile": 16}:
            raise AssertionError(f"the app's 16 Cornell frames launched {launches_a}")
        out_a = read_png(res_a["output"])
        if not (out_a.shape == (HEIGHT, WIDTH, 3) and 0.0 < out_a.mean() < 1.0
                and len(res_a["screenshots"]) == 1):
            raise AssertionError("the app's Cornell image or screenshot is off")
        # the same 16 frames through Renderer, driven directly
        direct = Renderer(Scene.from_built(cornell_box()).bake(max_lights=16, device=dev),
                          RenderConfig(width=WIDTH, height=HEIGHT))
        direct.render(16)
        write_png(f"{tmp8}/direct.png", direct.display())
        with np.load(f"{tmp8}/a/state.npz") as z:
            accum_a = z["accum_last"]
        if not (np.array_equal(accum_a.view(np.int32),
                               direct.state.accum.last_frame.cpu().numpy().view(np.int32))
                and same_file(res_a["output"], f"{tmp8}/direct.png")):
            raise AssertionError("the app's accumulator or PNG differs from Renderer's")
        p8["8a app"] = {
            "frames": 16, "launches": launches_a, "sec_per_frame": res_a["sec_per_frame"],
            "load_time_s": res_a["load_time"], "frame_times_s": res_a["frame_times"],
            "perf_ranges": res_a["perf_ranges"], "memory_ranges": res_a["memory_ranges"],
            "profile_ms": res_a["profile"], "equals_renderer": True}
        log(f"8a app.main cornell {WIDTH}x{HEIGHT}, 16 frames, --profile: sec_per_frame "
            f"{res_a['sec_per_frame']:.6f} s (host clock with a sync, render_frame_profiled), "
            f"load_time {res_a['load_time']:.3f} s (warm kernel cache), launches {launches_a}; "
            f"profile {json.dumps(res_a['profile'])}; accumulator and PNG equal Renderer's")

        # 8b: 8 frames and a checkpoint, then a new process's worth of state
        # (a new Renderer) resumed up to 16 frames: 8a's accumulator and PNG
        run_app(["--frames", "8", "--checkpoint", f"{tmp8}/b/state",
                 "--outputdir", f"{tmp8}/b"])
        res_b, launches_b = run_app(["--frames", "16", "--checkpoint", f"{tmp8}/b/state",
                                     "--resume", "--outputdir", f"{tmp8}/b"])
        with np.load(f"{tmp8}/b/state.npz") as z:
            accum_b = z["accum_last"]
        resumed = (np.array_equal(accum_a.view(np.int32), accum_b.view(np.int32))
                   and same_file(res_a["output"], res_b["output"]))
        if not (resumed and len(res_b["frame_times"]) == 8
                and launches_b == {"frame": 8, "compact": 8, "splat_tile": 8}):
            raise AssertionError("the resumed run differs from the unbroken one")
        p8["8b resume"] = {"frames": "8 + 8 resumed", "launches_resumed": launches_b,
                           "bit_equal_to_8a": resumed, "sec_per_frame": res_b["sec_per_frame"]}
        log(f"8b checkpoint after 8 frames, resumed to 16: accumulator and PNG bit-equal to "
            f"8a's unbroken run; launches of the resumed run {launches_b}")

        # 8d: --probe with a seeded 1024x512 lat-long PNG (the env map sends
        # Cornell to the wavefront)
        env = latlong_probe(512, 1024, seed=8)
        env_png = f"{tmp8}/env.png"
        write_png(env_png, env)
        if not np.array_equal(read_png(env_png), to_u8(env).astype(np.float32) / 255.0):
            raise AssertionError("the env map PNG does not read back")
        res_d, launches_d = run_app(["--frames", "6", "--envmap", env_png, "--probe",
                                     "--outputdir", f"{tmp8}/d"])
        # 6 wavefront frames (6 shaded, 3 any-hit, 1 K2, 1 K3 each; the app's
        # sec_per_frame is the mean of the last 5), then probe_lit_pass's one
        # shadow batch a light
        want_d = {"shaded": 36, "occluded": 19, "compact": 6, "splat_tile": 6}
        lit = read_png(res_d["probe_lit"])
        if launches_d != want_d or not (lit.shape == (HEIGHT, WIDTH, 3) and lit.mean() > 0):
            raise AssertionError(f"the --probe route launched {launches_d} or its image is off")
        p8["8d probe"] = {"env": "1024x512 lat-long PNG", "frames": 6, "launches": launches_d,
                          "sec_per_frame": res_d["sec_per_frame"],
                          "probe_lit_mean": float(lit.mean())}
        log(f"8d --envmap (1024x512 PNG) --probe: sec_per_frame {res_d['sec_per_frame']:.6f} s, "
            f"launches {launches_d}, probe_lit.png mean {lit.mean():.4f}")

    # 8c: the output passes at 1280x720 on the G-buffer of frame 0, against a
    # plain=True bake: the whole image bit for bit on Cornell (dense tier); on
    # pink_room (BVH tier) every batch the pass hands the kernels is held on
    # every 4th lane against the plain version, bit for bit
    def checked(kernel_isect, plain_isect, step, tally):
        def lanes(x, width=1):
            return x if not isinstance(x, torch.Tensor) or x.dim() == 0 else pick(x, step, width)

        def intersect(o, d, t_min, t_max=None, closest=True, cull_backface=False, **kw):
            hit = kernel_isect(o, d, t_min, t_max, closest, cull_backface)
            ref = plain_isect(lanes(o, 3), lanes(d, 3), lanes(t_min), lanes(t_max), closest,
                              cull_backface)
            tally.append(all(torch.equal(bits(pick(getattr(hit, f), step, 1)),
                                         bits(getattr(ref, f)))
                             for f in ("t", "tri", "bary_u", "bary_v")))
            return hit
        return intersect

    p8_calls = {}  # profiled after every timing, with phase 6's frames

    def extras_run(bk, label, step):
        ch = ray_traced_gbuffer(bk, make_shaded_tracer(bk), WIDTH, HEIGHT, GBUF_FRAME_INIT,
                                jitter)
        plain_isect = replace(bk, plain=True).intersector()
        count = int(bk.data.lights.count)
        occ, clo = (("occluded", "closest") if bk.n_tris <= isect.MAX_DENSE_TRIS
                    else ("bvh_occluded", "bvh_closest"))
        out = {}
        for name, fn, kw, want in (
                ("ao", extras.ambient_occlusion_pass, {"num_rays": 32}, {occ: 32}),
                ("lambertian_shadows", extras.lambertian_shadows_pass, {}, {occ: count}),
                ("diffuse_gi", extras.diffuse_gi_pass, {}, {occ: 2, clo: 1})):
            call = partial(fn, bk, bk.intersector(), ch, 7, **kw)
            cuda.reset_launch_counts()
            img = call()
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
            ms = time_ms(call, 5)
            if step == 1:
                same = torch.equal(bits(img), bits(fn(bk, plain_isect, ch, 7, **kw)))
                held = "the whole image against the plain chain"
            else:
                tally = []
                again = fn(bk, checked(bk.intersector(), plain_isect, step, tally), ch, 7, **kw)
                same = bool(tally) and all(tally) and torch.equal(bits(again), bits(img))
                held = f"{len(tally)} batches on every {step}th lane against the plain version"
            finite = bool(torch.isfinite(img).all())
            if launches != want or not same or not finite or img.shape != (HEIGHT, WIDTH, 4):
                raise AssertionError(f"8c {name} on {label}: launches {launches} (want {want}), "
                                     f"bit-equal {same}, finite {finite}")
            out[name] = {"ms": ms, "launches_per_call": launches, "bit_equal": same,
                         "held": held, "mean": float(img[..., :3].mean())}
            p8_calls[(label, name)] = (out[name], call)
            log(f"8c {name} on {label} ({bk.n_tris} tris) {WIDTH}x{HEIGHT}: {ms:.4f} ms a call "
                f"(CUDA events), launches a call {launches}; bit-equal ({held})")
        return out

    p8["8c passes"] = {"cornell (dense)": extras_run(scene("cornell", WIDTH, HEIGHT),
                                                     "Cornell", 1),
                       "pink_room (BVH)": extras_run(pink_main, "pink_room", 4)}

    # ---- phase 9: scene I/O and animation ------------------------------------
    # before phase 5e's profiler, as phases 6 and 8; every file the phase
    # reads is written by the port's own writers into a temporary folder
    from fyp_bidirectionalpathtracer_tpu_torch.models.fbx import save_fbx
    from fyp_bidirectionalpathtracer_tpu_torch.models.obj import save_obj
    from fyp_bidirectionalpathtracer_tpu_torch.passes.bdpt import bdpt_pass
    from fyp_bidirectionalpathtracer_tpu_torch.scene.fscene import load_fscene

    p9 = {"device": smi, "size": f"{WIDTH}x{HEIGHT}"}
    t9 = time.perf_counter()
    dt9 = 1.0 / 60.0
    cfg9 = RenderConfig(width=WIDTH, height=HEIGHT)
    mk_want = {"frame": 1, "compact": 1, "splat_tile": 1}

    def state_of(prefix):
        with np.load(prefix + ".npz") as z:
            accum = z["accum_last"]
        with open(prefix + ".json") as fh:
            return accum, json.load(fh)

    def lanes(x, step, width=1):
        return x if not isinstance(x, torch.Tensor) or x.dim() == 0 else pick(x, step, width)

    def checked_trace(kernel_trace, plain_trace, step, tally):
        """The frame's tracer, its hits held on every step-th lane against
        the plain version's, bit for bit (`tally`)."""
        def trace(o, d, t_min, view, cull_backface=False, coherent=True, lean=False):
            hit, sd = kernel_trace(o, d, t_min, view, cull_backface, coherent, lean)
            v = (lanes(view, step, 3)
                 if isinstance(view, torch.Tensor) and view.shape == o.shape else view)
            ref, _ = plain_trace(lanes(o, step, 3), lanes(d, step, 3), lanes(t_min, step), v,
                                 cull_backface, coherent, lean)
            tally.append(all(torch.equal(bits(pick(getattr(hit, f), step, 1)),
                                         bits(getattr(ref, f)))
                             for f in ("t", "tri", "bary_u", "bary_v")))
            return hit, sd
        return trace

    with tempfile.TemporaryDirectory() as tmp9:
        # 9a: an animated Cornell .fscene (its model file missing: the
        # cornell_box() stand-in) through app.main, 16 frames, the camera
        # path moving every frame; against Renderer + animate over the same
        # file, and resumed from a checkpoint at frame 8
        f9a = write_json(f"{tmp9}/cornell.fscene", cornell_fscene_doc("cornell_box.fbx", True))
        anim = ["--scene", f9a, "--animate"]
        res_a, launches_a = run_app(anim + ["--frames", "16", "--outputdir", f"{tmp9}/a",
                                            "--checkpoint", f"{tmp9}/a/state"])
        if launches_a != {k: 16 * v for k, v in mk_want.items()}:
            raise AssertionError(f"9a: the animated Cornell frames launched {launches_a}")
        direct = Renderer(load_fscene(f9a).bake(max_lights=16, device=dev), cfg9)
        poses = []
        for _ in range(16):
            direct.animate(dt9)
            poses.append(direct.camera.pos_w.clone())
            direct.render_frame()
        write_png(f"{tmp9}/a_direct.png", direct.display())
        accum_a, meta_a = state_of(f"{tmp9}/a/state")
        equal_a = (np.array_equal(accum_a.view(np.int32),
                                  direct.state.accum.last_frame.cpu().numpy().view(np.int32))
                   and same_file(res_a["output"], f"{tmp9}/a_direct.png")
                   and meta_a["time"] == direct.state.time)
        moved = all(not torch.equal(a, b) for a, b in zip(poses, poses[1:]))
        if not (equal_a and moved and int(direct.state.accum.count) == 1):
            raise AssertionError("9a: the app's animated frames differ from Renderer's, or the "
                                 "camera did not move every frame")
        run_app(anim + ["--frames", "8", "--checkpoint", f"{tmp9}/b/state",
                        "--outputdir", f"{tmp9}/b"])
        res_b, launches_b = run_app(anim + ["--frames", "16", "--checkpoint", f"{tmp9}/b/state",
                                            "--resume", "--outputdir", f"{tmp9}/b"])
        accum_b, meta_b = state_of(f"{tmp9}/b/state")
        resumed = (np.array_equal(accum_a.view(np.int32), accum_b.view(np.int32))
                   and same_file(res_a["output"], res_b["output"]) and meta_a == meta_b)
        if not (resumed and launches_b == {k: 8 * v for k, v in mk_want.items()}):
            raise AssertionError(f"9a: the resumed animated run differs from the unbroken one "
                                 f"(launches {launches_b})")
        p9["9a animated cornell"] = {
            "frames": 16, "launches": launches_a, "sec_per_frame": res_a["sec_per_frame"],
            "frame_times_s": res_a["frame_times"], "time": meta_a["time"],
            "equals_renderer": True, "resumed_at_8_bit_equal": True,
            "launches_resumed": launches_b}
        log(f"9a app.main animated Cornell .fscene {WIDTH}x{HEIGHT}, 16 frames: sec_per_frame "
            f"{res_a['sec_per_frame']:.6f} s (host clock with a sync), launches {launches_a}; "
            f"accumulator and PNG equal Renderer + animate; resumed at 8 bit-equal, time "
            f"{meta_a['time']}")

        # 9b: the animated flagship: pink_room's stand-in with a ball on an
        # object path and a lamp on a light path, a re-bake every frame
        room_ref = pink_room(asset_dir="")
        save_obj(f"{tmp9}/ball.obj", [icosphere((0.0, 0.0, 0.0), 1.0, 0, subdivisions=2)],
                 [procedural.MaterialDesc("ball", base_color=(0.9, 0.3, 0.2, 1.0),
                                          specular=(0.3, 0.3, 0.3, 0.8))])
        f9b = write_json(f"{tmp9}/pink_room.fscene", pink_fscene_doc(room_ref))
        t_load = time.perf_counter()
        r9 = Renderer(load_fscene(f9b).bake(max_lights=16, device=dev), cfg9)
        load_ms = (time.perf_counter() - t_load) * 1e3
        host9 = r9.baked.host
        is_ball = torch.from_numpy(np.concatenate(
            [np.full(len(m.positions), m.name == "ball") for m in host9.meshes]))
        lamp_row = [light.get("name") for light in host9.lights].index("lamp2")
        n_b = 8
        rebake_ms, frame_ms, geoms, light_tabs, kept = [], [], [], [], {}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        cuda.reset_launch_counts()
        for i in range(n_b):
            torch.cuda.synchronize()
            t_re = time.perf_counter()
            r9.animate(dt9)
            torch.cuda.synchronize()
            rebake_ms.append((time.perf_counter() - t_re) * 1e3)
            scene_i, index_i = r9.baked.with_camera(r9.camera), r9.state.frame_index
            start.record()
            r9.render_frame()
            end.record()
            torch.cuda.synchronize()
            frame_ms.append(start.elapsed_time(end))
            geoms.append(r9.baked.data.geometry.positions.clone())
            light_tabs.append(r9.baked.light_rows.cpu())
            if i in (0, n_b - 1):
                kept[i] = (scene_i, index_i, r9.channels["BDPT"].clone())
        launches_9b = {k: v for k, v in cuda.LAUNCHES.items() if v}
        want_9b = {"bvh_shaded": 6 * n_b, "bvh_occluded": 3 * n_b, "compact": n_b,
                   "splat_tile": n_b}
        lamp_mask = torch.arange(light_tabs[0].shape[0]) == lamp_row
        motion = all(not torch.equal(a[is_ball], b[is_ball]) and torch.equal(a[~is_ball],
                                                                             b[~is_ball])
                     and not torch.equal(la[lamp_mask], lb[lamp_mask])
                     and torch.equal(la[~lamp_mask], lb[~lamp_mask])
                     for a, b, la, lb in zip(geoms, geoms[1:], light_tabs, light_tabs[1:]))
        out9 = r9.channels["PipelineOutput"]
        if not (launches_9b == want_9b and motion and bool(torch.isfinite(out9).all())
                and r9.baked.n_tris > isect.MAX_DENSE_TRIS):
            raise AssertionError(f"9b: launches {launches_9b} (want {want_9b}), the ball and "
                                 f"lamp2 alone moving every frame {motion}")
        # the BVH kernels on every 4th lane of every batch of the first and
        # the last frame, against their plain versions, bit for bit; the
        # checked frame is the rendered one, bit for bit
        held = {}
        for i, (scene_i, index_i, bdpt_i) in kept.items():
            tally = []
            plain_i = replace(scene_i, plain=True)
            mean = cfg9.bdpt.bounce_tex_mean
            trace = checked_trace(make_shaded_tracer(scene_i, bounce_tex_mean=mean),
                                  make_shaded_tracer(plain_i, bounce_tex_mean=mean), 4, tally)
            intersect = checked(scene_i.intersector(), plain_i.intersector(), 4, tally)
            bdpt_frame = (BDPT_FRAME_INIT + index_i) & 0xFFFFFFFF
            jit = pixel_jitter_for_frame(bdpt_frame, cfg9.gbuffer.jitter_mode)
            ch = ray_traced_gbuffer(scene_i, trace, WIDTH, HEIGHT,
                                    (GBUF_FRAME_INIT + index_i) & 0xFFFFFFFF, jit,
                                    focal_len=cfg9.gbuffer.focal_length_gui,
                                    env_bilinear=cfg9.gbuffer.env_bilinear)
            img = bdpt_pass(scene_i, intersect, ch, bdpt_frame, jit, cfg9.bdpt, trace=trace)
            torch.cuda.synchronize()
            same = torch.equal(bits(img), bits(bdpt_i))
            if not (tally and all(tally) and same):
                raise AssertionError(f"9b frame {i}: a BVH kernel differs from its plain "
                                     f"version ({tally}) or the checked frame from the "
                                     f"rendered one ({same})")
            held[f"frame {i}"] = {"batches": len(tally), "bit_equal": True}
        p9["9b animated pink_room"] = {
            "tris": r9.baked.n_tris, "frames": n_b, "launches": launches_9b,
            "load_and_bake_ms": load_ms, "rebake_host_ms": rebake_ms,
            "frame_ms": frame_ms, "rebake_share": sum(rebake_ms) / (sum(rebake_ms)
                                                                    + sum(frame_ms)),
            "bvh_kernels_vs_plain_every_4th_lane": held, "ball_and_lamp_alone_move": True}
        log(f"9b animated pink_room .fscene ({r9.baked.n_tris} tris) {WIDTH}x{HEIGHT}, {n_b} "
            f"frames: re-bake (host clock with a sync) ms {[round(x, 2) for x in rebake_ms]}, "
            f"frame (CUDA events) ms {[round(x, 3) for x in frame_ms]}, re-bake share "
            f"{p9['9b animated pink_room']['rebake_share']:.3f}; launches {launches_9b}; the ball "
            f"and lamp2 alone move every frame; BVH kernels bit-equal to the plain versions on "
            f"every 4th lane of {held}")
        del r9, kept, scene_i, plain_i, geoms

        # 9c: OBJ + MTL, the alpha panel room with an RGBA PNG cutout map_Kd
        # and a PNG map_bump, through --scene x.obj: the wavefront's alpha
        # restarts on the dense kernels
        panel = procedural.alpha_panel_scene()
        save_obj(f"{tmp9}/panel.obj", panel.meshes, panel.materials)
        write_png_rgba(f"{tmp9}/cutout.png", panel.materials[1].base_color_image)
        tilt = np.zeros((8, 8, 3), np.float32)
        tilt[..., 0], tilt[..., 1], tilt[..., 2] = 0.75, 0.5, 1.0
        write_png(f"{tmp9}/bump.png", tilt)
        mtl = open(f"{tmp9}/panel.mtl").read()
        mtl = mtl.replace("newmtl panel\n", "newmtl panel\nmap_Kd cutout.png\n")
        mtl = mtl.replace("newmtl white\n", "newmtl white\nmap_bump bump.png\n")
        open(f"{tmp9}/panel.mtl", "w").write(mtl)
        res_c, launches_c = run_app(["--scene", f"{tmp9}/panel.obj", "--frames", "2",
                                     "--outputdir", f"{tmp9}/c"])
        bk9c = app.load_scene(f"{tmp9}/panel.obj").bake(max_lights=16, device=dev)
        out_c = read_png(res_c["output"])
        if not (bk9c.has_alpha and bk9c.has_normal_maps and set(launches_c) <= {
                "shaded", "closest", "occluded", "compact", "splat_tile"}
                and launches_c.get("shaded", 0) > 0 and launches_c.get("closest", 0) > 0
                and out_c.shape == (HEIGHT, WIDTH, 3)):
            raise AssertionError(f"9c: the OBJ scene's bake or launches are off ({launches_c})")
        restarts_c = alpha_restarts(bk9c, "9c OBJ panel", 1)
        p9["9c obj alpha + normal map"] = {
            "tris": bk9c.n_tris, "frames": 2, "launches": launches_c,
            "sec_per_frame": res_c["sec_per_frame"], "frame_times_s": res_c["frame_times"],
            "alpha_restarts": restarts_c}
        log(f"9c app.main --scene panel.obj (RGBA cutout map_Kd, map_bump) {WIDTH}x{HEIGHT}, 2 "
            f"frames: sec_per_frame {res_c['sec_per_frame']:.6f} s (host clock with a sync), "
            f"launches {launches_c}; the dense kernels bit-equal under the alpha restarts")
        del bk9c

        # 9d: Cornell's geometry through save_fbx and an .fscene, 1 frame,
        # exported with --export-scene and rendered again; each frame against
        # the built-in Cornell box's: bit for bit where the baked rows are
        # bit-equal, else within the same-path bounds (image_stats's
        # defaults): save_obj's 6 decimals move a vertex by up to 5e-7,
        # which can flip a hit at an edge
        src = Renderer(Scene.from_built(cornell_box()).bake(max_lights=16, device=dev), cfg9)
        src.render_frame()
        src_accum = src.state.accum.last_frame
        cb = cornell_box()
        save_fbx(f"{tmp9}/cornell.fbx", cb.meshes, cb.materials, version=7500)
        f9d = write_json(f"{tmp9}/cornell_fbx.fscene", cornell_fscene_doc("cornell.fbx", False))
        exported = f"{tmp9}/export/cornell.fscene"
        runs_d = {}
        for label, argv in (("fbx", ["--scene", f9d, "--export-scene", exported]),
                            ("exported", ["--scene", exported])):
            res, launches = run_app(argv + ["--frames", "1", "--outputdir", f"{tmp9}/d_{label}",
                                            "--checkpoint", f"{tmp9}/d_{label}/state"])
            bk = app.load_scene(argv[1]).bake(max_lights=16, device=dev)
            # the pack's rows but their last column, the material id: the
            # loaders put a default material first, so the ids shift by one
            # and index equal constants (the rows carry the constants)
            rows_equal = (bk.tri_pack.shape == src.baked.tri_pack.shape
                          and torch.equal(bits(bk.tri_pack[:, :PACK_ID_COL]),
                                          bits(src.baked.tri_pack[:, :PACK_ID_COL]))
                          and torch.equal(bits(bk.light_rows), bits(src.baked.light_rows)))
            accum, _ = state_of(f"{tmp9}/d_{label}/state")
            accum = torch.from_numpy(accum).to(dev)
            identical = bool(torch.equal(bits(accum), bits(src_accum)))
            frac, mad, dmean, close = image_stats(accum, src_accum)
            runs_d[label] = {"launches": launches, "tris": bk.n_tris, "rows_bit_equal": rows_equal,
                             "frame_bit_equal": identical, "frac_over_1e-3": frac,
                             "mean_abs_d": mad, "mean_radiance_d": dmean}
            if launches != mk_want or (rows_equal and not identical) or not close:
                raise AssertionError(f"9d {label}: {runs_d[label]}")
            log(f"9d {label} Cornell {WIDTH}x{HEIGHT}, 1 frame: launches {launches}; baked rows "
                f"(but the material id) bit-equal to the built-in Cornell box's {rows_equal}, "
                f"frame bit-equal "
                f"{identical} (frac>1e-3 {frac:.4f} <= 0.02, mean|d| {mad:.2e} < 5e-3, mean "
                f"radiance d {dmean:.2e} < 2e-3)")
            del bk
        p9["9d fbx and export"] = runs_d
        del src
    p9["phase_s"] = time.perf_counter() - t9
    log(f"phase 9: {p9['phase_s']:.1f} s")

    # ---- phase 10: row sharding (parallel/sharding.py) -----------------------
    # before phase 5e's profiler, as phases 6, 8 and 9.  10a: K1 over 2 and 4
    # row shards (pix0, n_sub) against the whole-image launch, bit for bit,
    # both variants, one process.  10b / 10c: 2 ranks on this card (gloo:
    # NCCL refuses two ranks on one device) through Renderer(mesh=) on the
    # megakernel, wavefront and BMFR-on routes against the single-device
    # frames.  10d: app.main --shard 2 and a resume.  The two ranks share
    # the card, so their times measure the collectives' overhead, not
    # scaling.
    from fyp_bidirectionalpathtracer_tpu_torch.parallel import sharding

    p10 = {"device": smi, "size": f"{WIDTH}x{HEIGHT}", "ranks": 2,
           "note": "both ranks share one card; times show overhead, not scaling"}
    t10 = time.perf_counter()
    k1_shards = {}
    for label, bk, cfg10, packed in (
            ("Cornell", cornell, cfg_for(WIDTH, HEIGHT), True),
            ("textured room (deferred)", tex_main,
             cfg_for(WIDTH, HEIGHT, defer_textures=True), False)):
        args = frame_mod.frame_args(bk, WIDTH, HEIGHT, BDPT_FRAME_INIT, jitter, cfg10,
                                    gbuf_frame=GBUF_FRAME_INIT, splat_rgb8e=packed)
        whole = frame_mod.frame_kernel(args, bk.light_rows, bk.tri_pack, bk.bvh_nodes)
        for n in (2, 4):
            sub = HEIGHT // n * WIDTH
            parts = [frame_mod.frame_kernel(replace(args, pix0=r * sub, sub_pixels=sub),
                                            bk.light_rows, bk.tri_pack, bk.bvh_nodes)
                     for r in range(n)]
            torch.cuda.synchronize()
            same = {k: torch.equal(bits(torch.cat([getattr(q, k) for q in parts], -1)), bits(v))
                    for k, v in vars(whole).items() if v is not None}
            k1_shards[f"{label}, {n} shards"] = same
            if not all(same.values()):
                raise AssertionError(f"10a K1 over {n} shards of {label} differs: {same}")
            log(f"10a K1 {label} {WIDTH}x{HEIGHT} over {n} row shards (pix0, n_sub): every "
                f"column bit-equal to the whole-image launch {sorted(same)}")
        del whole, parts
    p10["10a K1 shards bit-equal"] = k1_shards

    # 10b / 10c: the single-device references, then the ranks
    refs = {}
    for run in P10_RUNS:
        frames = p10_frames(run, p10_renderer(run, dev))
        refs[run[0]] = [({k: ch[k] for k in P10_GBUF + ("PipelineOutput",)}, ms, host)
                        for ch, ms, host in frames]
        del frames
    t_launch = time.perf_counter()
    ranks10 = sharding.launch(p10_rank, 2, device=dev)
    launch_s = time.perf_counter() - t_launch
    p10["launch"] = {"backend": ranks10[0]["backend"],
                     "rank_devices": [r["device"] for r in ranks10], "wall_s": launch_s}
    log(f"10b/10c launch of 2 ranks on {[r['device'] for r in ranks10]} over "
        f"{ranks10[0]['backend']}: {launch_s:.1f} s wall (spawn, bakes, every run)")
    want_launches = {
        "10b megakernel Cornell": {"frame": 1, "compact": 1, "splat_tile": 1},
        "10b megakernel textured room (deferred)": {"frame_textured": 1, "compact": 1,
                                                    "splat_tile": 1},
        "10c wavefront Cornell": {"shaded": 1 + (DEPTH - 1) + DEPTH, "occluded": 3,
                                  "compact": 1, "splat_tile": 1},
        "10c wavefront pink_room": {"bvh_shaded": 1 + (DEPTH - 1) + DEPTH, "bvh_occluded": 3,
                                    "compact": 1, "splat_tile": 1},
        "10c BMFR on Cornell (camera moved)": {"frame": 1, "compact": 1, "splat_tile": 1,
                                               "bmfr_fit": 1},
    }
    p10["runs"] = {}
    for run in P10_RUNS:
        label, n_fr = run[0], run[4]
        per_rank = [r["runs"][label] for r in ranks10]
        gbuf_equal, out_err = True, 0.0
        for f, (ref_ch, _, _) in enumerate(refs[label]):
            for rank_run in per_rank:
                row0, sub_h = rank_run["rows"]
                gbuf_equal &= all(rank_run["gbuf"][f][k] == p10_digest(ref_ch[k][row0:row0 + sub_h])
                                  for k in P10_GBUF)
                got = rank_run["output"][f].to(dev)
                out_err = max(out_err, float((got - ref_ch["PipelineOutput"][
                    row0:row0 + sub_h]).abs().max()))
        launches = [rank_run["launches"] for rank_run in per_rank]
        want = {k: v * n_fr for k, v in want_launches[label].items()}
        counts = [rank_run["count"] for rank_run in per_rank]
        ref_ms = [ms for _, ms, _ in refs[label]][1:]
        ref_host = [h for _, _, h in refs[label]][1:]
        rec = {"frames": n_fr, "launches_per_rank": launches, "gbuffer_bit_equal": gbuf_equal,
               "pipeline_output_max_abs_err": out_err, "accum_counts": counts,
               "rank0_ms_per_frame": sum(per_rank[0]["ms"][1:]) / (n_fr - 1),
               "rank0_host_ms_per_frame": sum(per_rank[0]["host_ms"][1:]) / (n_fr - 1),
               "rank1_ms_per_frame": sum(per_rank[1]["ms"][1:]) / (n_fr - 1),
               "single_device_ms_per_frame": sum(ref_ms) / len(ref_ms),
               "single_device_host_ms_per_frame": sum(ref_host) / len(ref_host),
               "timed": "CUDA events and the host clock around each frame after the first, "
                        "with a sync"}
        p10["runs"][label] = rec
        ok = (gbuf_equal and out_err <= 2e-5 and all(x == want for x in launches)
              and all(rank_run["finite"] for rank_run in per_rank)
              and len(set(counts)) == 1)
        log(f"{label} {WIDTH}x{HEIGHT}, {n_fr} frames on 2 ranks: G-buffer bit-equal "
            f"{gbuf_equal}, PipelineOutput max |d| {out_err:.3e} (<= 2e-5), launches a rank "
            f"{launches[0]} (want {want}), accum counts {counts}; ms/frame rank 0 "
            f"{rec['rank0_ms_per_frame']:.4f} (CUDA events; host {rec['rank0_host_ms_per_frame']:.4f})"
            f", rank 1 {rec['rank1_ms_per_frame']:.4f}, single device "
            f"{rec['single_device_ms_per_frame']:.4f} (host "
            f"{rec['single_device_host_ms_per_frame']:.4f})")
        if not ok:
            raise AssertionError(f"{label}: the sharded frames differ from the single-device "
                                 f"ones or launched the wrong kernels: {rec}")
    ar = ranks10[0]["all_reduce"]
    p10["splat all-reduce"] = {**ar, "rank1_ms": ranks10[1]["all_reduce"]["ms"],
                               "what": f"f32 rgba {WIDTH}x{HEIGHT} summed over 2 ranks, gloo, "
                                       f"{P10_ALL_REDUCES} calls"}
    log(f"10b splat all-reduce: {ar['bytes']} bytes (f32 rgba {WIDTH}x{HEIGHT}), "
        f"{ar['ms']:.4f} ms a call on rank 0 (CUDA events; host {ar['host_ms']:.4f} ms), "
        f"gloo on one shared card")
    del refs, ranks10

    # 10d: app.main --shard 2 (rank 0 writes), 4 frames and a checkpoint,
    # resumed to 8; the accumulator against 8 single-device frames
    with tempfile.TemporaryDirectory() as tmp10:
        t_app = time.perf_counter()
        res_a, _ = run_app(["--shard", "2", "--frames", "4", "--checkpoint", f"{tmp10}/state",
                            "--outputdir", f"{tmp10}/a"])
        app_a_s = time.perf_counter() - t_app
        res_b, _ = run_app(["--shard", "2", "--frames", "8", "--checkpoint", f"{tmp10}/state",
                            "--resume", "--outputdir", f"{tmp10}/b"])
        png = read_png(res_b["output"])
        direct = Renderer(Scene.from_built(cornell_box()).bake(max_lights=16, device=dev),
                          RenderConfig(width=WIDTH, height=HEIGHT))
        direct.render(8)
        with np.load(f"{tmp10}/state.npz") as z:
            accum10, count10 = z["accum_last"], int(z["accum_count"])
        err10 = float(np.abs(accum10 - direct.state.accum.last_frame.cpu().numpy()).max())
        bit10 = bool(np.array_equal(accum10.view(np.int32),
                                    direct.state.accum.last_frame.cpu().numpy().view(np.int32)))
        if not (png.shape == (HEIGHT, WIDTH, 3) and 0.0 < png.mean() < 1.0 and count10 == 8
                and len(res_b["frame_times"]) == 4 and err10 <= 2e-5
                and os.path.exists(res_a["output"])):
            raise AssertionError(f"10d app --shard 2: png {png.shape}, count {count10}, "
                                 f"accumulator max |d| {err10}")
        p10["10d app --shard 2"] = {
            "frames": "4 + 4 resumed", "sec_per_frame_first": res_a["sec_per_frame"],
            "sec_per_frame_resumed": res_b["sec_per_frame"], "first_run_wall_s": app_a_s,
            "accum_max_abs_err_vs_single_device": err10, "accum_bit_equal": bit10,
            "png_mean": float(png.mean())}
        log(f"10d app.main --shard 2 Cornell {WIDTH}x{HEIGHT}: 4 frames + checkpoint "
            f"({app_a_s:.1f} s wall, spawn included), resumed to 8 (sec_per_frame "
            f"{res_b['sec_per_frame']:.6f} s, host clock, rank 0): PNG written (mean "
            f"{png.mean():.4f}), accumulator max |d| {err10:.3e} against 8 single-device "
            f"frames (bit-equal {bit10})")
        del direct
    p10["phase_s"] = time.perf_counter() - t10
    log(f"phase 10: {p10['phase_s']:.1f} s")

    # ---- phase 11: JAX's frame options ---------------------------------------
    # before phase 5e's profiler, as phases 6, 8, 9 and 10.  11a: pink_room's
    # wavefront with the direction sort on (the default) and off, frames bit
    # for bit; each BVH kernel with and without a ray `order` on pink_room's
    # G-buffer, extension and shadow batches, against its bound.  11b:
    # Cornell (dense tier) and pink_room (BVH tier) under reverse_shadows,
    # merge_shadow_batches (bit-equal) and each timing stub, beside the full
    # frame, in turns.  11c: every splat mode on one wavefront frame's estimator-2
    # updates against 'direct', K5 with segments=3 against the flat sort,
    # and a frame with splat_segments against one without, bit for bit.
    t11 = time.perf_counter()
    p11 = {}

    def frames11(baked, n, megakernel="auto", **bdpt_kw):
        """One frame, then n timed frames through Renderer at 1280x720,
        counts from 0: (the first frame's channels, the last's, ms a frame
        by CUDA events, by the host clock, the launches with the variants,
        the frames)."""
        r = Renderer(baked, cfg_for(WIDTH, HEIGHT, megakernel, **bdpt_kw))
        cuda.reset_launch_counts()
        r.render_frame()
        first = {k: v.clone() for k, v in r.channels.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        for _ in range(n):
            r.render_frame()
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t_host) * 1e3 / n
        counts = {**cuda.LAUNCHES, **cuda.LAUNCHES_BY_VARIANT}
        if not all(bool(torch.isfinite(v).all()) for v in r.channels.values()):
            raise AssertionError(f"phase 11: a frame is not finite ({bdpt_kw})")
        return (first, dict(r.channels), start.elapsed_time(end) / n, host,
                {k: v for k, v in counts.items() if v}, n + 1)

    def same_bits(a, b):
        return all(torch.equal(bits(a[k]), bits(b[k])) for k in a)

    # 11a: the sorted frame (the defaults) against the frame with
    # sort_bounces and sort_shadows off, 3 frames each
    on = frames11(pink_main, 2)
    off = frames11(pink_main, 2, sort_bounces=False, sort_shadows=False)
    n11 = on[5]
    want_on = {"bvh_shaded": 6 * n11, "bvh_shaded[order]": 5 * n11,
               "bvh_occluded": 3 * n11, "bvh_occluded[order]": 3 * n11}
    sorted_equal = same_bits(on[0], off[0]) and same_bits(on[1], off[1])
    p11["11a pink_room sorted vs unsorted"] = {
        "frames": n11, "bit_equal": sorted_equal, "sorted_ms_per_frame": on[2],
        "sorted_host_ms_per_frame": on[3], "unsorted_ms_per_frame": off[2],
        "unsorted_host_ms_per_frame": off[3], "sorted_launches": on[4],
        "unsorted_launches": off[4]}
    log(f"11a pink_room {WIDTH}x{HEIGHT}, {n11} frames: sorted (default) {on[2]:.4f} ms/frame "
        f"(host {on[3]:.4f}), unsorted {off[2]:.4f} ms/frame (host {off[3]:.4f}); frames "
        f"bit-equal {sorted_equal}; launches sorted {on[4]}, unsorted {off[4]}")
    if not sorted_equal:
        raise AssertionError("11a: the sorted pink_room frame differs from the unsorted one")
    # est-3's batch is sorted either way, as in JAX
    want_off = {"bvh_shaded[order]": 0, "bvh_occluded[order]": n11}
    if any(on[4].get(k, 0) != v for k, v in want_on.items()) or any(
            off[4].get(k, 0) != v for k, v in want_off.items()):
        raise AssertionError(f"11a: launches {on[4]} (want {want_on}), unsorted {off[4]} "
                             f"(want {want_off})")

    # each BVH kernel's launch on packed rays with and without the order
    (o_g, d_g), (o_e, d_e), (o_s, d_s, tm_s) = k4_rays(
        pink_main, WIDTH, HEIGHT, dev,
        partial(cluster.bvh_shaded_fm, rows=pink_main.bw_rows, pairs=pink_main.bvh_pairs))
    lib, stream, p = cuda.library(), cuda.stream(dev), cuda.ptr
    bw, pairs = p(pink_main.bw_rows), p(pink_main.bvh_pairs)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    st = bvh_stats["pink_room"]
    p11a = {}
    for batch, o, d, tmin, tmax, cull in (("G-buffer", o_g, d_g, 0.0, None, 1),
                                          ("extension", o_e, d_e, MIN_T, None, 0),
                                          ("shadow", o_s, d_s, MIN_T, tm_s, 0)):
        order = sort_order(o, d, tmin, tmax, pink_main.sort_bounds)
        sort_ms = time_ms(lambda: sort_order(o, d, tmin, tmax, pink_main.sort_bounds), 10)
        rows, _ = isect.rays(o, d, tmin, tmax)
        n = rows.shape[1]
        fields = torch.empty((isect.OUT_W, n), device=dev)
        t_ = torch.empty(n, device=dev)
        id_ = torch.empty(n, dtype=torch.int32, device=dev)
        u_, v_ = torch.empty_like(t_), torch.empty_like(t_)
        occ = torch.empty(n, dtype=torch.bool, device=dev)
        runs = {
            "bvh_shaded": (lambda o_: lib.bdpt_bvh_shaded(
                p(rows), n, p(pink_main.tri_pack), bw, pairs, cull, p(fields), p(counter), o_,
                stream), lambda: fields.clone()),
            "bvh_closest": (lambda o_: lib.bdpt_bvh_closest(
                p(rows), n, bw, pairs, cull, p(t_), p(id_), p(u_), p(v_), p(counter), o_,
                stream), lambda: torch.stack([t_, id_.view(torch.float32), u_, v_])),
        } if batch != "shadow" else {
            "bvh_occluded": (lambda o_: lib.bdpt_bvh_occluded(
                p(rows), n, bw, pairs, p(occ), p(counter), o_, stream), lambda: occ.clone()),
        }
        for name, (launch, result) in runs.items():
            cuda.check_error(name, launch(None))
            plain_out = result()
            cuda.check_error(name, launch(p(order)))
            equal = bool(torch.equal(bits(plain_out), bits(result())))
            ms = time_ms(lambda: cuda.check_error(name, launch(None)), 10)
            ms_order = time_ms(lambda: cuda.check_error(name, launch(p(order))), 10)
            bd = (st[name]["extension_bound_ms"] if batch == "extension"
                  else st[name]["bound_ms"])
            p11a[f"{name} {batch}"] = {"rays": n, "ms": ms, "order_ms": ms_order,
                                       "sort_order_ms": sort_ms, "bound_ms": bd,
                                       "bit_equal": equal}
            log(f"11a {name} pink_room {batch} batch ({n} rays): {ms:.4f} ms in ray order, "
                f"{ms_order:.4f} ms in sorted order (+ sort_order {sort_ms:.4f} ms), bound "
                f"{bd:.4f} ms; answers bit-equal {equal}")
            if not equal:
                raise AssertionError(f"11a: {name} with the order differs ({batch} batch)")
    p11["11a kernels with and without order"] = p11a

    # the kernels line's [order] rows: the ordered launch on the batch the
    # main path orders (extensions; the shadow batch for the any-hit kernel);
    # the plain version with the order on every PINK_SAMPLE-th ray
    oe, de = pick(o_e, PINK_SAMPLE), pick(d_e, PINK_SAMPLE)
    os_, ds_, ts_ = pick(o_s, PINK_SAMPLE), pick(d_s, PINK_SAMPLE), pick(tm_s, PINK_SAMPLE, 1)
    ord_e = sort_order(oe, de, MIN_T, None, pink_main.sort_bounds).long()
    ord_s = sort_order(os_, ds_, MIN_T, ts_, pink_main.sort_bounds).long()
    plain11 = {
        "bvh_shaded": lambda: isect.shaded_plain(pink_main.tri_pack, pink_main.n_tris,
                                                 oe[ord_e], de[ord_e], MIN_T, None, False),
        "bvh_closest": lambda: isect.closest_plain(pink_main.bw_rows, pink_main.n_tris,
                                                   oe[ord_e], de[ord_e], MIN_T, None, False),
        "bvh_occluded": lambda: isect.occluded_plain(pink_main.bw_rows, pink_main.n_tris,
                                                     os_[ord_s], ds_[ord_s], MIN_T, ts_[ord_s]),
    }
    for name in ("bvh_shaded", "bvh_closest", "bvh_occluded"):
        rec = p11a[f"{name} {'shadow' if name == 'bvh_occluded' else 'extension'}"]
        base = bvh_stats["pink_room"][name]
        bd_key = "bound_ms" if name == "bvh_occluded" else "extension_bound_ms"
        by_key = "bound_by" if name == "bvh_occluded" else "extension_bound_by"
        kernels[f"{name}[order]"] = dict(
            max_abs_err=0.0, ms=rec["order_ms"], unordered_ms=rec["ms"],
            sort_order_ms=rec["sort_order_ms"], plain_ms=time_ms(plain11[name], 1),
            plain_rays=int(ord_e.numel() if name != "bvh_occluded" else ord_s.numel()),
            bound_ms=base[bd_key], bound_by=base.get(by_key, base["bound_by"]),
            library_ms=None, batch="shadow" if name == "bvh_occluded" else "extension")

    # 11b: the shadow options and the timing stubs on both tiers
    p11b = {}
    options = (("full frame", {}), ("reverse_shadows", dict(reverse_shadows=True)),
               ("merge_shadow_batches", dict(merge_shadow_batches=True)),
               ("debug_stub_shadows", dict(debug_stub_shadows=True)),
               ("debug_stub_extensions", dict(debug_stub_extensions=True)),
               ("both stubs", dict(debug_stub_shadows=True, debug_stub_extensions=True)))
    for label, bk, tier in (("Cornell", cornell, ""), ("pink_room", pink_main, "bvh_")):
        # the host paces these frames and drifts: every option twice, in
        # turns (the list, then the list reversed), 5 frames each time
        runs11, again = {}, {}
        for opt, kw in options:
            runs11[opt] = frames11(bk, 4, "off", **kw)
        for opt, kw in reversed(options):
            again[opt] = frames11(bk, 4, "off", **kw)[2]
        full = runs11["full frame"]
        n = full[5]
        shaded, occluded = f"{tier}shaded", f"{tier}occluded"
        want = {"full frame": (6, 3), "reverse_shadows": (6, 3), "merge_shadow_batches": (6, 1),
                "debug_stub_shadows": (6, 0), "debug_stub_extensions": (1, 3),
                "both stubs": (1, 0)}
        rec = {}
        for opt, (first, last, ms, host, launches, _) in runs11.items():
            ws, wo = want[opt]
            frac, mad, dmean, ok = image_stats(first["BDPT"], full[0]["BDPT"])
            rec[opt] = {"ms_per_frame": ms, "ms_per_frame_again": again[opt],
                        "host_ms_per_frame": host, "launches": launches,
                        "bit_equal_to_full": same_bits(first, full[0]) and same_bits(last,
                                                                                     full[1]),
                        "frac_over_1e-3": frac, "mean_abs_d": mad, "mean_radiance_d": dmean}
            log(f"11b {label} wavefront {opt}: {ms:.4f}, {again[opt]:.4f} ms/frame (host "
                f"{host:.4f}), full frame {full[2]:.4f}, {again['full frame']:.4f}; frame 0 "
                f"against the full frame: frac>1e-3 "
                f"{frac:.4f}, mean|d| {mad:.2e}, bit-equal {rec[opt]['bit_equal_to_full']}; "
                f"launches {launches}")
            if launches.get(shaded, 0) != ws * n or launches.get(occluded, 0) != wo * n:
                raise AssertionError(f"11b {label} {opt}: launches {launches}, want {ws} "
                                     f"{shaded} and {wo} {occluded} a frame")
            if opt == "merge_shadow_batches" and not rec[opt]["bit_equal_to_full"]:
                raise AssertionError(f"11b {label}: the merged shadow batch changes the frame")
            if opt == "reverse_shadows" and not ok:
                raise AssertionError(f"11b {label}: the reversed shadow rays' frame is off "
                                     f"the full frame beyond the image bounds")
        p11b[label] = rec
    p11["11b shadow options and timing stubs"] = p11b

    # 11c: the splat modes on one Cornell wavefront frame's est-2 updates
    caught = {}
    real_scatter = splat_mod.scatter_add_rgba

    def catch(mode, lin, rgb, alpha, n_targets, alpha_is_count=False, segments=1, **kw):
        caught.update(lin=lin, rgb=rgb, alpha=alpha, n=n_targets, count=alpha_is_count)
        return real_scatter(mode, lin, rgb, alpha, n_targets, alpha_is_count, segments, **kw)

    splat_mod.scatter_add_rgba = catch
    try:
        Renderer(cornell, cfg_for(WIDTH, HEIGHT, "off")).render_frame()
    finally:
        splat_mod.scatter_add_rgba = real_scatter
    lin_f, rgb_f, a_f, n_f = caught["lin"], caught["rgb"], caught["alpha"], caught["n"]
    live_f = lin_f < n_f
    # a pixel's envelope: the sum of its updates' largest channels
    env = torch.zeros(n_f, device=dev).index_add_(0, lin_f[live_f].long(),
                                                  rgb_f[live_f].amax(-1))
    count_f = torch.zeros(n_f, device=dev).index_add_(0, lin_f[live_f].long(),
                                                      torch.ones_like(a_f[live_f]))
    # 'direct' and 'complex' add with atomics in no fixed order, so a second
    # 'direct' call may differ from the first in the last bits
    direct = real_scatter("direct", lin_f, rgb_f, a_f, n_f, alpha_is_count=True)
    total = direct[:, :3].sum(0)
    tol = {"direct": 1e-5, "complex": 1e-5, "tiled": 1e-5, "sorted": None, "packed": None,
           "tiled_bf16": 2.0 ** -8, "tiled_bf16w": 2.0 ** -8, "tiled_rgb8e": 2.0 ** -8}
    p11c = {"updates": int(lin_f.numel()), "live": int(live_f.sum()), "modes": {}}
    for mode in ("direct", "sorted", "packed", "complex", "tiled", "tiled_bf16", "tiled_bf16w",
                 "tiled_rgb8e", "tiled_sortonly", "skip"):
        def run(mode=mode, segments=1):
            return real_scatter(mode, lin_f, rgb_f, a_f, n_f, alpha_is_count=True,
                                segments=segments)
        out = run()
        ms = time_ms(run, 10)
        err = (out[:, :3] - direct[:, :3]).abs()
        if mode in ("tiled_sortonly", "skip"):
            ok = not bool(out.any())
        else:
            if mode == "sorted":
                limit = total * 2.0 ** -20
            elif mode == "packed":
                limit = count_f[:, None] * 2.0 ** -19 + 1e-6
            else:
                limit = env[:, None] * tol[mode] + 1e-6
            ok = bool((err <= limit).all()) and torch.equal(out[:, 3], direct[:, 3])
        p11c["modes"][mode] = {"ms": ms, "max_abs_err": float(err.max()), "ok": ok}
        log(f"11c splat mode {mode} on the frame's {lin_f.numel()} est-2 updates "
            f"({int(live_f.sum())} live): {ms:.4f} ms, max |d| {float(err.max()):.3e} against "
            f"'direct', within its bound {ok}")
        if not ok:
            raise AssertionError(f"11c: splat mode {mode} is off 'direct' beyond its bound")
    seg_equal = {}
    for mode in ("tiled", "tiled_rgb8e"):
        flat = real_scatter(mode, lin_f, rgb_f, a_f, n_f, alpha_is_count=True)
        seg = real_scatter(mode, lin_f, rgb_f, a_f, n_f, alpha_is_count=True, segments=DEPTH)
        seg_equal[mode] = bool(torch.equal(bits(flat), bits(seg)))
        p11c["modes"][mode]["segments_ms"] = time_ms(
            lambda: real_scatter(mode, lin_f, rgb_f, a_f, n_f, alpha_is_count=True,
                                 segments=DEPTH), 10)
    log(f"11c segments={DEPTH} against the flat sort, bit-equal: {seg_equal}")
    if not all(seg_equal.values()):
        raise AssertionError(f"11c: a segmented splat differs from the flat one {seg_equal}")
    p11c["segments_bit_equal"] = seg_equal

    # K5 alone with segments on the frame's rows: each depth's updates sorted
    # on their own, against K5 on the flat sort of the same updates
    sent_f = splat_tile.sentinel(n_f)
    keys_f = torch.where(lin_f < 0, sent_f, torch.clamp(lin_f, max=sent_f)).to(torch.int32)
    ks_seg, ord_seg = torch.sort(keys_f.reshape(DEPTH, -1), dim=1, stable=True)
    ord_seg = (ord_seg + torch.arange(DEPTH, device=dev)[:, None] * (keys_f.numel() // DEPTH))
    ks_seg, ord_seg = ks_seg.reshape(-1).contiguous(), ord_seg.reshape(-1)
    vals_seg = rgb_f.T[:, ord_seg].contiguous()
    ks_flat, ord_flat = torch.sort(keys_f, stable=True)
    vals_flat = rgb_f.T[:, ord_flat].contiguous()
    k5s = splat_tile.splat_reduce_rows(ks_seg, vals_seg, n_f, DEPTH)
    k5f = splat_tile.splat_reduce_rows(ks_flat, vals_flat, n_f)
    k5p = splat_tile.reduce_rows_plain(ks_seg, vals_seg, n_f, DEPTH)
    torch.cuda.synchronize()
    k5_equal = bool(torch.equal(bits(k5s), bits(k5f)) and torch.equal(bits(k5s), bits(k5p)))
    n_live_f = int(live_f.sum())
    src_f = torch.cat([vals_flat[:, :n_live_f].T, torch.ones((n_live_f, 1), device=dev)], 1)
    idx_f = ks_flat[:n_live_f].long()
    k5_seg = dict(
        max_abs_err=float((k5s - k5p).abs().max()), bit_equal_flat_and_plain=k5_equal,
        ms=time_ms(lambda: splat_tile.splat_reduce_rows(ks_seg, vals_seg, n_f, DEPTH), 20),
        flat_ms=time_ms(lambda: splat_tile.splat_reduce_rows(ks_flat, vals_flat, n_f), 20),
        plain_ms=time_ms(lambda: splat_tile.reduce_rows_plain(ks_seg, vals_seg, n_f, DEPTH), 3),
        library_ms=time_ms(lambda: torch.zeros((n_f, 4), device=dev).index_add_(
            0, idx_f, src_f), 20),
        segments=DEPTH, **bound(16.0 * n_live_f + 16.0 * n_f, 0.0))
    log(f"11c K5 segments={DEPTH} on the frame's rows ({n_live_f} live): bit-equal to K5 on "
        f"the flat sort and to its plain version {k5_equal}; {k5_seg['ms']:.4f} ms (flat "
        f"{k5_seg['flat_ms']:.4f} ms), plain {k5_seg['plain_ms']:.4f} ms, index_add_ "
        f"{k5_seg['library_ms']:.4f} ms, bound {k5_seg['bound_ms']:.4f} ms")
    if not k5_equal:
        raise AssertionError("11c: K5 with segments differs from the flat sort's K5")
    kernels["splat_rows[segments]"] = k5_seg

    # a wavefront frame with splat_segments ('auto': rgb8e decoded into K5,
    # run by run) against the same frame without (K2 + sort + K3)
    seg_run = frames11(cornell, 1, "off", splat_segments=True)
    flat_run = frames11(cornell, 1, "off")
    seg_frame_equal = same_bits(seg_run[0], flat_run[0]) and same_bits(seg_run[1], flat_run[1])
    p11c["frame with splat_segments"] = {
        "bit_equal": seg_frame_equal, "ms_per_frame": seg_run[2], "flat_ms_per_frame": flat_run[2],
        "launches": seg_run[4], "frames": seg_run[5]}
    log(f"11c Cornell wavefront with splat_segments: {seg_run[2]:.4f} ms/frame (without "
        f"{flat_run[2]:.4f}), bit-equal to the frame without {seg_frame_equal}; launches "
        f"{seg_run[4]}")
    if not seg_frame_equal or seg_run[4].get("splat_rows[segments]", 0) != seg_run[5]:
        raise AssertionError("11c: the frame with splat_segments differs, or K5 with "
                             "segments did not run once a frame")
    p11["11c splat modes and segments"] = p11c
    p11["phase_s"] = time.perf_counter() - t11
    log(f"phase 11: {p11['phase_s']:.1f} s")

    # ---- phase 12: the image decoders (utils/jpeg.py, utils/raster.py) -------
    # before phase 5e's profiler, as phases 6 and 8-11; this machine has no
    # PIL.  12a: every fixture of tests/torch_images/ decoded and held bit
    # for bit to PIL's decode checked in beside it, host ms a file and a
    # megapixel.  12b: the alpha panel as OBJ + MTL with its cutout map_Kd a
    # 32-bit RLE TGA and the walls' map_Kd a progressive 4:2:0 JPEG, through
    # app.main --scene, against the same scene with PNG maps of the same
    # pixels.  12c: --envmap with the 1024x512 baseline JPEG and --probe
    # (phase 8d's route) against its PNG twin.  12d: pink_room built from a
    # folder of the fixtures under its texture names against a folder of
    # their PNG twins and against the checkerboard build.  Launches equal
    # to the PNG route's, frames bit-equal to it, ms a frame by CUDA events.
    from fyp_bidirectionalpathtracer_tpu_torch.models import pink_room as pink_mod
    from fyp_bidirectionalpathtracer_tpu_torch.utils.image import read_image, read_rgba

    t12 = time.perf_counter()
    p12 = {"device": smi, "size": f"{WIDTH}x{HEIGHT}"}
    fixture_dir = os.path.join(REPO, "tests", "torch_images")
    fixtures = sorted(f for f in os.listdir(fixture_dir) if not f.endswith((".py", ".pil.png")))
    decodes = {}
    for name in fixtures:
        path = os.path.join(fixture_dir, name)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            got = read_rgba(path)
            times.append((time.perf_counter() - t) * 1e3)
        want = read_rgba(path + ".pil.png")
        if got.shape != want.shape or not np.array_equal(got.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"12a: {name} does not decode as PIL does")
        mpix = got.shape[0] * got.shape[1] / 1e6
        decodes[name] = {"size": f"{got.shape[1]}x{got.shape[0]}", "bytes": os.path.getsize(path),
                         "ms": min(times), "ms_per_megapixel": min(times) / mpix}
    p12["12a decodes"] = decodes
    env_dec = decodes["env_1024x512.jpg"]
    log(f"12a {len(fixtures)} fixtures (JPEG, PNG, TGA, BMP) decoded bit-equal to PIL's decodes; "
        f"host ms (best of 3): " + ", ".join(f"{k} {v['ms']:.2f}" for k, v in decodes.items())
        + f"; the 1024x512 JPEG {env_dec['ms']:.2f} ms, {env_dec['ms_per_megapixel']:.2f} ms/MP")

    with tempfile.TemporaryDirectory() as tmp12:
        # 12b: the OBJ panel, TGA + JPEG maps against PNG maps of the same pixels
        panel = procedural.alpha_panel_scene()
        cut = panel.materials[1].base_color_image
        runs_b = {}
        for label, cut_map, wall_map in (("tga+jpeg", "cutout.tga", "walls.jpg"),
                                         ("png", "cutout.png", "walls.png")):
            d = f"{tmp12}/b_{label}"
            os.makedirs(d)
            save_obj(f"{d}/panel.obj", panel.meshes, panel.materials)
            write_tga_rle32(f"{d}/cutout.tga", cut)
            write_png_rgba(f"{d}/cutout.png", cut)
            shutil.copy(os.path.join(fixture_dir, "progressive_420.jpg"), f"{d}/walls.jpg")
            write_png(f"{d}/walls.png", read_png(f"{d}/walls.jpg"))
            mtl = open(f"{d}/panel.mtl").read()
            mtl = mtl.replace("newmtl panel\n", f"newmtl panel\nmap_Kd {cut_map}\n")
            mtl = mtl.replace("newmtl white\n", f"newmtl white\nmap_Kd {wall_map}\n")
            open(f"{d}/panel.mtl", "w").write(mtl)
            res, launches = run_app(["--scene", f"{d}/panel.obj", "--frames", "2",
                                     "--outputdir", f"{d}/out"])
            runs_b[label] = (res, launches, d)
        (res_t, launches_t, d_t), (res_p, launches_p, d_p) = runs_b["tga+jpeg"], runs_b["png"]
        maps_equal = all(np.array_equal(read_rgba(f"{d_t}/{a}"), read_rgba(f"{d_p}/{b}"))
                         for a, b in (("cutout.tga", "cutout.png"), ("walls.jpg", "walls.png")))
        bk12b = app.load_scene(f"{d_t}/panel.obj").bake(max_lights=16, device=dev)
        first_b, last_b, ms_b, host_b, frame_launches_b, n_b12 = frames11(bk12b, 2)
        if not (maps_equal and launches_t == launches_p and same_file(res_t["output"],
                                                                       res_p["output"])
                and bk12b.has_alpha and launches_t.get("shaded", 0) > 0):
            raise AssertionError(f"12b: the TGA/JPEG-mapped panel differs from the PNG-mapped "
                                 f"one (maps equal {maps_equal}, launches {launches_t} vs "
                                 f"{launches_p})")
        p12["12b obj tga + jpeg maps"] = {
            "tris": bk12b.n_tris, "frames": 2, "launches": launches_t,
            "png_route_launches": launches_p, "image_bit_equal_to_png_route": True,
            "sec_per_frame": res_t["sec_per_frame"], "ms_per_frame": ms_b,
            "host_ms_per_frame": host_b, "renderer_launches": frame_launches_b,
            "renderer_frames": n_b12}
        log(f"12b app.main --scene panel.obj (map_Kd a 32-bit RLE TGA cutout and a progressive "
            f"4:2:0 JPEG) {WIDTH}x{HEIGHT}, 2 frames: launches {launches_t} = the PNG-mapped "
            f"scene's, image bit-equal to it; Renderer {ms_b:.4f} ms/frame (CUDA events), host "
            f"{host_b:.4f}")
        del bk12b, first_b, last_b

        # 12c: --envmap with the 1024x512 baseline JPEG, phase 8d's route
        env_jpg = os.path.join(fixture_dir, "env_1024x512.jpg")
        write_png(f"{tmp12}/env.png", read_png(env_jpg))
        runs_c = {}
        for label, env in (("jpeg", env_jpg), ("png", f"{tmp12}/env.png")):
            runs_c[label] = run_app(["--frames", "6", "--envmap", env, "--probe",
                                     "--outputdir", f"{tmp12}/c_{label}"])
        (res_j, launches_j), (res_q, launches_q) = runs_c["jpeg"], runs_c["png"]
        env_scene = Scene.from_built(cornell_box())
        env_scene.env_map = read_image(env_jpg)
        bk12c = env_scene.bake(max_lights=16, device=dev)
        first_c, last_c, ms_c, host_c, frame_launches_c, n_c12 = frames11(bk12c, 3)
        if not (launches_j == launches_q == want_d
                and same_file(res_j["output"], res_q["output"])
                and same_file(res_j["probe_lit"], res_q["probe_lit"])):
            raise AssertionError(f"12c: the JPEG env map's run differs from the PNG's "
                                 f"(launches {launches_j}, {launches_q}, want {want_d})")
        p12["12c jpeg env map"] = {
            "env": "1024x512 baseline JPEG", "frames": 6, "launches": launches_j,
            "images_bit_equal_to_png_route": True, "sec_per_frame": res_j["sec_per_frame"],
            "ms_per_frame": ms_c, "host_ms_per_frame": host_c}
        log(f"12c --envmap (1024x512 baseline JPEG) --probe {WIDTH}x{HEIGHT}, 6 frames: launches "
            f"{launches_j} = the PNG env map's, render and probe_lit bit-equal to it; Renderer "
            f"{ms_c:.4f} ms/frame (CUDA events), host {host_c:.4f}")
        del bk12c, first_c, last_c

        # 12d: pink_room from the fixtures under its texture names, against
        # their PNG twins (the checked-in decodes) and the checkerboard build
        names = []
        real_loader = pink_mod._load_texture
        pink_mod._load_texture = lambda d, name, fallback: names.append(name) or fallback
        try:
            pink_mod.pink_room(asset_dir="")
        finally:
            pink_mod._load_texture = real_loader
        jpgs = [f for f in fixtures if f.endswith(".jpg") and not f.startswith("env")]
        others = [f for f in fixtures if not f.startswith("env")]
        bakes = {}
        for label, suffix in (("fixtures", ""), ("png twins", ".pil.png")):
            folder = f"{tmp12}/tex_{label.replace(' ', '_')}"
            os.makedirs(folder)
            for i, name in enumerate(names):
                src = jpgs[i % len(jpgs)] if name.endswith(".jpg") else others[i % len(others)]
                shutil.copy(os.path.join(fixture_dir, src + suffix), os.path.join(folder, name))
            t = time.perf_counter()
            built = pink_room(asset_dir=folder)
            build_ms = (time.perf_counter() - t) * 1e3
            bakes[label] = (Scene.from_built(built, aspect=WIDTH / HEIGHT).bake(device=dev),
                            build_ms)
        bk_fix, bk_twin = bakes["fixtures"][0], bakes["png twins"][0]
        atlas = bk_fix.data.textures
        same_atlas = all(torch.equal(getattr(atlas, k), getattr(bk_twin.data.textures, k))
                         for k in ("data", "sizes"))
        differs = not (atlas.sizes.shape == pink_main.data.textures.sizes.shape
                       and torch.equal(atlas.sizes, pink_main.data.textures.sizes)
                       and torch.equal(atlas.data, pink_main.data.textures.data))
        run_fix, run_twin = frames11(bk_fix, 2), frames11(bk_twin, 2)
        frames_equal = same_bits(run_fix[0], run_twin[0]) and same_bits(run_fix[1], run_twin[1])
        if not (same_atlas and differs and frames_equal and run_fix[4] == run_twin[4]
                and run_fix[4].get("bvh_shaded", 0) > 0):
            raise AssertionError(f"12d: pink_room from the fixtures: atlas equal to the PNG "
                                 f"twins' {same_atlas}, unlike the checkerboards' {differs}, "
                                 f"frames equal {frames_equal}, launches {run_fix[4]} vs "
                                 f"{run_twin[4]}")
        p12["12d pink_room texture folder"] = {
            "textures": len(names), "tris": bk_fix.n_tris,
            "build_ms_fixtures": bakes["fixtures"][1], "build_ms_png_twins": bakes["png twins"][1],
            "frames": run_fix[5], "ms_per_frame": run_fix[2], "host_ms_per_frame": run_fix[3],
            "png_twins_ms_per_frame": run_twin[2], "launches": run_fix[4],
            "atlas_equal_to_png_twins": True, "atlas_differs_from_checkerboards": True,
            "frames_bit_equal_to_png_twins": True}
        log(f"12d pink_room from {len(names)} fixture files under its texture names "
            f"({bk_fix.n_tris} tris) {WIDTH}x{HEIGHT}, {run_fix[5]} frames: {run_fix[2]:.4f} "
            f"ms/frame (CUDA events; PNG twins {run_twin[2]:.4f}), host {run_fix[3]:.4f}; build "
            f"{bakes['fixtures'][1]:.1f} ms (PNG twins {bakes['png twins'][1]:.1f}); atlas equal "
            f"to the PNG twins' and unlike the checkerboard build's; frames bit-equal; launches "
            f"{run_fix[4]}")
        del bakes, bk_fix, bk_twin, run_fix, run_twin
    p12["phase_s"] = time.perf_counter() - t12
    log(f"phase 12: {p12['phase_s']:.1f} s")

    # ---- phase 5e: BMFR on the Cornell megakernel path ---------------------
    # bench.py's BMFR cell: every stage, the full screen; the BMFR-off frame
    # is phase 5's megakernel run
    bmfr_cfg = BMFRConfig(enabled=True, preprocess=True, regression=True, postprocess=True,
                          half_screen_debug=False)
    bm_label = "Cornell megakernel + BMFR (full screen)"
    bm_launches, bm_frames, _, bm_ms = drive("auto", label=bm_label, bmfr=bmfr_cfg)
    for key in ("frame", "compact", "splat_tile", "bmfr_fit"):
        if bm_launches[key] != bm_frames:
            raise AssertionError(f"kernel {key} launched {bm_launches[key]} times in "
                                 f"{bm_frames} BMFR frames")
    # one pass's stages on a frame with history (2 frames rendered; a still
    # camera, as the bench's)
    r = Renderer(cornell, cfg_for(WIDTH, HEIGHT, bmfr=bmfr_cfg))
    r.render(2)
    ch, st, cam = r.channels, r.state.bmfr, r.camera
    pos, nrm, alb, acc = (ch[k] for k in ("WorldPosition", "WorldNormal", "MaterialDiffuse",
                                          "Accumulated"))
    stage_fns = {}
    for solver in ("qr", "normal"):
        scfg = replace(bmfr_cfg, regression_solver=solver)
        pre = bmfr_mod.preprocess(st, pos, nrm, acc, cam.prev_view_proj, scfg)
        st_blit = replace(st, prev_noisy=pre[0], prev_norm=nrm, prev_pos=pos)
        reg = bmfr_mod.regression(pos, nrm, alb, pre[0], st.frame_number, scfg)
        stage_fns[solver] = {
            "preprocess": partial(bmfr_mod.preprocess, st, pos, nrm, acc, cam.prev_view_proj,
                                  scfg),
            "regression": partial(bmfr_mod.regression, pos, nrm, alb, pre[0], st.frame_number,
                                  scfg),
            "postprocess": partial(bmfr_mod.postprocess, st_blit, reg, pre[1], pre[2], scfg),
            "pass": partial(bmfr_mod.bmfr_pass, st, ch, cam, scfg)}
        if solver == "qr":  # the fit kernel's plain version on the same inputs
            stage_fns[solver]["regression_plain"] = partial(
                bmfr_mod.regression_plain, pos, nrm, alb, pre[0], st.frame_number, scfg)
    # eager (paced by the host's cost of each of a pass's ~1,000 launches)
    # and CUDA-graph replays (the device's time)
    stages = {solver: {key: value for name, fn in fns.items()
                       for key, value in ((f"{name}_ms", time_ms(fn, 10)),
                                          (f"{name}_graph_ms", time_graph_ms(fn, 5)))}
              for solver, fns in stage_fns.items()}
    # the fit kernel: host us a call, and against its plain version on the
    # same card inputs (the share of pixels and blocks beyond 1e-3, the
    # pixels the window leaves bit-equal)
    fit = stage_fns["qr"]
    fit_got, fit_want = fit["regression"](), fit["regression_plain"]()
    fit_d = (fit_got - fit_want)[..., :3].abs().amax(-1)
    fit_line = {
        "kernel_ms": stages["qr"]["regression_ms"],
        "kernel_graph_ms": stages["qr"]["regression_graph_ms"],
        "kernel_host_us": host_us(fit["regression"], 200),
        "plain_ms": stages["qr"]["regression_plain_ms"],
        "plain_graph_ms": stages["qr"]["regression_plain_graph_ms"],
        "max_abs_err": float(fit_d.max()), "share_over_1e-3": float((fit_d > 1e-3).float().mean()),
        "alpha_equal": bool(torch.equal(fit_got[..., 3], fit_want[..., 3])),
        "ptxas": {v: kernel_ptxas(ptxas, f"bmfr_fit_kernelILb{int(v == 'ld_skip')}E")
                  for v in ("ld_skip", "add_noise")}}
    log(f"BMFR fit kernel at {WIDTH}x{HEIGHT}: {fit_line}")
    if not (fit_line["share_over_1e-3"] <= 1e-3 and fit_line["alpha_equal"]
            and bool(torch.isfinite(fit_got).all())):
        raise AssertionError("BMFR's fit kernel differs from its plain version")
    del fit, fit_got, fit_want, fit_d
    # the card's pass against the port's own CPU pass on the same inputs
    st_cpu = BMFRState(*(t.cpu() for t in (st.prev_pos, st.prev_norm, st.prev_noisy,
                                            st.prev_filtered, st.frame_number)))
    ch_cpu = {k: v.cpu() for k, v in ch.items()}
    vs_cpu = {}
    for solver in ("qr", "normal"):
        scfg = replace(bmfr_cfg, regression_solver=solver)
        _, on_card = bmfr_mod.bmfr_pass(st, ch, cam, scfg)
        _, on_cpu = bmfr_mod.bmfr_pass(st_cpu, ch_cpu, cam, scfg)
        d = (on_card.cpu() - on_cpu).abs().amax(-1)
        vs_cpu[solver] = {"max_abs_err": float(d.max()),
                          "share_over_1e-3": float((d > 1e-3).float().mean()),
                          "finite": bool(torch.isfinite(on_card).all())}
    log(f"BMFR pass, card vs CPU at {WIDTH}x{HEIGHT}: {vs_cpu} (qr: <= 0.1% of pixels over "
        f"1e-3; normal reported)")
    if not (vs_cpu["qr"]["share_over_1e-3"] <= 1e-3 and vs_cpu["qr"]["finite"]
            and vs_cpu["normal"]["finite"]):
        raise AssertionError("the card's BMFR pass differs from the CPU's")
    # device operations of one call (kernels, copies and memsets, from a
    # profiler trace); after every timing, as CUPTI slows later launches
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for solver, fns in stage_fns.items():
        for name, fn in fns.items():
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            stages[solver][f"{name}_device_ops"] = len(device_operations(prof.events()))
    n_blocks = ((HEIGHT + 31) // 32 + 1) * ((WIDTH + 31) // 32 + 1)
    # the regression reads its block window once ([n_by * 32, n_bx * 32, 12]
    # float32), reads the noisy image and writes the output ([H, W, 4]);
    # operations: per block and column c of the QR, the norm (2 a pixel) and
    # the reflection of the 12 - c later columns (4 a pixel each), the fit
    # (60 a pixel) and the features (13 a pixel)
    reg_bytes = 4.0 * (n_blocks * 1024 * 12 + 2 * 4 * n_pix)
    reg_flops = n_blocks * 1024.0 * (sum(2 + 4 * (12 - c) for c in range(10)) + 60 + 13)
    reg_bound = bound(reg_bytes, reg_flops)
    bmfr_line = {"bmfr": {
        "device": smi, "size": f"{WIDTH}x{HEIGHT}", "depth": DEPTH,
        "config": "BMFRConfig(enabled, preprocess, regression, postprocess, "
                  "half_screen_debug=False), solver auto = qr, history_pack auto = f32",
        "ms_per_frame": bm_ms, "host_ms_per_frame": host_ms_of[bm_label],
        "ms_per_frame_bmfr_off": mk_ms, "host_ms_per_frame_bmfr_off": host_ms_of["auto path"],
        "kernel_launches": {k: bm_launches[k] for k in ("frame", "compact", "splat_tile",
                                                        "bmfr_fit")},
        "frames": bm_frames, "stages": stages, "card_vs_cpu": vs_cpu,
        "regression_bytes": reg_bytes, "regression_flops": reg_flops,
        "regression_bound_ms": reg_bound["bound_ms"],
        "regression_bound_by": reg_bound["bound_by"],
        "fit_kernel": {**fit_line, "blocks": n_blocks,
                       "bound_share": reg_bound["bound_ms"] / fit_line["kernel_graph_ms"]}}}
    log(f"{bm_label}: {bm_ms:.4f} ms/frame against {mk_ms:.4f} BMFR off; stages {stages}; "
        f"regression bound {reg_bound['bound_ms']:.4f} ms ({reg_bound['bound_by']})")
    del r, ch, st, cam, ch_cpu, st_cpu, stage_fns

    # phase 6's frames profiled (after every timing): device busy and idle
    # (against the unprofiled ms/frame above), launches and ms by kernel:
    # the port's own kernels (namespace bdpt::) and torch's 8 longest, by
    # their names up to the template arguments
    for label, (bk, cfg) in p6_renderers.items():
        prof = profile_renderer(Renderer(bk, cfg), frames=3, repeats=0)
        run = p6["runs"][label]
        by_kernel = prof["kernels_ms_per_frame"]
        ours = {k.split("(")[0]: v for k, v in by_kernel.items() if "bdpt::" in k}
        torch_ms = {}
        for k, v in by_kernel.items():
            if "bdpt::" not in k:
                name = re.sub(r"^void ", "", k.split("<")[0])
                torch_ms[name] = torch_ms.get(name, 0.0) + v
        torch_top = dict(sorted(torch_ms.items(), key=lambda kv: -kv[1])[:8])
        run.update(device_busy_ms_per_frame=prof["device_busy_ms_per_frame"],
                   device_idle_share=1.0 - prof["device_busy_ms_per_frame"] / run["ms_per_frame"],
                   device_operations_per_frame=prof["kernel_launches_per_frame"],
                   port_kernels_ms_per_frame=ours, port_kernels_ms_sum=sum(ours.values()),
                   torch_kernels_ms_per_frame=torch_top)
        log(f"{label} profile: busy {run['device_busy_ms_per_frame']:.4f} ms of "
            f"{run['ms_per_frame']:.4f} ms/frame (idle {run['device_idle_share']:.3f}), "
            f"{run['device_operations_per_frame']:.0f} device operations a frame; the port's "
            f"kernels {ours} (sum {run['port_kernels_ms_sum']:.4f} ms); torch's longest "
            f"{torch_top}")

    # phase 8c's passes profiled the same way: busy and idle against the
    # unprofiled CUDA-event ms a call, device operations, ms by kernel
    for (label, name), (run, call) in p8_calls.items():
        _, busy, ops, by_kernel, _ = profile_calls(call, 3)
        ours = {k.split("(")[0]: v for k, v in by_kernel.items() if "bdpt::" in k}
        torch_ms = {}
        for k, v in by_kernel.items():
            if "bdpt::" not in k:
                key = re.sub(r"^void ", "", k.split("<")[0])
                torch_ms[key] = torch_ms.get(key, 0.0) + v
        run.update(device_busy_ms=busy, device_idle_share=1.0 - busy / run["ms"],
                   device_operations=ops, port_kernels_ms=ours,
                   port_kernels_ms_sum=sum(ours.values()),
                   torch_kernels_ms=dict(sorted(torch_ms.items(), key=lambda kv: -kv[1])[:6]))
        log(f"8c {name} on {label} profile: busy {busy:.4f} ms of {run['ms']:.4f} ms a call "
            f"(idle {run['device_idle_share']:.3f}), {ops:.0f} device operations; the port's "
            f"kernels {ours} (sum {run['port_kernels_ms_sum']:.4f} ms); torch's longest "
            f"{run['torch_kernels_ms']}")

    launches = {"frame": mk_launches["frame"], "compact": mk_launches["compact"],
                "splat_tile": mk_launches["splat_tile"], "shaded": wf_launches["shaded"],
                "occluded": wf_launches["occluded"],
                "bvh_shaded": pk_launches["bvh_shaded"],
                "bvh_occluded": pk_launches["bvh_occluded"],
                "bvh_closest": big_launches[4]["bvh_closest"],
                "frame_textured": tex_runs["auto"][0]["frame_textured"],
                "splat_rows": tex_runs["tiled"][0]["splat_rows"],
                "subpath": sp_launches["subpath"],
                "bvh_shaded[order]": pk_launches["bvh_shaded[order]"],
                "bvh_occluded[order]": pk_launches["bvh_occluded[order]"],
                "bvh_closest[order]": big_launches[4]["bvh_closest[order]"],
                "splat_rows[segments]": seg_run[4]["splat_rows[segments]"]}
    # the closest kernel's main path: phase 6a's alpha shadow batches and
    # restarts (the force_fused=False G-buffer of phase 4 launches it once)
    kernels["closest"]["gbuffer_force_fused_false_launches"] = kernels["closest"].pop("launches")
    p6a = p6["runs"]["6a alpha panel (dense)"]
    launches["closest"] = p6a["launches_per_frame"]["closest"] * p6a["frames"]
    # the run each kernel's launch count comes from
    paths = {name: f"megakernel {WIDTH}x{HEIGHT}, {n_frames} frames"
             for name in ("frame", "compact", "splat_tile")}
    paths.update({name: f"wavefront {WIDTH}x{HEIGHT}, {n_frames} frames"
                  for name in ("shaded", "occluded")})
    paths["closest"] = (f"6a alpha panel wavefront {WIDTH}x{HEIGHT}, {p6a['frames']} frames "
                        f"(alpha shadow batches and restarts)")
    paths.update({name: f"pink_room wavefront {WIDTH}x{HEIGHT}, {pk_frames} frames"
                  for name in ("bvh_shaded", "bvh_occluded")})
    paths["bvh_closest"] = f"pink_room subdivisions=4 wavefront {WIDTH}x{HEIGHT}, {n_big} frames"
    paths["frame_textured"] = (f"textured room megakernel (defer_textures, auto) "
                               f"{WIDTH}x{HEIGHT}, {tex_runs['auto'][1]} frames")
    paths["splat_rows"] = (f"textured room megakernel (defer_textures, splat_mode tiled) "
                           f"{WIDTH}x{HEIGHT}, {tex_runs['tiled'][1]} frames")
    paths["subpath"] = f"build_subpath, {n_pix} Cornell camera rays x {DEPTH} bounces, 1 call"
    paths.update({f"{name}[order]": paths[name] + " (the sorted extensions and shadow batches)"
                  for name in ("bvh_shaded", "bvh_closest", "bvh_occluded")})
    paths["splat_rows[segments]"] = (f"11c Cornell wavefront with splat_segments "
                                     f"{WIDTH}x{HEIGHT}, {seg_run[5]} frames")
    for name in ("bvh_shaded", "bvh_closest", "bvh_occluded"):
        kernels[name] = dict(max_abs_err=0.0, library_ms=None,
                             **{k: v for k, v in bvh_stats["pink_room"][name].items()})

    # ---- phase 7: goldens ---------------------------------------------------
    # utils/testing.golden_compare's metric (8-bit PSNR against
    # tests/golden/<name>.png), read here without its UPDATE_GOLDEN rewrite:
    # a missing golden raises, and each must reach the JAX package's bar
    def golden_psnr(name, img, bar=MIN_PSNR):
        golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
        value = psnr(to_u8(img).astype(np.float32) / 255.0, golden)
        if bar is not None and not value >= bar:
            raise AssertionError(f"golden {name}: PSNR {value:.2f} dB < {bar} dB")
        return value

    for mk in ("auto", "off"):
        small = Renderer(scene("cornell", 64, 64),
                         RenderConfig(width=64, height=64, bdpt=BDPTConfig(megakernel=mk)))
        small.render(8)
        value = golden_psnr("cornell_bdpt_8f_64", small.display())
        log(f"golden cornell_bdpt_8f_64 (megakernel {mk}): PSNR {value:.2f} dB "
            f"(>= {MIN_PSNR})")

    # the BMFR golden (tests/test_golden.py's case: regression on, the
    # reference's half-screen default)
    small = Renderer(scene("cornell", 64, 64),
                     RenderConfig(width=64, height=64,
                                  bmfr=BMFRConfig(enabled=True, regression=True)))
    small.render(6)
    value = golden_psnr("cornell_bmfr_6f_64", small.display())
    log(f"golden cornell_bmfr_6f_64: PSNR {value:.2f} dB (>= {MIN_PSNR})")

    # the pink_room golden: with exact taps at every vertex (what JAX's CPU
    # path renders) at the JAX package's bar; the default config's
    # mean-albedo bounce decodes beside it, with no bar
    small = pink(3, 64, 40)
    for mean in (False, True):
        r = Renderer(small, RenderConfig(width=64, height=40,
                                         bdpt=BDPTConfig(bounce_tex_mean=mean)))
        r.render(2)
        value = golden_psnr("pink_room_fallback_2f_64x40", r.display(),
                            None if mean else MIN_PSNR)
        log(f"golden pink_room_fallback_2f_64x40 (bounce_tex_mean={mean}): PSNR {value:.2f} dB"
            + ("" if mean else f" (>= {MIN_PSNR})"))

    # the env-map golden (tests/test_envmap.py's open scene, 64x64, 4 frames)
    # and the probe-lit one (tests/test_lightprobe.py: the Cornell G-buffer,
    # probe_lit_pass with its 1x1 env's probe, the clamp tone map)
    small = open_scene(procedural, Scene, latlong_probe_gradient(), 1.0).bake(device=dev)
    r = Renderer(small, RenderConfig(width=64, height=64))
    r.render(4)
    value = golden_psnr("env_open_4f_64", r.display())
    log(f"golden env_open_4f_64: PSNR {value:.2f} dB (>= {MIN_PSNR})")
    small = scene("cornell", 64, 64)
    gb = ray_traced_gbuffer(small, make_shaded_tracer(small), 64, 64, GBUF_FRAME_INIT,
                            pixel_jitter_for_frame(GBUF_FRAME_INIT))
    small_probe = lightprobe.LightProbe(small.env_map, diff_samples=256, spec_samples=64,
                                        diff_size=16, spec_size=32, spec_mips=4)
    lit = probe_lit_pass(small, small.intersector(), gb, small_probe)
    value = golden_psnr("cornell_probe_lit_64", tonemap.tone_map(lit[..., :3], tonemap.CLAMP))
    log(f"golden cornell_probe_lit_64: PSNR {value:.2f} dB (>= {MIN_PSNR})")

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
    # the variants: the BVH kernels walking a ray order, K5 with segments
    for name in ("bvh_shaded", "bvh_closest", "bvh_occluded"):
        meta[f"{name}[order]"] = meta[name]
        if name in also:
            also[f"{name}[order]"] = also[name]
    meta["splat_rows[segments]"] = meta["splat_rows"]
    # the alpha restarts' batches (phase 6a, 6b) beside each kernel's main keys
    for name, value in p6_kernels.items():
        kernels[name]["alpha_restarts"] = value
    for name in kernels:
        kernels[name]["phase6_launches_per_frame"] = {
            label: run["launches_per_frame"].get(name, 0) for label, run in p6["runs"].items()}
        # the row-sharded runs (phase 10b/10c): each rank's launches in its run
        kernels[name]["sharded_launches_per_rank"] = {
            label: run["launches_per_rank"][0].get(name, 0) for label, run in p10["runs"].items()}
    log(json.dumps({"phase6": p6}))
    log(json.dumps({"phase8": p8}))
    log(json.dumps({"phase9": p9}))
    log(json.dumps({"phase10": p10}))
    log(json.dumps({"phase11": p11}))
    log(json.dumps({"phase12": p12}))
    log(json.dumps(bmfr_line))
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": pkg + meta[name][0],
         "replaces": meta[name][1], "launches": launches[name], "path": paths[name],
         **({"also_replaces": also[name]} if name in also else {}), **kernels[name]}
        for name in ("frame", "compact", "splat_tile", "shaded", "closest", "occluded",
                     "bvh_shaded", "bvh_closest", "bvh_occluded", "frame_textured",
                     "splat_rows", "subpath", "bvh_shaded[order]", "bvh_closest[order]",
                     "bvh_occluded[order]", "splat_rows[segments]")]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
