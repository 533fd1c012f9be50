"""Kernel and frame times of one checkout of the port, for parent/change pairs.

    python3 ab_times.py --root DIR [--label NAME] [--out PATH.json]
                        [--parts splat,closest,any_hit,k1,frames]

Imports `fyp_bidirectionalpathtracer_tpu_torch` from the checkout at `--root`
(this file's own checkout by default), builds that checkout's kernels into
its own `build/torch_kernels/`, and times on the CUDA device at 1280x720,
depth 3, with `chip_smoke.py`'s timers (this file's checkout's), the parts
`--parts` names (all by default):

- splat: K5 (`splat_reduce_rows`) on U = 2,764,800 sorted updates, 15% live, as
  `chip_smoke.py` phase 3b makes them (float32 rgb + count, float32 4 rows,
  bfloat16 4 rows), beside `index_add_` of the live rows and the bytes
  bound; K3 (`splat_reduce`) on the live prefix beside its `index_add_`.
  As in `chip_smoke.py`'s kernels line, `ms` and `library_ms` are eager
  calls, `graph_ms` and `library_graph_ms` 20 calls replayed from one CUDA
  graph, which leaves out the host's cost of each call;
  K3 also with the host's cost of a call (`host_us`);
- k1: K1 on the Cornell box and K1's textured variant on the textured room
  (`defer_textures`), as `chip_smoke.py` phases 4 and 4f call them;
- closest: the BVH closest and shaded kernels (K4h/K4j, K4g) on pink_room's
  G-buffer rays (back-face culling on) and one extension batch (off), as
  `chip_smoke.k4_rays` makes them, at subdivisions 3 and 5 (10,546 and
  164,146 triangles), over the tables the checkout's kernels take: their
  launches on the packed rays (`ms`, `extension_ms`, as `chip_smoke.py`
  phase 4d times them), and the hits they found;
- any_hit: the BVH any-hit kernel on pink_room's est-3-shaped shadow
  batch ([4, 720, 1280], 30% of the lanes empty, as `chip_smoke.k4_rays`
  makes it) at subdivisions 3 and 5 (10,546 and 164,146 triangles), over
  the tables the checkout's kernel takes: its launch on the packed rays
  (`ms`, as `chip_smoke.py` times it) and the wrapper's whole call
  (`accel/cluster.bvh_occluded`, `wrapper_ms`);
- frames: frames through `Renderer`: the Cornell megakernel path, the deferred
  textured room with splat mode "auto" and "tiled", and pink_room (default
  config, the wavefront with the BVH kernels): device ms/frame (CUDA
  events around 10 frames after 3 warm-up frames), host ms/frame, and the
  device busy time a frame (the union of the kernels' intervals in a
  `torch.profiler` trace of 5 frames, by the checkout's `frame_profile`)
  with the idle share it leaves.

Prints one JSON object (and writes it to `--out`).  Run it on parent and
change in turns in one call (parent, change, change, parent), each checkout
unpacked from `git archive` into a directory that `.gitignore` lists, so the
two are compared on one card.  The frame entry point it calls is the
checkout's own: `frame_kernel` takes the BVH node table where its signature
asks for it, and the BVH kernels the tables theirs ask for.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

from chip_smoke import bound, host_us, k4_rays, time_graph_ms, time_ms

WIDTH, HEIGHT, DEPTH = 1280, 720, 3
LIVE_FRAC = 0.15
MIN_T = 1e-3


def _times(fn, lib_fn) -> dict:
    """A kernel's call and its library call, eager and graph-replayed."""
    return {"ms": time_ms(fn, 20), "graph_ms": time_graph_ms(fn),
            "library_ms": time_ms(lib_fn, 20), "library_graph_ms": time_graph_ms(lib_fn)}


def splat_times(torch, pkg, dev) -> dict:
    splat_tile = pkg["splat_tile"]
    n_pix = WIDTH * HEIGHT
    u = DEPTH * n_pix
    sent = ((n_pix + 1023) // 1024) * 1024
    g = torch.Generator().manual_seed(0)
    live = torch.rand(u, generator=g) < LIVE_FRAC
    keys = torch.where(live, torch.randint(0, n_pix, (u,), generator=g),
                       torch.full((u,), n_pix)).to(torch.int32)
    rgb = torch.rand(u, 3, generator=g) * 0.9
    alpha = torch.rand((1, u), generator=g)
    keys_d = torch.where(keys < n_pix, keys, sent).to(dev)
    ks, order = torch.sort(keys_d, stable=True)
    n_live = int((ks < n_pix).sum())
    vals_all = torch.cat([rgb.T, alpha], 0).to(dev)[:, order].contiguous()
    out = {"updates": u, "live": n_live}
    for label, vals in (("f32 count", vals_all[:3].contiguous()), ("f32", vals_all),
                        ("bf16", vals_all.to(torch.bfloat16))):
        src = vals[:, :n_live].T.float()
        if vals.shape[0] == 3:
            src = torch.cat([src, torch.ones((n_live, 1), device=dev)], 1)
        src, idx = src.contiguous(), ks[:n_live].long()
        got = splat_tile.splat_reduce_rows(ks, vals, n_pix)
        want = splat_tile.reduce_rows_plain(ks, vals, n_pix)
        torch.cuda.synchronize()
        n_bytes = (4.0 + vals.element_size() * vals.shape[0]) * n_live + 16.0 * n_pix
        out[f"K5 {label}"] = {
            **_times(lambda: splat_tile.splat_reduce_rows(ks, vals, n_pix),
                     lambda: torch.zeros((n_pix, 4), device=dev).index_add_(0, idx, src)),
            "bound_ms": bound(n_bytes, 0.0)["bound_ms"],
            "bit_equal": bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))}
    # K3 on the sorted live prefix of rgb8e payloads
    ls = ks[:n_live]
    c = rgb.to(dev)[order][:n_live]
    p8 = splat_tile.pack_rgb8e(c[:, 0].contiguous(), c[:, 1].contiguous(),
                               c[:, 2].contiguous()).contiguous()
    rows4 = torch.cat([torch.stack(splat_tile.unpack_rgb8e(p8), 1),
                       torch.ones((n_live, 1), device=dev)], 1)
    idx = ls.long()
    out["K3"] = {
        **_times(lambda: splat_tile.splat_reduce(ls, p8, n_pix),
                 lambda: torch.zeros((n_pix, 4), device=dev).index_add_(0, idx, rows4)),
        "host_us": host_us(lambda: splat_tile.splat_reduce(ls, p8, n_pix)),
        "bound_ms": bound(8.0 * n_live + 16.0 * n_pix, 0.0)["bound_ms"]}
    return out


def _two_box(cluster) -> bool:
    """Do the checkout's BVH closest kernels walk the two-box table (else
    the pack and the threaded node table)?"""
    return "pairs" in inspect.signature(cluster.bvh_closest).parameters


def _pink(pkg, dev, sub):
    """pink_room at `subdivisions` and the checkout's BVH shaded wrapper
    over its tables, for `chip_smoke.k4_rays`."""
    cluster = pkg["cluster"]
    bk = _bake(pkg, dev, pkg["pink_room"](asset_dir="", subdivisions=sub))
    tables = (dict(rows=bk.bw_rows, pairs=bk.bvh_pairs) if _two_box(cluster)
              else dict(nodes=bk.bvh_nodes))
    return bk, partial(cluster.bvh_shaded_fm, **tables)


def closest_times(torch, pkg, dev) -> dict:
    """The BVH shaded and closest kernels' launches on packed rays: `ms` on
    pink_room's G-buffer rays (culling on), `extension_ms` on an extension
    batch (off), as `chip_smoke.py` phase 4d times them (the launch with a
    preallocated ray counter where the checkout's kernels take one)."""
    cluster, isect, cuda = pkg["cluster"], pkg["intersect"], pkg["cuda"]
    lib, stream, p = cuda.library(), cuda.stream(dev), cuda.ptr
    out = {}
    for sub in (3, 5):
        bk, shaded = _pink(pkg, dev, sub)
        (o_g, d_g), (o_e, d_e), _ = k4_rays(bk, WIDTH, HEIGHT, dev, shaded)
        rows_g, _ = isect.rays(o_g, d_g, 0.0, None)
        rows_e, _ = isect.rays(o_e, d_e, MIN_T, None)
        n = rows_g.shape[1]
        fields = torch.empty((isect.OUT_W, n), device=dev)
        t = torch.empty(n, device=dev)
        ids = torch.empty(n, dtype=torch.int32, device=dev)
        u, v = torch.empty_like(t), torch.empty_like(t)
        if _two_box(cluster):
            counter = torch.empty(1, dtype=torch.int32, device=dev)
            closest_tables = (p(bk.bw_rows), p(bk.bvh_pairs))
            shaded_tables = (p(bk.tri_pack),) + closest_tables
            tail = (p(counter), stream)
        else:
            closest_tables = shaded_tables = (p(bk.tri_pack), p(bk.bvh_nodes))
            tail = (stream,)
        runs = {"bvh_shaded": lambda rows, cull: lib.bdpt_bvh_shaded(
                    p(rows), n, *shaded_tables, cull, p(fields), *tail),
                "bvh_closest": lambda rows, cull: lib.bdpt_bvh_closest(
                    p(rows), n, *closest_tables, cull, p(t), p(ids), p(u), p(v), *tail)}
        for name, run in runs.items():
            cuda.check_error(name, run(rows_g, 1))
            hits = int((fields[1] >= 0).sum() if name == "bvh_shaded" else (ids >= 0).sum())
            out[f"{name} pink_room subdivisions={sub}"] = {
                "tris": bk.n_tris, "rays": n, "gbuffer_hits": hits,
                "ms": time_ms(lambda: cuda.check_error(name, run(rows_g, 1)), 10),
                "extension_ms": time_ms(lambda: cuda.check_error(name, run(rows_e, 0)), 10)}
        del bk, o_g, d_g, o_e, d_e, rows_g, rows_e
    return out


def any_hit_times(torch, pkg, dev) -> dict:
    """The BVH any-hit kernel on pink_room's shadow batch: `ms` its launch
    on the packed rays (as `chip_smoke.py` times it), `wrapper_ms` the
    wrapper's whole call.  The checkout's kernel takes the Baldwin-Weber
    rows and two-box table and a counter where its bake has the two-box
    table, else the pack and the threaded node table."""
    cluster, isect, cuda = pkg["cluster"], pkg["intersect"], pkg["cuda"]
    lib, stream, p = cuda.library(), cuda.stream(dev), cuda.ptr
    out = {}
    for sub in (3, 5):
        bk, shaded = _pink(pkg, dev, sub)
        _, _, (o, d, tmax) = k4_rays(bk, WIDTH, HEIGHT, dev, shaded)
        rows, _ = isect.rays(o, d, MIN_T, tmax)
        n = rows.shape[1]
        occ = torch.empty(n, dtype=torch.bool, device=dev)
        if getattr(bk, "bvh_pairs", None) is not None:
            tables = (bk.bw_rows, bk.n_tris, bk.bvh_pairs)
            counter = torch.empty(1, dtype=torch.int32, device=dev)
            args = (p(rows), n, p(bk.bw_rows), p(bk.bvh_pairs), p(occ), p(counter), stream)
        else:
            tables = (bk.tri_pack, bk.n_tris, bk.bvh_nodes)
            args = (p(rows), n, p(bk.tri_pack), p(bk.bvh_nodes), p(occ), stream)
        got = cluster.bvh_occluded(*tables, o, d, MIN_T, tmax)
        out[f"bvh_occluded pink_room subdivisions={sub}"] = {
            "tris": bk.n_tris, "rays": n, "live": int((tmax > 0).sum()),
            "occluded": int(got.sum()),
            "ms": time_ms(lambda: cuda.check_error("bvh_occluded",
                                                   lib.bdpt_bvh_occluded(*args)), 10),
            "wrapper_ms": time_ms(lambda: cluster.bvh_occluded(*tables, o, d, MIN_T, tmax), 10)}
        del bk, o, d, tmax, rows
    return out


def _cfg(pkg, **kw):
    return pkg["RenderConfig"](width=WIDTH, height=HEIGHT,
                               bdpt=pkg["BDPTConfig"](max_depth=DEPTH, **kw))


def _bake(pkg, dev, built):
    return pkg["Scene"].from_built(built, aspect=WIDTH / HEIGHT).bake(device=dev)


def k1_times(torch, pkg, dev) -> dict:
    """K1 on the Cornell box and K1's textured variant on the textured room."""
    frame_mod, procedural = pkg["frame"], pkg["procedural"]
    jitter = pkg["pixel_jitter_for_frame"](pkg["BDPT_FRAME_INIT"])
    takes_nodes = "nodes" in inspect.signature(frame_mod.frame_kernel).parameters
    out = {}
    for label, built, c, packed in (
            ("K1 Cornell", procedural.cornell_box(), _cfg(pkg), True),
            ("K1 textured", procedural.textured_room(), _cfg(pkg, defer_textures=True), False)):
        bk = _bake(pkg, dev, built)
        args = frame_mod.frame_args(bk, WIDTH, HEIGHT, pkg["BDPT_FRAME_INIT"], jitter, c,
                                    gbuf_frame=pkg["GBUF_FRAME_INIT"], splat_rgb8e=packed)
        extra = (bk.bvh_nodes,) if takes_nodes else ()
        out[label] = {"ms": time_ms(lambda: frame_mod.frame_kernel(
            args, bk.light_rows, bk.tri_pack, *extra), 10)}
    return out


def frame_times(torch, pkg, dev) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    procedural, Renderer = pkg["procedural"], pkg["Renderer"]
    cornell = _bake(pkg, dev, procedural.cornell_box())
    room = _bake(pkg, dev, procedural.textured_room())
    pink = _bake(pkg, dev, pkg["pink_room"](asset_dir=""))
    out = {}
    for label, bk, c in (("Cornell megakernel", cornell, _cfg(pkg)),
                         ("textured room deferred (auto)", room,
                          _cfg(pkg, defer_textures=True, splat_mode="auto")),
                         ("textured room deferred (tiled)", room,
                          _cfg(pkg, defer_textures=True, splat_mode="tiled")),
                         ("pink_room", pink, _cfg(pkg))):
        r = Renderer(bk, c)
        r.render(3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        r.render(10)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r.render(5)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = pkg["busy_us"]([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3 / 5
        out[label] = {"ms_per_frame": start.elapsed_time(end) / 10,
                      "host_ms_per_frame": host_ms, "device_busy_ms_per_frame": busy,
                      "device_idle_share": 1.0 - busy / host_ms,
                      "launches_per_frame": len(kern) / 5}
    return out


PARTS = {"splat": splat_times, "closest": closest_times, "any_hit": any_hit_times,
         "k1": k1_times, "frames": frame_times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="which of " + ", ".join(PARTS) + " to time (comma-separated)")
    a = ap.parse_args()
    root = Path(a.root).resolve()
    sys.path[0] = str(root)  # in place of this file's directory
    import torch

    if not torch.cuda.is_available():
        print("ab_times: no CUDA device", file=sys.stderr)
        return 1
    import fyp_bidirectionalpathtracer_tpu_torch as port

    if Path(port.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported the port from {port.__file__}, not from {root}")
    from fyp_bidirectionalpathtracer_tpu_torch import cuda
    from fyp_bidirectionalpathtracer_tpu_torch.accel import cluster, frame
    from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect
    from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
    from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room
    from fyp_bidirectionalpathtracer_tpu_torch.ops import splat_tile
    from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.frame_profile import _busy_us
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
        BDPT_FRAME_INIT,
        GBUF_FRAME_INIT,
        Renderer,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, RenderConfig

    pkg = dict(frame=frame, cluster=cluster, intersect=intersect, cuda=cuda,
               procedural=procedural, pink_room=pink_room,
               splat_tile=splat_tile, Scene=Scene,
               Renderer=Renderer, BDPTConfig=BDPTConfig, RenderConfig=RenderConfig,
               pixel_jitter_for_frame=pixel_jitter_for_frame, BDPT_FRAME_INIT=BDPT_FRAME_INIT,
               GBUF_FRAME_INIT=GBUF_FRAME_INIT, busy_us=_busy_us)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda.library()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"label": a.label, "root": str(root), "device": smi, "build_s": build_s}
    for part in a.parts.split(","):
        result.update(PARTS[part](torch, pkg, dev))
    text = json.dumps(result)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
