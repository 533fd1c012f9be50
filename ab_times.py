"""Kernel and frame times of one checkout of the port, for parent/change pairs.

    python3 ab_times.py --root DIR [--label NAME] [--out PATH.json]

Imports `fyp_bidirectionalpathtracer_tpu_torch` from the checkout at `--root`
(this file's own checkout by default), builds that checkout's kernels into
its own `build/torch_kernels/`, and times on the CUDA device at 1280x720,
depth 3, with `chip_smoke.py`'s timers (this file's checkout's):

- K5 (`splat_reduce_rows`) on U = 2,764,800 sorted updates, 15% live, as
  `chip_smoke.py` phase 3b makes them (float32 rgb + count, float32 4 rows,
  bfloat16 4 rows), beside `index_add_` of the live rows and the bytes
  bound; K3 (`splat_reduce`) on the live prefix beside its `index_add_`.
  As in `chip_smoke.py`'s kernels line, `ms` and `library_ms` are eager
  calls, `graph_ms` and `library_graph_ms` 20 calls replayed from one CUDA
  graph, which leaves out the host's cost of each call;
- K1 on the Cornell box and K1's textured variant on the textured room
  (`defer_textures`), as `chip_smoke.py` phases 4 and 4f call them;
- frames through `Renderer`: the Cornell megakernel path and the deferred
  textured room with splat mode "auto" and "tiled": device ms/frame (CUDA
  events around 10 frames after 3 warm-up frames), host ms/frame, and the
  device busy time a frame (the union of the kernels' intervals in a
  `torch.profiler` trace of 5 frames, by the checkout's `frame_profile`)
  with the idle share it leaves.

Prints one JSON object (and writes it to `--out`).  Run it on parent and
change in turns in one call (parent, change, change, parent), each checkout
unpacked from `git archive` into a directory that `.gitignore` lists, so the
two are compared on one card.  The frame entry point it calls is the
checkout's own: `frame_kernel` takes the BVH node table where its signature
asks for it.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import bound, time_graph_ms, time_ms

WIDTH, HEIGHT, DEPTH = 1280, 720, 3
LIVE_FRAC = 0.15


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
        "bound_ms": bound(8.0 * n_live + 16.0 * n_pix, 0.0)["bound_ms"]}
    return out


def frame_times(torch, pkg, dev) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame_mod, procedural = pkg["frame"], pkg["procedural"]
    Scene, Renderer = pkg["Scene"], pkg["Renderer"]
    BDPTConfig, RenderConfig = pkg["BDPTConfig"], pkg["RenderConfig"]
    jitter = pkg["pixel_jitter_for_frame"](pkg["BDPT_FRAME_INIT"])
    takes_nodes = "nodes" in inspect.signature(frame_mod.frame_kernel).parameters

    def cfg(**kw):
        return RenderConfig(width=WIDTH, height=HEIGHT, bdpt=BDPTConfig(max_depth=DEPTH, **kw))

    def bake(built):
        return Scene.from_built(built, aspect=WIDTH / HEIGHT).bake(device=dev)

    cornell, room = bake(procedural.cornell_box()), bake(procedural.textured_room())
    out = {}
    for label, bk, c, packed in (("K1 Cornell", cornell, cfg(), True),
                                 ("K1 textured", room, cfg(defer_textures=True), False)):
        args = frame_mod.frame_args(bk, WIDTH, HEIGHT, pkg["BDPT_FRAME_INIT"], jitter, c,
                                    gbuf_frame=pkg["GBUF_FRAME_INIT"], splat_rgb8e=packed)
        extra = (bk.bvh_nodes,) if takes_nodes else ()
        out[label] = {"ms": time_ms(lambda: frame_mod.frame_kernel(
            args, bk.light_rows, bk.tri_pack, *extra), 10)}
    for label, bk, c in (("Cornell megakernel", cornell, cfg()),
                         ("textured room deferred (auto)", room,
                          cfg(defer_textures=True, splat_mode="auto")),
                         ("textured room deferred (tiled)", room,
                          cfg(defer_textures=True, splat_mode="tiled"))):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
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
    from fyp_bidirectionalpathtracer_tpu_torch.accel import frame
    from fyp_bidirectionalpathtracer_tpu_torch.models import procedural
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

    pkg = dict(frame=frame, procedural=procedural, splat_tile=splat_tile, Scene=Scene,
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
    result = {"label": a.label, "root": str(root), "device": smi, "build_s": build_s,
              **splat_times(torch, pkg, dev), **frame_times(torch, pkg, dev)}
    text = json.dumps(result)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
