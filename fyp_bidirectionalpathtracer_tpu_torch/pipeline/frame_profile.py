"""Where the main path's frame time goes on a CUDA device.

    python -m fyp_bidirectionalpathtracer_tpu_torch.pipeline.frame_profile \
        [--scene cornell|pink_room|textured] [--megakernel auto|off]
        [--defer-textures] [--bmfr] [--frames 5] [--repeats 2]
        [--out PATH.json] [--trace PATH.json]

Renders a scene at 1280x720, depth 3, BMFR off (`--bmfr`: on, every stage,
full screen, as `chip_smoke.py` phase 5e), default config otherwise (the
frames that `chip_smoke.py` times) through `Renderer`: the Cornell box
on the megakernel path (`auto`) or the per-bounce wavefront (`off`);
pink_room (`models/pink_room.pink_room(asset_dir="")`, 10,546 triangles,
procedural textures), which the megakernel gate sends to the wavefront and
its BVH kernels; or the textured room (`models/procedural.textured_room`,
342 triangles, two base-colour textures), which takes the wavefront by
default and, with `--defer-textures` (`BDPTConfig(defer_textures=True)`),
the deferred-texture megakernel: K1's textured variant, the replay and the
splat.  Prints one JSON object:

- `device`: the card's name and power limit as nvidia-smi prints them;
- `ms_per_frame_host`: host-clock ms per frame of `--frames` frames, with a
  device sync before and after them, without the profiler and (`_profiled`)
  under it;
- `device_busy_ms_per_frame`: the union of the CUDA kernels' intervals in a
  `torch.profiler` trace of the profiled frames, per frame;
  `device_idle_share` is 1 - busy / the unprofiled host-clock frame time
  (the profiler slows the host, not the kernels);
- `kernels_ms_per_frame`: device time per frame by kernel name, and
  `kernel_launches_per_frame` the number of CUDA kernels a frame runs;
- `stages_ms`: host-clock ms of each stage of one frame with a device sync
  after it (attribution only: the syncs serialise what overlaps in a real
  frame), once per repeat; with `--bmfr` the BMFR pass is one of them.

`--out` also writes the JSON to a file, `--trace` the Chrome trace.
`profile_renderer` does the same for any `Renderer` (chip_smoke.py's
phase 6 profiles its alpha, env-map and normal-map frames with it), and
`profile_calls` for any function (phase 8c's output passes).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

from ..accel.frame import (
    frame_args,
    frame_kernel,
    is_textured,
    supports_megakernel,
    textured_replay,
)
from ..models.pink_room import pink_room
from ..models.procedural import cornell_box, textured_room
from ..ops.shading import make_shaded_tracer
from ..ops.splat import scatter_add_rgba, scatter_add_rgba_prepacked
from ..passes.bdpt import bdpt_pass
from ..passes.bmfr import bmfr_pass
from ..passes.gbuffer import pixel_jitter_for_frame, ray_traced_gbuffer
from ..scene.camera import begin_frame
from ..scene.scene import Scene
from ..utils.config import BDPTConfig, BMFRConfig, RenderConfig
from .renderer import BDPT_FRAME_INIT, GBUF_FRAME_INIT, Renderer

WIDTH, HEIGHT, DEPTH = 1280, 720, 3


def _timed(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def stage_times(renderer: Renderer) -> dict:
    """One frame, stage by stage, with a sync after each stage."""
    cfg, r = renderer.cfg, renderer
    scene = r.baked.with_camera(r.camera)
    frame = (BDPT_FRAME_INIT + r.state.frame_index) & 0xFFFFFFFF
    jitter = pixel_jitter_for_frame(frame)
    out = {}
    if cfg.bdpt.megakernel == "off" or not supports_megakernel(scene, cfg):
        trace = make_shaded_tracer(scene, bounce_tex_mean=cfg.bdpt.bounce_tex_mean)
        out["G-buffer (ray_traced_gbuffer, one shaded launch)"], ch = _timed(
            lambda: ray_traced_gbuffer(scene, trace, cfg.width, cfg.height,
                                       GBUF_FRAME_INIT, jitter))
        out["bdpt_pass (5 shaded + 3 any-hit launches, splat chain)"], _ = _timed(
            lambda: bdpt_pass(scene, scene.intersector(), ch, frame, jitter, cfg.bdpt,
                              trace=trace))
    else:
        textured = is_textured(scene)
        out["frame_args (host)"], args = _timed(lambda: frame_args(
            scene, cfg.width, cfg.height, frame, jitter, cfg,
            gbuf_frame=GBUF_FRAME_INIT, splat_rgb8e=not textured))
        out["K1 frame_kernel" + (" (textured)" if textured else "")], fo = _timed(
            lambda: frame_kernel(args, scene.light_rows, scene.tri_pack, scene.bvh_nodes))
        if textured:
            out["textured_replay (taps, ratios, accumulation)"], rep = _timed(
                lambda: textured_replay(fo, cfg.bdpt, scene.atlas))
            out[f"splat ({cfg.bdpt.splat_mode})"], _ = _timed(lambda: scatter_add_rgba(
                cfg.bdpt.splat_mode, *(torch.cat(x) for x in zip(*rep[1])), args.n_pix,
                alpha_is_count=True))
        else:
            out["splat chain (K2 + live-count sync + sort + K3)"], _ = _timed(
                lambda: scatter_add_rgba_prepacked(fo.splat_pix.reshape(-1),
                                                   fo.splat_pay.reshape(-1), args.n_pix))
    if cfg.bmfr.enabled:
        out["bmfr_pass (preprocess, regression, postprocess)"], _ = _timed(
            lambda: bmfr_pass(r.state.bmfr, r.channels, r.camera, cfg.bmfr))
    out["begin_frame (camera update)"], _ = _timed(lambda: begin_frame(r.camera))
    out["whole render_frame"], _ = _timed(r.render_frame)
    return out


SCENES = {"cornell": cornell_box, "pink_room": lambda: pink_room(asset_dir=""),
          "textured": textured_room}


def profile(frames: int = 5, repeats: int = 2, trace: str | None = None,
            megakernel: str = "auto", scene: str = "cornell",
            defer_textures: bool = False, bmfr: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("frame_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    baked = Scene.from_built(SCENES[scene](), aspect=WIDTH / HEIGHT).bake(device=dev)
    # bench.py's BMFR cell: every stage, the full screen
    bmfr_cfg = (BMFRConfig(enabled=True, regression=True, half_screen_debug=False) if bmfr
                else BMFRConfig())
    r = Renderer(baked, RenderConfig(width=WIDTH, height=HEIGHT, bmfr=bmfr_cfg,
                                     bdpt=BDPTConfig(max_depth=DEPTH, megakernel=megakernel,
                                                     defer_textures=defer_textures)))
    return {"scene": scene, "megakernel": megakernel, "defer_textures": defer_textures,
            "bmfr": bmfr, **profile_renderer(r, frames, repeats, trace)}


def profile_calls(fn, calls: int):
    """`calls` calls of `fn` on a CUDA device under torch.profiler: (host
    ms a call with a device sync before and after, device busy ms a call
    (the union of the CUDA kernels' intervals), device operations a call,
    device ms a call by kernel name, the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_ms, _ = _timed(lambda: [fn() for _ in range(calls)])
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / calls
    return (host_ms / calls, busy, len(kernels) / calls,
            dict(sorted(by_name.items(), key=lambda kv: -kv[1])), prof)


def profile_renderer(r: Renderer, frames: int = 5, repeats: int = 2,
                     trace: str | None = None) -> dict:
    """The measurements of `profile` (all its keys but the options) for the
    renderer `r` on a CUDA device."""
    r.render(3)  # warm-up: kernel build, allocator, first-call costs
    plain_ms, _ = _timed(lambda: r.render(frames))
    # before the profiler: CUPTI slows every launch after it has traced
    stages = [stage_times(r) for _ in range(repeats)]
    host_ms, busy, launches, by_name, prof = profile_calls(r.render_frame, frames)
    if trace:
        prof.export_chrome_trace(trace)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    return {
        "device": smi,
        "triangles": r.baked.n_tris,
        "path": "megakernel" if (r.cfg.bdpt.megakernel != "off"
                                 and supports_megakernel(r.baked, r.cfg)) else "wavefront",
        "frames": frames,
        "ms_per_frame_host": plain_ms / frames,
        "ms_per_frame_host_profiled": host_ms,
        "device_busy_ms_per_frame": busy,
        "device_idle_share": 1.0 - busy / (plain_ms / frames),
        "kernel_launches_per_frame": launches,
        "kernels_ms_per_frame": by_name,
        "stages_ms": stages,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=tuple(SCENES), default="cornell")
    ap.add_argument("--megakernel", choices=("auto", "off"), default="auto")
    ap.add_argument("--defer-textures", action="store_true",
                    help="BDPTConfig(defer_textures=True): the textured room takes the "
                         "deferred-texture megakernel")
    ap.add_argument("--bmfr", action="store_true",
                    help="BMFRConfig(enabled=True, regression=True, half_screen_debug=False): "
                         "the denoiser's three stages after accumulation")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--trace")
    a = ap.parse_args()
    result = profile(a.frames, a.repeats, a.trace, a.megakernel, a.scene, a.defer_textures,
                     a.bmfr)
    text = json.dumps(result, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
