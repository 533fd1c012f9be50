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
- `device_busy_ms_per_frame`: the union of the device operations' intervals
  in a `torch.profiler` trace of the profiled frames, per frame (the spans'
  ranges on the device's timeline are none, `device_operations`);
  `device_idle_share` is 1 - busy / the unprofiled host-clock frame time
  (the profiler slows the host, not the kernels);
- `kernels_ms_per_frame`: device time per frame by kernel name, and
  `kernel_launches_per_frame` the number of CUDA kernels a frame runs;
- `stages_ms`: the self time of each `utils/profiler` span (its host-clock
  ms less its child spans'), by path, ms a frame over `--repeats` frames of
  `Renderer.render_frame_profiled`, whose six pass events wait for the
  device (attribution only: the waits serialise what overlaps in a real
  frame); with `--bmfr` BMFR's three stages are among them.

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

from ..accel.frame import supports_megakernel
from ..models.pink_room import pink_room
from ..models.procedural import cornell_box, textured_room
from ..scene.scene import Scene
from ..utils.config import BDPTConfig, BMFRConfig, RenderConfig
from ..utils.profiler import Profiler
from .renderer import Renderer

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


def stage_self_ms(r: Renderer, frames: int) -> dict:
    """The spans' self ms a frame, by path, over `frames` frames of
    `render_frame_profiled` (`{}` for none; the `frame` event waits for
    each frame's device work)."""
    prof = Profiler()
    for _ in range(frames):
        r.render_frame_profiled(prof)
    return {key: ev["self_ms"] * ev["count"] / frames
            for key, ev in sorted(prof.as_dict().items())}


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


def device_operations(events) -> list:
    """The device operations among a torch.profiler trace's events: its
    CUDA events less the device timeline's copies of `record_function`
    ranges (user annotations, such as the port's spans), which are no
    operations."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_calls(fn, calls: int):
    """`calls` calls of `fn` on a CUDA device under torch.profiler: (host
    ms a call with a device sync before and after, device busy ms a call
    (the union of the device operations' intervals), device operations a
    call, device ms a call by kernel name, the profiler)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_ms, _ = _timed(lambda: [fn() for _ in range(calls)])
    kernels = device_operations(prof.events())
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
    stages = stage_self_ms(r, repeats)
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
