"""Whether what the timed path produced is correct.

During the window the harness keeps, for a sample of frames drawn from the
seed, the port's outputs of that frame (`Snapshot`).  After the window,
with the port's state freed, `compare` renders each sampled frame again
with the plain reference (`reference/`) from the configuration's scene,
poses and frame index, and compares:

- `accum_px`, `accum_mad`: the `Accumulated` channel (the frame program,
  the estimator-2 splat, the accumulation): the share of pixels whose
  largest channel differs by more than 1e-3, and the mean absolute
  difference, the worst over the frames;
- where BMFR runs, `out_mad`: the mean absolute difference of
  `PipelineOutput` (BMFR's preprocess, fit and postprocess; its share of
  pixels off is no number to compare: the port's float32 QR departs from
  the exact fit by more than 1e-3 on 7-10% of the pixels of a sound run,
  within 2.2x of the control's share), and `hist_px`, `hist_mad`:
  the same of the history the frame leaves (its preprocessed colour,
  position and normal, and its sample count relative to the count: the
  count grows by one a frame along the walk, to some thousands in a window,
  so float rounding of the taps' weights moves it by more than 1e-3 in
  absolute terms; a frame count other than the reference's counts as every
  pixel off).  A sampled frame's BMFR starts from the port's own
  history before it, which the port's earlier frames made: the reference
  could only follow those step by step.  So each sampled frame's written
  history is compared too, and the run's first frame, from fresh history,
  is always among the sampled ones.

A tie on a triangle's edge, decided otherwise by float32 rounding, sends a
path elsewhere and changes its pixel wholly; so the numbers are shares and
means, and each has a limit of its own (`limits/<workload>.json`), set
between the sound runs' largest reading and the control's least.
`control=True` puts the reference computed in bfloat16 in the port's place
(`reference.render.control`).
"""
from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PX_TOL = 1e-3


@dataclass
class Snapshot:
    run_frame: int            # the run's frame number (warm-up frames first)
    view_start: int           # the run frame of its view's first frame
    accumulated: torch.Tensor
    output: torch.Tensor | None = None      # PipelineOutput, where BMFR runs
    bmfr_before: object = None              # the port's BMFRState before it
    bmfr_after: object = None               # and after it


def load_limits(workload: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)


def image_numbers(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(share of pixels off by more than PX_TOL in a channel, mean |diff|);
    NaN counts as off, and as 1 in the mean."""
    d = (got.to(want.device, want.dtype) - want).abs()
    d = torch.nan_to_num(d, nan=1.0, posinf=1.0)
    return float((d.amax(-1) > PX_TOL).float().mean()), float(d.mean())


def history_numbers(got, want) -> tuple[float, float]:
    """`image_numbers` of BMFR's written history: colour, position and
    normal absolute, the sample count (prev_noisy's alpha) relative to
    max(count, 1); a pixel is off where any of them is."""
    d = torch.cat([(got.prev_noisy[..., :3].to(want.noisy) - want.noisy[..., :3]).abs(),
                   ((got.prev_noisy[..., 3:].to(want.noisy) - want.noisy[..., 3:]).abs()
                    / want.noisy[..., 3:].abs().clamp(min=1.0)),
                   (got.prev_pos.to(want.pos) - want.pos).abs(),
                   (got.prev_norm.to(want.norm) - want.norm).abs()], -1)
    d = torch.nan_to_num(d, nan=1.0, posinf=1.0)
    return float((d.amax(-1) > PX_TOL).float().mean()), float(d.mean())


def history_of(state, device, dtype):
    """The port's BMFRState as the reference's History."""
    from reference.bmfr import History

    def t(x):
        return x.to(device, dtype)
    return History(pos=t(state.prev_pos), norm=t(state.prev_norm), noisy=t(state.prev_noisy),
                   filtered=t(state.prev_filtered), frame=int(state.frame_number))


def compare(snapshots, cfg: dict, plan, scene_arrays, device,
            control: bool = False) -> tuple[dict, list[dict]]:
    """(the worst numbers over the snapshots, each snapshot's numbers)."""
    from reference import render
    from reference.scene import Scene

    dt = torch.float64
    scene = Scene.of(scene_arrays, device, dt)
    numbers: dict[str, float] = {}
    per_frame = []
    for snap in snapshots:
        poses = [plan.pose(i) for i in range(snap.view_start, snap.run_frame + 1)]
        denoise = snap.output is not None
        hist = (history_of(snap.bmfr_before, device, dt)
                if snap.bmfr_before is not None else None)
        with torch.no_grad(), (render.control() if control else contextlib.nullcontext()):
            ch = render.frames(scene, scene_arrays["camera"], cfg, poses,
                               plan.first_index + snap.view_start, hist, denoise)
        px, mad = image_numbers(snap.accumulated, ch["Accumulated"])
        found = {"accum_px": px, "accum_mad": mad}
        if denoise:
            found["out_mad"] = image_numbers(snap.output, ch["PipelineOutput"])[1]
            want, got = ch["history"], snap.bmfr_after
            found["hist_px"], found["hist_mad"] = history_numbers(got, want)
            if int(got.frame_number) != want.frame:
                found["hist_px"] = 1.0
        for k, v in found.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        per_frame.append(found)
        del ch
    return numbers, per_frame


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number without a limit, or a limit without a number, is not correct."""
    report = {k: {"value": numbers.get(k), "limit": limits.get(k)}
              for k in sorted(set(numbers) | set(limits))}
    ok = all(v["value"] is not None and v["limit"] is not None and v["value"] <= v["limit"]
             for v in report.values())
    return ok, report
