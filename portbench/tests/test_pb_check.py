"""The correctness check drives a whole run on the CPU at 48x27 (the look
for a card skipped): sound, it is correct; the control (the reference in
bfloat16) and each fault a cell can have, planted in the port's timed
path, come out not correct.  The faults: a step that returns its state
unchanged (the accumulation), half the estimator-2 splats left out and the
rest doubled (the mean over the rest), a frame's answer altered where it
is produced (K1's image, the wavefront's BDPT image), BMFR's output left
as its input, and the history BMFR writes left stale (its colour, or its
frame count).  One chip: no exchange between chips to leave out."""
from dataclasses import replace

import torch
import pytest

import calibrate
import check
import run
from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
from fyp_bidirectionalpathtracer_tpu_torch.ops import splat as splat_mod
from fyp_bidirectionalpathtracer_tpu_torch.passes import accumulate as accumulate_mod
from fyp_bidirectionalpathtracer_tpu_torch.passes import bmfr as bmfr_mod
from fyp_bidirectionalpathtracer_tpu_torch.pipeline import renderer as renderer_mod

SIZE = (48, 27)
SEED = 2**31 + 4099


def _run(workload, seconds=1.0):
    result, _ = run.run(workload, SEED, seconds, False, device="cpu", size=SIZE)
    return result


@pytest.mark.parametrize("workload", ["cornell.progressive", "cornell.interactive"])
def test_sound_runs_are_correct(workload):
    result = _run(workload)
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert list(result)[-1] == "check"
    assert {"frame_ms", "setup_s"} <= set(result["metrics"])


def test_the_control_fails_the_limits():
    summary = calibrate.calibrate("cornell.progressive", [SEED, SEED + 1], 1.0, device="cpu",
                                  size=SIZE)
    limits = check.load_limits("cornell.progressive")
    assert any(summary["control_min"][k] > limits[k] for k in limits)
    assert all(summary["sound_max"][k] <= limits[k] for k in limits)


def _unchanged_state(state, cur_frame, max_accum_count, reset=False):
    return state, state.last_frame


def _half_splats(mode, lin, rgb, alpha, n_targets, *args, _orig=splat_mod.scatter_add_rgba,
                 **kw):
    keep = torch.arange(lin.shape[0]) % 2 == 0
    lin = torch.where(keep, lin, torch.full_like(lin, -1))
    out = _orig(mode, lin, rgb * 2.0, alpha, n_targets, *args, **kw)
    out[:, 3] *= 2.0
    return out


def _altered_frame(*args, _orig=frame_mod.render_frame_megakernel, **kw):
    channels, img = _orig(*args, **kw)
    img = img.clone()
    img[..., :3] *= 1.02
    return channels, img


def _bmfr_identity(state, channels, camera, cfg, *, mesh=None):
    return state, channels["Accumulated"]


FAULTS = {
    "state_unchanged": (accumulate_mod, "accumulate", _unchanged_state, renderer_mod),
    "half_the_splats": (splat_mod, "scatter_add_rgba", _half_splats, None),
    "answer_altered": (frame_mod, "render_frame_megakernel", _altered_frame, renderer_mod),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_are_caught(fault, monkeypatch):
    module, name, fn, user = FAULTS[fault]
    monkeypatch.setattr(module, name, fn)
    if user is not None:
        monkeypatch.setattr(user, name, fn)
    result = _run("cornell.progressive")
    assert not result["correct"], result["check"]


def _stale_colour(state, channels, camera, cfg, *, mesh=None, _orig=bmfr_mod.bmfr_pass):
    new, out = _orig(state, channels, camera, cfg, mesh=mesh)
    return replace(new, prev_noisy=state.prev_noisy), out


def _stale_count(state, channels, camera, cfg, *, mesh=None, _orig=bmfr_mod.bmfr_pass):
    new, out = _orig(state, channels, camera, cfg, mesh=mesh)
    return replace(new, frame_number=state.frame_number), out


BMFR_FAULTS = {"left_out": _bmfr_identity, "history_colour_stale": _stale_colour,
               "history_count_stale": _stale_count}


@pytest.mark.parametrize("fault", sorted(BMFR_FAULTS))
def test_bmfr_faults_are_caught(fault, monkeypatch):
    monkeypatch.setattr(renderer_mod, "bmfr_pass", BMFR_FAULTS[fault])
    result = _run("cornell.interactive")
    assert not result["correct"], result["check"]


def test_the_history_s_sample_count_is_compared_relative_to_itself():
    from types import SimpleNamespace

    from reference.bmfr import History

    z = torch.zeros((2, 3, 4), dtype=torch.float64)
    noisy = z.clone()
    noisy[..., 3] = 1000.0
    want = History(pos=z, norm=z, noisy=noisy, filtered=z, frame=5)
    count_off = noisy.clone()
    count_off[0, 0, 3] += 0.01          # 1e-5 of the count: rounding
    colour_off = noisy.clone()
    colour_off[0, 0, 0] += 0.01         # an absolute 1e-2 in a colour
    for moved, off in ((count_off, 0.0), (colour_off, 1 / 6)):
        got = SimpleNamespace(prev_noisy=moved, prev_pos=z, prev_norm=z)
        assert check.history_numbers(got, want)[0] == pytest.approx(off)
