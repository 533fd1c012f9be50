"""The port's BMFR denoiser (`passes/bmfr.py`) against the JAX package's on
the CPU, and its behaviour on its own.

Inputs come from numpy seeds, or from the port's CPU render of the Cornell
box (BMFR off) carried to JAX as numpy arrays.  Tolerances:

- bit for bit: `_mirror`, the window's symmetric addressing against
  `jnp.pad(mode="symmetric")`, `_hash_random`, `_qr_noise_pattern`, the
  bf16 history pack, the 2x2 tap fetch, the feature tensor and the
  normalized features (elementwise IEEE operations on both sides);
- `preprocess` (f32 and bf16 packs) and `postprocess`: atol 1e-5, the
  accept bits equal, with a camera that moved between frames (85-98% of
  the pixels accept a tap);
- `regression` and `bmfr_pass`: at most 0.1% of the pixels differ by more
  than 1e-3 (sums of 1,024 products run in another order), and every
  block accepts the same feature columns.  Worst difference measured:
  5.3e-4 (normal equations, add-noise, the seeded plane); QR 2.0e-4 (LD
  skip, rendered channels);
- the normal-equations LD skip on rendered channels: its skip test of a
  column that depends on earlier ones up to rounding compares
  sqrt(G[c,c] - sum R[k,c]^2), a difference of sums of ~1e3 whose rounding
  is ~1e-4, with 0.01; there the decision follows the summation order, so
  the port (torch's sums) and JAX (XLA's dot) may accept different columns
  in such blocks, and on rendered channels JAX's own normal fit departs
  from its QR fit by more than 1e-3 in 1-7 of 9 blocks a frame.  The
  blocks where neither happens are held to atol 5e-3, the JAX package's
  bound between its two solvers (tests/test_bmfr.py::
  test_normal_eq_solver_matches_qr); worst measured there 3.5e-3;
- the Cornell golden with BMFR: >= 38 dB, the JAX package's bar.
"""
import os
import types
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.passes import bmfr as jbmfr
from fyp_bidirectionalpathtracer_tpu.utils.config import BMFRConfig as JBMFRConfig
from fyp_bidirectionalpathtracer_tpu.utils.image import psnr, read_png, to_u8
from fyp_bidirectionalpathtracer_tpu.utils.testing import GOLDEN_DIR
from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.passes import bmfr
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BMFRConfig, RenderConfig
from torch_threads import one_intra_op_thread  # noqa: F401

KEYS = ("WorldPosition", "WorldNormal", "MaterialDiffuse", "Accumulated")
STATE_FIELDS = ("prev_pos", "prev_norm", "prev_noisy", "prev_filtered", "frame_number")
MIN_PSNR = 38.0          # the JAX package's golden bar
ATOL = 1e-5              # preprocess, postprocess
PIX_TOL, PIX_SHARE = 1e-3, 1e-3   # regression: share of pixels beyond PIX_TOL
NORMAL_ATOL = 5e-3       # normal-equations fit, blocks with the same columns


def _render(w, h, n):
    """n frames of the port's CPU render (BMFR off), the channels as numpy,
    and the camera's view-projection."""
    r = Renderer(Scene.from_built(cornell_box(), aspect=w / h).bake(device="cpu"),
                 RenderConfig(width=w, height=h))
    frames = []
    for _ in range(n):
        r.render_frame()
        frames.append({k: r.channels[k].numpy().copy() for k in KEYS})
    return frames, r.camera.view_proj.numpy()


@pytest.fixture(scope="module")
def cornell64():
    return _render(64, 64, 6)


@pytest.fixture(scope="module")
def cornell64x40():
    return _render(64, 40, 1)


def _moved(vp, k):
    """The view-projection of a camera that moved k steps (clip-space
    shift): the history's taps land partly on other surfaces."""
    pvp = np.array(vp, np.float32)
    pvp[0, 3] += 0.03 * k
    pvp[1, 3] -= 0.015 * k
    return pvp


def _pixel_stats(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    return float(d.max()), float((d > PIX_TOL).mean())


def _jax_state(ch_prev, frame, filtered_scale=0.9):
    return jbmfr.BMFRState.create(*ch_prev["Accumulated"].shape[:2]).replace(
        prev_pos=jnp.asarray(ch_prev["WorldPosition"]),
        prev_norm=jnp.asarray(ch_prev["WorldNormal"]),
        prev_noisy=jnp.asarray(ch_prev["Accumulated"]),
        prev_filtered=jnp.asarray(ch_prev["Accumulated"] * filtered_scale),
        frame_number=jnp.int32(frame))


def _port_state(jstate):
    return bmfr.BMFRState.from_arrays({f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS},
                                      device="cpu")


# ------------------------------------------------------------ bit for bit
def test_constants_equal_jax():
    assert (bmfr.BLOCK_EDGE, bmfr.BLOCK_PIXELS, bmfr.FEATURES, bmfr.BUFFERS,
            bmfr.FEATURES_NOT_SCALED, bmfr._PAD_L, bmfr._PAD_R) == (
        jbmfr.BLOCK_EDGE, jbmfr.BLOCK_PIXELS, jbmfr.FEATURES, jbmfr.BUFFERS,
        jbmfr.FEATURES_NOT_SCALED, jbmfr._PAD_L, jbmfr._PAD_R)
    np.testing.assert_array_equal(np.asarray(bmfr.BLOCK_OFFSETS),
                                  np.asarray(jbmfr.BLOCK_OFFSETS))


def test_mirror_bit_equal():
    idx = np.arange(-70, 140, dtype=np.int32)
    for n in (40, 64, 70):
        np.testing.assert_array_equal(bmfr._mirror(torch.tensor(idx), n).numpy(),
                                      np.asarray(jbmfr._mirror(jnp.asarray(idx), n)))


@pytest.mark.parametrize("n", [20, 40, 64, 720])
def test_symmetric_equals_jnp_pad(n):
    """The window's addressing is jnp.pad's symmetric padding over the
    whole reach [-_PAD_L, n + _PAD_R), also where it reflects more than
    once (n < 64)."""
    want = np.asarray(jnp.pad(jnp.arange(n), (bmfr._PAD_L, bmfr._PAD_R), mode="symmetric"))
    got = bmfr._symmetric(torch.arange(-bmfr._PAD_L, n + bmfr._PAD_R), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_random_bit_equal():
    a = np.random.RandomState(3).randint(-2 ** 31, 2 ** 31 - 1, 200_000).astype(np.int32)
    got = bmfr._hash_random(torch.tensor(a)).numpy()
    want = np.asarray(jbmfr._hash_random(jnp.asarray(a)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("frame", [0, 7, 2 ** 20 + 3])
def test_qr_noise_pattern_bit_equal(frame):
    got = bmfr._qr_noise_pattern(torch.tensor(frame, dtype=torch.int32), 0.01).numpy()
    want = np.asarray(jbmfr._qr_noise_pattern(jnp.int32(frame), 0.01))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_history_bf16_pack_bit_equal():
    rs = np.random.RandomState(4)
    hist = (rs.randn(5, 6, 13) * 3).astype(np.float32)
    packed = bmfr._pack_hist_bf16(torch.tensor(hist))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jbmfr._pack_hist_bf16(jnp.asarray(hist))))
    taps_i = rs.randint(-2 ** 31, 2 ** 31 - 1, (5, 6, 28)).astype(np.int32)
    for got, want in zip(bmfr._unpack_hist_bf16(torch.tensor(taps_i)),
                         jbmfr._unpack_hist_bf16(jnp.asarray(taps_i))):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_gather_2x2_bit_equal():
    """One gather of the four edge-clamped taps is JAX's 2x2 pack + gather,
    bases off the image on every side included."""
    rs = np.random.RandomState(5)
    h, w = 9, 13
    img = rs.rand(h, w, 3).astype(np.float32)
    base = np.stack([rs.randint(-4, w + 4, (7, 11)), rs.randint(-4, h + 4, (7, 11))],
                    -1).astype(np.int32)
    want = np.asarray(jbmfr._gather_2x2(jbmfr._pack_2x2(jnp.asarray(img)),
                                        jnp.asarray(base), h, w))
    np.testing.assert_array_equal(bmfr._gather_2x2(torch.tensor(img), torch.tensor(base)).numpy(),
                                  want)


def _jax_window_features(ch, frame, half_screen=False):
    """JAX's feature build: symmetric pad, dynamic slice, blocks."""
    h, w = ch["Accumulated"].shape[:2]
    n_bx = (w + 31) // 32 + 1
    if half_screen:
        n_bx //= 2
    n_by = (h + 31) // 32 + 1
    off = jbmfr.BLOCK_OFFSETS[jnp.int32(frame) % 16]
    tab = jnp.concatenate([jnp.asarray(ch[k])[..., :3] for k in KEYS], -1)
    padded = jnp.pad(tab, ((jbmfr._PAD_L, jbmfr._PAD_R), (jbmfr._PAD_L, jbmfr._PAD_R), (0, 0)),
                     mode="symmetric")
    win = jax.lax.dynamic_slice(padded, (jbmfr._PAD_L + off[1], jbmfr._PAD_L + off[0], 0),
                                (n_by * 32, n_bx * 32, 12))
    feats, alb = jbmfr._features_from_window(win, n_by, n_bx)
    return feats, alb, jbmfr._normalize_features(feats), (win, n_by, n_bx)


def _port_window_rows(ch, frame, half_screen=False):
    h, w = ch["Accumulated"].shape[:2]
    n_bx = (w + 31) // 32 + 1
    if half_screen:
        n_bx //= 2
    n_by = (h + 31) // 32 + 1
    off = torch.tensor(bmfr.BLOCK_OFFSETS[frame % 16])
    tab = torch.cat([torch.tensor(ch[k])[..., :3] for k in KEYS], -1).reshape(-1, 12)
    return tab[bmfr._window_index(h, w, n_by, n_bx, off)]


@pytest.mark.parametrize("frame", [0, 3, 9, 15])
@pytest.mark.parametrize("size", ["64x64", "64x40"])
def test_features_bit_equal(frame, size, cornell64, cornell64x40):
    """The feature tensor and the normalized features, every block (at 64x40
    the window reaches past one reflection: rows 62-93 for off_y = -2)."""
    ch = cornell64[0][2] if size == "64x64" else cornell64x40[0][0]
    jf, jalb, jx, _ = _jax_window_features(ch, frame)
    feats, alb = bmfr._features_from_window(_port_window_rows(ch, frame))
    for got, want in ((feats, jf), (alb, jalb), (bmfr._normalize_features(feats), jx)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


# ------------------------------------------------------ within tolerances
def test_state_from_arrays_carries_jax_state(cornell64):
    js = _jax_state(cornell64[0][0], 5)
    ps = _port_state(js)
    for f in STATE_FIELDS:
        got = getattr(ps, f)
        assert got.device.type == "cpu" and got.dtype == (
            torch.int32 if f == "frame_number" else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(js, f)))


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("pack", ["f32", "bf16"])
def test_preprocess_postprocess_match_jax(pack, half, cornell64):
    frames, vp = cornell64
    js = _jax_state(frames[0], 1)
    ps = _port_state(js)
    ch, pvp = frames[1], _moved(vp, 1)
    jcfg, pcfg = JBMFRConfig(half_screen_debug=half), BMFRConfig(half_screen_debug=half)
    jout = jbmfr.preprocess(js, *(jnp.asarray(ch[k]) for k in ("WorldPosition", "WorldNormal",
                                                                "Accumulated")),
                            jnp.asarray(pvp), jcfg, pack=pack)
    pout = bmfr.preprocess(ps, *(torch.tensor(ch[k]) for k in ("WorldPosition", "WorldNormal",
                                                               "Accumulated")),
                           torch.tensor(pvp), pcfg, pack=pack)
    accept = np.asarray(jout[1])
    assert 0.5 < (accept > 0).mean() < 0.99 and (accept == 15).mean() < 0.9
    np.testing.assert_array_equal(pout[1].numpy(), accept)
    for i in (0, 2):
        np.testing.assert_allclose(pout[i].numpy(), np.asarray(jout[i]), atol=ATOL, rtol=0)
    assert (pout[3] is None) == (jout[3] is None) == (pack == "f32")
    if pack == "bf16":
        np.testing.assert_allclose(pout[3].numpy(), np.asarray(jout[3]), atol=ATOL, rtol=0)
    jpost = jbmfr.postprocess(js, jout[0], jout[1], jout[2], jcfg, taps=jout[3])
    ppost = bmfr.postprocess(ps, pout[0], pout[1], pout[2], pcfg, taps=pout[3])
    np.testing.assert_allclose(ppost.numpy(), np.asarray(jpost), atol=ATOL, rtol=0)


def _plane_channels(h, w, seed):
    """A seeded plane z = 1 seen in clip space (test_bmfr's scene), normals
    exactly (0, 0, -1): the LD skip drops the normal and depth columns
    exactly; random albedo (some under the 0.01 gate) and noisy colour."""
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = (xs + 0.5) / w * 2 - 1
    v = 1 - (ys + 0.5) / h * 2
    one = np.ones_like(u)
    pos = np.stack([u, v, one, one], -1).astype(np.float32)
    norm = np.zeros((h, w, 4), np.float32)
    norm[..., 2] = -1.0
    albedo = rs.uniform(0.0, 0.9, (h, w, 4)).astype(np.float32)
    color = np.stack([0.3 + 0.2 * u, 0.5 - 0.1 * v, 0.4 + 0.05 * (u + v)], -1)
    noisy = np.clip(color + rs.normal(0, 0.25, color.shape), 0, None)
    noisy4 = np.concatenate([noisy, one[..., None]], -1).astype(np.float32)
    return dict(zip(KEYS, (pos, norm, albedo, noisy4)))


def _random_channels(h, w, seed):
    """Seeded uniform G-buffer: every column independent, none skipped."""
    rs = np.random.RandomState(seed)
    return {k: rs.rand(h, w, 4).astype(np.float32) for k in KEYS}


def _accepted(wts):
    """[B, 10] which feature columns a block kept (a skipped one weighs 0)."""
    return (np.asarray(wts) != 0.0).any(-1)


def _solver_pair(solver, ld, frame):
    if ld:
        return ((jbmfr._householder_qr_skip_ld, bmfr._householder_qr_skip_ld) if solver == "qr"
                else (jbmfr._normal_eq_skip_ld, bmfr._normal_eq_skip_ld))
    jfn, pfn = ((jbmfr._householder_qr_noise, bmfr._householder_qr_noise) if solver == "qr"
                else (jbmfr._normal_eq_noise, bmfr._normal_eq_noise))
    return (lambda x: jfn(x, jnp.int32(frame), 0.01),
            lambda x: pfn(x, torch.tensor(frame, dtype=torch.int32), 0.01))


def _check_regression(ch, frame, solver, ld, half):
    kw = dict(regression_solver=solver, remove_ld_features=ld, half_screen_debug=half)
    want = np.asarray(jbmfr.regression(*(jnp.asarray(ch[k]) for k in KEYS), jnp.int32(frame),
                                       JBMFRConfig(**kw)))
    got = bmfr.regression(*(torch.tensor(ch[k]) for k in KEYS),
                          torch.tensor(frame, dtype=torch.int32), BMFRConfig(**kw)).numpy()
    worst, share = _pixel_stats(got, want)
    assert share <= PIX_SHARE, (worst, share)
    # the same columns kept in every block
    _, _, jx, _ = _jax_window_features(ch, frame, half)
    x = torch.tensor(np.asarray(jx))
    jfn, pfn = _solver_pair(solver, ld, frame)
    np.testing.assert_array_equal(_accepted(pfn(x)), _accepted(jfn(jx)))
    return worst


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("ld", [True, False], ids=["skip_ld", "noise"])
@pytest.mark.parametrize("solver", ["qr", "normal"])
@pytest.mark.parametrize("size", [(64, 64), (40, 64)], ids=["64x64", "64x40"])
@pytest.mark.parametrize("scene", ["plane", "random"])
def test_regression_matches_jax(scene, size, solver, ld, half):
    make = _plane_channels if scene == "plane" else _random_channels
    ch = make(*size, seed=11)
    for frame in (0, 13):
        _check_regression(ch, frame, solver, ld, half)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("solver,ld", [("qr", True), ("qr", False), ("normal", False)],
                         ids=["qr-skip_ld", "qr-noise", "normal-noise"])
def test_regression_on_render_matches_jax(solver, ld, half, cornell64, cornell64x40):
    worst = 0.0
    for ch in (cornell64[0][2], cornell64x40[0][0]):
        for frame in (0, 5, 9):
            worst = max(worst, _check_regression(ch, frame, solver, ld, half))
    assert worst < PIX_TOL


def test_regression_normal_ld_on_render(cornell64, cornell64x40):
    """The normal-equations LD skip on rendered channels, block by block:
    where JAX's normal fit agrees with JAX's QR fit (within PIX_TOL) and
    both sides keep the same columns, the port's normal fit agrees with
    JAX's within NORMAL_ATOL.  The other blocks are ill-conditioned for the
    normal equations (see the module doc)."""
    ill = total = 0
    for ch in (cornell64[0][2], cornell64x40[0][0]):
        for frame in (0, 5, 9):
            _, _, jx, (win, n_by, n_bx) = _jax_window_features(ch, frame)

            def jax_fit(solver):
                img = np.asarray(jbmfr._fit_window(win, n_by, n_bx, jnp.int32(frame),
                                                   JBMFRConfig(regression_solver=solver)))
                return img.reshape(n_by, 32, n_bx, 32, 3).transpose(0, 2, 1, 3, 4).reshape(
                    -1, 1024, 3)

            want, want_qr = jax_fit("normal"), jax_fit("qr")
            got = bmfr._fit_window(_port_window_rows(ch, frame), torch.tensor(frame),
                                   BMFRConfig(regression_solver="normal")).numpy()
            same = (_accepted(bmfr._normal_eq_skip_ld(torch.tensor(np.asarray(jx))))
                    == _accepted(jbmfr._normal_eq_skip_ld(jx))).all(-1)
            well = same & (np.abs(want - want_qr).max((1, 2)) <= PIX_TOL)
            np.testing.assert_allclose(got[well], want[well], atol=NORMAL_ATOL, rtol=0)
            ill += int((~well).sum())
            total += well.size
    print(f"normal LD skip on the render: {ill} of {total} blocks ill-conditioned")
    assert ill < total


def test_bmfr_pass_six_frames_match_jax(cornell64):
    """Six frames of the whole pass (the bench's configuration: every
    stage, full screen) from a carried state, the camera moving."""
    frames, vp = cornell64
    kw = dict(enabled=True, preprocess=True, regression=True, postprocess=True,
              half_screen_debug=False)
    js = _jax_state(frames[0], 0)
    ps = _port_state(js)
    for k, ch in enumerate(frames):
        pvp = _moved(vp, k % 3)
        js, jout = jbmfr.bmfr_pass(js, {key: jnp.asarray(ch[key]) for key in KEYS},
                                   types.SimpleNamespace(prev_view_proj=jnp.asarray(pvp)),
                                   JBMFRConfig(**kw))
        ps, pout = bmfr.bmfr_pass(ps, {key: torch.tensor(ch[key]) for key in KEYS},
                                  types.SimpleNamespace(prev_view_proj=torch.tensor(pvp)),
                                  BMFRConfig(**kw))
        worst, share = _pixel_stats(pout.numpy(), jout)
        assert share <= PIX_SHARE and worst < 1e-2, (k, worst, share)
        assert int(ps.frame_number) == int(js.frame_number) == k + 1


def test_bmfr_runs_no_matmul(cornell64):
    """Every product of the pass is an elementwise multiply and sum: no
    matmul, so no TF32 setting can reach the Gram or the reflections."""
    from torch.profiler import ProfilerActivity, profile

    frames, vp = cornell64
    state = bmfr.BMFRState.create(64, 64, device="cpu")
    cam = types.SimpleNamespace(prev_view_proj=torch.tensor(_moved(vp, 1)))
    ch = {k: torch.tensor(frames[0][k]) for k in KEYS}
    names = set()
    for solver in ("qr", "normal"):
        for ld in (True, False):
            cfg = BMFRConfig(enabled=True, regression=True, regression_solver=solver,
                             remove_ld_features=ld, half_screen_debug=False)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                bmfr.bmfr_pass(state, ch, cam, cfg)
            names |= {e.key for e in prof.key_averages()}
    assert "aten::sum" in names
    assert not names & {"aten::mm", "aten::bmm", "aten::matmul", "aten::addmm",
                        "aten::baddbmm", "aten::einsum", "aten::linalg_qr",
                        "aten::linalg_cholesky_ex", "aten::linalg_lstsq"}, names


def test_golden_cornell_bmfr():
    """tests/test_golden.py's BMFR case on the port: 6 frames at 64x64."""
    cfg = RenderConfig(width=64, height=64, bmfr=BMFRConfig(enabled=True, regression=True))
    r = Renderer(Scene.from_built(cornell_box(), aspect=1.0).bake(device="cpu"), cfg)
    r.render(6)
    assert bool(torch.isfinite(r.channels["PipelineOutput"]).all())
    assert int(r.state.bmfr.frame_number) == 6
    golden = read_png(os.path.join(GOLDEN_DIR, "cornell_bmfr_6f_64.png"))
    got = to_u8(np.clip(r.display().numpy(), 0.0, 1.0)).astype(np.float32) / 255.0
    value = psnr(got, golden)
    assert value >= MIN_PSNR, value


# ------------------------------------------- tests/test_bmfr.py on the port
H = W = 64


def _flat_scene(color_fn, seed=0):
    """test_bmfr's synthetic planar G-buffer: plane z=1, camera at origin."""
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    u = (xs + 0.5) / W * 2 - 1
    v = 1 - (ys + 0.5) / H * 2
    pos = np.stack([u, v, np.ones_like(u), np.ones_like(u)], -1).astype(np.float32)
    norm = np.zeros((H, W, 4), np.float32)
    norm[..., 2] = -1.0
    albedo = np.full((H, W, 4), 0.5, np.float32)
    clean = color_fn(u, v)
    noisy = clean + rs.normal(0, 0.25, clean.shape).astype(np.float32)
    noisy4 = np.concatenate([noisy, np.ones((H, W, 1), np.float32)], -1)
    return (torch.tensor(pos), torch.tensor(norm), torch.tensor(albedo),
            torch.tensor(np.clip(noisy4, 0, None)), clean)


def _grey(u, v):
    return np.full((H, W, 3), 0.5, np.float32)


def _state(**kw):
    return replace(bmfr.BMFRState.create(H, W, device="cpu"), **kw)


def _frame(n):
    return torch.tensor(n, dtype=torch.int32)


def _case_mirror_addressing():
    out = bmfr._mirror(torch.tensor([-3, -1, 0, 5, 63, 64, 66]), 64).numpy()
    np.testing.assert_array_equal(out, [2, 0, 0, 5, 63, 63, 61])


def _case_hash_random_range():
    r = bmfr._hash_random(torch.arange(1000)).numpy()
    assert np.all((r >= 0) & (r < 1)) and 0.4 < r.mean() < 0.6


def _case_block_features_match_mirror_gather():
    """The window gather equals the per-pixel mirror fetch (regressionCP.
    hlsl:104-124) bit for bit where one reflection reaches (64x64)."""
    rs = np.random.RandomState(7)
    ch = {k: rs.rand(H, W, 4).astype(np.float32) for k in KEYS}
    tab = np.concatenate([ch[k][..., :3] for k in KEYS], -1).reshape(-1, 12)
    for frame in (0, 3, 9, 15):
        feats, alb = bmfr._features_from_window(_port_window_rows(ch, frame))
        offx, offy = bmfr.BLOCK_OFFSETS[frame % 16]
        bid, pid = np.arange(9), np.arange(1024)
        px = torch.tensor((bid % 3)[:, None] * 32 + pid[None, :] % 32 + offx)
        py = torch.tensor((bid // 3)[:, None] * 32 + pid[None, :] // 32 + offy)
        row = tab[(bmfr._mirror(py, H) * W + bmfr._mirror(px, W)).numpy()]
        np.testing.assert_array_equal(alb.numpy(), row[..., 6:9])
        np.testing.assert_array_equal(feats[..., 1:4].numpy(), row[..., 3:6])
        np.testing.assert_array_equal(feats[..., 4:7].numpy(), row[..., 0:3])


def _linear(u, v):
    c = np.stack([0.3 + 0.2 * u, 0.5 - 0.1 * v, 0.4 + 0.05 * (u + v)], -1)
    return np.clip(c, 0, None).astype(np.float32)


def _case_regression_denoises_linear_signal():
    """A signal linear in the features is recovered almost exactly."""
    pos, norm, albedo, noisy4, clean = _flat_scene(_linear)
    for remove_ld in (True, False):
        cfg = BMFRConfig(half_screen_debug=False, remove_ld_features=remove_ld)
        out = bmfr.regression(pos, norm, albedo, noisy4, _frame(0), cfg).numpy()
        assert np.isfinite(out).all()
        err_out = np.abs(out[..., :3] - clean).mean()
        assert err_out < 0.25 * np.abs(noisy4.numpy()[..., :3] - clean).mean(), remove_ld


def _case_regression_rank_deficient_stable():
    """A constant position plane (features collapse) does not blow up."""
    pos = torch.ones((H, W, 4))
    norm = torch.zeros((H, W, 4))
    norm[..., 2] = 1.0
    albedo = torch.full((H, W, 4), 0.5)
    noisy = torch.tensor(np.abs(np.random.RandomState(1).normal(0.4, 0.2, (H, W, 4)))
                         .astype(np.float32))
    for remove_ld in (True, False):
        cfg = BMFRConfig(half_screen_debug=False, remove_ld_features=remove_ld)
        out = bmfr.regression(pos, norm, albedo, noisy, _frame(2), cfg)
        assert bool(torch.isfinite(out).all()), remove_ld


def _case_preprocess_static_camera_accumulates():
    """Identity reprojection and matching history: spp grows."""
    pos, norm, _, noisy4, _ = _flat_scene(_grey)
    state = _state(prev_pos=pos, prev_norm=norm, prev_noisy=noisy4, frame_number=_frame(1))
    out, accept, _, _ = bmfr.preprocess(state, pos, norm, noisy4, torch.eye(4),
                                        BMFRConfig(half_screen_debug=False))
    out = out.numpy()
    assert np.isfinite(out).all()
    assert (accept.numpy() > 0).mean() > 0.9
    assert (out[..., 3] >= 2.0 - 1e-5).mean() > 0.8


def _case_preprocess_first_frame_passthrough():
    pos, norm, _, noisy4, _ = _flat_scene(_grey)
    out, accept, _, _ = bmfr.preprocess(_state(), pos, norm, noisy4, torch.eye(4),
                                        BMFRConfig(half_screen_debug=False))
    np.testing.assert_allclose(out.numpy()[..., :3], noisy4.numpy()[..., :3], atol=1e-6)
    assert np.all(accept.numpy() == 0) and np.all(out.numpy()[..., 3] == 1.0)


def _case_postprocess_blends_history():
    filtered = torch.full((H, W, 4), 0.8)
    filtered[..., 3] = 10.0
    state = _state(prev_filtered=torch.full((H, W, 4), 0.2), frame_number=_frame(3))
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    out = bmfr.postprocess(state, filtered, torch.full((H, W), 0b1111, dtype=torch.int32),
                           torch.stack([xs, ys], -1), BMFRConfig(half_screen_debug=False))
    # alpha = max(1/10, 0.1) = 0.1 -> 0.1*0.8 + 0.9*0.2 = 0.26
    np.testing.assert_allclose(out.numpy()[5, 5, :3], 0.26, rtol=1e-4)


def _case_half_screen_gate():
    pos, norm, _, noisy4, _ = _flat_scene(_grey)
    state = _state(prev_pos=pos, prev_norm=norm, prev_noisy=noisy4, frame_number=_frame(1))
    out, _, _, _ = bmfr.preprocess(state, pos, norm, noisy4, torch.eye(4),
                                   BMFRConfig(half_screen_debug=True))
    # the right half passes through unchanged
    np.testing.assert_array_equal(out.numpy()[:, (W + 1) // 2:],
                                  noisy4.numpy()[:, (W + 1) // 2:])


def _case_history_pack_bf16_matches_f32():
    """The bf16x2 history fetch reproduces the f32 one within the bf16
    rounding of the history over a 3-frame run with motion."""
    def color_fn(u, v):
        return np.stack([0.5 + 0.4 * u, 0.5 - 0.3 * v, 0.4 + 0.2 * u * v], -1).astype(np.float32)

    outs = {}
    for pack in ("f32", "bf16"):
        cfg = BMFRConfig(enabled=True, preprocess=True, regression=True, postprocess=True,
                         half_screen_debug=False, history_pack=pack)
        state = bmfr.BMFRState.create(H, W, device="cpu")
        for frame in range(3):
            pos, norm, albedo, noisy4, _ = _flat_scene(color_fn, seed=frame)
            pvp = torch.eye(4)
            pvp[1, 3] = -0.004 * frame
            channels = dict(zip(KEYS, (pos, norm, albedo, noisy4)))
            state, out = bmfr.bmfr_pass(state, channels,
                                        types.SimpleNamespace(prev_view_proj=pvp), cfg)
        outs[pack] = out.numpy()
    # bf16 keeps 8 bits of mantissa; the drift stays O(2^-7) absolute here
    np.testing.assert_allclose(outs["bf16"], outs["f32"], atol=2e-2)
    assert np.mean(np.abs(outs["bf16"] - outs["f32"])) < 3e-3


def _case_normal_eq_solver_matches_qr():
    """solver 'normal' reproduces the QR's fit to float32 tolerance, with
    rank-deficient blocks where the 0.01 skip fires, both variants."""
    rs = np.random.RandomState(11)
    a = rs.rand(8, bmfr.BLOCK_PIXELS, bmfr.BUFFERS).astype(np.float32)
    a[:, :, 0] = 1.0
    a[:4, :, 5] = a[:4, :, 4]
    a[2:6, :, 8] = 0.25
    x = torch.tensor(a)
    f = a[..., :bmfr.FEATURES]
    w_qr, w_ne = bmfr._householder_qr_skip_ld(x).numpy(), bmfr._normal_eq_skip_ld(x).numpy()
    np.testing.assert_allclose(np.einsum("bpf,bfc->bpc", f, w_ne),
                               np.einsum("bpf,bfc->bpc", f, w_qr), atol=5e-3)
    w_qr_n = bmfr._householder_qr_noise(x, _frame(7), 0.01).numpy()
    w_ne_n = bmfr._normal_eq_noise(x, _frame(7), 0.01).numpy()
    np.testing.assert_allclose(np.einsum("bpf,bfc->bpc", f, w_ne_n),
                               np.einsum("bpf,bfc->bpc", f, w_qr_n), atol=5e-3)
    np.testing.assert_array_equal(w_qr == 0.0, w_ne == 0.0)


BEHAVIOUR = {
    "mirror_addressing": _case_mirror_addressing,
    "hash_random_range": _case_hash_random_range,
    "block_features_match_mirror_gather": _case_block_features_match_mirror_gather,
    "regression_denoises_linear_signal": _case_regression_denoises_linear_signal,
    "regression_rank_deficient_stable": _case_regression_rank_deficient_stable,
    "preprocess_static_camera_accumulates": _case_preprocess_static_camera_accumulates,
    "preprocess_first_frame_passthrough": _case_preprocess_first_frame_passthrough,
    "postprocess_blends_history": _case_postprocess_blends_history,
    "half_screen_gate": _case_half_screen_gate,
    "history_pack_bf16_matches_f32": _case_history_pack_bf16_matches_f32,
    "normal_eq_solver_matches_qr": _case_normal_eq_solver_matches_qr,
}


@pytest.mark.parametrize("case", list(BEHAVIOUR))
def test_bmfr_behaviour(case):
    """tests/test_bmfr.py's 11 behaviour tests, on the port, with their
    tolerances."""
    BEHAVIOUR[case]()


# ------------------------------------------ the fit kernel's wrapper on the CPU
def _faulty(fault):
    """The flat scene's regression inputs with one fault the fit kernel's
    wrapper refuses on every device."""
    pos, norm, albedo, noisy4, _ = _flat_scene(_linear)
    fr = _frame(3)
    if fault == "float64_albedo":
        albedo = albedo.double()
    elif fault == "int64_frame":
        fr = fr.long()
    elif fault == "column_slice":  # rows of a wider image: not one pixel stride
        pos = torch.cat([pos, pos], 1)[:, :W]
    elif fault == "transposed":
        norm = norm.transpose(0, 1)
    elif fault == "three_channels":
        noisy4 = noisy4[..., :3]
    elif fault == "channel_on_meta":
        albedo = albedo.to("meta")
    elif fault == "frame_on_meta":
        fr = fr.to("meta")
    return pos, norm, albedo, noisy4, fr


FIT_FAULTS = ("float64_albedo", "int64_frame", "column_slice", "transposed", "three_channels",
              "channel_on_meta", "frame_on_meta")


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("fault", FIT_FAULTS)
def test_fit_wrapper_refuses_what_the_kernel_does_not_take(fault, sharded):
    """`regression` and `regression_sharded` check the inputs as the fit
    kernel takes them on every device (dtypes, [H, W, 4], one pixel stride,
    one device) and raise before any work, the CPU's plain path included."""
    args = _faulty(fault)
    cfg = BMFRConfig(half_screen_debug=False)
    with pytest.raises((TypeError, ValueError)):
        if sharded:
            bmfr.regression_sharded(*args, cfg, None)
        else:
            bmfr.regression(*args, cfg)


def test_fit_wrapper_takes_plane_major_channels():
    """K1's G-buffer channels are plane-major views ([H, W, 4] with pixel
    stride 1): the wrapper takes them, and the fit equals the contiguous
    channels' bit for bit."""
    pos, norm, albedo, noisy4, _ = _flat_scene(_linear)

    def planes(t):
        return t.reshape(-1, 4).T.contiguous().T.reshape(H, W, 4)

    assert planes(pos).stride() == (W, 1, H * W)
    cfg = BMFRConfig(half_screen_debug=False)
    got = bmfr.regression(planes(pos), planes(norm), planes(albedo), noisy4, _frame(5), cfg)
    want = bmfr.regression(pos, norm, albedo, noisy4, _frame(5), cfg)
    assert torch.equal(got, want)


def test_bmfr_pass_on_cpu_takes_the_plain_fit(monkeypatch):
    """On CPU tensors `bmfr_pass` fits through `regression_plain`, once a
    pass, and launches no fit kernel."""
    calls = []
    plain = bmfr.regression_plain
    monkeypatch.setattr(bmfr, "regression_plain", lambda *a: calls.append(1) or plain(*a))
    pos, norm, albedo, noisy4, _ = _flat_scene(_linear)
    cfg = BMFRConfig(enabled=True, regression=True, half_screen_debug=False)
    state = bmfr.BMFRState.create(H, W, device="cpu")
    cuda.reset_launch_counts()
    for _ in range(2):
        state, out = bmfr.bmfr_pass(state, dict(zip(KEYS, (pos, norm, albedo, noisy4))),
                                    types.SimpleNamespace(prev_view_proj=torch.eye(4)), cfg)
    assert len(calls) == 2 and cuda.LAUNCHES["bmfr_fit"] == 0
    assert bool(torch.isfinite(out).all())
