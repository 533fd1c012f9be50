"""The port's light probe (ops/lightprobe.py), probe-lit pass
(passes/extras.probe_lit_pass) and tone-map operators (ops/tonemap.py)
against the JAX package's on the CPU, and test_lightprobe.py's behaviour
cases on the port.

The Hammersley points are bit-equal.  The integrals sum their samples in
chunks (JAX in order, by `lax.scan`), and torch's sin, cos, atan2 and
acos differ from XLA's in the last bits, so the integrals are held within
rtol 1e-4, atol 1e-5 at sizes 8-16, 32-64 samples and 3 mips; eval_probe
and the pass likewise, on the same probe arrays; the tone map within
atol 1e-6.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box as jcornell_box
from fyp_bidirectionalpathtracer_tpu.ops import lightprobe as jlp
from fyp_bidirectionalpathtracer_tpu.ops import tonemap as jtonemap
from fyp_bidirectionalpathtracer_tpu.passes import extras as jextras
from fyp_bidirectionalpathtracer_tpu.passes import gbuffer as jgbuffer
from fyp_bidirectionalpathtracer_tpu.ops.shading import make_shaded_tracer as jmake_shaded_tracer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu.utils.image import psnr, read_png, to_u8
from fyp_bidirectionalpathtracer_tpu.utils.testing import GOLDEN_DIR
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.ops import lightprobe as lp
from fyp_bidirectionalpathtracer_tpu_torch.ops import tonemap
from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu_torch.passes.extras import probe_lit_pass
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import (
    pixel_jitter_for_frame,
    ray_traced_gbuffer,
)
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from test_torch_textured import jax_scene_arrays
from torch_threads import one_intra_op_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _env(h=16, w=32, seed=0):
    """A probe from a seed: a latitude gradient plus noise, rgb and a = 1."""
    rs = np.random.RandomState(seed)
    v = np.linspace(0.0, 1.0, h)[:, None, None]
    img = 0.2 + 0.6 * v + 0.2 * rs.uniform(0, 1, (h, w, 3))
    return np.concatenate([img, np.ones((h, w, 1))], -1).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------- sampling
def test_hammersley_and_radical_inverse_bit_equal():
    rs = np.random.RandomState(1)
    i = np.concatenate([np.arange(4096), rs.randint(0, 2**32, 4096, dtype=np.uint64),
                        [2**32 - 1, 2**31, 2**31 - 1]]).astype(np.uint32)
    want_v = np.asarray(jlp.radical_inverse_vdc(jnp.asarray(i)))
    got_v = lp.radical_inverse_vdc(torch.from_numpy(i.astype(np.int64)))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), want_v.view(np.int32))
    want = jlp.hammersley(jnp.arange(4096, dtype=jnp.uint32), 4096)
    got = lp.hammersley(torch.arange(4096), 4096)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


def test_sample_directions_match_jax():
    """importance_sample_cos_dir and _ggx over one basis, _smith_ggx, _ggx_d
    and the dominant directions, atol 1e-6."""
    rs = np.random.RandomState(2)
    n = rs.normal(size=(512, 3)).astype(np.float32)
    n[:4] = [[0, 0, 1], [0, 0, -1], [0, 1e-7, 1], [1, 0, 0]]
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u1, u2, r = (rs.uniform(0, 1, 512).astype(np.float32) for _ in range(3))
    J, T = jnp.asarray, torch.from_numpy
    pairs = [
        (jlp.importance_sample_cos_dir(J(u1), J(u2), J(n)),
         lp.importance_sample_cos_dir(T(u1), T(u2), T(n))),
        (jlp.importance_sample_ggx(J(u1), J(u2), J(n), J(r)),
         lp.importance_sample_ggx(T(u1), T(u2), T(n), T(r))),
        (jlp._smith_ggx(J(u1), J(u2), J(r)), lp._smith_ggx(T(u1), T(u2), T(r))),
        (jlp._ggx_d(J(r), J(u1)), lp._ggx_d(T(r), T(u1))),
        (jlp._get_diffuse_dominant_dir(J(n), J(n[::-1].copy()), J(r)),
         lp._get_diffuse_dominant_dir(T(n), T(n[::-1].copy()), T(r))),
        (jlp._get_specular_dominant_dir(J(n), J(n[::-1].copy()), J(r)),
         lp._get_specular_dominant_dir(T(n), T(n[::-1].copy()), T(r))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_fetches_and_pyramid_match_jax():
    env = _env(16, 32)
    rs = np.random.RandomState(3)
    u, v, m = (rs.uniform(-0.05, 1.05, 2048).astype(np.float32) for _ in range(3))
    m *= 5
    np.testing.assert_allclose(
        lp._bilinear_fetch(torch.from_numpy(env), torch.from_numpy(u), torch.from_numpy(v)),
        np.asarray(jlp._bilinear_fetch(jnp.asarray(env), jnp.asarray(u), jnp.asarray(v))),
        atol=1e-6)
    want_p = jlp.build_mip_pyramid(jnp.asarray(env), 4)
    got_p = lp.build_mip_pyramid(torch.from_numpy(env), 4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6)  # mean's order
    args = (torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(m))
    np.testing.assert_allclose(
        lp._pyramid_fetch(got_p, *args),
        np.asarray(jlp._pyramid_fetch(want_p, jnp.asarray(u), jnp.asarray(v), jnp.asarray(m))),
        atol=1e-6)
    np.testing.assert_allclose(lp.latlong_texel_dirs(8, 16, device="cpu"),
                               np.asarray(jlp.latlong_texel_dirs(8, 16)), atol=1e-6)


# ------------------------------------------------------------ integrals
def test_integrate_diffuse_ld_matches_jax():
    env = _env()
    want = jlp.integrate_diffuse_ld(jnp.asarray(env), size=8, sample_count=64)
    _close(lp.integrate_diffuse_ld(torch.from_numpy(env), size=8, sample_count=64), want)


def test_integrate_specular_ld_matches_jax(monkeypatch):
    """Three mips at size 8 over 32 samples, in one chunk and in chunks of
    3 samples (a tenth of the chunk budget of the card's default probe)."""
    env = _env()
    want = jlp.integrate_specular_ld(jnp.asarray(env), size=8, sample_count=32, mip_count=3)
    got = lp.integrate_specular_ld(torch.from_numpy(env), size=8, sample_count=32, mip_count=3)
    assert got.shape == (3, 8, 8, 3)
    _close(got, want)
    monkeypatch.setattr(lp, "_PAIR_BUDGET", 3 * 64)
    _close(lp.integrate_specular_ld(torch.from_numpy(env), size=8, sample_count=32,
                                    mip_count=3), want)


def test_integrate_dfg_matches_jax():
    want = jlp.integrate_dfg(size=16, sample_count=64)
    _close(lp.integrate_dfg(size=16, sample_count=64, device="cpu"), want)


def _probe_pair(env, **kw):
    """(JAX LightProbe, the port's LightProbe on the JAX probe's arrays)."""
    jprobe = jlp.LightProbe(jnp.asarray(env), **kw)
    probe = lp.LightProbe.__new__(lp.LightProbe)
    for name in ("origin", "diffuse", "specular", "dfg"):
        setattr(probe, name, torch.from_numpy(np.asarray(getattr(jprobe, name)).copy()))
    return jprobe, probe


def test_light_probe_and_eval_probe_match_jax():
    """The port's own LightProbe against JAX's; eval_probe on JAX's probe
    arrays over random shading inputs."""
    env = _env()
    kw = dict(diff_samples=64, spec_samples=32, diff_size=8, spec_size=8, spec_mips=3)
    jprobe, probe = _probe_pair(env, **kw)
    own = lp.LightProbe(torch.from_numpy(env), **kw)
    for name in ("diffuse", "specular", "dfg"):
        _close(getattr(own, name), getattr(jprobe, name))
    rs = np.random.RandomState(4)
    n = rs.normal(size=(1024, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v = rs.normal(size=(1024, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = np.where((v * n).sum(-1, keepdims=True) < 0, -v, v)
    dif, spec = (rs.uniform(0, 1, (1024, 3)).astype(np.float32) for _ in range(2))
    rough = rs.uniform(0.0064, 1.0, 1024).astype(np.float32)
    n[:8] = 0.0  # a G-buffer miss's normal: NaN lanes read texel 0, as JAX's
    args = (n, v, dif, spec, rough)
    want = jlp.eval_probe(jprobe, *(jnp.asarray(a) for a in args))
    got = lp.eval_probe(probe, *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               equal_nan=True)


# ------------------------------------------------------------- tone map
@pytest.mark.parametrize("name", list(jtonemap.OPERATOR_NAMES))
def test_tone_map_matches_jax(name):
    """Every operator with the frame's own exposure and, but for clamp,
    with a given average luminance; atol 1e-6."""
    rs = np.random.RandomState(5)
    c = (rs.lognormal(-1.0, 1.5, (32, 24, 3))).astype(np.float32)
    c[0, :4] = 0.0
    op = tonemap.OPERATOR_NAMES[name]
    assert op == jtonemap.OPERATOR_NAMES[name]
    for kw in ({}, {"avg_luminance": 0.3, "exposure_key": 0.18, "max_white_luminance": 2.0,
                    "white_scale": 6.0}):
        want = jtonemap.tone_map(jnp.asarray(c), op, **kw)
        got = tonemap.tone_map(torch.from_numpy(c), op, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ------------------------------------------------------- the probe-lit pass
@pytest.fixture(scope="module")
def cornell_gbuffers():
    """JAX's Cornell G-buffer at 32x32 and the port's bake of the same
    arrays with an env map from a seed."""
    jb = JScene.from_built(jcornell_box(), aspect=1.0)
    jb.env_map = _env(16, 32, seed=6)
    jb = jb.bake()
    frame = jnp.uint32(0xDEADBEEF)
    jit = jgbuffer.pixel_jitter_for_frame(frame, "msaa8")
    ch = jgbuffer.ray_traced_gbuffer(jb, jmake_shaded_tracer(jb), 32, 32, frame, jit)
    return jb, baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu"), ch


def test_probe_lit_pass_matches_jax(cornell_gbuffers):
    """probe_lit_pass on JAX's G-buffer and probe arrays: the port's
    any-hit shadow rays and eval_probe against JAX's."""
    jb, pb, jch = cornell_gbuffers
    jprobe, probe = _probe_pair(np.asarray(jb.data.env_map), diff_samples=64, spec_samples=32,
                                diff_size=8, spec_size=16, spec_mips=3)
    want = np.asarray(jextras.probe_lit_pass(jb, jb.intersector(), jch, jprobe))
    ch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jch.items()}
    got = probe_lit_pass(pb, pb.intersector(), ch, probe).numpy()
    assert got.shape == (32, 32, 4) and np.isfinite(got).all()
    differs = (np.abs(got - want) > ATOL + RTOL * np.abs(want)).any(-1)
    assert differs.mean() <= 0.01, differs.mean()  # shadow-edge rays
    valid = np.asarray(jch["WorldPosition"])[..., 3] != 0
    assert (got[valid, :3] > 0).any()


# --------------------------------------------- test_lightprobe.py's cases
def test_hammersley_exact():
    u, v = lp.hammersley(torch.arange(8), 8)
    np.testing.assert_allclose(u.numpy(), np.arange(8) / 8)
    np.testing.assert_allclose(v.numpy(), [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875])


def test_latlong_dirs_roundtrip():
    from fyp_bidirectionalpathtracer_tpu_torch.core.vecmath import ws_vector_to_latlong

    h, w = 8, 16
    u, v = ws_vector_to_latlong(lp.latlong_texel_dirs(h, w, device="cpu"))
    np.testing.assert_allclose(u.numpy(), np.tile((np.arange(w) + 0.5) / w, (h, 1)), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.tile(((np.arange(h) + 0.5) / h)[:, None], (1, w)),
                               atol=1e-5)


def test_diffuse_constant_fixed_point():
    out = lp.integrate_diffuse_ld(torch.full((8, 16, 3), 0.7), size=8, sample_count=64)
    assert out.shape == (8, 8, 3)
    np.testing.assert_allclose(out.numpy(), 0.7, rtol=1e-5)


def test_specular_constant_fixed_point():
    out = lp.integrate_specular_ld(torch.full((16, 32, 3), 0.4), size=8, sample_count=32,
                                   mip_count=3)
    assert out.shape == (3, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), 0.4, rtol=1e-4)


def test_diffuse_matches_numpy_quadrature():
    """The cosine convolution of a latitude-only env against a numpy
    quadrature on a dense sphere grid, within 2%."""
    h, w = 16, 32
    band = (0.2 + 0.6 * (np.cos((np.arange(h) + 0.5) / h * np.pi) + 1) / 2).astype(np.float32)
    env = torch.from_numpy(np.tile(band[:, None, None], (1, w, 3)))
    size = 8
    out = lp.integrate_diffuse_ld(env, size=size, sample_count=4096).numpy()
    n_dirs = lp.latlong_texel_dirs(size, size, device="cpu").numpy().reshape(-1, 3)
    t = np.linspace(0, np.pi, 256)
    p = np.linspace(0, 2 * np.pi, 256, endpoint=False)
    tt, pp = np.meshgrid(t, p, indexing="ij")
    dirs = np.stack([np.sin(tt) * np.sin(pp), np.cos(tt), -np.sin(tt) * np.cos(pp)], -1)
    d_omega = np.sin(tt) * (t[1] - t[0]) * (p[1] - p[0])
    env_l = 0.2 + 0.6 * (dirs[..., 1] + 1) / 2
    for k in range(0, n_dirs.shape[0], 7):
        cos_nl = dirs @ n_dirs[k]
        ref = float(np.sum(np.where(cos_nl > 0, env_l * cos_nl, 0.0) * d_omega) / np.pi)
        got = out.reshape(-1, 3)[k, 0]
        assert abs(got - ref) < 0.02 * max(ref, 0.1), (k, got, ref)


def test_dfg_matches_numpy_oracle():
    """test_lightprobe.py's numpy re-derivation of integrateDFG at four
    (NdotV, roughness) points."""
    from test_lightprobe import _np_dfg_point

    size, n_samples = 16, 128
    out = lp.integrate_dfg(size=size, sample_count=n_samples, device="cpu").numpy()
    assert out.shape == (size, size, 3) and np.isfinite(out).all() and (out >= 0).all()
    for iy, ix in [(0, 8), (8, 4), (15, 15), (4, 12)]:
        ref = _np_dfg_point((ix + 0.5) / size, (iy + 0.5) / size, n_samples)
        np.testing.assert_allclose(out[iy, ix], ref, rtol=2e-3, atol=2e-4)


def test_lightprobe_bundle_shapes():
    probe = lp.LightProbe(torch.full((8, 16, 3), 0.25), diff_samples=16, spec_samples=8,
                          diff_size=4, spec_size=4, spec_mips=2)
    assert probe.diffuse.shape == (4, 4, 3)
    assert probe.specular.shape == (2, 4, 4, 3)
    assert probe.dfg.shape == (128, 128, 3)


def test_eval_probe_constant_env_orientation_invariant():
    probe = lp.LightProbe(torch.full((8, 16, 3), 0.6), diff_samples=32, spec_samples=16,
                          diff_size=8, spec_size=8, spec_mips=3)
    c, s = np.cos(0.3), np.sin(0.3)
    n = torch.tensor([[0.0, 0.0, 1.0], [0.0, s, c]], dtype=torch.float32)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    v = torch.from_numpy(np.stack([[s, 0.0, c], rot @ np.array([s, 0.0, c])]).astype(np.float32))
    out = lp.eval_probe(probe, n, v, torch.full((2, 3), 0.5), torch.full((2, 3), 0.04),
                        torch.full((2,), 0.25)).numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    np.testing.assert_allclose(out[0], out[1], rtol=2e-3, atol=1e-4)


def test_probe_lit_pass_golden():
    """cornell_probe_lit_64 through the port (read only), at 38 dB: the
    Cornell G-buffer, probe_lit_pass with its (black, 1x1) env's probe, the
    clamp tone map."""
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake(device="cpu")
    frame = 0xDEADBEEF
    jit = pixel_jitter_for_frame(frame, "msaa8")
    channels = ray_traced_gbuffer(baked, make_shaded_tracer(baked), 64, 64, frame, jit)
    probe = lp.LightProbe(baked.env_map, diff_samples=256, spec_samples=64, diff_size=16,
                          spec_size=32, spec_mips=4)
    img = probe_lit_pass(baked, baked.intersector(), channels, probe).numpy()
    assert np.isfinite(img).all()
    out = tonemap.tone_map(torch.from_numpy(img[..., :3]), tonemap.CLAMP).numpy()
    golden = read_png(os.path.join(GOLDEN_DIR, "cornell_probe_lit_64.png"))
    value = psnr(to_u8(out).astype(np.float32) / 255.0, golden)
    assert value >= 38.0, value
