"""The port's splat path (rgb8e packing, K2's and K3's plain versions, the
direct mode) against the JAX package on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.ops.compact import K as JK
from fyp_bidirectionalpathtracer_tpu.ops.compact import compact_live as jcompact_live
from fyp_bidirectionalpathtracer_tpu.ops.splat import scatter_add_rgba_direct as jdirect
from fyp_bidirectionalpathtracer_tpu.ops.splat_tile import _pack_rgb8e as jpack
from fyp_bidirectionalpathtracer_tpu.ops.splat_tile import _unpack_rgb8e as junpack
from fyp_bidirectionalpathtracer_tpu.ops.splat_tile import (
    scatter_add_rgba_tiled_prepacked as jprepacked,
)
from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.ops.compact import compact_live, compact_plain
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat import (
    scatter_add_rgba,
    scatter_add_rgba_direct,
    scatter_add_rgba_prepacked,
)
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat_tile import (
    pack_rgb8e,
    reduce_sorted_plain,
    splat_reduce,
    unpack_rgb8e,
)
from torch_threads import one_intra_op_thread  # noqa: F401


def _rgb8e_inputs():
    """Non-negative channels with the edge cases of the quantiser: zeros,
    subnormals, values >= 2^15, and exact .5 ties of c * scale."""
    rs = np.random.RandomState(5)
    n = 6000
    c = np.abs(rs.normal(size=(n, 3))).astype(np.float32)
    c[:500] *= np.float32(1e-40)                       # subnormals
    c[500:1000] = 0.0
    c[1000:1500] *= np.float32(2.0 ** 17)              # >= 2^15
    c[1500:2000, 1:] = 0.0
    # ties: max channel 1.0 (scale 2^7) and m + 0.5 steps of 2^-7
    m = rs.randint(0, 127, size=(1000, 3)).astype(np.float32)
    c[2000:3000] = (m + 0.5) / np.float32(128.0)
    c[2000:3000, 0] = 1.0
    c[3000:3100] = np.float32(2.0 ** -30) * rs.rand(100, 3).astype(np.float32)
    return c


def test_pack_rgb8e_bit_equal():
    c = _rgb8e_inputs()
    want = np.asarray(jpack(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]),
                            jnp.asarray(c[:, 2])))
    t = torch.from_numpy(c)
    got = pack_rgb8e(t[:, 0], t[:, 1], t[:, 2])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for w, g in zip(junpack(jnp.asarray(want)), unpack_rgb8e(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# the cases of tests/test_ops.py::test_compact_live_preserves_source_order
COMPACT_CASES = [(2 * JK, 0.15), (JK + 1000, 0.5), (3 * JK, 0.0)]


@pytest.mark.parametrize("u,frac", COMPACT_CASES)
def test_compact_matches_stable_partition_and_jax(u, frac):
    rs = np.random.RandomState(7)
    n_targets, sent = 2000, 2048
    live = rs.rand(u) < frac
    keys = np.where(live, rs.randint(0, n_targets, u), n_targets).astype(np.int32)
    pay = rs.randint(-(2 ** 31), 2 ** 31 - 1, u).astype(np.int32)
    ck, cp, n_live = compact_plain(torch.from_numpy(keys), torch.from_numpy(pay),
                                   n_targets, sent)
    n = int(n_live)
    # exact: the live subsequence in source order, then sentinels, zeros
    np.testing.assert_array_equal(ck[:n].numpy(), keys[live])
    np.testing.assert_array_equal(cp[:n].numpy(), pay[live])
    assert n == int(live.sum())
    assert bool((ck[n:] == sent).all()) and bool((cp[n:] == 0).all())
    # JAX's compact_live (interpret): the same live subsequence
    jk, jp, jn = jcompact_live(jnp.asarray(keys), jnp.asarray(pay), n_targets,
                               sent, interpret=True)
    jk, jp = np.asarray(jk)[:int(jn)], np.asarray(jp)[:int(jn)]
    keep = jk < n_targets
    np.testing.assert_array_equal(ck[:n].numpy(), jk[keep])
    np.testing.assert_array_equal(cp[:n].numpy(), jp[keep])


def _splat_updates(seed, n_targets, u, live_frac):
    rs = np.random.RandomState(seed)
    live = rs.rand(u) < live_frac
    lin = np.where(live, rs.randint(0, n_targets, u), n_targets).astype(np.int32)
    rgb = np.abs(rs.normal(size=(u, 3))).astype(np.float32)
    return lin, rgb


@pytest.mark.parametrize("n_targets,u,live_frac", [
    (2000, 3 * 8192, 0.15),   # the est-2 live share; dead key n_targets
    (1000, 4000, 0.9),        # a sentinel (1024) above n_targets
    (3000, 6000, 0.5),        # runs across three 1024-pixel tiles
])
def test_prepacked_reduce_matches_jax(n_targets, u, live_frac):
    """K2 + stable sort + K3 (plain) against JAX's prepacked rgb8e splat
    (interpret, compact on).  Counts exactly equal; rgb within the rgb8e
    envelope of tests/test_ops.py (2^-8 of each update's largest channel),
    since both sum the same decoded values in another order."""
    lin, rgb = _splat_updates(11, n_targets, u, live_frac)
    packed = np.array(jpack(jnp.asarray(rgb[:, 0]), jnp.asarray(rgb[:, 1]),
                            jnp.asarray(rgb[:, 2])))
    want = np.asarray(jprepacked(jnp.asarray(lin), jnp.asarray(packed), n_targets,
                                 interpret=True, compact="on"))
    got = scatter_add_rgba_prepacked(torch.from_numpy(lin),
                                     torch.from_numpy(packed), n_targets).numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    kept = lin < n_targets
    env = np.zeros(n_targets)
    np.add.at(env, lin[kept], rgb[kept].max(-1) * 2.0 ** -8)
    assert np.all(np.abs(got[:, :3] - want[:, :3]) <= env[:, None] + 1e-6)
    # and against the exact direct sum, within the same envelope
    d = np.asarray(jdirect(jnp.asarray(lin), jnp.asarray(rgb),
                           jnp.ones(u, jnp.float32), n_targets))
    assert np.all(np.abs(got[:, :3] - d[:, :3]) <= env[:, None] + 1e-5)


def test_reduce_sorted_is_exact_segment_sum():
    """K3's plain version sums each pixel's decoded run (float64 check)."""
    lin, rgb = _splat_updates(3, 500, 5000, 0.7)
    keep = lin < 500
    keys = np.sort(lin[keep], kind="stable").astype(np.int32)
    t = torch.from_numpy(rgb[keep])
    pay = pack_rgb8e(t[:, 0], t[:, 1], t[:, 2])
    out = reduce_sorted_plain(torch.from_numpy(keys), pay, 500).numpy()
    dec = torch.stack(unpack_rgb8e(pay), 1).double().numpy()
    want = np.zeros((500, 3))
    np.add.at(want, keys, dec)
    np.testing.assert_allclose(out[:, :3], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out[:, 3], np.bincount(keys, minlength=500))


def test_direct_mode_matches_jax():
    """Both scatter-add in update order: rtol 1e-6 covers the last ulp."""
    lin, rgb = _splat_updates(2, 1000, 3000, 0.8)
    lin[::7] = 1200  # out of range: dropped by both
    alpha = np.random.RandomState(4).rand(3000).astype(np.float32)
    want = np.asarray(jdirect(jnp.asarray(lin), jnp.asarray(rgb), jnp.asarray(alpha), 1000))
    got = scatter_add_rgba_direct(torch.from_numpy(lin), torch.from_numpy(rgb),
                                  torch.from_numpy(alpha), 1000).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    auto = scatter_add_rgba("auto", torch.from_numpy(lin), torch.from_numpy(rgb),
                            torch.from_numpy(alpha), 1000, alpha_is_count=True).numpy()
    np.testing.assert_array_equal(auto, got)  # 'auto' is 'direct' on the CPU


def test_cpu_wrappers_run_plain_versions_without_launching():
    cuda.reset_launch_counts()
    keys = torch.tensor([3, 9, 1, 9, 0], dtype=torch.int32)
    pay = torch.arange(5, dtype=torch.int32)
    ck, cp, n = compact_live(keys, pay, 9, 1024)
    assert ck.tolist() == [3, 1, 0, 1024, 1024] and cp.tolist() == [0, 2, 4, 0, 0]
    assert int(n) == 3
    out = splat_reduce(torch.tensor([0, 1, 1], dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32), 4)
    assert out[:, 3].tolist() == [1.0, 2.0, 0.0, 0.0]
    assert set(cuda.LAUNCHES) >= {"frame", "compact", "splat_tile"}
    assert all(v == 0 for v in cuda.LAUNCHES.values())
    with pytest.raises(TypeError):
        compact_live(keys.to(torch.int64), pay, 9, 1024)


# ------------------------------------------- the scatter-workaround modes
def _est2_updates(seed, count):
    """The estimator-2 splat's shape scaled down: 3 depths x a 64x48 image
    (U = 9,216 of the 1280x720 frame's 2,764,800), 15% live, the dead ones
    at n_targets; radiance over four decades; alpha the count or real."""
    n_targets = 64 * 48
    lin, rgb = _splat_updates(seed, n_targets, 3 * n_targets, 0.15)
    rs = np.random.RandomState(seed + 1)
    rgb *= (10.0 ** rs.uniform(-3, 1, (rgb.shape[0], 1))).astype(np.float32)
    live = lin < n_targets
    alpha = live.astype(np.float32) if count else rs.rand(lin.shape[0]).astype(np.float32)
    return lin, rgb, alpha, n_targets


def _both(mode, lin, rgb, alpha, n_targets, count):
    from fyp_bidirectionalpathtracer_tpu.ops.splat import scatter_add_rgba as jscatter

    want = np.asarray(jscatter(mode, jnp.asarray(lin), jnp.asarray(rgb), jnp.asarray(alpha),
                               n_targets, alpha_is_count=count))
    got = scatter_add_rgba(mode, torch.from_numpy(lin), torch.from_numpy(rgb),
                           torch.from_numpy(alpha), n_targets, alpha_is_count=count).numpy()
    return got, want


@pytest.mark.parametrize("count", [True, False], ids=["count", "alpha"])
def test_packed_mode_bit_equal_to_jax(count):
    """'packed': int32 fixed point at 2^-18, prefix sums wrapped at 32 bits
    as XLA's int32, the scatter-max of segment ends: bit for bit; and within
    the quantization (2^-19 an update) of the exact sum."""
    lin, rgb, alpha, n_t = _est2_updates(21, count)
    got, want = _both("packed", lin, rgb, alpha, n_t, count)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    exact = scatter_add_rgba_direct(torch.from_numpy(lin), torch.from_numpy(rgb),
                                    torch.from_numpy(alpha), n_t).double().numpy()
    n_upd = np.bincount(lin[lin < n_t], minlength=n_t)[:, None]
    assert np.all(np.abs(got - exact) <= n_upd * 2.0 ** -19 + 1e-6)


def test_packed_mode_wraps_as_int32():
    """Prefix sums past 2^31 wrap, and a pixel's total (below 2^13) is
    still exact: 10 updates of 500 a pixel on 4 pixels, 20,000 in all."""
    lin = np.repeat(np.arange(4, dtype=np.int32), 10)
    rgb = np.full((40, 3), 500.0, np.float32)
    got, want = _both("packed", lin, rgb, np.ones(40, np.float32), 4, True)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, np.tile([[5000.0] * 3 + [10.0]], (4, 1)))


@pytest.mark.parametrize("mode", ["sorted", "complex"])
@pytest.mark.parametrize("count", [True, False], ids=["count", "alpha"])
def test_sorted_and_complex_modes_match_jax(mode, count):
    """'complex' scatter-adds float pairs in update order: within the
    direct mode's rtol 1e-6.  'sorted' takes a pixel's total as the
    difference of two float32 prefix sums over all sorted updates, whose
    rounding (JAX's cumsum associates in another order than torch's) is
    relative to the prefix, not to the pixel: within 2^-20 of the
    channel's whole sum of either package (8 float32 ulps of the largest
    prefix), and of the exact sum."""
    lin, rgb, alpha, n_t = _est2_updates(22, count)
    got, want = _both(mode, lin, rgb, alpha, n_t, count)
    exact = scatter_add_rgba_direct(torch.from_numpy(lin), torch.from_numpy(rgb),
                                    torch.from_numpy(alpha), n_t).numpy()
    if mode == "complex":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-7)
    else:
        prefix = exact.sum(0) * 2.0 ** -20
        assert np.all(np.abs(got - want) <= prefix), np.abs(got - want).max(0) / prefix
        assert np.all(np.abs(got - exact) <= prefix)
    assert float(got[:, 3].sum()) > 0


@pytest.mark.parametrize("mode", ["skip", "tiled_sortonly"])
@pytest.mark.parametrize("count", [True, False], ids=["count", "alpha"])
def test_timing_stub_modes_give_zeros(mode, count):
    """'skip' and 'tiled_sortonly' (the sort kept, no reduction) give the
    zeros JAX gives."""
    lin, rgb, alpha, n_t = _est2_updates(23, count)
    got, want = _both(mode, lin, rgb, alpha, n_t, count)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.shape == (n_t, 4) and not got.any()
