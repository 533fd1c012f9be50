"""The port's tiled splat reductions (K5's plain version, the bf16x2
payload, the mode dispatch) against the JAX package on the CPU.

JAX runs `scatter_add_rgba_tiled` with its Pallas tile kernels in
interpret mode.  Its one-hot matmul may associate a pixel's sum in another
order than the port's one-add-at-a-time sum, so counts are held exactly
and every other channel to float32 re-association (rtol 1e-6, and 1e-6 of
the channel's largest sum where a sum cancels to ~0).  The port's own
orders are held bit for bit: K5's plain version is a sequential sum in
sorted order.  With `segments` S both packages sort each of the S runs on
its own and sum a pixel's updates run by run, the order the flat stable
sort gives them: the port's segmented sums equal its flat ones bit for
bit, and JAX's `segments=3` results are held to the same tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.ops.splat import scatter_add_rgba as jscatter
from fyp_bidirectionalpathtracer_tpu.ops.splat_tile import _pack2bf16 as jpack2bf16
from fyp_bidirectionalpathtracer_tpu.ops.splat_tile import _unpack2bf16 as junpack2bf16
from fyp_bidirectionalpathtracer_tpu.ops.splat_tile import scatter_add_rgba_tiled as jtiled
from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat import resolve_mode, scatter_add_rgba
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat_tile import (
    pack2bf16,
    reduce_rows_plain,
    scatter_add_rgba_tiled,
    splat_reduce_rows,
    unpack2bf16,
)
from torch_threads import one_intra_op_thread  # noqa: F401

N_TARGETS = 2500          # no multiple of the 1024-pixel tile; sentinel 3072
U = 3 * 1400              # three depth segments


def _updates(u=U, n_targets=N_TARGETS, seed=0):
    """Targets with dropped ones (< 0, == n_targets, past the sentinel),
    non-negative rgb over eight decades, and a real-valued alpha."""
    rs = np.random.RandomState(seed)
    lin = rs.randint(0, n_targets, size=u).astype(np.int32)
    drop = rs.rand(u)
    lin[drop < 0.05] = -1 - rs.randint(0, 5, size=int((drop < 0.05).sum()))
    lin[(drop >= 0.05) & (drop < 0.08)] = n_targets
    lin[(drop >= 0.08) & (drop < 0.1)] = n_targets + 5000
    rgb = (rs.rand(u, 3) * 10.0 ** rs.uniform(-4, 4, size=(u, 1))).astype(np.float32)
    alpha = rs.rand(u).astype(np.float32)
    return lin, rgb, alpha


def _check_sums(got: np.ndarray, want: np.ndarray, count: bool):
    assert got.shape == want.shape and got.dtype == np.float32
    if count:
        np.testing.assert_array_equal(got[:, 3], want[:, 3])
    cols = 3 if count else 4
    for c in range(cols):
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want[:, c]).max()))


def test_pack2bf16_bit_equal():
    """Round to nearest even, ties, subnormals, infinities, both halves."""
    rs = np.random.RandomState(3)
    x = (rs.normal(size=5000) * 10.0 ** rs.uniform(-30, 30, size=5000)).astype(np.float32)
    x[:100] = (np.arange(100, dtype=np.float32) + 0.5) * np.float32(2.0 ** -7) + 1.0  # ties
    x[100:200] = np.float32(1e-40) * rs.rand(100).astype(np.float32)               # subnormal
    x[200:204] = [np.inf, -np.inf, 0.0, -0.0]
    y = x[::-1].copy()
    want = np.asarray(jpack2bf16(jnp.asarray(x), jnp.asarray(y)))
    got = pack2bf16(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for w, g in zip(junpack2bf16(jnp.asarray(want)), unpack2bf16(got)):
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


CASES = [  # (pack, alpha_is_count, segments, mxu_bf16)
    ("f32", True, 1, False), ("f32", True, 3, False),
    ("f32", False, 1, False), ("f32", False, 3, False),
    ("bf16", True, 1, False), ("bf16", True, 3, True),
    ("bf16", False, 1, True), ("bf16", False, 3, False),
    ("rgb8e", True, 1, True), ("rgb8e", True, 3, True),
]


@pytest.mark.parametrize("pack,count,segments,mxu", CASES,
                         ids=[f"{p}-{'count' if c else 'alpha'}-s{s}{'-mxu' if m else ''}"
                              for p, c, s, m in CASES])
def test_tiled_matches_jax(pack, count, segments, mxu):
    lin, rgb, alpha = _updates()
    want = np.asarray(jtiled(jnp.asarray(lin), jnp.asarray(rgb), jnp.asarray(alpha),
                             N_TARGETS, count, interpret=True, pack=pack, mxu_bf16=mxu,
                             segments=segments))
    got = scatter_add_rgba_tiled(torch.from_numpy(lin), torch.from_numpy(rgb),
                                 torch.from_numpy(alpha), N_TARGETS, count, pack=pack,
                                 mxu_bf16=mxu, segments=segments)
    _check_sums(got.numpy(), want, count)
    assert float(got[:, 3].sum()) > 0


def test_tiled_empty_and_segments_order():
    """An empty input gives zeros; `segments=3` (three runs, each sorted on
    its own, summed run by run by K5's plain version) equals the flat sort's
    sums bit for bit, for every pack; a count that does not divide U takes
    one run, as JAX's does."""
    empty = scatter_add_rgba_tiled(torch.zeros(0, dtype=torch.int32), torch.zeros(0, 3),
                                   torch.zeros(0), 100, True)
    assert empty.shape == (100, 4) and not bool(empty.any())
    lin, rgb, alpha = (torch.from_numpy(a) for a in _updates(seed=1))
    for pack, count in (("f32", True), ("f32", False), ("bf16", True), ("rgb8e", True)):
        flat = scatter_add_rgba_tiled(lin, rgb, alpha, N_TARGETS, count, pack=pack)
        seg = scatter_add_rgba_tiled(lin, rgb, alpha, N_TARGETS, count, pack=pack, segments=3)
        assert torch.equal(flat.view(torch.int32), seg.view(torch.int32)), pack
        odd = scatter_add_rgba_tiled(lin, rgb, alpha, N_TARGETS, count, pack=pack, segments=11)
        assert U % 11 and torch.equal(flat.view(torch.int32), odd.view(torch.int32)), pack


def test_reduce_rows_plain_is_the_sequential_sum():
    """K5's plain version equals a literal float32 loop over each pixel's
    updates in sorted order, for float32 and bfloat16 rows and a count
    alpha."""
    rs = np.random.RandomState(4)
    m, n_t = 1200, 50
    keys = np.sort(rs.randint(0, n_t + 3, size=m)).astype(np.int32)
    vals = (rs.rand(4, m) * 10.0 ** rs.uniform(-3, 3, size=(1, m))).astype(np.float32)
    for dtype, rows in ((torch.float32, 4), (torch.bfloat16, 3)):
        v = torch.from_numpy(vals[:rows]).to(dtype)
        got = reduce_rows_plain(torch.from_numpy(keys), v, n_t).numpy()
        vf = v.float().numpy()
        want = np.zeros((n_t, 4), np.float32)
        for i in range(m):
            if keys[i] < n_t:
                upd = vf[:, i] if rows == 4 else np.append(vf[:, i], np.float32(1.0))
                want[keys[i]] = (want[keys[i]] + upd).astype(np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_splat_reduce_rows_checks_and_cpu_plain():
    keys = torch.tensor([0, 1, 1, 5], dtype=torch.int32)
    cuda.reset_launch_counts()
    out = splat_reduce_rows(keys, torch.ones(4, 4), 4)
    assert out.tolist() == [[1.0] * 4, [2.0] * 4, [0.0] * 4, [0.0] * 4]
    assert cuda.LAUNCHES["splat_rows"] == 0
    with pytest.raises(ValueError):
        splat_reduce_rows(keys, torch.ones(2, 4), 4)
    with pytest.raises(ValueError):
        splat_reduce_rows(keys.reshape(2, 2), torch.ones(4, 4), 4)
    with pytest.raises(TypeError):
        splat_reduce_rows(keys, torch.ones(4, 4, dtype=torch.float64), 4)


MODES = [("tiled", True), ("tiled_bf16", True), ("tiled_bf16w", True),
         ("tiled_rgb8e", True), ("tiled_bf16w", False), ("direct", False)]


@pytest.mark.parametrize("mode,count", MODES, ids=[f"{m}-{c}" for m, c in MODES])
def test_modes_match_jax_dispatch(mode, count):
    """Each mode through `scatter_add_rgba` against JAX's dispatch of the
    same mode (tiled modes in interpret mode on the CPU)."""
    lin, rgb, alpha = _updates(u=1500, seed=2)
    lin[lin < 0] = N_TARGETS  # JAX's direct mode wraps negative targets
    want = np.asarray(jscatter(mode, jnp.asarray(lin), jnp.asarray(rgb), jnp.asarray(alpha),
                               N_TARGETS, alpha_is_count=count))
    got = scatter_add_rgba(mode, torch.from_numpy(lin), torch.from_numpy(rgb),
                           torch.from_numpy(alpha), N_TARGETS, alpha_is_count=count)
    _check_sums(got.numpy(), want, count and mode != "direct")


def test_auto_resolution_and_refused_modes():
    """'auto': tiled_rgb8e for a count alpha on a CUDA device, tiled_bf16w
    for any other alpha there (as JAX on the TPU), direct on the CPU; every
    mode of JAX's runs (none raises any more), and a mode JAX does not have
    raises."""
    assert resolve_mode("auto", True, True) == "tiled_rgb8e"
    assert resolve_mode("auto", True, False) == "tiled_bf16w"
    assert resolve_mode("auto", False, True) == resolve_mode("auto", False, False) == "direct"
    assert resolve_mode("tiled", True, True) == "tiled"
    lin = torch.tensor([0, 3, 3, 8], dtype=torch.int32)
    for mode in ("direct", "sorted", "packed", "complex", "tiled", "tiled_bf16", "tiled_bf16w",
                 "tiled_rgb8e", "tiled_sortonly", "skip", "auto"):
        out = scatter_add_rgba(mode, lin, torch.ones(4, 3), torch.ones(4), 8, alpha_is_count=True)
        assert out.shape == (8, 4), mode
    with pytest.raises(ValueError, match="unknown"):
        scatter_add_rgba("tiled_fp8", lin, torch.zeros(4, 3), torch.ones(4), 8)


def test_segmented_rows_reduction_and_checks():
    """K5's plain version with segments=3: three sorted runs summed run by
    run, bit-equal to a literal loop that takes a pixel's updates of run 0,
    then of run 1, then of run 2; a run count that does not divide M
    raises in the wrapper and the plain version."""
    rs = np.random.RandomState(8)
    m, n_t = 3 * 500, 40
    keys = np.sort(rs.randint(0, n_t + 3, size=(3, m // 3)), axis=1).astype(np.int32).ravel()
    vals = (rs.rand(4, m) * 10.0 ** rs.uniform(-3, 3, size=(1, m))).astype(np.float32)
    got = splat_reduce_rows(torch.from_numpy(keys), torch.from_numpy(vals), n_t, segments=3)
    want = np.zeros((n_t, 4), np.float32)
    for i in range(m):
        if keys[i] < n_t:
            want[keys[i]] = (want[keys[i]] + vals[:, i]).astype(np.float32)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="runs"):
        splat_reduce_rows(torch.from_numpy(keys), torch.from_numpy(vals), n_t, segments=7)
    with pytest.raises(ValueError, match="runs"):
        reduce_rows_plain(torch.from_numpy(keys), torch.from_numpy(vals), n_t, segments=0)
