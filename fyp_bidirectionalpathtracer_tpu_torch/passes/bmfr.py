"""BMFR denoiser: Blockwise Multi-Order Feature Regression.

Port of `fyp_bidirectionalpathtracer_tpu/passes/bmfr.py`, the reference's
3-stage DenoisePass (Passes/DenoisePass.cpp:148-279):

  1. preprocess  (preprocess.ps.hlsl): temporal reprojection through
     prevViewProj, 2x2 bilinear tap acceptance by world-position and
     normal distance, exponential blend alpha = max(1/(spp+1), 0.2), spp
     carried in alpha.
  2. regression  (regressionCP.hlsl): per 32x32 block, the 13-column
     feature matrix [1, n, p, p^2, rgb/albedo], min/max normalization,
     Householder QR (or its normal-equations form) and back-substitution
     for the 3 colour channels, in the IGNORE_LD_fEATURES (rank-deficient
     column skip) and add-noise variants.  On CUDA tensors the QR fit is
     one hand-written kernel, `csrc/bmfr_fit.cu`, a thread block a 32x32
     block; the plain version (every block one batch element of
     [B, 1024, 13] torch math) is the CPU path and the normal-equations
     solver's.
  3. postprocess (postprocess.ps.hlsl): second temporal accumulation of
     the filtered frame, alpha = max(1/spp, 0.1).

The pass runs on the device of its inputs and keeps the frame counter on
that device: the frame's block offset, the add-noise pattern and the
first-frame gates are index and elementwise operations on it, so a frame
never waits on a copy to the host.  Every product (Gram, reflections, the
fit) is an elementwise multiply and sum in float32, never a matmul, so no
TF32 setting reaches it.  The fit kernel replaces no TPU kernel (JAX's pass
is plain `jnp`): it reads the frame counter on the device too, and follows
the plain version's float32 arithmetic with its sums in another order.

Row-sharded mode (`bmfr_pass(mesh=)`, `parallel/sharding.py`): each rank
holds its rows of the channels and the history.  The reprojection taps
come from a history window of +-`shard_history_margin` rows exchanged with
the neighbours (`_extend_rows`; taps reprojecting further are rejected
like off-screen taps, as in JAX), and the regression recomputes the
32x32 blocks that straddle a shard boundary from identical halo rows
(`regression_sharded`).  'auto' settings take JAX's choice off the TPU:
solver 'qr', history pack 'f32'.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np
import torch

from .. import cuda
from ..ops.splat_tile import pack2bf16, unpack2bf16
from ..utils.profiler import span

BLOCK_EDGE = 32
BLOCK_PIXELS = 1024
FEATURES = 10
BUFFERS = 13
FEATURES_NOT_SCALED = 4

# regressionCP.hlsl:40-58, (x, y) by frame_number % 16
BLOCK_OFFSETS = (
    (-30, -30), (-12, -22), (-24, -2), (-8, -16), (-26, -24), (-14, -4),
    (-4, -28), (-26, -16), (-4, -2), (-24, -32), (-10, -10), (-18, -18),
    (-12, -30), (-32, -4), (-2, -20), (-22, -12),
)
# the block window reaches image rows and columns [-_PAD_L, n + _PAD_R):
# JAX pads the image by these (symmetric) before it slices the window
_PAD_L = BLOCK_EDGE
_PAD_R = 2 * BLOCK_EDGE

_MASK = 0xFFFFFFFF


@dataclass(frozen=True)
class BMFRState:
    """History textures (DenoisePass.h mInputTex) and the frame counter."""

    prev_pos: torch.Tensor       # [H,W,4]
    prev_norm: torch.Tensor      # [H,W,4]
    prev_noisy: torch.Tensor     # [H,W,4]
    prev_filtered: torch.Tensor  # [H,W,4]
    frame_number: torch.Tensor   # [] int32 (mAccumCount)

    @classmethod
    def create(cls, height: int, width: int, device="cuda") -> "BMFRState":
        device = cuda.resolve_device(device)
        z = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
        return cls(prev_pos=z, prev_norm=z, prev_noisy=z, prev_filtered=z,
                   frame_number=torch.zeros((), dtype=torch.int32, device=device))

    @classmethod
    def from_arrays(cls, arrays: dict, device="cuda") -> "BMFRState":
        """From the JAX BMFRState's fields as numpy arrays ({"prev_pos":
        [H,W,4], ..., "frame_number": []}), on the card unless named."""
        device = cuda.resolve_device(device)

        def t(name, dtype):
            return torch.tensor(np.asarray(arrays[name], dtype), device=device)

        return cls(prev_pos=t("prev_pos", np.float32), prev_norm=t("prev_norm", np.float32),
                   prev_noisy=t("prev_noisy", np.float32),
                   prev_filtered=t("prev_filtered", np.float32),
                   frame_number=t("frame_number", np.int32))


def _mirror(idx, size: int):
    """Mirror addressing (regressionCP.hlsl:60-68)."""
    idx = torch.where(idx < 0, idx.abs() - 1, idx)
    return torch.where(idx >= size, 2 * size - idx - 1, idx)


def _symmetric(idx, size: int):
    """The image index that `jnp.pad(mode="symmetric")` puts at `idx`: the
    edge repeated, period 2 * size.  Equal to `_mirror` within one
    reflection; past it (an image smaller than the block window) the
    padding repeats, which `_mirror` does not."""
    m = torch.remainder(idx, 2 * size)
    return torch.where(m >= size, 2 * size - 1 - m, m)


def _extend_rows(x, n_top: int, n_bot: int, mesh, mode: str):
    """Rows [row0 - n_top, row0 + sub_h + n_bot) of the full image around
    this rank's block `x` [sub_h, W, C] (JAX `_extend_rows`).  Rows outside
    the image are the image reflected (mode 'symmetric', as `jnp.pad`) or
    zero ('zero').  Halos that fit in one neighbour's rows come from the
    neighbours (one exchange); past that (tiny shards) every rank gathers
    the whole image."""
    sub_h = x.shape[0]
    full_h = sub_h * mesh.size
    if 0 < n_top <= sub_h and 0 < n_bot <= sub_h:
        above, below = mesh.exchange_rows(x[:n_bot], x[-n_top:])
        edge = (lambda rows: rows.flip(0)) if mode == "symmetric" else torch.zeros_like
        top = edge(x[:n_top]) if above is None else above
        bot = edge(x[-n_bot:]) if below is None else below
        return torch.cat([top, x, bot], 0)
    if mode == "symmetric" and max(n_top, n_bot) > full_h:
        raise ValueError(f"sharded BMFR needs image height >= halo ({max(n_top, n_bot)})")
    full = mesh.gather_rows(x)
    row0 = mesh.rank * sub_h
    rows = torch.arange(row0 - n_top, row0 + sub_h + n_bot, device=x.device)
    if mode == "symmetric":
        return full[_symmetric(rows, full_h)]
    inside = (rows >= 0) & (rows < full_h)
    out = full[rows.clamp(0, full_h - 1)]
    return torch.where(inside.reshape((-1,) + (1,) * (x.dim() - 1)), out, torch.zeros_like(out))


@lru_cache(maxsize=None)
def _offsets_table(device: torch.device) -> torch.Tensor:
    """BLOCK_OFFSETS on `device`, made once a device (a copy from the host
    each frame would wait on the device's queue)."""
    return torch.tensor(BLOCK_OFFSETS, dtype=torch.int64, device=device)


def _gather_2x2(img, base):
    """The four bilinear taps of `img` [H, W, C] at integer base coords
    `base` [..., 2] (x, y): [..., 4C], tap-major in the order (0,0), (1,0),
    (0,1), (1,1), each coordinate clamped to the image.  The semantics of
    JAX's `_gather_2x2(_pack_2x2(img), base, h, w)`, one gather."""
    h, w, c = img.shape
    bx, by = base[..., 0].long(), base[..., 1].long()
    xs = torch.stack([bx, bx + 1, bx, bx + 1], -1).clamp(0, w - 1)
    ys = torch.stack([by, by, by + 1, by + 1], -1).clamp(0, h - 1)
    taps = img.reshape(-1, c)[ys * w + xs]
    return taps.reshape(*base.shape[:-1], 4 * c)


def _tap_base(pixel_f, h: int, w: int):
    """floor(pixel_f) as int32, with NaN, infinite and far-off coords (off
    the screen, so no tap of theirs is valid) moved just outside the image:
    a float -> int cast of those differs between the CPU and CUDA."""
    lim = float(max(h, w) + 1)
    return torch.nan_to_num(torch.floor(pixel_f), nan=-2.0).clamp(-2.0, lim).to(torch.int32)


def _bilinear_weights(pixel_f):
    frac = pixel_f - torch.floor(pixel_f)
    omf = 1.0 - frac
    return (omf[..., 0] * omf[..., 1], frac[..., 0] * omf[..., 1],
            omf[..., 0] * frac[..., 1], frac[..., 0] * frac[..., 1])


_TAP_OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _pack_hist_bf16(hist13):
    """[H,W,13] float32 history [pos3|norm3|noisy_rgb3|spp|filtered3] ->
    [H,W,7] int32 of bf16x2 pairs (BMFRConfig.history_pack).  Pair layout:
    (px,py)(pz,nx)(ny,nz)(nr,ng)(nb,spp)(fr,fg)(fb,0)."""
    padded = torch.cat([hist13, torch.zeros_like(hist13[..., :1])], -1)
    return pack2bf16(padded[..., 0::2], padded[..., 1::2])


def _unpack_hist_bf16(taps_i):
    """[...,28] int32 (4 taps x 7 pairs) -> (taps [...,40] in the f32 layout
    [pos3|norm3|noisy_rgb3|spp] a tap, filt_taps [...,12])."""
    lead = taps_i.shape[:-1]
    hi, lo = unpack2bf16(taps_i.reshape(*lead, 4, 7))
    vals = torch.stack([hi, lo], -1).reshape(*lead, 4, 14)
    return vals[..., :10].reshape(*lead, 40), vals[..., 10:13].reshape(*lead, 12)


def _hash_random(a):
    """random() (regressionCP.hlsl:78-87): integer hash -> [0,1) float32,
    in uint32 arithmetic (int64 values masked to 32 bits)."""
    a = a.to(torch.int64) & _MASK
    a = ((a + 0x7ED55D16) + (a << 12)) & _MASK
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _MASK
    a = ((a + 0x165667B1) + (a << 5)) & _MASK
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _MASK
    a = ((a + 0xFD7046C5) + (a << 3)) & _MASK
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & _MASK
    return a.to(torch.float32) / 4294967296.0


# ------------------------------------------------------------- preprocess
def preprocess(state: BMFRState, cur_pos, cur_norm, cur_noisy, prev_view_proj,
               cfg, pack: str = "f32", *, hist=None, hist_y0: int = 0,
               full_h: int | None = None):
    """Temporal reprojection + first blend (preprocess.ps.hlsl).

    Returns (blended_noisy [H,W,4] with spp in alpha, accept_bits [H,W]
    int32, prev_pixel_f [H,W,2], filt_taps): filt_taps is the
    postprocess's [H,W,12] prev_filtered tap block when pack='bf16'
    fetched it with the rest, else None.

    Sharded use: `hist` is the history window [Hh, W, C] whose row 0 is
    global row `hist_y0` ([pos3|norm3|noisy4], or its bf16 pack [Hh, W, 7]
    int32 under pack='bf16'), and `full_h` the image's height; taps
    landing outside the window are rejected like off-screen taps.  The
    defaults are the whole history of one device."""
    h, w = cur_noisy.shape[0], cur_noisy.shape[1]
    full_h = h if full_h is None else full_h
    wp = cur_pos[..., :3]
    nrm = cur_norm[..., :3]
    color = cur_noisy[..., :3]

    # project through prevViewProj (column vectors), the matrix as float32
    # scalars: a camera lives on the host, and a copy to the device would
    # wait on its queue
    x, y, z = wp[..., 0], wp[..., 1], wp[..., 2]
    m = prev_view_proj.to(torch.float32).tolist()
    cx = m[0][0] * x + m[0][1] * y + m[0][2] * z + m[0][3]
    cy = m[1][0] * x + m[1][1] * y + m[1][2] * z + m[1][3]
    cw = m[3][0] * x + m[3][1] * y + m[3][2] * z + m[3][3]
    inv_w = 1.0 / cw
    uvx = (cx * inv_w + 1.0) * 0.5
    uvy = (1.0 - cy * inv_w) * 0.5
    in_screen = (uvx >= 0.0) & (uvx <= 1.0) & (uvy >= 0.0) & (uvy <= 1.0)

    pixel_f = torch.stack([uvx * w, uvy * full_h], -1) - 0.5  # PIXEL_OFFSET
    base = _tap_base(pixel_f, full_h, w)
    weights = _bilinear_weights(pixel_f)
    win_base = _window_base(base, hist_y0)

    filt_taps = None
    if pack == "bf16":
        # one 13-value fetch a tap, the postprocess's prev_filtered taps too
        if hist is None:
            hist = _pack_hist_bf16(torch.cat(
                [state.prev_pos[..., :3], state.prev_norm[..., :3], state.prev_noisy,
                 state.prev_filtered[..., :3]], -1))
        taps, filt_taps = _unpack_hist_bf16(_gather_2x2(hist, win_base))
    else:
        if hist is None:
            hist = torch.cat([state.prev_pos[..., :3], state.prev_norm[..., :3],
                              state.prev_noisy], -1)
        taps = _gather_2x2(hist, win_base)  # [H, W, 40]
    hist_h = hist.shape[0]

    prev_color = torch.zeros_like(color)
    sample_spp = torch.zeros((h, w), dtype=torch.float32, device=color.device)
    total_weight = torch.zeros_like(sample_spp)
    accept = torch.zeros((h, w), dtype=torch.int32, device=color.device)
    for i, (dx, dy) in enumerate(_TAP_OFFSETS):
        sx = base[..., 0] + dx
        sy = base[..., 1] + dy
        valid = ((sx >= 0) & (sx < w) & (sy >= 0) & (sy < full_h)
                 & (sy >= hist_y0) & (sy < hist_y0 + hist_h))
        tap = taps[..., 10 * i:10 * (i + 1)]
        pos_ok = torch.sum((tap[..., 0:3] - wp) ** 2, -1) < cfg.position_limit_sq
        nrm_ok = torch.sum((tap[..., 3:6] - nrm) ** 2, -1) < cfg.normal_limit_sq
        ok = valid & pos_ok & nrm_ok
        accept = accept | (ok.to(torch.int32) << i)
        wgt = torch.where(ok, weights[i], 0.0)
        prev_color = prev_color + wgt[..., None] * tap[..., 6:9]
        sample_spp = sample_spp + wgt * tap[..., 9]
        total_weight = total_weight + wgt

    has_prev = total_weight > 0.0
    safe_weight = torch.clamp_min(total_weight, 1e-20)
    prev_color = torch.where(has_prev[..., None], prev_color / safe_weight[..., None], 0.0)
    sample_spp = torch.where(has_prev, sample_spp / safe_weight, 0.0)
    blend_alpha = torch.where(
        has_prev, torch.clamp_min(1.0 / (sample_spp + 1.0), cfg.blend_alpha), 1.0)

    reset = (state.frame_number <= 0) | ~in_screen
    blend_alpha = torch.where(reset, 1.0, blend_alpha)
    accept = torch.where(reset, 0, accept)

    new_spp = torch.where(blend_alpha < 1.0, 1.0 + sample_spp, 1.0)
    new_color = (blend_alpha[..., None] * color
                 + (1.0 - blend_alpha[..., None]) * prev_color)
    out = torch.cat([new_color, new_spp[..., None]], -1)

    if cfg.half_screen_debug:
        # texC.x > 0.5 early-out (preprocess.ps.hlsl:38); accept and the
        # prev pixel are read for the left half only
        out = torch.where(_right_half(w, out.device), cur_noisy, out)
    return out, accept, pixel_f, filt_taps


def _window_base(base, hist_y0: int):
    """Tap base coords relative to a history window starting at global row
    `hist_y0`."""
    if hist_y0 == 0:
        return base
    return torch.stack([base[..., 0], base[..., 1] - hist_y0], -1)


def _right_half(w: int, device):
    return (torch.arange(w, device=device) >= (w + 1) // 2)[None, :, None]


# ------------------------------------------------------------- regression
def _window_index(h: int, w: int, n_blocks_y: int, n_blocks_x: int, off):
    """[B, 1024] flat pixel index of each block pixel's source: pixel
    (block * 32 + local + off) in symmetric addressing (regressionCP.hlsl:
    104-124), block b = by * n_blocks_x + bx, pixel p = ly * 32 + lx.  `off`
    is the frame's (x, y) offset, a tensor on the device."""
    dev = off.device
    local = torch.arange(BLOCK_EDGE, device=dev)
    ys = (torch.arange(n_blocks_y, device=dev)[:, None] * BLOCK_EDGE + local) + off[1]
    xs = (torch.arange(n_blocks_x, device=dev)[:, None] * BLOCK_EDGE + local) + off[0]
    my, mx = _symmetric(ys, h), _symmetric(xs, w)
    idx = my[:, None, :, None] * w + mx[None, :, None, :]  # [by, bx, ly, lx]
    return idx.reshape(n_blocks_y * n_blocks_x, BLOCK_PIXELS)


def _features_from_window(rows):
    """The [B, 1024, 13] feature tensor and the albedo [B, 1024, 3] from the
    block window's rows [B, 1024, 12] = [pos3|norm3|albedo3|noisy_rgb3]."""
    p, n, alb, c = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], rows[..., 9:12]
    c_over_a = torch.where(alb < 0.01, 0.0, c / torch.clamp_min(alb, 1e-20))
    feats = torch.cat([torch.ones_like(p[..., :1]), n, p, p * p, c_over_a], -1)
    return feats, alb


def _normalize_features(x):
    """Min/max normalize the scaled features (regressionCP.hlsl:127-190)."""
    scaled = x[..., FEATURES_NOT_SCALED:FEATURES]
    cmin = scaled.amin(1, keepdim=True)
    span = scaled.amax(1, keepdim=True) - cmin
    big = span > 1.0
    scaled = torch.where(big, (scaled - cmin) / torch.where(big, span, 1.0), scaled - cmin)
    return torch.cat([x[..., :FEATURES_NOT_SCALED], scaled, x[..., FEATURES:]], -1)


def _col_dots(v, a):
    """sum_p v[b, p] * a[b, p, j] -> [B, J], elementwise float32."""
    return (v[:, :, None] * a).sum(1)


def _reflect(a, col: int, uvec, scale):
    """a[:, :, j] -= uvec * (dots_j * scale) for the columns j > col; the
    finished columns live in R."""
    rest = a[:, :, col + 1:]
    rest -= uvec[:, :, None] * (_col_dots(uvec, rest) * scale[:, None])[:, None, :]


def _qr_noise_pattern(frame_number, noise_amount: float, device=None):
    """The add_random noise image [1024, 13] (regressionCP.hlsl:89-98),
    the same for every block, on feature columns 1..9."""
    pid = torch.arange(BLOCK_PIXELS, dtype=torch.int64, device=device)[:, None]
    fid = torch.arange(BUFFERS, dtype=torch.int64, device=device)[None, :]
    frame = torch.as_tensor(frame_number, device=device).to(torch.int64)
    noise_idx = pid + fid * BLOCK_PIXELS + frame * (BUFFERS * BLOCK_PIXELS)
    noise = noise_amount * 2.0 * (_hash_random(noise_idx) - 0.5)
    return torch.where((fid >= 1) & (fid < FEATURES), noise, 0.0)


def _householder_qr_noise(a, frame_number, noise_amount: float):
    """The add_random variant (regressionCP.hlsl:346-466 path).
    a: [B, 1024, 13].  Returns weights [B, 10, 3]."""
    a = a + _qr_noise_pattern(frame_number, noise_amount, a.device)[None]
    b = a.shape[0]
    rows = torch.arange(BLOCK_PIXELS, device=a.device)
    rmat = torch.zeros((b, FEATURES, BUFFERS), dtype=torch.float32, device=a.device)
    for col in range(FEATURES):
        u = a[:, :, col]
        norm_sq = torch.where(rows > col, u * u, 0.0).sum(1)
        u_col = u[:, col]
        vec_len = torch.sqrt(norm_sq + u_col * u_col)
        u_new_col = u_col - vec_len
        u_len_sq = norm_sq + u_new_col * u_new_col
        uvec = torch.where(rows == col, u_new_col[:, None], u)
        uvec = torch.where(rows < col, 0.0, uvec)
        # R: rows < col keep the reduced values, row col is |v|
        rmat[:, :col, col] = a[:, :col, col]
        rmat[:, col, col] = vec_len
        _reflect(a, col, uvec, 2.0 / torch.clamp_min(u_len_sq, 1e-30))
    # Q^T y rows 0..9 live in the transformed colour columns
    return _back_substitute(rmat, a[:, :FEATURES, FEATURES:BUFFERS])


def _back_substitute(rmat, qty):
    """Weights [B, 10, 3] of the full-rank triangular system R w = Q^T y."""
    weights = torch.zeros_like(qty)
    wrows = qty.clone()
    for i in range(FEATURES - 1, -1, -1):
        wi = wrows[:, i, :] / rmat[:, i, i][:, None]
        weights[:, i, :] = wi
        if i > 0:
            wrows[:, :i, :] += -rmat[:, :i, i][:, :, None] * wi[:, None, :]
    return weights


def _back_substitute_ld(rmat, qty, limit):
    """LD back-substitution (regressionCP.hlsl:323-344): walk the columns
    9..0, taking pivot rows from `limit - 1` down for accepted columns
    (diag != 0); skipped columns get zero weights."""
    weights = torch.zeros_like(qty)
    wrows = qty
    limit = limit - 1
    ridx = torch.arange(FEATURES, device=qty.device)
    for i in range(FEATURES - 1, -1, -1):
        have = limit >= 0
        piv = limit.clamp_min(0)[:, None]
        diag = torch.where(have, rmat[:, :, i].gather(1, piv)[:, 0], 0.0)
        accepted = (diag != 0.0) & have
        piv_rhs = torch.where(have[:, None], wrows.gather(
            1, piv[:, :, None].expand(-1, 1, 3))[:, 0], 0.0)
        wi = torch.where(accepted[:, None],
                         piv_rhs / torch.where(accepted, diag, 1.0)[:, None], 0.0)
        weights[:, i, :] = wi
        new_limit = limit - accepted.to(limit.dtype)
        # wrows[r] -= R[r, i] * wi for the rows 0..new_limit
        row_mask = (ridx[None, :] <= new_limit[:, None]) & accepted[:, None]
        coeff = torch.where(row_mask, rmat[:, :, i], 0.0)
        wrows = wrows - coeff[:, :, None] * wi[:, None, :]
        limit = new_limit
    return weights


def _householder_qr_skip_ld(a):
    """The IGNORE_LD_fEATURES variant (regressionCP.hlsl:207-344): columns
    whose remaining norm is <= 0.01 are zeroed in R and skipped; the pivot
    row advances only on accepted columns.  Returns weights [B, 10, 3]
    (zeros for skipped columns)."""
    a = a.clone()
    b = a.shape[0]
    rows = torch.arange(BLOCK_PIXELS, device=a.device)[None, :]
    ridx = torch.arange(FEATURES, device=a.device)[None, :]
    rmat = torch.zeros((b, FEATURES, BUFFERS), dtype=torch.float32, device=a.device)
    limit = torch.zeros((b,), dtype=torch.int64, device=a.device)
    for col in range(FEATURES):
        u = a[:, :, col]
        lim = limit[:, None]
        norm_sq = torch.where(rows > lim, u * u, 0.0).sum(1)
        u_piv = u.gather(1, lim)[:, 0]
        vec_len = torch.sqrt(norm_sq + u_piv * u_piv)
        accept = vec_len > 0.01
        u_new_piv = u_piv - vec_len
        u_len_sq = norm_sq + u_new_piv * u_new_piv
        do_reflect = accept & (u_len_sq >= 0.001)

        uvec = torch.where(rows == lim, u_new_piv[:, None], u)
        uvec = torch.where(rows < lim, 0.0, uvec)

        # R column: rows < limit copy the reduced column, row limit gets
        # |v|, the rest zero; a rejected column is all zero
        r_col = torch.where(ridx < lim, a[:, :FEATURES, col], 0.0)
        r_col = torch.where(ridx == lim, vec_len[:, None], r_col)
        rmat[:, :, col] = torch.where(accept[:, None], r_col, 0.0)

        _reflect(a, col, uvec,
                 torch.where(do_reflect, 2.0 / torch.clamp_min(u_len_sq, 1e-30), 0.0))
        limit = limit + accept.to(limit.dtype)
    return _back_substitute_ld(rmat, a[:, :FEATURES, FEATURES:BUFFERS], limit)


def _gram(a):
    """[B, 13, 13] Gram matrix of a [B, 1024, 13], elementwise float32."""
    return torch.stack([_col_dots(a[:, :, i], a) for i in range(a.shape[-1])], 1)


def _normal_eq_factor(a, skip_ld: bool):
    """Cholesky factor of the Gram matrix with the reference's per-column
    skip rule: the normal-equations form of the Householder QR
    (BMFRConfig.regression_solver='normal').  Its pivot sqrt(G[c,c] -
    sum_k R[k,c]^2) is the QR's reduced column norm, so the accept rule
    (> 0.01), R and the transformed colour columns rmat[:, :, 10:13] match
    the QR up to float32 rounding.  Returns (rmat [B, 10, 13], limit [B])."""
    b = a.shape[0]
    g = _gram(a)
    rmat = torch.zeros((b, FEATURES, BUFFERS), dtype=torch.float32, device=a.device)
    limit = torch.zeros((b,), dtype=torch.int64, device=a.device)
    ridx = torch.arange(FEATURES, device=a.device)
    jidx = torch.arange(BUFFERS, device=a.device)
    accepts = []
    for col in range(FEATURES):
        cross = _col_dots(rmat[:, :, col], rmat)  # [B, 13]
        vec_len = torch.sqrt(torch.clamp_min(g[:, col, col] - cross[:, col], 0.0))
        accept = vec_len > 0.01 if skip_ld else torch.ones_like(vec_len, dtype=torch.bool)
        accepts.append(accept)
        row = (g[:, col, :] - cross) / torch.clamp_min(vec_len, 1e-30)[:, None]
        row = torch.where((jidx >= col)[None, :] & accept[:, None], row, 0.0)
        onehot = (ridx[None, :] == limit[:, None]).to(torch.float32)
        rmat = rmat + onehot[:, :, None] * row[:, None, :]
        limit = limit + accept.to(limit.dtype)
    # a rejected column's R entries are zero in the QR (regressionCP.hlsl:
    # 255-263); the factor wrote its projections while it was a candidate
    col_ok = torch.cat([torch.stack(accepts, -1),
                        torch.ones((b, BUFFERS - FEATURES), dtype=torch.bool,
                                   device=a.device)], -1)
    return torch.where(col_ok[:, None, :], rmat, 0.0), limit


def _normal_eq_skip_ld(a):
    """IGNORE_LD_fEATURES weights through the normal-equations factor and
    the QR version's back-substitution."""
    rmat, limit = _normal_eq_factor(a, skip_ld=True)
    return _back_substitute_ld(rmat, rmat[:, :, FEATURES:BUFFERS], limit)


def _normal_eq_noise(a, frame_number, noise_amount: float):
    """add_random-variant weights through the normal-equations factor (the
    noise added to `a` first, as `_householder_qr_noise` does)."""
    a = a + _qr_noise_pattern(frame_number, noise_amount, a.device)[None]
    rmat, _ = _normal_eq_factor(a, skip_ld=False)
    return _back_substitute(rmat, rmat[:, :, FEATURES:BUFFERS])


def _solve(x, frame_number, cfg):
    """The weights [B, 10, 3] of the configured solver and variant."""
    qr = cfg.regression_solver in ("qr", "auto")
    if cfg.remove_ld_features:
        return _householder_qr_skip_ld(x) if qr else _normal_eq_skip_ld(x)
    if qr:
        return _householder_qr_noise(x, frame_number, cfg.noise_amount)
    return _normal_eq_noise(x, frame_number, cfg.noise_amount)


def _fit_window(rows, frame_number, cfg):
    """Feature build + fit over the block rows [B, 1024, 12]; the fitted
    rgb [B, 1024, 3] (regressionCP.hlsl `fit` body)."""
    feats, alb = _features_from_window(rows)
    x = _normalize_features(feats)
    wts = _solve(x, frame_number, cfg)
    fitted = (x[..., :FEATURES, None] * wts[:, None, :, :]).sum(2)  # [B, 1024, 3]
    return alb * torch.clamp_min(fitted, 0.0)


def _blocks_x(w: int, cfg) -> int:
    n_blocks_x = (w + BLOCK_EDGE - 1) // BLOCK_EDGE + 1
    if cfg.half_screen_debug:
        n_blocks_x //= 2  # DenoisePass.cpp:266-268 halves horizontal coverage
    return n_blocks_x


def _check_channels(cur_pos, cur_norm, albedo, noisy, frame_number) -> None:
    """The regression's inputs as the fit kernel takes them, on every
    device: four float32 [H, W, 4] channels on one device, each with its
    pixels at one stride in row-major order (a contiguous image, or a
    plane-major view such as K1's G-buffer rows), and the frame counter an
    int32 scalar on the same device.  Raises on anything else."""
    dev = noisy.device
    for name, t in (("cur_pos", cur_pos), ("cur_norm", cur_norm), ("albedo", albedo),
                    ("noisy", noisy)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, noisy on {dev}")
        if t.dim() != 3 or t.shape != noisy.shape or t.shape[2] != 4:
            raise ValueError(f"{name} must be [H, W, 4] like noisy {tuple(noisy.shape)}, "
                             f"got {tuple(t.shape)}")
        if t.shape[0] > 1 and t.shape[1] > 1 and t.stride(0) != t.shape[1] * t.stride(1):
            raise ValueError(f"{name}'s pixels do not lie at one stride (strides {t.stride()})")
    if not isinstance(frame_number, torch.Tensor) or frame_number.dtype != torch.int32 \
            or frame_number.numel() != 1 or frame_number.device != dev:
        raise ValueError(f"frame_number must be one int32 on {dev}")


def _channel(t: torch.Tensor):
    """(pointer, pixel stride, channel stride) of a [rows, W, C] channel."""
    return t.data_ptr(), t.stride(1) if t.shape[1] > 1 else t.stride(0), t.stride(2)


def _qr_on_card(noisy, cfg) -> bool:
    """Whether the regression runs as the fit kernel: the QR solver
    (`regression_solver` 'qr' or 'auto') on a CUDA tensor.  The CPU, and
    the normal-equations solver on any device, take the plain version; a
    tensor on any other device raises."""
    if noisy.device.type == "cpu" or cfg.regression_solver not in ("qr", "auto"):
        return False
    if noisy.device.type != "cuda":
        raise ValueError(f"the BMFR fit kernel runs on CUDA tensors, not {noisy.device}")
    return True


def _fit_kernel(src, src_h: int, noisy, frame_number, cfg, n_by: int, row0: int,
                sharded: bool, kept=None):
    """Launch `csrc/bmfr_fit.cu` over n_by x n_blocks_x blocks.  `src`: the
    position, normal, albedo and noisy-rgb channels the blocks read (the
    image, or the rank's halo-extended rows); the output is noisy's shape,
    its alpha noisy's, and the pixels the window leaves keep noisy's
    colour (a copy, made only where the window does not cover the image).
    `kept`, an int32 [n_by * n_blocks_x] tensor or None, gets each block's
    accepted feature columns as bits (bit c: column c)."""
    out_h, w = noisy.shape[0], noisy.shape[1]
    n_bx = _blocks_x(w, cfg)
    if kept is not None:
        cuda.check_tensor("kept", kept, torch.int32, noisy.device)
        if kept.numel() != n_by * n_bx:
            raise ValueError(f"kept must hold {n_by * n_bx} blocks, got {kept.numel()}")
    out = torch.empty((out_h, w, 4), dtype=torch.float32, device=noisy.device)
    if (n_bx - 1) * BLOCK_EDGE < w:  # some offset's window leaves columns uncovered
        out.copy_(noisy)
    cuda.check_launch("bmfr_fit", cuda.library().bdpt_bmfr_fit(
        *_channel(src[0]), *_channel(src[1]), *_channel(src[2]), *_channel(src[3]),
        *_channel(noisy), src_h, w, cuda.ptr(frame_number), int(sharded), row0,
        int(cfg.remove_ld_features), 2.0 * cfg.noise_amount, n_bx, n_by, cuda.ptr(out), out_h,
        cuda.ptr(kept), cuda.stream(noisy.device)))
    return out


def regression(cur_pos, cur_norm, albedo, noisy, frame_number, cfg):
    """Fit + replace the noisy colour block by block (regressionCP.hlsl
    `fit`).  The blocks tile the image shifted by the frame's offset
    BLOCK_OFFSETS[frame_number % 16], one block row and column past it.

    On CUDA tensors the QR solver runs as one kernel, `csrc/bmfr_fit.cu`
    (counted in `cuda.LAUNCHES["bmfr_fit"]`); CPU tensors, and the
    normal-equations solver, take `regression_plain`."""
    _check_channels(cur_pos, cur_norm, albedo, noisy, frame_number)
    if not _qr_on_card(noisy, cfg):
        return regression_plain(cur_pos, cur_norm, albedo, noisy, frame_number, cfg)
    h = noisy.shape[0]
    return _fit_kernel((cur_pos, cur_norm, albedo, noisy), h, noisy, frame_number, cfg,
                       (h + BLOCK_EDGE - 1) // BLOCK_EDGE + 1, 0, False)


def regression_plain(cur_pos, cur_norm, albedo, noisy, frame_number, cfg):
    """`regression` in plain torch, on any device: the CPU path, and the
    arithmetic the fit kernel follows."""
    h, w = noisy.shape[0], noisy.shape[1]
    n_blocks_x = _blocks_x(w, cfg)
    n_blocks_y = (h + BLOCK_EDGE - 1) // BLOCK_EDGE + 1
    dev = noisy.device
    off = _offsets_table(dev).index_select(0, frame_number.reshape(1).to(torch.int64) % 16)[0]

    tab = torch.cat([cur_pos[..., :3], cur_norm[..., :3], albedo[..., :3],
                     noisy[..., :3]], -1).reshape(-1, 12)
    rows = tab[_window_index(h, w, n_blocks_y, n_blocks_x, off)]  # [B, 1024, 12]
    fitted = _fit_window(rows, frame_number, cfg).reshape(-1, 3)

    # write-back: pixel (y, x) lies at (y - off_y, x - off_x) of the window
    # (blocks are disjoint there); pixels the window leaves keep the noisy
    wy = torch.arange(h, device=dev)[:, None] - off[1]
    wx = torch.arange(w, device=dev)[None, :] - off[0]
    inside = ((wy >= 0) & (wy < n_blocks_y * BLOCK_EDGE)
              & (wx >= 0) & (wx < n_blocks_x * BLOCK_EDGE))
    block = (wy // BLOCK_EDGE) * n_blocks_x + wx // BLOCK_EDGE
    pix = (wy % BLOCK_EDGE) * BLOCK_EDGE + wx % BLOCK_EDGE
    src = torch.where(inside, block * BLOCK_PIXELS + pix, 0)
    new_rgb = torch.where(inside[..., None], fitted[src], noisy[..., :3])
    return torch.cat([new_rgb, noisy[..., 3:4]], -1)


def _halo_rows(cur_pos, cur_norm, albedo, noisy, mesh):
    """(n_loc, row0, ext): the block rows that can meet this rank's rows
    [row0, row0 + sub_h) at any frame offset, and the [pos3|norm3|albedo3|
    noisy_rgb3] table of its rows with their halo, from row0 - 32."""
    sub_h = noisy.shape[0]
    n_loc = (sub_h - 1) // BLOCK_EDGE + 2
    n_bot = BLOCK_EDGE * n_loc - sub_h
    tab = torch.cat([cur_pos[..., :3], cur_norm[..., :3], albedo[..., :3],
                     noisy[..., :3]], -1)
    return n_loc, mesh.rank * sub_h, _extend_rows(tab, BLOCK_EDGE, n_bot, mesh, "symmetric")


def regression_sharded(cur_pos, cur_norm, albedo, noisy, frame_number, cfg, mesh):
    """`regression` on this rank's rows [sub_h, W] of the mesh's image
    (JAX `regression_sharded`).  The rank fits every 32x32 block that
    meets its rows; a block that straddles a shard boundary is fitted by
    both neighbours from the same halo rows, and each writes back its own
    rows.  The halo: 32 rows above, 32 n_loc - sub_h (32..63) below
    (regressionCP.hlsl:28-58, DenoisePass.cpp:262-268).  On CUDA tensors
    the QR solver runs as the fit kernel over the halo-extended rows, as
    `regression` does; else `regression_sharded_plain`."""
    _check_channels(cur_pos, cur_norm, albedo, noisy, frame_number)
    if not _qr_on_card(noisy, cfg):
        return regression_sharded_plain(cur_pos, cur_norm, albedo, noisy, frame_number, cfg,
                                        mesh)
    n_loc, row0, ext = _halo_rows(cur_pos, cur_norm, albedo, noisy, mesh)
    src = tuple(ext[..., i:i + 3] for i in (0, 3, 6, 9))
    return _fit_kernel(src, ext.shape[0], noisy, frame_number, cfg, n_loc, row0, True)


def regression_sharded_plain(cur_pos, cur_norm, albedo, noisy, frame_number, cfg, mesh):
    """`regression_sharded` in plain torch, on any device."""
    sub_h, w = noisy.shape[0], noisy.shape[1]
    n_blocks_x = _blocks_x(w, cfg)
    n_loc, row0, ext = _halo_rows(cur_pos, cur_norm, albedo, noisy, mesh)
    dev = noisy.device
    off = _offsets_table(dev).index_select(0, frame_number.reshape(1).to(torch.int64) % 16)[0]
    # the first block row meeting row0 starts at global row g0 (<= row0),
    # row s of ext (in (0, 32])
    g0 = off[1] + BLOCK_EDGE * torch.div(row0 - off[1], BLOCK_EDGE, rounding_mode="floor")
    s = g0 - row0 + BLOCK_EDGE
    local = torch.arange(BLOCK_EDGE, device=dev)
    ys = torch.arange(n_loc, device=dev)[:, None] * BLOCK_EDGE + local + s
    xs = _symmetric(torch.arange(n_blocks_x, device=dev)[:, None] * BLOCK_EDGE + local + off[0], w)
    idx = ys[:, None, :, None] * w + xs[None, :, None, :]  # [by, bx, ly, lx]
    rows = ext.reshape(-1, 12)[idx.reshape(n_loc * n_blocks_x, BLOCK_PIXELS)]
    fitted = _fit_window(rows, frame_number, cfg).reshape(-1, 3)

    # write-back of this rank's rows; every row lies in the window
    wy = torch.arange(sub_h, device=dev)[:, None] + (row0 - g0)
    wx = torch.arange(w, device=dev)[None, :] - off[0]
    inside = (wx >= 0) & (wx < n_blocks_x * BLOCK_EDGE)
    block = (wy // BLOCK_EDGE) * n_blocks_x + wx // BLOCK_EDGE
    pix = (wy % BLOCK_EDGE) * BLOCK_EDGE + wx % BLOCK_EDGE
    src = torch.where(inside, block * BLOCK_PIXELS + pix, 0)
    new_rgb = torch.where(inside[..., None], fitted[src], noisy[..., :3])
    return torch.cat([new_rgb, noisy[..., 3:4]], -1)


# ------------------------------------------------------------ postprocess
def postprocess(state: BMFRState, filtered, accept, prev_pixel_f, cfg, taps=None, *,
                hist=None, hist_y0: int = 0, full_h: int | None = None):
    """Second temporal accumulation (postprocess.ps.hlsl).  `taps` is the
    [H,W,12] prev_filtered tap block when preprocess fetched it (bf16).
    Sharded use: `hist` is the prev_filtered window [Hh, W, 3] from global
    row `hist_y0`, with preprocess's margin, so every accepted tap lies in
    it; `full_h` the image's height."""
    h, w = filtered.shape[0], filtered.shape[1]
    color = filtered[..., :3]
    spp = filtered[..., 3]
    weights = _bilinear_weights(prev_pixel_f)
    if taps is None:
        if hist is None:
            hist = state.prev_filtered[..., :3]
        base = _tap_base(prev_pixel_f, h if full_h is None else full_h, w)
        taps = _gather_2x2(hist, _window_base(base, hist_y0))
    prev_color = torch.zeros_like(color)
    total_weight = torch.zeros_like(spp)
    for i in range(len(_TAP_OFFSETS)):
        wgt = torch.where((accept & (1 << i)) != 0, weights[i], 0.0)
        prev_color = prev_color + wgt[..., None] * taps[..., 3 * i:3 * (i + 1)]
        total_weight = total_weight + wgt

    has_prev = (total_weight > 0.0) & (accept > 0) & (state.frame_number > 0)
    blend_alpha = torch.where(
        has_prev, torch.clamp_min(1.0 / torch.clamp_min(spp, 1e-20), cfg.second_blend_alpha),
        1.0)
    prev_color = torch.where(
        has_prev[..., None], prev_color / torch.clamp_min(total_weight, 1e-20)[..., None], 0.0)
    out_rgb = blend_alpha[..., None] * color + (1.0 - blend_alpha[..., None]) * prev_color
    out = torch.cat([out_rgb, torch.ones_like(spp)[..., None]], -1)
    if cfg.half_screen_debug:
        out = torch.where(_right_half(w, out.device), filtered, out)
    return out


# ------------------------------------------------------------- full pass
def bmfr_pass(state: BMFRState, channels: dict, camera, cfg, *, mesh=None):
    """The denoise stage over the channel dict; returns (state, output).

    DenoisePass::execute's order: preprocess -> history blits
    (noisy/norm/pos) -> regression -> postprocess -> the filtered history.
    Disabled (the reference's default): a plain blit of Accumulated.

    Sharded mode (`mesh` of more than one rank): the channels and the
    history are this rank's rows of the mesh's image.  The
    reprojection taps come from a +-`shard_history_margin`-row window of
    history exchanged with the neighbours (JAX's rule: a tap reprojecting
    further is rejected like an off-screen tap, so the result equals one
    device's while motion between frames stays within the margin; the
    bf16 pack is applied before the exchange), and the regression fits
    the blocks of the rank's rows from exact 32-row halos."""
    cur_pos = channels["WorldPosition"]
    cur_norm = channels["WorldNormal"]
    albedo = channels["MaterialDiffuse"]
    noisy = channels["Accumulated"]

    # mDoDenoise master gate (DenoisePass.cpp:158)
    if not cfg.enabled or not (cfg.preprocess or cfg.regression or cfg.postprocess):
        return state, noisy

    # the combined bf16 fetch needs both stages' taps on one index vector;
    # 'auto' is 'f32', as in JAX off the TPU
    pack = ("bf16" if cfg.history_pack == "bf16" and cfg.preprocess and cfg.postprocess
            else "f32")
    sharded = mesh is not None and mesh.size > 1
    sub_h = noisy.shape[0]
    full_h = sub_h * mesh.size if sharded else sub_h
    margin = min(cfg.shard_history_margin, full_h)
    hist_y0 = mesh.rank * sub_h - margin if sharded else 0

    def window(x):  # the history rows the taps may reach
        return _extend_rows(x, margin, margin, mesh, "zero")

    filt_taps = None
    with span("preprocess"):
        if cfg.preprocess:
            hist = None
            if sharded:
                cols = [state.prev_pos[..., :3], state.prev_norm[..., :3], state.prev_noisy]
                hist = window(
                    _pack_hist_bf16(torch.cat(cols + [state.prev_filtered[..., :3]], -1))
                    if pack == "bf16" else torch.cat(cols, -1))
            noisy, accept, prev_pixel_f, filt_taps = preprocess(
                state, cur_pos, cur_norm, noisy, camera.prev_view_proj, cfg, pack=pack,
                hist=hist, hist_y0=hist_y0, full_h=full_h)
        else:
            # no reprojection: postprocess blends nothing (no accept bits)
            h, w, dev = noisy.shape[0], noisy.shape[1], noisy.device
            accept = torch.zeros((h, w), dtype=torch.int32, device=dev)
            ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                    torch.arange(w, dtype=torch.float32, device=dev),
                                    indexing="ij")
            prev_pixel_f = torch.stack([xs, ys], -1)

    # history blits (DenoisePass.cpp:180-182)
    state = replace(state, prev_noisy=noisy, prev_norm=cur_norm, prev_pos=cur_pos)

    if cfg.regression:
        with span("regression"):
            if sharded:
                noisy = regression_sharded(cur_pos, cur_norm, albedo, noisy,
                                           state.frame_number, cfg, mesh)
            else:
                noisy = regression(cur_pos, cur_norm, albedo, noisy, state.frame_number, cfg)

    if cfg.postprocess:
        with span("postprocess"):
            hist_f = None
            if sharded and filt_taps is None:  # bf16 fetched the taps in preprocess
                hist_f = window(state.prev_filtered[..., :3])
            out = postprocess(state, noisy, accept, prev_pixel_f, cfg, taps=filt_taps,
                              hist=hist_f, hist_y0=hist_y0, full_h=full_h)
            state = replace(state, prev_filtered=out)
    else:
        out = noisy
    return replace(state, frame_number=state.frame_number + 1), out
