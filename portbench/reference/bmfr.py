"""The BMFR denoiser's three stages (Koskela et al., TOG 2019), written
from the JAX package's `passes/bmfr.py`, which follows the app's
DenoisePass (preprocess.ps.hlsl, regressionCP.hlsl, postprocess.ps.hlsl):

- preprocess: each pixel's world position projected through the previous
  view-projection matrix; the four bilinear taps of the history there kept
  where their position lies within 0.1 and their normal within 1 of the
  pixel's; the noisy colour blended with their mean at max(1 / (spp + 1),
  0.2), spp carried in alpha;
- the fit: blocks of 32 x 32 pixels, shifted by the frame's offset of the
  table of 16, edges mirrored; per block the least-squares fit of the
  colour over albedo by ten features [1, normal, position, position^2]
  (the last six min/max-normalised over the block), a feature dropped
  where its part outside the span of the features kept before it is 0.01
  or less; the fitted colour, at least 0, times the albedo;
- postprocess: the fit blended with the previous output's bilinear taps
  that the preprocess kept, at max(1 / spp, 0.1).

The fit is a solve of the normal equations a block in float64, not the
shaders' Householder QR: in exact arithmetic they give the same weights.
`step` also returns the history it writes, which the check compares.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

EDGE = 32
OFFSETS = ((-30, -30), (-12, -22), (-24, -2), (-8, -16), (-26, -24), (-14, -4), (-4, -28),
           (-26, -16), (-4, -2), (-24, -32), (-10, -10), (-18, -18), (-12, -30), (-32, -4),
           (-2, -20), (-22, -12))
KEEP_NORM = 0.01


@dataclass
class History:
    pos: torch.Tensor        # [H, W, 4] the last frame's WorldPosition
    norm: torch.Tensor       # [H, W, 4] its WorldNormal
    noisy: torch.Tensor      # [H, W, 4] its preprocessed colour, spp in alpha
    filtered: torch.Tensor   # [H, W, 4] its output
    frame: int               # frames denoised so far

    @classmethod
    def fresh(cls, height, width, device, dtype=torch.float64):
        z = torch.zeros((height, width, 4), dtype=dtype, device=device)
        return cls(z, z, z, z, 0)


def _taps(prev_view_proj, pos):
    """The bilinear footprint of each pixel's position in the last frame:
    (x0, y0 integer corners, the four weights, on screen)."""
    h, w = pos.shape[:2]
    p = torch.cat([pos[..., :3], torch.ones_like(pos[..., :1])], -1)
    clip = p @ prev_view_proj.T
    ux = (clip[..., 0] / clip[..., 3] + 1.0) * 0.5
    uy = (1.0 - clip[..., 1] / clip[..., 3]) * 0.5
    on_screen = (ux >= 0) & (ux <= 1) & (uy >= 0) & (uy <= 1)
    fx, fy = ux * w - 0.5, uy * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    ax, ay = fx - x0, fy - y0
    weights = ((1 - ax) * (1 - ay), ax * (1 - ay), (1 - ax) * ay, ax * ay)
    return x0.to(torch.int64), y0.to(torch.int64), weights, on_screen


def _at(img, x, y):
    h, w = img.shape[:2]
    return img[y.clamp(0, h - 1), x.clamp(0, w - 1)]


CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def preprocess(hist: History, pos, norm, noisy, prev_view_proj):
    """(blended colour with spp [H, W, 4], kept taps [4 x H, W] bool, the footprint)."""
    h, w = noisy.shape[:2]
    x0, y0, weights, on_screen = _taps(prev_view_proj, pos)
    fresh = hist.frame <= 0
    colour = torch.zeros_like(noisy[..., :3])
    spp = torch.zeros_like(noisy[..., 0])
    total = torch.zeros_like(spp)
    kept = []
    for (dx, dy), wt in zip(CORNERS, weights):
        x, y = x0 + dx, y0 + dy
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        near = ((_at(hist.pos, x, y)[..., :3] - pos[..., :3]) ** 2).sum(-1) < 0.01
        alike = ((_at(hist.norm, x, y)[..., :3] - norm[..., :3]) ** 2).sum(-1) < 1.0
        keep = inside & near & alike & on_screen & (not fresh)
        kept.append(keep)
        wk = torch.where(keep, wt, torch.zeros_like(wt))
        tap = _at(hist.noisy, x, y)
        colour = colour + wk[..., None] * tap[..., :3]
        spp = spp + wk * tap[..., 3]
        total = total + wk
    some = total > 0
    colour = torch.where(some[..., None], colour / total.clamp(min=1e-20)[..., None], 0 * colour)
    spp = torch.where(some, spp / total.clamp(min=1e-20), 0 * spp)
    blend = torch.where(some, torch.clamp(1.0 / (spp + 1.0), min=0.2), torch.ones_like(spp))
    new_spp = torch.where(blend < 1.0, 1.0 + spp, torch.ones_like(spp))
    out = blend[..., None] * noisy[..., :3] + (1.0 - blend[..., None]) * colour
    return torch.cat([out, new_spp[..., None]], -1), kept, (x0, y0, weights)


def _mirror(i, n):
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - i - 1, i)


def fit(pos, norm, albedo, noisy, frame: int):
    """The regression's output [H, W, 4]: the fitted colour, noisy's alpha."""
    h, w = noisy.shape[:2]
    ox, oy = OFFSETS[frame % 16]
    nbx, nby = (w + EDGE - 1) // EDGE + 1, (h + EDGE - 1) // EDGE + 1
    dev = noisy.device
    ys = _mirror(torch.arange(nby * EDGE, device=dev) + oy, h)
    xs = _mirror(torch.arange(nbx * EDGE, device=dev) + ox, w)
    table = torch.cat([pos[..., :3], norm[..., :3], albedo[..., :3], noisy[..., :3]], -1)
    win = table[ys][:, xs]                                   # [nby*32, nbx*32, 12]
    blocks = (win.reshape(nby, EDGE, nbx, EDGE, 12).permute(0, 2, 1, 3, 4)
              .reshape(nby * nbx, EDGE * EDGE, 12))
    p, n, alb, c = blocks[..., 0:3], blocks[..., 3:6], blocks[..., 6:9], blocks[..., 9:12]
    y = torch.where(alb < 0.01, torch.zeros_like(c), c / alb.clamp(min=1e-20))
    feats = torch.cat([torch.ones_like(p[..., :1]), n, p, p * p], -1)   # [B, 1024, 10]
    scaled = feats[..., 4:]
    lo = scaled.amin(1, keepdim=True)
    span = scaled.amax(1, keepdim=True) - lo
    scaled = torch.where(span > 1.0, (scaled - lo) / torch.where(span > 1.0, span, 1.0),
                         scaled - lo)
    x = torch.cat([feats[..., :4], scaled], -1)
    gram = x.transpose(1, 2) @ x                              # [B, 10, 10]
    rhs = x.transpose(1, 2) @ y                               # [B, 10, 3]
    kept = torch.zeros(gram.shape[:2], dtype=torch.bool, device=dev)
    eye = torch.eye(10, dtype=x.dtype, device=dev)
    for col in range(10):
        # the part of column col outside the span of the columns kept so far
        m = kept.to(x.dtype)
        g_kk = gram * m[:, :, None] * m[:, None, :] + torch.diag_embed(1.0 - m)
        proj = torch.linalg.solve(g_kk, gram[:, :, col] * m)
        rest = gram[:, col, col] - (gram[:, :, col] * m * proj).sum(1)
        kept[:, col] = torch.sqrt(rest.clamp(min=0.0)) > KEEP_NORM
    m = kept.to(x.dtype)
    weights = torch.linalg.solve(gram * m[:, :, None] * m[:, None, :] + torch.diag_embed(1.0 - m),
                                 rhs * m[:, :, None])
    fitted = alb * (x @ weights).clamp(min=0.0)
    img = (fitted.reshape(nby, nbx, EDGE, EDGE, 3).permute(0, 2, 1, 3, 4)
           .reshape(nby * EDGE, nbx * EDGE, 3))
    # the window starts at (oy, ox); image pixel (i, j) is window pixel (i - oy, j - ox)
    rgb = img[-oy:-oy + h, -ox:-ox + w]
    return torch.cat([rgb, noisy[..., 3:4]], -1)


def postprocess(hist: History, fitted, kept, footprint):
    x0, y0, weights = footprint
    colour = torch.zeros_like(fitted[..., :3])
    total = torch.zeros_like(fitted[..., 0])
    for (dx, dy), wt, keep in zip(CORNERS, weights, kept):
        wk = torch.where(keep, wt, torch.zeros_like(wt))
        colour = colour + wk[..., None] * _at(hist.filtered, x0 + dx, y0 + dy)[..., :3]
        total = total + wk
    some = (total > 0) & torch.stack(kept).any(0) & (hist.frame > 0)
    spp = fitted[..., 3]
    blend = torch.where(some, torch.clamp(1.0 / spp.clamp(min=1e-20), min=0.1),
                        torch.ones_like(spp))
    colour = torch.where(some[..., None], colour / total.clamp(min=1e-20)[..., None], 0 * colour)
    out = blend[..., None] * fitted[..., :3] + (1.0 - blend[..., None]) * colour
    return torch.cat([out, torch.ones_like(out[..., :1])], -1)


def step(hist: History, pos, norm, albedo, noisy, prev_view_proj):
    """One frame of every stage: (output [H, W, 4], the history it writes)."""
    blended, kept, footprint = preprocess(hist, pos, norm, noisy, prev_view_proj)
    fitted = fit(pos, norm, albedo, blended, hist.frame)
    out = postprocess(hist, fitted, kept, footprint)
    return out, History(pos=pos, norm=norm, noisy=blended, filtered=out, frame=hist.frame + 1)
