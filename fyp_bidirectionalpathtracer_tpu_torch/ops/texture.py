"""Texture atlas sampling by gathers.

Port of `fyp_bidirectionalpathtracer_tpu/ops/texture.py`.  Every texture
lives in one stacked atlas [T, R, R, 4] and a lookup is a (slot, uv)
gather, so rays with different materials stay in one tensor op.  The JAX
module's taps are XLA gathers, so torch gathers are their counterpart
here, on whatever device the atlas lies on.

Semantics: wrap addressing and a bilinear filter (the scene loader binds a
linear wrap sampler, SceneLoaderWrapper.cpp:65-68); slot < 0 selects the
constant factor.  `TextureAtlas.packed` holds each texel's 2x2 wrap
neighbourhood in one 16-float row, so a bilinear tap is one gather;
`TextureAtlas.combined` holds base, specular and emissive neighbourhoods
of a material in one 12-word u8 row, so the three kinds are one gather.
"""
from __future__ import annotations

import torch


def _uv_to_texels(uv, res):
    """Wrap uv -> (x0i, y0i, fx, fy): integer texel coordinates [...] and
    lerp weights [..., 1]."""
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * res - 0.5
    y = v * res - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), res)
    y0i = torch.remainder(y0.to(torch.int64), res)
    return x0i, y0i, fx, fy


def _lerp2(c00, c10, c01, c11, fx, fy):
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_atlas_bilinear(atlas_data, slot, uv):
    """Bilinear tap of atlas[slot] at uv (wrap): slot [...], uv [..., 2] ->
    [..., 4].  Negative slots gather slot 0; the caller selects the
    constant.  Four 4-column gathers."""
    t, res = atlas_data.shape[0], atlas_data.shape[1]
    s = torch.clamp(slot.long(), 0, t - 1)
    x0i, y0i, fx, fy = _uv_to_texels(uv, res)
    x1i = torch.remainder(x0i + 1, res)
    y1i = torch.remainder(y0i + 1, res)
    return _lerp2(atlas_data[s, y0i, x0i], atlas_data[s, y0i, x1i],
                  atlas_data[s, y1i, x0i], atlas_data[s, y1i, x1i], fx, fy)


def sample_atlas_bilinear_packed(packed, slot, uv):
    """The bilinear tap as one 16-column gather from the wrap-packed atlas
    [T, R, R, 16] (c00 c10 c01 c11 a row, scene.Scene.bake)."""
    t, res = packed.shape[0], packed.shape[1]
    s = torch.clamp(slot.long(), 0, t - 1)
    x0i, y0i, fx, fy = _uv_to_texels(uv, res)
    row = packed[s, y0i, x0i]
    return _lerp2(row[..., 0:4], row[..., 4:8], row[..., 8:12], row[..., 12:16], fx, fy)


def _uv_to_texels_fm(u, v, res):
    """Field-major _uv_to_texels: u, v [N] -> (x0i, y0i, fx, fy), all [N]."""
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    x = u * res - 0.5
    y = v * res - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return (torch.remainder(x0.to(torch.int64), res), torch.remainder(y0.to(torch.int64), res),
            x - x0, y - y0)


def sample_bilinear_packed_fm(packed, slot, u, v):
    """Field-major bilinear tap: slot, u, v [N] -> [4, N] rgba, one gather
    of a flat [T*R*R, 16] row a lane and the lerps on [N] lane vectors."""
    t, res = packed.shape[0], packed.shape[1]
    s = torch.clamp(slot.long(), 0, t - 1)
    x0i, y0i, fx, fy = _uv_to_texels_fm(u, v, res)
    row_t = packed.reshape(t * res * res, 16)[(s * res + y0i) * res + x0i].T  # [16, N]
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy
    return row_t[0:4] * w00 + row_t[4:8] * w10 + row_t[8:12] * w01 + row_t[12:16] * w11


def sample_or_constant_fm(atlas, slot, u, v, constant, static_used: bool = True):
    """Field-major sample_or_constant: slot, u, v [N], constant [C <= 4, N]
    (or a broadcastable scalar) -> [4, N] (the constant as it is when the
    kind is statically unused).  Without the packed table the tap is the
    four-gather `sample_atlas_bilinear`."""
    if not static_used:
        return constant
    data = atlas.data
    if data.shape[1] == 1 and data.shape[2] == 1:
        if data.shape[0] == 1:
            tex = data[0, 0, 0][:, None]
        else:
            tex = data[torch.clamp(slot.long(), 0, data.shape[0] - 1), 0, 0].T
        return torch.where(slot >= 0, tex, constant)
    if atlas.packed is not None:
        tex = sample_bilinear_packed_fm(atlas.packed, slot, u, v)
    else:
        tex = sample_atlas_bilinear(data, slot, torch.stack([u, v], -1)).T
    return torch.where(slot >= 0, tex, constant)


def _u32_rgba(u):
    """Unpack 32-bit words (int32 bits of a little-endian u32) into [..., 4]
    float32 rgba in [0, 1]."""
    return torch.stack([((u >> s) & 0xFF).to(torch.float32) for s in (0, 8, 16, 24)],
                       -1) * (1.0 / 255.0)


def sample_combined(atlas, mat_id, uv):
    """(base, spec, emissive) [..., 4] from one gather of the combined
    material texel table (`TextureAtlas.combined`, [M*R*R, 12]).  Callers
    still select the constants for slot < 0 materials (those rows hold
    zeros)."""
    comb = atlas.combined
    res = atlas.resolution
    m = torch.clamp(mat_id.long(), min=0)
    x0i, y0i, fx, fy = _uv_to_texels(uv, res)
    row = comb[(m * res + y0i) * res + x0i]  # [..., 12]
    out = [_lerp2(*(_u32_rgba(row[..., 4 * k + c]) for c in range(4)), fx, fy)
           for k in range(3)]
    return out[0], out[1], out[2]


def sample_base_color(atlas, materials, mat_id, uv):
    """Base-colour tap for a material id (the combined table when there is
    one): the alpha test's one needed kind."""
    m = torch.clamp(mat_id.long(), min=0)
    const = materials.base_color[m]
    if atlas.combined is not None and atlas.any_base:
        base_t, _, _ = sample_combined(atlas, m, uv)
        return torch.where((materials.base_color_tex[m] >= 0)[..., None], base_t, const)
    return sample_or_constant(atlas, materials.base_color_tex[m], uv, const,
                              static_used=atlas.any_base)


def sample_or_constant(atlas, slot, uv, constant, static_used: bool = True):
    """The texture where slot >= 0, else the constant ([..., 4] both).

    A 1x1 atlas needs no bilinear taps, and the dummy single-slot atlas of
    an untextured scene no gather at all.  `static_used=False` is the
    bake-time fact that no material carries this kind
    (`TextureAtlas.any_*`): the tap disappears."""
    if not static_used:
        return constant
    data = atlas.data
    if data.shape[1] == 1 and data.shape[2] == 1:
        if data.shape[0] == 1:
            tex = torch.broadcast_to(data[0, 0, 0], constant.shape)
        else:
            tex = data[torch.clamp(slot.long(), 0, data.shape[0] - 1), 0, 0]
        return torch.where((slot >= 0)[..., None], tex, constant)
    if atlas.packed is not None:
        tex = sample_atlas_bilinear_packed(atlas.packed, slot, uv)
    else:
        tex = sample_atlas_bilinear(data, slot, uv)
    return torch.where((slot >= 0)[..., None], tex, constant)
