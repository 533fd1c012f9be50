"""Whole-frame BDPT program: kernel K1 and its plain PyTorch version.

Port of `fyp_bidirectionalpathtracer_tpu/accel/pallas_frame.py`: the
reference's per-pixel program (BDPTMain.rt.hlsl:42-234 plus the G-buffer
primary hit of lightProbeGBuffer.rt.hlsl) in one launch: primary ray and
20 G-buffer rows, camera and light subpaths, estimator-1 NEE, estimator-3
(s,t) connections with uniform / power / balance weights, estimator-2
light-tracing splat rows, thin lens.

K1 replaces the TPU kernel `accel/pallas_frame.py:frame_kernel`.  Its CUDA
sources are `csrc/frame.cu` (one thread per pixel; see the note there) and
`csrc/frame_textured.cu`; the textured instantiations run every ray query
through the BVH walk of `csrc/bvh.cuh`, the untextured ones the dense
pair loop.
`frame_plain` below is the same program vectorised over [N] pixel tensors,
a literal translation of the JAX kernel; closest hit is the [N, T]
Baldwin-Weber test of `accel/intersect.py`, where the lowest triangle index
wins at equal t.  It traces the rays the kernel traces and no others: no
finished path, no shadow ray of a zero throughput or of a dead splat (the
results are the same either way, and its trace calls see the kernel's ray
work).
`frame_kernel` is the wrapper: it runs `frame_plain` for CPU tensors and
launches K1 for CUDA tensors.

The sampler helpers the JAX kernel imports from `accel/pallas_subpath.py`
(`_sample_brdf_tiles`, `_perpendicular`, `_normalize3`, `_next_rand`) are
`sample_brdf` here and the core/ helpers it uses.

Scope (`supports_megakernel`): 1x1 env map, no alpha-tested material, at
most 2048 triangles, 1 <= max_depth <= 8; a textured scene only through deferred texturing
(`defer_textures`, base colour and emissive the only textured kinds,
max_depth <= 4, uniform weights).  The textured variant of the program
(`FrameArgs.textured`, JAX `frame_kernel(textured=True)`) shades with each
material's mean albedo and writes, instead of the own-pixel result, the
per-vertex texture records and the raw estimator parts; `textured_replay`
then applies the texel/mean ratios in the reference's accumulation order
(JAX `_textured_replay`).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import cuda
from ..core.rng import next_rand, tea_init
from ..core.samplers import cos_hemisphere3, unit_sphere3
from ..core.vecmath import (
    M_1_PI,
    M_PI,
    add3,
    dot3,
    neg3,
    normalize3_rn,
    perpendicular3,
    scale3,
    sub3,
    where3,
)
from ..ops.splat_tile import pack_rgb8e
from ..ops.texture import sample_or_constant_fm
from ..scene.types import LIGHT_DIRECTIONAL, SHADING_METAL_ROUGH
from ..utils.profiler import span
from .cluster import check_nodes
from .intersect import any_hit_rows, closest_rows, winner_uv

_BIG = 1e30
N_GBUF_ROWS = 20
MAX_TRIS = 2048
BW_COLS = 12              # csrc/intersect.cuh kBwCols: K1's shared triangle rows
MAX_DEPTH = 8
MAX_TEXTURED_DEPTH = 4   # the deferred row budget grows ~O(d^2) (JAX gate)
N_REC_ROWS = 7           # a vertex record: u, v, base slot, is_spec, base rgb
_WEIGHTS = {"uniform": 0, "power": 1, "balance": 2}

# scalar-row layout (the JAX kernel's scal_ref)
_C_POS, _C_U, _C_V, _C_W, _C_N = 0, 3, 6, 9, 12
_C_IU2, _C_IV2, _C_IW2, _C_JX, _C_JY = 15, 16, 17, 18, 19
_C_ENV, _C_LCNT, _C_LENSR, _C_FOCAL, _C_UN, _C_VN = 20, 23, 24, 25, 26, 29
NSCAL = 32

# light-row layout (scene.lights.light_rows)
_L_POS, _L_DIR, _L_INT, _L_TYPE, _L_COSO, _L_OPEN, _L_PEN = 0, 3, 6, 9, 10, 11, 12
NLROW = 13


@dataclass(frozen=True)
class FrameArgs:
    """Everything of one frame launch but the two tables."""

    scal: tuple              # NSCAL float32 values (layout above)
    bdpt_frame: int          # uint32 BDPT seed frame id
    gbuf_frame: int          # uint32 G-buffer seed frame id (thin lens)
    light_count: int
    n_tris: int
    width: int
    height: int
    d_max: int
    mat_model: int           # 0 GGX, 1 Lambertian
    faithful_rng: bool
    reference_quirks: bool
    min_t: float
    clamp_upper: float
    enable_e1: bool
    enable_e2: bool
    enable_e3: bool
    connection_weight: str   # 'uniform' | 'power' | 'balance'
    use_thin_lens: bool
    splat_rgb8e: bool        # pack est-2 splats to rgb8e in the kernel
    textured: bool = False   # the deferred-texture variant
    pix0: int = 0            # global index of the launch's first pixel
    sub_pixels: int | None = None  # pixels from pix0 on (None: to the end)

    @property
    def n_pix(self) -> int:
        return self.width * self.height

    @property
    def n_sub(self) -> int:
        """The pixels of the launch: a shard's rows (JAX `_frame_out`'s
        `n_sub`), else the whole image; the outputs' row length."""
        return self.n_pix - self.pix0 if self.sub_pixels is None else self.sub_pixels

    @property
    def n_splat_depths(self) -> int:
        return self.d_max if self.enable_e2 else 0

    @property
    def n_e1(self) -> int:
        return self.d_max if self.enable_e1 else 0

    @property
    def n_pairs(self) -> int:
        return len(e3_pair_list(self.d_max, self.enable_e3))


@dataclass(frozen=True)
class FrameOut:
    """Per-pixel kernel outputs, field-major ([rows, N], N = the launch's
    `n_sub` pixels, W*H unless a shard's).

    The textured variant writes no own-pixel result (`res` is None; the
    replay computes it) and its splat rows hold the raw shade (no 1/(i+2),
    clamp or NaN guard); it adds the rows of JAX's `frame_kernel` `:1036-
    1052`: `vrec`, for camera vertices 1..D then light vertices 1..D, 7
    rows each (u, v, base-colour slot, is_spec, base-colour constant rgb;
    slot -1 and constant 1 for a zero vertex), then the primary hit's
    emissive slot (-1 off the scene); `e1_parts`, per NEE depth i the
    diffuse-linear and the specular part x the camera throughput (6 rows);
    `e3_parts`, per (s, t) pair of `e3_pair_list` the raw shade rgb and the
    visibility mask (4 rows).  Lanes that trace nothing hold zeros there."""

    res: torch.Tensor | None  # [4, N] own-pixel rgba
    gbuf: torch.Tensor       # [20, N] pos3 valid normal3 dist dif3 opacity
    #                          spec3 lrough ior emissive3
    splat_pix: torch.Tensor  # [D, N] int32 global splat target pixel, W*H = dead
    splat_pay: torch.Tensor | None   # [D, N] int32 rgb8e payload
    splat_rgba: torch.Tensor | None  # [D, 4, N] float32 r, g, b, live
    vrec: torch.Tensor | None = None      # [14 D + 1, N] textured
    e1_parts: torch.Tensor | None = None  # [6 n_e1, N] textured
    e3_parts: torch.Tensor | None = None  # [4 P, N] textured


def out_rows(d_max: int, enable_e2: bool, emit_gbuffer: bool, textured: bool = False,
             enable_e1: bool = True, enable_e3: bool = True,
             splat_rgb8e: bool = False) -> int:
    """Rows of the JAX kernel's one [R, N] output (JAX `out_rows`); the
    port's FrameOut holds the same rows in separate tensors."""
    r = 4 + ((2 if splat_rgb8e else 5) * d_max if enable_e2 else 0) + (
        N_GBUF_ROWS if emit_gbuffer else 0)
    if textured:
        r += 2 * N_REC_ROWS * d_max + 1
        r += 6 * (d_max if enable_e1 else 0)
        r += 4 * len(e3_pair_list(d_max, enable_e3))
    return r


def e3_pair_list(d_max: int, enable_e3: bool):
    """The (totalLength, s, t) connection pairs in BDPTMain.rt.hlsl:212-233
    loop order."""
    pairs = []
    for total_len in range(2, (d_max + 1) if enable_e3 else 0):
        for sx in range(1, d_max):
            tx = total_len - sx
            if 0 <= tx <= d_max:
                pairs.append((total_len, sx, tx))
    return tuple(pairs)


def is_textured(baked) -> bool:
    """Whether the bake carries a real atlas (not the 1x1 dummy)."""
    return tuple(baked.data.textures.data.shape[:2]) != (1, 1)


def supports_megakernel(baked, cfg, max_tris: int = MAX_TRIS) -> bool:
    """Static scope gate (JAX `supports_megakernel`, `pallas_frame.py:
    1155-1185`): a textured scene qualifies through deferred texturing when
    only base colour (and emissive) is textured (`tex_defer_ok`), at
    depth <= 4 and with uniform weights (the replay bakes 1/totalLength
    into its clamp).  Alpha-tested scenes (K1 has no alpha test) and env
    maps larger than 1x1 (K1 reads one texel) go to the wavefront; a
    normal-mapped scene fails `tex_defer_ok`.  The port's kernel takes
    depth <= 8."""
    b = cfg.bdpt
    untextured = not is_textured(baked)
    tex_ok = untextured or (b.defer_textures and baked.tex_defer_ok
                            and b.max_depth <= MAX_TEXTURED_DEPTH)
    return (
        baked.n_tris <= max_tris
        and tuple(baked.data.env_map.shape[:2]) == (1, 1)
        and tex_ok
        and not baked.has_alpha
        and (b.connection_weight == "uniform" or untextured)
        and 1 <= b.max_depth <= MAX_DEPTH
    )


# ------------------------------------------------------------ tile helpers
def _normed(a):
    """normalize with K1's correctly rounded 1/sqrt (core.vecmath.normalize3_rn)."""
    return normalize3_rn(a[0], a[1], a[2], eps=0.0)


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def _luminance3(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def _nan_guard3(c):
    bad = torch.isnan(c[0]) | torch.isnan(c[1]) | torch.isnan(c[2])
    return tuple(torch.where(bad, torch.zeros_like(x), x) for x in c)


def _clamp3(c, upper):
    return tuple(torch.clamp(x, 0.0, upper) for x in c)


def _acos_approx(x):
    """acos by the Hastings polynomial the JAX kernel uses (|err| < 7e-5)."""
    ax = x.abs()
    p = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * (
        1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * -0.0187293)))
    return torch.where(x >= 0.0, p, M_PI - p)


def sample_brdf(seed, n, v, dif, spec, rough, mat_model: int):
    """sampleBRDF per lane (`pallas_subpath._sample_brdf_tiles`).
    Returns (seed, weight3, l3, pdf, is_spec, below)."""
    nx, ny, nz = n
    vx, vy, vz = v
    if mat_model == 0:  # the lobe pick is GGX-only
        seed, u_lobe = next_rand(seed)
    seed, su0 = next_rand(seed)
    seed, su1 = next_rand(seed)
    bx, by, bz = normalize3_rn(*perpendicular3(nx, ny, nz))
    tx = by * nz - bz * ny
    ty = bz * nx - bx * nz
    tz = bx * ny - by * nx
    r_ = torch.sqrt(su0)
    phi = 2.0 * M_PI * su1
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    zc = torch.sqrt(torch.clamp(1.0 - su0, min=0.0))
    ldx = tx * (r_ * cphi) + bx * (r_ * sphi) + nx * zc
    ldy = ty * (r_ * cphi) + by * (r_ * sphi) + ny * zc
    ldz = tz * (r_ * cphi) + bz * (r_ * sphi) + nz * zc
    if mat_model != 0:  # Lambertian
        ndl = _saturate(nx * ldx + ny * ldy + nz * ldz)
        zeros = torch.zeros_like(ndl, dtype=torch.bool)
        return seed, dif, (ldx, ldy, ldz), ndl * M_1_PI, zeros, zeros

    lum_d = torch.clamp(_luminance3(dif), min=0.01)
    lum_s = torch.clamp(_luminance3(spec), min=0.01)
    prob_diff = lum_d / (lum_d + lum_s)
    choose_diff = u_lobe < prob_diff
    a2 = rough * rough
    cos_th = torch.sqrt(torch.clamp(
        (1.0 - su0) / ((a2 - 1.0) * su0 + 1.0), min=0.0))
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    phi_h = su1 * M_PI * 2.0
    cph, sph = torch.cos(phi_h), torch.sin(phi_h)
    hx = tx * (sin_th * cph) + bx * (sin_th * sph) + nx * cos_th
    hy = ty * (sin_th * cph) + by * (sin_th * sph) + ny * cos_th
    hz = tz * (sin_th * cph) + bz * (sin_th * sph) + nz * cos_th
    vdh = vx * hx + vy * hy + vz * hz
    sdx, sdy, sdz = normalize3_rn(2.0 * vdh * hx - vx, 2.0 * vdh * hy - vy,
                                  2.0 * vdh * hz - vz)
    lx = torch.where(choose_diff, ldx, sdx)
    ly = torch.where(choose_diff, ldy, sdy)
    lz = torch.where(choose_diff, ldz, sdz)
    ndl_any = nx * lx + ny * ly + nz * lz
    below = ndl_any <= 0.0
    ndl = _saturate(ndl_any)
    ndv_c = _saturate(nx * vx + ny * vy + nz * vz)
    pdf_diff = ndl * M_1_PI * prob_diff
    ndh = _saturate(nx * hx + ny * hy + nz * hz)
    ldh = _saturate(sdx * hx + sdy * hy + sdz * hz)
    ndl_s = _saturate(nx * sdx + ny * sdy + nz * sdz)
    dd = (ndh * a2 - ndh) * ndh + 1.0
    big_d = a2 / torch.clamp(dd * dd * M_PI, min=0.001)
    k = rough * rough / 2.0
    big_g = (ndv_c / (ndv_c * (1.0 - k) + k)) * (ndl_s / (ndl_s * (1.0 - k) + k))
    f5 = torch.pow(torch.clamp(1.0 - ldh, min=0.0), 5.0)
    ggx_prob = big_d * ndh / (4.0 * ldh)
    gterm = big_d * big_g / (4.0 * ndl_s * ndv_c)
    scale = ndl_s / (ggx_prob * (1.0 - prob_diff))
    ws = tuple(scale * gterm * (sp + (1.0 - sp) * f5) for sp in spec)
    pdf = torch.where(choose_diff, pdf_diff, ggx_prob * (1.0 - prob_diff))
    w = tuple(torch.where(choose_diff, dc / prob_diff, wc)
              for dc, wc in zip(dif, ws))
    zero = torch.zeros_like(pdf)
    pdf = torch.where(below, zero, pdf)
    w = tuple(torch.where(below, zero, c) for c in w)
    return seed, w, (lx, ly, lz), pdf, ~choose_diff, below


def _ggx_spec(h, l, n, n_dot_l, n_dot_v, rough, spec):
    """ops.brdf.ggx_lighting's colour term per lane."""
    n_dot_h = _saturate(dot3(n, h))
    l_dot_h = _saturate(dot3(l, h))
    a2 = rough * rough
    dd = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    d = a2 / torch.clamp(dd * dd * M_PI, min=0.001)
    k = rough * rough / 2.0
    g = (n_dot_v / (n_dot_v * (1.0 - k) + k)) * (n_dot_l / (n_dot_l * (1.0 - k) + k))
    f5 = torch.pow(torch.clamp(1.0 - l_dot_h, min=0.0), 5.0)
    scale = d * g / (4.0 * n_dot_l * n_dot_v)
    return tuple((sp + (1.0 - sp) * f5) * scale for sp in spec)


def _eval_brdf(v, l, n, dif, spec, rough, is_spec, mat_model: int):
    """ops.materials.eval_brdf per lane."""
    if mat_model != 0:  # Lambertian: albedo (the reference omits 1/pi)
        return dif
    below = dot3(n, l) <= 0.0
    h = _normed(add3(l, v))
    spec_col = _ggx_spec(h, l, n, _saturate(dot3(n, l)), _saturate(dot3(n, v)),
                         rough, spec)
    out = where3(is_spec, spec_col, tuple(c * M_1_PI for c in dif))
    zero = torch.zeros_like(rough)
    return where3(below, (zero, zero, zero), out)


def _nee_shade(vis, l, inten, n, v, dif, spec, rough, lcnt, mat_model):
    """ops.materials.nee_shade per lane (diffuse plus specular part)."""
    difp, specp = _nee_shade_split(vis, l, inten, n, v, dif, spec, rough, lcnt, mat_model)
    if mat_model != 0:
        return difp
    return tuple(dp + sp for dp, sp in zip(difp, specp))


def _nee_shade_split(vis, l, inten, n, v, dif, spec, rough, lcnt, mat_model):
    """nee_shade split into (diffuse-albedo-linear part, specular part), as
    the deferred-texture records need them (JAX `_nee_shade_tiles_split`)."""
    n_dot_l = _saturate(dot3(n, l))
    shadow_mult = torch.where(vis, lcnt, 0.0)
    if mat_model != 0:
        zero = torch.zeros_like(n_dot_l)
        return tuple(shadow_mult * n_dot_l * ic * dc / M_PI
                     for ic, dc in zip(inten, dif)), (zero, zero, zero)
    h = _normed(add3(v, l))
    n_dot_h = _saturate(dot3(n, h))
    l_dot_h = _saturate(dot3(l, h))
    n_dot_v = _saturate(dot3(n, v))
    a2 = rough * rough
    dd = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    d = a2 / torch.clamp(dd * dd * M_PI, min=0.001)
    k = rough * rough / 2.0
    g = (n_dot_l / (n_dot_l * (1.0 - k) + k)) * (n_dot_v / (n_dot_v * (1.0 - k) + k))
    f5 = torch.pow(torch.clamp(1.0 - l_dot_h, min=0.0), 5.0)
    dg4 = d * g / (4.0 * n_dot_v)
    difp = tuple(shadow_mult * ic * n_dot_l * dc * M_1_PI
                 for ic, dc in zip(inten, dif))
    specp = tuple(shadow_mult * ic * (sc + (1.0 - sc) * f5) * dg4
                  for ic, sc in zip(inten, spec))
    return difp, specp


# ---------------------------------------------------------- intersection
def _closest_on(lanes, tris, n_tris, o, d, tmin, tmax, cull_backface):
    """closest_rows on the lanes the kernel traces (every lane for None);
    a miss (t = tmax, id -1) on the others."""
    if lanes is None:
        return closest_rows(tris, n_tris, o, d, tmin, tmax, cull_backface)
    idx = lanes.nonzero().squeeze(1)
    got = closest_rows(tris, n_tris, tuple(c[idx] for c in o), tuple(c[idx] for c in d),
                       tmin[idx], tmax[idx], cull_backface)
    hit, t = torch.zeros_like(lanes), tmax.clone()
    best = torch.full(lanes.shape, -1, dtype=torch.int64, device=lanes.device)
    hit[idx], t[idx], best[idx] = got
    return hit, t, best


def _any_hit_on(lanes, tris, n_tris, o, d, tmin, tmax):
    """any_hit_rows on the lanes the kernel traces; not occluded on the
    others."""
    idx = lanes.nonzero().squeeze(1)
    occ = torch.zeros_like(lanes)
    occ[idx] = any_hit_rows(tris, n_tris, tuple(c[idx] for c in o),
                            tuple(c[idx] for c in d), tmin[idx], tmax[idx])
    return occ


def _trace(tris, n_tris, o, d, tmin, cull_backface, lanes=None):
    """Closest hit plus the winner's attributes (`_trace_rows`) on `lanes`
    (every lane for None)."""
    hit, t_, best_id = _closest_on(lanes, tris, n_tris, o, d, tmin,
                                   torch.full_like(tmin, _BIG), cull_backface)
    a = tris[best_id.clamp(min=0)]
    a = torch.where(hit[:, None], a, torch.zeros_like(a))
    attr = lambda k: a[:, k]  # noqa: E731
    u, v = winner_uv(a, o, d, t_)
    w = 1.0 - u - v
    hf = hit.to(torch.float32)
    u, v, w = u * hf, v * hf, w * hf
    n_raw = tuple(w * attr(12 + k) + u * attr(15 + k) + v * attr(18 + k)
                  for k in range(3))
    return {
        "hit": hit,
        "pos": add3(o, scale3(d, t_)),
        "n_raw": n_raw,
        # uv and the texture slots feed the deferred-texture records
        "uv": tuple(w * attr(21 + k) + u * attr(23 + k) + v * attr(25 + k)
                    for k in range(2)),
        "base": tuple(attr(27 + k) for k in range(4)),
        "spec": tuple(attr(31 + k) for k in range(4)),
        "emissive": tuple(attr(35 + k) for k in range(3)),
        "ior": attr(38),
        "shading_model": attr(39),
        "double_sided": attr(40),
        "bc_tex": attr(41),
        "em_tex": attr(43),
    }


def _decode_shading(tr, view_origin):
    """Untextured ShadingData decode (`ops.shading.shading_from_fields`)."""
    b0, b1, b2, b3 = tr["base"]
    s0, s1, s2, s3 = tr["spec"]
    metal_rough = tr["shading_model"] == float(SHADING_METAL_ROUGH)
    metal = s2
    dif = where3(metal_rough, (b0 * (1.0 - metal), b1 * (1.0 - metal),
                               b2 * (1.0 - metal)), (b0, b1, b2))
    spc = where3(metal_rough, tuple(0.04 * (1.0 - metal) + b * metal
                                    for b in (b0, b1, b2)), (s0, s1, s2))
    lrough = torch.clamp(torch.where(metal_rough, s1, 1.0 - s3), min=0.08)
    n = _normed(tr["n_raw"])
    v = _normed(sub3(view_origin, tr["pos"]))
    flip = (dot3(n, v) <= 0.0) & (tr["double_sided"] > 0.5)
    n = where3(flip, neg3(n), n)
    return {"pos": tr["pos"], "n": n, "v": v, "dif": dif, "spec": spc,
            "lrough": lrough, "rough": lrough * lrough,
            "emissive": tr["emissive"], "opacity": b3, "ior": tr["ior"]}


def _fetch_light(lights, idx):
    row = lights[idx]
    c = lambda k: row[:, k]  # noqa: E731
    return {"pos": (c(0), c(1), c(2)), "dir": (c(3), c(4), c(5)),
            "inten": (c(6), c(7), c(8)), "type": c(_L_TYPE),
            "coso": c(_L_COSO), "open": c(_L_OPEN), "pen": c(_L_PEN)}


def _eval_light(lrow, surf_pos):
    """scene.lights.eval_light per lane -> (to_light3, intensity3, dist)."""
    lpos, ldir, linten = lrow["pos"], lrow["dir"], lrow["inten"]
    to_l = sub3(lpos, surf_pos)
    dist_sq = dot3(to_l, to_l)
    valid = dist_sq > 1e-5
    zero = torch.zeros_like(dist_sq)
    dist_pt = torch.where(valid, torch.sqrt(torch.clamp(dist_sq, min=1e-20)), zero)
    inv = 1.0 / torch.clamp(dist_pt, min=1e-20)
    l_pt = where3(valid, scale3(to_l, inv), (inv * 0.0,) * 3)
    falloff = 1.0 / (0.0001 + dist_sq)
    cos_theta = -dot3(l_pt, ldir)
    falloff = torch.where(cos_theta < lrow["coso"], zero, falloff)
    pen_scale = _saturate(
        ((lrow["open"] - _acos_approx(torch.clamp(cos_theta, -1.0, 1.0)))
         - lrow["pen"]) / torch.clamp(lrow["pen"], min=1e-9))
    falloff = torch.where(lrow["pen"] > 0.0, falloff * pen_scale, falloff)
    inten_pt = scale3(linten, falloff)
    diff = sub3(surf_pos, lpos)
    dist_dir = torch.sqrt(torch.clamp(dot3(diff, diff), min=0.0))
    pos_dir = sub3(surf_pos, scale3(ldir, dist_dir))
    is_dir = lrow["type"] == float(LIGHT_DIRECTIONAL)
    to_light = where3(is_dir, neg3(ldir), l_pt)
    intensity = where3(is_dir, linten, inten_pt)
    dvec = sub3(where3(is_dir, pos_dir, lpos), surf_pos)
    dist = torch.sqrt(torch.clamp(dot3(dvec, dvec), min=0.0))
    return to_light, intensity, dist


# ------------------------------------------------------------ plain frame
_VFIELDS3 = ("color", "pos", "n", "v", "dif", "spec")
# the deferred-texture record of a vertex: uv, base-colour slot and constant
_TFIELDS = ("tu", "tv", "bslot", "bc0", "bc1", "bc2")
_VFIELDS1 = ("rough", "pdf", "is_spec") + _TFIELDS


def _zeros_vertex(n, device):
    """A zero vertex; its record has slot -1 (ratio 1) and constant 1 (no
    0/0 in the replay's ratio)."""
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    one = torch.ones_like(z)
    out = {k: (z, z, z) for k in _VFIELDS3}
    out.update({k: z for k in _VFIELDS1})
    out.update(bslot=-one, bc0=one, bc1=one, bc2=one)
    return out


def _record(tr):
    """The texture record fields of a traced hit."""
    return {"tu": tr["uv"][0], "tv": tr["uv"][1], "bslot": tr["bc_tex"],
            "bc0": tr["base"][0], "bc1": tr["base"][1], "bc2": tr["base"][2]}


def _vertex_where(mask, a, b):
    out = {k: where3(mask, a[k], b[k]) for k in _VFIELDS3}
    out.update({k: torch.where(mask, a[k], b[k]) for k in _VFIELDS1})
    return out


def _f32(x) -> float:
    """A float32 value as a Python float (exact)."""
    return float(np.float32(x))


def frame_plain(args: FrameArgs, lights: torch.Tensor, tris: torch.Tensor) -> FrameOut:
    """The frame program vectorised over the launch's `n_sub` pixels from
    `pix0` on (see module doc).  Outputs are [rows, n_sub]; the primary
    rays, the RNG seeds and the splat targets use global pixel ids, and a
    dead splat's pixel is W*H, so the shards of an image concatenate to
    the whole-image call."""
    dev = tris.device
    w_, h_ = args.width, args.height
    n_pix = args.n_pix
    n_sub = args.n_sub
    d_max = args.d_max
    mat_model = args.mat_model
    n_tris = args.n_tris
    sc = [_f32(x) for x in args.scal]
    f32 = np.float32

    def full(v):
        return torch.full((n_sub,), v, dtype=torch.float32, device=dev)

    cam_pos = tuple(sc[_C_POS + k] for k in range(3))
    cam_u = tuple(sc[_C_U + k] for k in range(3))
    cam_v = tuple(sc[_C_V + k] for k in range(3))
    cam_w = tuple(sc[_C_W + k] for k in range(3))
    cam_n = tuple(sc[_C_N + k] for k in range(3))
    inv_u2, inv_v2, inv_w2 = sc[_C_IU2], sc[_C_IV2], sc[_C_IW2]
    jx, jy = sc[_C_JX], sc[_C_JY]
    env = tuple(sc[_C_ENV + k] for k in range(3))
    lcnt_f = sc[_C_LCNT]
    lcnt_i = args.light_count

    lin = torch.arange(n_sub, dtype=torch.int64, device=dev) + args.pix0
    x = (lin % w_).to(torch.float32)
    y = (lin // w_).to(torch.float32)
    zero_t = full(0.0)
    ones = full(1.0)

    # ---------------- primary ray (G-buffer, lightProbeGBuffer.rt.hlsl) ----
    ndc_x = (2.0 * x / w_ - 1.0) + _f32(f32(2.0) * f32(jx) / f32(w_))
    ndc_y = (-2.0 * y / h_ + 1.0) - _f32(f32(2.0) * f32(jy) / f32(h_))
    cw = [f32(c) for c in cam_w]
    inv_wlen = _f32(f32(1.0) / np.sqrt(cw[0] * cw[0] + cw[1] * cw[1] + cw[2] * cw[2]))
    d_raw = scale3(tuple(ndc_x * cam_u[k] + ndc_y * cam_v[k] + cam_w[k]
                         for k in range(3)), inv_wlen)
    cam_tiles = tuple(full(c) for c in cam_pos)
    if args.use_thin_lens:
        # lens origin from the G-buffer pass's own RNG stream
        # (lightProbeGBuffer.rt.hlsl:119-145)
        gseed = tea_init(lin, torch.full_like(lin, args.gbuf_frame))
        gseed, u0 = next_rand(gseed)
        gseed, u1 = next_rand(gseed)
        theta = 2.0 * M_PI * u0
        r = sc[_C_LENSR] * u1
        lx, ly = r * torch.cos(theta), r * torch.sin(theta)
        origin0 = tuple(cam_tiles[k] + lx * sc[_C_UN + k] + ly * sc[_C_VN + k]
                        for k in range(3))
        focal_pt = add3(cam_tiles, scale3(d_raw, sc[_C_FOCAL]))
        prim_dir = _normed(sub3(focal_pt, origin0))
    else:
        origin0 = cam_tiles
        prim_dir = _normed(d_raw)
    tr = _trace(tris, n_tris, origin0, prim_dir, zero_t, True)
    sd = _decode_shading(tr, cam_tiles)
    valid = tr["hit"]

    world_pos = where3(valid, sd["pos"], (zero_t,) * 3)
    world_norm = where3(valid, sd["n"], (zero_t,) * 3)
    dif = where3(valid, sd["dif"], tuple(full(c) for c in env))
    spc = where3(valid, sd["spec"], (zero_t,) * 3)
    lrough = torch.where(valid, sd["lrough"], zero_t)
    rough = lrough * lrough
    emis = where3(valid, sd["emissive"], (zero_t,) * 3)
    # the camera vertex's view vector uses the pinhole even under thin lens
    v_tiles = _normed(sub3(cam_tiles, world_pos))

    seed = tea_init(lin, torch.full_like(lin, args.bdpt_frame))

    # ---------------- camera subpath ----------------
    zeros_vert = _zeros_vertex(n_sub, dev)
    cam_path = [zeros_vert] * (d_max + 1)
    cam_path[0] = dict(zeros_vert, pos=cam_tiles, n=tuple(full(c) for c in cam_n),
                       color=(ones, ones, ones), pdf=ones)
    seed2, wgt, out_dir, pdf1, is_spec1, _ = sample_brdf(
        seed, world_norm, v_tiles, dif, spc, rough, mat_model)
    if not args.faithful_rng:
        seed = seed2
    cam_path[1] = _vertex_where(valid, {
        "color": wgt, "pos": world_pos, "n": world_norm, "v": v_tiles,
        "dif": dif, "spec": spc, "rough": rough,
        "is_spec": is_spec1.to(torch.float32), "pdf": pdf1, **_record(tr),
    }, zeros_vert)
    min_t_tiles = full(args.min_t)

    def shoot(state):
        """passes.bdpt.shoot_ray per lane."""
        active = ~state["term"]
        tr_b = _trace(tris, n_tris, state["o"], state["d"], min_t_tiles, False, active)
        sd_b = _decode_shading(tr_b, state["o"])
        seed_b, w_b, l_b, pdf_b, isspec_b, _ = sample_brdf(
            state["seed"], sd_b["n"], sd_b["v"], sd_b["dif"], sd_b["spec"],
            sd_b["rough"], mat_model)
        got = active & tr_b["hit"]
        missed = active & ~tr_b["hit"]
        new = dict(state)
        if not args.faithful_rng:
            new["seed"] = torch.where(got, seed_b, state["seed"])
        new["color"] = where3(
            got, tuple(c * w for c, w in zip(state["color"], w_b)),
            where3(missed, (zero_t,) * 3, state["color"]))
        for key in ("pos", "n", "v", "dif", "spec"):
            new[key] = where3(got, sd_b[key], state[key])
        new["rough"] = torch.where(got, sd_b["rough"], state["rough"])
        new["is_spec"] = torch.where(got, isspec_b.to(torch.float32),
                                     state["is_spec"])
        new["pdf"] = torch.where(got, pdf_b, state["pdf"])
        # a miss keeps the stale record (JAX `:713-718`)
        new.update({k: torch.where(got, x, state[k]) for k, x in _record(tr_b).items()})
        new["o"] = where3(got, sd_b["pos"], state["o"])
        new["d"] = where3(got, l_b, state["d"])
        new["term"] = state["term"] | missed
        return new

    def vertex_of(state):
        return {k: state[k] for k in _VFIELDS3 + _VFIELDS1}

    def start_state(o, d, color, seed):
        return dict(zeros_vert, o=o, d=d, color=color, seed=seed, pos=o,
                    term=~valid)

    state = start_state(world_pos, out_dir, wgt, seed)
    for depth in range(1, d_max):
        was_active = ~state["term"]
        state = shoot(state)
        cam_path[depth + 1] = _vertex_where(was_active, vertex_of(state), zeros_vert)
    seed = state["seed"]

    # ---------------- light subpath (sample_light, BDPTUtils.hlsli:140-152)
    seed, u_pick = next_rand(seed)
    lidx = torch.clamp((u_pick * lcnt_f).to(torch.int64), max=lcnt_i - 1)
    lrow0 = _fetch_light(lights, lidx)
    is_dir = lrow0["type"] == float(LIGHT_DIRECTIONAL)
    seed_s, p_sph = unit_sphere3(seed)
    seed = torch.where(is_dir, seed, seed_s)
    seed, l_dir0 = cos_hemisphere3(seed, where3(is_dir, lrow0["dir"], p_sph))
    light_path = [zeros_vert] * (d_max + 1)
    light_path[0] = dict(zeros_vert, pos=lrow0["pos"], color=lrow0["inten"],
                         pdf=ones / lcnt_f)
    take = [ones] * (d_max + 1)
    lstate = start_state(lrow0["pos"], l_dir0, lrow0["inten"], seed)
    for depth in range(d_max):
        was_active = ~lstate["term"]
        lstate = shoot(lstate)
        light_path[depth + 1] = _vertex_where(was_active, vertex_of(lstate),
                                              zeros_vert)
        take[depth + 1] = torch.where(
            was_active, (~lstate["term"]).to(torch.float32), take[depth + 1])
    seed = lstate["seed"]

    # ---------------- accumulate own pixel ----------------
    # (textured: the raw parts instead, replayed by textured_replay)
    textured = args.textured
    e1_rows, e3_rows = [], []
    has_emis = (emis[0] > 0.0) | (emis[1] > 0.0) | (emis[2] > 0.0)
    em_mask = valid & has_emis
    out = [torch.where(em_mask, emis[k], zero_t) for k in range(3)] + [zero_t]

    # --- estimator 1: path tracing with NEE (BDPTMain:161-167) ---
    if args.enable_e1:
        e1 = []
        for i in range(d_max):
            seed, u = next_rand(seed)
            idx = torch.clamp((u * lcnt_f).to(torch.int64), max=lcnt_i - 1)
            e1.append(_eval_light(_fetch_light(lights, idx), cam_path[i + 1]["pos"]))
        for i in range(d_max):
            l3, inten3, dist = e1[i]
            vtx = cam_path[i + 1]
            # the kernel skips the shadow ray of a zero throughput
            c = cam_path[i]["color"]
            traced = valid & ~((c[0] == 0.0) & (c[1] == 0.0) & (c[2] == 0.0))
            occ = _any_hit_on(traced, tris, n_tris, vtx["pos"], l3, min_t_tiles, dist)
            nee = (~occ, l3, inten3, vtx["n"], vtx["v"], vtx["dif"], vtx["spec"],
                   vtx["rough"], lcnt_f, mat_model)
            if textured:
                # raw parts x the camera throughput; the ratios, 1/(i+2),
                # clamp and NaN guard replay after the kernel (JAX `:821-828`)
                for part in _nee_shade_split(*nee):
                    e1_rows += [torch.where(traced, cc * p, zero_t) for cc, p in zip(c, part)]
                continue
            direct = _nee_shade(*nee)
            shade = tuple(c * dc for c, dc in zip(cam_path[i]["color"], direct))
            shade = _nan_guard3(_clamp3(scale3(shade, 1.0 / (i + 2)),
                                        args.clamp_upper))
            for k in range(3):
                out[k] = out[k] + torch.where(valid, shade[k], zero_t)
            out[3] = out[3] + torch.where(valid, ones, zero_t)

    # --- estimator 3: s,t connections (BDPTMain:212-233) ---
    e3_pairs = e3_pair_list(d_max, args.enable_e3)
    if args.connection_weight != "uniform" and e3_pairs:
        mis_weight = _mis_weights(cam_path, light_path, d_max,
                                  2.0 if args.connection_weight == "power" else 1.0)
    for total_len, sx, tx in e3_pairs:
        vec = sub3(light_path[tx]["pos"], cam_path[sx]["pos"])
        length_ab = torch.sqrt(torch.clamp(dot3(vec, vec), min=1e-30))
        dir_ab = scale3(vec, 1.0 / length_ab)
        # interval shortened by min_t to exclude far-endpoint self-hits
        occ = _any_hit_on(valid, tris, n_tris, cam_path[sx]["pos"], dir_ab,
                          min_t_tiles, length_ab - min_t_tiles)
        if tx >= 1:
            # evalGWithoutV (BDPTUtils.hlsli:172-184)
            inv_len = 1.0 / torch.sqrt(torch.clamp(dot3(vec, vec), min=1e-30))
            dd = scale3(vec, inv_len)
            cam_end, light_end = cam_path[sx], light_path[tx]
            g = (dot3(cam_end["n"], dd).abs() * dot3(light_end["n"], dd).abs()
                 * inv_len * inv_len)
            a_e = cam_path[sx - 1]["color"]
            a_l = (light_path[sx - 1]["color"] if args.reference_quirks
                   else light_path[tx - 1]["color"])
            connect_dir = _normed(sub3(cam_end["pos"], light_end["pos"]))
            wo_l = _normed(sub3(light_path[tx - 1]["pos"], light_end["pos"]))
            fs_l = _eval_brdf(connect_dir, wo_l, light_end["n"], light_end["dif"],
                              light_end["spec"], light_end["rough"],
                              light_end["is_spec"] > 0.5, mat_model)
            wo_e = _normed(sub3(cam_path[sx - 1]["pos"], cam_end["pos"]))
            fs_e = _eval_brdf(neg3(connect_dir), wo_e, cam_end["n"],
                              cam_end["dif"], cam_end["spec"], cam_end["rough"],
                              cam_end["is_spec"] > 0.5, mat_model)
            shade = tuple(al * (fl * g * fe) * ae
                          for al, fl, fe, ae in zip(a_l, fs_l, fs_e, a_e))
            # textured: the raw shade; the replay weights, clamps and guards
            if not textured:
                if args.connection_weight != "uniform":
                    wgt_mis = mis_weight(sx, tx, total_len)
                    shade = tuple(c * wgt_mis for c in shade)
                else:
                    shade = scale3(shade, 1.0 / float(total_len))
                shade = _nan_guard3(_clamp3(shade, args.clamp_upper))
        else:
            shade = (zero_t, zero_t, zero_t)
        mask = valid & ~occ
        if textured:  # JAX `:939-944`
            e3_rows += [torch.where(mask, c, zero_t) for c in shade] + [mask.to(torch.float32)]
            continue
        for k in range(3):
            out[k] = torch.where(mask, _saturate(out[k] + shade[k]), out[k])
        out[3] = torch.where(mask, _saturate(out[3] + 1.0), out[3])

    # --- estimator 2: light-tracing splats (BDPTMain:171-208) ---
    splat_pix, splat_pay, splat_rgba = [], [], []
    take_cum = torch.ones((n_sub,), dtype=torch.bool, device=dev)
    for i in range(args.n_splat_depths):
        take_cum = take_cum & (take[i + 1] > 0.5)
        last = light_path[i + 1]
        to_cam = sub3(cam_tiles, last["pos"])
        dis = torch.sqrt(torch.clamp(dot3(to_cam, to_cam), min=1e-30))
        dir_to_cam = scale3(to_cam, 1.0 / dis)
        facing = dot3(dir_to_cam, cam_n) < 0.0
        # project_dir_to_pixel (BDPTUtils.hlsli:129-138)
        d1 = dot3(dir_to_cam, cam_u) * inv_u2
        d2 = dot3(dir_to_cam, cam_v) * inv_v2
        d3 = dot3(dir_to_cam, cam_w) * inv_w2
        px = ((d1 / d3) * 0.5 + 0.5) * float(w_) - jx
        py = ((-d2 / d3) * 0.5 + 0.5) * float(h_) - jy
        rx, ry = torch.round(px), torch.round(py)  # half to even
        in_range = (rx >= 0) & (rx < w_) & (ry >= 0) & (ry < h_)
        # the kernel traces the shadow ray of a splat that is live so far
        occ = _any_hit_on(valid & take_cum & facing & in_range, tris, n_tris, last["pos"],
                          dir_to_cam, min_t_tiles, dis)
        active2 = valid & take_cum & facing & ~occ
        theta1 = _saturate(dot3(dir_to_cam, cam_n).abs())
        theta2 = _saturate(dot3(dir_to_cam, last["n"]).abs())
        g = theta1 * theta2 / (dis * dis)
        brdf = _eval_brdf(last["v"], dir_to_cam, last["n"], last["dif"],
                          last["spec"], last["rough"], last["is_spec"] > 0.5,
                          mat_model)
        shade = tuple(lc * bc * g for lc, bc in zip(light_path[i]["color"], brdf))
        if not textured:  # textured splat rows stay raw (JAX `:986-988`)
            shade = _nan_guard3(_clamp3(scale3(shade, 1.0 / (i + 2)), args.clamp_upper))
        ok = active2 & in_range
        pix = torch.where(ok, ry.clamp(0, h_ - 1).to(torch.int64) * w_
                          + rx.clamp(0, w_ - 1).to(torch.int64),
                          torch.full_like(lin, n_pix))
        splat_pix.append(pix.to(torch.int32))
        live = tuple(torch.where(ok, c, zero_t) for c in shade)
        if args.splat_rgb8e:
            splat_pay.append(pack_rgb8e(*live))
        else:
            splat_rgba.append(torch.stack(list(live) + [ok.to(torch.float32)]))

    # background early-out wrote (env, 1) (BDPTMain:62-66); the textured
    # variant writes no own-pixel result (JAX `:1012-1015`)
    res = None if textured else torch.stack(
        [torch.where(valid, out[k], dif[k]) for k in range(3)]
        + [torch.where(valid, out[3], ones)])
    dvec = sub3(world_pos, cam_tiles)
    gbuf = torch.stack([
        world_pos[0], world_pos[1], world_pos[2], valid.to(torch.float32),
        world_norm[0], world_norm[1], world_norm[2],
        torch.where(valid, torch.sqrt(torch.clamp(dot3(dvec, dvec), min=0.0)), zero_t),
        dif[0], dif[1], dif[2], torch.where(valid, sd["opacity"], ones),
        spc[0], spc[1], spc[2], lrough,
        torch.where(valid, sd["ior"], zero_t),
        emis[0], emis[1], emis[2],
    ])
    def stack(rows, row_shape, dtype):  # [D, ...]; D may be 0
        if rows:
            return torch.stack(rows)
        return torch.zeros((0,) + row_shape, dtype=dtype, device=dev)

    tex = {}
    if textured:  # JAX `:1036-1052`
        rec = [vtx[k] for path in (cam_path, light_path) for vtx in path[1:]
               for k in ("tu", "tv", "bslot", "is_spec", "bc0", "bc1", "bc2")]
        rec.append(torch.where(valid, tr["em_tex"], -ones))
        tex = dict(vrec=torch.stack(rec), e1_parts=stack(e1_rows, (n_sub,), torch.float32),
                   e3_parts=stack(e3_rows, (n_sub,), torch.float32))
    return FrameOut(
        res=res, gbuf=gbuf,
        splat_pix=stack(splat_pix, (n_sub,), torch.int32),
        splat_pay=stack(splat_pay, (n_sub,), torch.int32) if args.splat_rgb8e else None,
        splat_rgba=None if args.splat_rgb8e else stack(splat_rgba, (4, n_sub), torch.float32),
        **tex,
    )


def _mis_weights(cam_path, light_path, d_max, mis_power):
    """Corrected MIS (passes.bdpt._connection_weight): per-lane log-pdf
    chains of both subpaths, then a max-subtracted softmax over the splits
    of each total length.  Returns weight(sx, tx, total_len)."""

    def log_pdf_g(a, b):
        vec = sub3(b["pos"], a["pos"])
        d2 = torch.clamp(dot3(vec, vec), min=1e-30)
        dn = scale3(vec, torch.rsqrt(d2))

        def cosf(vtx):
            degenerate = dot3(vtx["n"], vtx["n"]) < 0.5
            return torch.where(degenerate, torch.ones_like(d2),
                               dot3(vtx["n"], dn).abs())

        return torch.log(torch.clamp(cosf(a) * cosf(b), min=0.0)) - torch.log(d2)

    def cum_logpdf(path):
        lp = [torch.log(torch.clamp(path[0]["pdf"], min=0.0))]
        for k in range(1, d_max + 1):
            lp.append(lp[-1] + torch.log(torch.clamp(path[k]["pdf"], min=0.0))
                      + log_pdf_g(path[k - 1], path[k]))
        return lp

    lc, ll = cum_logpdf(cam_path), cum_logpdf(light_path)

    def weight(sx, tx, total_len):
        terms = [lc[i] + ll[total_len - i] for i in range(total_len + 1)
                 if i <= d_max and total_len - i <= d_max]
        cur = lc[sx] + ll[tx]
        m = terms[0]
        for term in terms[1:]:
            m = torch.maximum(m, term)
        denom = sum(torch.exp(mis_power * (term - m)) for term in terms)
        w = torch.exp(mis_power * (cur - m)) / torch.clamp(denom, min=1e-30)
        finite = (cur == cur) & (cur > -_BIG) & (cur < _BIG)
        return torch.where(finite, w, torch.zeros_like(w))

    return weight


# ----------------------------------------------------------------- K1 wrapper
class _FrameParams(ctypes.Structure):
    """Mirror of `FrameParams` in csrc/frame_program.cuh."""

    _fields_ = [
        ("scal", ctypes.c_float * NSCAL),
        ("bdpt_frame", ctypes.c_uint32),
        ("gbuf_frame", ctypes.c_uint32),
        ("light_count", ctypes.c_int),
        ("n_tris", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("mat_model", ctypes.c_int),
        ("faithful_rng", ctypes.c_int),
        ("reference_quirks", ctypes.c_int),
        ("enable_e1", ctypes.c_int),
        ("enable_e2", ctypes.c_int),
        ("enable_e3", ctypes.c_int),
        ("connection_weight", ctypes.c_int),
        ("use_thin_lens", ctypes.c_int),
        ("splat_rgb8e", ctypes.c_int),
        ("min_t", ctypes.c_float),
        ("clamp_upper", ctypes.c_float),
        ("pix0", ctypes.c_int),
        ("n_sub", ctypes.c_int),
    ]


def _params(args: FrameArgs) -> _FrameParams:
    p = _FrameParams()
    p.scal[:] = [float(v) for v in args.scal]
    p.bdpt_frame = args.bdpt_frame & 0xFFFFFFFF
    p.gbuf_frame = args.gbuf_frame & 0xFFFFFFFF
    for name in ("light_count", "n_tris", "width", "height", "mat_model",
                 "faithful_rng", "reference_quirks", "enable_e1", "enable_e2",
                 "enable_e3", "use_thin_lens", "splat_rgb8e"):
        setattr(p, name, int(getattr(args, name)))
    p.connection_weight = _WEIGHTS[args.connection_weight]
    p.min_t = args.min_t
    p.clamp_upper = args.clamp_upper
    p.pix0 = args.pix0
    p.n_sub = args.n_sub
    return p


def _check_args(args: FrameArgs, lights: torch.Tensor, tris: torch.Tensor):
    cuda.check_tensor("lights", lights, torch.float32, lights.device)
    cuda.check_tensor("tris", tris, torch.float32, lights.device)
    if lights.dim() != 2 or lights.shape[1] != NLROW:
        raise ValueError(f"lights must be [L, {NLROW}], got {tuple(lights.shape)}")
    if tris.dim() != 2 or tris.shape[1] != 48 or tris.shape[0] < args.n_tris:
        raise ValueError(f"tris must be [T_pad >= {args.n_tris}, 48], "
                         f"got {tuple(tris.shape)}")
    if not 1 <= args.light_count <= lights.shape[0]:
        raise ValueError(f"light_count {args.light_count} outside [1, {lights.shape[0]}]")
    if not 1 <= args.d_max <= MAX_DEPTH:
        raise ValueError(f"d_max {args.d_max} outside [1, {MAX_DEPTH}]")
    if not 1 <= args.n_tris <= MAX_TRIS:
        raise ValueError(f"n_tris {args.n_tris} outside [1, {MAX_TRIS}]")
    if not (0 <= args.pix0 and 1 <= args.n_sub and args.pix0 + args.n_sub <= args.n_pix):
        raise ValueError(f"pixels [{args.pix0}, {args.pix0} + {args.n_sub}) outside the "
                         f"{args.width}x{args.height} image")
    if len(args.scal) != NSCAL or args.connection_weight not in _WEIGHTS:
        raise ValueError("bad scal row or connection_weight")
    if args.textured and (args.splat_rgb8e or args.d_max > MAX_TEXTURED_DEPTH
                          or args.connection_weight != "uniform"):
        raise ValueError(f"the textured frame takes d_max <= {MAX_TEXTURED_DEPTH}, uniform "
                         f"weights and unpacked splat rows")


def frame_kernel(args: FrameArgs, lights: torch.Tensor, tris: torch.Tensor,
                 nodes: torch.Tensor) -> FrameOut:
    """K1 wrapper: frame_plain for CPU tensors, the CUDA kernel otherwise
    (its textured variant for `args.textured`).  `nodes` is the bake's BVH
    node table (`BakedScene.bvh_nodes`), which every ray query of the
    textured variant walks, checked and passed only there (the untextured
    one loops over every triangle and does not read it); the plain version
    tests every triangle and finds the same hits."""
    _check_args(args, lights, tris)
    if args.textured:
        check_nodes(nodes, lights.device)
    if tris.device.type == "cpu":
        return frame_plain(args, lights, tris)
    n, d2 = args.n_sub, args.n_splat_depths
    dev = tris.device

    def rows(r, dtype=torch.float32):
        return torch.empty((r, n), dtype=dtype, device=dev)

    gbuf, pix = rows(N_GBUF_ROWS), rows(d2, torch.int32)
    pay = rows(d2, torch.int32) if args.splat_rgb8e else None
    rgba = None if args.splat_rgb8e else torch.empty((d2, 4, n), dtype=torch.float32, device=dev)
    params = _params(args)
    lib = cuda.library()
    if args.textured:
        vrec, e1, e3 = (rows(2 * N_REC_ROWS * args.d_max + 1), rows(6 * args.n_e1),
                        rows(4 * args.n_pairs))
        cuda.check_launch("frame_textured", lib.bdpt_frame_textured_launch(
            ctypes.byref(params), args.d_max, cuda.ptr(lights), cuda.ptr(tris),
            cuda.ptr(nodes), nodes.shape[0], cuda.ptr(gbuf), cuda.ptr(pix), cuda.ptr(rgba),
            cuda.ptr(vrec), cuda.ptr(e1), cuda.ptr(e3), cuda.stream(dev)))
        return FrameOut(res=None, gbuf=gbuf, splat_pix=pix, splat_pay=None, splat_rgba=rgba,
                        vrec=vrec, e1_parts=e1, e3_parts=e3)
    res = rows(4)
    cuda.check_launch("frame", lib.bdpt_frame_launch(
        ctypes.byref(params), args.d_max, cuda.ptr(lights), cuda.ptr(tris), cuda.ptr(res),
        cuda.ptr(gbuf), cuda.ptr(pix), cuda.ptr(pay), cuda.ptr(rgba), cuda.stream(dev)))
    return FrameOut(res=res, gbuf=gbuf, splat_pix=pix, splat_pay=pay,
                    splat_rgba=rgba)


# ------------------------------------------------------- frame entry point
def frame_args(baked, width: int, height: int, bdpt_frame: int, pixel_jitter,
               cfg, gbuf_frame: int = 0, splat_rgb8e: bool = False, pix0: int = 0,
               sub_pixels: int | None = None) -> FrameArgs:
    """Host-side argument packing of the JAX `_frame_out`; `pix0` and
    `sub_pixels` select a shard's pixels (its `pixel_offset`, `n_sub`)."""
    with span("frame_args"):
        cam = baked.data.camera
        gcfg = cfg.gbuffer
        bcfg = cfg.bdpt
        lens_radius = gcfg.focal_length_gui / (2.0 * gcfg.f_stop) if gcfg.use_thin_lens else 0.0
        jit = torch.as_tensor(pixel_jitter, dtype=torch.float32)
        f = lambda v: torch.as_tensor(v, dtype=torch.float32).reshape(-1)  # noqa: E731
        scal = torch.cat([
            cam.pos_w, cam.camera_u, cam.camera_v, cam.camera_w,
            cam.camera_w / torch.linalg.norm(cam.camera_w),
            f([1.0]) / torch.dot(cam.camera_u, cam.camera_u).reshape(1),
            f([1.0]) / torch.dot(cam.camera_v, cam.camera_v).reshape(1),
            f([1.0]) / torch.dot(cam.camera_w, cam.camera_w).reshape(1),
            jit[:2],
            baked.data.env_map[0, 0, :3].to(torch.float32),
            f(float(baked.data.lights.count)),
            f([lens_radius, gcfg.focal_length_gui]),
            cam.camera_u / torch.linalg.norm(cam.camera_u),
            cam.camera_v / torch.linalg.norm(cam.camera_v),
        ]).to(torch.float32)
        return FrameArgs(
            scal=tuple(scal.tolist()),
            bdpt_frame=int(bdpt_frame) & 0xFFFFFFFF,
            gbuf_frame=int(gbuf_frame) & 0xFFFFFFFF,
            light_count=int(baked.data.lights.count),
            n_tris=baked.n_tris, width=width, height=height,
            d_max=bcfg.max_depth, mat_model=bcfg.mat_model,
            faithful_rng=bcfg.faithful_rng,
            reference_quirks=bcfg.reference_quirks,
            min_t=_f32(bcfg.min_t), clamp_upper=_f32(bcfg.clamp_upper),
            enable_e1=bcfg.enable_path_tracing,
            enable_e2=bcfg.enable_light_tracing,
            enable_e3=bcfg.enable_connections,
            connection_weight=bcfg.connection_weight,
            use_thin_lens=bool(gcfg.use_thin_lens), splat_rgb8e=splat_rgb8e,
            textured=is_textured(baked), pix0=int(pix0), sub_pixels=sub_pixels,
        )


def textured_replay(out: FrameOut, bcfg, atlas):
    """The deferred-texture replay after the textured frame (JAX
    `_textured_replay`, `pallas_frame.py:1188-1310`).

    Taps each vertex's base-colour texel, multiplies the texel/mean ratios
    into the raw estimator parts and replays the own-pixel accumulation in
    the reference's order: emissive add, est-1 adds, the est-3 saturate
    chain, the background fold (BDPTMain.rt.hlsl:155-233).  The math stays
    field-major ([3, N] and [N] lane vectors); transposes happen at the
    return.  Returns (res4 [N, 4], splats [(lin [N], rgb [N, 3], alpha [N])]
    a light-tracing depth, dif_ratio1 [N, 3], em3 [N, 3]); the last two fix
    the G-buffer's MaterialDiffuse and Emissive to their texel values."""
    d_max = bcfg.max_depth
    n_e1 = d_max if bcfg.enable_path_tracing else 0
    n_e2 = d_max if bcfg.enable_light_tracing else 0
    pairs = e3_pair_list(d_max, bcfg.enable_connections)
    gbuf, vrec = out.gbuf, out.vrec
    n = gbuf.shape[1]
    ones4 = torch.ones((4, n), dtype=torch.float32, device=gbuf.device)
    valid = gbuf[3] > 0.0
    dif_env, emis_const = gbuf[8:11], gbuf[17:20]

    def vertex(base):
        u, v = vrec[base], vrec[base + 1]
        slot = vrec[base + 2].to(torch.int32)
        lobe, bconst = vrec[base + 3], vrec[base + 4:base + 7]
        tap = sample_or_constant_fm(atlas, slot, u, v, ones4, static_used=atlas.any_base)
        # [N] masks broadcast against [3, N]
        ratio = torch.where(slot >= 0, tap[:3] / torch.clamp(bconst, min=1e-6), 1.0)
        rhat = torch.where(lobe > 0.5, 1.0, ratio)
        return (u, v), slot, ratio, rhat

    cam = [vertex(N_REC_ROWS * k) for k in range(d_max)]
    lig = [vertex(N_REC_ROWS * (d_max + k)) for k in range(d_max)]
    one = torch.tensor(1.0, dtype=torch.float32, device=gbuf.device)
    r_c, r_l = [one], [one]
    for vtx in cam:
        r_c.append(r_c[-1] * vtx[3])
    for vtx in lig:
        r_l.append(r_l[-1] * vtx[3])

    em_slot = vrec[2 * N_REC_ROWS * d_max].to(torch.int32)
    u1, v1 = cam[0][0]
    em3 = sample_or_constant_fm(atlas, em_slot, u1, v1, torch.cat([emis_const, ones4[:1]], 0),
                                static_used=atlas.any_emissive)[:3]

    def guard(c):
        return torch.where(torch.isnan(c).any(0), 0.0, c)

    out_rgb = torch.where(valid & (em3 > 0.0).any(0), em3, 0.0)
    out_a = torch.zeros_like(out_rgb[0])
    for i in range(n_e1):
        difp, specp = out.e1_parts[6 * i:6 * i + 3], out.e1_parts[6 * i + 3:6 * i + 6]
        full = r_c[i] * (difp * cam[i][2] + specp)
        full = guard(torch.clamp(full / (i + 2), 0.0, bcfg.clamp_upper))
        out_rgb = out_rgb + torch.where(valid, full, 0.0)
        out_a = out_a + torch.where(valid, 1.0, 0.0)
    for p, (total_len, sx, tx) in enumerate(pairs):
        shade = out.e3_parts[4 * p:4 * p + 3]
        mask = out.e3_parts[4 * p + 3] > 0.5
        if tx >= 1:
            # reference_quirks' aL index is the spec: copied, not fixed
            a_l_ratio = r_l[sx - 1] if bcfg.reference_quirks else r_l[tx - 1]
            full = shade * r_c[sx - 1] * cam[sx - 1][3] * lig[tx - 1][3] * a_l_ratio
            full = guard(torch.clamp(full / float(total_len), 0.0, bcfg.clamp_upper))
        else:
            full = torch.zeros_like(shade)
        out_rgb = torch.where(mask, torch.clamp(out_rgb + full, 0.0, 1.0), out_rgb)
        out_a = torch.where(mask, torch.clamp(out_a + 1.0, 0.0, 1.0), out_a)

    res4 = torch.cat([torch.where(valid, out_rgb, dif_env),
                      torch.where(valid, out_a, 1.0)[None]], 0).T
    splats = []
    for i in range(n_e2):
        raw, alpha = out.splat_rgba[i, :3], out.splat_rgba[i, 3]
        full = raw * r_l[i] * lig[i][3]
        full = guard(torch.clamp(full / (i + 2), 0.0, bcfg.clamp_upper))
        splats.append((out.splat_pix[i], torch.where(alpha > 0.5, full, 0.0).T, alpha))
    return res4, splats, cam[0][2].T, em3.T


def render_frame_megakernel(baked, width: int, height: int, bdpt_frame,
                            pixel_jitter, cfg, gbuf_frame=0, sub_height: int | None = None,
                            pixel_offset: int | None = None, mesh=None):
    """Run K1, then the est-2 splat reduction; returns (channels, frame_img
    [H, W, 4]) like the JAX `render_frame_megakernel`.  A textured scene
    runs K1's textured variant and `textured_replay`, whose splats go to
    `scatter_add_rgba` (JAX `pallas_frame.py:1446-1527`).

    Row-sharded use (`parallel/sharding.py`): `sub_height` rows from the
    global pixel `pixel_offset` on (a multiple of `width`), and `mesh`, the
    row mesh.  K1 runs on the shard's pixels with global pixel ids; its
    splats land on global pixels, K2, the sort and K3 reduce them into a
    full W x H image, the mesh sums that image over its ranks (the frame's
    one collective) and the shard keeps its rows.  The channels and the
    frame are the shard's [sub_height, W, 4].

    A bake with `plain=True` runs the plain versions of the kernels on its
    device instead: the reference the kernels' whole frame is held against."""
    from ..ops import splat as splat_mod

    bcfg = cfg.bdpt
    textured = is_textured(baked)
    sub_h = height if sub_height is None else sub_height
    pix0 = 0 if pixel_offset is None else int(pixel_offset)
    if mesh is None and (sub_h, pix0) != (height, 0):
        raise ValueError("a shard's rows (sub_height, pixel_offset) need the row mesh")
    if pix0 % width:
        raise ValueError(f"pixel_offset {pix0} does not start a row of {width} pixels")
    # pack the est-2 splats to rgb8e in the kernel for splat_mode
    # 'tiled_rgb8e', or 'auto' on a CUDA device (as 'auto' on the TPU)
    mode = bcfg.splat_mode
    packed = (not textured) and bcfg.enable_light_tracing and (
        mode == "tiled_rgb8e" or (mode == "auto" and baked.device.type == "cuda"))
    args = frame_args(baked, width, height, bdpt_frame, pixel_jitter, cfg,
                      gbuf_frame=gbuf_frame, splat_rgb8e=packed, pix0=pix0,
                      sub_pixels=sub_h * width)
    with span("k1"):
        out = (frame_plain(args, baked.light_rows, baked.tri_pack) if baked.plain
               else frame_kernel(args, baked.light_rows, baked.tri_pack, baked.bvh_nodes))
    n_pix = args.n_pix

    def img(rows):
        return rows.T.reshape(sub_h, width, rows.shape[0])

    if textured:
        res4, tex_splats, dif_ratio1, em3 = textured_replay(out, bcfg, baked.atlas)
        result = res4.reshape(sub_h, width, 4)
    else:
        result = img(out.res)
    if bcfg.enable_light_tracing:
        # the splats in the reference's depth order (depth-major concat)
        if packed:
            splat_flat = splat_mod.scatter_add_rgba_prepacked(
                out.splat_pix.reshape(-1), out.splat_pay.reshape(-1), n_pix,
                plain=baked.plain)
        elif textured:
            splat_flat = splat_mod.scatter_add_rgba(
                mode, torch.cat([s[0] for s in tex_splats]),
                torch.cat([s[1] for s in tex_splats]), torch.cat([s[2] for s in tex_splats]),
                n_pix, alpha_is_count=True,
                segments=len(tex_splats) if bcfg.splat_segments else 1, plain=baked.plain)
        else:
            rgba = out.splat_rgba.permute(0, 2, 1).reshape(-1, 4)
            splat_flat = splat_mod.scatter_add_rgba(
                mode, out.splat_pix.reshape(-1), rgba[:, :3], rgba[:, 3], n_pix,
                alpha_is_count=True, segments=bcfg.max_depth if bcfg.splat_segments else 1,
                plain=baked.plain)
        if mesh is not None:
            # every shard's light subpaths splat onto any pixel: sum the
            # images over the ranks, keep this shard's rows
            splat_flat = mesh.all_reduce(splat_flat)
        splat = splat_flat[pix0:pix0 + sub_h * width].reshape(sub_h, width, 4)
        got_splat = (splat != 0.0).any(dim=-1, keepdim=True)
        frame_img = torch.where(got_splat, torch.clamp(result + splat, 0.0, 1.0),
                                result)
    else:
        frame_img = result

    gbuf = img(out.gbuf)
    mat_dif, emis3 = gbuf[..., 8:12], gbuf[..., 17:20]
    if textured:
        # the kernel shaded with mean albedos; the G-buffer channels carry
        # the texel values (lightProbeGBuffer.rt.hlsl:110-116)
        mat_dif = torch.cat([gbuf[..., 8:11] * dif_ratio1.reshape(sub_h, width, 3),
                             gbuf[..., 11:12]], -1)
        emis3 = em3.reshape(sub_h, width, 3)
    zeros3 = torch.zeros((sub_h, width, 3), dtype=torch.float32, device=gbuf.device)
    channels = {
        "WorldPosition": gbuf[..., 0:4],
        "WorldNormal": gbuf[..., 4:8],
        "MaterialDiffuse": mat_dif,
        "MaterialSpecRough": gbuf[..., 12:16],
        "MaterialExtraParams": torch.cat([gbuf[..., 16:17], zeros3], -1),
        "Emissive": torch.cat([emis3, zeros3[..., :1]], -1),
        "BDPT": frame_img,
    }
    return channels, frame_img
