"""Hit-point shading data for the wavefront path.

Port of `fyp_bidirectionalpathtracer_tpu/ops/shading.py`: `ShadingData`,
`_tap_kinds` (the texture taps: one combined-table gather, or a tap a
kind), `interpolate_hit`, `shading_from_fields(_fm)` / `_decode_fields`,
`prepare_shading_data` (getHitShadingData + simplePrepareShadingData,
BDPTUtils.hlsli:1-61) and `make_shaded_tracer` with its three branches:
the dense shaded kernel (at most 2048 triangles), the BVH shaded kernel
(the JAX cluster branch, up to 32768), and closest hit plus gathers above
that.  Normal maps stay out, as on the reference's secondary surfaces
(BDPTUtils.hlsli:40-41); the bake refuses normal-mapped scenes (ROADMAP
Queue 1 item 10b), so the G-buffer's primary hits need none either.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import torch

from ..accel import cluster
from ..accel import intersect as isect
from ..accel.traverse import CLUSTER_THRESHOLD, HitRecord, TriSoA
from ..core.vecmath import dot, normalize
from ..scene.types import SHADING_METAL_ROUGH, MaterialArray, TextureAtlas, on_device
from .texture import sample_combined, sample_or_constant


@dataclass(frozen=True)
class ShadingData:
    """Shading data at hit points (a Falcor ShadingData subset)."""

    pos_w: torch.Tensor            # [..., 3]
    n: torch.Tensor                # [..., 3] shading normal (maybe flipped)
    v: torch.Tensor                # [..., 3] toward the viewer / previous vertex
    uv: torch.Tensor               # [..., 2]
    diffuse: torch.Tensor          # [..., 3]
    specular: torch.Tensor         # [..., 3]
    linear_roughness: torch.Tensor  # [...] clamped >= 0.08
    roughness: torch.Tensor        # [...] alpha = linear^2
    emissive: torch.Tensor         # [..., 3]
    opacity: torch.Tensor          # [...]
    ior: torch.Tensor              # [...]
    n_dot_v: torch.Tensor          # [...]
    material_id: torch.Tensor      # [...] int32


def _tap_kinds(atlas: TextureAtlas, mat_id, bc_tex, sp_tex, em_tex, uv,
               base_const, spec_const, em_rgb):
    """(base [..., 4], spec [..., 4], emissive [..., 3]) with the constant
    where a slot is < 0: one gather of the combined table when the atlas
    has one, else a tap a kind (JAX `ops/shading.py:37-68`)."""
    if atlas.combined is not None and (atlas.any_base or atlas.any_spec or atlas.any_emissive):
        base_t, spec_t, em_t = sample_combined(atlas, mat_id, uv)
        base = (torch.where((bc_tex >= 0)[..., None], base_t, base_const)
                if atlas.any_base else base_const)
        spec = (torch.where((sp_tex >= 0)[..., None], spec_t, spec_const)
                if atlas.any_spec else spec_const)
        emissive = (torch.where((em_tex >= 0)[..., None], em_t[..., :3], em_rgb)
                    if atlas.any_emissive else em_rgb)
        return base, spec, emissive
    base = sample_or_constant(atlas, bc_tex, uv, base_const, static_used=atlas.any_base)
    spec = sample_or_constant(atlas, sp_tex, uv, spec_const, static_used=atlas.any_spec)
    em_const = torch.cat([em_rgb, torch.ones_like(em_rgb[..., :1])], -1)
    emissive = sample_or_constant(atlas, em_tex, uv, em_const,
                                  static_used=atlas.any_emissive)[..., :3]
    return base, spec, emissive


def mean_atlas(atlas: TextureAtlas) -> TextureAtlas:
    """The atlas of `bounce_tex_mean`: no taps, so a decode shades with the
    material constants, which carry the texture means (scene.Scene.bake)."""
    return replace(atlas, packed=None, combined=None, any_base=False, any_spec=False,
                   any_emissive=False)


def _surface(pos, n, uv, base, spec, emissive, opacity, ior, metal_rough,
             double_sided, mat_id, view_origin) -> ShadingData:
    """The decode both JAX paths share: spec-gloss or metal-rough, roughness
    clamp and square, double-sided flip."""
    metal = spec[..., 2:3]
    dif_mr = base[..., :3] * (1.0 - metal)
    spec_mr = 0.04 * (1.0 - metal) + base[..., :3] * metal
    mr = metal_rough[..., None]
    diffuse = torch.where(mr, dif_mr, base[..., :3])
    specular = torch.where(mr, spec_mr, spec[..., :3])
    linear_rough = torch.clamp(torch.where(metal_rough, spec[..., 1], 1.0 - spec[..., 3]),
                               min=0.08)
    v = normalize(view_origin - pos)
    n_dot_v = dot(n, v)
    flip = (n_dot_v <= 0) & double_sided
    n = torch.where(flip[..., None], -n, n)
    n_dot_v = torch.where(flip, -n_dot_v, n_dot_v)
    return ShadingData(
        pos_w=pos, n=n, v=v, uv=uv, diffuse=diffuse, specular=specular,
        linear_roughness=linear_rough, roughness=linear_rough * linear_rough,
        emissive=emissive, opacity=opacity, ior=ior, n_dot_v=n_dot_v,
        material_id=mat_id)


def _tri_attr_pack(tris: TriSoA):
    """[T, 16]: n0 n1 n2 (9), uv0 uv1 uv2 (6), material id (1)."""
    return torch.cat([tris.n0, tris.n1, tris.n2, tris.uv0, tris.uv1, tris.uv2,
                      tris.material_id.to(torch.float32)[:, None]], dim=-1)


def interpolate_hit(tris: TriSoA, hit: HitRecord, ray_origin, ray_dir):
    """Geometric attributes at the hit: (pos, n, uv, material id); the
    position from the ray's parametric form."""
    tri = torch.clamp(hit.tri, min=0).long()
    u = hit.bary_u[..., None]
    v = hit.bary_v[..., None]
    w = 1.0 - u - v
    pos = ray_origin + hit.t[..., None] * ray_dir
    a = _tri_attr_pack(tris)[tri]
    n = normalize(w * a[..., 0:3] + u * a[..., 3:6] + v * a[..., 6:9])
    uv = w * a[..., 9:11] + u * a[..., 11:13] + v * a[..., 13:15]
    return pos, n, uv, a[..., 15].to(torch.int32)


def shading_from_fields(fields_rm, atlas, hit: HitRecord, ray_origin, ray_dir,
                        view_origin) -> ShadingData:
    """ShadingData from the shaded kernel's row-major field table [..., 32]."""
    return _decode_fields(
        lambda lo, hi: fields_rm[..., lo:hi] if hi > lo + 1 else fields_rm[..., lo],
        atlas, hit, ray_origin, ray_dir, view_origin)


def shading_from_fields_fm(fields_fm, atlas, hit: HitRecord, ray_origin, ray_dir,
                           view_origin) -> ShadingData:
    """ShadingData from the field-major table [32, ...] (no transpose of
    the whole table: only the vector channels move their axis)."""
    def pick(lo, hi):
        if hi > lo + 1:
            return torch.movedim(fields_fm[lo:hi], 0, -1)
        return fields_fm[lo]

    return _decode_fields(pick, atlas, hit, ray_origin, ray_dir, view_origin)


def _decode_fields(pick, atlas, hit: HitRecord, ray_origin, ray_dir,
                   view_origin) -> ShadingData:
    """The field-table decode; `pick(lo, hi)` returns columns [lo, hi) with
    the field axis last (a scalar field for hi == lo + 1)."""
    pos = ray_origin + hit.t[..., None] * ray_dir
    uv = pick(7, 9)
    base_const, spec_const, em_rgb = pick(9, 13), pick(13, 17), pick(17, 20)
    mat_id = pick(26, 27).to(torch.int32)
    base, spec, emissive = _tap_kinds(
        atlas, mat_id, pick(23, 24).to(torch.int32), pick(24, 25).to(torch.int32),
        pick(25, 26).to(torch.int32), uv, base_const, spec_const, em_rgb)
    return _surface(pos, normalize(pick(4, 7)), uv, base, spec, emissive, base_const[..., 3],
                    pick(20, 21), pick(21, 22) == SHADING_METAL_ROUGH, pick(22, 23) > 0.5,
                    mat_id, view_origin)


def prepare_shading_data(tris: TriSoA, materials: MaterialArray, atlas,
                         hit: HitRecord, ray_origin, ray_dir, camera_pos) -> ShadingData:
    """simplePrepareShadingData (BDPTUtils.hlsli:2-52) by gathers of the
    triangle attributes, the material row and the textures."""
    pos, n, uv, mat_id = interpolate_hit(tris, hit, ray_origin, ray_dir)
    m = torch.clamp(mat_id, min=0).long()
    f32 = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    mat_pack = torch.cat([
        materials.base_color, materials.specular, materials.emissive,
        f32(materials.ior), f32(materials.shading_model), f32(materials.double_sided),
        f32(materials.base_color_tex), f32(materials.specular_tex),
        f32(materials.emissive_tex),
    ], dim=-1)
    mrow = mat_pack[m]
    base_const = mrow[..., 0:4]
    base, spec, emissive = _tap_kinds(
        atlas, m, mrow[..., 14].to(torch.int32), mrow[..., 15].to(torch.int32),
        mrow[..., 16].to(torch.int32), uv, base_const, mrow[..., 4:8], mrow[..., 8:11])
    return _surface(pos, n, uv, base, spec, emissive, base_const[..., 3], mrow[..., 11],
                    mrow[..., 12] == SHADING_METAL_ROUGH, mrow[..., 13] > 0.5, mat_id,
                    camera_pos)


def make_shaded_tracer(baked, force_fused: bool | None = None, sort_divergent: bool = False,
                       lean_bf16: bool | None = None, bounce_tex_mean: bool = False):
    """Build `trace(origin, direction, t_min, view_origin, cull_backface=False,
    coherent=True, lean=False) -> (HitRecord, ShadingData)`.

    - At most 2048 triangles (fused, the default): the dense shaded kernel
      (`accel/intersect.intersect_shaded_fm`) and the field-major decode.
    - Above that, up to 32768: the BVH shaded kernel
      (`accel/cluster.bvh_shaded_fm`) and the same decode, JAX's cluster
      branch (`ops/shading.py:405-457, 647-655`).
    - `force_fused=False`, or above 32768 triangles: the closest-hit kernel
      of `baked.intersector()` and `prepare_shading_data`, with its
      material and texture gathers (`:699-713`).

    `bounce_tex_mean`: on the kernel branches a `lean=True` trace (a
    subpath extension) decodes with the mean atlas, as JAX's TPU paths do
    (`:381-383, 451, 526`); primary hits tap the atlas.  The gather branch
    taps it always, as JAX's does.  `coherent`, `sort_divergent` (a
    direction sort whose permutation is inverted) and `lean_bf16` (JAX's
    bf16 quantisation of lean bounce shading on the TPU; the port keeps
    float32, as JAX on the CPU does) are accepted and ignored.  A bake with
    `plain=True` runs the kernels' plain versions."""
    del sort_divergent, lean_bf16
    atlas_full = baked.atlas
    atlas_mean = mean_atlas(atlas_full) if bounce_tex_mean else atlas_full
    dense = baked.n_tris <= isect.MAX_DENSE_TRIS
    if force_fused is None:
        force_fused = baked.n_tris <= CLUSTER_THRESHOLD

    if force_fused:
        if baked.plain:
            shaded = isect.shaded_plain
        elif dense:
            shaded = isect.intersect_shaded_fm
        else:
            shaded = partial(cluster.bvh_shaded_fm, rows=baked.bw_rows, pairs=baked.bvh_pairs)

        def trace(origin, direction, t_min, view_origin, cull_backface=False,
                  coherent=True, lean=False):
            del coherent
            hit, fields_fm = shaded(baked.tri_pack, baked.n_tris, origin=origin,
                                    direction=direction, t_min=t_min,
                                    cull_backface=cull_backface)
            return hit, shading_from_fields_fm(fields_fm, atlas_mean if lean else atlas_full,
                                               hit, origin, direction, view_origin)

        return trace

    intersect = baked.intersector()
    tris = on_device(baked.tris, baked.device)
    materials = on_device(baked.data.materials, baked.device)

    def trace(origin, direction, t_min, view_origin, cull_backface=False,
              coherent=True, lean=False):
        del coherent, lean
        hit = intersect(origin, direction, t_min, closest=True, cull_backface=cull_backface)
        return hit, prepare_shading_data(tris, materials, atlas_full, hit, origin, direction,
                                         view_origin)

    return trace
