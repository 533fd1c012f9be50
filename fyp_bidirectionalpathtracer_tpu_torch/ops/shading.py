"""Hit-point shading data for the wavefront path.

Port of `fyp_bidirectionalpathtracer_tpu/ops/shading.py` for untextured
scenes of at most 2048 triangles: `ShadingData`, `interpolate_hit`,
`shading_from_fields(_fm)` / `_decode_fields`, `prepare_shading_data`
(getHitShadingData + simplePrepareShadingData, BDPTUtils.hlsli:1-61) and
the dense branches of `make_shaded_tracer`.  The bake refuses textured
materials (ROADMAP Queue 1 item 10), so the JAX `_tap_kinds` reduces to
the material constants.  Normal maps stay out, as on the reference's secondary
surfaces (BDPTUtils.hlsli:40-41).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from ..accel import intersect as isect
from ..accel.traverse import HitRecord, TriSoA, check_dense
from ..core.vecmath import dot, normalize
from ..scene.types import SHADING_METAL_ROUGH, MaterialArray


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


def _surface(pos, n, uv, base, spec, emissive, ior, metal_rough,
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
        emissive=emissive, opacity=base[..., 3], ior=ior, n_dot_v=n_dot_v,
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
    del atlas  # untextured: no taps
    pos = ray_origin + hit.t[..., None] * ray_dir
    return _surface(
        pos, normalize(pick(4, 7)), pick(7, 9), pick(9, 13), pick(13, 17),
        pick(17, 20), pick(20, 21), pick(21, 22) == SHADING_METAL_ROUGH,
        pick(22, 23) > 0.5, pick(26, 27).to(torch.int32), view_origin)


def prepare_shading_data(tris: TriSoA, materials: MaterialArray, atlas,
                         hit: HitRecord, ray_origin, ray_dir, camera_pos) -> ShadingData:
    """simplePrepareShadingData (BDPTUtils.hlsli:2-52) by gathers of the
    triangle attributes and the material row."""
    del atlas  # untextured: no taps
    pos, n, uv, mat_id = interpolate_hit(tris, hit, ray_origin, ray_dir)
    m = torch.clamp(mat_id, min=0).long()
    f32 = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    mat_pack = torch.cat([
        materials.base_color, materials.specular, materials.emissive,
        f32(materials.ior), f32(materials.shading_model), f32(materials.double_sided),
    ], dim=-1)
    mrow = mat_pack[m]
    return _surface(pos, n, uv, mrow[..., 0:4], mrow[..., 4:8], mrow[..., 8:11],
                    mrow[..., 11], mrow[..., 12] == SHADING_METAL_ROUGH,
                    mrow[..., 13] > 0.5, mat_id, camera_pos)


def _on(obj, device):
    """A dataclass of tensors with every tensor field moved to `device`."""
    return replace(obj, **{f.name: getattr(obj, f.name).to(device) for f in fields(obj)
                           if isinstance(getattr(obj, f.name), torch.Tensor)})


def make_shaded_tracer(baked, force_fused: bool | None = None):
    """Build `trace(origin, direction, t_min, view_origin, cull_backface=False,
    coherent=True, lean=False) -> (HitRecord, ShadingData)` for a scene of
    at most 2048 triangles.

    Fused (the default): the shaded kernel (`accel/intersect.
    intersect_shaded_fm`) and the field-major decode, no attribute gather.
    `force_fused=False`: the closest-hit kernel of `baked.intersector()`
    and `prepare_shading_data`.  The trace's `coherent` and `lean` change
    nothing on the dense tier of an untextured scene and are accepted for
    the JAX signature; so are the JAX factory's `sort_divergent` and
    `bounce_tex_mean`, which the port does not take.  A bake with
    `plain=True` runs the kernels' plain versions."""
    check_dense(baked.n_tris)
    atlas = baked.data.textures

    if force_fused is None or force_fused:
        shaded = isect.shaded_plain if baked.plain else isect.intersect_shaded_fm

        def trace(origin, direction, t_min, view_origin, cull_backface=False,
                  coherent=True, lean=False):
            del coherent, lean
            hit, fields_fm = shaded(baked.tri_pack, baked.n_tris, origin, direction,
                                    t_min, None, cull_backface)
            return hit, shading_from_fields_fm(fields_fm, atlas, hit, origin, direction,
                                               view_origin)

        return trace

    intersect = baked.intersector()
    tris = _on(baked.tris, baked.device)
    materials = _on(baked.data.materials, baked.device)

    def trace(origin, direction, t_min, view_origin, cull_backface=False,
              coherent=True, lean=False):
        del coherent, lean
        hit = intersect(origin, direction, t_min, closest=True, cull_backface=cull_backface)
        return hit, prepare_shading_data(tris, materials, atlas, hit, origin, direction,
                                         view_origin)

    return trace
