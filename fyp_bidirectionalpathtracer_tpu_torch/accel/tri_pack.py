"""Intersection-ready triangles and the per-triangle pack of the frame kernel.

Ports `TriSoA` / `bake_triangles` (`fyp_bidirectionalpathtracer_tpu/accel/
traverse.py:41-93`), `pack_triangles` (`accel/pallas_intersect.py:42`),
`pack_shaded_triangles` (`accel/pallas_shaded.py:59`) and
`pack_shaded_tris_lane` / `tri_pad_rows` (`accel/pallas_lane.py:46-86`).

The [T_pad, 48] pack, one row per triangle:
   0:12  Baldwin-Weber rows (n, n.v0, r1, r1.v0, r2, r2.v0)
  12:21  n0, n1, n2                (vertex normals)
  21:27  uv0, uv1, uv2
  27:31  base_color rgba           (material constants, per triangle)
  31:35  specular rgba
  35:38  emissive rgb
  38     ior
  39     shading_model
  40     double_sided
  41:44  base_color / specular / emissive texture slots
  44     material id
  45:48  zero
T_pad is T rounded up to a multiple of 8; pad rows are zero.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.vecmath import cross, dot
from ..scene.types import GeometryArrays, MaterialArray

PACK_COLS = 48


@dataclass(frozen=True)
class TriSoA:
    """Pre-expanded triangles (in BVH leaf order when built from one)."""

    v0: torch.Tensor      # [F,3]
    e1: torch.Tensor      # [F,3] v1 - v0
    e2: torch.Tensor      # [F,3] v2 - v0
    n0: torch.Tensor      # [F,3] vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor     # [F,2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    material_id: torch.Tensor  # [F] int32


def bake_triangles(geom: GeometryArrays, order=None) -> TriSoA:
    """Expand indexed geometry into a triangle SoA, optionally permuted."""
    idx = geom.indices.long() if order is None else geom.indices.long()[order]
    mat = geom.material_id if order is None else geom.material_id[order]
    p, n, uv = geom.positions, geom.normals, geom.uvs
    v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    return TriSoA(
        v0=v0, e1=v1 - v0, e2=v2 - v0,
        n0=n[idx[:, 0]], n1=n[idx[:, 1]], n2=n[idx[:, 2]],
        uv0=uv[idx[:, 0]], uv1=uv[idx[:, 1]], uv2=uv[idx[:, 2]],
        material_id=mat.to(torch.int32),
    )


def tri_pad_rows(t: int) -> int:
    """Rows of the pack: T rounded up to a multiple of 8 (at least 8)."""
    return max(8, ((t + 7) // 8) * 8)


def pack_bw_rows(tris: TriSoA) -> torch.Tensor:
    """[T, 12] Baldwin-Weber rows: n, n.v0, r1, r1.v0, r2, r2.v0."""
    n = cross(tris.e1, tris.e2)
    n_sq = dot(n, n)
    inv = torch.where(n_sq > 0, 1.0 / torch.clamp(n_sq, min=1e-30),
                      torch.zeros_like(n_sq))
    r1 = cross(tris.e2, n) * inv[:, None]
    r2 = cross(n, tris.e1) * inv[:, None]
    return torch.cat([
        n, dot(n, tris.v0)[:, None],
        r1, dot(r1, tris.v0)[:, None],
        r2, dot(r2, tris.v0)[:, None],
    ], dim=1)


def pack_shaded_tris_lane(tris: TriSoA, materials: MaterialArray) -> torch.Tensor:
    """The [T_pad, 48] float32 per-triangle pack (see module docstring)."""
    t = int(tris.v0.shape[0])
    m = torch.clamp(tris.material_id, min=0).long()
    f32 = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    rows = torch.cat([
        pack_bw_rows(tris),
        tris.n0, tris.n1, tris.n2,
        tris.uv0, tris.uv1, tris.uv2,
        materials.base_color[m],
        materials.specular[m],
        materials.emissive[m],
        f32(materials.ior[m]),
        f32(materials.shading_model[m]),
        f32(materials.double_sided[m]),
        f32(materials.base_color_tex[m]),
        f32(materials.specular_tex[m]),
        f32(materials.emissive_tex[m]),
        f32(tris.material_id),
    ], dim=1)  # [T, 45]
    out = torch.zeros((tri_pad_rows(t), PACK_COLS), dtype=torch.float32)
    out[:t, :rows.shape[1]] = rows
    return out
