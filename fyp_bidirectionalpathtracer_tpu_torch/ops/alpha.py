"""Alpha-tested transparency (the DXR any-hit alpha test).

Port of `fyp_bidirectionalpathtracer_tpu/ops/alpha.py`.  The reference
ignores hits whose sampled base-colour alpha is below the material's
alphaThreshold in every any-hit shader (`alphaTestFails`,
BDPTUtils.hlsli:115-127).  Hardware re-enters traversal after IgnoreHit();
the wavefront's equivalent is a bounded masked restart loop: trace the
closest hit, test alpha there, and trace again past failed hits with t_min
pushed beyond them.  Lanes that passed restart with t_min = 1e30, the
empty interval: the kernels answer them as misses and the select drops
their result.

The restarts run the port's intersector kernels (the dense closest and
shaded kernels, the BVH closest and shaded kernels) with a per-lane t_min;
the test itself is torch gathers, as JAX's is jnp.  Scenes with no
alpha-testable material skip the wrappers: `has_alpha_materials` runs once
at bake time (`scene.BakedScene.has_alpha`).
"""
from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

from ..scene.types import on_device
from .shading import interpolate_hit
from .texture import sample_base_color

_INERT = 1e30  # the restart t_min of a lane that passed: [1e30, t_max) is empty
MAX_RESTARTS = 4  # restart rounds after the first trace; each runs for every lane


def has_alpha_materials(materials, atlas) -> bool:
    """Can any hit in this scene fail the alpha test?  True if some
    material's base colour (its texture's least texel alpha if textured,
    else its constant alpha) is below its threshold."""
    thr = np.asarray(materials.alpha_threshold)
    bc = np.asarray(materials.base_color)
    bc_tex = np.asarray(materials.base_color_tex)
    data = np.asarray(atlas.data)
    for m in range(thr.shape[0]):
        a_min = float(data[bc_tex[m], ..., 3].min()) if bc_tex[m] >= 0 else float(bc[m, 3])
        if a_min < thr[m]:
            return True
    return False


def _fails(atlas, materials, hit, mat_id, uv) -> torch.Tensor:
    """hit & (sampled base alpha < the material's threshold)."""
    m = torch.clamp(mat_id, min=0).long()
    base = sample_base_color(atlas, materials, m, uv)
    return hit.hit & (base[..., 3] < materials.alpha_threshold[m])


def _alpha_fails(tris, materials, atlas, hit, origin, direction) -> torch.Tensor:
    """alphaTestFails over a hit wavefront."""
    _, _, uv, mat_id = interpolate_hit(tris, hit, origin, direction)
    return _fails(atlas, materials, hit, mat_id, uv)


def _push_tmin(hit, t_min):
    """t_min pushed just past an ignored hit (the restart epsilon)."""
    return hit.t * (1.0 + 1e-4) + 1e-4


def _select(fail, new, old):
    """Field by field `where(fail, new, old)` of two dataclasses, the mask
    broadcast over each field's trailing dimensions."""
    out = {}
    for f in fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        mask = fail.reshape(fail.shape + (1,) * (a.dim() - fail.dim()))
        out[f.name] = torch.where(mask, a, b)
    return replace(old, **out)


def _restart_tmin(t_min, origin) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(t_min, dtype=torch.float32, device=origin.device),
                              origin.shape[:-1])


def wrap_intersector(baked, intersect, max_restarts: int = MAX_RESTARTS):
    """Alpha-aware `intersect(origin, direction, t_min, t_max=None,
    closest=True, cull_backface=False, coherent=True, const_origin=False)`
    with the same signature.  Closest-hit and any-hit queries both trace
    closest hits and restart past alpha-failed ones (any hit = an
    alpha-passing hit in range exists, which hardware finds by IgnoreHit
    re-entry), so a shadow batch becomes a closest-hit query with a
    per-lane t_max."""
    tris = on_device(baked.tris, baked.device)
    materials = on_device(baked.data.materials, baked.device)
    atlas = baked.atlas

    def intersect_alpha(origin, direction, t_min, t_max=None, closest=True,
                        cull_backface=False, coherent=True, const_origin=False):
        del closest, const_origin
        tmin = _restart_tmin(t_min, origin)
        hit = intersect(origin, direction, tmin, t_max, True, cull_backface,
                        coherent=coherent)
        for _ in range(max_restarts):
            fail = _alpha_fails(tris, materials, atlas, hit, origin, direction)
            tmin = torch.where(fail, _push_tmin(hit, tmin), _INERT)
            hit2 = intersect(origin, direction, tmin, t_max, True, cull_backface,
                             coherent=coherent)
            hit = _select(fail, hit2, hit)
        return hit

    return intersect_alpha


def wrap_tracer(baked, trace, max_restarts: int = MAX_RESTARTS):
    """Alpha-aware `trace(origin, direction, t_min, view_origin,
    cull_backface=False, coherent=True, lean=False) -> (HitRecord,
    ShadingData)`: restarts past hits whose sampled base alpha fails; the
    ShadingData's uv and material of the current hit drive the test, the
    data the reference's any-hit reads.  The select runs over every field
    of both records."""
    materials = on_device(baked.data.materials, baked.device)
    atlas = baked.atlas

    def trace_alpha(origin, direction, t_min, view_origin, cull_backface=False,
                    coherent=True, lean=False):
        del lean  # the test reads sd.uv and sd.material_id: the full decode
        tmin = _restart_tmin(t_min, origin)
        hit, sd = trace(origin, direction, tmin, view_origin, cull_backface,
                        coherent=coherent)
        for _ in range(max_restarts):
            fail = _fails(atlas, materials, hit, sd.material_id, sd.uv)
            tmin = torch.where(fail, _push_tmin(hit, tmin), _INERT)
            hit2, sd2 = trace(origin, direction, tmin, view_origin, cull_backface,
                              coherent=coherent)
            hit = _select(fail, hit2, hit)
            sd = _select(fail, sd2, sd)
        return hit, sd

    return trace_alpha
