"""Ray-scene intersection for the wavefront path (the TraceRay replacement).

Port of `fyp_bidirectionalpathtracer_tpu/accel/traverse.py`: `HitRecord`
and the `_BIG = 1e30` miss convention (defined beside the kernels, in
`accel/intersect.py`), `TriSoA` (here `accel/tri_pack.py`) and
`make_intersector`, for the dense tier of at most 2048 triangles.  Every
query runs one of the dense kernels of `accel/intersect.py` (K4): any-hit
without culling goes to the any-hit kernel, closest hit and culled any-hit
to the closest-hit kernel.  Barycentrics follow DXR:
P = (1-u-v) v0 + u v1 + v v2.

The JAX package sends the shadow rays of a 513-2048 triangle scene to its
cluster tier (`scene.py:389` passes `brute_threshold=512`); the port keeps
the dense any-hit kernel up to 2048 triangles, since an any-hit answer does
not depend on the tier.  Scenes above 2048 triangles need the cluster and
HBM tiers (K4f-K4j), which are not ported yet.
"""
from __future__ import annotations

import torch

from . import intersect as isect
from .intersect import _BIG, HitRecord, check_dense
from .tri_pack import TriSoA  # noqa: F401  (the JAX module's TriSoA)


def make_intersector(tri_pack: torch.Tensor, n_tris: int, *, plain: bool = False):
    """Build the `intersect(origin, direction, t_min, t_max=None,
    closest=True, cull_backface=False, coherent=True, const_origin=False)
    -> HitRecord` closure over the bake's [T_pad, 48] pack.

    `coherent` and `const_origin` are accepted and ignored, as on the JAX
    dense tier: the dense kernels do not care about ray order.  `plain=True`
    runs the kernels' plain versions on any device (the reference the
    kernels are held against on the card)."""
    check_dense(n_tris)
    occluded = isect.occluded_plain if plain else isect.occluded
    closest_hit = isect.closest_plain if plain else isect.intersect_closest

    def intersect(origin, direction, t_min, t_max=None, closest=True,
                  cull_backface=False, coherent=True, const_origin=False):
        del coherent, const_origin
        if not closest and not cull_backface:
            occ = occluded(tri_pack, n_tris, origin, direction, t_min, t_max)
            zero = torch.zeros(occ.shape, dtype=torch.float32, device=occ.device)
            return HitRecord(t=torch.where(occ, zero, _BIG),
                             tri=torch.where(occ, 0, -1).to(torch.int32),
                             bary_u=zero, bary_v=zero)
        return closest_hit(tri_pack, n_tris, origin, direction, t_min, t_max,
                           cull_backface)

    return intersect
