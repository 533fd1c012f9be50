"""Ray-scene intersection for the wavefront path (the TraceRay replacement).

Port of `fyp_bidirectionalpathtracer_tpu/accel/traverse.py`: `HitRecord`
and the `_BIG = 1e30` miss convention (defined beside the kernels, in
`accel/intersect.py`), `TriSoA` (here `accel/tri_pack.py`) and
`make_intersector`.  Every query runs a kernel, by scene size:

- at most 2048 triangles, the dense kernels of `accel/intersect.py` (K4a-
  K4e): any-hit without culling goes to the any-hit kernel, closest hit
  and culled any-hit to the closest-hit kernel;
- above that, at every size, the BVH kernels of `accel/cluster.py`, which
  replace the cluster and HBM tiers (K4f-K4j) and JAX's jnp `intersect_bvh`
  above 1M triangles, with the same routing.

Barycentrics follow DXR: P = (1-u-v) v0 + u v1 + v v2.

The JAX package sends the shadow rays of a 513-2048 triangle scene to its
cluster tier (`scene.py:389` passes `brute_threshold=512`); the port keeps
the dense any-hit kernel up to 2048 triangles, since an any-hit answer does
not depend on the tier.
"""
from __future__ import annotations

from functools import partial

import torch

from . import cluster
from . import intersect as isect
from .intersect import _BIG, MAX_DENSE_TRIS, HitRecord
from .tri_pack import TriSoA  # noqa: F401  (the JAX module's TriSoA)

CLUSTER_THRESHOLD = 32768  # above it JAX's shaded tracer gathers its attributes


def make_intersector(tri_pack: torch.Tensor, n_tris: int, nodes: torch.Tensor | None = None,
                     *, plain: bool = False):
    """Build the `intersect(origin, direction, t_min, t_max=None,
    closest=True, cull_backface=False, coherent=True, const_origin=False)
    -> HitRecord` closure over the bake's [T_pad, 48] pack (and, above 2048
    triangles, its BVH node table `nodes`).

    `coherent` and `const_origin` are accepted and ignored: on the JAX
    cluster tiers they only choose a direction sort that gives the same
    output (`traverse.py:349-411`).  `plain=True` runs the kernels' plain
    versions on any device (the reference the kernels are held against on
    the card)."""
    if plain or n_tris <= MAX_DENSE_TRIS:
        occluded = partial(isect.occluded_plain if plain else isect.occluded, tri_pack, n_tris)
        closest_hit = partial(isect.closest_plain if plain else isect.intersect_closest,
                              tri_pack, n_tris)
    elif nodes is None:
        raise ValueError(f"{n_tris} triangles need the bake's BVH node table")
    else:
        occluded = partial(cluster.bvh_occluded, tri_pack, n_tris, nodes)
        closest_hit = partial(cluster.bvh_closest, tri_pack, n_tris, nodes)

    def intersect(origin, direction, t_min, t_max=None, closest=True,
                  cull_backface=False, coherent=True, const_origin=False):
        del coherent, const_origin
        if not closest and not cull_backface:
            occ = occluded(origin, direction, t_min, t_max)
            zero = torch.zeros(occ.shape, dtype=torch.float32, device=occ.device)
            return HitRecord(t=torch.where(occ, zero, _BIG),
                             tri=torch.where(occ, 0, -1).to(torch.int32),
                             bary_u=zero, bary_v=zero)
        return closest_hit(origin, direction, t_min, t_max, cull_backface=cull_backface)

    return intersect
