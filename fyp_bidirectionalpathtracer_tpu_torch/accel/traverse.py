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
  above 1M triangles, with the same routing: two walks (any hit, closest
  hit) of the bake's two-box BVH table over its Baldwin-Weber rows.

Barycentrics follow DXR: P = (1-u-v) v0 + u v1 + v v2.

The JAX package sends the shadow rays of a 513-2048 triangle scene to its
cluster tier (`scene.py:389` passes `brute_threshold=512`); the port keeps
the dense any-hit kernel up to 2048 triangles, since an any-hit answer does
not depend on the tier.

`coherent=False` marks an incoherent wavefront.  JAX sorts such a batch by
direction-major keys on its cluster tiers (`sort_wavefront`,
`traverse.py:349-411`) and unsorts the answers; the port's BVH tier walks
it in the same order (`ops/raysort.sort_order` over the bake's
`sort_bounds`, empty-interval lanes last) by the BVH kernels' `order`,
which answers each ray in place: the output is the unsorted call's bit for
bit.  The dense tier stays unsorted, as JAX's dense tiers are.
`const_origin` (every ray shares one origin) only spares JAX three sort
payload columns; the port's sort moves no ray data, so it changes nothing.

Each query is the span `trace` (`utils/profiler`), and its direction sort
the span `sort` inside it.
"""
from __future__ import annotations

from functools import partial

import torch

from ..ops.raysort import sort_order
from ..utils.profiler import span
from . import cluster
from . import intersect as isect
from .intersect import _BIG, MAX_DENSE_TRIS, HitRecord
from .tri_pack import TriSoA  # noqa: F401  (the JAX module's TriSoA)

CLUSTER_THRESHOLD = 32768  # above it JAX's shaded tracer gathers its attributes


def make_intersector(tri_pack: torch.Tensor, n_tris: int, pairs: torch.Tensor | None = None,
                     bw_rows: torch.Tensor | None = None, *, plain: bool = False,
                     bounds: torch.Tensor | None = None):
    """Build the `intersect(origin, direction, t_min, t_max=None,
    closest=True, cull_backface=False, coherent=True, const_origin=False)
    -> HitRecord` closure over the bake's [T_pad, 48] pack (and, above 2048
    triangles, its two-box BVH table `pairs` and Baldwin-Weber rows
    `bw_rows`, which the BVH kernels walk, and its bounds [2, 3] `bounds`,
    the box of the sort keys of incoherent batches).

    `coherent=False` on the BVH tier walks the rays in direction-sorted
    order (see the module doc); `const_origin` is accepted and changes
    nothing.  `plain=True` runs the kernels' plain versions on any device
    (the reference the kernels are held against on the card)."""
    bvh_tier = False
    if plain or n_tris <= MAX_DENSE_TRIS:
        occluded = partial(isect.occluded_plain if plain else isect.occluded, tri_pack, n_tris)
        closest_hit = partial(isect.closest_plain if plain else isect.intersect_closest,
                              tri_pack, n_tris)
    elif pairs is None or bw_rows is None:
        raise ValueError(f"{n_tris} triangles need the bake's two-box BVH table and "
                         f"Baldwin-Weber rows")
    else:
        occluded = partial(cluster.bvh_occluded, bw_rows, n_tris, pairs)
        closest_hit = partial(cluster.bvh_closest, bw_rows, n_tris, pairs)
        bvh_tier = True

    def intersect(origin, direction, t_min, t_max=None, closest=True,
                  cull_backface=False, coherent=True, const_origin=False):
        del const_origin
        with span("trace"):
            kw = {}
            if bvh_tier and not coherent:
                if bounds is None:
                    raise ValueError("an incoherent batch on the BVH tier is sorted by keys "
                                     "over the bake's bounds, which were not given")
                with span("sort"):
                    kw["order"] = sort_order(origin, direction, t_min, t_max, bounds)
            if not closest and not cull_backface:
                occ = occluded(origin, direction, t_min, t_max, **kw)
                zero = torch.zeros(occ.shape, dtype=torch.float32, device=occ.device)
                return HitRecord(t=torch.where(occ, zero, _BIG),
                                 tri=torch.where(occ, 0, -1).to(torch.int32),
                                 bary_u=zero, bary_v=zero)
            return closest_hit(origin, direction, t_min, t_max, cull_backface=cull_backface,
                               **kw)

    return intersect
