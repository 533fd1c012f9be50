"""BVH intersection above 2048 triangles: the BVH kernels and their plain
versions.

The port's counterpart of `fyp_bidirectionalpathtracer_tpu/accel/
pallas_cluster.py`.  Five TPU kernels there compute two functions and
differ only in how they fit VMEM, SMEM and HBM (clusters of ck triangles,
per-cell shortlists, DMA paging).  One per-ray walk of the bake's threaded
BVH (`csrc/bvh.cuh`) carries that contract in three CUDA kernels
(`csrc/bvh.cu`):

- `bvh_closest` -> HitRecord: closest hit (K4h `_cluster_closest_kernel`,
  K4j `_cluster_closest_hbm_kernel`), with or without backface culling;
- `bvh_shaded_fm` -> (HitRecord, fields [32, ...]): closest hit plus the
  winner's attributes, field-major (K4g `_cluster_shaded_kernel`);
- `bvh_occluded` -> bool: any hit in (t_min, t_max), no culling (K4f
  `_cluster_occlusion_kernel`, K4i `_cluster_occlusion_hbm_kernel`).

The adapters `occluded_clusters(_hbm)`, `intersect_closest_clusters(_hbm)`
and `intersect_shaded_clusters(_fm)` keep the JAX names and output layouts;
they take the port's tables (the bake's [T_pad, 48] pack and node table)
in place of the TPU layout arguments (`aabbs`, `ck`, `interpret`,
`directional`, `proxy_pack`).

The plain versions are the dense chunked programs of `accel/intersect.py`
(`closest_plain`, `occluded_plain`, `shaded_plain`).  The walk resolves ties
by (t, id) and culls conservatively, so a kernel equals its plain version
bit for bit.  A wrapper runs the plain version for CPU tensors and launches
its kernel for CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from .intersect import (
    OUT_W,
    HitRecord,
    check_rays,
    closest_plain,
    hit_record,
    occluded_plain,
    rays,
    shaded_hit,
    shaded_plain,
)

NODE_COLS = 8  # csrc/bvh.cuh kNodeCols
# node boxes grow by this share of the scene's size (largest coordinate
# magnitude plus the diagonal): more than the rounding of a Baldwin-Weber
# hit point, so no box excludes a pair the dense test accepts
PAD_REL = 1e-4
COUNT_MODES = {"closest": 0, "closest_cull": 1, "any": 2}


def pack_bvh_nodes(bvh) -> torch.Tensor:
    """The kernels' node table [N, 8] float32 from the bake's BVHArrays: the
    padded box (min xyz, max xyz), then two int32 in float bits: the miss
    link, and -1 for an inner node or (first << 3) | count for a leaf.

    The table relies on the pre-order threading of `accel/bvh.build_bvh`:
    an inner node's hit link is the next node and a leaf's hit link is its
    miss link; it raises on a tree that is not so threaded."""
    lo = np.asarray(bvh.node_min, np.float32)
    hi = np.asarray(bvh.node_max, np.float32)
    left = np.asarray(bvh.node_left, np.int64)
    count = np.asarray(bvh.node_count, np.int64)
    hit = np.asarray(bvh.node_hit, np.int64)
    miss = np.asarray(bvh.node_miss, np.int64)
    n = len(lo)
    leaf = hit == miss
    inner_ok = (count == 0) & (hit == np.arange(n) + 1)
    if not (leaf | inner_ok).all() or (count > 7).any() or (left >= 1 << 28).any():
        raise ValueError("the BVH is not a pre-order threaded tree with leaves of at "
                         "most 7 triangles")
    size = float(np.abs(np.concatenate([lo[0], hi[0]])).max() + np.linalg.norm(hi[0] - lo[0]))
    pad = np.float32(PAD_REL * size)
    ints = np.stack([miss, np.where(leaf, (left << 3) | count, -1)], 1).astype(np.int32)
    table = np.concatenate([lo - pad, hi + pad, ints.view(np.float32)], 1)
    return torch.from_numpy(np.ascontiguousarray(table, np.float32))


def check_nodes(nodes, device) -> None:
    """The node table of `pack_bvh_nodes`: float32 [N >= 1, NODE_COLS] on `device`."""
    cuda.check_tensor("nodes", nodes, torch.float32, device)
    if nodes.dim() != 2 or nodes.shape[1] != NODE_COLS or nodes.shape[0] < 1:
        raise ValueError(f"nodes must be [N >= 1, {NODE_COLS}], got {tuple(nodes.shape)}")


def _check(tri_pack, n_tris, nodes, origin, direction):
    check_rays(tri_pack, n_tris, origin, direction)
    check_nodes(nodes, origin.device)


# ------------------------------------------------------------ closest hit
def bvh_closest(tri_pack, n_tris, nodes, origin, direction, t_min, t_max=None,
                cull_backface=False) -> HitRecord:
    """Closest hit of rays [..., 3] in (t_min, t_max) (t_max None: 1e30)."""
    _check(tri_pack, n_tris, nodes, origin, direction)
    if origin.device.type == "cpu":
        return closest_plain(tri_pack, n_tris, origin, direction, t_min, t_max, cull_backface)
    rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = rows.shape[1], rows.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    cuda.check_launch("bvh_closest", cuda.library().bdpt_bvh_closest(
        cuda.ptr(rows), n, cuda.ptr(tri_pack), cuda.ptr(nodes), int(bool(cull_backface)),
        cuda.ptr(t), cuda.ptr(tri), cuda.ptr(u), cuda.ptr(v), cuda.stream(dev)))
    return hit_record(t, tri, u, v, shape)


# ------------------------------------------------- closest hit + attributes
def bvh_shaded_fm(tri_pack, n_tris, nodes, origin, direction, t_min, t_max=None,
                  cull_backface=False):
    """Closest hit plus the winner's attributes: (HitRecord, fields_fm
    [32, ...]), the table of `accel/intersect.py`."""
    _check(tri_pack, n_tris, nodes, origin, direction)
    if origin.device.type == "cpu":
        return shaded_plain(tri_pack, n_tris, origin, direction, t_min, t_max, cull_backface)
    rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = rows.shape[1], rows.device
    fields = torch.empty((OUT_W, n), dtype=torch.float32, device=dev)
    cuda.check_launch("bvh_shaded", cuda.library().bdpt_bvh_shaded(
        cuda.ptr(rows), n, cuda.ptr(tri_pack), cuda.ptr(nodes), int(bool(cull_backface)),
        cuda.ptr(fields), cuda.stream(dev)))
    return shaded_hit(fields, shape), fields.reshape((OUT_W,) + shape)


# ---------------------------------------------------------------- any hit
def bvh_occluded(tri_pack, n_tris, nodes, origin, direction, t_min, t_max=None) -> torch.Tensor:
    """Any hit of rays [..., 3] in (t_min, t_max), no culling -> bool [...]."""
    _check(tri_pack, n_tris, nodes, origin, direction)
    if origin.device.type == "cpu":
        return occluded_plain(tri_pack, n_tris, origin, direction, t_min, t_max)
    rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = rows.shape[1], rows.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    cuda.check_launch("bvh_occluded", cuda.library().bdpt_bvh_occluded(
        cuda.ptr(rows), n, cuda.ptr(tri_pack), cuda.ptr(nodes), cuda.ptr(occ),
        cuda.stream(dev)))
    return occ.reshape(shape)


def bvh_walk_counts(tri_pack, n_tris, nodes, origin, direction, t_min, t_max=None,
                    mode: str = "closest") -> torch.Tensor:
    """What the kernels' walk does on these rays, from its counting
    instantiation (CUDA only, not counted as a launch): int32 [4, N] a ray
    of node rows read (one slab test each) and pair tests by the stage they
    reach (n.d; t; u and v).  `mode`: closest, closest_cull or any."""
    _check(tri_pack, n_tris, nodes, origin, direction)
    rows, _ = rays(origin, direction, t_min, t_max)
    n, dev = rows.shape[1], rows.device
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    cuda.check_error("bvh_count", cuda.library().bdpt_bvh_count(
        cuda.ptr(rows), n, cuda.ptr(tri_pack), cuda.ptr(nodes), COUNT_MODES[mode],
        cuda.ptr(out), cuda.stream(dev)))
    return out


# ------------------------------------------ adapters with the JAX names
def occluded_clusters(tri_pack, n_tris, nodes, origin, direction, t_min,
                      t_max=None) -> torch.Tensor:
    """K4f's entry point (`pallas_cluster.py:1319`)."""
    return bvh_occluded(tri_pack, n_tris, nodes, origin, direction, t_min, t_max)


def intersect_closest_clusters(tri_pack, n_tris, nodes, origin, direction, t_min,
                               t_max=None, cull_backface=False) -> HitRecord:
    """K4h's entry point (`pallas_cluster.py:1122`)."""
    return bvh_closest(tri_pack, n_tris, nodes, origin, direction, t_min, t_max,
                       cull_backface)


def intersect_shaded_clusters(tri_pack, n_tris, nodes, origin, direction, t_min,
                              t_max=None, cull_backface=False):
    """K4g's row-major entry point (`pallas_cluster.py:1340`): (HitRecord,
    fields [..., 32])."""
    hit, fields_fm = bvh_shaded_fm(tri_pack, n_tris, nodes, origin, direction, t_min,
                                   t_max, cull_backface)
    return hit, fields_fm.movedim(0, -1)


occluded_clusters_hbm = occluded_clusters                   # K4i (:1260)
intersect_closest_clusters_hbm = intersect_closest_clusters  # K4j (:1280)
intersect_shaded_clusters_fm = bvh_shaded_fm                # K4g field-major (:1376)
