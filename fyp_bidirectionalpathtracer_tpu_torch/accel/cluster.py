"""BVH intersection above 2048 triangles: the BVH kernels and their plain
versions.

The port's counterpart of `fyp_bidirectionalpathtracer_tpu/accel/
pallas_cluster.py`.  Five TPU kernels there compute two functions and
differ only in how they fit VMEM, SMEM and HBM (clusters of ck triangles,
per-cell shortlists, DMA paging).  Per-ray walks of the two-box form of the
bake's BVH (`pack_bvh_pairs`) with a short stack, nearer child first, over
the Baldwin-Weber rows, carry that contract in three persistent CUDA
kernels that take only the rays that need a walk (`csrc/bvh.cu`,
`csrc/bvh_pairs.cuh`):

- `bvh_closest` -> HitRecord: closest hit (K4h `_cluster_closest_kernel`,
  K4j `_cluster_closest_hbm_kernel`), with or without backface culling;
- `bvh_shaded_fm` -> (HitRecord, fields [32, ...]): closest hit plus the
  winner's attributes from its pack row, field-major (K4g
  `_cluster_shaded_kernel`);
- `bvh_occluded` -> bool: any hit in (t_min, t_max), no culling (K4f
  `_cluster_occlusion_kernel`, K4i `_cluster_occlusion_hbm_kernel`).

The adapters `occluded_clusters(_hbm)`, `intersect_closest_clusters(_hbm)`
and `intersect_shaded_clusters(_fm)` keep the JAX names and output layouts;
they take the port's tables (the bake's [T_pad, 12] Baldwin-Weber rows and
two-box table, `pair_tables`; the shaded ones also its [T_pad, 48] pack)
in place of the TPU layout arguments (`aabbs`, `ck`, `interpret`,
`directional`, `proxy_pack`).  The threaded node table (`pack_bvh_nodes`)
serves K1's textured walk (`csrc/bvh.cuh`) and the counting walks.

The plain versions are the dense chunked programs of `accel/intersect.py`
(`closest_plain`, `occluded_plain`, `shaded_plain`).  The walks resolve
ties by (t, id) and cull conservatively, so a kernel equals its plain
version bit for bit.  A wrapper runs the plain version for CPU tensors and
launches its kernel for CUDA tensors.

Each wrapper takes an optional `order` (int32 [N], a permutation of the
rays, `ops/raysort.sort_order`): the kernel walks the rays in that order
(slot j of its ray counter takes ray order[j]) and answers each in place,
and the plain version gathers the rays in that order and scatters its
answers back.  A ray's answer depends on that ray alone, so the output is
the unordered call's bit for bit.  A launch with an order also counts in
`cuda.LAUNCHES_BY_VARIANT` under `<kernel>[order]`.  Each wrapper adds the
rays of its batch to `cuda.RAYS[<kernel>]` on every device, from the
batch's shape.
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
PAIR_COLS = 16  # csrc/bvh_pairs.cuh kPairCols
BW_COLS = 12  # csrc/intersect.cuh kBwCols
STACK_SIZE = 32  # csrc/bvh_pairs.cuh kStackSize: the deepest tree the two-box walks take
# node boxes grow by this share of the scene's size (largest coordinate
# magnitude plus the diagonal): more than the rounding of a Baldwin-Weber
# hit point, so no box excludes a pair the dense test accepts
PAD_REL = 1e-4
# csrc/bvh.cu bvh_count_kernel: the threaded walks, and the two-box walks
COUNT_MODES = {"closest": 0, "closest_cull": 1, "any": 2}
PAIR_COUNT_MODES = {"any": 3, "closest": 4, "closest_cull": 5}


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


def pack_bvh_pairs(bvh) -> torch.Tensor:
    """The BVH kernels' two-box table [N_inner, 16] float32 from the bake's
    BVHArrays (`csrc/bvh_pairs.cuh` has the layout): a row for each
    inner node in pre-order, root first, with both children's boxes as
    `pack_bvh_nodes` pads them and their links (an inner child's row, or
    ~((first << 3) | count) for a leaf).  In the pre-order threading the
    children of inner node i are i + 1 and miss[i + 1].  A tree that is a
    single leaf gets one row: the leaf beside an empty leaf.  Raises on a
    tree deeper than the walks' stack (STACK_SIZE inner nodes on a path)."""
    table = pack_bvh_nodes(bvh).numpy()
    ints = table[:, 6:].view(np.int32)
    miss, code = ints[:, 0].astype(np.int64), ints[:, 1].astype(np.int64)
    inner = np.nonzero(code < 0)[0]
    if len(inner) == 0:
        links = np.asarray([~code[0], ~(code[0] & ~7)], np.int32)
        row = np.concatenate([table[0, :6], table[0, :6], links.view(np.float32),
                              np.zeros(2, np.float32)])
        return torch.from_numpy(row[None].astype(np.float32))
    c0, c1 = inner + 1, miss[inner + 1]
    if not ((c1 > c0) & (c1 < len(table))).all():
        raise ValueError("an inner node of the BVH lacks its second child")
    rank = np.full(len(table), -1, np.int64)
    rank[inner] = np.arange(len(inner))
    depth = np.zeros(len(table), np.int64)
    depth[0] = 1
    for i, a, b in zip(inner.tolist(), c0.tolist(), c1.tolist()):  # parents come first
        depth[a] = depth[b] = depth[i] + 1
    levels = int(depth[inner].max())
    if levels > STACK_SIZE:
        raise ValueError(f"the BVH has {levels} inner levels; the two-box walks' stack "
                         f"holds {STACK_SIZE}")

    def link(c):
        return np.where(code[c] < 0, rank[c], ~code[c]).astype(np.int32)

    links = np.stack([link(c0), link(c1), np.zeros_like(c0, np.int32),
                      np.zeros_like(c0, np.int32)], 1)
    rows = np.concatenate([table[c0, :6], table[c1, :6], links.view(np.float32)], 1)
    return torch.from_numpy(np.ascontiguousarray(rows, np.float32))


def pair_tables(bvh, tri_pack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The BVH kernels' tables of a bake, on the pack's device: the
    [T_pad, 12] Baldwin-Weber rows (the pack's first columns, contiguous,
    in its leaf order) and the two-box table (`pack_bvh_pairs`)."""
    return tri_pack[:, :BW_COLS].contiguous(), pack_bvh_pairs(bvh).to(tri_pack.device)


def check_nodes(nodes, device) -> None:
    """The node table of `pack_bvh_nodes`: float32 [N >= 1, NODE_COLS] on `device`."""
    cuda.check_tensor("nodes", nodes, torch.float32, device)
    if nodes.dim() != 2 or nodes.shape[1] != NODE_COLS or nodes.shape[0] < 1:
        raise ValueError(f"nodes must be [N >= 1, {NODE_COLS}], got {tuple(nodes.shape)}")


def check_pairs(pairs, device) -> None:
    """The two-box table of `pack_bvh_pairs`: float32 [N >= 1, PAIR_COLS] on `device`."""
    cuda.check_tensor("pairs", pairs, torch.float32, device)
    if pairs.dim() != 2 or pairs.shape[1] != PAIR_COLS or pairs.shape[0] < 1:
        raise ValueError(f"pairs must be [N >= 1, {PAIR_COLS}], got {tuple(pairs.shape)}")


def _check(rows, n_tris, pairs, origin, direction):
    check_rays(rows, n_tris, origin, direction, cols=BW_COLS)
    check_pairs(pairs, origin.device)


def _counter(dev) -> torch.Tensor:
    """A persistent kernel's ray counter: one int32, zeroed by the launch."""
    return torch.empty((1,), dtype=torch.int32, device=dev)


def _check_order(order, origin) -> None:
    if order is not None:
        cuda.check_tensor("order", order, torch.int32, origin.device)
        n = origin.numel() // 3
        if order.shape != (n,):
            raise ValueError(f"order must be [{n}], got {tuple(order.shape)}")


def _launch(kernel: str, err: int, order) -> None:
    cuda.check_launch(kernel, err, None if order is None else f"{kernel}[order]")


def _gathered(order, origin, direction, t_min, t_max):
    """The rays, flat, in `order`: (origin, direction, t_min, t_max, the
    index tensor); a scalar or absent interval end stays as it is."""
    shape, idx = origin.shape[:-1], order.long()

    def pick(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return torch.broadcast_to(x.to(origin.device, torch.float32), shape).reshape(-1)[idx]

    return (origin.reshape(-1, 3)[idx], direction.reshape(-1, 3)[idx], pick(t_min),
            pick(t_max), idx)


def _scattered(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Columns [..., N] computed in the order `idx`, back in ray order."""
    out = torch.empty_like(x)
    out[..., idx] = x
    return out


# ------------------------------------------------------------ closest hit
def bvh_closest(rows, n_tris, pairs, origin, direction, t_min, t_max=None,
                cull_backface=False, order=None) -> HitRecord:
    """Closest hit of rays [..., 3] in (t_min, t_max) (t_max None: 1e30),
    over the bake's [T_pad, 12] Baldwin-Weber rows (`BakedScene.bw_rows`)
    and two-box table (`BakedScene.bvh_pairs`), the rays walked in `order`
    (see the module doc)."""
    _check(rows, n_tris, pairs, origin, direction)
    _check_order(order, origin)
    cuda.RAYS["bvh_closest"] += origin.numel() // 3
    if origin.device.type == "cpu":
        if order is None:
            return closest_plain(rows, n_tris, origin, direction, t_min, t_max, cull_backface)
        o, d, tn, tm, idx = _gathered(order, origin, direction, t_min, t_max)
        h = closest_plain(rows, n_tris, o, d, tn, tm, cull_backface)
        return hit_record(*(_scattered(x, idx) for x in (h.t, h.tri, h.bary_u, h.bary_v)),
                          tuple(origin.shape[:-1]))
    ray_rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = ray_rows.shape[1], ray_rows.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    _launch("bvh_closest", cuda.library().bdpt_bvh_closest(
        cuda.ptr(ray_rows), n, cuda.ptr(rows), cuda.ptr(pairs), int(bool(cull_backface)),
        cuda.ptr(t), cuda.ptr(tri), cuda.ptr(u), cuda.ptr(v), cuda.ptr(_counter(dev)),
        cuda.ptr(order), cuda.stream(dev)), order)
    return hit_record(t, tri, u, v, shape)


# ------------------------------------------------- closest hit + attributes
def bvh_shaded_fm(tri_pack, n_tris, rows, pairs, origin, direction, t_min, t_max=None,
                  cull_backface=False, order=None):
    """Closest hit plus the winner's attributes: (HitRecord, fields_fm
    [32, ...]), the table of `accel/intersect.py`; the walk as
    `bvh_closest`'s, the fields from the winner's row of the [T_pad, 48]
    pack `tri_pack`."""
    _check(rows, n_tris, pairs, origin, direction)
    check_rays(tri_pack, n_tris, origin, direction)
    _check_order(order, origin)
    cuda.RAYS["bvh_shaded"] += origin.numel() // 3
    if origin.device.type == "cpu":
        if order is None:
            return shaded_plain(tri_pack, n_tris, origin, direction, t_min, t_max,
                                cull_backface)
        o, d, tn, tm, idx = _gathered(order, origin, direction, t_min, t_max)
        _, f = shaded_plain(tri_pack, n_tris, o, d, tn, tm, cull_backface)
        shape = tuple(origin.shape[:-1])
        fields = _scattered(f, idx)
        return shaded_hit(fields, shape), fields.reshape((OUT_W,) + shape)
    ray_rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = ray_rows.shape[1], ray_rows.device
    fields = torch.empty((OUT_W, n), dtype=torch.float32, device=dev)
    _launch("bvh_shaded", cuda.library().bdpt_bvh_shaded(
        cuda.ptr(ray_rows), n, cuda.ptr(tri_pack), cuda.ptr(rows), cuda.ptr(pairs),
        int(bool(cull_backface)), cuda.ptr(fields), cuda.ptr(_counter(dev)), cuda.ptr(order),
        cuda.stream(dev)), order)
    return shaded_hit(fields, shape), fields.reshape((OUT_W,) + shape)


# ---------------------------------------------------------------- any hit
def bvh_occluded(rows, n_tris, pairs, origin, direction, t_min, t_max=None,
                 order=None) -> torch.Tensor:
    """Any hit of rays [..., 3] in (t_min, t_max), no culling -> bool [...],
    over the Baldwin-Weber rows and the two-box table, the rays walked in
    `order`."""
    _check(rows, n_tris, pairs, origin, direction)
    _check_order(order, origin)
    cuda.RAYS["bvh_occluded"] += origin.numel() // 3
    if origin.device.type == "cpu":
        if order is None:
            return occluded_plain(rows, n_tris, origin, direction, t_min, t_max)
        o, d, tn, tm, idx = _gathered(order, origin, direction, t_min, t_max)
        occ = occluded_plain(rows, n_tris, o, d, tn, tm)
        return _scattered(occ, idx).reshape(origin.shape[:-1])
    ray_rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = ray_rows.shape[1], ray_rows.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    _launch("bvh_occluded", cuda.library().bdpt_bvh_occluded(
        cuda.ptr(ray_rows), n, cuda.ptr(rows), cuda.ptr(pairs), cuda.ptr(occ),
        cuda.ptr(_counter(dev)), cuda.ptr(order), cuda.stream(dev)), order)
    return occ.reshape(shape)


def _counts(tris, nodes, origin, direction, t_min, t_max, mode: int) -> torch.Tensor:
    ray_rows, _ = rays(origin, direction, t_min, t_max)
    n, dev = ray_rows.shape[1], ray_rows.device
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    cuda.check_error("bvh_count", cuda.library().bdpt_bvh_count(
        cuda.ptr(ray_rows), n, cuda.ptr(tris), cuda.ptr(nodes), mode, cuda.ptr(out),
        cuda.stream(dev)))
    return out


def bvh_walk_counts(tri_pack, n_tris, nodes, origin, direction, t_min, t_max=None,
                    mode: str = "closest") -> torch.Tensor:
    """What the threaded walk (`csrc/bvh.cuh`, K1's textured walk, which the
    BVH kernels ran before their two-box walks) does on these rays, from its
    counting instantiation (CUDA only, not counted as a launch): int32
    [4, N] a ray of node rows read (one slab test each) and pair tests by
    the stage they reach (n.d; t; u and v).  `mode`: closest, closest_cull
    or any."""
    check_rays(tri_pack, n_tris, origin, direction)
    check_nodes(nodes, origin.device)
    return _counts(tri_pack, nodes, origin, direction, t_min, t_max, COUNT_MODES[mode])


def bvh_pair_walk_counts(rows, n_tris, pairs, origin, direction, t_min, t_max=None,
                         mode: str = "any") -> torch.Tensor:
    """What the BVH kernels' two-box walks (`csrc/bvh_pairs.cuh`) do on
    these rays, as `bvh_walk_counts` counts it, over the Baldwin-Weber rows
    and the two-box table: the first count is of two-box rows read, two
    slab tests each.  `mode`: any, closest or closest_cull."""
    _check(rows, n_tris, pairs, origin, direction)
    return _counts(rows, pairs, origin, direction, t_min, t_max, PAIR_COUNT_MODES[mode])


# ------------------------------------------ adapters with the JAX names
def occluded_clusters(rows, n_tris, pairs, origin, direction, t_min,
                      t_max=None) -> torch.Tensor:
    """K4f's entry point (`pallas_cluster.py:1319`), over the bake's
    Baldwin-Weber rows and two-box table."""
    return bvh_occluded(rows, n_tris, pairs, origin, direction, t_min, t_max)


def intersect_closest_clusters(rows, n_tris, pairs, origin, direction, t_min,
                               t_max=None, cull_backface=False) -> HitRecord:
    """K4h's entry point (`pallas_cluster.py:1122`), over the bake's
    Baldwin-Weber rows and two-box table."""
    return bvh_closest(rows, n_tris, pairs, origin, direction, t_min, t_max, cull_backface)


def intersect_shaded_clusters(tri_pack, n_tris, rows, pairs, origin, direction, t_min,
                              t_max=None, cull_backface=False):
    """K4g's row-major entry point (`pallas_cluster.py:1340`): (HitRecord,
    fields [..., 32]), over the bake's pack, Baldwin-Weber rows and two-box
    table."""
    hit, fields_fm = bvh_shaded_fm(tri_pack, n_tris, rows, pairs, origin, direction, t_min,
                                   t_max, cull_backface)
    return hit, fields_fm.movedim(0, -1)


occluded_clusters_hbm = occluded_clusters                   # K4i (:1260)
intersect_closest_clusters_hbm = intersect_closest_clusters  # K4j (:1280)
intersect_shaded_clusters_fm = bvh_shaded_fm                # K4g field-major (:1376)
