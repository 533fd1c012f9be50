"""Host-side BVH construction -> flattened threaded node arrays.

TPU-native replacement for the reference's DXR acceleration structures
(RtModel::buildAccelerationStructure, RtModel.cpp:181-254, and
RtScene::createTlas, RtScene.cpp:220-308).  The app loads scenes with
RemoveInstancing (SceneLoaderWrapper.cpp:58), so a single flat BVH over the
pre-transformed triangle soup is a faithful stand-in for the TLAS/BLAS split.

The tree is emitted in DFS pre-order with *threaded* hit/miss links so the
device-side traversal is stackless: each ray keeps one int32 cursor and steps
  cursor = aabb_hit ? node_hit : node_miss
with leaves additionally running their (<= leaf_size) triangle tests.  This
maps a divergent recursive traversal onto a lockstep vector loop.

Construction: binned split (largest-extent axis, 16 bins) with median fallback;
pure numpy, iterative (no recursion limits).  An optional C++ implementation
(native/bvh_builder.cc via ctypes) produces the same arrays faster for large
meshes.

The port's own copy of `fyp_bidirectionalpathtracer_tpu/accel/bvh.py`: the
bake orders triangles by `build_bvh`'s `tri_order`, so both packages number
triangles the same way (held equal by `tests/test_torch_scene.py`, through
the native library and through the numpy construction).
"""
from __future__ import annotations

import numpy as np

from .native import build_sah_native  # optional C++ path (None if unavailable)

_N_BINS = 16


def _empty_bvh():
    return {
        "node_min": np.zeros((1, 3), np.float32),
        "node_max": np.zeros((1, 3), np.float32),
        "node_left": np.zeros(1, np.int32),
        "node_count": np.zeros(1, np.int32),
        "node_hit": np.full(1, -1, np.int32),
        "node_miss": np.full(1, -1, np.int32),
        "tri_order": np.zeros(0, np.int32),
    }


def _split(idx, centroids):
    """Binned split along the largest centroid-extent axis.

    Returns (left_idx, right_idx); falls back to a median split when binning
    degenerates.  Never returns an empty side for len(idx) >= 2.
    """
    cmin = centroids[idx].min(axis=0)
    cmax = centroids[idx].max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    c = centroids[idx, axis]
    if ext[axis] > 1e-12:
        rel = (c - cmin[axis]) / ext[axis]
        bins = np.clip((rel * _N_BINS).astype(np.int32), 0, _N_BINS - 1)
        counts = np.bincount(bins, minlength=_N_BINS)
        # pick the bin boundary that best balances the two sides
        prefix = np.cumsum(counts)[:-1]
        total = len(idx)
        balance = np.abs(2 * prefix - total)
        b = int(np.argmin(balance)) + 1
        mask = bins < b
        if mask.any() and (~mask).any():
            return idx[mask], idx[~mask]
    order = np.argsort(c, kind="stable")
    half = max(1, len(idx) // 2)
    return idx[order[:half]], idx[order[half:]]


def build_bvh(positions: np.ndarray, indices: np.ndarray, leaf_size: int = 4):
    """Build a threaded BVH; returns dict of numpy arrays matching
    scene.types.BVHArrays fields."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int64)
    if len(indices) == 0:
        return _empty_bvh()

    native = build_sah_native(positions, indices, leaf_size)
    if native is not None:
        return native

    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroids = (tri_min + tri_max) * 0.5

    # Phase 1: build the topology iteratively.  Nodes are dicts; children are
    # built before the parent is finalized via an explicit work stack.
    # Each entry: (tri_idx, parent_slot) where parent_slot is (node, 'l'/'r').
    root = {"idx": np.arange(len(indices))}
    stack = [root]
    while stack:
        node = stack.pop()
        idx = node.pop("idx")
        node["bb_min"] = tri_min[idx].min(axis=0)
        node["bb_max"] = tri_max[idx].max(axis=0)
        if len(idx) <= leaf_size:
            node["tris"] = idx
            node["size"] = 1
            continue
        l_idx, r_idx = _split(idx, centroids)
        node["l"] = {"idx": l_idx}
        node["r"] = {"idx": r_idx}
        stack.append(node["l"])
        stack.append(node["r"])

    # Phase 2: subtree sizes (post-order, iterative).
    post = []
    stack = [root]
    while stack:
        node = stack.pop()
        post.append(node)
        if "l" in node:
            stack.append(node["l"])
            stack.append(node["r"])
    for node in reversed(post):
        if "l" in node:
            node["size"] = 1 + node["l"]["size"] + node["r"]["size"]

    # Phase 3: pre-order flatten with threaded hit/miss links.
    n = root["size"]
    node_min = np.zeros((n, 3), np.float32)
    node_max = np.zeros((n, 3), np.float32)
    node_left = np.zeros(n, np.int32)
    node_count = np.zeros(n, np.int32)
    node_hit = np.zeros(n, np.int32)
    node_miss = np.zeros(n, np.int32)
    tri_order: list[np.ndarray] = []
    tri_cursor = 0

    stack = [(root, -1)]
    cursor = 0
    while stack:
        node, miss = stack.pop()
        i = cursor
        cursor += 1
        node_min[i] = node["bb_min"]
        node_max[i] = node["bb_max"]
        node_miss[i] = miss
        if "tris" in node:
            node_left[i] = tri_cursor
            node_count[i] = len(node["tris"])
            node_hit[i] = miss  # after a leaf's tris, continue at miss link
            tri_order.append(node["tris"])
            tri_cursor += len(node["tris"])
        else:
            node_hit[i] = i + 1  # first child follows in pre-order
            right_index = i + 1 + node["l"]["size"]
            stack.append((node["r"], miss))
            stack.append((node["l"], right_index))

    return {
        "node_min": node_min,
        "node_max": node_max,
        "node_left": node_left,
        "node_count": node_count,
        "node_hit": node_hit,
        "node_miss": node_miss,
        "tri_order": np.concatenate(tri_order).astype(np.int32),
    }
