"""Ray stream sorting (Morton binning) for incoherent wavefronts.

Port of `fyp_bidirectionalpathtracer_tpu/ops/raysort.py`: `_spread4`,
`ray_sort_keys`, `ray_sort_keys_dirq`, `make_permutation` and
`scene_bounds`, bit for bit, plus `sort_order`, the key step of JAX's
cluster-tier `sort_wavefront` (`accel/traverse.py:349-411`).  Plain torch:
no TPU kernel stands behind any of them.

The port's BVH kernels (`accel/cluster.py`) take the permutation as their
`order`: slot j of a kernel's ray counter walks ray order[j] and answers
it in place, so a sorted launch reorders the work and not the data, and
its answers equal the unsorted launch's bit for bit.  The keys follow
JAX's int32 arithmetic, with its saturating float -> int32 conversion
(NaN to 0), which a plain torch cast does not give.
"""
from __future__ import annotations

import torch

DEAD_KEY = 0x7FFFFFFF  # an empty-interval lane sorts to the tail


def _spread4(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 4 bits of x to every 3rd bit (Morton interleave)."""
    x = x & 0xF
    x = (x | (x << 6)) & 0x0C3   # 0b000011000011
    x = (x | (x << 3)) & 0x249   # 0b001001001001
    return x


def _cell(x: torch.Tensor, top: int) -> torch.Tensor:
    """clip(int32(x), 0, top) with XLA's saturating conversion: NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0, posinf=float(top), neginf=0.0)
    return torch.clamp(x, 0.0, float(top)).to(torch.int32)


def _span(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.clamp(hi - lo, min=1e-6)


def ray_sort_keys(origin, direction, lo, hi, octant_major: bool = False) -> torch.Tensor:
    """15-bit coherence key a ray: the 12-bit Morton code of its origin
    quantized to 4 bits an axis within [lo, hi], and its 3-bit direction
    octant, in the high bits when `octant_major`."""
    q = _cell((origin - lo) / _span(lo, hi) * 16.0, 15)
    morton = _spread4(q[..., 0]) | (_spread4(q[..., 1]) << 1) | (_spread4(q[..., 2]) << 2)
    pos = (direction >= 0).to(torch.int32)
    octant = pos[..., 0] | (pos[..., 1] << 1) | (pos[..., 2] << 2)
    if octant_major:
        return (octant << 12) | morton
    return (morton << 3) | octant


def ray_sort_keys_dirq(origin, direction, lo, hi) -> torch.Tensor:
    """Direction-major key: 2 bits an axis of the direction in the high
    bits, the 9-bit Morton code of the origin (3 bits an axis) below."""
    q = _cell((origin - lo) / _span(lo, hi) * 8.0, 7)
    morton9 = _spread4(q[..., 0]) | (_spread4(q[..., 1]) << 1) | (_spread4(q[..., 2]) << 2)
    qd = _cell((direction + 1.0) * 2.0, 3)
    dir6 = (qd[..., 0] << 4) | (qd[..., 1] << 2) | qd[..., 2]
    return (dir6 << 9) | morton9


def make_permutation(keys_flat: torch.Tensor):
    """(perm, inv_perm) sorting rays by key, ties in ray order; both [N]
    int32 (the order of `lax.sort` over [keys, iota])."""
    n = keys_flat.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=keys_flat.device)
    perm = torch.sort(keys_flat, stable=True).indices.to(torch.int32)
    inv = torch.zeros(n, dtype=torch.int32, device=keys_flat.device)
    inv[perm.long()] = iota
    return perm, inv


def scene_bounds(tris):
    """(lo, hi) [3] of the triangle soup (a TriSoA: v0, v0 + e1, v0 + e2)."""
    v0, v1, v2 = tris.v0, tris.v0 + tris.e1, tris.v0 + tris.e2
    lo = torch.minimum(torch.minimum(v0.min(0).values, v1.min(0).values), v2.min(0).values)
    hi = torch.maximum(torch.maximum(v0.max(0).values, v1.max(0).values), v2.max(0).values)
    return lo, hi


def sort_order(origin, direction, t_min, t_max, bounds) -> torch.Tensor:
    """The direction-major order of a wavefront of rays [..., 3]: int32
    [N], the rays sorted by `ray_sort_keys_dirq` over `bounds` ([2, 3]:
    lo, hi), ties in ray order.  A lane with t_max <= t_min gets the key
    0x7FFFFFFF and sorts to the tail when t_max is a tensor of rays, as in
    JAX (a scalar or absent t_max marks no lane)."""
    shape = origin.shape[:-1]
    keys = ray_sort_keys_dirq(origin.reshape(-1, 3), direction.reshape(-1, 3),
                              bounds[0], bounds[1])
    if isinstance(t_max, torch.Tensor) and t_max.dim() != 0:
        dev = origin.device
        tmax = torch.broadcast_to(t_max.to(dev, torch.float32), shape).reshape(-1)
        tmin = (torch.broadcast_to(t_min.to(dev, torch.float32), shape).reshape(-1)
                if isinstance(t_min, torch.Tensor)
                else torch.full(shape, float(t_min), dtype=torch.float32, device=dev).reshape(-1))
        keys = torch.where(tmax <= tmin, DEAD_KEY, keys)
    return make_permutation(keys)[0]
