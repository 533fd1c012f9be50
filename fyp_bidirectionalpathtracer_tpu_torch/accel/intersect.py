"""Dense ray-triangle intersection: kernels K4 and their plain versions.

The wrappers of the JAX modules `accel/pallas_intersect.py`,
`accel/pallas_lane.py` and `accel/pallas_shaded.py`.  Three CUDA kernels
(`csrc/intersect.cu`) carry the two functions the five TPU kernels of the
dense tier compute in different memory layouts:

- `intersect_closest` -> HitRecord: closest hit (K4a `pallas_intersect.
  _kernel`), with or without backface culling;
- `occluded` -> bool: any hit in (t_min, t_max) without culling (K4b
  `pallas_intersect._occlusion_kernel`, K4d `pallas_lane._occlusion_kernel`);
- `intersect_shaded_fm` -> (HitRecord, fields [32, ...]): closest hit plus
  the winner's attributes, field-major (K4c `pallas_shaded._kernel`, K4e
  `pallas_lane._shaded_kernel`).

The adapters `intersect_pallas`, `occluded_pallas`, `occluded_lanes`,
`intersect_shaded` (row-major [..., 32]), `intersect_shaded_lanes` and
`intersect_shaded_lanes_fm` keep the JAX names and output layouts.

All read the bake's [T_pad, 48] pack (`accel/tri_pack.py`).  The field
table (`accel/pallas_shaded.py:27-30`): 0 t, 1 triangle id, 2 u, 3 v, 4:7
the interpolated normal (not normalized), 7:9 uv, 9:13 base colour rgba,
13:17 specular rgba, 17:20 emissive, 20 ior, 21 shading model, 22 double
sided, 23:26 texture slots, 26 material id, 27:32 zero.  On a miss: t =
tmax (the HitRecord says 1e30), id -1, every other field 0.

Each wrapper runs the kernel's plain version for CPU tensors and launches
the kernel for CUDA tensors.  The plain versions (`closest_plain`,
`occluded_plain`, `shaded_plain`) are chunked [rays x triangles] torch
programs of the Baldwin-Weber lane kernel (`pallas_lane.py:181-347`) with
the kernels' operation order, so the two agree bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import cuda

_BIG = 1e30  # the miss distance of a HitRecord
OUT_W = 32
PACK_COLS = 48
_PAIR_BUDGET = 1 << 24  # [rays x tris] elements per pair-test chunk
MAX_DENSE_TRIS = 2048


@dataclass(frozen=True)
class HitRecord:
    """Per-ray closest (or first) hit."""

    t: torch.Tensor        # [...] hit distance (1e30 = miss)
    tri: torch.Tensor      # [...] int32 triangle id in TriSoA order (-1 miss)
    bary_u: torch.Tensor   # [...]
    bary_v: torch.Tensor   # [...]

    @property
    def hit(self) -> torch.Tensor:
        return self.tri >= 0


def check_dense(n_tris: int) -> None:
    """Raise for a scene beyond the dense tier: the dense kernels stage every
    triangle in shared memory; larger scenes go to the BVH kernels
    (`accel/cluster.py`)."""
    if n_tris > MAX_DENSE_TRIS:
        raise ValueError(f"{n_tris} triangles: the dense kernels take at most "
                         f"{MAX_DENSE_TRIS}; accel/cluster.py's BVH kernels take more")


# ------------------------------------------------- the plain pair programs
def _pair_test(tris, o, d, tmin, tmax, cull_backface):
    """[N, T] Baldwin-Weber test (`pallas_lane._pair_test`, rays x tris);
    o, d are (x, y, z) component tensors [N]."""
    col = lambda k: tris[:, k][None, :]  # noqa: E731
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    nx, ny, nz, nv0 = col(0), col(1), col(2), col(3)
    ndir = nx * dx + ny * dy + nz * dz
    dir_ok = ndir < -1e-9 if cull_backface else ndir.abs() > 1e-9
    t = (nv0 - (nx * ox + ny * oy + nz * oz)) / torch.where(
        dir_ok, ndir, torch.ones_like(ndir))
    r1x, r1y, r1z, r1v0 = col(4), col(5), col(6), col(7)
    u = (r1x * ox + r1y * oy + r1z * oz - r1v0) + t * (r1x * dx + r1y * dy + r1z * dz)
    r2x, r2y, r2z, r2v0 = col(8), col(9), col(10), col(11)
    v = (r2x * ox + r2y * oy + r2z * oz - r2v0) + t * (r2x * dx + r2y * dy + r2z * dz)
    valid = (dir_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin[:, None]) & (t < tmax[:, None]))
    return valid, t


def _ray_chunks(n_rays, n_tris):
    step = max(1, _PAIR_BUDGET // max(n_tris, 1))
    return [slice(s, s + step) for s in range(0, n_rays, step)]


def closest_rows(tris, n_tris, o, d, tmin, tmax, cull_backface):
    """Closest hit in (tmin, tmax) over components [N]: (hit, t, id int64);
    the lowest t wins, at equal t the lowest id; t = tmax on a miss."""
    tri = tris[:n_tris]
    best_t = tmax.clone()
    best_id = torch.full(best_t.shape, -1, dtype=torch.int64, device=best_t.device)
    ids = torch.arange(n_tris, device=best_t.device)
    inf = torch.tensor(float("inf"), device=best_t.device)
    for sl in _ray_chunks(best_t.shape[0], n_tris):
        valid, t = _pair_test(tri, tuple(c[sl] for c in o), tuple(c[sl] for c in d),
                              tmin[sl], best_t[sl], cull_backface)
        t_m = torch.where(valid, t, inf)
        col_min = t_m.min(dim=1).values
        first = torch.where((t_m == col_min[:, None]) & valid, ids,
                            n_tris).min(dim=1).values
        hit = valid.any(dim=1)
        best_t[sl] = torch.where(hit, col_min, best_t[sl])
        best_id[sl] = torch.where(hit, first, best_id[sl])
    return best_id >= 0, best_t, best_id


def any_hit_rows(tris, n_tris, o, d, tmin, tmax):
    """Any hit in (tmin, tmax), no culling, over components [N] -> bool."""
    tri = tris[:n_tris]
    occ = torch.zeros(tmin.shape, dtype=torch.bool, device=tmin.device)
    for sl in _ray_chunks(tmin.shape[0], n_tris):
        valid, _ = _pair_test(tri, tuple(c[sl] for c in o), tuple(c[sl] for c in d),
                              tmin[sl], tmax[sl], False)
        occ[sl] = valid.any(dim=1)
    return occ


def winner_uv(a, o, d, t):
    """u, v of the winners' pack rows `a` [N, 48] at distance t."""
    u = (a[:, 4] * o[0] + a[:, 5] * o[1] + a[:, 6] * o[2] - a[:, 7]) + t * (
        a[:, 4] * d[0] + a[:, 5] * d[1] + a[:, 6] * d[2])
    v = (a[:, 8] * o[0] + a[:, 9] * o[1] + a[:, 10] * o[2] - a[:, 11]) + t * (
        a[:, 8] * d[0] + a[:, 9] * d[1] + a[:, 10] * d[2])
    return u, v


# ------------------------------------------------------------ ray rows
def rays(origin, direction, t_min, t_max):
    """The kernels' ray rows [8, N]: ox oy oz dx dy dz tmin tmax."""
    shape = tuple(origin.shape[:-1])
    n = 1
    for s in shape:
        n *= s
    dev = origin.device
    rows = torch.empty((8, n), dtype=torch.float32, device=dev)
    rows[0:3] = origin.reshape(n, 3).T
    rows[3:6] = direction.reshape(n, 3).T
    for k, val in ((6, t_min), (7, _BIG if t_max is None else t_max)):
        if isinstance(val, torch.Tensor):
            rows[k] = torch.broadcast_to(val.to(device=dev, dtype=torch.float32),
                                         shape).reshape(n)
        else:
            rows[k] = float(val)
    return rows, shape


def components(rows):
    return (rows[0], rows[1], rows[2]), (rows[3], rows[4], rows[5]), rows[6], rows[7]


def hit_record(t, tri, u, v, shape) -> HitRecord:
    tri = tri.to(torch.int32)
    return HitRecord(t=torch.where(tri < 0, _BIG, t).reshape(shape),
                     tri=tri.reshape(shape), bary_u=u.reshape(shape),
                     bary_v=v.reshape(shape))


def check_rays(tri_pack, n_tris, origin, direction, cols=PACK_COLS):
    """The checks of every intersector wrapper on its triangle rows (the
    [T_pad, 48] pack, or `cols` columns) and rays."""
    dev = origin.device
    cuda.check_tensor("tri_pack", tri_pack, torch.float32, dev)
    for name, x in (("origin", origin), ("direction", direction)):
        if x.dtype != torch.float32 or x.device != dev or x.shape[-1:] != (3,):
            raise ValueError(f"{name} must be float32 [..., 3] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if direction.shape != origin.shape:
        raise ValueError(f"origin {tuple(origin.shape)} and direction "
                         f"{tuple(direction.shape)} differ")
    if n_tris < 1 or tri_pack.dim() != 2 or tri_pack.shape[1] != cols \
            or tri_pack.shape[0] < n_tris:
        raise ValueError(f"tri_pack must be [T_pad >= {n_tris} >= 1, {cols}], "
                         f"got {tuple(tri_pack.shape)}")


# ------------------------------------------------------------ closest hit
def _check(tri_pack, n_tris, origin, direction):
    check_dense(n_tris)
    check_rays(tri_pack, n_tris, origin, direction)


def _closest_fields(tri_pack, n_tris, rows, cull_backface):
    o, d, tmin, tmax = components(rows)
    hit, t, tri = closest_rows(tri_pack, n_tris, o, d, tmin, tmax, cull_backface)
    a = tri_pack[tri.clamp(min=0)]
    u, v = winner_uv(a, o, d, t)
    zero = torch.zeros_like(t)
    return hit, t, tri, torch.where(hit, u, zero), torch.where(hit, v, zero), a


def closest_plain(tri_pack, n_tris, origin, direction, t_min, t_max=None,
                  cull_backface=False) -> HitRecord:
    """The closest kernel's plain version (any device)."""
    rows, shape = rays(origin, direction, t_min, t_max)
    _, t, tri, u, v, _ = _closest_fields(tri_pack, n_tris, rows, cull_backface)
    return hit_record(t, tri, u, v, shape)


def intersect_closest(tri_pack, n_tris, origin, direction, t_min, t_max=None,
                      cull_backface=False) -> HitRecord:
    """Closest hit of rays [..., 3] in (t_min, t_max) (t_max None: 1e30)."""
    _check(tri_pack, n_tris, origin, direction)
    if origin.device.type == "cpu":
        return closest_plain(tri_pack, n_tris, origin, direction, t_min, t_max,
                             cull_backface)
    rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = rows.shape[1], rows.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    cuda.check_launch("closest", cuda.library().bdpt_intersect_closest(
        cuda.ptr(rows), n, cuda.ptr(tri_pack), n_tris, int(bool(cull_backface)),
        cuda.ptr(t), cuda.ptr(tri), cuda.ptr(u), cuda.ptr(v), cuda.stream(dev)))
    return hit_record(t, tri, u, v, shape)


# ---------------------------------------------------------------- any hit
def occluded_plain(tri_pack, n_tris, origin, direction, t_min, t_max=None) -> torch.Tensor:
    """The any-hit kernel's plain version (any device)."""
    rows, shape = rays(origin, direction, t_min, t_max)
    o, d, tmin, tmax = components(rows)
    return any_hit_rows(tri_pack, n_tris, o, d, tmin, tmax).reshape(shape)


def occluded(tri_pack, n_tris, origin, direction, t_min, t_max=None) -> torch.Tensor:
    """Any hit of rays [..., 3] in (t_min, t_max), no culling -> bool [...]."""
    _check(tri_pack, n_tris, origin, direction)
    if origin.device.type == "cpu":
        return occluded_plain(tri_pack, n_tris, origin, direction, t_min, t_max)
    rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = rows.shape[1], rows.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    cuda.check_launch("occluded", cuda.library().bdpt_occluded(
        cuda.ptr(rows), n, cuda.ptr(tri_pack), n_tris, cuda.ptr(occ), cuda.stream(dev)))
    return occ.reshape(shape)


# ------------------------------------------------- closest hit + attributes
def shaded_hit(fields, shape):
    return hit_record(fields[0], fields[1], fields[2], fields[3], shape)


def shaded_plain(tri_pack, n_tris, origin, direction, t_min, t_max=None,
                 cull_backface=False):
    """The shaded kernel's plain version (any device): (HitRecord,
    fields_fm [32, ...])."""
    rows, shape = rays(origin, direction, t_min, t_max)
    hit, t, tri, u, v, a = _closest_fields(tri_pack, n_tris, rows, cull_backface)
    w = 1.0 - u - v
    mix = lambda k, s: w * a[:, k] + u * a[:, k + s] + v * a[:, k + 2 * s]  # noqa: E731
    zero = torch.zeros_like(t)
    attrs = [mix(12, 3), mix(13, 3), mix(14, 3), mix(21, 2), mix(22, 2)] + [
        a[:, k] for k in range(27, 45)]
    fields = torch.stack(
        [t, tri.to(torch.float32), u, v] + [torch.where(hit, x, zero) for x in attrs]
        + [zero] * (OUT_W - 4 - len(attrs)))
    return shaded_hit(fields, shape), fields.reshape((OUT_W,) + shape)


def intersect_shaded_fm(tri_pack, n_tris, origin, direction, t_min, t_max=None,
                        cull_backface=False):
    """Closest hit plus the winner's attributes: (HitRecord, fields_fm
    [32, ...]), field-major as the JAX `intersect_shaded_lanes_fm`."""
    _check(tri_pack, n_tris, origin, direction)
    if origin.device.type == "cpu":
        return shaded_plain(tri_pack, n_tris, origin, direction, t_min, t_max,
                            cull_backface)
    rows, shape = rays(origin, direction, t_min, t_max)
    n, dev = rows.shape[1], rows.device
    fields = torch.empty((OUT_W, n), dtype=torch.float32, device=dev)
    cuda.check_launch("shaded", cuda.library().bdpt_intersect_shaded(
        cuda.ptr(rows), n, cuda.ptr(tri_pack), n_tris, int(bool(cull_backface)),
        cuda.ptr(fields), cuda.stream(dev)))
    return shaded_hit(fields, shape), fields.reshape((OUT_W,) + shape)


# ------------------------------------------ adapters with the JAX names
def intersect_pallas(tri_pack, n_tris, origin, direction, t_min, t_max=None,
                     closest=True, cull_backface=False) -> HitRecord:
    """K4a's entry point: the dense search always yields the closest hit."""
    del closest
    return intersect_closest(tri_pack, n_tris, origin, direction, t_min, t_max,
                             cull_backface)


def intersect_shaded(tri_pack, n_tris, origin, direction, t_min, t_max=None,
                     cull_backface=False):
    """K4c's and K4e's row-major entry point: (HitRecord, fields [..., 32])."""
    hit, fields_fm = intersect_shaded_fm(tri_pack, n_tris, origin, direction, t_min,
                                         t_max, cull_backface)
    return hit, fields_fm.movedim(0, -1)


occluded_pallas = occluded          # K4b
occluded_lanes = occluded           # K4d
intersect_shaded_lanes = intersect_shaded      # K4e, row-major
intersect_shaded_lanes_fm = intersect_shaded_fm  # K4e, field-major
