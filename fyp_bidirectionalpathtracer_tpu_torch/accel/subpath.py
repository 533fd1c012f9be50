"""Fused subpath construction: kernel K6 and its plain PyTorch version.

Port of `fyp_bidirectionalpathtracer_tpu/accel/pallas_subpath.py`:
`build_subpath` (`:399`) and the per-ray program of `subpath_kernel`
(`:191`): n_bounces of closest hit, the winner's decode, sampleBRDF and
the vertex record, for a wavefront of rays, in one launch.

K6 replaces the TPU kernel `accel/pallas_subpath.py:subpath_kernel`; its
CUDA source is `csrc/subpath.cu` (one thread a ray; see the note there).
`subpath_plain` is the same program over [N] ray tensors, a literal
transcription of the JAX kernel with its own semantics, which are not the
wavefront tracer's: the ray-triangle test has no back-face cull, accepts
|n.d| > 1e-9 and t > min_t strictly below the running best (the lowest id
wins a tie), t is (n.v0 - n.o) times 1/(n.d); the view vector is -d; the
seed advances only on an active hit (never under `faithful_rng`); a miss
zeroes the colour and keeps the stale vertex; the vertex rows of a lane
that was already inactive are zeroed, and its `take` is 1.  The kernel is
compiled without FMA contraction, so on the card it repeats the plain
version's operations one for one.

Layouts (field-major, N rays): state [12, N] float32 = origin 3, direction
3, colour 3, terminated, seed bits (uint32 bits as float32), min_t;
vertex rows [24 * n_bounces, N] = per bounce colour 3, pos 3, n 3, v 3,
dif 3, spec 3, rough, is_spec, pdf, hit, take, pad.
"""
from __future__ import annotations

import torch

from .. import cuda
from .frame import MAX_TRIS, sample_brdf
from ..core.vecmath import normalize3_rn

VERT_ROWS = 24
STATE_ROWS = 12
_MASK = 0xFFFFFFFF
# the winner's pack columns the program reads: BW rows 4:12, vertex
# normals 12:21, base and specular 27:35, shading model 39, double sided 40
_FETCH = tuple(range(4, 21)) + tuple(range(27, 35)) + (39, 40)


def _seed_bits(seed: torch.Tensor) -> torch.Tensor:
    """An int64 seed in [0, 2^32) -> its uint32 bits as float32."""
    s = seed.to(torch.int64) & _MASK
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32).view(torch.float32)


def _seed_of(bits: torch.Tensor) -> torch.Tensor:
    return bits.contiguous().view(torch.int32).to(torch.int64) & _MASK


def subpath_plain(state: torch.Tensor, tris: torch.Tensor, n_tris: int, n_bounces: int,
                  mat_model: int, faithful_rng: bool):
    """Plain K6: (verts [24 n_bounces, N], final state [12, N])."""
    ox, oy, oz, dx, dy, dz, cr, cg, cb = state[:9]
    term = state[9] > 0.5
    seed = _seed_of(state[10])
    min_t = state[11]
    zero = torch.zeros_like(ox)
    p_pos, p_n, p_v = [ox, oy, oz], [zero] * 3, [zero] * 3
    p_dif, p_spec = [zero] * 3, [zero] * 3
    p_rough = p_isspec = p_pdf = zero
    bw = tris[:n_tris, :12].cpu().tolist()  # float32 values, exact as floats
    rows = []
    for _ in range(n_bounces):
        active = ~term
        best_t = torch.full_like(ox, 1e30)
        best_id = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
        for t_i, (nx, ny, nz, nv0, r1x, r1y, r1z, r1w, r2x, r2y, r2z, r2w) in enumerate(bw):
            ndir = nx * dx + ny * dy + nz * dz
            dir_ok = ndir.abs() > 1e-9
            inv_nd = 1.0 / torch.where(dir_ok, ndir, 1.0)
            tt = (nv0 - (nx * ox + ny * oy + nz * oz)) * inv_nd
            u = (r1x * ox + r1y * oy + r1z * oz - r1w) + tt * (r1x * dx + r1y * dy + r1z * dz)
            v_ = (r2x * ox + r2y * oy + r2z * oz - r2w) + tt * (r2x * dx + r2y * dy + r2z * dz)
            ok = (dir_ok & (u >= 0.0) & (v_ >= 0.0) & (u + v_ <= 1.0)
                  & (tt > min_t) & (tt < best_t))
            best_t = torch.where(ok, tt, best_t)
            best_id = torch.where(ok, t_i, best_id)
        hit = best_id >= 0
        fetched = torch.where(hit[:, None], tris[best_id.clamp(min=0)], 0.0)
        a = {k: fetched[:, k] for k in _FETCH}
        u = (a[4] * ox + a[5] * oy + a[6] * oz - a[7]) + best_t * (a[4] * dx + a[5] * dy
                                                                    + a[6] * dz)
        v_ = (a[8] * ox + a[9] * oy + a[10] * oz - a[11]) + best_t * (a[8] * dx + a[9] * dy
                                                                       + a[10] * dz)
        w = 1.0 - u - v_
        px, py, pz = ox + best_t * dx, oy + best_t * dy, oz + best_t * dz
        n = normalize3_rn(w * a[12] + u * a[15] + v_ * a[18],
                          w * a[13] + u * a[16] + v_ * a[19],
                          w * a[14] + u * a[17] + v_ * a[20])
        vx, vy, vz = -dx, -dy, -dz  # normalize(rayOrigin - hit) for a unit direction
        b, s = (a[27], a[28], a[29]), (a[31], a[32], a[33], a[34])
        metal_rough = a[39] == 0.0  # SHADING_METAL_ROUGH
        metal = s[2]
        dif = tuple(torch.where(metal_rough, c * (1.0 - metal), c) for c in b)
        spc = tuple(torch.where(metal_rough, 0.04 * (1.0 - metal) + c * metal, sc)
                    for c, sc in zip(b, s))
        lr = torch.clamp(torch.where(metal_rough, s[1], 1.0 - s[3]), min=0.08)
        rough = lr * lr
        flip = (n[0] * vx + n[1] * vy + n[2] * vz <= 0) & (a[40] > 0.5)
        n = tuple(torch.where(flip, -c, c) for c in n)
        seed_b, wgt, l_, pdf, is_spec, _ = sample_brdf(seed, n, (vx, vy, vz), dif, spc, rough,
                                                       mat_model)
        got = active & hit
        missed = active & ~hit
        if not faithful_rng:
            seed = torch.where(got, seed_b, seed)
        cr, cg, cb = (torch.where(got, c * wc, torch.where(missed, 0.0, c))
                      for c, wc in zip((cr, cg, cb), wgt))

        def sel3(new, old):
            return [torch.where(got, x, y) for x, y in zip(new, old)]

        p_pos = sel3((px, py, pz), p_pos)
        p_n = sel3(n, p_n)
        p_v = sel3((vx, vy, vz), p_v)
        p_dif, p_spec = sel3(dif, p_dif), sel3(spc, p_spec)
        p_rough = torch.where(got, rough, p_rough)
        p_isspec = torch.where(got, is_spec.to(torch.float32), p_isspec)
        p_pdf = torch.where(got, pdf, p_pdf)
        ox, oy, oz = sel3((px, py, pz), (ox, oy, oz))
        dx, dy, dz = sel3(l_, (dx, dy, dz))
        term = term | missed
        # the vertex record (cameraPath[depth+1] = create(payload)); zeros
        # where the lane was already terminated before this bounce
        af = active.to(torch.float32)
        fields = [cr, cg, cb, *p_pos, *p_n, *p_v, *p_dif, *p_spec, p_rough, p_isspec, p_pdf,
                  got.to(torch.float32)]
        rows += [f * af for f in fields]
        rows += [torch.where(active, (~term).to(torch.float32), 1.0), zero]
    final = torch.stack([ox, oy, oz, dx, dy, dz, cr, cg, cb, term.to(torch.float32),
                         _seed_bits(seed), min_t])
    return torch.stack(rows), final


def subpath_kernel(state: torch.Tensor, tris: torch.Tensor, n_tris: int, n_bounces: int,
                   mat_model: int, faithful_rng: bool):
    """K6 wrapper: subpath_plain for CPU tensors, the CUDA kernel otherwise."""
    cuda.check_tensor("state", state, torch.float32, state.device)
    cuda.check_tensor("tris", tris, torch.float32, state.device)
    if state.dim() != 2 or state.shape[0] != STATE_ROWS:
        raise ValueError(f"state must be [{STATE_ROWS}, N], got {tuple(state.shape)}")
    if tris.dim() != 2 or tris.shape[1] != 48 or tris.shape[0] < n_tris:
        raise ValueError(f"tris must be [T_pad >= {n_tris}, 48], got {tuple(tris.shape)}")
    if not 1 <= n_tris <= MAX_TRIS:
        raise ValueError(f"n_tris {n_tris} outside [1, {MAX_TRIS}]: the kernel holds the "
                         f"scene in shared memory")
    if n_bounces < 1:
        raise ValueError(f"n_bounces {n_bounces} < 1")
    if state.device.type == "cpu":
        return subpath_plain(state, tris, n_tris, n_bounces, mat_model, faithful_rng)
    n = state.shape[1]
    verts = torch.empty((VERT_ROWS * n_bounces, n), dtype=torch.float32, device=state.device)
    final = torch.empty_like(state)
    cuda.check_launch("subpath", cuda.library().bdpt_subpath(
        cuda.ptr(state), n, cuda.ptr(tris), n_tris, n_bounces, int(mat_model),
        int(bool(faithful_rng)), cuda.ptr(verts), cuda.ptr(final), cuda.stream(state.device)))
    return verts, final


def build_subpath(tri_pack, n_tris: int, origin, direction, color, seed, terminated, min_t,
                  n_bounces: int, mat_model: int, faithful_rng: bool, *, plain: bool = False):
    """Run K6 over a ray wavefront (JAX `build_subpath`).  tri_pack is the
    port's [T_pad, 48] pack (`accel/tri_pack.pack_shaded_tris_lane`, the
    transpose of JAX's `pack_shaded_triangles`); origin, direction, color
    [..., 3], seed [...] (int64 in [0, 2^32)), terminated [...] bool.
    Returns (verts, final): n_bounces dicts of [...]-shaped fields (color,
    pos, n, v, dif, spec [..., 3], rough, is_spec, pdf, hit, take) and
    dict(origin, direction, color, seed, terminated).  `plain=True` runs
    the plain version on any device."""
    shape = origin.shape[:-1]
    dev = tri_pack.device

    def field(x):
        return x.to(device=dev, dtype=torch.float32).reshape(-1, x.shape[-1]).T

    n = origin[..., 0].numel()
    state = torch.cat([
        field(origin), field(direction), field(color),
        terminated.to(device=dev, dtype=torch.float32).reshape(1, n),
        _seed_bits(seed.to(dev)).reshape(1, n),
        torch.full((1, n), float(min_t), dtype=torch.float32, device=dev),
    ]).contiguous()
    run = subpath_plain if plain else subpath_kernel
    verts_arr, final_arr = run(state, tri_pack, n_tris, n_bounces, mat_model, faithful_rng)

    def rows(arr, r, width=1):
        x = arr[r:r + width].T
        return x.reshape(shape) if width == 1 else x.reshape(shape + (width,))

    verts = []
    for bnc in range(n_bounces):
        b = bnc * VERT_ROWS
        verts.append({
            "color": rows(verts_arr, b, 3), "pos": rows(verts_arr, b + 3, 3),
            "n": rows(verts_arr, b + 6, 3), "v": rows(verts_arr, b + 9, 3),
            "dif": rows(verts_arr, b + 12, 3), "spec": rows(verts_arr, b + 15, 3),
            "rough": rows(verts_arr, b + 18), "is_spec": rows(verts_arr, b + 19) > 0.5,
            "pdf": rows(verts_arr, b + 20), "hit": rows(verts_arr, b + 21) > 0.5,
            "take": rows(verts_arr, b + 22) > 0.5,
        })
    final = {
        "origin": rows(final_arr, 0, 3), "direction": rows(final_arr, 3, 3),
        "color": rows(final_arr, 6, 3), "terminated": rows(final_arr, 9) > 0.5,
        "seed": _seed_of(final_arr[10]).reshape(shape),
    }
    return verts, final
