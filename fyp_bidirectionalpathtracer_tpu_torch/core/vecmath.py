"""Vector helpers for the camera, the wavefront passes and the plain frame
program.

Port of `fyp_bidirectionalpathtracer_tpu/core/vecmath.py` (the [..., 3]
forms of the camera and the wavefront) plus the per-component tuple forms
that `accel/pallas_frame.py` and `accel/pallas_subpath.py` use on [S, 128]
tiles; here a component is an [N] pixel tensor.
"""
from __future__ import annotations

import torch

M_PI = 3.14159265358979323846
M_1_PI = 0.318309886183790671538


# ------------------------------------------------------------ [..., 3] form
def vec3(x, y, z):
    """Stack three same-shaped fields into a [..., 3] vector."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def reflect(i, n):
    """HLSL reflect: i - 2 dot(i, n) n (i points toward the surface)."""
    return i - 2.0 * dot(i, n)[..., None] * n


def luminance(c):
    """Rec.709 luminance."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def get_perpendicular(u):
    """Branch-free perpendicular vector (MaterialUtils.hlsli:31-38)."""
    a = u.abs()
    xm = ((a[..., 0] - a[..., 1]) < 0) & ((a[..., 0] - a[..., 2]) < 0)
    ym = (~xm) & ((a[..., 1] - a[..., 2]) < 0)
    zm = ~(xm | ym)
    return cross(u, vec3(xm.to(u.dtype), ym.to(u.dtype), zm.to(u.dtype)))


def build_onb(n):
    """(tangent, bitangent): bitangent = normalize(perpendicular(n)),
    tangent = cross(bitangent, n) (MaterialUtils.hlsli:47-48)."""
    bitangent = normalize(get_perpendicular(n))
    return cross(bitangent, n), bitangent


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize(a, eps: float = 0.0):
    """a / sqrt(|a|^2 + eps); with eps=0 HLSL normalize (a zero vector
    gives nan/inf)."""
    return a / torch.sqrt(dot(a, a) + eps)[..., None]


def ws_vector_to_latlong(d):
    """World-space direction -> lat-long (u, v) in [0, 1]^2
    (wsVectorToLatLong, BDPTUtils.hlsli:80-88): u from atan2(x, -z), v
    from acos(y)."""
    p = normalize(d)
    u = (1.0 + torch.atan2(p[..., 0], -p[..., 2]) * M_1_PI) * 0.5
    v = torch.acos(torch.clamp(p[..., 1], -1.0, 1.0)) * M_1_PI
    return u, v


# ------------------------------------------------------- per-component form
def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def neg3(a):
    return (-a[0], -a[1], -a[2])


def where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def normalize3(x, y, z, eps: float = 1e-20):
    inv = torch.rsqrt(x * x + y * y + z * z + eps)
    return x * inv, y * inv, z * inv


def normalize3_rn(x, y, z, eps: float = 1e-20):
    """normalize3 with a correctly rounded 1/sqrt, as the CUDA kernels
    compute it (torch.rsqrt is approximate on a CUDA device; on the CPU it
    is the same 1/sqrt): for the plain versions that must repeat a kernel
    bit for bit."""
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + eps)
    return x * inv, y * inv, z * inv


def normed(a):
    return normalize3(a[0], a[1], a[2], eps=0.0)


def perpendicular3(ux, uy, uz):
    """Branch-free perpendicular (MaterialUtils.hlsli:31-38)."""
    ax, ay, az = ux.abs(), uy.abs(), uz.abs()
    xm = ((ax - ay) < 0) & ((ax - az) < 0)
    ym = (~xm) & ((ay - az) < 0)
    zm = ~(xm | ym)
    bx, by, bz = xm.to(ux.dtype), ym.to(ux.dtype), zm.to(ux.dtype)
    return uy * bz - uz * by, uz * bx - ux * bz, ux * by - uy * bx


def build_onb3(n):
    """(tangent, bitangent): bitangent = normalize(perpendicular(n)),
    tangent = cross(bitangent, n) (MaterialUtils.hlsli:47-48)."""
    b = normalize3(*perpendicular3(*n))
    t = (
        b[1] * n[2] - b[2] * n[1],
        b[2] * n[0] - b[0] * n[2],
        b[0] * n[1] - b[1] * n[0],
    )
    return t, b
