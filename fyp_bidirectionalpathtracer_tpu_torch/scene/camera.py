"""Camera construction and derivation (Falcor Camera semantics).

Port of `fyp_bidirectionalpathtracer_tpu/scene/camera.py`
(Camera::calculateCameraParameters, Camera.cpp:64-140).  All 4x4 math is
float32 on the host.  Matrices use the column-vector convention.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..core.vecmath import cross, normalize
from .types import CameraData


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _mm(a, b):
    """4x4 matmul in full float32.  On a CUDA tensor TF32 would keep ~10
    mantissa bits, the Hopper twin of the TPU's bf16 matmul default that
    the JAX `camera._mm` guards against, so it is switched off."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return a @ b


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def look_at(eye, target, up):
    """Right-handed view matrix (glm::lookAt)."""
    f = normalize(target - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    return torch.stack([
        torch.cat([s, -_dot(s, eye)[None]]),
        torch.cat([u, -_dot(u, eye)[None]]),
        torch.cat([-f, _dot(f, eye)[None]]),
        _f32([0.0, 0.0, 0.0, 1.0]),
    ])


def perspective(fov_y, aspect, near, far):
    """Right-handed zero-to-one depth projection (glm perspectiveRH_ZO)."""
    t = 1.0 / torch.tan(fov_y * 0.5)
    z = far / (near - far)
    zero = torch.zeros((), dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    return torch.stack([
        torch.stack([t / aspect, zero, zero, zero]),
        torch.stack([zero, t, zero, zero]),
        torch.stack([zero, zero, z, z * near]),
        torch.stack([zero, zero, -one, zero]),
    ])


def focal_length_to_fov_y(focal_length, frame_height):
    return 2.0 * torch.atan(0.5 * frame_height / focal_length)


def make_camera(pos, target, up=(0.0, 1.0, 0.0), focal_length: float = 21.0,
                frame_height: float = 24.0, aspect: float = 16.0 / 9.0,
                near_z: float = 0.1, far_z: float = 1000.0,
                focal_distance: float = 10000.0,
                aperture_radius: float = 0.0) -> CameraData:
    """A CameraData with derived fields filled in (prev == current)."""
    zero3 = torch.zeros(3, dtype=torch.float32)
    eye4 = torch.eye(4, dtype=torch.float32)
    cam = CameraData(
        pos_w=_f32(pos), target=_f32(target), up=_f32(up),
        focal_length=_f32(focal_length), frame_height=_f32(frame_height),
        aspect=_f32(aspect), near_z=_f32(near_z), far_z=_f32(far_z),
        focal_distance=_f32(focal_distance),
        aperture_radius=_f32(aperture_radius),
        jitter=torch.zeros(2, dtype=torch.float32),
        camera_u=zero3, camera_v=zero3, camera_w=zero3,
        view_proj=eye4, prev_view_proj=eye4, inv_view_proj=eye4,
    )
    cam = derive_camera(cam)
    return replace(cam, prev_view_proj=_unjittered_view_proj(cam))


def _unjittered_view_proj(cam: CameraData):
    fov_y = focal_length_to_fov_y(cam.focal_length, cam.frame_height)
    return _mm(perspective(fov_y, cam.aspect, cam.near_z, cam.far_z),
               look_at(cam.pos_w, cam.target, cam.up))


def derive_camera(cam: CameraData) -> CameraData:
    """Recompute U/V/W and the matrices from pose and intrinsics (does not
    roll prev_view_proj; begin_frame does)."""
    fov_y = focal_length_to_fov_y(cam.focal_length, cam.frame_height)
    w = normalize(cam.target - cam.pos_w) * cam.focal_distance
    u = normalize(cross(w, cam.up))
    v = normalize(cross(u, w))
    ulen = cam.focal_distance * torch.tan(fov_y * 0.5) * cam.aspect
    vlen = cam.focal_distance * torch.tan(fov_y * 0.5)
    vp_nj = _unjittered_view_proj(cam)
    # the jitter matrix adds 2*jitter to clip x/y (Camera.cpp:101-106)
    jitter_mat = torch.eye(4, dtype=torch.float32)
    jitter_mat[0, 3] = 2.0 * cam.jitter[0]
    jitter_mat[1, 3] = 2.0 * cam.jitter[1]
    vp = _mm(jitter_mat, vp_nj)
    return replace(cam, camera_u=u * ulen, camera_v=v * vlen, camera_w=w,
                   view_proj=vp, inv_view_proj=torch.linalg.inv(vp))


def begin_frame(cam: CameraData, jitter=None) -> CameraData:
    """Per-frame update: prev_view_proj <- unjittered current, optional new
    jitter, re-derive (Camera::beginFrame, Camera.cpp:55-62)."""
    prev = _unjittered_view_proj(cam)
    if jitter is not None:
        cam = replace(cam, jitter=_f32(jitter))
    cam = derive_camera(cam)
    return replace(cam, prev_view_proj=prev)


def camera_ray_dirs(cam: CameraData, width: int, height: int, pixel_jitter, device=None,
                    row0: int = 0, sub_height: int | None = None):
    """Primary ray directions [H, W, 3] on `device` (default: the camera's),
    Falcor ray-gen convention (lightProbeGBuffer.rt.hlsl:122-125):
    ndc = (2, -2) * (index + jitter) / dim + (-1, 1),
    dir = (ndc.x U + ndc.y V + W) / |W|, not normalized.  `row0` and
    `sub_height` give rows [row0, row0 + sub_height) of the full image (a
    row shard, `parallel/sharding.py`)."""
    dev = cam.camera_w.device if device is None else torch.device(device)
    jit = torch.as_tensor(pixel_jitter, dtype=torch.float32)
    sub_h = height if sub_height is None else sub_height
    xs = (torch.arange(width, dtype=torch.float32, device=jit.device) + jit[0]) / width
    ys = (torch.arange(sub_h, dtype=torch.float32, device=jit.device) + float(row0)
          + jit[1]) / height
    ndc_x = (2.0 * xs - 1.0).to(dev)
    ndc_y = (-2.0 * ys + 1.0).to(dev)
    u, v, w = (c.to(dev) for c in (cam.camera_u, cam.camera_v, cam.camera_w))
    d = (ndc_x[None, :, None] * u[None, None, :]
         + ndc_y[:, None, None] * v[None, None, :]
         + w[None, None, :])
    return d / torch.linalg.norm(cam.camera_w).to(dev)


def project_dir_to_pixel(cam: CameraData, d, dims, jitter):
    """World direction [..., 3] -> pixel ids (ix, iy) int32, unclamped, for
    the light-tracing splats (getLaunchIndexFromDirection,
    BDPTUtils.hlsli:129-138): project onto U/V/W, divide by the W
    component, round(pixelCenter * dim - jitter) half to even.  The
    camera's values stay scalar tensors, read by the device op where they
    are host tensors and never read on the host where they are the
    device's (a CUDA graph's inputs, `pipeline/graphs.py`): float32
    either way, the same bits."""
    def vdot(b):
        return d[..., 0] * b[0] + d[..., 1] * b[1] + d[..., 2] * b[2]

    def vdot3(v):
        return v[0] * v[0] + v[1] * v[1] + v[2] * v[2]

    d1 = vdot(cam.camera_u) / vdot3(cam.camera_u)
    d2 = vdot(cam.camera_v) / vdot3(cam.camera_v)
    d3 = vdot(cam.camera_w) / vdot3(cam.camera_w)
    jit = torch.as_tensor(jitter, dtype=torch.float32)
    px = ((d1 / d3) * 0.5 + 0.5) * float(dims[0]) - jit[0]
    py = ((-d2 / d3) * 0.5 + 0.5) * float(dims[1]) - jit[1]
    return torch.round(px).to(torch.int32), torch.round(py).to(torch.int32)
