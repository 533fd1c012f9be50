"""Ray-traced G-buffer pass (the LightProbeGBufferPass rebuild) and the
per-frame camera jitter.

Port of `fyp_bidirectionalpathtracer_tpu/passes/gbuffer.py`:
`pixel_jitter_for_frame` (`:25-39`) and `ray_traced_gbuffer` (`:42-140`)
for the wavefront path; the megakernel path writes the same rows from the
frame program (`accel/frame.py`).  Channels (lightProbeGBuffer.rt.hlsl:
93-110): WorldPosition (pos, valid), WorldNormal (N, distance to the
camera), MaterialDiffuse (diffuse, opacity; a miss gives (env, 1)),
MaterialSpecRough (specular, linear roughness), MaterialExtraParams (IoR,
0, 0, 0), Emissive (emissive, 0).  Primary rays cull backfaces
(lightProbeGBuffer.rt.hlsl:152); a normal-mapped scene perturbs the
primary hits' normals (Shading.slang:135-157).
"""
from __future__ import annotations

import torch

from ..core import rng, samplers
from ..core.vecmath import normalize
from ..ops.envmap import eval_env_bilinear, eval_env_nearest
from ..ops.shading import apply_normal_mapping
from ..scene.camera import camera_ray_dirs


def pixel_jitter_for_frame(frame_count, mode: str = "msaa8") -> torch.Tensor:
    """Subpixel jitter in [0,1]^2 pixel units (float32 [2]).  msaa8 is
    kMSAA[frame % 8] / 16 + 0.5 (LightProbeGBufferPass.cpp:131-140)."""
    if mode == "none":
        return torch.tensor([0.5, 0.5], dtype=torch.float32)
    if mode == "msaa8":
        return samplers.msaa8_jitter(frame_count) + 0.5
    if mode == "random":
        seed = rng.tea_init(int(frame_count) & 0xFFFFFFFF, 0xDEAD)
        seed, u0, u1 = rng.next_rand2(seed)
        return torch.stack([u0, u1])
    raise ValueError(mode)


def ray_traced_gbuffer(baked, trace, width: int, height: int, frame_count, pixel_jitter,
                       use_thin_lens: bool = False, lens_radius=0.0, focal_len=1.0,
                       row0: int = 0, sub_height: int | None = None,
                       env_bilinear: bool = False) -> dict:
    """The channel dict [H, W, 4] on the scene's device; `trace` from
    `ops.shading.make_shaded_tracer`.  `row0` / `sub_height` render rows
    [row0, row0 + sub_height) of the width x height image with global
    pixel ids (the jittered NDC and the lens seeds): a row shard of
    `parallel/sharding.py`, whose channels are [sub_height, W, 4]."""
    cam = baked.data.camera
    dev = baked.device
    d_raw = camera_ray_dirs(cam, width, height, pixel_jitter, device=dev, row0=row0,
                            sub_height=sub_height)
    cam_pos = cam.pos_w.to(dev)
    if use_thin_lens:
        seeds = rng.pixel_seeds(width, height, frame_count, row0=row0, sub_height=sub_height,
                                device=dev)
        focal_pt = cam_pos + focal_len * d_raw
        seeds, lx, ly = samplers.lens_sample(seeds, lens_radius)
        origin = (cam_pos + lx[..., None] * normalize(cam.camera_u).to(dev)
                  + ly[..., None] * normalize(cam.camera_v).to(dev))
        direction = normalize(focal_pt - origin)
    else:
        origin = cam_pos.expand(d_raw.shape)
        direction = normalize(d_raw)

    hit, sd = trace(origin, direction, 0.0, cam_pos.expand(d_raw.shape),
                    cull_backface=True)
    if baked.has_normal_maps:
        # primary hits get prepareShadingData's normal map; bounces keep
        # the simple path
        sd = apply_normal_mapping(baked, hit, sd)
    valid = hit.hit
    vmask = valid[..., None]
    dist = torch.sqrt(torch.sum((sd.pos_w - cam_pos) ** 2, -1))
    env = (eval_env_bilinear if env_bilinear else eval_env_nearest)(
        baked.env_map, direction)

    zero = torch.zeros_like(dist)
    one = torch.ones_like(dist)
    z3 = torch.zeros_like(sd.pos_w)
    cat = lambda *xs: torch.cat(xs, -1)  # noqa: E731
    return {
        "WorldPosition": cat(torch.where(vmask, sd.pos_w, z3), valid[..., None].to(torch.float32)),
        "WorldNormal": cat(torch.where(vmask, sd.n, z3), torch.where(valid, dist, zero)[..., None]),
        "MaterialDiffuse": cat(torch.where(vmask, sd.diffuse, env),
                               torch.where(valid, sd.opacity, one)[..., None]),
        "MaterialSpecRough": cat(torch.where(vmask, sd.specular, z3),
                                 torch.where(valid, sd.linear_roughness, zero)[..., None]),
        "MaterialExtraParams": cat(torch.where(valid, sd.ior, zero)[..., None], z3),
        "Emissive": cat(torch.where(vmask, sd.emissive, z3), zero[..., None]),
    }
