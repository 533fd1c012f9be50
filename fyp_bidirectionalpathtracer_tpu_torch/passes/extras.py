"""Shading passes beyond the BDPT app's pipeline: rebuilds of the
reference's CommonPasses library (SURVEY.md §2.3).

Port of `fyp_bidirectionalpathtracer_tpu/passes/extras.py`: ambient
occlusion, Lambertian + shadows, one-bounce diffuse GI, the probe-lit
pass, the tone-mapping pass and copy-to-output.  Each consumes the shared
G-buffer channels on the bake's device.  `intersect` is the scene's
intersector (`baked.intersector()`): shadow and AO rays go to its any-hit
kernel, GI's bounce rays to its closest-hit kernel (the dense ones up to
2048 triangles, the BVH walks above), in the alpha restarts where the
scene has alpha-tested materials.  The per-light loops stop at the light
table's count: the lights past it add nothing in JAX, so here they trace
nothing.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.samplers import cos_hemisphere_sample
from ..core.vecmath import M_PI, dot, normalize, saturate
from ..ops import materials as mat
from ..ops import tonemap as tonemap_mod
from ..ops.lightprobe import eval_probe
from ..ops.shading import prepare_shading_data
from ..scene.lights import eval_light
from ..scene.types import on_device


def _ones(h: int, w: int, dev) -> torch.Tensor:
    return torch.ones((h, w, 1), dtype=torch.float32, device=dev)


def _direct_lambertian(baked, intersect, pos, n, min_t) -> torch.Tensor:
    """Sum over the table's lights of N.L x intensity where a shadow ray
    reaches the light: one any-hit batch a light (lambertianPlusShadows)."""
    h, w = pos.shape[0], pos.shape[1]
    direct = torch.zeros((h, w, 3), dtype=torch.float32, device=pos.device)
    for li in range(int(baked.data.lights.count)):
        idx = torch.full((h, w), li, dtype=torch.int32, device=pos.device)
        l, inten, dist, _ = eval_light(baked.light_rows, idx, pos)
        ndl = saturate(dot(n, l))
        vis = ~intersect(pos, l, min_t, t_max=dist, closest=False).hit
        direct = direct + torch.where(vis[..., None], ndl[..., None] * inten, 0.0)
    return direct


def ambient_occlusion_pass(baked, intersect, channels, frame_count, num_rays: int = 32,
                           ao_radius: float | None = None, min_t: float = 1e-4) -> torch.Tensor:
    """AmbientOcclusionPass (aoTracing.rt.hlsl): `num_rays` cosine rays a
    pixel within gAORadius (default: half the scene's bounding-box
    diagonal), each a batch of H x W any-hit rays with a scalar t_max;
    output [H, W, 4] = the visible fraction (1 where nothing was hit)."""
    pos4, norm4 = channels["WorldPosition"], channels["WorldNormal"]
    dev = pos4.device
    h, w = pos4.shape[0], pos4.shape[1]
    valid = pos4[..., 3] != 0.0
    if ao_radius is None:
        p = baked.data.geometry.positions
        lo, hi = p.min(dim=0).values, p.max(dim=0).values
        ao_radius = 0.5 * torch.sqrt(torch.sum((hi - lo) ** 2))
    ao_radius = float(ao_radius)
    seed = rng.pixel_seeds(w, h, frame_count, device=dev)
    vis_sum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for _ in range(num_rays):
        seed, d = cos_hemisphere_sample(seed, norm4[..., :3])
        hit = intersect(pos4[..., :3], d, min_t, t_max=ao_radius, closest=False)
        vis_sum = vis_sum + (~hit.hit).to(torch.float32)
    ao = vis_sum / num_rays
    out = torch.where(valid, ao, 1.0)
    return torch.stack([out, out, out, torch.ones_like(out)], -1)


def lambertian_shadows_pass(baked, intersect, channels, frame_count,
                            min_t: float = 1e-3) -> torch.Tensor:
    """LambertianPlusShadowPass (lambertianPlusShadows.rt.hlsl): one shadow
    ray a light, summed Lambertian shading [H, W, 4]; the albedo where the
    G-buffer holds no surface."""
    del frame_count  # the pass draws no random numbers
    pos4, norm4, dif4 = (channels[k] for k in ("WorldPosition", "WorldNormal",
                                               "MaterialDiffuse"))
    h, w = pos4.shape[0], pos4.shape[1]
    valid = pos4[..., 3] != 0.0
    shade = _direct_lambertian(baked, intersect, pos4[..., :3], norm4[..., :3], min_t)
    shade = shade * dif4[..., :3] / M_PI
    out = torch.where(valid[..., None], shade, dif4[..., :3])
    return torch.cat([out, _ones(h, w, pos4.device)], -1)


def diffuse_gi_pass(baked, intersect, channels, frame_count, min_t: float = 1e-3,
                    mat_model: int = mat.LAMBERTIAN) -> torch.Tensor:
    """SimpleDiffuseGIPass: direct NEE plus ONE cosine-sampled indirect
    bounce with NEE at the secondary hit (tutorial-12 style) [H, W, 4]: a
    shadow batch, a closest-hit batch of bounce rays decoded by
    `prepare_shading_data`, a second shadow batch.  `mat_model` is
    accepted as in JAX, which shades Lambertian whatever it says."""
    del mat_model
    pos4, norm4, dif4 = (channels[k] for k in ("WorldPosition", "WorldNormal",
                                               "MaterialDiffuse"))
    dev = pos4.device
    h, w = pos4.shape[0], pos4.shape[1]
    valid = pos4[..., 3] != 0.0
    pos, n, dif = pos4[..., :3], norm4[..., :3], dif4[..., :3]
    rows, count = baked.light_rows, int(baked.data.lights.count)
    seed = rng.pixel_seeds(w, h, frame_count, device=dev)

    def shadow_fn(o, d, tmin, tmax):
        return ~intersect(o, d, tmin, tmax, closest=False).hit

    seed, direct = mat.lambertian_direct(seed, shadow_fn, rows, count, min_t, pos, n, dif)

    # one indirect bounce
    seed, bounce_dir = cos_hemisphere_sample(seed, n)
    hit = intersect(pos, bounce_dir, min_t, closest=True)
    sd = prepare_shading_data(on_device(baked.tris, dev), on_device(baked.data.materials, dev),
                              baked.atlas, hit, pos, bounce_dir, pos)
    seed, bounce_direct = mat.lambertian_direct(seed, shadow_fn, rows, count, min_t, sd.pos_w,
                                                sd.n, sd.diffuse)
    # cosine-sampled: f cos / pdf = albedo, so indirect = albedo * L_direct(hit)
    indirect = torch.where(hit.hit[..., None], dif * bounce_direct, 0.0)
    out = torch.where(valid[..., None], direct + indirect, dif)
    return torch.cat([out, _ones(h, w, dev)], -1)


def probe_lit_pass(baked, intersect, channels, probe, min_t: float = 1e-3) -> torch.Tensor:
    """Probe-lit shading [H, W, 4]: analytic direct light (one shadow ray a
    light, Lambertian, lambertianPlusShadows.rt.hlsl) plus pre-integrated
    light-probe IBL (SceneRenderer.cpp:114-145 -> Shading.slang:330-340).
    `probe` is an `ops/lightprobe.LightProbe` of the scene's env map;
    roughness is decoded from the G-buffer as prepareShadingData does
    (sd.roughness = linear roughness^2, Shading.slang:236-237)."""
    pos4, norm4 = channels["WorldPosition"], channels["WorldNormal"]
    dif4, spec4 = channels["MaterialDiffuse"], channels["MaterialSpecRough"]
    h, w = pos4.shape[0], pos4.shape[1]
    valid = pos4[..., 3] != 0.0
    pos = pos4[..., :3]
    n = norm4[..., :3]
    v = normalize(baked.data.camera.pos_w.to(pos4.device) - pos)
    lin_rough = torch.clamp(spec4[..., 3], min=0.08)
    roughness = lin_rough * lin_rough

    direct = _direct_lambertian(baked, intersect, pos, n, min_t) * dif4[..., :3] / M_PI
    ambient = eval_probe(probe, n, v, dif4[..., :3], spec4[..., :3], roughness)
    out = torch.where(valid[..., None], direct + ambient, dif4[..., :3])
    return torch.cat([out, _ones(h, w, pos4.device)], -1)


def tone_mapping_pass(channels, src: str = "PipelineOutput",
                      operator: str = "clamp") -> torch.Tensor:
    """SimpleToneMappingPass wrapper over ops/tonemap (alpha kept)."""
    img = channels[src]
    rgb = tonemap_mod.tone_map(img[..., :3], tonemap_mod.OPERATOR_NAMES[operator])
    return torch.cat([rgb, img[..., 3:4]], -1)


def copy_to_output_pass(channels, src: str):
    """CopyToOutputPass: blit any channel to the output."""
    return channels[src]
