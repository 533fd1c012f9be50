"""Shading passes beyond the BDPT app's pipeline.

Port of `fyp_bidirectionalpathtracer_tpu/passes/extras.py` for
`probe_lit_pass` (`:111`); the other passes of that module (ambient
occlusion, Lambertian with shadows, diffuse GI, the tone-map pass and
copy) are ROADMAP Queue 1 item 12a.
"""
from __future__ import annotations

import torch

from ..core.vecmath import M_PI, dot, normalize, saturate
from ..ops.lightprobe import eval_probe
from ..scene.lights import eval_light


def probe_lit_pass(baked, intersect, channels, probe, min_t: float = 1e-3) -> torch.Tensor:
    """Probe-lit shading [H, W, 4]: analytic direct light (one shadow ray a
    light, Lambertian, lambertianPlusShadows.rt.hlsl) plus pre-integrated
    light-probe IBL (SceneRenderer.cpp:114-145 -> Shading.slang:330-340).
    `probe` is an `ops/lightprobe.LightProbe` of the scene's env map;
    `intersect` the scene's intersector (its any-hit kernel, or the alpha
    restarts); roughness is decoded from the G-buffer as prepareShadingData
    does (sd.roughness = linear roughness^2, Shading.slang:236-237).  The
    lights past the table's count add nothing and trace nothing."""
    pos4, norm4 = channels["WorldPosition"], channels["WorldNormal"]
    dif4, spec4 = channels["MaterialDiffuse"], channels["MaterialSpecRough"]
    dev = pos4.device
    h, w = pos4.shape[0], pos4.shape[1]
    valid = pos4[..., 3] != 0.0
    pos = pos4[..., :3]
    n = norm4[..., :3]
    v = normalize(baked.data.camera.pos_w.to(dev) - pos)
    lin_rough = torch.clamp(spec4[..., 3], min=0.08)
    roughness = lin_rough * lin_rough

    direct = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    for li in range(int(baked.data.lights.count)):
        idx = torch.full((h, w), li, dtype=torch.int32, device=dev)
        l, inten, dist, _ = eval_light(baked.light_rows, idx, pos)
        ndl = saturate(dot(n, l))
        vis = ~intersect(pos, l, min_t, t_max=dist, closest=False).hit
        direct = direct + torch.where(vis[..., None], ndl[..., None] * inten, 0.0)
    direct = direct * dif4[..., :3] / M_PI

    ambient = eval_probe(probe, n, v, dif4[..., :3], spec4[..., :3], roughness)
    out = torch.where(valid[..., None], direct + ambient, dif4[..., :3])
    return torch.cat([out, torch.ones((h, w, 1), dtype=torch.float32, device=dev)], -1)
