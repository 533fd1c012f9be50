"""Bidirectional path tracer pass: the per-bounce wavefront.

Port of `fyp_bidirectionalpathtracer_tpu/passes/bdpt.py`, the wavefront
rebuild of the reference's DXR raygen program (BDPTMain.rt.hlsl:42-234):
one whole-image wavefront a step instead of a thread a pixel.

1. camera subpath: vertex 0 the pinhole, vertex 1 from the G-buffer,
   vertices 2..maxDepth by extension traces of every lane, masked by each
   lane's termination;
2. light subpath: one light sample a pixel, extended the same way;
3. estimator 1, path tracing with NEE at every camera vertex;
4. estimator 2, light tracing: every light vertex connected to the camera,
   splatted onto the computed pixel by a deterministic scatter-add
   (`ops/splat.scatter_add_rgba`; on a CUDA device K2 + sort + K3);
5. estimator 3, every (s, t) connection with a visibility ray, saturated
   in the reference's order.

Every closest-hit trace goes through `trace` (the shaded kernel), every
shadow batch through `intersect` (the any-hit kernel).  The reference's
quirks are kept under the config flags (utils/config.BDPTConfig), and so
are JAX's frame options:

- `sort_bounces` / `sort_shadows`: the subpath extensions, and the est-1
  and est-2 shadow batches, are traced as incoherent batches (est-3's
  always are), which the BVH tier walks in direction-sorted order; the
  image does not change;
- `reverse_shadows`: the est-1 batch is traced from the light point
  towards the vertex and the est-2 batch from the camera, over the same
  open segments; an any-hit answer may change at grazing hits, as in JAX;
- `merge_shadow_batches` (with `reverse_shadows` off): one any-hit query
  over est-1, est-3 and est-2; the image does not change;
- `splat_segments`: the estimator-2 splat sorts each depth's updates on
  its own (`ops/splat_tile.py` `segments`); the image does not change;
- `debug_stub_shadows` / `debug_stub_extensions`: timing stubs that break
  the image on purpose, as JAX's do: every visibility query answers
  "visible", or the extension traces are skipped and each subpath keeps
  its payload.

`bdpt_pass` is `bdpt_splat` of `bdpt_estimates`: everything up to the
estimator-2 splat, whose shapes the frame's size fixes (what
`pipeline/graphs.py` captures as CUDA graphs), then the splat, whose sort
runs over the live updates that a host read counts.

Spans (`utils/profiler`): `subpaths` (steps 1 and 2: both subpaths and
their extension traces) and `shadows` (the shadow batches of estimators
1-3, built and traced through `shadow_fn`); each query inside is a
`trace` span of the tracer or the intersector.  The estimator-2 splat
keeps its own `splat` span.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from ..core import rng
from ..core.samplers import cos_hemisphere_sample, unit_sphere_sample
from ..core.vecmath import dot, normalize, saturate
from ..ops import materials as mat
from ..ops import splat as splat_mod
from ..ops.lookup import table_lookup
from ..ops.shading import make_shaded_tracer
from ..scene.camera import project_dir_to_pixel
from ..scene.types import LIGHT_DIRECTIONAL
from ..utils.config import BDPTConfig
from ..utils.profiler import span


def _fmap(fn, *objs):
    """The dataclass of fn applied to the same-named fields of `objs`."""
    return type(objs[0])(**{f.name: fn(*(getattr(o, f.name) for o in objs))
                            for f in fields(objs[0])})


@dataclass(frozen=True)
class PathVertex:
    """PathVertex over the pixel grid (RayPathData.hlsli:1-45)."""

    color: torch.Tensor     # [..., 3] throughput
    pos: torch.Tensor       # [..., 3]
    n: torch.Tensor         # [..., 3]
    v: torch.Tensor         # [..., 3]
    dif: torch.Tensor       # [..., 3]
    spec: torch.Tensor      # [..., 3]
    rough: torch.Tensor     # [...]
    is_spec: torch.Tensor   # [...] bool
    pdf_fwd: torch.Tensor   # [...]

    @classmethod
    def zeros(cls, shape, device):
        z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(color=z3, pos=z3, n=z3, v=z3, dif=z3, spec=z3, rough=z,
                   is_spec=torch.zeros(shape, dtype=torch.bool, device=device), pdf_fwd=z)

    def where(self, mask, other: "PathVertex") -> "PathVertex":
        def pick(a, b):
            return torch.where(mask[..., None] if a.dim() > mask.dim() else mask, a, b)
        return _fmap(pick, self, other)


@dataclass(frozen=True)
class Payload:
    """RayPayload (RayPathData.hlsli:48-86)."""

    color: torch.Tensor
    seed: torch.Tensor       # int64 holding a uint32 (core/rng.py)
    pos: torch.Tensor
    n: torch.Tensor
    v: torch.Tensor
    dif: torch.Tensor
    spec: torch.Tensor
    rough: torch.Tensor
    is_spec: torch.Tensor
    pdf_fwd: torch.Tensor
    ray_origin: torch.Tensor
    ray_dir: torch.Tensor
    terminated: torch.Tensor

    def vertex(self) -> PathVertex:
        return PathVertex(color=self.color, pos=self.pos, n=self.n, v=self.v, dif=self.dif,
                          spec=self.spec, rough=self.rough, is_spec=self.is_spec,
                          pdf_fwd=self.pdf_fwd)


def init_payload(origin, direction, color, seed) -> Payload:
    z3 = torch.zeros_like(origin)
    z = torch.zeros(origin.shape[:-1], dtype=torch.float32, device=origin.device)
    f = torch.zeros(z.shape, dtype=torch.bool, device=origin.device)
    return Payload(color=color, seed=seed, pos=origin, n=z3, v=z3, dif=z3, spec=z3,
                   rough=z, is_spec=f, pdf_fwd=z, ray_origin=origin, ray_dir=direction,
                   terminated=f)


def _nan_guard(c):
    """A NaN in any channel zeroes the contribution (BDPTMain:165)."""
    return torch.where(torch.isnan(c).any(-1, keepdim=True), torch.zeros_like(c), c)


def shoot_ray(payload: Payload, trace, cfg: BDPTConfig, coherent: bool = True) -> Payload:
    """One extension step of the active lanes (globalIlluminationRay.hlsli):
    a miss sets color 0 and terminated, keeping the stale geometry (a
    reference quirk); a hit samples the BRDF and moves the ray on."""
    active = ~payload.terminated
    hit, sd = trace(payload.ray_origin, payload.ray_dir, cfg.min_t, payload.ray_origin,
                    coherent=coherent, lean=True)
    seed2, weight, l, pdf, is_spec = mat.sample_brdf(
        payload.seed, sd.n, sd.n, sd.v, sd.diffuse, sd.specular, sd.roughness,
        cfg.mat_model)
    got = active & hit.hit
    missed = active & ~hit.hit
    m3 = got[..., None]
    return Payload(
        color=torch.where(m3, payload.color * weight,
                          torch.where(missed[..., None], torch.zeros_like(payload.color),
                                      payload.color)),
        seed=payload.seed if cfg.faithful_rng else torch.where(got, seed2, payload.seed),
        pos=torch.where(m3, sd.pos_w, payload.pos),
        n=torch.where(m3, sd.n, payload.n),
        v=torch.where(m3, sd.v, payload.v),
        dif=torch.where(m3, sd.diffuse, payload.dif),
        spec=torch.where(m3, sd.specular, payload.spec),
        rough=torch.where(got, sd.roughness, payload.rough),
        is_spec=torch.where(got, is_spec, payload.is_spec),
        pdf_fwd=torch.where(got, pdf, payload.pdf_fwd),
        ray_origin=torch.where(m3, sd.pos_w, payload.ray_origin),
        ray_dir=torch.where(m3, l, payload.ray_dir),
        terminated=payload.terminated | missed,
    )


def sample_light(seed, light_rows, light_count: int):
    """sampleLight (BDPTUtils.hlsli:140-152): a uniform pick; the direction
    is a cosine lobe about dirW (directional) or about an un-normalized
    ball sample (point, a reference quirk)."""
    seed, idx = mat.pick_light(seed, light_count)
    row = table_lookup(light_rows, idx)
    origin, light_dir_w, intensity = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    is_dir = row[..., 9].to(torch.int32) == LIGHT_DIRECTIONAL
    seed_s, p = unit_sphere_sample(seed)
    # directional lanes draw no sphere samples (the HLSL skips the loop)
    seed = torch.where(is_dir, seed, seed_s)
    seed, direction = cos_hemisphere_sample(seed, torch.where(is_dir[..., None], light_dir_w, p))
    return seed, origin, direction, intensity


def _eval_g_without_v(a: PathVertex, b: PathVertex):
    """evalGWithoutV (BDPTUtils.hlsli:172-184)."""
    vec = b.pos - a.pos
    inv_len = 1.0 / torch.sqrt(torch.clamp(dot(vec, vec), min=1e-30))
    d = vec * inv_len[..., None]
    return dot(a.n, d).abs() * dot(b.n, d).abs() * inv_len * inv_len


def _unweighted_contribution(camera_path, light_path, s, t, g, cfg: BDPTConfig):
    """getUnweightedContribution (BDPTUtils.hlsli:186-224) for s, t >= 1;
    reference_quirks keeps aL = lightPath[s-1].color (the shipped index bug)."""
    cam_end, light_end = camera_path[s], light_path[t]
    a_e = camera_path[s - 1].color
    a_l = light_path[s - 1].color if cfg.reference_quirks else light_path[t - 1].color
    connect_dir = normalize(cam_end.pos - light_end.pos)
    wo_l = normalize(light_path[t - 1].pos - light_end.pos)
    fs_l = mat.eval_brdf(connect_dir, wo_l, light_end.n, light_end.n, light_end.dif,
                         light_end.spec, light_end.rough, light_end.is_spec, cfg.mat_model)
    wo_e = normalize(camera_path[s - 1].pos - cam_end.pos)
    fs_e = mat.eval_brdf(-connect_dir, wo_e, cam_end.n, cam_end.n, cam_end.dif,
                         cam_end.spec, cam_end.rough, cam_end.is_spec, cfg.mat_model)
    return a_l * (fs_l * g[..., None] * fs_e) * a_e


def _connection_weight(camera_path, light_path, s, t, cfg: BDPTConfig, total_len):
    """Estimator-3 path weight: 'uniform' is the shipped 1/totalLength
    (BDPTMain.rt.hlsl:228); 'power' / 'balance' the corrected MIS over the
    splits of one length (the dead getWeightPower / getWeightLinear,
    BDPTUtils.hlsli:226-278), with zero-normal endpoints counted as cosine 1
    and the pdf chains in log space (the JAX function's two corrections)."""
    if cfg.connection_weight == "uniform":
        return 1.0 / float(total_len)
    power = 2.0 if cfg.connection_weight == "power" else 1.0

    def log_pdf_g(a, b):
        vec = b.pos - a.pos
        d2 = torch.clamp(dot(vec, vec), min=1e-30)
        d = vec / torch.sqrt(d2)[..., None]

        def cosf(vtx):
            degenerate = dot(vtx.n, vtx.n) < 0.5  # normals are unit or zero
            return torch.where(degenerate, torch.ones_like(d2), dot(vtx.n, d).abs())

        return torch.log(torch.clamp(cosf(a) * cosf(b), min=0.0)) - torch.log(d2)

    def subpath_logpdf(path, k):
        lp = torch.log(torch.clamp(path[0].pdf_fwd, min=0.0))
        for x in range(1, k + 1):
            lp = lp + torch.log(torch.clamp(path[x].pdf_fwd, min=0.0))
            lp = lp + log_pdf_g(path[x - 1], path[x])
        return lp

    terms, current = [], None
    for i in range(0, total_len + 1):
        j = total_len - i
        if i >= len(camera_path) or j >= len(light_path):
            continue
        lp = subpath_logpdf(camera_path, i) + subpath_logpdf(light_path, j)
        terms.append(lp)
        if i == s and j == t:
            current = lp
    if current is None:
        return 0.0
    stacked = torch.stack(terms)
    m = stacked.max(dim=0).values
    denom = torch.sum(torch.exp(power * (stacked - m)), dim=0)
    w = torch.exp(power * (current - m)) / torch.clamp(denom, min=1e-30)
    return torch.where(torch.isfinite(current), w, torch.zeros_like(w))


def _stack(payloads):
    return _fmap(lambda *xs: torch.stack(xs), *payloads)


def _unstack(payload, k):
    return _fmap(lambda x: x[k], payload)


@dataclass(frozen=True)
class Estimates:
    """`bdpt_estimates`' result: the image of estimators 1 and 3 over the
    background, and estimator 2's updates for the splat."""

    result: torch.Tensor            # [H, W, 4]
    pix: torch.Tensor | None        # int32 [n]: the update's pixel (n_pix: none)
    rgb: torch.Tensor | None        # [n, 3]
    alpha: torch.Tensor | None      # [n]: 1 where the update lands
    segments: int                   # the splat's sort segments
    n_pix: int                      # pixels of the full-height image
    row0: int


def bdpt_pass(baked, intersect, channels: dict, frame_count, pixel_jitter, cfg: BDPTConfig,
              trace=None, full_height: int | None = None, row0: int = 0, mesh=None):
    """The full BDPT estimator: the frame's radiance image [H, W, 4]
    (SimpleDiffuseGIRayGen, BDPTMain.rt.hlsl:42-234, from a cleared
    texture, BDPTPass.cpp:74).  A bake with `plain=True` splats with the
    plain K2 and K3.

    Row-sharded use (`parallel/sharding.py`): `channels` hold rows [row0,
    row0 + H) of an image `full_height` rows high.  The RNG seeds and the
    estimator-2 pixel projection use global pixel ids; the light-tracing
    splat builds the full-height image, `mesh` sums it over its ranks (the
    frame's one collective) and the shard keeps its rows."""
    est = bdpt_estimates(baked, intersect, channels, frame_count, pixel_jitter, cfg,
                         trace=trace, full_height=full_height, row0=row0)
    return bdpt_splat(est, cfg, plain=baked.plain, mesh=mesh)


def bdpt_estimates(baked, intersect, channels: dict, frame_count, pixel_jitter,
                   cfg: BDPTConfig, trace=None, full_height: int | None = None,
                   row0: int = 0) -> Estimates:
    """`bdpt_pass` up to the estimator-2 splat.  `frame_count` is an int or
    an int64 scalar tensor on the device, and the camera and
    `pixel_jitter` host or device tensors: the same image."""
    if trace is None:
        trace = make_shaded_tracer(baked, sort_divergent=cfg.sort_bounces,
                                   bounce_tex_mean=cfg.bounce_tex_mean)
    cam = baked.data.camera
    light_rows, light_count = baked.light_rows, int(baked.data.lights.count)
    pos4, norm4 = channels["WorldPosition"], channels["WorldNormal"]
    dif4, spec4, emis4 = channels["MaterialDiffuse"], channels["MaterialSpecRough"], channels["Emissive"]
    dev = pos4.device
    height, width = pos4.shape[0], pos4.shape[1]
    shape = (height, width)
    g_height = height if full_height is None else full_height
    cam_pos = cam.pos_w.to(dev)
    cam_n = normalize(cam.camera_w).to(dev)

    def shadow_fn(o, d, tmin, tmax, coherent=True, const_origin=False):
        if cfg.debug_stub_shadows:  # timing attribution only
            return torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
        return ~intersect(o, d, tmin, tmax, closest=False, coherent=coherent,
                          const_origin=const_origin).hit

    def extend(p, coherent=False):
        # debug_stub_extensions (timing attribution only): the lane keeps
        # its payload, as JAX's `if not cfg.debug_stub_extensions` leaves it
        return p if cfg.debug_stub_extensions else shoot_ray(p, trace, cfg, coherent=coherent)

    valid = pos4[..., 3] != 0.0
    world_pos, world_norm = pos4[..., :3], norm4[..., :3]
    dif, spec = dif4[..., :3], spec4[..., :3]
    rough = spec4[..., 3] * spec4[..., 3]
    v = normalize(cam_pos - world_pos)
    seed = rng.pixel_seeds(width, g_height, frame_count, row0=row0, sub_height=height,
                           device=dev)

    # ---------------- camera subpath ----------------
    d_max = cfg.max_depth
    n_verts = cfg.max_possible_depth + 1
    zeros_vert = PathVertex.zeros(shape, dev)
    camera_path = [zeros_vert] * n_verts
    ones = torch.ones(shape, dtype=torch.float32, device=dev)
    camera_path[0] = replace(zeros_vert, pos=cam_pos.expand(shape + (3,)),
                             n=cam_n.expand(shape + (3,)), color=ones[..., None].expand(shape + (3,)),
                             pdf_fwd=ones)
    with span("subpaths"):
        seed2, hit_thp, out_dir, pdf1, is_spec1 = mat.sample_brdf(
            seed, world_norm, world_norm, v, dif, spec, rough, cfg.mat_model)
        if not cfg.faithful_rng:
            seed = seed2
        camera_path[1] = PathVertex(color=hit_thp, pos=world_pos, n=world_norm, v=v, dif=dif,
                                    spec=spec, rough=rough, is_spec=is_spec1,
                                    pdf_fwd=pdf1).where(valid, zeros_vert)
        payload = replace(init_payload(world_pos, out_dir, hit_thp, seed), terminated=~valid)

        def light_start(seed_l):
            seed_l, l_origin, l_dir, l_intensity = sample_light(seed_l, light_rows, light_count)
            path = [zeros_vert] * n_verts
            path[0] = replace(zeros_vert, pos=l_origin, color=l_intensity,
                              pdf_fwd=ones / float(light_count))
            lp = replace(init_payload(l_origin, l_dir, l_intensity, seed_l), terminated=~valid)
            return path, lp

        take = [torch.ones(shape, dtype=torch.bool, device=dev)] * n_verts
        if cfg.parallel_subpaths:
            # the light subpath draws from its own stream (a salted frame id), so
            # the two chains' extension traces merge into one [2, H, W] trace a
            # depth (utils/config.BDPTConfig.parallel_subpaths)
            frame = frame_count if isinstance(frame_count, torch.Tensor) else int(frame_count)
            light_path, lpayload = light_start(rng.pixel_seeds(
                width, g_height, (frame ^ 0x9E3779B9) & 0xFFFFFFFF, row0=row0,
                sub_height=height, device=dev))
            for depth in range(0, d_max):
                do_cam = 1 <= depth <= d_max - 1
                was_active_l = ~lpayload.terminated
                if do_cam:
                    was_active_c = ~payload.terminated
                    merged = extend(_stack([payload, lpayload]))
                    payload, lpayload = _unstack(merged, 0), _unstack(merged, 1)
                    camera_path[depth + 1] = payload.vertex().where(was_active_c, zeros_vert)
                else:
                    lpayload = extend(lpayload)
                light_path[depth + 1] = lpayload.vertex().where(was_active_l, zeros_vert)
                take[depth + 1] = torch.where(was_active_l, ~lpayload.terminated,
                                              take[depth + 1])
            seed = payload.seed
        else:
            for depth in range(1, d_max):
                was_active = ~payload.terminated
                payload = extend(payload)
                camera_path[depth + 1] = payload.vertex().where(was_active, zeros_vert)
            # ---------------- light subpath ----------------
            light_path, lpayload = light_start(payload.seed)
            for depth in range(0, d_max):
                was_active = ~lpayload.terminated
                lpayload = extend(lpayload)
                light_path[depth + 1] = lpayload.vertex().where(was_active, zeros_vert)
                take[depth + 1] = torch.where(was_active, ~lpayload.terminated, take[depth + 1])
            seed = lpayload.seed

    # ---------------- accumulate ----------------
    zero4 = torch.zeros(shape + (4,), dtype=torch.float32, device=dev)
    # background early-out (BDPTMain:62-66): env colour, alpha 1
    bg = torch.cat([dif, ones[..., None]], -1)
    # emissive pixels (BDPTMain:155-158)
    has_emissive = (emis4[..., :3] > 0.0).any(-1)
    out = torch.where((valid & has_emissive)[..., None], emis4, zero4)

    # Visibility of all three families in three batched any-hit queries
    # (the rays are independent of the RNG order).  Shadow rays whose
    # contribution is zero whatever the visibility get an empty interval
    # (t_max = 0 < min_t): est-1 lanes whose unshadowed shade is zero, est-2
    # lanes failing a visibility-free gate.  est-3 is not maskable: its
    # saturate-accumulate adds alpha whenever the ray passes.
    n_e1 = d_max if cfg.enable_path_tracing else 0
    e1_picks, e1_unshadowed = [], []
    for i in range(n_e1):
        vtx = camera_path[i + 1]
        seed, l, intensity, dist = mat.nee_pick(seed, light_rows, light_count, vtx.pos)
        unsh = mat.nee_shade(torch.ones(shape, dtype=torch.bool, device=dev), l, intensity,
                             vtx.n, vtx.v, vtx.dif, vtx.spec, vtx.rough, light_count,
                             cfg.mat_model)
        # NaN lanes stay conservative (NaN != 0 is true: the ray is traced)
        matters = valid & (unsh != 0.0).any(-1)
        e1_picks.append((l, torch.where(matters, dist, torch.zeros_like(dist))))
        e1_unshadowed.append(unsh)

    e3_pairs = []
    for total_len in range(2, (d_max + 1) if cfg.enable_connections else 0):
        for s in range(1, d_max):
            t = total_len - s
            if 0 <= t <= cfg.max_possible_depth:
                e3_pairs.append((total_len, s, t))
    e3_geom = []
    for _, s, t in e3_pairs:
        vec = light_path[t].pos - camera_path[s].pos
        length_ab = torch.sqrt(torch.clamp(dot(vec, vec), min=1e-30))
        e3_geom.append((vec / length_ab[..., None], length_ab))

    n_e2 = d_max if cfg.enable_light_tracing else 0
    e2_geom, e2_pre = [], []
    take_cum = torch.ones(shape, dtype=torch.bool, device=dev)
    for i in range(n_e2):
        to_cam = cam_pos - light_path[i + 1].pos
        dis = torch.sqrt(torch.clamp(dot(to_cam, to_cam), min=1e-30))
        dir_to_cam = to_cam / dis[..., None]
        take_cum = take_cum & take[i + 1]
        facing = dot(cam_n, dir_to_cam) < 0.0
        ix, iy = project_dir_to_pixel(cam, dir_to_cam, (width, g_height), pixel_jitter)
        in_range = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < g_height)
        pre_ok = valid & take_cum & facing & in_range
        e2_geom.append((dir_to_cam, torch.where(pre_ok, dis, torch.zeros_like(dis))))
        e2_pre.append((ix, iy, pre_ok))

    with span("shadows"):
        # the est-1, est-3 and est-2 batches: origins, directions, interval ends
        e1_batch = (torch.stack([camera_path[i + 1].pos for i in range(n_e1)]),
                    torch.stack([p[0] for p in e1_picks]),
                    torch.stack([p[1] for p in e1_picks])) if n_e1 else None
        # est-3's interval ends min_t short of the far endpoint, which lies on
        # the connected surface (PARITY.md)
        e3_batch = (torch.stack([camera_path[s].pos for _, s, _ in e3_pairs]),
                    torch.stack([g[0] for g in e3_geom]),
                    torch.stack([g[1] for g in e3_geom]) - cfg.min_t) if e3_pairs else None
        e2_batch = (torch.stack([light_path[i + 1].pos for i in range(n_e2)]),
                    torch.stack([g[0] for g in e2_geom]),
                    torch.stack([g[1] for g in e2_geom])) if n_e2 else None
        batches = [b for b in (e1_batch, e3_batch, e2_batch) if b is not None]
        if cfg.merge_shadow_batches and not cfg.reverse_shadows and batches:
            # one any-hit query over the three families (the rays are the same)
            o_all, d_all, t_all = (torch.cat(parts) for parts in zip(*batches))
            vis_all = shadow_fn(o_all, d_all, cfg.min_t, t_all, coherent=False)
            vis_b, e3_vis, e2_vis = (vis_all[:n_e1], vis_all[n_e1:n_e1 + len(e3_pairs)],
                                     vis_all[n_e1 + len(e3_pairs):])
        else:
            if n_e1:
                o1, l1, d1 = e1_batch
                if cfg.reverse_shadows:
                    # from the light point towards the vertex over the same open
                    # segment (the light point is eval_light's pos + l * dist)
                    vis_b = shadow_fn(o1 + l1 * d1[..., None], -l1, 0.0, d1 - cfg.min_t,
                                      coherent=not cfg.sort_shadows)
                else:
                    vis_b = shadow_fn(o1, l1, cfg.min_t, d1, coherent=not cfg.sort_shadows)
            if e3_pairs:
                e3_vis = shadow_fn(*e3_batch[:2], cfg.min_t, e3_batch[2], coherent=False)
            if n_e2:
                o2, d2, dis2 = e2_batch
                if cfg.reverse_shadows:
                    # from the camera towards the light vertex: one shared origin
                    e2_vis = shadow_fn(cam_pos.expand(d2.shape), -d2, 0.0, dis2 - cfg.min_t,
                                       coherent=not cfg.sort_shadows, const_origin=True)
                else:
                    e2_vis = shadow_fn(o2, d2, cfg.min_t, dis2, coherent=not cfg.sort_shadows)

    alpha1 = ones[..., None]
    # --- estimator 1: path tracing with NEE ---
    for i in range(n_e1):
        direct = torch.where(vis_b[i][..., None], e1_unshadowed[i],
                             torch.zeros_like(e1_unshadowed[i]))
        shade = mat.clamp_vec(camera_path[i].color * direct / (i + 2), cfg.clamp_upper)
        add = torch.cat([_nan_guard(shade), alpha1], -1)
        out = out + torch.where(valid[..., None], add, zero4)

    # --- estimator 3: s,t connections (own pixel, sequential saturate) ---
    for k, (total_len, s, t) in enumerate(e3_pairs):
        if t >= 1:
            g = _eval_g_without_v(camera_path[s], light_path[t])
            shade = _unweighted_contribution(camera_path, light_path, s, t, g, cfg)
            w = _connection_weight(camera_path, light_path, s, t, cfg, total_len)
            if isinstance(w, torch.Tensor):  # per-lane MIS weight
                w = w[..., None]
            shade = _nan_guard(mat.clamp_vec(shade * w, cfg.clamp_upper))
        else:
            # t == 0: no contribution, but the reference still saturate-adds
            # alpha 1 when the shadow ray passes
            shade = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
        add = torch.cat([shade, alpha1], -1)
        out = torch.where((valid & e3_vis[k])[..., None], saturate(out + add), out)

    # --- estimator 2: light-tracing splats (deterministic scatter-add) ---
    e2_lin, e2_rgb, e2_a = [], [], []
    n_pix = g_height * width
    for i in range(n_e2):
        last = light_path[i + 1]
        dir_to_cam, dis = e2_geom[i]   # dis is 0 on pre-failed lanes (masked)
        ix, iy, pre_ok = e2_pre[i]
        theta1 = saturate(dot(dir_to_cam, cam_n).abs())
        theta2 = saturate(dot(dir_to_cam, last.n).abs())
        g = theta1 * theta2 / (dis * dis)
        brdf = mat.eval_brdf(last.v, normalize(cam_pos - last.pos), last.n, last.n, last.dif,
                             last.spec, last.rough, last.is_spec, cfg.mat_model)
        shade = light_path[i].color * brdf * g[..., None]
        shade = _nan_guard(mat.clamp_vec(shade / (i + 2), cfg.clamp_upper))
        ok = pre_ok & e2_vis[i]
        e2_lin.append(torch.where(ok, iy * width + ix, n_pix).reshape(-1))
        e2_rgb.append(torch.where(ok[..., None], shade, torch.zeros_like(shade)).reshape(-1, 3))
        e2_a.append(ok.to(torch.float32).reshape(-1))
    # background pixels wrote (env, 1) before any splat landed (BDPTMain:64)
    result = torch.where(valid[..., None], out, bg)
    if not e2_lin:
        return Estimates(result, None, None, None, 1, n_pix, row0)
    return Estimates(result, torch.cat(e2_lin).to(torch.int32), torch.cat(e2_rgb),
                     torch.cat(e2_a), len(e2_lin) if cfg.splat_segments else 1, n_pix, row0)


def bdpt_splat(est: Estimates, cfg: BDPTConfig, plain: bool = False, mesh=None):
    """Estimator 2's updates splatted onto `est.result` (`ops/splat`; the
    plain K2 and K3 with `plain`): `bdpt_pass`'s image."""
    result = est.result
    height, width = result.shape[0], result.shape[1]
    if est.pix is None:
        return result
    splat = splat_mod.scatter_add_rgba(cfg.splat_mode, est.pix, est.rgb, est.alpha, est.n_pix,
                                       alpha_is_count=True, segments=est.segments, plain=plain)
    if mesh is not None:
        # light subpaths of any shard splat onto any pixel: sum the
        # full-height images over the ranks, keep this shard's rows
        splat = mesh.all_reduce(splat)
    row0 = est.row0
    splat = splat[row0 * width:(row0 + height) * width].reshape(height, width, 4)
    got_splat = (splat != 0.0).any(-1, keepdim=True)
    return torch.where(got_splat, saturate(result + splat), result)
