"""One frame of the bidirectional path tracer, a path a pixel.

Written from the JAX package's `passes/bdpt.py` and `passes/gbuffer.py`,
which follow the app's shaders (BDPTMain.rt.hlsl:42-234 and
lightProbeGBuffer.rt.hlsl), in its default configuration: the GGX
material, uniform 1/pathLength weights and the reference's quirks.  For
each pixel:

1. the primary ray through the pixel and the frame's MSAA-8 jitter, back
   faces culled: the G-buffer;
2. the camera subpath: the pixel's hit, then `depth - 1` BRDF-sampled
   bounces; a bounce that misses keeps the last hit's geometry with a zero
   throughput (the stale-vertex quirk);
3. the light subpath: a light drawn uniformly, a direction about an
   unnormalized point in the unit ball (a point light; directional: about
   its direction), then `depth` bounces;
4. estimator 1 at each camera vertex i + 1: a light drawn, its shadow ray,
   the throughput of vertex i, / (i + 2), clamped;
5. estimator 3, every (s, t) connection of length 2 .. depth in the
   reference's order with its shadow ray, the light side's throughput
   taken at index s - 1 (the index quirk), / length, each added with a
   saturate;
6. estimator 2, each light vertex seen from the camera: projected to a
   pixel and added there with its count in alpha, then one saturate.

A pixel whose primary ray misses shows the environment and takes no
estimator; its light subpath is not traced.  A ray is tested
(Moller-Trumbore, in float64 unless the caller asks otherwise) against
every triangle of each group whose box it passes within a margin of
(`scene.split`, `_margin`), in blocks of at most CAP pairs, so memory
does not grow with the triangle count; the answers are those of testing
every triangle, bit for bit.  Each draw comes from the pixel's own
stream (`rng`) in the order the shaders take them.
"""
from __future__ import annotations

import math

import torch

from .rng import Stream, pixel_stream

CLAMP = 0.9          # mClampUpper
MIN_T = 1.0e-3       # ResourceManager's mMinT
FAR = 1.0e30
CAP = 1 << 24        # ray-box or ray-triangle pairs a block holds at most
MSAA8 = ((1, -3), (-1, 3), (5, 1), (-3, -5), (-5, 5), (-7, -1), (3, 7), (7, -7))
FIELDS = ("color", "pos", "n", "v", "dif", "spec", "alpha", "spec_lobe", "pdf")


def jitter(frame_count: int) -> tuple[float, float]:
    """The pixel offset of a frame: the MSAA-8 pattern / 16, plus 0.5."""
    x, y = MSAA8[frame_count % 8]
    return x * 0.0625 + 0.5, y * 0.0625 + 0.5


def dot(a, b):
    return (a * b).sum(-1)


def unit(a):
    return a / torch.sqrt(dot(a, a)).unsqueeze(-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def sat(x):
    return x.clamp(0.0, 1.0)


# ------------------------------------------------------------------ rays
def _tests(v0, e1, e2, o, d, tmin, tmax, cull):
    """Triangles v0, e1, e2 ([L, 3], or [M, L, 3] a ray each) against rays
    o, d [M, 3]: (valid, t, u, v), [M, L]."""
    o, d = o[:, None], d[:, None]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det > 1e-9 if cull else det.abs() > 1e-9
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv
    q = cross(tvec, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin[:, None]) & (t < tmax[:, None])
    return hit, t, u, v


def _margin(scene, o, d):
    """[M, G]: how far outside a group's box the triangle test can still
    find a hit of a ray o, d [M, 3].

    Let R be a bound on the distance from o to the group's box's farthest
    point, E the group's longest edge and e the working type's epsilon.
    The test's u, v and t are products of sums of lengths up to R, E and
    |d|, over det, with |det| > 1e-9.  Their rounding puts a point that
    the test accepts at most about 38 e |d| E^2 R / 1e-9 from its
    triangle; this takes 1000 e |d| E^2 R / 1e-9.  To that it adds 1e-9 x
    (S + R), S the scene's scale, which the box test's own rounding stays
    under while |d| E^2 is under 1e9.  Under the bfloat16 control the
    margin stays the working type's."""
    centre = (scene.box_lo + scene.box_hi) / 2
    half = torch.linalg.vector_norm(scene.box_hi - scene.box_lo, dim=1) / 2
    reach = torch.linalg.vector_norm(o[:, None] - centre, dim=2) + half
    length = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    rounding = 1000 * torch.finfo(o.dtype).eps / 1e-9
    return 1e-9 * (scene.scale + reach) + rounding * length * scene.box_edge ** 2 * reach


def _enter(scene, o, d, tmin, tmax):
    """[M, G]: whether each ray o + t d, tmin < t < tmax, passes within
    its margin of a group's box, slab by slab."""
    pad = _margin(scene, o, d)[..., None]
    inv = (1.0 / d)[:, None]
    t0 = (scene.box_lo - pad - o[:, None]) * inv
    t1 = (scene.box_hi + pad - o[:, None]) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    # 0 * inf: a ray in a slab's plane that runs along it
    near = torch.where(torch.isnan(lo), -math.inf, lo).amax(-1)
    far = torch.where(torch.isnan(hi), math.inf, hi).amin(-1)
    return (near <= far) & (far >= tmin[:, None]) & (near <= tmax[:, None])


def _nearest(scene, o, d, tmin, tmax, cull):
    """Each group's nearest hit for each ray o, d [M, 3] that `_enter`s
    its box, in blocks of at most CAP ray-box and CAP ray-triangle pairs:
    yields (ray, t, triangle, u, v), each [P], t = inf where the group has
    no hit; a tie goes to the lower triangle index."""
    m, (n_groups, width) = o.shape[0], scene.groups.shape
    per_block, per_chunk = max(1, CAP // n_groups), max(1, CAP // width)
    for a in range(0, m, per_block):
        b = min(m, a + per_block)
        rays, groups = _enter(scene, o[a:b], d[a:b], tmin[a:b], tmax[a:b]).nonzero(as_tuple=True)
        for c in range(0, rays.numel(), per_chunk):
            r = rays[c:c + per_chunk] + a
            tris = scene.groups[groups[c:c + per_chunk]]
            hit, t, u, v = _tests(scene.v0[tris], scene.e1[tris], scene.e2[tris], o[r], d[r],
                                  tmin[r], tmax[r], cull)
            t = torch.where(hit, t, torch.full_like(t, math.inf))
            best, k = t.min(1)
            rows = torch.arange(r.numel(), device=o.device)
            yield r, best, tris[rows, k], u[rows, k], v[rows, k]


def closest(scene, o, d, tmin, cull=False):
    """The nearest hit of each ray beyond tmin: (tri, -1 on a miss; t, u, v),
    as testing every triangle gives it, the least t and on a tie the lowest
    triangle index; a miss reads t = inf and triangle 0's u, v."""
    m, dev = o.shape[0], o.device
    tmin = torch.as_tensor(tmin, dtype=o.dtype, device=dev).expand(m)
    far = torch.full((m,), FAR, dtype=o.dtype, device=dev)
    none = scene.v0.shape[0]
    tri = torch.full((m,), none, dtype=torch.int64, device=dev)
    t = torch.full((m,), math.inf, dtype=o.dtype, device=dev)
    _, _, u, v = _tests(scene.v0[:1], scene.e1[:1], scene.e2[:1], o, d, tmin, far, cull)
    u, v = u[:, 0].clone(), v[:, 0].clone()
    for r, tt, k, uu, vv in _nearest(scene, o, d, tmin, far, cull):
        found = torch.isfinite(tt)
        r, tt, k, uu, vv = r[found], tt[found], k[found], uu[found], vv[found]
        best = t.scatter_reduce(0, r, tt, "amin")
        ties = tt == best[r]
        k_best = torch.where(t == best, tri, torch.full_like(tri, none)).scatter_reduce(
            0, r[ties], k[ties], "amin")
        take = ties & (k == k_best[r])
        u[r[take]], v[r[take]] = uu[take], vv[take]
        t, tri = best, k_best
    return torch.where(tri < none, tri, torch.full_like(tri, -1)), t, u, v


def blocked(scene, o, d, tmin, tmax):
    """Whether anything lies on each ray strictly between tmin and tmax."""
    m = o.shape[0]
    out = torch.zeros(m, dtype=torch.bool, device=o.device)
    tmin = torch.as_tensor(tmin, dtype=o.dtype, device=o.device).expand(m)
    tmax = torch.as_tensor(tmax, dtype=o.dtype, device=o.device).expand(m)
    for r, t, _, _, _ in _nearest(scene, o, d, tmin, tmax, False):
        out[r[torch.isfinite(t)]] = True
    return out


def surface(scene, o, d, tri, t, u, v, view):
    """The shading data where rays o + t d hit triangles `tri` (>= 0)."""
    k = tri.clamp(min=0)
    pos = o + t[:, None] * d
    w = (1.0 - u - v)[:, None]
    n = unit(w * scene.n0[k] + u[:, None] * scene.n1[k] + v[:, None] * scene.n2[k])
    to_view = unit(view - pos)
    flip = (dot(n, to_view) <= 0) & scene.two_sided[k]
    n = torch.where(flip[:, None], -n, n)
    return {"pos": pos, "n": n, "v": to_view, "dif": scene.diffuse[k],
            "spec": scene.specular[k], "alpha": scene.alpha[k],
            "emissive": scene.emissive[k], "opacity": scene.opacity[k]}


# ---------------------------------------------------------------- the GGX
def _onb(n):
    """(tangent, bitangent): bitangent = the unit cross of n with the axis
    of its smallest component, tangent = bitangent x n."""
    a = n.abs()
    x = (a[:, 0] < a[:, 1]) & (a[:, 0] < a[:, 2])
    y = ~x & (a[:, 1] < a[:, 2])
    axis = torch.stack([x, y, ~(x | y)], -1).to(n.dtype)
    b = unit(cross(n, axis))
    return cross(b, n), b


def _ggx(n, v, l, h, alpha, spec, n_dot_l):
    """(Schlick's Fresnel [M, 3], the GGX distribution D, Schlick-GGX G,
    n.h, l.h) of BRDFUtils.hlsli: D and G both take alpha squared."""
    n_dot_v = sat(dot(n, v))
    n_dot_h, l_dot_h = sat(dot(n, h)), sat(dot(l, h))
    a2 = alpha * alpha
    den = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    dist = a2 / torch.clamp(den * den * math.pi, min=0.001)
    k = alpha * alpha / 2.0
    geo = n_dot_v / (n_dot_v * (1.0 - k) + k) * (n_dot_l / (n_dot_l * (1.0 - k) + k))
    fres = spec + (1.0 - spec) * torch.clamp(1.0 - l_dot_h, min=0.0).pow(5.0)[:, None]
    return fres, dist, geo, n_dot_h, l_dot_h


def _p_diffuse(dif, spec):
    def lum(c):
        return torch.clamp(0.2126 * c[:, 0] + 0.7152 * c[:, 1] + 0.0722 * c[:, 2], min=0.01)
    return lum(dif) / (lum(dif) + lum(spec))


def brdf(n, v, l, dif, spec, alpha, spec_lobe):
    """f of the lobe a vertex was sampled with; 0 below the surface."""
    n_dot_l, n_dot_v = sat(dot(n, l)), sat(dot(n, v))
    fres, dist, geo, _, _ = _ggx(n, v, l, unit(l + v), alpha, spec, n_dot_l)
    f = fres * (dist * geo / (4.0 * n_dot_l * n_dot_v))[:, None]
    out = torch.where(spec_lobe[:, None], f, dif / math.pi)
    return torch.where((dot(n, l) <= 0)[:, None], torch.zeros_like(out), out)


def sample(u, n, v, dif, spec, alpha):
    """A BRDF sample from three draws: (weight f cos / pdf, l, pdf, lobe)."""
    u_lobe, u0, u1 = u
    p_dif = _p_diffuse(dif, spec)
    tangent, bitangent = _onb(n)
    phi = 2.0 * math.pi * u1
    r = torch.sqrt(u0)
    l_dif = (tangent * (r * torch.cos(phi))[:, None] + bitangent * (r * torch.sin(phi))[:, None]
             + n * torch.sqrt(torch.clamp(1.0 - u0, min=0.0))[:, None])
    a2 = alpha * alpha
    cos_h = torch.sqrt(torch.clamp((1.0 - u0) / ((a2 - 1.0) * u0 + 1.0), min=0.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    h = (tangent * (sin_h * torch.cos(phi))[:, None] + bitangent * (sin_h * torch.sin(phi))[:, None]
         + n * cos_h[:, None])
    l_spec = unit(2.0 * dot(v, h)[:, None] * h - v)
    diffuse = u_lobe < p_dif
    l = torch.where(diffuse[:, None], l_dif, l_spec)
    n_dot_l, n_dot_v = sat(dot(n, l)), sat(dot(n, v))
    fres, dist, geo, n_dot_h, l_dot_h = _ggx(n, v, l_spec, h, alpha, spec, n_dot_l)
    f = fres * (dist * geo / (4.0 * n_dot_l * n_dot_v))[:, None]
    pdf_spec = dist * n_dot_h / (4.0 * l_dot_h) * (1.0 - p_dif)
    pdf = torch.where(diffuse, n_dot_l / math.pi * p_dif, pdf_spec)
    weight = torch.where(diffuse[:, None], dif / p_dif[:, None], (n_dot_l / pdf_spec)[:, None] * f)
    below = dot(n, l) <= 0
    return (torch.where(below[:, None], torch.zeros_like(weight), weight), l,
            torch.where(below, torch.zeros_like(pdf), pdf), ~diffuse)


# ----------------------------------------------------------------- lights
def _pick(u, count: int):
    return torch.clamp((u * count).to(torch.int64), max=count - 1)


def light_at(scene, idx, pos):
    """Light idx seen from pos: (unit direction to it, radiance, distance)."""
    lpos, ldir = scene.light_pos[idx], scene.light_dir[idx]
    power, directional = scene.light_power[idx], scene.light_directional[idx]
    to_l = lpos - pos
    d2 = dot(to_l, to_l)
    near = d2 <= 1e-5
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    l_pt = torch.where(near[:, None], torch.zeros_like(to_l),
                       to_l / torch.clamp(dist, min=1e-20)[:, None])
    cone = -dot(l_pt, ldir) < -1.0    # the point lights' opening angle is pi
    fall = torch.where(cone, torch.zeros_like(d2), 1.0 / (1e-4 + d2))
    far = torch.sqrt(torch.clamp(dot(pos - lpos, pos - lpos), min=0.0))
    src = torch.where(directional[:, None], pos - ldir * far[:, None], lpos)
    l = torch.where(directional[:, None], -ldir, l_pt)
    radiance = torch.where(directional[:, None], power, power * fall[:, None])
    return l, radiance, torch.sqrt(torch.clamp(dot(src - pos, src - pos), min=0.0))


def direct(vtx, l, radiance, n_lights: int):
    """The GGX material lit from l (MaterialUtils.hlsli:160-183), unshadowed."""
    n, v = vtx["n"], vtx["v"]
    n_dot_l, n_dot_v = sat(dot(n, l)), sat(dot(n, v))
    fres, dist, geo, _, _ = _ggx(n, v, l, unit(v + l), vtx["alpha"], vtx["spec"], n_dot_l)
    spec = fres * (dist * geo / (4.0 * n_dot_v))[:, None]   # NdotL cancelled, as the shader does
    return n_lights * radiance * (spec + n_dot_l[:, None] * vtx["dif"] / math.pi)


# ------------------------------------------------------------------ paths
def _blank(m, like):
    """A vertex of zeros, each field a tensor of its own."""
    def z(*shape):
        return torch.zeros((m,) + shape, dtype=like.dtype, device=like.device)
    return {"color": z(3), "pos": z(3), "n": z(3), "v": z(3), "dif": z(3), "spec": z(3),
            "alpha": z(), "spec_lobe": torch.zeros(m, dtype=torch.bool, device=like.device),
            "pdf": z()}


def _keep(mask, a, b):
    m = mask if a.dim() == 1 else mask[:, None]
    return torch.where(m, a, b)


def _bounce(scene, path, stream: Stream):
    """One extension of every live path (`path` carries its ray and vertex):
    on a hit the vertex moves there and the throughput takes the sample's
    weight; on a miss the throughput goes to 0 and the path ends, its
    geometry left as it was.  Returns the mask of paths that hit."""
    live = ~path["dead"]
    idx = live.nonzero().squeeze(1)
    o, d = path["o"][idx], path["d"][idx]
    tri, t, u, v = closest(scene, o, d, MIN_T)
    sd = surface(scene, o, d, tri, t, u, v, o)
    draws = [x[idx] for x in stream.peek(3)]
    weight, l, pdf, lobe = sample(draws, sd["n"], sd["v"], sd["dif"], sd["spec"], sd["alpha"])
    hit = tri >= 0
    got = torch.zeros_like(live)
    got[idx] = hit
    stream.advance(3, got)
    new = {"color": torch.where(hit[:, None], path["color"][idx] * weight,
                                torch.zeros_like(weight)),
           "pos": sd["pos"], "n": sd["n"], "v": sd["v"], "dif": sd["dif"],
           "spec": sd["spec"], "alpha": sd["alpha"], "spec_lobe": lobe, "pdf": pdf}
    for k, val in new.items():
        if k == "color":
            path[k][idx] = val
        else:
            path[k][idx] = _keep(hit, val, path[k][idx])
    path["o"][idx] = _keep(hit, sd["pos"], o)
    path["d"][idx] = _keep(hit, l, d)
    dead = path["dead"].clone()
    dead[idx] = ~hit
    path["dead"] = dead
    return got


def _record(path, was_live):
    blank = _blank(was_live.shape[0], path["pos"])
    return {k: _keep(was_live, path[k], blank[k]) for k in FIELDS}


def frame(scene, cam, width: int, height: int, frame_count: int, depth: int):
    """(the frame's image [H, W, 4], its G-buffer channels) at BDPT frame
    count `frame_count` (0x1337 + the renderer's frame index)."""
    dev, dt = cam.pos.device, cam.pos.dtype
    n_px = width * height
    jx, jy = jitter(frame_count)
    xs = (torch.arange(width, dtype=dt, device=dev) + jx) / width
    ys = (torch.arange(height, dtype=dt, device=dev) + jy) / height
    raw = ((2.0 * xs - 1.0)[None, :, None] * cam.u + (1.0 - 2.0 * ys)[:, None, None] * cam.v
           + cam.w) / torch.linalg.vector_norm(cam.w)
    d = unit(raw.reshape(n_px, 3))
    o = cam.pos.expand(n_px, 3)
    tri, t, u, v = closest(scene, o, d, 0.0, cull=True)
    valid = tri >= 0
    sd = surface(scene, o, d, tri, t, u, v, cam.pos)
    v3, one = valid[:, None], torch.ones(n_px, 1, dtype=dt, device=dev)
    z3 = torch.zeros_like(d)
    pos = torch.where(v3, sd["pos"], z3)
    gbuffer = {
        "WorldPosition": torch.cat([pos, valid[:, None].to(dt)], 1),
        "WorldNormal": torch.cat([torch.where(v3, sd["n"], z3), torch.where(
            v3, torch.linalg.vector_norm(sd["pos"] - cam.pos, dim=1, keepdim=True), 0 * one)], 1),
        "MaterialDiffuse": torch.cat([torch.where(v3, sd["dif"], scene.env.expand(n_px, 3)),
                                      torch.where(v3, sd["opacity"][:, None], one)], 1),
    }
    n = torch.where(v3, sd["n"], z3)
    dif = torch.where(v3, sd["dif"], scene.env.expand(n_px, 3))
    spec = torch.where(v3, sd["spec"], z3)
    alpha = torch.where(valid, sd["alpha"], torch.zeros_like(t))
    to_cam = unit(cam.pos - pos)
    stream = pixel_stream(width, height, frame_count, dev, dt)
    out = torch.zeros((n_px, 4), dtype=dt, device=dev)
    emissive = torch.where(v3, sd["emissive"], z3)
    lit = valid & (emissive > 0).any(1)
    out = out + torch.where(lit[:, None], torch.cat([emissive, 0 * one], 1), 0 * out)

    # the camera subpath
    cam_v0 = _blank(n_px, pos)
    cam_v0.update(pos=cam.pos.expand(n_px, 3), n=unit(cam.w).expand(n_px, 3),
                  color=torch.ones_like(d), pdf=torch.ones_like(t))
    weight, l, pdf, lobe = sample([stream.draw() for _ in range(3)], n, to_cam, dif, spec, alpha)
    first = {"color": weight, "pos": pos, "n": n, "v": to_cam, "dif": dif, "spec": spec,
             "alpha": alpha, "spec_lobe": lobe, "pdf": pdf}
    C = [cam_v0, _record(first, valid)]
    # the path starts at the hit with the sample's weight, its other fields 0
    path = dict(_blank(n_px, pos), color=weight.clone(), pos=pos.clone(), o=pos.clone(),
                d=l.clone(), dead=~valid)
    for _ in range(1, depth):
        was_live = ~path["dead"]
        _bounce(scene, path, stream)
        C.append(_record(path, was_live))

    # the light subpath
    k = _pick(stream.draw(), scene.n_lights)
    directional = scene.light_directional[k]
    lpos, power = scene.light_pos[k], scene.light_power[k]
    p = torch.full((n_px, 3), 2.0, dtype=dt, device=dev)
    done = directional.clone()
    for _ in range(24):
        x, y, z = stream.peek(3)
        cand = torch.stack([2.0 * x - 1.0, 2.0 * y - 1.0, 2.0 * z - 1.0], 1)
        p = torch.where(done[:, None], p, cand)
        stream.advance(3, ~done)
        done = done | (dot(p, p) <= 1.0)
    p = torch.where(done[:, None], p, torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev))
    axis = torch.where(directional[:, None], scene.light_dir[k], p)
    u0, u1 = stream.draw(), stream.draw()
    tangent, bitangent = _onb(axis)
    r, phi = torch.sqrt(u0), 2.0 * math.pi * u1
    ldir = (tangent * (r * torch.cos(phi))[:, None] + bitangent * (r * torch.sin(phi))[:, None]
            + axis * torch.sqrt(torch.clamp(1.0 - u0, min=0.0))[:, None])
    light_v0 = _blank(n_px, pos)
    light_v0.update(pos=lpos, color=power, pdf=torch.full_like(t, 1.0 / scene.n_lights))
    L = [light_v0]
    lpath = dict(_blank(n_px, pos), color=power.clone(), pos=lpos.clone(), o=lpos.clone(),
                 d=ldir.clone(), dead=~valid)
    take = [torch.ones_like(valid)]
    for _ in range(depth):
        was_live = ~lpath["dead"]
        hit = _bounce(scene, lpath, stream)
        L.append(_record(lpath, was_live))
        take.append(torch.where(was_live, hit, torch.ones_like(hit)))

    # estimator 1: a light at each camera vertex
    for i in range(depth):
        vtx = C[i + 1]
        light = _pick(stream.draw(), scene.n_lights)
        l, radiance, dist = light_at(scene, light, vtx["pos"])
        unshadowed = direct(vtx, l, radiance, scene.n_lights)
        seen = torch.ones_like(valid)
        seen[valid] = ~blocked(scene, vtx["pos"][valid], l[valid], MIN_T, dist[valid])
        shade = _guard((C[i]["color"] * torch.where(seen[:, None], unshadowed,
                                                    torch.zeros_like(unshadowed))
                        / (i + 2)).clamp(0.0, CLAMP))
        out = out + torch.where(valid[:, None], torch.cat([shade, one], 1), 0 * out)

    # estimator 3: the (s, t) connections, each added with a saturate
    for total in range(2, depth + 1):
        for s in range(1, depth):
            tt = total - s
            if tt < 0 or tt > 8:
                continue
            a, b = C[s], L[tt]
            vec = b["pos"] - a["pos"]
            length = torch.sqrt(torch.clamp(dot(vec, vec), min=1e-30))
            way = vec / length[:, None]
            seen = torch.zeros_like(valid)
            seen[valid] = ~blocked(scene, a["pos"][valid], way[valid], MIN_T,
                                   length[valid] - MIN_T)
            if tt >= 1:
                g = dot(a["n"], way).abs() * dot(b["n"], way).abs() / (length * length)
                join = unit(a["pos"] - b["pos"])
                f_l = brdf(b["n"], join, unit(L[tt - 1]["pos"] - b["pos"]), b["dif"], b["spec"],
                           b["alpha"], b["spec_lobe"])
                f_e = brdf(a["n"], -join, unit(C[s - 1]["pos"] - a["pos"]), a["dif"], a["spec"],
                           a["alpha"], a["spec_lobe"])
                shade = L[s - 1]["color"] * (f_l * g[:, None] * f_e) * C[s - 1]["color"]
                shade = _guard((shade * (1.0 / total)).clamp(0.0, CLAMP))
            else:
                shade = torch.zeros_like(d)
            ok = (valid & seen)[:, None]
            out = torch.where(ok, sat(out + torch.cat([shade, one], 1)), out)

    # estimator 2: light vertices seen by the camera, splatted where they land
    splat = torch.zeros((n_px + 1, 4), dtype=dt, device=dev)
    fwd = unit(cam.w)
    alive = torch.ones_like(valid)
    for i in range(depth):
        b = L[i + 1]
        to_c = cam.pos - b["pos"]
        dis = torch.sqrt(torch.clamp(dot(to_c, to_c), min=1e-30))
        way = to_c / dis[:, None]
        alive = alive & take[i + 1]
        facing = dot(way, fwd) < 0
        dx = dot(way, cam.u) / dot(cam.u, cam.u)
        dy = dot(way, cam.v) / dot(cam.v, cam.v)
        dz = dot(way, cam.w) / dot(cam.w, cam.w)
        ix = torch.round(((dx / dz) * 0.5 + 0.5) * width - jx)
        iy = torch.round(((-dy / dz) * 0.5 + 0.5) * height - jy)
        inside = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        ok = valid & alive & facing & inside
        seen = torch.zeros_like(valid)
        seen[ok] = ~blocked(scene, b["pos"][ok], way[ok], MIN_T, dis[ok])
        ok = ok & seen
        g = sat(dot(way, fwd).abs()) * sat(dot(way, b["n"]).abs()) / (dis * dis)
        f = brdf(b["n"], b["v"], unit(cam.pos - b["pos"]), b["dif"], b["spec"], b["alpha"],
                 b["spec_lobe"])
        shade = _guard((L[i]["color"] * f * g[:, None] / (i + 2)).clamp(0.0, CLAMP))
        target = torch.where(ok, (iy * width + ix).to(torch.int64),
                             torch.full_like(tri, n_px))
        splat.index_add_(0, target, torch.where(ok[:, None], torch.cat([shade, one], 1),
                                                torch.zeros_like(out)))
    splat = splat[:n_px]
    image = torch.where(v3, out, torch.cat([dif, one], 1))
    image = torch.where((splat != 0).any(1, keepdim=True), sat(image + splat), image)
    return image.reshape(height, width, 4), {k: x.reshape(height, width, 4)
                                            for k, x in gbuffer.items()}


def _guard(c):
    """A contribution with a NaN channel counts 0 (BDPTMain.rt.hlsl:165)."""
    return torch.where(torch.isnan(c).any(1, keepdim=True), torch.zeros_like(c), c)
