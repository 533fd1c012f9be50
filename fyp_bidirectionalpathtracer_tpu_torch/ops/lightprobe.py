"""Light-probe pre-integration (the Falcor LightProbe rebuild).

Port of `fyp_bidirectionalpathtracer_tpu/ops/lightprobe.py`.  The
reference pre-filters an environment map once at load time into three
textures (Graphics/LightProbe.cpp:140-167): a diffuse LD map (cosine-
importance-sampled irradiance a direction, LightProbeIntegration.ps.slang:
96-111), a specular LD mip chain (GGX-importance-sampled radiance, a mip a
roughness step, the source read at a solid-angle-matched level, :113-153)
and the DFG lookup (the split-sum BRDF term over (NdotV, roughness), plus
a Disney diffuse term in blue, :155-195).  Default sizes as LightProbe.h:
48-51 and LightProbe.cpp:150.

JAX's module is plain jnp (a `lax.scan` over the Hammersley samples whose
carry is the running sum), with no TPU kernel behind it; this is plain
torch on the probe's device.  Every output texel is a lane; the samples go
in chunks of [K samples x N lanes] (`_PAIR_BUDGET` elements), summed in
the chunk and added to the running sum in sample order, so the memory is
bounded (the default specular chain would need 12.9 GB a mip at once) and
the sum differs from JAX's in-order one by float32 rounding alone.  The
per-direction basis is computed once, not a sample.  Every product is an
elementwise multiply (no matmul, so no TF32 can reach it).
"""
from __future__ import annotations

import torch

from .. import cuda
from ..core.vecmath import M_PI, cross, dot, normalize, reflect, saturate, ws_vector_to_latlong

M_PI2 = 2.0 * M_PI
_PAIR_BUDGET = 1 << 23  # samples x lanes a chunk


# ------------------------------------------------------------- sampling
def radical_inverse_vdc(i) -> torch.Tensor:
    """Van der Corput radical inverse of uint32 i (getHammersley's second
    coordinate, radicalInverse): the bit reversal in int64 with 32-bit
    masks, then float32 times 2^-32, bit for bit as JAX's uint32 form."""
    bits = torch.as_tensor(i).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        bits = ((bits & mask) << shift) | ((bits >> shift) & mask)
    return bits.to(torch.float32) * torch.tensor(2.3283064365386963e-10, dtype=torch.float32)


def hammersley(i, n):
    """getHammersley(i, N) -> (i / N, radicalInverse(i))."""
    i = torch.as_tensor(i)
    u = i.to(torch.float32) / torch.tensor(float(n), dtype=torch.float32)
    return u, radical_inverse_vdc(i)


def _generate_basis(n):
    """generateBasis (LightProbeIntegration.ps.slang:42-47): up is +z unless
    N is nearly +-z, right = normalize(up x N), forward = N x right."""
    near_z = n[..., 2:3].abs() >= 0.999999
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=n.device)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=n.device)
    up = torch.where(near_z, x_axis, z_axis).expand(n.shape)
    right = normalize(cross(up, n))
    forward = cross(n, right)
    return up, right, forward


def _cos_dir(u1, u2, n, right, forward):
    """importance_sample_cos_dir over a precomputed basis."""
    r = torch.sqrt(u1)
    phi = u2 * M_PI2
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    lz = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return normalize(right * ly[..., None] + forward * lx[..., None] + n * lz[..., None])


def _ggx_dir(u1, u2, n, right, forward, roughness):
    """importance_sample_ggx over a precomputed basis."""
    a = roughness * roughness
    phi = M_PI2 * u1
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    tx = sin_t * torch.cos(phi)
    ty = sin_t * torch.sin(phi)
    return normalize(right * tx[..., None] + forward * ty[..., None] + n * cos_t[..., None])


def importance_sample_cos_dir(u1, u2, n):
    """Cosine-weighted hemisphere direction about n
    (LightProbeIntegration.ps.slang:49-65, with the reference's axis swap:
    L = right * tangent.y + forward * tangent.x + N * tangent.z)."""
    _, right, forward = _generate_basis(n)
    return _cos_dir(u1, u2, n, right, forward)


def importance_sample_ggx(u1, u2, n, roughness):
    """GGX half-vector about n (LightProbeIntegration.ps.slang:67-87)."""
    _, right, forward = _generate_basis(n)
    return _ggx_dir(u1, u2, n, right, forward, roughness)


def _smith_ggx(n_dot_l, n_dot_v, roughness):
    """LightProbeIntegration.ps.slang:89-95 (the UE4 k remap, not the
    shading path's evalSmithGGX)."""
    k = ((roughness + 1.0) ** 2) / 8.0
    g1 = n_dot_l / (n_dot_l * (1.0 - k) + k)
    g2 = n_dot_v / (n_dot_v * (1.0 - k) + k)
    return g1 * g2


def _ggx_d(roughness, n_dot_h):
    """evalGGX (ShadingUtils/BRDF.slang:94-99) with a2 = roughness^2, while
    importanceSampleGGX's distribution has alpha^2 = roughness^4: the
    reference's pdf mismatch, reproduced."""
    a2 = roughness * roughness
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / torch.clamp(d * d, min=1e-20)


# --------------------------------------------------------------- fetches
def _bilinear_fetch(env, u, v):
    """[..., 3] bilinear lat-long fetch, edge-clamped (gSampler is a linear
    clamp sampler, LightProbe.cpp:50-56).  A NaN coordinate reads texel 0
    (its weights keep the NaN), as JAX's clamping gather does."""
    h, w = env.shape[0], env.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0 = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    top = env[y0, x0, :3] * (1 - fx) + env[y0, x1, :3] * fx
    bot = env[y1, x0, :3] * (1 - fx) + env[y1, x1, :3] * fx
    return top * (1 - fy) + bot * fy


def build_mip_pyramid(env, levels: int) -> torch.Tensor:
    """[L, H, W, 3] box-filtered mip pyramid, every level repeated back to
    the base resolution (nearest), so a fractional mip pick is one more
    gather coordinate."""
    h, w = env.shape[0], env.shape[1]
    base = env[..., :3].to(torch.float32)
    out = [base]
    cur = base
    for _ in range(1, levels):
        nh, nw = max(1, cur.shape[0] // 2), max(1, cur.shape[1] // 2)
        cur = cur[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, 3).mean((1, 3))
        out.append(cur.repeat_interleave(h // nh, 0).repeat_interleave(w // nw, 1))
    return torch.stack(out)


def _pyramid_fetch(pyr, u, v, mip):
    """Nearest-in-space, linear-in-mip fetch from a [L, H, W, 3] pyramid (a
    NaN mip reads level 0, as JAX's clamping gather does)."""
    levels = pyr.shape[0]
    m = torch.clamp(mip, 0.0, levels - 1.0)
    m0 = torch.clamp(torch.floor(m).to(torch.int64), 0, levels - 1)
    m1 = torch.clamp(m0 + 1, max=levels - 1)
    fm = (m - m0.to(torch.float32))[..., None]
    h, w = pyr.shape[1], pyr.shape[2]
    x = torch.clamp((u * w - 0.5).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h - 0.5).to(torch.int64), 0, h - 1)
    return pyr[m0, y, x] * (1 - fm) + pyr[m1, y, x] * fm


# ----------------------------------------------------------- directions
def latlong_texel_dirs(height: int, width: int, device="cuda") -> torch.Tensor:
    """[H, W, 3] world directions through the lat-long texel centres (the
    inverse of ws_vector_to_latlong), on the card unless `device` names
    another."""
    dev = cuda.resolve_device(device)
    v = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    u = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    theta = vv * M_PI
    phi = (2.0 * uu - 1.0) * M_PI
    s = torch.sin(theta)
    return torch.stack([s * torch.sin(phi), torch.cos(theta), -s * torch.cos(phi)], -1)


# ------------------------------------------------------------ integrals
def _sample_sum(step, sample_count: int, n_lanes: int, device) -> torch.Tensor:
    """sum over i < sample_count of step(i) ([K] sample ids -> [K, N, C]),
    K samples a chunk, the chunks added in sample order."""
    k = max(1, min(sample_count, _PAIR_BUDGET // max(n_lanes, 1)))
    acc = None
    for s in range(0, sample_count, k):
        ids = torch.arange(s, min(s + k, sample_count), dtype=torch.int64, device=device)
        part = step(ids).sum(0)
        acc = part if acc is None else acc + part
    return acc


def integrate_diffuse_ld(env, size: int = 128, sample_count: int = 4096) -> torch.Tensor:
    """[size, size, 3] cosine-convolved radiance (integrateDiffuseLD,
    LightProbeIntegration.ps.slang:96-111): for each output direction N,
    the mean of env(L) over cosine-importance directions L (the pdf
    cancels the NdotL / pi kernel)."""
    env = env[..., :3].to(torch.float32)
    n = latlong_texel_dirs(size, size, env.device).reshape(-1, 3)
    _, right, forward = _generate_basis(n)

    def step(i):
        u1, u2 = hammersley(i, sample_count)
        u1, u2 = u1[:, None], u2[:, None]
        l = _cos_dir(u1, u2, n, right, forward)
        u, v = ws_vector_to_latlong(l)
        c = _bilinear_fetch(env, u, v)
        return torch.where((dot(n, l) > 0.0)[..., None], c, 0.0)

    acc = _sample_sum(step, sample_count, n.shape[0], env.device)
    return (acc / sample_count).reshape(size, size, 3)


def integrate_specular_ld(env, size: int = 1024, sample_count: int = 1024,
                          mip_count: int = 8) -> torch.Tensor:
    """[mip_count, size, size, 3] GGX-pre-filtered radiance; mip m has
    roughness m / (mip_count - 1) (LightProbe.cpp:92-101;
    integrateSpecularLD, LightProbeIntegration.ps.slang:113-153): V = N,
    GGX half-vectors, the source read at a solid-angle-matched mip,
    NdotL-weighted mean.  Every mip at `size`, as the reference's square
    target."""
    env = env[..., :3].to(torch.float32)
    src_h, src_w = env.shape[0], env.shape[1]
    src_mips = max(1, max(src_h, src_w).bit_length() - 1)
    pyr = build_mip_pyramid(env, src_mips)
    cube_width = src_w / 4.0
    omega_p = 4.0 * M_PI / (6.0 * cube_width * cube_width)
    n = latlong_texel_dirs(size, size, env.device).reshape(-1, 3)
    _, right, forward = _generate_basis(n)

    def one_mip(mip_idx: int):
        roughness = (torch.tensor(float(mip_idx), dtype=torch.float32, device=env.device)
                     / torch.tensor(float(max(1, mip_count - 1)), dtype=torch.float32))

        def step(i):
            u1, u2 = hammersley(i, sample_count)
            u1, u2 = u1[:, None], u2[:, None]
            h = _ggx_dir(u1, u2, n, right, forward, roughness)
            l = reflect(-n, h)
            n_dot_l = dot(n, l)
            n_dot_h = saturate(dot(n, h))
            l_dot_h = saturate(dot(l, h))
            pdf = (_ggx_d(roughness, n_dot_h) / M_PI) * n_dot_h / torch.clamp(
                4.0 * l_dot_h, min=1e-20)
            omega_s = 1.0 / torch.clamp(sample_count * pdf, min=1e-20)
            mip = torch.clamp(0.5 * torch.log2(omega_s / omega_p), 0.0, src_mips - 1.0)
            u, v = ws_vector_to_latlong(l)
            li = _pyramid_fetch(pyr, u, v, mip)
            w = torch.where(n_dot_l > 0.0, n_dot_l, 0.0)
            return torch.cat([li * w[..., None], w[..., None]], -1)

        acc = _sample_sum(step, sample_count, n.shape[0], env.device)
        return (acc[:, :3] / torch.clamp(acc[:, 3:], min=1e-20)).reshape(size, size, 3)

    return torch.stack([one_mip(m) for m in range(mip_count)])


def integrate_dfg(size: int = 128, sample_count: int = 128, device="cuda") -> torch.Tensor:
    """[size, size, 3] DFG lookup: x = NdotV, y = roughness; R, G the
    split-sum scale and bias of F0, B the Disney diffuse Fresnel term
    (LightProbeIntegration.ps.slang:155-195; sizes from LightProbe.cpp:150).
    On the card unless `device` names another."""
    dev = cuda.resolve_device(device)
    t = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    n_dot_v, roughness = torch.meshgrid(t, t, indexing="xy")  # x fast = NdotV
    n_dot_v = n_dot_v.reshape(-1)
    roughness = roughness.reshape(-1)
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev).expand(
        n_dot_v.shape[0], 3)
    sin_v = torch.sqrt(torch.clamp(1.0 - n_dot_v * n_dot_v, min=0.0))
    v = torch.stack([sin_v, torch.zeros_like(sin_v), n_dot_v], -1)
    _, right, forward = _generate_basis(n)

    def step(i):
        u1, u2 = hammersley(i, sample_count)
        u1, u2 = u1[:, None], u2[:, None]
        h = _ggx_dir(u1, u2, n, right, forward, roughness)
        l = reflect(-n, h)
        n_dot_h = saturate(dot(n, h))
        l_dot_h = saturate(dot(l, h))
        n_dot_l = saturate(dot(n, l))
        g = _smith_ggx(n_dot_l, n_dot_v, roughness)
        g_vis = (g * l_dot_h) / torch.clamp(n_dot_v * n_dot_h, min=1e-20)
        fc = (1.0 - l_dot_h) ** 5
        take = (n_dot_l > 0.0) & (g > 0.0)
        r = torch.where(take, (1.0 - fc) * g_vis, 0.0)
        gg = torch.where(take, fc * g_vis, 0.0)
        # the Disney diffuse term: u shifted by 0.5, cosine directions
        ld = _cos_dir(torch.remainder(u1 + 0.5, 1.0), torch.remainder(u2 + 0.5, 1.0), n,
                      right, forward)
        n_dot_ld = saturate(dot(n, ld))
        hd = normalize(v + ld)
        l_dot_hd = saturate(dot(ld, hd))
        fd90 = 0.5 + 2.0 * l_dot_hd * l_dot_hd * torch.sqrt(roughness)
        f_view = 1.0 + (fd90 - 1.0) * (1.0 - saturate(n_dot_v)) ** 5
        f_light = 1.0 + (fd90 - 1.0) * (1.0 - n_dot_ld) ** 5
        b = torch.where(n_dot_ld > 0.0, f_view * f_light, 0.0)
        return torch.stack([r, gg, b], -1)

    acc = _sample_sum(step, sample_count, n.shape[0], dev)
    return (acc / sample_count).reshape(size, size, 3)


class LightProbe:
    """The pre-integrated probe (Graphics/LightProbe.h:40-157): the source
    map, the diffuse LD map, the specular LD chain and the DFG lookup, on
    the source map's device."""

    def __init__(self, env, diff_samples: int = 4096, spec_samples: int = 1024,
                 diff_size: int = 128, spec_size: int = 1024, spec_mips: int = 8):
        self.origin = env
        self.diffuse = integrate_diffuse_ld(env, diff_size, diff_samples)
        self.specular = integrate_specular_ld(env, spec_size, spec_samples, spec_mips)
        self.dfg = integrate_dfg(device=env.device)


# ------------------------------------------------------------ evaluation
def _get_diffuse_dominant_dir(n, v, roughness):
    """getDiffuseDominantDir (Lights.slang:140-146)."""
    a = 1.02341 * roughness - 1.51174
    b = -0.511705 * roughness + 0.755868
    factor = saturate((saturate(dot(n, v)) * a + b) * roughness)
    return normalize(n + (v - n) * factor[..., None])


def _get_specular_dominant_dir(n, r, roughness):
    """getSpecularDominantDir (Lights.slang:148-153)."""
    smoothness = 1.0 - roughness
    factor = smoothness * (torch.sqrt(smoothness) + roughness)
    return normalize(n + (r - n) * factor[..., None])


def eval_probe(probe: LightProbe, n, v, diffuse, specular, roughness):
    """Shade with a pre-integrated global probe (radius < 0, intensity 1):
    evalLightProbeLinear2D (Lights.slang:155-226) through the probe
    overload of evalMaterial (Shading.slang:330-340).  Per-lane G-buffer
    fields [..., 3] / [...]; `roughness` is sd.roughness = linear
    roughness^2 (Shading.slang:236-237).  Returns the probe-lit rgb."""
    dfg = probe.dfg
    dfg_w = dfg.shape[1]
    n_dot_v = saturate(dot(n, v))
    l = reflect(-v, n)  # ls.L (Lights.slang:208)

    # diffuse: the LD map at the diffuse dominant direction x DFG blue
    ud, vd = ws_vector_to_latlong(_get_diffuse_dominant_dir(n, v, roughness))
    diffuse_lighting = _bilinear_fetch(probe.diffuse, ud, vd)
    ls_diffuse = diffuse_lighting * _bilinear_fetch(dfg, n_dot_v, roughness)[..., 2:3]

    # specular: the LD chain at the specular dominant direction x DFG
    mip_count = probe.specular.shape[0]
    dominant = _get_specular_dominant_dir(n, l, roughness)
    n_dot_v_s = torch.clamp(n_dot_v, min=0.5 / dfg_w)
    # linearRoughnessToLod with sd.roughness passed in, as shipped
    # (Lights.slang:191 and its TODO)
    mip = torch.sqrt(roughness) * (mip_count - 1)
    us, vs = ws_vector_to_latlong(dominant)
    ld = _pyramid_fetch(probe.specular, us, vs, mip)
    dfg_xy = _bilinear_fetch(dfg, n_dot_v_s, roughness)
    ls_specular = ld * (specular * dfg_xy[..., 0:1] + dfg_xy[..., 1:2])

    # evalMaterial(sd, probe): the diffuse term plus the saturate(evalGGX)-
    # scaled specular (Shading.slang:334-339; NdotH from H = normalize(V + L))
    h = normalize(v + l)
    n_dot_h = dot(n, h)
    a2 = roughness * roughness
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    eval_ggx = a2 / (d * d)
    return diffuse * ls_diffuse + saturate(eval_ggx)[..., None] * ls_specular * specular
