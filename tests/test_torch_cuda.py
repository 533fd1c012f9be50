"""K1 (and its textured variant), K2, K3, K5 (also with `segments`), K6,
the K4 intersectors, the BVH kernels (also with a ray `order`) and BMFR's
fit kernel (one device and row-sharded) against their plain versions on an
H100, and the frames
(Cornell, pink_room, the textured room's deferred-texture megakernel)
against the plain chain; K1 at every depth the gate admits and at its
2,048 triangles, K3 and K5 also on ragged inputs.

Marked `cuda`: they need the card and skip without one.  On the card:
    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import dataclasses
from dataclasses import replace

import pytest
import torch

from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.accel import cluster
from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect as isect
from fyp_bidirectionalpathtracer_tpu_torch.accel import subpath
from fyp_bidirectionalpathtracer_tpu_torch.core import rng
from fyp_bidirectionalpathtracer_tpu_torch.core.samplers import cos_hemisphere_sample
from fyp_bidirectionalpathtracer_tpu_torch.ops.compact import compact_live, compact_plain
from fyp_bidirectionalpathtracer_tpu_torch.ops.raysort import sort_order
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat_tile import (
    pack_rgb8e,
    reduce_rows_plain,
    reduce_sorted_plain,
    scatter_add_rgba_tiled,
    splat_reduce,
    splat_reduce_rows,
    unpack_rgb8e,
)
from fyp_bidirectionalpathtracer_tpu_torch.models.pink_room import pink_room
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import (
    cornell_box,
    icosphere,
    textured_room,
)
from fyp_bidirectionalpathtracer_tpu_torch.passes.accumulate import AccumState
from fyp_bidirectionalpathtracer_tpu_torch.passes import bmfr
from fyp_bidirectionalpathtracer_tpu_torch.passes.bmfr import BMFRState
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer, render_frame_fn
from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import camera_ray_dirs
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import BDPTConfig, BMFRConfig, RenderConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    cuda.build()
    return torch.device("cuda")


def _updates(u, n_targets, frac, seed=0):
    g = torch.Generator().manual_seed(seed)
    live = torch.rand(u, generator=g) < frac
    keys = torch.where(live, torch.randint(0, n_targets, (u,), generator=g),
                       torch.full((u,), n_targets)).to(torch.int32)
    rgb = torch.rand(u, 3, generator=g) * 2.0
    return keys, pack_rgb8e(rgb[:, 0], rgb[:, 1], rgb[:, 2])


# sizes about a tile (4,096 updates) and the Cornell 720p frame's 2,764,800;
# all live and none live
@pytest.mark.parametrize("u,frac", [(0, 0.15), (1, 1.0), (1000, 0.5), (1023, 0.15),
                                    (1024, 0.15), (1025, 0.15), (4095, 0.5), (4097, 0.5),
                                    (300_001, 0.15), (300_001, 1.0), (300_001, 0.0),
                                    (2_764_800, 0.15)])
def test_compact_kernel_bit_equal(dev, u, frac):
    """K2 bit for bit against its plain version: the live pairs in source
    order, the sentinel tail, the live count; two calls in a row, on
    scratch the caching allocator hands back (a status word left set would
    show), a launch each."""
    keys, pay = _updates(u, 5000, frac)
    want = compact_plain(keys, pay, 5000, 5120)
    cuda.reset_launch_counts()
    for _ in range(2):
        got = compact_live(keys.to(dev), pay.to(dev), 5000, 5120)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert cuda.LAUNCHES["compact"] == 2


def test_splat_reduce_kernel(dev):
    keys, pay = _updates(200_000, 50_000, 0.5, seed=1)
    keep = keys < 50_000
    ls, order = torch.sort(keys[keep], stable=True)
    p8 = pay[keep][order].contiguous()
    got = splat_reduce(ls.to(dev), p8.to(dev), 50_000).cpu()
    want = reduce_sorted_plain(ls, p8, 50_000)
    assert torch.equal(got[:, 3], want[:, 3])
    torch.testing.assert_close(got[:, :3], want[:, :3], rtol=1e-5, atol=1e-6)


def _baked(dev, scene, w, h):
    if scene == "pink_room":
        return Scene.from_built(pink_room(asset_dir=""), aspect=w / h).bake(device=dev)
    if scene in ("textured_room", "textured_gate_limit"):
        built = textured_room()
        if scene == "textured_gate_limit":  # 342 + 1280 + 320 + 106 = 2,048 triangles
            built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
            built.meshes.append(icosphere((0.25, 0.3, 0.3), 0.12, 0, subdivisions=2))
            part = icosphere((0.75, 0.3, 0.7), 0.12, 0, subdivisions=2)
            built.meshes.append(dataclasses.replace(part, indices=part.indices[:106]))
        return Scene.from_built(built, aspect=w / h).bake(device=dev)
    built = cornell_box()
    if scene in ("cornell_icosphere", "gate_limit"):
        built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    if scene == "gate_limit":  # 34 + 1280 + 2 x 320 + 94 = 2,048 triangles
        built.meshes.append(icosphere((0.25, 0.3, 0.3), 0.12, 0, subdivisions=2))
        built.meshes.append(icosphere((0.75, 0.3, 0.7), 0.12, 0, subdivisions=2))
        part = icosphere((0.3, 0.7, 0.6), 0.1, 0, subdivisions=2)
        built.meshes.append(dataclasses.replace(part, indices=part.indices[:94]))
    return Scene.from_built(built, aspect=w / h).bake(device=dev)


# 50x37 is no multiple of the kernel's 128-thread block, so its tail runs;
# every depth the gate admits (accel/frame.supports_megakernel: 1..8)
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("w,h", [(64, 48), (50, 37)])
@pytest.mark.parametrize("scene", ["cornell", "cornell_icosphere"])
def test_frame_kernel_matches_plain(dev, scene, w, h, d):
    baked = _baked(dev, scene, w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig(max_depth=d))
    args = frame_mod.frame_args(baked, w, h, 0x1337, pixel_jitter_for_frame(0x1337),
                                cfg, splat_rgb8e=True)
    k = frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack, baked.bvh_nodes)
    p = frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack)
    torch.cuda.synchronize()
    # the CPU parity bounds of test_torch_frame.py: edge ties flipped by FMA
    # contraction and transcendental rounding
    assert ((k.res - p.res).abs().max(0).values > 1e-3).float().mean() <= 0.02
    assert ((k.gbuf - p.gbuf).abs().max(0).values > 1e-3).float().mean() <= 0.01
    live_k, live_p = k.splat_pix < args.n_pix, p.splat_pix < args.n_pix
    either, both = live_k | live_p, live_k & live_p
    assert (k.splat_pix[either] == p.splat_pix[either]).float().mean() >= 0.98
    assert (k.splat_pay[both] == p.splat_pay[both]).float().mean() >= 0.98


@pytest.mark.parametrize("textured", [False, True])
def test_frame_kernel_at_the_gate_limit(dev, textured):
    """K1 at the gate's 2,048 triangles: the rows (and, for the textured
    variant's walk, the node table) take more than 48 KB of shared memory
    (the opt-in of frame.cu), and the kernel keeps K1's bounds against its
    plain version."""
    w, h = 64, 48
    baked = _baked(dev, "textured_gate_limit" if textured else "gate_limit", w, h)
    assert baked.n_tris == frame_mod.MAX_TRIS
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig(defer_textures=textured))
    assert frame_mod.supports_megakernel(baked, cfg)
    smem = 4 * (baked.n_tris * frame_mod.BW_COLS + textured * baked.bvh_nodes.numel())
    assert 48 * 1024 < smem <= 232_448  # the H100's opt-in limit a block
    args = frame_mod.frame_args(baked, w, h, 0x1337, pixel_jitter_for_frame(0x1337),
                                cfg, splat_rgb8e=not textured)
    assert args.textured == textured
    cuda.reset_launch_counts()
    k = frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack, baked.bvh_nodes)
    assert cuda.LAUNCHES["frame_textured" if textured else "frame"] == 1
    p = frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack)
    torch.cuda.synchronize()
    assert _rows_off(k.gbuf, p.gbuf) <= 0.01
    live_k, live_p = k.splat_pix < args.n_pix, p.splat_pix < args.n_pix
    either = live_k | live_p
    assert (k.splat_pix[either] == p.splat_pix[either]).float().mean() >= 0.98
    if textured:  # the textured variant's bounds
        assert _rows_off(k.vrec, p.vrec) <= 0.01
        for name in ("e1_parts", "e3_parts"):
            assert _rows_off(getattr(k, name), getattr(p, name)) <= 0.02, name
    else:
        assert _rows_off(k.res, p.res) <= 0.02
        both = live_k & live_p
        assert (k.splat_pay[both] == p.splat_pay[both]).float().mean() >= 0.98


def _rows_off(a, b):
    """Share of pixels with a row off by more than 1e-3 (NaN as 0); 0 for
    outputs without rows (no est-3 pair at d = 1)."""
    if a.shape[0] == 0:
        return 0.0
    a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
    return float(((a - b).abs().max(0).values > 1e-3).float().mean())


@pytest.mark.parametrize("w,h", [(64, 48), (50, 37)])
def test_frame_with_splats_matches_plain_chain(dev, w, h):
    baked = _baked(dev, "cornell", w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig())
    k, p = (frame_mod.render_frame_megakernel(
        replace(baked, plain=plain), w, h, 0x1337, pixel_jitter_for_frame(0x1337), cfg)[1]
        for plain in (False, True))
    d = (k - p).abs()
    # the image bounds of test_torch_frame.py
    assert (d.amax(-1) > 1e-3).float().mean() <= 0.02
    assert d.mean() < 5e-3
    assert abs(k[..., :3].mean() - p[..., :3].mean()) < 2e-3


def _k4_rays(baked, w, h, kind, dev):
    """[h, w] rays of one kind: 'gbuffer' (camera rays), 'bounce' (random
    origins in the box, random directions), 'extension' (from the camera
    rays' hits, cosine samples about the interpolated normal: the
    wavefront's extension rays are BRDF samples there) or 'shadow' (finite
    t_max, 30% of the lanes empty)."""
    g = torch.Generator().manual_seed(7)
    if kind in ("gbuffer", "extension"):
        d = camera_ray_dirs(baked.data.camera, w, h, torch.tensor([0.5, 0.5]))
        d = d / d.norm(dim=-1, keepdim=True)
        o, tmax = baked.data.camera.pos_w.expand(d.shape), None
        if kind == "extension":
            o, d = o.contiguous().to(dev), d.contiguous().to(dev)
            hit, fields = isect.intersect_shaded_fm(baked.tri_pack, baked.n_tris, o, d, 0.0,
                                                    None, True)
            nrm = torch.movedim(fields[4:7], 0, -1)
            nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp(min=1e-20)
            o = o + hit.t[..., None] * d
            _, d = cos_hemisphere_sample(rng.pixel_seeds(w, h, 0x1337, device=dev), nrm)
    else:
        o = torch.rand((h, w, 3), generator=g) * 0.9 + 0.05
        d = torch.randn((h, w, 3), generator=g)
        d = d / d.norm(dim=-1, keepdim=True)
        tmax = None
        if kind == "shadow":
            tmax = torch.where(torch.rand((h, w), generator=g) < 0.3, 0.0,
                               torch.rand((h, w), generator=g) * 1.5).to(dev)
    return o.contiguous().to(dev), d.contiguous().to(dev), tmax


def _assert_k4_hits(k, p, kf=None, pf=None):
    """The K4 bounds of tests/test_torch_intersect.py: ids equal but on ties
    (both hit, t within rtol 1e-5), t rtol 1e-5, fields atol 2e-4."""
    differs = k.tri != p.tri
    torch.testing.assert_close(k.t[differs], p.t[differs], rtol=1e-5, atol=1e-7)
    assert (k.tri[differs] >= 0).all() and (p.tri[differs] >= 0).all()
    same = ~differs
    torch.testing.assert_close(k.t[same], p.t[same], rtol=1e-5, atol=1e-7)
    if kf is not None:
        torch.testing.assert_close(kf[:, same], pf[:, same], rtol=0, atol=2e-4)


# 50x37 is no multiple of the kernels' 256-thread block, so their tail runs
@pytest.mark.parametrize("w,h", [(64, 48), (50, 37)])
@pytest.mark.parametrize("scene", ["cornell", "cornell_icosphere", "textured_room"])
def test_k4_kernels_match_plain(dev, scene, w, h):
    """The dense shaded and closest kernels on camera rays (culling on),
    random rays and an extension batch (culling off), and the any-hit
    kernel on a shadow batch, against their plain versions."""
    baked = _baked(dev, scene, w, h)
    args = (baked.tri_pack, baked.n_tris)
    cuda.reset_launch_counts()
    for kind, cull in (("gbuffer", True), ("bounce", False), ("extension", False)):
        o, d, _ = _k4_rays(baked, w, h, kind, dev)
        kh, kf = isect.intersect_shaded_fm(*args, o, d, 1e-3, None, cull)
        ph, pf = isect.shaded_plain(*args, o, d, 1e-3, None, cull)
        _assert_k4_hits(kh, ph, kf, pf)
        _assert_k4_hits(isect.intersect_closest(*args, o, d, 1e-3, None, cull),
                        isect.closest_plain(*args, o, d, 1e-3, None, cull))
    o, d, tmax = _k4_rays(baked, w, h, "shadow", dev)
    got = isect.occluded(*args, o, d, 1e-3, tmax)
    assert torch.equal(got, isect.occluded_plain(*args, o, d, 1e-3, tmax))
    assert 0 < int(got.sum()) < w * h
    # the extension batch's camera rays are the fourth shaded launch
    assert cuda.LAUNCHES["shaded"] == 4 and cuda.LAUNCHES["closest"] == 3
    assert cuda.LAUNCHES["occluded"] == 1


def test_dense_any_hit_on_the_textured_room(dev):
    """The dense any-hit kernel bit for bit against its plain version on the
    textured room's (342 triangles) est-3-shaped shadow batch: from the
    G-buffer hits toward random points of the room, 30% of the lanes empty,
    NaN lanes; 4 x 101 x 67 = 27,068 rays, no multiple of the kernel's
    block of 256 threads x 4 rays."""
    w, h = 101, 67
    baked = Scene.from_built(textured_room(), aspect=w / h).bake(device=dev)
    args = (baked.tri_pack, baked.n_tris)
    o_g, d_g, _ = _k4_rays(baked, w, h, "gbuffer", dev)
    hit, _ = isect.intersect_shaded_fm(*args, o_g, d_g, 0.0, None, True)
    pos = o_g + hit.t[..., None] * d_g
    g = torch.Generator().manual_seed(11)
    lo, hi = (x[0].to(dev) for x in (baked.data.bvh.node_min, baked.data.bvh.node_max))
    vec = lo + (hi - lo) * torch.rand((4, h, w, 3), generator=g).to(dev) - pos
    length = vec.norm(dim=-1)
    empty = torch.rand((4, h, w), generator=g).to(dev) < 0.3
    tmax = torch.where(empty | ~hit.hit, 0.0, length - 1e-3)
    o, d = pos.expand(4, h, w, 3).clone(), vec / length[..., None]
    o[0, 0, :5, 0] = float("nan")
    d[1, 1, :5, 2] = float("nan")
    cuda.reset_launch_counts()
    got = isect.occluded(*args, o, d, 1e-3, tmax)
    assert cuda.LAUNCHES["occluded"] == 1 and got.numel() % 1024 != 0
    assert torch.equal(got, isect.occluded_plain(*args, o, d, 1e-3, tmax))
    assert 0 < int(got.sum()) < int((tmax > 0).sum())


@pytest.mark.parametrize("w,h", [(64, 48), (50, 37)])
def test_wavefront_frame_matches_plain_chain(dev, w, h):
    baked = _baked(dev, "cornell", w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig(megakernel="off"))
    imgs = []
    for plain in (False, True):
        ch, _, _ = render_frame_fn(replace(baked, plain=plain), baked.data.camera,
                                   AccumState.create(h, w, dev), BMFRState.create(h, w, dev),
                                   0xDEADBEEF, 0x1337, False, cfg)
        imgs.append(ch["BDPT"])
    d = (imgs[0] - imgs[1]).abs()
    assert (d.amax(-1) > 1e-3).float().mean() <= 0.02
    assert d.mean() < 5e-3
    assert abs(imgs[0][..., :3].mean() - imgs[1][..., :3].mean()) < 2e-3


def _scene_rays(baked, w, h, kind, dev, dead=0.3):
    """[h, w] rays of one kind inside the scene's bounds: 'gbuffer' (camera
    rays), 'bounce' (random origins and directions) or 'shadow' (finite
    t_max, a share `dead` of the lanes empty)."""
    if kind == "gbuffer":
        return _k4_rays(baked, w, h, kind, dev)
    g = torch.Generator().manual_seed(11)
    lo, hi = baked.data.bvh.node_min[0], baked.data.bvh.node_max[0]
    o = lo + (hi - lo) * torch.rand((h, w, 3), generator=g)
    d = torch.randn((h, w, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    tmax = None
    if kind == "shadow":
        tmax = torch.where(torch.rand((h, w), generator=g) < dead, 0.0,
                           torch.rand((h, w), generator=g) * float((hi - lo).norm())).to(dev)
    return o.contiguous().to(dev), d.contiguous().to(dev), tmax


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# 50x37 is no multiple of the BVH kernels' 128-thread block, nor is
# 1111x501, whose 556,611 rays are more than twice the persistent kernels'
# resident lanes on an H100 (132 SMs x at most 2,048), so their loops
# refill and drain over two full rounds; the shadow rays with no empty
# lane, and with 30% of them empty (t_max = 0), which the kernels keep out
# of their warps
@pytest.mark.parametrize("dead", [0.0, 0.3])
@pytest.mark.parametrize("w,h", [(64, 36), (50, 37), (1111, 501)])
@pytest.mark.parametrize("scene", ["pink_room", "cornell_icosphere"])
def test_bvh_kernels_match_plain(dev, scene, w, h, dead):
    """t, ids, u, v, the 32 fields and the occlusion bits equal their plain
    versions (the dense programs) bit for bit; on Cornell + icosphere they
    also equal the dense K4 kernels.  The kernels also on lanes with a NaN
    origin or direction."""
    baked = _baked(dev, scene, w, h)
    args = (baked.tri_pack, baked.n_tris)
    rows, pairs = cluster.pair_tables(baked.data.bvh, baked.tri_pack)
    walk_args = (rows, baked.n_tris, pairs)
    cuda.reset_launch_counts()
    for kind, cull in (("gbuffer", True), ("bounce", False), ("shadow", False)):
        o, d, tmax = _scene_rays(baked, w, h, kind, dev, dead)
        kh, kf = cluster.bvh_shaded_fm(*args, rows, pairs, o, d, 1e-3, tmax, cull)
        ph, pf = isect.shaded_plain(*args, o, d, 1e-3, tmax, cull)
        kc = cluster.bvh_closest(*walk_args, o, d, 1e-3, tmax, cull)
        pc = isect.closest_plain(*args, o, d, 1e-3, tmax, cull)
        for got, want in ((kf, pf), (kc.t, pc.t), (kc.tri, pc.tri), (kc.bary_u, pc.bary_u),
                          (kc.bary_v, pc.bary_v), (kh.t, ph.t)):
            assert torch.equal(_bits(got), _bits(want)), kind
        assert int(kh.hit.sum()) > 0
        if scene == "cornell_icosphere":
            assert torch.equal(_bits(kf), _bits(isect.intersect_shaded_fm(
                *args, o, d, 1e-3, tmax, cull)[1]))
    # direction components of +-0 and +-1e-13 from the camera: the walk's
    # 1/d is infinite or huge there
    tiny = torch.tensor([0.0, -0.0, 1e-13, -1e-13], device=dev)
    o, d = _k4_rays(baked, w, h, "gbuffer", dev)[:2]
    dz = d.reshape(-1, 3)[:16].clone()
    dz[:, 0] = tiny.repeat(4)
    dz[:, 1] = tiny.repeat_interleave(4)
    dz = dz / dz.norm(dim=-1, keepdim=True)
    oz = o.reshape(-1, 3)[:16].contiguous()
    for cull in (False, True):
        kc = cluster.bvh_closest(*walk_args, oz, dz, 1e-3, None, cull)
        pc = isect.closest_plain(*args, oz, dz, 1e-3, None, cull)
        assert torch.equal(_bits(kc.t), _bits(pc.t)) and torch.equal(kc.tri, pc.tri)
    o, d, tmax = _scene_rays(baked, w, h, "shadow", dev, dead)
    got = cluster.bvh_occluded(*walk_args, o, d, 1e-3, tmax)
    assert torch.equal(got, isect.occluded_plain(*args, o, d, 1e-3, tmax))
    assert 0 < int(got.sum()) < int((tmax > 0).sum())
    if scene == "cornell_icosphere":
        assert torch.equal(got, isect.occluded(*args, o, d, 1e-3, tmax))
    o, d = o.reshape(-1, 3).clone(), d.reshape(-1, 3).clone()
    o[::7, 1] = float("nan")
    d[3::11, 2] = float("nan")
    got = cluster.bvh_occluded(*walk_args, o, d, 1e-3, tmax.reshape(-1))
    assert torch.equal(got, isect.occluded_plain(*args, o, d, 1e-3, tmax.reshape(-1)))
    assert not got[::7].any() and not got[3::11].any() and got.any()
    for cull in (False, True):
        kh, kf = cluster.bvh_shaded_fm(*args, rows, pairs, o, d, 1e-3, None, cull)
        ph, pf = isect.shaded_plain(*args, o, d, 1e-3, None, cull)
        kc = cluster.bvh_closest(*walk_args, o, d, 1e-3, None, cull)
        assert torch.equal(_bits(kf), _bits(pf))
        assert torch.equal(_bits(kc.t), _bits(ph.t)) and torch.equal(kc.tri, ph.tri)
        assert (kc.tri[::7] == -1).all() and (kc.tri[3::11] == -1).all() and kc.hit.any()
    assert cuda.LAUNCHES["bvh_shaded"] == 5 and cuda.LAUNCHES["bvh_closest"] == 7
    assert cuda.LAUNCHES["bvh_occluded"] == 2


@pytest.mark.parametrize("w,h", [(64, 36), (50, 37)])
def test_textured_wavefront_frame_matches_plain_chain(dev, w, h):
    """pink_room through the wavefront (the BVH kernels and the texture
    taps) equals the frame of the plain chain."""
    baked = _baked(dev, "pink_room", w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig())
    imgs = []
    cuda.reset_launch_counts()
    for plain in (False, True):
        ch, _, _ = render_frame_fn(replace(baked, plain=plain), baked.data.camera,
                                   AccumState.create(h, w, dev), BMFRState.create(h, w, dev),
                                   0xDEADBEEF, 0x1337, False, cfg)
        imgs.append(ch["BDPT"])
    assert cuda.LAUNCHES["bvh_shaded"] == 6 and cuda.LAUNCHES["bvh_occluded"] == 3
    assert torch.equal(imgs[0], imgs[1])


@pytest.mark.parametrize("dtype,rows", [(torch.float32, 4), (torch.float32, 3),
                                        (torch.bfloat16, 4), (torch.bfloat16, 3)])
def test_splat_rows_kernel_bit_equal(dev, dtype, rows):
    """K5 sums each pixel's run in the plain version's order: bit-equal."""
    g = torch.Generator().manual_seed(5)
    m, n_t = 360_000, 50_000
    keys = torch.sort(torch.randint(0, n_t + 2000, (m,), generator=g))[0].to(torch.int32)
    vals = (torch.rand(rows, m, generator=g) * 3.0).to(dtype)
    cuda.reset_launch_counts()
    got = splat_reduce_rows(keys.to(dev), vals.to(dev), n_t).cpu()
    assert cuda.LAUNCHES["splat_rows"] == 1
    want = reduce_rows_plain(keys, vals, n_t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _ragged_updates(case, g):
    """(sorted int32 keys [M], n_targets) of one ragged K5 input; the
    sentinel of a dropped update is n_targets rounded up to 1024."""
    if case == "long_run":  # one pixel's run spans several staged chunks
        n_t = 4000
        keys = torch.cat([torch.randint(0, n_t, (3001,), generator=g),
                          torch.full((5000,), 1234)])
    elif case == "empty_tiles":  # whole 1024-pixel tiles without an update
        n_t = 9 * 1024
        keys = torch.cat([torch.randint(0, 1024, (2001,), generator=g),
                          torch.randint(5 * 1024, 6 * 1024, (1503,), generator=g)])
    elif case == "all_dead":
        n_t = 3000
        keys = torch.full((777,), 3072)
    elif case == "empty":  # M = 0
        n_t = 3000
        keys = torch.zeros((0,), dtype=torch.int64)
    elif case == "ragged_targets":  # n_targets no multiple of the tile
        n_t = 5 * 1024 + 37
        keys = torch.randint(0, n_t, (20_003,), generator=g)
    else:  # the live prefix ends inside a tile, a dead tail behind it
        n_t = 6000
        keys = torch.cat([torch.randint(0, 2500, (9_999,), generator=g),
                          torch.full((3_001,), 6144)])
    return torch.sort(keys)[0].to(torch.int32), n_t


@pytest.mark.parametrize("case", ["long_run", "empty_tiles", "all_dead", "empty",
                                  "ragged_targets", "live_prefix_in_tile"])
@pytest.mark.parametrize("dtype,rows", [(torch.float32, 4), (torch.float32, 3),
                                        (torch.bfloat16, 4), (torch.bfloat16, 3)])
def test_splat_rows_kernel_ragged(dev, dtype, rows, case):
    """K5 bit-equal to its plain version on ragged inputs (M is odd or no
    multiple of 8, so the rows' 16-byte loads meet unaligned heads and
    tails), with one launch."""
    g = torch.Generator().manual_seed(9)
    keys, n_t = _ragged_updates(case, g)
    m = keys.numel()
    vals = (torch.rand(rows, m, generator=g) * 3.0).to(dtype)
    cuda.reset_launch_counts()
    got = splat_reduce_rows(keys.to(dev), vals.to(dev), n_t).cpu()
    assert cuda.LAUNCHES["splat_rows"] == 1
    want = reduce_rows_plain(keys, vals, n_t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case in ("all_dead", "empty"):
        assert not got.any()


@pytest.mark.parametrize("case", ["long_run", "empty_tiles", "all_dead", "empty",
                                  "ragged_targets", "live_prefix_in_tile"])
def test_splat_reduce_kernel_ragged(dev, case):
    """K3 on K5's ragged inputs with rgb8e payloads: one launch; the counts
    equal its plain version's, rgb is bit-equal to a sequential sum in
    sorted order (K5's plain version of the unpacked rows with a count
    alpha) and within K3's bound of the plain version's segment sum."""
    g = torch.Generator().manual_seed(9)
    keys, n_t = _ragged_updates(case, g)
    rgb = torch.rand(keys.numel(), 3, generator=g) * 3.0
    pay = pack_rgb8e(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    cuda.reset_launch_counts()
    got = splat_reduce(keys.to(dev), pay.to(dev), n_t).cpu()
    assert cuda.LAUNCHES["splat_tile"] == 1
    seq = reduce_rows_plain(keys, torch.stack(unpack_rgb8e(pay)), n_t)
    assert torch.equal(got.view(torch.int32), seq.view(torch.int32))
    want = reduce_sorted_plain(keys, pay, n_t)
    assert torch.equal(got[:, 3], want[:, 3])
    torch.testing.assert_close(got[:, :3], want[:, :3], rtol=1e-5, atol=1e-6)
    if case in ("all_dead", "empty"):
        assert not got.any()


@pytest.mark.parametrize("pack,count", [("f32", True), ("f32", False), ("bf16", False),
                                        ("rgb8e", True)])
def test_tiled_splat_matches_plain(dev, pack, count):
    g = torch.Generator().manual_seed(6)
    u, n_t = 3 * 40_000, 30_000
    lin = torch.randint(-100, n_t + 100, (u,), generator=g).to(torch.int32)
    rgb, alpha = torch.rand(u, 3, generator=g), torch.rand(u, generator=g)
    got = scatter_add_rgba_tiled(lin.to(dev), rgb.to(dev), alpha.to(dev), n_t, count,
                                 pack=pack).cpu()
    want = scatter_add_rgba_tiled(lin, rgb, alpha, n_t, count, pack=pack, plain=True)
    if count:
        assert torch.equal(got[:, 3], want[:, 3])
    # K5 is bit-equal to its plain version; rgb8e takes K3, whose plain
    # version sums a run by a segment sum (K3's bound)
    tol = 1e-5 if pack == "rgb8e" else 1e-6
    torch.testing.assert_close(got, want, rtol=tol, atol=1e-6)


def _subpath_state(baked, n, dev):
    g = torch.Generator().manual_seed(8)
    o = torch.rand(n, 3, generator=g) * 0.9 + 0.05
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    seed = rng.tea_init(torch.arange(n), 5)
    term = torch.rand(n, generator=g) < 0.1
    return [x.to(dev) for x in (o, d, torch.ones(n, 3), seed, term)]


@pytest.mark.parametrize("mat_model,faithful", [(0, False), (1, True)])
def test_subpath_kernel_matches_plain(dev, mat_model, faithful):
    """K6 against its plain version on Cornell: fields within atol 5e-4 on
    the lanes active before each bounce; hit, take, terminated and seed
    exact."""
    baked = _baked(dev, "cornell", 64, 64)
    ray = _subpath_state(baked, 50_000, dev)
    cuda.reset_launch_counts()
    kv, kf = subpath.build_subpath(baked.tri_pack, baked.n_tris, *ray, 1e-3, 3, mat_model,
                                   faithful)
    assert cuda.LAUNCHES["subpath"] == 1
    pv, pf = subpath.build_subpath(baked.tri_pack, baked.n_tris, *ray, 1e-3, 3, mat_model,
                                   faithful, plain=True)
    active = ~ray[4]
    for b in range(3):
        for name in ("hit", "take", "is_spec"):
            assert torch.equal(kv[b][name], pv[b][name]), (b, name)
        for name in ("color", "pos", "n", "v", "dif", "spec", "rough", "pdf"):
            torch.testing.assert_close(torch.nan_to_num(kv[b][name][active], nan=-7.0),
                                       torch.nan_to_num(pv[b][name][active], nan=-7.0),
                                       rtol=0, atol=5e-4)
        active = active & pv[b]["take"]
    assert torch.equal(kf["terminated"], pf["terminated"])
    assert torch.equal(kf["seed"], pf["seed"])


@pytest.mark.parametrize("w,h", [(64, 48), (50, 37)])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_textured_frame_kernel_matches_plain(dev, w, h, d):
    """K1's textured variant against its plain version with K1's bounds:
    G-buffer and records <= 1% of pixels off by more than 1e-3, estimator
    rows (NaN as 0) <= 2%, splat ids equal on >= 98% of lanes."""
    baked = _baked(dev, "textured_room", w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig(max_depth=d, defer_textures=True))
    args = frame_mod.frame_args(baked, w, h, 0x1337, pixel_jitter_for_frame(0x1337), cfg)
    assert args.textured
    cuda.reset_launch_counts()
    k = frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack, baked.bvh_nodes)
    assert cuda.LAUNCHES["frame_textured"] == 1 and cuda.LAUNCHES["frame"] == 0
    p = frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack)
    torch.cuda.synchronize()

    frac = _rows_off
    assert frac(k.gbuf, p.gbuf) <= 0.01 and frac(k.vrec, p.vrec) <= 0.01
    for name in ("e1_parts", "e3_parts"):
        assert frac(getattr(k, name), getattr(p, name)) <= 0.02, name
    assert frac(k.splat_rgba.reshape(4 * d, -1), p.splat_rgba.reshape(4 * d, -1)) <= 0.02
    assert float((k.splat_pix == p.splat_pix).float().mean()) >= 0.98


@pytest.mark.parametrize("mode", ["auto", "tiled"])
def test_textured_frame_with_splats_matches_plain_chain(dev, mode):
    """The deferred-texture megakernel path through render_frame_fn: K1's
    textured variant, the replay and the splat ('auto': K2, sort, K3;
    'tiled': K5) against the plain chain, with the image bounds."""
    w, h = 64, 48
    baked = _baked(dev, "textured_room", w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig(defer_textures=True, splat_mode=mode))
    imgs = []
    cuda.reset_launch_counts()
    for plain in (False, True):
        ch, _, _ = render_frame_fn(replace(baked, plain=plain), baked.data.camera,
                                   AccumState.create(h, w, dev), BMFRState.create(h, w, dev),
                                   0xDEADBEEF, 0x1337, False, cfg)
        imgs.append(ch["BDPT"])
    want = {"frame_textured": 1, "frame": 0, "shaded": 0, "occluded": 0,
            "compact": int(mode == "auto"), "splat_tile": int(mode == "auto"),
            "splat_rows": int(mode == "tiled")}
    assert {k: cuda.LAUNCHES[k] for k in want} == want
    d = (imgs[0] - imgs[1]).abs()
    assert (d.amax(-1) > 1e-3).float().mean() <= 0.02
    assert d.mean() < 5e-3
    assert abs(imgs[0][..., :3].mean() - imgs[1][..., :3].mean()) < 2e-3


@pytest.mark.parametrize("w,h", [(64, 36), (1111, 501)])
def test_bvh_kernels_with_order_bit_equal(dev, w, h):
    """The BVH kernels walking pink_room's rays in the direction-sorted
    order (`ops/raysort.sort_order`) and in a random order answer every ray
    as the unordered launch does, bit for bit, and equal the plain versions
    given the same order; each ordered launch counts as its variant."""
    baked = _baked(dev, "pink_room", w, h)
    walk = (baked.bw_rows, baked.n_tris, baked.bvh_pairs)
    g = torch.Generator().manual_seed(3)
    cuda.reset_launch_counts()
    for kind, cull in (("gbuffer", True), ("bounce", False), ("shadow", False)):
        o, d, tmax = _scene_rays(baked, w, h, kind, dev, 0.3)
        n = o.numel() // 3
        for order in (sort_order(o, d, 1e-3, tmax, baked.sort_bounds),
                      torch.randperm(n, generator=g).to(torch.int32).to(dev)):
            shaded = (baked.tri_pack, baked.n_tris, baked.bw_rows, baked.bvh_pairs, o, d, 1e-3,
                      tmax, cull)
            _, kf = cluster.bvh_shaded_fm(*shaded, order=order)
            _, uf = cluster.bvh_shaded_fm(*shaded)
            kc = cluster.bvh_closest(*walk, o, d, 1e-3, tmax, cull, order=order)
            uc = cluster.bvh_closest(*walk, o, d, 1e-3, tmax, cull)
            assert torch.equal(_bits(kf), _bits(uf)), kind
            for k in ("t", "tri", "bary_u", "bary_v"):
                assert torch.equal(_bits(getattr(kc, k)), _bits(getattr(uc, k))), (kind, k)
            if w * h < 10_000:  # the plain version with the order, on the CPU
                pc = cluster.bvh_closest(baked.bw_rows.cpu(), baked.n_tris,
                                         baked.bvh_pairs.cpu(), o.cpu(), d.cpu(), 1e-3,
                                         None if tmax is None else tmax.cpu(), cull,
                                         order=order.cpu())
                assert torch.equal(_bits(kc.t.cpu()), _bits(pc.t))
                assert torch.equal(kc.tri.cpu(), pc.tri)
            if kind == "shadow":
                ko = cluster.bvh_occluded(*walk, o, d, 1e-3, tmax, order=order)
                assert torch.equal(ko, cluster.bvh_occluded(*walk, o, d, 1e-3, tmax))
    assert cuda.LAUNCHES_BY_VARIANT["bvh_shaded[order]"] == 6
    assert cuda.LAUNCHES_BY_VARIANT["bvh_closest[order]"] == 6
    assert cuda.LAUNCHES_BY_VARIANT["bvh_occluded[order]"] == 2


@pytest.mark.parametrize("dtype,rows", [(torch.float32, 4), (torch.float32, 3),
                                        (torch.bfloat16, 4), (torch.bfloat16, 3)])
@pytest.mark.parametrize("case", ["est2", "ragged_targets"])
def test_splat_rows_kernel_segments_bit_equal(dev, dtype, rows, case):
    """K5 with segments=3 (three runs, each sorted) bit-equal to its plain
    version and to K5 on the flat stable sort of the same updates."""
    g = torch.Generator().manual_seed(12)
    n_t = 60_000 if case == "est2" else 5 * 1024 + 37
    run = 3 * n_t // 3 if case == "est2" else 20_003
    keys = torch.randint(0, n_t + 3000, (3, run), generator=g)
    keys[:, ::3] = ((n_t + 1023) // 1024) * 1024  # dead updates
    seg = torch.sort(keys, dim=1, stable=True)[0].reshape(-1).to(torch.int32)
    vals = (torch.rand(rows, seg.numel(), generator=g) * 3.0).to(dtype)
    cuda.reset_launch_counts()
    got = splat_reduce_rows(seg.to(dev), vals.to(dev), n_t, segments=3).cpu()
    assert cuda.LAUNCHES["splat_rows"] == 1
    assert cuda.LAUNCHES_BY_VARIANT["splat_rows[segments]"] == 1
    want = reduce_rows_plain(seg, vals, n_t, segments=3)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    flat_keys, order = torch.sort(seg, stable=True)
    flat = splat_reduce_rows(flat_keys.to(dev), vals[:, order].contiguous().to(dev), n_t).cpu()
    assert torch.equal(got.view(torch.int32), flat.view(torch.int32))


# ------------------------------------------------------------- the BMFR fit
# The fit kernel sums each block's 1,024 products in another order than
# torch: float32 rounding of ~1e-7 relative, amplified by the conditioning
# of a block's near-dependent features.  FIT_ATOL is the bound the CPU
# suite holds the plain fit to against JAX's for the same reason
# (tests/test_torch_bmfr.py PIX_TOL).  A column whose reduced norm lies
# within rounding of the LD-skip threshold 0.01 can be kept on one side and
# skipped on the other; such a block's pixels are left out, and there are
# at most FIT_DIFFERING_BLOCKS of them a frame.
FIT_ATOL = 1e-3
FIT_DIFFERING_BLOCKS = 0.02


@pytest.fixture(scope="module")
def bmfr_inputs(dev):
    """Cornell's BMFR regression inputs at 64x64 and 1280x720: the G-buffer
    channels (plane-major views of K1's rows) and the preprocessed noisy
    image (spp in alpha) of the third frame."""
    out = {}
    for w, h in ((64, 64), (1280, 720)):
        cfg = RenderConfig(width=w, height=h, bmfr=BMFRConfig(
            enabled=True, regression=True, half_screen_debug=False))
        r = Renderer(Scene.from_built(cornell_box(), aspect=w / h).bake(device=dev), cfg)
        r.render(2)
        ch = r.channels
        pos, nrm, alb = (ch[k] for k in ("WorldPosition", "WorldNormal", "MaterialDiffuse"))
        noisy = bmfr.preprocess(r.state.bmfr, pos, nrm, ch["Accumulated"],
                                r.camera.prev_view_proj, cfg.bmfr)[0]
        out[(w, h)] = (pos, nrm, alb, noisy)
    return out


def _fit_blocks(h, w, frame, cfg):
    """Each pixel's block of the frame's window (block by * n_bx + bx), -1
    where the window leaves the pixel; and n_by, n_bx."""
    n_bx, n_by = bmfr._blocks_x(w, cfg), (h + 31) // 32 + 1
    off_x, off_y = bmfr.BLOCK_OFFSETS[frame % 16]
    wy, wx = torch.arange(h)[:, None] - off_y, torch.arange(w)[None, :] - off_x
    inside = (wy >= 0) & (wy < n_by * 32) & (wx >= 0) & (wx < n_bx * 32)
    return torch.where(inside, (wy // 32) * n_bx + wx // 32, -1), n_by, n_bx


def _plain_kept(fn, monkeypatch):
    """`fn()` (a plain LD-skip regression) and each block's kept feature
    columns as bits, read from R (a skipped column's R is zero)."""
    seen, back = {}, bmfr._back_substitute_ld

    def spy(rmat, qty, limit):
        seen["rmat"] = rmat
        return back(rmat, qty, limit)

    with monkeypatch.context() as mp:
        mp.setattr(bmfr, "_back_substitute_ld", spy)
        out = fn()
    kept = (seen["rmat"][:, :, :bmfr.FEATURES] != 0).any(1).int()
    return out, (kept << torch.arange(bmfr.FEATURES, device=kept.device)).sum(1).int()


def _check_fit(got, want, noisy, blocks, differ):
    """Pixels the window leaves equal noisy bit for bit, alpha is noisy's,
    and the fitted rgb is within FIT_ATOL but in the `differ` blocks.
    Returns the worst difference checked."""
    blocks = blocks.to(got.device)
    out = blocks < 0
    assert torch.equal(got[out], noisy[out])
    assert torch.equal(got[..., 3], noisy[..., 3])
    checked = ~out & ~torch.isin(blocks, differ)
    d = (got[..., :3] - want[..., :3]).abs().amax(-1)[checked]
    worst = float(d.max()) if d.numel() else 0.0
    assert worst <= FIT_ATOL, worst
    return worst


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("ld", [True, False])
@pytest.mark.parametrize("size", [(64, 64), (1280, 720)])
def test_bmfr_fit_kernel_matches_plain(dev, bmfr_inputs, monkeypatch, size, ld, half):
    """The fit kernel against `regression_plain` on the same Cornell inputs
    at every one of the 16 frame offsets, both QR variants (LD skip and
    add-noise), half screen on and off: one launch a call, the kept columns
    of every block equal but for a few (FIT_DIFFERING_BLOCKS; none in the
    add-noise variant, which keeps them all), and `_check_fit`."""
    pos, nrm, alb, noisy = bmfr_inputs[size]
    w, h = size
    cfg = BMFRConfig(enabled=True, regression=True, remove_ld_features=ld,
                     half_screen_debug=half, regression_solver="qr")
    worst, n_differ = 0.0, 0
    for frame in range(16):
        fr = torch.tensor(frame, dtype=torch.int32, device=dev)
        blocks, n_by, n_bx = _fit_blocks(h, w, frame, cfg)
        kept = torch.empty(n_by * n_bx, dtype=torch.int32, device=dev)
        cuda.reset_launch_counts()
        got = bmfr._fit_kernel((pos, nrm, alb, noisy), h, noisy, fr, cfg, n_by, 0, False, kept)
        assert cuda.LAUNCHES["bmfr_fit"] == 1
        assert torch.equal(got, bmfr.regression(pos, nrm, alb, noisy, fr, cfg))
        plain = lambda: bmfr.regression_plain(pos, nrm, alb, noisy, fr, cfg)  # noqa: E731
        if ld:
            want, want_kept = _plain_kept(plain, monkeypatch)
        else:
            want, want_kept = plain(), torch.full_like(kept, (1 << bmfr.FEATURES) - 1)
        differ = torch.nonzero(kept != want_kept)[:, 0]
        assert differ.numel() <= (FIT_DIFFERING_BLOCKS * kept.numel() if ld else 0), frame
        n_differ += differ.numel()
        worst = max(worst, _check_fit(got, want, noisy, blocks, differ))
    print(f"{size} ld={ld} half={half}: worst {worst:.3e}, differing blocks {n_differ} "
          f"in 16 frames")


class _RowHalves:
    """Two ranks' row mesh over one image held whole on one device: the
    row exchange and gather of `parallel/sharding.RowMesh`, without a
    process group."""

    def __init__(self, full, rank):
        self.full, self.rank, self.size = full, rank, 2
        self.sub_h = full.shape[0] // 2

    def exchange_rows(self, first, last):
        r0, r1 = self.rank * self.sub_h, (self.rank + 1) * self.sub_h
        above = self.full[r0 - last.shape[0]:r0] if self.rank > 0 else None
        below = self.full[r1:r1 + first.shape[0]] if self.rank < 1 else None
        return above, below

    def gather_rows(self, x):
        return self.full


@pytest.mark.parametrize("ld", [True, False])
def test_bmfr_fit_kernel_sharded_matches_plain(dev, bmfr_inputs, monkeypatch, ld):
    """`regression_sharded` on the two row halves of the 1280x720 Cornell
    inputs: the kernel from each rank's halo-extended rows equals the
    one-device kernel's rows bit for bit (the same blocks from the same
    pixels), and the plain sharded fit within `_check_fit`'s bounds but in
    the blocks whose kept columns differ between the one-device kernel and
    the plain fit."""
    pos, nrm, alb, noisy = bmfr_inputs[(1280, 720)]
    cfg = BMFRConfig(enabled=True, regression=True, remove_ld_features=ld,
                     half_screen_debug=False, regression_solver="qr")
    full = torch.cat([pos[..., :3], nrm[..., :3], alb[..., :3], noisy[..., :3]], -1)
    for frame in (0, 3, 9, 13):
        fr = torch.tensor(frame, dtype=torch.int32, device=dev)
        blocks, n_by, n_bx = _fit_blocks(720, 1280, frame, cfg)
        kept = torch.empty(n_by * n_bx, dtype=torch.int32, device=dev)
        one = bmfr._fit_kernel((pos, nrm, alb, noisy), 720, noisy, fr, cfg, n_by, 0, False, kept)
        if ld:
            _, want_kept = _plain_kept(
                lambda: bmfr.regression_plain(pos, nrm, alb, noisy, fr, cfg), monkeypatch)
            differ = torch.nonzero(kept != want_kept)[:, 0]
        else:
            differ = kept[:0]
        for rank in (0, 1):
            rows = slice(rank * 360, (rank + 1) * 360)
            part = [t[rows] for t in (pos, nrm, alb, noisy)]
            cuda.reset_launch_counts()
            got = bmfr.regression_sharded(*part, fr, cfg, _RowHalves(full, rank))
            assert cuda.LAUNCHES["bmfr_fit"] == 1
            assert torch.equal(got, one[rows])
            want = bmfr.regression_sharded_plain(*part, fr, cfg, _RowHalves(full, rank))
            _check_fit(got, want, part[3], blocks[rows], differ)
