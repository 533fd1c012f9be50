"""K1, K2 and K3 against their plain versions on an H100.

Marked `cuda`: they need the card and skip without one.  On the card:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
from fyp_bidirectionalpathtracer_tpu_torch.ops.compact import compact_live, compact_plain
from fyp_bidirectionalpathtracer_tpu_torch.ops.splat_tile import (
    pack_rgb8e,
    reduce_sorted_plain,
    splat_reduce,
)
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.shared import (
    BDPTConfig,
    RenderConfig,
    cornell_box,
    icosphere,
)

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


@pytest.mark.parametrize("u,frac", [(1, 1.0), (1000, 0.5), (300_001, 0.15)])
def test_compact_kernel_bit_equal(dev, u, frac):
    keys, pay = _updates(u, 5000, frac)
    got = compact_live(keys.to(dev), pay.to(dev), 5000, 5120)
    want = compact_plain(keys, pay, 5000, 5120)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


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
    built = cornell_box()
    if scene == "cornell_icosphere":
        built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
    return Scene.from_built(built, aspect=w / h).bake(device=dev)


# 50x37 is no multiple of the kernel's 128-thread block, so its tail runs
@pytest.mark.parametrize("w,h", [(64, 48), (50, 37)])
@pytest.mark.parametrize("scene", ["cornell", "cornell_icosphere"])
def test_frame_kernel_matches_plain(dev, scene, w, h):
    baked = _baked(dev, scene, w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig())
    args = frame_mod.frame_args(baked, w, h, 0x1337, pixel_jitter_for_frame(0x1337),
                                cfg, splat_rgb8e=True)
    k = frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack)
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


@pytest.mark.parametrize("w,h", [(64, 48), (50, 37)])
def test_frame_with_splats_matches_plain_chain(dev, w, h):
    baked = _baked(dev, "cornell", w, h)
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig())
    k, p = (frame_mod.render_frame_megakernel(
        baked, w, h, 0x1337, pixel_jitter_for_frame(0x1337), cfg, plain=plain)[1]
        for plain in (False, True))
    d = (k - p).abs()
    # the image bounds of test_torch_frame.py
    assert (d.amax(-1) > 1e-3).float().mean() <= 0.02
    assert d.mean() < 5e-3
    assert abs(k[..., :3].mean() - p[..., :3].mean()) < 2e-3
