"""The plain reference (`portbench/reference/`): its pieces against plain
scalar arithmetic, and its frames against the port's on the CPU at a small
size, where both follow the same semantics (the reference in float64)."""
import math

import numpy as np
import pytest
import torch

import check
import run
import scenes
from reference import bdpt, bmfr, render, rng
from reference.scene import Camera, Scene
from traffic import Plan, load_traffic

from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene as PortScene
from fyp_bidirectionalpathtracer_tpu_torch.utils import config as port_config

W, H = 48, 27


def _tea_scalar(v0, v1):
    s, m = 0, 0xFFFFFFFF
    for _ in range(16):
        s = (s + 0x9E3779B9) & m
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & m) ^ ((v1 + s) & m)
                    ^ (((v1 >> 5) + 0xC8013EA4) & m))) & m
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & m) ^ ((v0 + s) & m)
                    ^ (((v0 >> 5) + 0x7E95761E) & m))) & m
    return v0


def test_the_streams_are_the_scalar_tea_and_lcg():
    stream = rng.pixel_stream(7, 3, 0x1337 + 2**31, "cpu")
    for p in (0, 5, 20):
        s = _tea_scalar(p, (0x1337 + 2**31) & 0xFFFFFFFF)
        assert int(stream.s[p]) == s
    first = stream.draw()
    s = (_tea_scalar(20, (0x1337 + 2**31) & 0xFFFFFFFF) * 1664525 + 1013904223) & 0xFFFFFFFF
    assert float(first[20]) == (s & 0xFFFFFF) / 2**24


def test_the_camera_is_the_ports():
    cfg = scenes.load_config("cornell")
    arrays = scenes.load_arrays(cfg)
    port = Renderer(PortScene.from_built(scenes.port_scene(arrays), aspect=W / H).bake(
        device="cpu"), run.render_config(port_config, cfg, load_traffic("progressive"), W, H))
    pose = ((0.4, 0.6, -1.2), (0.5, 0.45, 0.52), (0.0, 1.0, 0.0))
    port.set_camera_pose(*pose)
    cam = Camera.at(arrays["camera"], pose, W / H, "cpu")
    c = port.camera
    for ours, theirs in ((cam.u, c.camera_u), (cam.v, c.camera_v), (cam.w, c.camera_w),
                         (cam.view_proj, c.view_proj), (cam.view_proj, c.prev_view_proj)):
        assert torch.allclose(ours, theirs.double(), rtol=1e-5, atol=1e-5)


def test_the_fit_is_each_block_s_least_squares():
    g = torch.Generator().manual_seed(5)
    h, w = 40, 70
    pos = torch.rand((h, w, 4), generator=g, dtype=torch.float64) * 3.0
    norm = torch.nn.functional.normalize(torch.randn((h, w, 4), generator=g,
                                                     dtype=torch.float64), dim=-1)
    albedo = 0.2 + 0.8 * torch.rand((h, w, 4), generator=g, dtype=torch.float64)
    noisy = torch.rand((h, w, 4), generator=g, dtype=torch.float64)
    out = bmfr.fit(pos, norm, albedo, noisy, frame=3)
    ox, oy = bmfr.OFFSETS[3]
    # the block holding image pixel (0, 0), solved by numpy's lstsq
    ys = [abs(y) - 1 if y < 0 else y for y in range(oy, oy + 32)]
    xs = [abs(x) - 1 if x < 0 else x for x in range(ox, ox + 32)]
    blk = lambda a: a[ys][:, xs].reshape(1024, -1).numpy()  # noqa: E731
    p, n, alb, c = blk(pos)[:, :3], blk(norm)[:, :3], blk(albedo)[:, :3], blk(noisy)[:, :3]
    scaled = np.concatenate([p, p * p], 1)
    lo, span = scaled.min(0), scaled.max(0) - scaled.min(0)
    scaled = np.where(span > 1.0, (scaled - lo) / np.where(span > 1.0, span, 1.0), scaled - lo)
    x = np.concatenate([np.ones((1024, 1)), n, scaled], 1)
    wts = np.linalg.lstsq(x, c / alb, rcond=None)[0]
    want = alb[-oy * 32 - ox] * np.maximum(x @ wts, 0.0)[-oy * 32 - ox]
    assert np.allclose(out[0, 0, :3].numpy(), want, rtol=1e-7, atol=1e-9)


def test_a_dependent_feature_is_dropped():
    h, w = 32, 32
    pos = torch.zeros((h, w, 4), dtype=torch.float64)   # p and p^2 constant: dropped
    norm = torch.zeros((h, w, 4), dtype=torch.float64)
    norm[..., 1] = 1.0
    albedo = torch.ones((h, w, 4), dtype=torch.float64)
    noisy = torch.full((h, w, 4), 0.25, dtype=torch.float64)
    out = bmfr.fit(pos, norm, albedo, noisy, frame=0)
    assert torch.allclose(out[..., :3], torch.full((h, w, 3), 0.25, dtype=torch.float64))


def test_a_shadow_ray_ends_before_its_target():
    scene = Scene.of(scenes.load_arrays(scenes.load_config("cornell")), "cpu")
    o = torch.tensor([[0.5, 0.5, 0.1], [0.5, 0.05, 0.3]], dtype=torch.float64)
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], dtype=torch.float64)
    assert bdpt.blocked(scene, o, d, 1e-3, torch.tensor([0.5, 0.1], dtype=torch.float64)).tolist() \
        == [False, True]
    tri, t, _, _ = bdpt.closest(scene, o, d, 1e-3)
    assert tri.tolist()[0] >= 0 and math.isclose(float(t[0]), 0.5) and math.isclose(
        float(t[1]), 0.05)


def _port_frames(cfg, mix, plan, n):
    pcfg = run.render_config(port_config, cfg, mix, W, H)
    arrays = scenes.load_arrays(cfg)
    r = Renderer(PortScene.from_built(scenes.port_scene(arrays), aspect=W / H).bake(
        device="cpu"), pcfg)
    r.state.frame_index = plan.first_index
    before = None
    for i in range(n):
        if plan.moves(i):
            r.set_camera_pose(*plan.pose(i))
        before = r.state.bmfr
        r.render_frame()
    return r, before, arrays


@pytest.mark.parametrize("seed", [2**31 + 5, 3 * 10**9 + 11])
def test_a_progressive_frame_is_the_ports(seed):
    cfg, mix = scenes.load_config("cornell"), load_traffic("progressive")
    plan = Plan(cfg, mix, seed)
    r, _, arrays = _port_frames(cfg, mix, plan, 5)
    start = plan.view_start(4)
    ch = render.frames(Scene.of(arrays, "cpu"), arrays["camera"], dict(cfg, width=W, height=H),
                       [plan.pose(i) for i in range(start, 5)], plan.first_index + start)
    px, mad = check.image_numbers(r.channels["Accumulated"], ch["Accumulated"])
    assert px <= 0.01 and mad <= 5e-3, (px, mad)


def test_a_denoised_frame_and_its_history_are_the_ports():
    cfg, mix = scenes.load_config("cornell"), load_traffic("interactive")
    plan = Plan(cfg, mix, 2**31 + 21)
    r, before, arrays = _port_frames(cfg, mix, plan, 4)
    hist = check.history_of(before, "cpu", torch.float64)
    ch = render.frames(Scene.of(arrays, "cpu"), arrays["camera"], dict(cfg, width=W, height=H),
                       [plan.pose(3)], plan.first_index + 3, hist, denoise=True)
    assert ch["history"].frame == int(r.state.bmfr.frame_number) == 4
    for got, want in ((r.channels["PipelineOutput"], ch["PipelineOutput"]),
                      (r.state.bmfr.prev_noisy, ch["history"].noisy),
                      (r.state.bmfr.prev_pos, ch["history"].pos)):
        px, mad = check.image_numbers(got, want)
        assert px <= 0.01 and mad <= 5e-3, (px, mad)
