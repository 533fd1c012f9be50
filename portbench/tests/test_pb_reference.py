"""The plain reference (`portbench/reference/`): its pieces against plain
scalar arithmetic, its ray queries against testing every triangle, and its
frames against the port's on the CPU at a small size, where both follow
the same semantics (the reference in float64)."""
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


# ------------------------------------------------- ray queries: the culling
ROWS = 256  # rays a block of the tests of every triangle


def _closest_all(scene, o, d, tmin, cull=False):
    """Every ray against every triangle, the nearest hit by t and then the
    first index: what the culled `bdpt.closest` must give."""
    m = o.shape[0]
    tmin = torch.as_tensor(tmin, dtype=o.dtype).expand(m)
    far = torch.full((m,), bdpt.FAR, dtype=o.dtype)
    out = []
    for a in range(0, max(m, 1), ROWS):
        hit, t, u, v = bdpt._tests(scene.v0, scene.e1, scene.e2, o[a:a + ROWS], d[a:a + ROWS],
                                   tmin[a:a + ROWS], far[a:a + ROWS], cull)
        best, k = torch.where(hit, t, torch.full_like(t, math.inf)).min(1)
        rows = torch.arange(k.shape[0])
        out.append((torch.where(torch.isfinite(best), k, torch.full_like(k, -1)), best,
                    u[rows, k], v[rows, k]))
    return tuple(torch.cat(x) for x in zip(*out))


def _blocked_all(scene, o, d, tmin, tmax):
    m = o.shape[0]
    tmin = torch.as_tensor(tmin, dtype=o.dtype).expand(m)
    return torch.cat([bdpt._tests(scene.v0, scene.e1, scene.e2, o[a:a + ROWS], d[a:a + ROWS],
                                  tmin[a:a + ROWS], tmax[a:a + ROWS], False)[0].any(1)
                      for a in range(0, max(m, 1), ROWS)])


def _bits(x):
    return x.view(torch.int64) if x.is_floating_point() else x


def _soup(seed, n_tris):
    """A scene of n_tris random triangles of about 0.1 in the unit cube, the
    last eighth copies of earlier ones (hits at equal t: ties)."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand((n_tris, 1, 3), generator=g, dtype=torch.float64)
    corners = (centers + 0.05 * torch.randn((n_tris, 3, 3), generator=g, dtype=torch.float64))
    copies = n_tris // 8
    corners[-copies:] = corners[torch.randint(0, n_tris - copies, (copies,), generator=g)]
    corners = corners.to(torch.float32).numpy().astype(np.float64)
    normals = np.tile(np.asarray([[0.0, 1.0, 0.0]]), (3 * n_tris, 1))
    mesh = {"positions": corners.reshape(-1, 3), "normals": normals,
            "uvs": np.zeros((3 * n_tris, 2)), "material": 0, "name": "soup",
            "indices": np.arange(3 * n_tris).reshape(-1, 3)}
    arrays = {"meshes": [mesh], "materials": [{"base_color": [0.5, 0.5, 0.5, 1.0]}],
              "lights": [{"pos": (0.5, 2.0, 0.5)}], "camera": {}}
    return Scene.of(arrays, "cpu"), g


def _rays(scene, g, n):
    """Rays from points on the triangles in random directions; rays from
    outside at edge points and corners; rays through a triangle's centre
    within 1e-6 of its plane."""
    f64 = torch.float64
    n_tris = scene.v0.shape[0]

    def pick():
        return torch.randint(0, n_tris, (n,), generator=g)

    k = pick()
    a, b = torch.rand(n, generator=g, dtype=f64), torch.rand(n, generator=g, dtype=f64)
    over = a + b > 1
    a, b = torch.where(over, 1 - a, a), torch.where(over, 1 - b, b)
    o_surface = scene.v0[k] + a[:, None] * scene.e1[k] + b[:, None] * scene.e2[k]
    d_surface = bdpt.unit(torch.randn((n, 3), generator=g, dtype=f64))
    k = pick()
    s = torch.rand((n, 1), generator=g, dtype=f64)
    v0, e1, e2 = scene.v0[k], scene.e1[k], scene.e2[k]
    edge = torch.stack([v0 + s * e1, v0 + s * e2, v0 + e1 + s * (e2 - e1), v0, v0 + e1], 1)
    target = edge[torch.arange(n), torch.randint(0, 5, (n,), generator=g)]
    o_edge = 0.5 + 2.0 * bdpt.unit(torch.randn((n, 3), generator=g, dtype=f64))
    d_edge = bdpt.unit(target - o_edge)
    k = pick()
    centre = scene.v0[k] + (scene.e1[k] + scene.e2[k]) / 3.0
    tilt = (torch.rand((n, 1), generator=g, dtype=f64) - 0.5) * 2e-6
    d_graze = bdpt.unit(bdpt.unit(scene.e1[k]) + tilt * bdpt.unit(bdpt.cross(scene.e1[k],
                                                                            scene.e2[k])))
    o_graze = centre - 0.3 * d_graze
    return torch.cat([o_surface, o_edge, o_graze]), torch.cat([d_surface, d_edge, d_graze])


def _tiles(seed, n=48):
    """n x n right triangles of side 1/n on a grid, each in a plane x, y or
    z = a random constant, so that many corners lie on their group's box's
    edges."""
    g = torch.Generator().manual_seed(seed)
    k = np.arange(n * n)
    a, b = (k // n) / n, (k % n) / n
    h = 1.0 / n
    flat = np.where((k % 2)[:, None, None] == 1,
                    np.stack([np.stack([a, b], 1), np.stack([a + h, b], 1),
                              np.stack([a, b + h], 1)], 1),
                    np.stack([np.stack([a + h, b + h], 1), np.stack([a, b + h], 1),
                              np.stack([a + h, b], 1)], 1))                  # [T, 3, 2]
    c = torch.rand(n * n, generator=g, dtype=torch.float64).numpy()
    corners = np.empty((n * n, 3, 3))
    for axis in range(3):
        m = k % 3 == axis
        corners[m, :, axis] = c[m, None]
        corners[m, :, (axis + 1) % 3] = flat[m, :, 0]
        corners[m, :, (axis + 2) % 3] = flat[m, :, 1]
    corners = corners.astype(np.float32).astype(np.float64)
    mesh = {"positions": corners.reshape(-1, 3), "uvs": np.zeros((3 * n * n, 2)),
            "normals": np.tile(np.asarray([[0.0, 1.0, 0.0]]), (3 * n * n, 1)),
            "material": 0, "name": "tiles", "indices": np.arange(3 * n * n).reshape(-1, 3)}
    arrays = {"meshes": [mesh], "materials": [{"base_color": [0.5, 0.5, 0.5, 1.0]}],
              "lights": [{"pos": (0.5, 2.0, 0.5)}], "camera": {}}
    return Scene.of(arrays, "cpu"), g


def _aimed(g, target):
    """Rays from about ten times the scene's scale away at the targets
    [n, 3], with directions from a hundredth to a hundred long, as the
    shadow rays to a light take them unnormalized, and ranges that end
    within 2% of the target."""
    f64, n = torch.float64, target.shape[0]
    o = 0.5 + 10.0 * bdpt.unit(torch.randn((n, 3), generator=g, dtype=f64))
    length = 10.0 ** (4.0 * torch.rand((n, 1), generator=g, dtype=f64) - 2.0)
    to = target - o
    tmax = (torch.linalg.vector_norm(to, dim=1) / length[:, 0]
            * (0.98 + 0.04 * torch.rand(n, generator=g, dtype=f64)))
    return o, bdpt.unit(to) * length, tmax


def _near(seed):
    """The soup and `_rays`, with ranges from 0.05 to 1.05."""
    scene, g = _soup(seed, 4096)
    o, d = _rays(scene, g, 1000)
    return scene, o, d, 0.05 + torch.rand(o.shape[0], generator=g, dtype=torch.float64)


def _far(seed):
    """The soup, and far rays at its triangles' edge points and corners."""
    scene, g = _soup(seed, 4096)
    n = 2000
    k = torch.randint(0, scene.v0.shape[0], (n,), generator=g)
    s = torch.rand((n, 1), generator=g, dtype=torch.float64)
    v0, e1, e2 = scene.v0[k], scene.e1[k], scene.e2[k]
    edge = torch.stack([v0 + s * e1, v0 + s * e2, v0 + e1 + s * (e2 - e1), v0, v0 + e1], 1)
    return (scene,) + _aimed(g, edge[torch.arange(n), torch.randint(0, 5, (n,), generator=g)])


def _edges(seed):
    """`_tiles`, and far rays at the corners that lie on an edge of their
    group's box, where the box test rounds either way: without the margin,
    one or two in a hundred miss a triangle they hit."""
    scene, g = _tiles(seed)
    corners = torch.stack([scene.v0, scene.v0 + scene.e1, scene.v0 + scene.e2], 1)
    group = torch.empty(scene.v0.shape[0], dtype=torch.int64)
    group[scene.groups.reshape(-1)] = torch.arange(scene.groups.shape[0]).repeat_interleave(
        scene.groups.shape[1])
    lo, hi = scene.box_lo[group][:, None], scene.box_hi[group][:, None]
    on_edge = corners[((corners == lo) | (corners == hi)).sum(-1) >= 2]
    assert on_edge.shape[0] >= 10
    return (scene,) + _aimed(g, on_edge[torch.randint(0, on_edge.shape[0], (4000,), generator=g)])


@pytest.mark.parametrize("seed", [3, 2**31 + 7, 3 * 10**9 + 1])
@pytest.mark.parametrize("rays", [_near, _far, _edges], ids=["near", "far", "edges"])
def test_the_culled_queries_are_every_triangle_s_bit_for_bit(rays, seed):
    scene, o, d, tmax = rays(seed)
    assert scene.groups.shape[0] > 1
    for cull in (False, True):
        got, want = bdpt.closest(scene, o, d, bdpt.MIN_T, cull), _closest_all(
            scene, o, d, bdpt.MIN_T, cull)
        assert int((want[0] >= 0).sum()) > 500
        for x, y in zip(got, want):
            assert torch.equal(_bits(x), _bits(y))
    want = _blocked_all(scene, o, d, bdpt.MIN_T, tmax)
    assert 300 < int(want.sum()) < o.shape[0] - 300
    assert torch.equal(bdpt.blocked(scene, o, d, bdpt.MIN_T, tmax), want)


@pytest.mark.parametrize("length", [1.0, 100.0])
def test_a_ray_within_a_box_s_margin_enters_it(length):
    """A ray that passes outside a group's box by less than its margin
    enters it, by twice the margin not; one whose range ends short of the
    box by less than the margin enters it, by twice not; at any length of
    its direction."""
    scene = Scene.of(scenes.load_arrays(scenes.load_config("cornell")), "cpu")
    assert scene.groups.shape[0] == 1
    hi, lo_z = float(scene.box_hi[0, 0]), float(scene.box_lo[0, 2])
    f64 = torch.float64
    d = torch.tensor([[0.0, 0.0, length]] * 4, dtype=f64)
    start = torch.tensor([[hi, 0.5, -1.0]] * 2 + [[0.5, 0.5, -1.0]] * 2, dtype=f64)
    pad = bdpt._margin(scene, start, d)[:, 0]
    assert (pad > 0).all()
    o = start + torch.stack([torch.tensor([0.5, 2.0, 0.0, 0.0], dtype=f64) * pad,
                             torch.zeros(4, dtype=f64), torch.zeros(4, dtype=f64)], 1)
    tmax = (torch.tensor([9.0, 9.0, lo_z + 1.0, lo_z + 1.0], dtype=f64)
            - torch.tensor([0.0, 0.0, 0.5, 2.0], dtype=f64) * pad) / length
    entered = bdpt._enter(scene, o, d, torch.zeros(4, dtype=f64), tmax)[:, 0]
    assert entered.tolist() == [True, False, True, False]


@pytest.mark.parametrize("n_tris", [4096, 16384])
def test_a_block_holds_at_most_cap_pairs(n_tris, monkeypatch):
    """At a fixed cap, the pairs a query holds do not grow with the
    triangle count: every box test and triangle test stays within it."""
    cap, sizes = 1 << 12, []
    tests, enter = bdpt._tests, bdpt._enter

    def counted_tests(*args):
        out = tests(*args)
        sizes.append(out[1].numel())
        return out

    def counted_enter(*args):
        out = enter(*args)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(bdpt, "CAP", cap)
    monkeypatch.setattr(bdpt, "_tests", counted_tests)
    monkeypatch.setattr(bdpt, "_enter", counted_enter)
    scene, g = _soup(5, n_tris)
    o, d = _rays(scene, g, 300)
    bdpt.closest(scene, o, d, bdpt.MIN_T)
    bdpt.blocked(scene, o, d, bdpt.MIN_T, torch.ones(o.shape[0], dtype=torch.float64))
    assert len(sizes) > 10 and max(sizes[1:]) <= cap  # [0]: triangle 0 for every ray


def test_a_cornell_frame_is_every_triangle_s_bit_for_bit(monkeypatch):
    arrays = scenes.load_arrays(scenes.load_config("cornell"))
    scene = Scene.of(arrays, "cpu")
    pose = ((0.45, 0.55, -1.3), (0.5, 0.45, 0.52), (0.0, 1.0, 0.0))
    cam = Camera.at(arrays["camera"], pose, 64 / 36, "cpu")
    culled = bdpt.frame(scene, cam, 64, 36, 0x1337 + 77, 3)
    monkeypatch.setattr(bdpt, "closest", _closest_all)
    monkeypatch.setattr(bdpt, "blocked", _blocked_all)
    every = bdpt.frame(scene, cam, 64, 36, 0x1337 + 77, 3)
    assert torch.equal(_bits(culled[0]), _bits(every[0]))
    for k in every[1]:
        assert torch.equal(_bits(culled[1][k]), _bits(every[1][k]))
