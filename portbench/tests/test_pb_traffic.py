"""The traffic generator: the same poses for a seed, the same views in
another order for another seed, walks at their step, inside their regions;
one pool size a mix, whatever the configuration."""
import math

import numpy as np

import scenes
from traffic import Plan, load_traffic

SEED = 2**31 + 977


def test_views_repeat_for_a_seed_and_reorder_for_another():
    cfg, mix = scenes.load_config("cornell"), load_traffic("progressive")
    a, b, c = Plan(cfg, mix, SEED), Plan(cfg, mix, SEED), Plan(cfg, mix, SEED + 1)
    fpv, w = mix["frames_per_view"], mix["warmup_frames"]
    starts = [w + k * fpv for k in range(2 * mix["pool_size"])]
    views_a = [a.pose(i) for i in starts]
    assert views_a == [b.pose(i) for i in starts]
    assert a.first_index == b.first_index
    views_c = [c.pose(i) for i in starts]
    assert sorted(views_a) == sorted(views_c) and views_a != views_c
    assert all(a.moves(i) for i in starts) and a.moves(0)
    assert not any(a.moves(i) for i in range(w + 1, w + fpv))
    assert a.view_start(w + 5) == w and a.view_start(w + fpv + 7) == w + fpv
    assert a.pose(w + 1) == a.pose(w + fpv - 1)
    size = mix["pool_size"]
    assert len(set(views_a)) == size and views_a[:size] == views_a[size:2 * size]


def test_cornell_views_face_the_open_side():
    cfg, mix = scenes.load_config("cornell"), load_traffic("progressive")
    plan, region = Plan(cfg, mix, SEED), cfg["views"]
    c = np.asarray(region["center"])
    for k in range(mix["pool_size"]):
        pos = np.asarray(plan.pose(mix["warmup_frames"] + k * mix["frames_per_view"])[0])
        d = pos - c
        r = np.linalg.norm(d)
        assert region["radius"][0] <= r <= region["radius"][1]
        angle = math.degrees(math.acos(np.dot(d / r, region["axis"])))
        assert angle <= region["max_angle_deg"] + 1e-9


def test_cornell_walk_swings_about_half_a_degree_a_frame():
    cfg, mix = scenes.load_config("cornell"), load_traffic("interactive")
    plan = Plan(cfg, mix, SEED)
    assert all(plan.moves(i) for i in range(10))
    c = np.asarray(cfg["walk"]["center"])
    d = np.asarray([plan.pose(i)[0] for i in range(1000)]) - c
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    step = np.degrees(np.arccos(np.clip(np.sum(d[1:] * d[:-1], 1), -1, 1)))
    assert 0.4 < step.mean() < 0.7
    assert Plan(cfg, mix, SEED).pose(17) == plan.pose(17)


def test_the_pool_size_is_the_mix_s_alone():
    cfg, mix = scenes.load_config("cornell"), load_traffic("progressive")
    cfg = dict(cfg, views=dict(cfg["views"], pool_size=2))
    plan = Plan(cfg, mix, SEED)
    starts = [mix["warmup_frames"] + k * mix["frames_per_view"] for k in range(mix["pool_size"])]
    assert len({plan.pose(i) for i in starts}) == mix["pool_size"]
