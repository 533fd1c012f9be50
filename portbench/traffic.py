"""The one traffic generator: camera poses a frame, from a traffic mix's
parameters (`traffic/<name>.json`), a configuration's regions (`views`,
`walk` in `configs/<name>.json`) and the run's seed.

Every mix is a closed loop of one viewer, who enqueues frame after frame.

- `"mode": "views"`: still views of `frames_per_view` frames each; the
  camera jumps to the next viewpoint after them.  The viewpoints are a pool
  of `pool_size` drawn from the configuration's `views` region with the
  mix's own `pool_seed`, the same pool for every run seed; the run seed
  sets their order.
- `"mode": "walk"`: the camera moves every frame along the configuration's
  `walk` loop (an orbit swing or an ellipse) by its step; the seed sets the
  starting point on the loop and the direction.  Every seed walks the same
  loop.

`first_index`, the renderer's first frame index (its sampler seeds), comes
from the seed too.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
UP = (0.0, 1.0, 0.0)


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names itself {mix.get('name')!r}")
    return mix


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _basis(axis):
    """Orthonormal (right, up, axis) with `up` near +y."""
    w = _unit(axis)
    right = _unit(np.cross(np.asarray(UP), w))
    return right, np.cross(w, right), w


def _hemisphere_view(region, rng):
    right, up, axis = _basis(region["axis"])
    c = np.asarray(region["center"], np.float64)
    cos_max = math.cos(math.radians(region["max_angle_deg"]))
    cos_t = 1.0 - rng.random() * (1.0 - cos_max)       # uniform on the cap
    sin_t = math.sqrt(max(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * math.pi * rng.random()
    d = axis * cos_t + (right * math.cos(phi) + up * math.sin(phi)) * sin_t
    r0, r1 = region["radius"]
    pos = c + d * (r0 + (r1 - r0) * rng.random())
    target = c + (rng.random(3) * 2.0 - 1.0) * region["target_jitter"]
    return pos, target


def _box_view(region, rng):
    lo, hi = np.asarray(region["lo"]), np.asarray(region["hi"])
    tlo, thi = np.asarray(region["target_lo"]), np.asarray(region["target_hi"])
    for _ in range(10000):
        pos = lo + (hi - lo) * rng.random(3)
        target = tlo + (thi - tlo) * rng.random(3)
        clear = all(np.linalg.norm(pos - np.asarray(a[:3])) > a[3] for a in region["avoid"])
        if clear and np.linalg.norm(target - pos) >= region["min_view_distance"]:
            return pos, target
    raise ValueError("the views region leaves no viewpoint clear of its `avoid` spheres")


def view_pool(region: dict, pool_seed: int, size: int):
    rng = np.random.default_rng(pool_seed)
    make = {"hemisphere": _hemisphere_view, "box": _box_view}[region["shape"]]
    return [make(region, rng) for _ in range(size)]


def _walk_pose(walk: dict, s: float):
    """The pose at arc parameter s (radians of the loop's phase)."""
    if walk["shape"] == "orbit":
        right, up, axis = _basis(walk["axis"])
        yaw = math.radians(walk["yaw_deg"]) * math.sin(s)
        pitch = math.radians(walk["pitch_deg"]) * math.sin(2.0 * s)
        d = (axis * math.cos(yaw) + right * math.sin(yaw)) * math.cos(pitch) \
            + up * math.sin(pitch)
        c = np.asarray(walk["center"], np.float64)
        return c + d * walk["radius"], c
    if walk["shape"] == "ellipse":
        c = np.asarray(walk["center"], np.float64)
        a, b = walk["semi_axes"]
        pos = c + np.asarray([a * math.cos(s), 0.0, b * math.sin(s)])
        return pos, np.asarray(walk["target"], np.float64)
    raise ValueError(f"unknown walk shape {walk['shape']!r}")


def _walk_rate(walk: dict) -> float:
    """Phase advance a frame that moves the camera by the walk's step."""
    if walk["shape"] == "orbit":
        # the yaw swing's mean angular speed is 4 * yaw a period of 2 pi
        return 2.0 * math.pi * walk["step_deg"] / (4.0 * walk["yaw_deg"])
    a, b = walk["semi_axes"]
    circumference = math.pi * (3 * (a + b) - math.sqrt((3 * a + b) * (a + 3 * b)))
    return 2.0 * math.pi * walk["step"] / circumference


class Plan:
    """The poses of one run: `pose(i)` for the run's i-th frame, `moves(i)`
    whether the camera moves at frame i.  The mix's `warmup_frames` come
    first; under views they take a view of their own, so that the window's
    first frame starts a view (`view_start`)."""

    def __init__(self, config: dict, mix: dict, seed: int):
        rng = np.random.default_rng(seed)
        self.mode = mix["mode"]
        self.warmup = int(mix["warmup_frames"])
        self.first_index = int(rng.integers(0, 1 << 24))
        if self.mode == "views":
            pool = view_pool(config["views"], mix["pool_seed"], mix["pool_size"])
            order = rng.permutation(len(pool))
            self._poses = [_pose(*pool[k]) for k in order]
            self.frames_per_view = int(mix["frames_per_view"])
        elif self.mode == "walk":
            self._walk = config["walk"]
            self._rate = _walk_rate(self._walk) * (1.0 if rng.random() < 0.5 else -1.0)
            self._phase = 2.0 * math.pi * rng.random()
        else:
            raise ValueError(f"unknown traffic mode {self.mode!r}")

    def view_of(self, i: int) -> int:
        """The view of run frame i (-1: the warm-up's)."""
        return (i - self.warmup) // self.frames_per_view

    def view_start(self, i: int) -> int:
        """The run frame at which frame i's camera was last set."""
        if self.mode == "walk":
            return i
        return self.warmup + self.view_of(i) * self.frames_per_view if i >= self.warmup else 0

    def moves(self, i: int) -> bool:
        return self.mode == "walk" or i == 0 or (
            i >= self.warmup and (i - self.warmup) % self.frames_per_view == 0)

    def pose(self, i: int):
        if self.mode == "views":
            return self._poses[self.view_of(i) % len(self._poses)]
        return _pose(*_walk_pose(self._walk, self._phase + self._rate * i))


def _pose(pos, target):
    return (tuple(float(x) for x in pos), tuple(float(x) for x in target), UP)
