"""Keyframed object and camera paths (Falcor ObjectPath semantics).

The port's own copy of `fyp_bidirectionalpathtracer_tpu/scene/
animation.py`, numpy line for line, so that `Path.sample` and
`rigid_transform_at` give the JAX package's float32 bits for any time
(`tests/test_torch_scene_io.py`).  The reference's .fscene paths animate
the camera with (time, pos, target, up) keyframes, looping, advanced by
Scene::update each frame (Scene.cpp:106-125); between keyframes the
interpolation is linear, as Falcor's default.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Keyframe:
    time: float
    pos: np.ndarray
    target: np.ndarray
    up: np.ndarray


@dataclass
class Path:
    name: str = "path"
    loop: bool = True
    frames: list = field(default_factory=list)  # list[Keyframe], time-sorted
    # (type, name) pairs from the .fscene attached_objects list
    # (SceneImporter.cpp:776, kAttachedObjects): 'camera' | 'model_instance'
    # | 'light'
    attached: list = field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.frames[-1].time if self.frames else 0.0

    def sample(self, t: float):
        """Interpolate (pos, target, up) at time t (loops if configured)."""
        if not self.frames:
            raise ValueError("empty path")
        if len(self.frames) == 1:
            f = self.frames[0]
            return f.pos, f.target, f.up
        dur = self.duration
        if self.loop and dur > 0:
            t = t % dur
        t = min(max(t, self.frames[0].time), dur)
        times = [f.time for f in self.frames]
        hi = int(np.searchsorted(times, t, side="right"))
        hi = min(max(hi, 1), len(self.frames) - 1)
        lo = hi - 1
        f0, f1 = self.frames[lo], self.frames[hi]
        span = max(f1.time - f0.time, 1e-9)
        a = (t - f0.time) / span
        lerp = lambda x, y: x * (1 - a) + y * a  # noqa: E731
        up = lerp(f0.up, f1.up)
        up = up / (np.linalg.norm(up) + 1e-20)
        return lerp(f0.pos, f1.pos), lerp(f0.target, f1.target), up


def path_from_dict(d: dict) -> Path:
    frames = [
        Keyframe(
            time=float(f["time"]),
            pos=np.asarray(f["pos"], np.float32),
            target=np.asarray(f["target"], np.float32),
            up=np.asarray(f.get("up", (0, 1, 0)), np.float32),
        )
        for f in d.get("frames", [])
    ]
    frames.sort(key=lambda f: f.time)
    attached = [(a.get("type", "camera"), a.get("name", ""))
                for a in d.get("attached_objects", [])]
    return Path(name=d.get("name", "path"), loop=bool(d.get("loop", False)),
                frames=frames, attached=attached)


def rigid_transform_at(path: Path, t: float):
    """(R [3,3], translation [3]) placing an attached object at time t.

    Falcor moves attached IMovableObjects with move(position, target, up)
    (MovableObject semantics): the orientation looks from pos toward target
    with the given up; the rigid transform maps the object's rest frame
    (forward -z, up +y, origin 0) to the keyframed pose."""
    pos, target, up = path.sample(t)
    fwd = target - pos
    n = np.linalg.norm(fwd)
    if n < 1e-12:
        return np.eye(3, dtype=np.float32), pos.astype(np.float32)
    fwd = fwd / n
    right = np.cross(fwd, up)
    rn = np.linalg.norm(right)
    if rn < 1e-12:
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        rn = np.linalg.norm(right)
    right = right / rn
    true_up = np.cross(right, fwd)
    # columns: rest +x -> right, rest +y -> true_up, rest -z -> fwd
    r = np.stack([right, true_up, -fwd], axis=1).astype(np.float32)
    return r, pos.astype(np.float32)
