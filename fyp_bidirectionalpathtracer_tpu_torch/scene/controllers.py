"""Interactive camera controllers (CameraController.cpp rebuild, headless).

The port's own copy of `fyp_bidirectionalpathtracer_tpu/scene/
controllers.py`, over the port's `CameraData` (float32 host tensors) and
`scene/camera.begin_frame`.  The reference drives its camera from window
events through three controllers (Graphics/Camera/CameraController.{h,cpp}):

  * ModelViewCameraController  - orbit around a model center: left-drag
    arcball rotation (project2DCrdToUnitSphere), wheel zoom in 0.2-radius
    steps (CameraController.cpp:55-113)
  * FirstPersonCameraController - WASDQE fly with yaw/pitch from left-drag,
    up locked to +Y (CameraController.cpp:115-262, b6DoF=false)
  * SixDoFCameraController      - the same plus roll from right-drag and a
    free up vector (b6DoF=true)

Windowless: callers feed MouseEvent / KeyEvent records (from a replay
script, say) and call `update(camera, dt)` once a frame, which returns the
new CameraData and whether it moved.  Speed modifiers follow the
reference: ctrl = 0.25x, shift = 10x (CameraController.cpp:158-160).  The
controller math is float64 numpy on the host, between frames.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .camera import begin_frame


# --------------------------------------------------------------- events
@dataclass
class MouseEvent:
    """Subset of Falcor::MouseEvent (Utils/UserInput.h)."""

    type: str                      # 'left_down'|'left_up'|'right_down'|'right_up'|'move'|'wheel'
    pos: tuple = (0.0, 0.0)        # [0,1]^2, y down (screen convention)
    wheel: float = 0.0


@dataclass
class KeyEvent:
    """Subset of Falcor::KeyboardEvent."""

    key: str                       # 'w','a','s','d','q','e'
    pressed: bool = True
    ctrl: bool = False
    shift: bool = False


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _convert_pos(pos):
    """[0,1] screen -> [-1,1] NDC with y flipped (convertCamPosRange,
    CameraController.cpp:37-44)."""
    return np.asarray([pos[0] * 2 - 1, pos[1] * -2 + 1], np.float32)


def _project_to_unit_sphere(xy):
    """project2DCrdToUnitSphere (Utils/Math/FalcorMath.h): map a 2D point
    to the arcball sphere — z from the unit disc, else normalized rim."""
    d2 = xy[0] * xy[0] + xy[1] * xy[1]
    if d2 <= 1.0:
        return np.asarray([xy[0], xy[1], np.sqrt(1.0 - d2)], np.float32)
    inv = 1.0 / np.sqrt(d2)
    return np.asarray([xy[0] * inv, xy[1] * inv, 0.0], np.float32)


def _quat_from_vectors(a, b):
    """createQuaternionFromVectors: shortest-arc rotation a -> b."""
    w = np.cross(a, b)
    q = np.asarray([1.0 + float(np.dot(a, b)), w[0], w[1], w[2]], np.float64)
    n = np.linalg.norm(q)
    if n < 1e-12:  # opposite vectors: 180-degree turn around any orthogonal
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis = axis / np.linalg.norm(axis)
        return np.asarray([0.0, axis[0], axis[1], axis[2]])
    return q / n


def _quat_to_mat(q):
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.eye(3)
    axis = axis / n
    h = angle * 0.5
    return _quat_to_mat(np.asarray(
        [np.cos(h), *(np.sin(h) * axis)], np.float64
    ))


def _f32_on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(like.device)


def _set_pose(camera, pos, target, up):
    """The camera at the new pose, its tensors on the camera's device,
    prevViewProj rolled (begin_frame)."""
    return begin_frame(replace(
        camera,
        pos_w=_f32_on(pos, camera.pos_w),
        target=_f32_on(target, camera.target),
        up=_f32_on(up, camera.up),
    ))


# ----------------------------------------------------------- controllers
class OrbitCameraController:
    """ModelViewCameraController: arcball orbit + wheel zoom
    (CameraController.cpp:46-113)."""

    def __init__(self, center=(0.5, 0.5, 0.5), radius=1.0,
                 distance_in_radii=3.0):
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)
        self.distance = float(distance_in_radii)
        self.rotation = np.eye(3)
        self._last_vec = None
        self._left_down = False
        self._dirty = True

    def set_model_params(self, center, radius, distance_in_radii):
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)
        self.distance = float(distance_in_radii)
        self.rotation = np.eye(3)
        self._dirty = True

    def on_mouse_event(self, ev: MouseEvent) -> bool:
        if ev.type == "wheel":
            self.distance -= ev.wheel * 0.2     # CameraController.cpp:61
            self._dirty = True
            return True
        if ev.type == "left_down":
            self._last_vec = _project_to_unit_sphere(_convert_pos(ev.pos))
            self._left_down = True
            return True
        if ev.type == "left_up":
            was = self._left_down
            self._left_down = False
            return was
        if ev.type == "move" and self._left_down:
            cur = _project_to_unit_sphere(_convert_pos(ev.pos))
            rot = _quat_to_mat(_quat_from_vectors(self._last_vec, cur))
            self.rotation = rot @ self.rotation
            self._last_vec = cur
            self._dirty = True
            return True
        return False

    def update(self, camera, dt: float = 0.0):
        if not self._dirty:
            return camera, False
        self._dirty = False
        # camPos = center + (z axis * R) * radius * distance  (:102-104)
        cam_pos = self.center + (
            np.asarray([0.0, 0.0, 1.0]) @ self.rotation
        ) * self.radius * self.distance
        up = np.asarray([0.0, 1.0, 0.0]) @ self.rotation
        return _set_pose(camera, cam_pos, self.center, up), True


class FirstPersonCameraController:
    """WASDQE fly + left-drag look; up locked to +Y unless six_dof
    (FirstPersonCameraControllerCommon, CameraController.cpp:115-262)."""

    six_dof = False

    def __init__(self, speed: float = 1.0):
        self.speed = speed
        self._keys: set = set()
        self._speed_mod = 1.0
        self._left_down = False
        self._right_down = False
        self._mouse_delta = np.zeros(2, np.float64)
        self._last_pos = None
        self._should_rotate = False

    def on_key_event(self, ev: KeyEvent) -> bool:
        if ev.key not in "wasdqe":
            return False
        if ev.pressed:
            self._keys.add(ev.key)
        else:
            self._keys.discard(ev.key)
        self._speed_mod = 0.25 if ev.ctrl else (10.0 if ev.shift else 1.0)
        return True

    def on_mouse_event(self, ev: MouseEvent) -> bool:
        if ev.type == "left_down":
            self._left_down = True
            self._last_pos = _convert_pos(ev.pos)
            return True
        if ev.type == "left_up":
            self._left_down = False
            return True
        if ev.type == "right_down":
            self._right_down = True
            self._last_pos = _convert_pos(ev.pos)
            return self.six_dof
        if ev.type == "right_up":
            self._right_down = False
            return self.six_dof
        if ev.type == "move" and (self._left_down or self._right_down):
            cur = _convert_pos(ev.pos)
            if self._last_pos is not None:
                self._mouse_delta = (cur - self._last_pos).astype(np.float64)
            self._last_pos = cur
            self._should_rotate = True
            return True
        return False

    def update(self, camera, dt: float):
        pos = _host64(camera.pos_w)
        target = _host64(camera.target)
        up = (_host64(camera.up)
              if self.six_dof else np.asarray([0.0, 1.0, 0.0]))
        dirty = False

        if self._should_rotate:
            view = target - pos
            view = view / np.linalg.norm(view)
            if self._left_down:
                side = np.cross(view, up / np.linalg.norm(up))
                rot_y = _axis_angle(side, self._mouse_delta[1] * self._speed_mod)
                view = view @ rot_y      # v * mat(q) (CameraController.cpp:186)
                up = up @ rot_y
                rot_x = _axis_angle(up, self._mouse_delta[0] * self._speed_mod)
                view = view @ rot_x
                target = pos + view
                dirty = True
            if self.six_dof and self._right_down:
                rot = _axis_angle(view, self._mouse_delta[0] * self._speed_mod)
                up = up @ rot
                dirty = True
            self._should_rotate = False

        if self._keys:
            # reference axes: A=+x("Left"? the cpp maps A->Right=-x), kept
            # verbatim: W/S = +-viewDir, A/D = +-sideway, E/Q = +-up
            # (CameraController.cpp:216-241)
            move = np.zeros(3)
            move[2] += 1 if "w" in self._keys else 0
            move[2] -= 1 if "s" in self._keys else 0
            move[0] += 1 if "d" in self._keys else 0
            move[0] -= 1 if "a" in self._keys else 0
            move[1] += 1 if "e" in self._keys else 0
            move[1] -= 1 if "q" in self._keys else 0
            view = target - pos
            view = view / np.linalg.norm(view)
            side = np.cross(view, up / np.linalg.norm(up))
            cur = self._speed_mod * self.speed * dt
            pos = pos + move[2] * cur * view + move[0] * cur * side \
                + move[1] * cur * up
            target = pos + view
            dirty = True

        if not dirty:
            return camera, False
        return _set_pose(camera, pos, target, up), True


class SixDoFCameraController(FirstPersonCameraController):
    """FirstPerson + roll (right-drag) + free up vector
    (FirstPersonCameraControllerCommon<true>)."""

    six_dof = True
