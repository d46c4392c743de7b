"""Euler-angle fly camera — behavioral port of the reference Camera.

Contract (ref: src/Camera.{hpp,cpp}):
  * pose = position (vec3) + rotation euler (pitch=x, yaw=y, roll=z)
  * basis vectors derived via glm::yawPitchRoll applied to the world axes
    (-Z forward, -X left, +Y up; ref: src/Utils.hpp:35-43, src/Camera.cpp:22-38)
  * view  = lookAt(pos, pos + forward, worldUp)        (src/Camera.cpp:74-78)
  * proj  = perspective(45.0f[rad!], W/H, 0.1, 100); proj[1][1] *= -1
    (the Vulkan Y-flip; src/Camera.cpp:9-14)
The ray-gen consumes only the *inverses* of these matrices
(src/Raytracer.cpp:230-231), exposed here as `view_inverse`/`proj_inverse`.
"""

from __future__ import annotations

import numpy as np

from vkrt_tpu_torch.utils import mathutils as mu

WORLD_FORWARD = np.array([0.0, 0.0, -1.0], dtype=np.float32)
WORLD_LEFT = np.array([-1.0, 0.0, 0.0], dtype=np.float32)
WORLD_UP = np.array([0.0, 1.0, 0.0], dtype=np.float32)

# ref: src/Camera.cpp:9-12 (45.0f is radians to modern glm — quirk preserved)
DEFAULT_FOV = 45.0
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100.0


class Camera:
    def __init__(self, width: int = 1600, height: int = 1200,
                 fov: float = DEFAULT_FOV, near: float = DEFAULT_NEAR,
                 far: float = DEFAULT_FAR):
        self._position = np.zeros(3, dtype=np.float32)
        self._rotation = np.zeros(3, dtype=np.float32)  # (pitch, yaw, roll)
        aspect = float(width) / float(height)
        self._proj = mu.perspective(fov, aspect, near, far)
        self._proj[1, 1] *= -1.0  # Vulkan Y-flip, ref: src/Camera.cpp:14
        self._update_view()

    # -- pose -------------------------------------------------------------
    @property
    def position(self) -> np.ndarray:
        return self._position.copy()

    @property
    def rotation(self) -> np.ndarray:
        return self._rotation.copy()

    def set_position(self, pos) -> None:
        self._position = np.asarray(pos, dtype=np.float32).copy()
        self._update_view()

    def set_rotation(self, rot) -> None:
        self._rotation = np.asarray(rot, dtype=np.float32).copy()
        self._update_view()

    def translate(self, delta) -> None:
        self._position = self._position + np.asarray(delta, dtype=np.float32)
        self._update_view()

    def rotate(self, axis, amount: float) -> None:
        # ref: src/Camera.cpp:58-62 — rotation += axis * amount
        self._rotation = self._rotation + np.asarray(axis, dtype=np.float32) * np.float32(amount)
        self._update_view()

    # -- derived basis (ref: src/Camera.cpp:22-38) ------------------------
    def _rot_matrix(self) -> np.ndarray:
        r = self._rotation
        return mu.yaw_pitch_roll(r[1], r[0], r[2])

    @property
    def forward(self) -> np.ndarray:
        return (self._rot_matrix() @ np.append(WORLD_FORWARD, 0.0).astype(np.float32))[:3]

    @property
    def left(self) -> np.ndarray:
        return (self._rot_matrix() @ np.append(WORLD_LEFT, 0.0).astype(np.float32))[:3]

    @property
    def up(self) -> np.ndarray:
        return (self._rot_matrix() @ np.append(WORLD_UP, 0.0).astype(np.float32))[:3]

    # -- matrices ---------------------------------------------------------
    def _update_view(self) -> None:
        self._view = mu.look_at(self._position, self._position + self.forward, WORLD_UP)

    @property
    def view_matrix(self) -> np.ndarray:
        return self._view.copy()

    @property
    def projection_matrix(self) -> np.ndarray:
        return self._proj.copy()

    @property
    def view_inverse(self) -> np.ndarray:
        return mu.inverse(self._view)

    @property
    def proj_inverse(self) -> np.ndarray:
        return mu.inverse(self._proj)
