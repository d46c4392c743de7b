"""glm-compatible matrix math (numpy, float32).

The reference builds its camera matrices with glm (yawPitchRoll / lookAt /
perspective, ref: src/Camera.cpp:6-78) and hands their *inverses* to the
ray-gen shader (ref: src/Raytracer.cpp:230-231, shaders/shader.rgen:36-38).
To reproduce frames bit-faithfully we re-implement exactly the glm formulas
(right-handed, GL depth convention) in numpy.

Convention: matrices here are numpy [row, col]; glm stores column-major
(M[col][row]) so glm's `Result[c][r] = x` appears here as `m[r, c] = x`.
Vectors multiply on the right: y = M @ x, matching glm's `M * v`.
"""

from __future__ import annotations

import numpy as np


def yaw_pitch_roll(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """glm::yawPitchRoll — rotation from euler angles (Y * P * R order).

    Mirrors the exact element formulas glm uses so the camera basis vectors
    (forward/left/up, ref: src/Camera.cpp:22-38) match to float32 precision.
    """
    ch, sh = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cb, sb = np.cos(roll), np.sin(roll)

    m = np.zeros((4, 4), dtype=np.float32)
    # column 0
    m[0, 0] = ch * cb + sh * sp * sb
    m[1, 0] = sb * cp
    m[2, 0] = -sh * cb + ch * sp * sb
    # column 1
    m[0, 1] = -ch * sb + sh * sp * cb
    m[1, 1] = cb * cp
    m[2, 1] = sb * sh + ch * sp * cb
    # column 2
    m[0, 2] = sh * cp
    m[1, 2] = -sp
    m[2, 2] = ch * cp
    m[3, 3] = 1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt (right-handed), ref usage: src/Camera.cpp:74-78."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)

    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)

    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """glm::perspective, right-handed, depth in [-1, 1] (GL default).

    NOTE the reference passes `45.0f` directly (src/Camera.cpp:9-13); modern
    glm interprets that as *radians*, so the argument wraps — tan(22.5 rad)
    ≈ 0.5574 — giving an effective vertical fov of ≈58.3°. We reproduce the
    formula verbatim, quirk included, so frames match.
    """
    tan_half = np.tan(np.float32(fovy) / np.float32(2.0))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    return m


def inverse(m: np.ndarray) -> np.ndarray:
    """Matrix inverse in float32 (ref: glm::inverse at src/Raytracer.cpp:230-231)."""
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    return v / np.linalg.norm(v)
