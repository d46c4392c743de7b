"""The fly-through generator: frames from a traffic mix's data file.

A mix (`traffic/<name>.json` with `"generator": "fly"`) names a scripted
camera path (the reference's WASD/ZC fly controls held for so many
frames each), the frames kept in flight and, optionally, a per-frame
instance transform (`sway`: a rotation about the world's y axis through
the origin by amplitude * sin(2 pi k / period) at path frame k). The
path loops, and every run starts at path frame 0 whatever its seed, so
a window of a given length renders the same frames on every seed (a
seeded start changed the work: the part of a loop past the last whole
one held other frames, and 2% more or fewer rays); the seed picks which
of them are checked (run.py, check.py).

A generator module exposes `Frames(mix, width, height, seed)`: called
with i, frame i of a run as (path frame, Pose, transform or None);
`len()` the loop's length; `at(k)` path frame k as (Pose, transform).

The camera arithmetic is the benchmark's own copy of the port's
`app/camera.py`, `app/flythrough.py` and `utils/mathutils.py` (glm's
yawPitchRoll, lookAt and perspective, the reference's 45.0 "degrees"
passed as radians included); tests/test_copies.py holds it bit for bit
against the port's `camera_path`.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

WORLD_FORWARD = np.array([0.0, 0.0, -1.0], dtype=np.float32)
WORLD_LEFT = np.array([-1.0, 0.0, 0.0], dtype=np.float32)
WORLD_UP = np.array([0.0, 1.0, 0.0], dtype=np.float32)


class Pose(NamedTuple):
    """What a frame reads of its camera (the program's Camera has both)."""
    proj_inverse: np.ndarray   # f32[4,4]
    view_inverse: np.ndarray   # f32[4,4]


def _yaw_pitch_roll(yaw, pitch, roll):
    ch, sh = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cb, sb = np.cos(roll), np.sin(roll)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = ch * cb + sh * sp * sb
    m[1, 0] = sb * cp
    m[2, 0] = -sh * cb + ch * sp * sb
    m[0, 1] = -ch * sb + sh * sp * cb
    m[1, 1] = cb * cp
    m[2, 1] = sb * sh + ch * sp * cb
    m[0, 2] = sh * cp
    m[1, 2] = -sp
    m[2, 2] = ch * cp
    m[3, 3] = 1.0
    return m


def _look_at(eye, center, up):
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


def _perspective(fovy, aspect, z_near, z_far):
    tan_half = np.tan(np.float32(fovy) / np.float32(2.0))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    return m


def _inverse(m):
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def _axis(rot, world):
    m = _yaw_pitch_roll(rot[1], rot[0], rot[2])
    return (m @ np.append(world, 0.0).astype(np.float32))[:3]


def camera_poses(mix: dict, width: int, height: int) -> List[Pose]:
    """One Pose per frame of the mix's path, in path order."""
    proj = _perspective(mix["fov"], float(width) / float(height),
                        mix["near"], mix["far"])
    proj[1, 1] *= -1.0                  # Vulkan's y flip
    proj_inv = _inverse(proj)
    pos = np.asarray(mix["start_position"], dtype=np.float32).copy()
    rot = np.asarray(mix["start_rotation"], dtype=np.float32).copy()
    dt = float(mix["dt"])
    tr = mix["translation_speed"] * dt
    rs = mix["rotation_speed"] * dt
    moves = {"w": (WORLD_FORWARD, 1.0), "s": (WORLD_FORWARD, -1.0),
             "a": (WORLD_LEFT, 1.0), "d": (WORLD_LEFT, -1.0),
             "e": (WORLD_UP, 1.0), "q": (WORLD_UP, -1.0)}
    turns = {"z": [0.0, 1.0, 0.0], "c": [0.0, -1.0, 0.0]}
    poses = []
    for keys, frames in mix["path"]:
        for _ in range(frames):
            for k in "wsadeq":
                if k in keys:
                    world, sign = moves[k]
                    step = _axis(rot, world) * tr
                    pos = pos + (step if sign > 0 else -_axis(rot, world)
                                 * tr)
            for k in "zc":
                if k in keys:
                    rot = rot + np.asarray(turns[k], np.float32) * \
                        np.float32(rs)
            fwd = _axis(rot, WORLD_FORWARD)
            view = _look_at(pos, pos + fwd, WORLD_UP)
            poses.append(Pose(proj_inv.copy(), _inverse(view)))
    return poses


def sway(mix: dict, k: int):
    """The instance transform of path frame k (f32[4,4]), or None."""
    sw = mix.get("sway")
    if not sw:
        return None
    a = sw["amplitude_rad"] * np.sin(2.0 * np.pi * k / sw["period_frames"])
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s, 0.0], [0.0, 1.0, 0.0, 0.0],
                     [-s, 0.0, c, 0.0], [0.0, 0.0, 0.0, 1.0]], np.float32)


class Frames:
    """Frame i of a run: (path frame, Pose, transform or None), looping
    from path frame 0 (module docstring); `seed` is not used."""

    def __init__(self, mix: dict, width: int, height: int, seed: int):
        self.mix = mix
        self.poses = camera_poses(mix, width, height)
        self.transforms = [sway(mix, k) for k in range(len(self.poses))]

    def __len__(self) -> int:
        return len(self.poses)

    def at(self, k: int):
        return self.poses[k], self.transforms[k]

    def __call__(self, i: int):
        k = i % len(self.poses)
        return (k, *self.at(k))
