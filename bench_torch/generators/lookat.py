"""The look-at generator: frames from keyframed eye and target points.

A mix (`traffic/<name>.json` with `"generator": "lookat"`) lists
`keyframes`, each [eye xyz, target xyz, frames] in world units: the
camera is at the keyframe's eye, looking at its target, at its first
path frame, and glides (eye and target linearly) to the next keyframe's
over its `frames` path frames; the last keyframe glides back to the
first, so the path loops. The mix also gives `fov`, `near`, `far`,
`inflight` and `sway` as a `fly` mix does. Every run starts at path
frame 0 whatever its seed, as fly.py's do.

The camera arithmetic is fly.py's own (`_look_at`, `_perspective`, the
Vulkan y flip, `_inverse`, the `sway` transform), imported, not copied:
a keyframe's eye and target that a fly path frame also has give that
frame's Pose bit for bit (tests/test_torch_morton_cells.py).

`Frames(mix, width, height, seed)`: called with i, frame i of a run as
(path frame, Pose, transform or None); `len()` the loop's length;
`at(k)` path frame k as (Pose, transform). `seed` is not used.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import spec

fly = spec.module("generators", "fly", Path(__file__).resolve().parent.parent)


def camera_poses(mix: dict, width: int, height: int):
    """One fly.Pose per path frame of the mix's keyframes, in path
    order."""
    proj = fly._perspective(mix["fov"], float(width) / float(height),
                            mix["near"], mix["far"])
    proj[1, 1] *= -1.0                  # Vulkan's y flip
    proj_inv = fly._inverse(proj)
    keys = [(np.asarray(e, np.float32), np.asarray(t, np.float32), int(n))
            for e, t, n in mix["keyframes"]]
    poses = []
    for i, (eye, target, n) in enumerate(keys):
        eye1, target1, _ = keys[(i + 1) % len(keys)]
        for j in range(n):
            s = np.float32(j / n)
            e = eye + (eye1 - eye) * s
            t = target + (target1 - target) * s
            view = fly._look_at(e, t, fly.WORLD_UP)
            poses.append(fly.Pose(proj_inv.copy(), fly._inverse(view)))
    return poses


class Frames:
    """Frame i of a run: (path frame, Pose, transform or None), looping
    from path frame 0 (module docstring); `seed` is not used."""

    def __init__(self, mix: dict, width: int, height: int, seed: int):
        self.mix = mix
        self.poses = camera_poses(mix, width, height)
        self.transforms = [fly.sway(mix, k) for k in range(len(self.poses))]

    def __len__(self) -> int:
        return len(self.poses)

    def at(self, k: int):
        return self.poses[k], self.transforms[k]

    def __call__(self, i: int):
        k = i % len(self.poses)
        return (k, *self.at(k))
