"""What decides `correct`: the program's frames against reference.py's.

Each compared frame is one that the timed window itself produced (its
u8 framebuffer and its ray count, as FrameScheduler handed them back);
the frames are drawn from the seed among those the window retired. The
reference renders the same pose, under the same instance transform,
from the benchmark's own scene data. Four numbers, the worst over the
compared frames, each held to its limit in cells/<workload>.json:

  px_off_share   share of pixels whose largest channel differs by more
                 than OFF_LSB of 255: a different hit, shadow or bounce
                 (rounding in the shading moves a channel by 1 or 2)
  px_off_shallow the same share over the pixels whose reference path
                 traced at most SHALLOW closest-hit rays: past two
                 bounces, float32 rounding in the reflected directions
                 grows until two sound tracers part on about 1% of a
                 depth-4 frame, which a limit on px_off_share must allow
  px_mean_abs    mean absolute difference over every channel, in 1/255
  rays_rel_gap   |program rays - reference rays| / reference rays
"""

from __future__ import annotations

import numpy as np

OFF_LSB = 8
SHALLOW = 2
NUMBERS = ("px_off_share", "px_off_shallow", "px_mean_abs",
           "rays_rel_gap")


def compare(fb, rays, ref_fb, ref_rays, ref_segments) -> dict:
    """The numbers of one frame (u8[H,W,3] each, ray counts, and the
    reference's closest-hit rays per pixel u8[H,W])."""
    fb = np.asarray(fb)
    ref_fb = np.asarray(ref_fb)
    if fb.shape != ref_fb.shape:
        return {k: float("inf") for k in NUMBERS}
    d = np.abs(fb.astype(np.int16) - ref_fb.astype(np.int16))
    off = d.max(axis=-1) > OFF_LSB
    shallow = np.asarray(ref_segments) <= SHALLOW
    return {"px_off_share": float(off.mean()),
            "px_off_shallow": float(off[shallow].mean()) if shallow.any()
            else 0.0,
            "px_mean_abs": float(d.mean()),
            "rays_rel_gap": abs(int(rays) - int(ref_rays))
            / max(int(ref_rays), 1)}


def worst(readings) -> dict:
    """Each number's largest reading over frames."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def report(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}, the result line's last key."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}


def sample(kept, n: int, seed: int):
    """n of the kept frame indices, drawn from the seed."""
    kept = sorted(kept)
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(kept), size=min(n, len(kept)), replace=False)
    return sorted(kept[int(i)] for i in pick)
