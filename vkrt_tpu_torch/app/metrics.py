"""Per-frame metrics and observability — counterpart of
vkrt_tpu/app/metrics.py.

  * FrameTimer: wall-clock frame ms, FPS and Mrays/s (the BASELINE
    metric). In a pipelined fly-through it times the gap between two
    retired frames, which holds the frame's download to the host and the
    host's own work: a wall time, not a device time.
  * profile: a torch.profiler trace (CPU and, on a CUDA device, CUDA
    activity) of the engine's record_function ranges, written to a
    directory as a Chrome trace.
  * check_finite: the NaN/Inf sentinel (the validation-layer analogue).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List

import numpy as np


@dataclasses.dataclass
class FrameStats:
    frame_ms: float
    rays: int

    @property
    def mrays_per_s(self) -> float:
        return self.rays / (self.frame_ms / 1000.0) / 1e6

    @property
    def fps(self) -> float:
        return 1000.0 / self.frame_ms


class FrameTimer:
    """Collects per-frame wall-clock stats (the reference's FPS counter)."""

    def __init__(self):
        self.frames: List[FrameStats] = []
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self, rays: int) -> FrameStats:
        dt = (time.perf_counter() - self._t0) * 1000.0
        stats = FrameStats(frame_ms=dt, rays=rays)
        self.frames.append(stats)
        return stats

    def summary(self) -> dict:
        """Means over the frames after the first (the steady state)."""
        if not self.frames:
            return {}
        ms = np.array([f.frame_ms for f in self.frames])
        rays = np.array([f.rays for f in self.frames])
        steady = slice(1, None) if len(ms) > 1 else slice(None)
        return {
            "frames": len(ms),
            "frame_ms_mean": float(ms[steady].mean()),
            "frame_ms_min": float(ms.min()),
            "fps_mean": float(1000.0 / ms[steady].mean()),
            "mrays_per_s": float((rays[steady] / ms[steady]).mean() / 1e3),
            "total_rays": int(rays.sum()),
        }


@contextlib.contextmanager
def profile(trace_dir: str | None, device="cuda"):
    """torch.profiler over the block, its Chrome trace written to
    `trace_dir`/trace.json; a no-op when trace_dir is empty."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def check_finite(fb: np.ndarray, label: str = "framebuffer") -> None:
    """NaN/Inf sentinel (validation-layer analogue)."""
    bad = ~np.isfinite(fb)
    if bad.any():
        raise FloatingPointError(
            f"{label}: {bad.sum()} non-finite values (first at "
            f"{np.argwhere(bad)[0].tolist()})")
