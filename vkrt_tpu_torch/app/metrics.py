"""Per-frame metrics and observability — counterpart of
vkrt_tpu/app/metrics.py.

  * FrameTimer: wall-clock frame ms, FPS and Mrays/s (the BASELINE
    metric). In a pipelined fly-through it times the gap between two
    retired frames, which holds the frame's download to the host and the
    host's own work: a wall time, not a device time.
  * profile: tracing on (vkrt_tpu_torch/tracing.py) and a torch.profiler
    trace (CPU and, on a CUDA device, CUDA activity) over the block,
    written to a directory as a Chrome trace (trace.json), with
    spans.json beside it: per frame the device ms of each span of the
    frame's captured graph (read from its marks), and the counters.
  * check_finite: the NaN/Inf sentinel (the validation-layer analogue).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
def profile(trace_dir: str | None, device="cuda", tables=None):
    """Tracing on and torch.profiler over the block, its Chrome trace
    written to `trace_dir`/trace.json and `spans_json` of it to
    `trace_dir`/spans.json; a no-op when trace_dir is empty. `tables`
    returns the span tables of the graphs the block replayed (e.g.
    `lambda: renderer.graphs.tables().values()`)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    from vkrt_tpu_torch import tracing

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with tracing.on():
        tracing.reset()
        with torch.profiler.profile(activities=acts) as prof:
            yield
        counts = tracing.counters()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    ops, _ = tracing.profile_ops(prof)
    out = spans_json(ops, list(tables()) if tables else [], counts)
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump(out, f, indent=1)


def spans_json(ops, tables, counters: dict) -> dict:
    """What the CLI writes to spans.json: for each replayed frame (in
    stream order; `tracing.device_spans`, which leaves out the eager
    warm-up of a capture and a replay the profiler dropped a mark of)
    the device ms of each span (`self_ms` summed over its intervals: the
    kernels in it and not in a child span) and `frame_ms`, the frame
    span's device time; the counters summed over every frame the block
    traced, and the lanes a frame that kernels A, A' and B launch, by
    kernel and span.
    Device ops are (name, start s, end s, correlation id), as
    `tracing.profile_ops` gives them. With no traced graph, or more than
    one, `frames` is empty."""
    from vkrt_tpu_torch import tracing

    frames, lanes = [], {}
    if len(tables) == 1:
        table = tables[0]
        for spans in tracing.device_spans(ops, table):
            ms: dict = {}
            for s in spans:
                ms[s.name] = ms.get(s.name, 0.0) + s.self_ms
            whole = [s for s in spans if s.parent is None]
            frames.append({"frame_ms": sum((s.end - s.start) * 1e3
                                           for s in whole),
                           "spans": ms})
        for kernel, inside, n in table.lanes:
            key = f"{kernel}@{inside}"
            lanes[key] = lanes.get(key, 0) + n
    return {"frames": frames, "counters": counters,
            "lanes_per_frame": lanes, "traced_graphs": len(tables)}


def check_finite(fb: np.ndarray, label: str = "framebuffer") -> None:
    """NaN/Inf sentinel (validation-layer analogue)."""
    bad = ~np.isfinite(fb)
    if bad.any():
        raise FloatingPointError(
            f"{label}: {bad.sum()} non-finite values (first at "
            f"{np.argwhere(bad)[0].tolist()})")
