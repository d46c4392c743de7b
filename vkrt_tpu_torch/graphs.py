"""Captured frames: the port's counterpart of `jax.jit`'s cache.

The JAX package compiles its work: each frame, with its per-frame accel
update, is one jitted program (vkrt_tpu/wavefront/engine.py:821-823,
raster/pipeline.py:211-217) and a sharded frame one `shard_map` program
(parallel/mesh.py:72-77), so enqueueing a frame costs one dispatch. The
CUDA counterpart is a graph: `FrameGraph` keeps, per static key, one
`torch.cuda.CUDAGraph` with its private memory pool, its static input
tensors and its static outputs.

  * The first call of a key copies the inputs into new static inputs,
    runs the frame once eagerly on a side stream (the warm-up: it builds
    the kernels and fills the allocator, so nothing of that lands in the
    capture), then captures it under `torch.cuda.graph`.
  * Every call copies its inputs into the static inputs (numpy arrays
    through pinned host memory, tensors device to device; enqueued, no
    host wait), replays the graph and returns a fresh copy of the outputs
    (or, for a caller that consumes them at once, the static outputs
    themselves), all on the current stream.

Everything else the frame reads (the scene's tensors, the lights) is
captured by address: a key names those objects by `id()`, and the entry
holds them, so no id is reused while its graph lives.

Which frames are captured (`resolve`): the renderers' `graph` argument,
True, False or None (the default). None captures on a CUDA device and
runs eagerly elsewhere (the CPU tests' path) and for frames that wait on
the host, which no graph can hold; True raises ValueError for those and
off the card; False is always eager. A capture or replay error is raised,
never answered by running eagerly.

Launches: each kernel wrapper counts on the host the launches it makes
(`trace_dense.launches` and the like): every launch of an eager frame,
and of a captured frame its warm-up's and its capture's (which records
the launch into the graph). A replay runs no Python and counts nothing
there. What a replay launches is seen on the card, where torch.profiler
(CUPTI) records every kernel node of a replayed graph by name;
`kernel_launches` reads the port's kernels from such a run.

Tracing (tracing.py): a capture made while tracing is on records the
frame's span table (`tables`), the order of the marks each replay leaves
on the card. The cache's own work is host spans: `vkrt.capture`, and per
call `vkrt.copy_in`, `vkrt.replay` and `vkrt.clone`.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import NamedTuple

import numpy as np
import torch

from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.runtime import map_tensors


def resolve(graph: bool | None, device, host_wait: str = "") -> bool:
    """Whether a frame on `device` is captured and replayed, for the
    renderers' `graph` argument; `host_wait` says why this frame waits on
    the host ('' if it does not). None: captured on a CUDA device unless
    the frame waits on the host. True where the frame cannot be captured
    raises ValueError with the reason. False: eager."""
    on_card = torch.device(device).type == "cuda"
    if graph is False:
        return False
    if graph and not on_card:
        raise ValueError(f"graph=True: a CUDA graph needs a CUDA device, "
                         f"not {torch.device(device)}")
    if graph and host_wait:
        raise ValueError(f"graph=True: {host_wait}, so no CUDA graph can "
                         f"hold the frame (pass graph=None or False)")
    return on_card and not host_wait


# --- launches on the card ----------------------------------------------
# kernels A, A', B, C, D, E, F, G, H, I, J, K and L's three steps: csrc/'s
# __global__ functions, named without their "_kernel" suffix
KERNELS = ("trace_closest", "trace_occluded", "occl_multi", "consolidate",
           "scatter_back", "lane_sort", "lane_unsort", "raster_edge",
           "sah_cut", "raster_sample", "raster_clip", "sample_hits",
           "shade_interp", "shade_lights", "shade_combine")
_KERNEL = re.compile(r"\bvkrt::(\w+)_kernel\b")


def kernel_name(name: str) -> str | None:
    """The port's kernel (one of KERNELS) that a device event of this
    demangled name ran, or None (a PyTorch kernel, a copy)."""
    m = _KERNEL.search(name)
    return m.group(1) if m and m.group(1) in KERNELS else None


def kernel_launches(events) -> dict:
    """{kernel: launches}, for each of KERNELS, among the device events of
    a torch.profiler run (its key_averages(): `key`, `count`,
    `device_type`): what ran on the card, replays included."""
    out = dict.fromkeys(KERNELS, 0)
    for e in events:
        k = kernel_name(e.key)
        if k and e.device_type == torch.autograd.DeviceType.CUDA:
            out[k] += e.count
    return out


# --- the cache ----------------------------------------------------------
class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list          # static input tensors
    outputs: object       # static outputs (tensors in tuples)
    holds: tuple          # what the graph reads by address
    capture_ms: float     # warm-up and capture, host clock
    table: object         # tracing.Table of a traced capture, else None


def _source(x):
    """An input as a tensor to copy from: numpy through pinned memory
    (the copy is then enqueued without a host wait)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
    return x


class FrameGraph:
    """Per static key, one captured CUDA graph (module docstring).

    run(key, fn, inputs, device) replays fn(*static inputs) for `key`,
    capturing it at the key's first call; `key` must name everything fn
    reads other than its inputs, and `holds` those of the objects it reads
    by address. free() drops every graph and its memory pool."""

    def __init__(self):
        self._entries: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def capture_ms(self) -> dict:
        """{key: warm-up + capture ms} of the graphs held."""
        return {k: e.capture_ms for k, e in self._entries.items()}

    def tables(self) -> dict:
        """{key: tracing.Table} of the graphs captured with tracing on."""
        return {k: e.table for k, e in self._entries.items()
                if e.table is not None}

    def run(self, key, fn, inputs, device, holds=(), copy: bool = True):
        """fn(*inputs) through the graph of `key` on CUDA `device`: the
        outputs, cloned unless `copy` is False (then the static outputs,
        which the next replay overwrites)."""
        dev = torch.device(device)
        with torch.cuda.device(dev):
            entry = self._entries.get(key)
            if entry is None:
                with tracing.span("vkrt.capture"):
                    entry = self._entries[key] = _capture(fn, inputs, dev,
                                                          tuple(holds))
            with tracing.span("vkrt.copy_in"):
                for s, x in zip(entry.inputs, inputs):
                    s.copy_(_source(x), non_blocking=True)
            with tracing.span("vkrt.replay"):
                entry.graph.replay()
            if not copy:
                return entry.outputs
            with tracing.span("vkrt.clone"):
                return map_tensors(torch.clone, entry.outputs)

    def free(self) -> None:
        """Drop every graph; their pools go back to the allocator."""
        self._entries.clear()


def _capture(fn, inputs, dev, holds) -> _Entry:
    """Warm up fn on static copies of `inputs`, then capture it (with
    tracing on, recording its span table)."""
    t0 = time.perf_counter()
    static = []
    for x in inputs:
        src = _source(x)
        static.append(torch.empty(src.shape, dtype=src.dtype, device=dev))
        static[-1].copy_(src, non_blocking=True)
    here = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(here)
    with torch.cuda.stream(side):
        fn(*static)                                           # warm-up
    here.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    traced = tracing.record() if tracing.enabled() \
        else contextlib.nullcontext()
    with traced as table, torch.cuda.graph(graph,
                                           stream=torch.cuda.Stream(dev)):
        outputs = fn(*static)
    return _Entry(graph, static, outputs, holds,
                  (time.perf_counter() - t0) * 1e3, table)
