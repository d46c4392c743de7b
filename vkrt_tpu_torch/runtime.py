"""Device runtime — counterpart of vkrt_tpu/runtime.py.

Sets the float32 policy (no TF32 anywhere: the JAX package lost image
quality twice to reduced-precision matmul defaults), reports the device
a run used, so every number printed beside it names its card, builds the
CUDA kernels up front (`initialize`; the nvcc build is what the JAX
package's compilation cache is there), and paces frames in flight
(`FrameScheduler`, the reference's 3 swapchain images and their fences).
"""

from __future__ import annotations

import collections
import subprocess
from typing import Callable

import torch

from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.utils.log import get_logger

log = get_logger("vkrt_tpu_torch.runtime")


def exact_f32() -> None:
    """Keep float32 exact on the card: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nvidia_smi_line() -> str:
    """`name, power.limit` of every card as nvidia-smi prints them, or
    'not available' where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip()


def device_info(device) -> dict:
    """Platform/device report for `device` (a torch.device or string)."""
    device = torch.device(device)
    info = {
        "platform": device.type,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "num_devices": torch.cuda.device_count() if device.type == "cuda" else 1,
    }
    if device.type == "cuda":
        info["device_kind"] = torch.cuda.get_device_name(device)
        info["nvidia_smi"] = nvidia_smi_line()
    else:
        info["device_kind"] = "cpu"
    return info


def initialize(device="cuda") -> dict:
    """One-call runtime start for `device`: the float32 policy, and on a
    CUDA device the kernels built (or found built) before the first
    frame. Raises on "cuda" without a card: nothing falls back to the
    CPU unless the caller asks for it. Returns the device report."""
    device = torch.device(device)
    exact_f32()
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but torch sees no "
                               "CUDA card; pass device 'cpu' to run the "
                               "plain versions on the CPU")
        b = kernels.build()
        kernels.library()
        log.info("kernels: %s (%.1f s, cached %s)", b.path, b.seconds,
                 b.cached)
    info = device_info(device)
    log.info("runtime: %s x%d (%s)", info["device_kind"],
             info["num_devices"], info["platform"])
    return info


def map_tensors(fn, out):
    """fn applied to every tensor of a (nested) tuple, NamedTuple or list;
    anything else is kept as it is."""
    if torch.is_tensor(out):
        return fn(out)
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(map_tensors(fn, x) for x in out))
    if isinstance(out, (tuple, list)):
        return type(out)(map_tensors(fn, x) for x in out)
    return out


def _tensors(out):
    """The tensors of a (nested) tuple or list."""
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)


def _to_pinned(t):
    """A copy of `t` to pinned host memory, enqueued on the current stream
    without a host wait."""
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=True).copy_(t, non_blocking=True)


class FrameScheduler:
    """Frames in flight over the card's asynchronous queue.

    submit(fn, *args) enqueues a frame (fn returns device tensors without
    waiting), then its copy to pinned host memory, and records a CUDA
    event behind the copy. When more than `inflight` frames are pending,
    the oldest frame's event is waited on and its outputs are returned as
    numpy arrays, so the host waits for that frame alone and not for the
    frames queued after it: the role of the reference's per-image fence
    wait (Context.cpp:141-152). On the CPU the outputs are already there.
    drain() retires the rest, oldest first."""

    def __init__(self, inflight: int = 3):   # swapchain depth
        self.inflight = inflight
        self._queue: collections.deque = collections.deque()
        self._next = 0

    def submit(self, fn: Callable, *args):
        """Enqueue one frame; returns (index, numpy outputs) of the frame
        this submission retired, or None."""
        out = fn(*args)
        event = None
        if any(t.is_cuda for t in _tensors(out)):
            out = map_tensors(_to_pinned, out)
            event = torch.cuda.Event()
            event.record()
        self._queue.append((self._next, out, event))
        self._next += 1
        if len(self._queue) > self.inflight:
            return self._retire()
        return None

    def _retire(self):
        idx, out, event = self._queue.popleft()
        if event is not None:
            event.synchronize()
        return idx, map_tensors(torch.Tensor.numpy, out)

    def drain(self):
        while self._queue:
            yield self._retire()

