"""The benchmark's arithmetic: percentiles and rates over a window, the
device's busy time as a union of intervals, the idle gaps and what the
host was doing in them, and the names of the port's kernels.

Pure Python on plain numbers, so tests/test_stats.py checks it on the
CPU with synthetic inputs.
"""

from __future__ import annotations

import math
import re
import statistics

# The port's hand-written kernels (csrc/'s __global__ functions, demangled
# as vkrt::<name>_kernel), a copy of the program's graphs.KERNELS, and
# the layer each belongs to. A kernel that is none of them is PyTorch's.
KERNEL_LAYER = {
    "trace_closest": "rt", "trace_occluded": "rt", "occl_multi": "rt",
    "consolidate": "reorder", "scatter_back": "reorder",
    "lane_sort": "reorder", "lane_unsort": "reorder",
    "raster_edge": "raster",
}
_KERNEL = re.compile(r"\bvkrt::(\w+)_kernel\b")
_COPY = re.compile(r"^(Memcpy|Memset)|^cudaMem", re.IGNORECASE)


def layer_of(name: str) -> str:
    """'rt', 'reorder' or 'raster' for a port kernel, 'copy' for a memcpy
    or memset, else 'torch' (a PyTorch kernel)."""
    m = _KERNEL.search(name)
    if m and m.group(1) in KERNEL_LAYER:
        return KERNEL_LAYER[m.group(1)]
    if _COPY.search(name):
        return "copy"
    return "torch"


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank: the smallest
    value with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])


def rate(count: float, seconds: float) -> float:
    """count per second over a window of `seconds`."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds


def spread(values) -> float:
    """Distance between the first and third quartile over the median
    (statistics.quantiles, n=4), the measure the bounds are set from."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals):
    """Merged (start, end) intervals, sorted, of possibly overlapping
    ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Time inside [lo, hi] covered by at least one interval."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


def idle_share(intervals, lo: float, hi: float) -> float:
    """Share (0-1) of the window [lo, hi] in which no interval runs."""
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) gaps of [lo, hi] between merged intervals."""
    out, at = [], lo
    for s, e in union(intervals):
        if s > at and s > lo:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


def host_label(host, t0: float, t1: float) -> str:
    """What the host was doing in (t0, t1): the shortest host range
    (name, start, end) that covers the gap's middle, or 'host: none'."""
    mid = 0.5 * (t0 + t1)
    best = None
    for name, s, e in host:
        if s <= mid <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "host: none"


def top(pairs, n: int = 10):
    """The n largest (name, value) pairs by value."""
    return sorted(pairs, key=lambda p: -p[1])[:n]


def by_name(ops):
    """{name: total duration} over (name, start, end) device ops."""
    out: dict = {}
    for name, s, e in ops:
        out[name] = out.get(name, 0.0) + (e - s)
    return out
