"""Spans and counters of the port's frames that come back on every replay
of a captured CUDA graph: the counterpart of the JAX package's
`jax.named_scope` ranges, which survive `jit`.

A graph replay runs no Python, so a `torch.profiler.record_function`
range opened while a frame is captured never shows again. Here a span
also leaves marks on the card:

  * `span(name, device)`: a context. On the host it opens
    `record_function(name)` while a profiler is active or tracing is on,
    and is a no-op otherwise. While tracing is on (`on()`) and `device` is
    a CUDA device, it enqueues one mark where it opens and one where it
    closes: an empty kernel, `vkrt::span_mark_kernel` (csrc/span_mark.cu).
    Captured, a mark is a kernel node of the graph, so every replay runs
    it and the profiler times it on the clock of every other kernel and
    host range. Each entry and exit also goes into the `Table` being
    recorded (`record()`; graphs.FrameGraph records one per capture) as
    (name, parent, opening). A span without a device is a host range
    only (the scheduler's and the graph cache's `vkrt.*` spans).
  * `count(name, mask)`: while tracing is on, adds `mask.sum()` into an
    int64 slot of the device's counter tensor. A graph captures the add
    by the tensor's address, so each replay adds again; `counters()`
    reads them, `reset()` zeroes them.
  * `lanes(name, n)`: the lanes a kernel wrapper launches, a host
    constant recorded into the table at capture (a replay launches the
    same).
  * `profile_ops(prof)`: a profile's device ops and host events, with
    their correlation ids (a graph replay's kernels share its launch's).
  * `device_spans(ops, table)`: per replayed frame, each span's interval
    and the device time of the kernels directly inside it, from those
    device ops and the graph's table: on one stream the kernels between
    two marks belong to the innermost span open between them. A replay
    the profiler dropped a record of is left out.

With tracing off nothing is marked, counted or allocated, so a captured
graph is the same as without this module. The renderers put `enabled()`
into their graph keys: a traced frame is a graph of its own.

`listen(fn)` calls fn(name, opening) at every device span's entry and
exit, tracing on or off: tools that time spans by CUDA events or on the
host (chip_smoke.py's EventRanges, tools/port_host_enqueue.py) hook in
there, on eager frames.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
from torch.profiler import record_function

MARK = "span_mark_kernel"     # the mark, as the profiler names its kernel
MAX_COUNTERS = 256            # int64 slots of a device's counter tensor

_on = 0                       # nesting depth of on()
_listeners: list = []
_tables: list = []            # the tables being recorded, innermost last
_counters: dict = {}          # torch.device -> i64[MAX_COUNTERS]
_slots: dict = {}             # counter name -> slot


def enabled() -> bool:
    """Whether tracing is on (a graph key holds this)."""
    return _on > 0


@contextlib.contextmanager
def on():
    """Tracing on inside the block: spans mark the card, counters count,
    the renderers capture graphs of their own."""
    global _on
    _on += 1
    try:
        yield
    finally:
        _on -= 1


@contextlib.contextmanager
def listen(fn: Callable):
    """fn(name, opening: bool) at each device span's entry and exit
    inside the block."""
    _listeners.append(fn)
    try:
        yield fn
    finally:
        _listeners.remove(fn)


class Table:
    """What a function did under tracing, in order: `spans`, each device
    span's entry and exit as (name, parent or None, opening); `lanes`,
    (kernel wrapper, innermost span, lanes launched)."""

    def __init__(self):
        self.spans: list = []
        self.lanes: list = []
        self._open: list = []

    def innermost(self):
        return self._open[-1] if self._open else None

    def _event(self, name: str, opening: bool) -> None:
        if opening:
            self.spans.append((name, self.innermost(), True))
            self._open.append(name)
        else:
            self._open.pop()
            self.spans.append((name, self.innermost(), False))


@contextlib.contextmanager
def record():
    """A new Table that the block's spans and lanes go into while tracing
    is on."""
    table = Table()
    _tables.append(table)
    try:
        yield table
    finally:
        _tables.remove(table)


def _mark(dev: torch.device) -> None:
    from vkrt_tpu_torch import kernels
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.vkrt_span_mark(torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "span_mark")


class _Span:
    __slots__ = ("name", "device", "args", "scope")

    def __init__(self, name, device, args):
        self.name, self.device, self.args = name, device, args
        self.scope = None

    def __enter__(self):
        if _on or torch.autograd._profiler_enabled():
            self.scope = record_function(self.name, self.args)
            self.scope.__enter__()
        if self.device is not None:
            for fn in _listeners:
                fn(self.name, True)
            if _on:
                if _tables:
                    _tables[-1]._event(self.name, True)
                if self.device.type == "cuda":
                    _mark(self.device)
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            if _on:
                if self.device.type == "cuda":
                    _mark(self.device)
                if _tables:
                    _tables[-1]._event(self.name, False)
            for fn in _listeners:
                fn(self.name, False)
        if self.scope is not None:
            self.scope.__exit__(*exc)
        return False


_NOTHING = contextlib.nullcontext()


def span(name: str, device=None, args: str | None = None):
    """A span named `name` over the block (module docstring): a host
    range, and with `device` (a torch.device) the device span that marks
    the card while tracing is on. `args` goes with the host range."""
    if not (_on or _listeners or torch.autograd._profiler_enabled()):
        return _NOTHING
    return _Span(name, None if device is None else torch.device(device),
                 args)


def count(name: str, mask: torch.Tensor) -> None:
    """While tracing is on, add mask.sum() to the counter `name` on the
    mask's device (enqueued, no host wait)."""
    if not _on:
        return
    dev = mask.device
    c = _counters.get(dev)
    if c is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tracing.count: a device's first count "
                               "cannot be captured (run the function once "
                               "before the capture)")
        c = _counters[dev] = torch.zeros(MAX_COUNTERS, dtype=torch.int64,
                                         device=dev)
    slot = _slots.setdefault(name, len(_slots))
    if slot >= MAX_COUNTERS:
        raise RuntimeError(f"tracing.count: more than {MAX_COUNTERS} "
                           f"counters")
    c.narrow(0, slot, 1).add_(mask.sum())


def lanes(name: str, n: int) -> None:
    """While tracing is on, record that the kernel wrapper `name`
    launches over `n` lanes, under the innermost span of the table."""
    if _on and _tables:
        t = _tables[-1]
        t.lanes.append((name, t.innermost(), int(n)))


def counters(device=None) -> dict:
    """{name: count} summed over the devices (or of `device`); waits for
    the card."""
    devs = [torch.device(device)] if device is not None else list(_counters)
    out = dict.fromkeys(_slots, 0)
    for d in devs:
        if d in _counters:
            vals = _counters[d].cpu().tolist()
            for name, slot in _slots.items():
                out[name] += vals[slot]
    return out


def reset() -> None:
    """Zero every counter (enqueued on each device's current stream)."""
    for c in _counters.values():
        c.zero_()


class Span(NamedTuple):
    """One interval of a span in one replayed frame: its parent span, the
    device start of its opening mark and end of its closing mark (the
    ops' clock), the device ms and number of the ops directly inside it
    (not in a child span), and the frame's group (its replay's launch's
    correlation id)."""
    name: str
    parent: str | None
    start: float
    end: float
    self_ms: float
    ops: int
    group: object = None


def profile_ops(prof):
    """(device ops, host events) of a torch.profiler profile, each as
    (name, start s, end s, correlation id). Every kernel of a graph
    replay carries its cudaGraphLaunch's correlation id. The profiler
    mirrors each host range onto the device's timeline; those mirrors
    are left out of the device ops, which keeps kernels, copies and
    sets."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        x = (e.name(), s, s + e.duration_ns() * 1e-9, e.correlation_id())
        (dev if e.device_type() == cuda else host).append(x)
    named = {h[0] for h in host}
    return [o for o in dev if o[0] not in named], host


def device_spans(ops, table) -> list:
    """Per replayed frame, in start order on the one stream, the Spans
    of a graph whose span table is `table` (a Table or its `spans`
    list), from a profile's device ops (`profile_ops`). The ops of one
    replay share its launch's correlation id, its group: each group
    whose marks (MARK in the name) are len(table) is a frame, and every
    other op of it between two marks counts to the innermost span open
    between them (ops outside every span: none). A group with fewer
    marks (a replay the profiler dropped a record of, eager launches,
    copies between frames) is left out. Raises ValueError only where
    the marks do not nest as the table does."""
    entries = table.spans if isinstance(table, Table) else list(table)
    n = len(entries)
    by_group: dict = {}
    for o in sorted(ops, key=lambda o: o[1]):
        by_group.setdefault(o[3], []).append(o)
    runs = [g for g in by_group.values()
            if n and sum(MARK in o[0] for o in g) == n]
    return [_frame_spans(run, entries, f) for f, run in enumerate(runs)]


def _frame_spans(ops, entries, f) -> list:
    """The Spans of one frame's ops (sorted; its marks len(entries))."""
    at = [i for i, o in enumerate(ops) if MARK in o[0]]
    group = ops[0][3]
    n = len(entries)
    rows, stack = [], []
    for j, ((name, parent, opening), i) in enumerate(zip(entries, at)):
        if opening:
            stack.append(len(rows))
            rows.append([name, parent, ops[i][1], None, 0.0, 0, group])
        else:
            row = rows[stack.pop()] if stack else None
            if row is None or row[0] != name:
                raise ValueError(f"frame {f}: {name!r} closes where "
                                 f"{row and row[0]!r} is open")
            row[3] = ops[i][2]
        if stack and j + 1 < n:
            row = rows[stack[-1]]
            for o in ops[i + 1:at[j + 1]]:
                row[4] += (o[2] - o[1]) * 1e3
                row[5] += 1
    return [Span(*r) for r in rows]
