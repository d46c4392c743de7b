"""The traced run's window of marked frames, read by the span and counter
metrics (metrics/shade_ms.py, sample_ms.py, accel_span_ms.py,
rt_live_share.py, queue_wait_ms.py, retire_lag_ms.py).

Under the program's `tracing.on()` (vkrt_tpu_torch/tracing.py):

  1. run.py's `trace_path_frames` go once through a fresh FrameScheduler
     at the cell's `inflight`: this pass captures the frame's marked
     graph (a graph of its own: tracing is in the renderer's graph key)
     and warms it up;
  2. the counters are zeroed;
  3. the same frames go through again under torch.profiler, with a
     clock probe (`to_host_clock`) before each submit;
  4. the counters are read, and `tracing.device_spans` splits the
     profile's device ops (`tracing.profile_ops`) into each replayed
     frame's spans by the marks (a replay's kernels share its launch's
     correlation id; a frame the profiler dropped a mark of is left out
     of the span metrics).

Done once a run (memoized on `run`). None where the run has no traced
window, is not on a card, or the program has no tracing module, or no
marked graph: a parent without tracing reads nothing and raises nothing.
"""

from __future__ import annotations

import bisect
from types import SimpleNamespace

HOST_SPANS = ("vkrt.submit", "vkrt.retire")
PROBE = "bench.clock_probe"


def window(run):
    """SimpleNamespace(frames: [[tracing.Span]] per whole replayed frame,
    replay: each frame's place among the n replays (or None), to_host:
    a device time on the host's clock (or None), counters:
    {name: count over the n frames}, lanes: [(kernel, span, lanes a
    frame)], n: frames sent, inflight, host: {"vkrt.submit" /
    "vkrt.retire": [(start s, end s)] in order}), or None."""
    if not hasattr(run, "_spans_window"):
        run._spans_window = _measure(run)
    return run._spans_window


def _measure(run):
    if run.trace is None or not run.cuda:
        return None
    try:
        from vkrt_tpu_torch import tracing
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from vkrt_tpu_torch import runtime

    import run as bench_run

    st = run.state
    program = st.entry.program
    if not hasattr(program, "graphs"):
        return None
    ks = bench_run.trace_path_frames(st)
    side = torch.cuda.Stream(st.device)
    src = torch.zeros(1, pin_memory=True)
    dst = torch.zeros(1, device=st.device)

    def probe():
        with record_function(PROBE), torch.cuda.stream(side):
            dst.copy_(src, non_blocking=True)

    def send():
        sched = runtime.FrameScheduler(inflight=st.inflight)
        for k in ks:
            pose, m = st.frames.at(k)
            probe()
            sched.submit(st.entry.frame, pose, m)
        for _ in sched.drain():
            probe()
        torch.cuda.synchronize()

    with tracing.on():
        send()
        tables = list(program.graphs.tables().values())
        if len(tables) != 1:
            return None
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            send()
        counts = tracing.counters()
    ops, host = tracing.profile_ops(prof)
    frames = tracing.device_spans(ops, tables[0])
    return SimpleNamespace(
        frames=frames, replay=_replay_index(host, frames, len(ks)),
        counters=counts, lanes=list(tables[0].lanes), n=len(ks),
        inflight=st.inflight, to_host=to_host_clock(ops, host),
        host={name: sorted((s, e) for n, s, e, _ in host if n == name)
              for name in HOST_SPANS})


def to_host_clock(ops, host):
    """A device time of the window as a time of the host events' clock.
    The profiler's device and host clocks wander apart within one window
    (on an H100 by up to about 7 ms over 2 s, and not at one rate), so
    they are tied where the card waits for no one: a 4-byte copy on a
    stream of its own (the copy engine, not the SMs the frames hold),
    launched in a `PROBE` range before each submit and after each
    retire of the drain, starts some microseconds after its runtime call
    (matched by correlation id). Between two probes the offset is
    interpolated, past the ends held. None where no probe is matched:
    the two clocks are then not tied, and no reading spans them."""
    dev = {o[3]: o[1] for o in ops if "Memcpy" in o[0]}
    calls = sorted((h[1], h[3]) for h in host
                   if h[0].startswith("cuda") and "Memcpy" in h[0])
    starts = [c[0] for c in calls]
    ties = []
    for name, s, e, _ in host:
        if name != PROBE:
            continue
        i = bisect.bisect_left(starts, s)
        if i < len(calls) and calls[i][0] <= e and calls[i][1] in dev:
            d = dev[calls[i][1]]
            ties.append((d, d - calls[i][0]))
    if not ties:
        return None
    ties.sort()
    at = [d for d, _ in ties]

    def to_host(t):
        i = bisect.bisect_right(at, t)
        if i == 0:
            return t - ties[0][1]
        if i == len(ties):
            return t - ties[-1][1]
        (d0, o0), (d1, o1) = ties[i - 1], ties[i]
        return t - (o0 + (o1 - o0) * (t - d0) / (d1 - d0))
    return to_host


def _replay_index(host, frames, n):
    """Each whole frame's place among the window's n replays: the k-th
    replay is the k-th submit's, and its group (correlation id) is the
    k-th graph launch's on the host. None where the window's launches
    are not n or a frame's launch is not among them."""
    launches = sorted((h[1], h[3]) for h in host if "GraphLaunch" in h[0])
    order = {g: k for k, (_, g) in enumerate(launches)}
    if len(order) != n or not all(f[0].group in order for f in frames):
        return None
    return [order[f[0].group] for f in frames]


def span_ms(win, prefix: str):
    """Device ms a frame of the ops directly inside the spans whose name
    starts with `prefix`, or None where no frame has such a span."""
    if win is None or not win.frames:
        return None
    spans = [s for f in win.frames for s in f if s.name.startswith(prefix)]
    if not spans:
        return None
    return sum(s.self_ms for s in spans) / len(win.frames)


def frame_spans(win):
    """The `frame` span of each replayed frame, in replay order."""
    return [s for f in win.frames for s in f if s.name == "frame"]


def host_vs_frames(win, name: str):
    """[(host range `name`, frame span on the host's clock)] of the
    frames after the first `inflight` (which start on an idle card),
    matched by replay order: the k-th submit and the k-th retire are the
    k-th replay's. None where the replays cannot be told apart, the
    clocks are not tied, or no frame is left."""
    if win is None or win.replay is None or win.to_host is None:
        return None
    host = win.host[name]
    if len(host) != win.n:
        return None
    pairs = [(host[k], f._replace(start=win.to_host(f.start),
                                  end=win.to_host(f.end)))
             for k, f in zip(win.replay, frame_spans(win))
             if k >= win.inflight]
    return pairs or None
