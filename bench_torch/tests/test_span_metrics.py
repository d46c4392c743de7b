"""The span and counter metrics (metrics/shade_ms.py, sample_ms.py,
accel_span_ms.py, rt_live_share.py, queue_wait_ms.py, retire_lag_ms.py)
on a fake run whose marked window (spans_window.py) is given: their
arithmetic, and nothing read, nothing raised, where the window holds
nothing or the program has no tracing module."""

import sys
from types import SimpleNamespace

import pytest

import spans_window
import spec
from vkrt_tpu_torch.tracing import Span

NAMES = ("shade_ms", "sample_ms", "accel_span_ms", "rt_live_share",
         "queue_wait_ms", "retire_lag_ms")


def frame(t0, accel=True):
    """One replayed frame's spans (ms clock given in s), starting at t0."""
    s = [Span("frame", None, t0, t0 + 0.020, 0.0, 0)]
    if accel:
        s.append(Span("accel_update", "frame", t0, t0 + 0.005, 4.5, 9))
    s += [Span("trace_closest_d0", "frame", t0 + 0.005, t0 + 0.008, 3.0, 1),
          Span("shade_d0", "frame", t0 + 0.008, t0 + 0.009, 1.0, 5),
          Span("sample_d0", "frame", t0 + 0.009, t0 + 0.011, 2.0, 4),
          Span("shade_d0", "frame", t0 + 0.011, t0 + 0.0115, 0.5, 2),
          Span("trace_shadow_d0", "frame", t0 + 0.0115, t0 + 0.019, 7.0, 1),
          Span("shade_d0", "frame", t0 + 0.019, t0 + 0.020, 0.75, 3)]
    return s


def fake_run(n=5, inflight=3, accel=True):
    starts = [0.1 + 0.02 * k for k in range(n)]
    win = SimpleNamespace(
        frames=[frame(t, accel) for t in starts],
        counters={"live_closest_d0": 600 * n, "cast_shadow_d0": 900 * n,
                  "live_closest_d1": 100 * n},
        lanes=[("trace_closest", "trace_closest_d0", 1000),
               ("occl_multi", "trace_shadow_d0", 4000),
               ("trace_closest", "trace_closest_d1", 1000)],
        replay=list(range(n)), n=n, inflight=inflight,
        to_host=lambda t: t,
        host={"vkrt.submit": [(t - 0.060, t - 0.058) for t in starts],
              "vkrt.retire": [(t + 0.019, t + 0.0215) for t in starts]})
    return SimpleNamespace(_spans_window=win, trace=object(), cuda=True)


def read(name, run):
    return spec.reader(name)(run)


def test_span_metrics_on_a_fake_window():
    run = fake_run()
    assert read("shade_ms", run) == pytest.approx(2.25)
    assert read("sample_ms", run) == pytest.approx(2.0)
    assert read("accel_span_ms", run) == pytest.approx(5.0)
    assert read("rt_live_share", run) == pytest.approx(
        100.0 * 1600 / 6000)
    assert read("queue_wait_ms", run) == pytest.approx(60.0)
    assert read("retire_lag_ms", run) == pytest.approx(1.5)


def test_queue_metrics_skip_the_first_inflight_frames():
    run = fake_run(n=5, inflight=3)
    win = run._spans_window
    win.host["vkrt.submit"][0] = (0.0, 0.001)          # an idle card's
    assert read("queue_wait_ms", run) == pytest.approx(60.0)
    win.host["vkrt.submit"][4] = (0.1 + 0.08 - 0.090, 0.0)
    assert read("queue_wait_ms", run) == pytest.approx(75.0)
    assert read("queue_wait_ms", fake_run(n=3, inflight=3)) is None
    short = fake_run()
    short._spans_window.host["vkrt.retire"].pop()
    assert read("retire_lag_ms", short) is None        # unmatched
    lost = fake_run(n=5, inflight=3)                   # replay 3 dropped
    win = lost._spans_window
    del win.frames[3], win.replay[3]
    win.host["vkrt.submit"][4] = (0.1 + 0.08 - 0.090, 0.0)
    assert read("queue_wait_ms", lost) == pytest.approx(90.0)
    assert read("shade_ms", lost) == pytest.approx(2.25)
    win.replay = None                                  # cannot be told
    assert read("queue_wait_ms", lost) is None


def test_nothing_read_where_the_window_holds_nothing():
    assert read("accel_span_ms", fake_run(accel=False)) is None
    empty = SimpleNamespace(_spans_window=None)
    for name in NAMES:
        assert read(name, empty) is None
    for run in (SimpleNamespace(trace=None, cuda=True),
                SimpleNamespace(trace=object(), cuda=False)):
        for name in NAMES:
            assert read(name, run) is None
        assert run._spans_window is None


def test_no_tracing_module_reads_nothing(monkeypatch):
    """A program without vkrt_tpu_torch.tracing (an older checkout):
    every reader returns None and none raises."""
    import vkrt_tpu_torch
    monkeypatch.setitem(sys.modules, "vkrt_tpu_torch.tracing", None)
    monkeypatch.delattr(vkrt_tpu_torch, "tracing")
    run = SimpleNamespace(trace=object(), cuda=True, state=None)
    for name in NAMES:
        assert read(name, run) is None
    assert spans_window.window(run) is None


def test_device_times_tied_to_the_host_clock():
    """A device clock that runs 2 ms behind, then drifts 1% and then
    holds: probes every 0.5 s (their runtime call 10 us before the copy)
    tie it back to within the probes' slack between them, and the frames'
    own copies are no probes."""
    def dev(t):                      # host time -> the device's reading
        return t - 0.002 - 0.01 * min(max(t - 1.0, 0.0), 1.0)
    ops, host = [], []
    for i, t in enumerate((0.5, 1.0, 1.5, 2.0, 2.5)):
        ops.append(("Memcpy HtoD (Pinned -> Device)", dev(t + 1e-5),
                    dev(t + 2e-5), 100 + i))
        host += [("bench.clock_probe", t - 1e-6, t + 5e-6, 0),
                 ("cudaMemcpyAsync", t, t + 3e-6, 100 + i)]
    ops.append(("Memcpy HtoD (Pinned -> Device)", dev(1.2), dev(1.21), 7))
    host.append(("cudaMemcpyAsync", 1.19, 1.191, 7))
    to_host = spans_window.to_host_clock(ops, host)
    for t in (0.5, 1.0, 1.25, 1.75, 2.0, 2.6):
        assert to_host(dev(t)) == pytest.approx(t, abs=2e-5)
    assert to_host(dev(0.2)) == pytest.approx(0.2, abs=2e-5)
    assert spans_window.to_host_clock(ops, host[1:2]) is None  # no probe
    assert spans_window.to_host_clock(ops, []) is None


def test_no_reading_across_untied_clocks():
    """Where no probe ties the device clock to the host's, the two
    readings that compare them read nothing; the device-only ones
    still read."""
    run = fake_run()
    run._spans_window.to_host = None
    assert read("queue_wait_ms", run) is None
    assert read("retire_lag_ms", run) is None
    assert read("shade_ms", run) == pytest.approx(2.25)


def test_replays_ordered_by_their_graph_launches():
    """A frame's place is its group's among the host's graph launches;
    none where the launches are not the frames sent."""
    frames = [[Span("frame", None, 0.0, 1.0, 0.0, 0, g)] for g in (30, 50)]
    host = [("cudaGraphLaunch", 0.1 * k, 0.1 * k + 0.01, g)
            for k, g in enumerate((10, 30, 40, 50))]
    host.append(("cudaMemcpyAsync", 0.05, 0.06, 20))
    assert spans_window._replay_index(host, frames, 4) == [1, 3]
    assert spans_window._replay_index(host, frames, 5) is None
    assert spans_window._replay_index(host[2:], frames, 2) is None
