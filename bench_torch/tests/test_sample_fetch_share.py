"""metrics/sample_fetch_share.py on a fake run whose marked window
(spans_window.py) is given: the fetch counters sample_fetch_d* over
sample_hits' lanes times the frames, in %; nothing read, nothing raised,
where the program keeps no such counter (a checkout before kernel K),
where the window holds nothing, or where the program has no tracing
module."""

import sys
from types import SimpleNamespace

import pytest

import spans_window
import spec


def fake_run(counters, lanes, n=5):
    win = SimpleNamespace(counters=counters, lanes=lanes, n=n)
    return SimpleNamespace(_spans_window=win, trace=object(), cuda=True)


def read(run):
    return spec.reader("sample_fetch_share")(run)


LANES = [("trace_closest", "trace_closest_d0", 1000),
         ("sample_hits", "sample_d0", 1000),
         ("occl_multi", "trace_shadow_d0", 4000),
         ("trace_closest", "trace_closest_d1", 1000),
         ("sample_hits", "sample_d1", 1000),
         ("occl_multi", "trace_shadow_d1", 4000)]


def test_fetched_lanes_over_the_sampled_lanes():
    counters = {"live_closest_d0": 5000, "sample_fetch_d0": 4500,
                "cast_shadow_d0": 9000, "live_closest_d1": 3000,
                "sample_fetch_d1": 1500}
    assert read(fake_run(counters, LANES)) == pytest.approx(
        100.0 * 6000 / (2 * 1000 * 5))
    assert read(fake_run(dict(counters, sample_fetch_d1=0), LANES)) == (
        pytest.approx(100.0 * 4500 / 10000))


def test_nothing_read_without_the_counters_or_the_lanes():
    parent = {"live_closest_d0": 5000, "cast_shadow_d0": 9000}
    no_k = [x for x in LANES if x[0] != "sample_hits"]
    assert read(fake_run(parent, no_k)) is None
    assert read(fake_run({"sample_fetch_d0": 10}, no_k)) is None
    assert read(SimpleNamespace(_spans_window=None)) is None
    for run in (SimpleNamespace(trace=None, cuda=True),
                SimpleNamespace(trace=object(), cuda=False)):
        assert read(run) is None


def test_no_tracing_module_reads_nothing(monkeypatch):
    import vkrt_tpu_torch
    monkeypatch.setitem(sys.modules, "vkrt_tpu_torch.tracing", None)
    monkeypatch.delattr(vkrt_tpu_torch, "tracing")
    run = SimpleNamespace(trace=object(), cuda=True, state=None)
    assert read(run) is None
    assert spans_window.window(run) is None
