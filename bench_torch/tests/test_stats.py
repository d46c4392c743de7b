"""The metric arithmetic on synthetic inputs."""

import statistics
from types import SimpleNamespace

import pytest

import spec
import stats


def test_percentile_and_rate_over_a_window_with_a_stall():
    # 100 frames of 23 ms with one stall of 400 ms: the tail sees it,
    # the rate is over all the window's time
    lat = [23.0] * 99 + [400.0]
    assert stats.percentile(lat, 95) == 23.0
    assert stats.percentile(lat, 100) == 400.0
    assert stats.percentile(lat[:-1] + [400.0] * 6, 95) == 400.0
    wall = sum(lat) / 1e3
    assert stats.rate(100, wall) == pytest.approx(100 / 2.677)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_percentile_is_nearest_rank():
    v = list(range(1, 201))             # 1..200
    assert stats.percentile(v, 95) == 190
    assert stats.percentile(v, 50) == 100
    assert stats.percentile([7.0], 95) == 7.0


def test_spread_is_statistics_quartiles_over_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 100.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_idle_share_is_a_union_of_overlapping_intervals():
    ops = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert stats.union(ops) == [(0.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    # window [0, 10]: busy 3 + 1 + 1 (clipped), idle 5 of 10
    assert stats.busy(ops, 0.0, 10.0) == pytest.approx(5.0)
    assert stats.idle_share(ops, 0.0, 10.0) == pytest.approx(0.5)
    assert stats.gaps(ops, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    assert stats.idle_share([(-1.0, 11.0)], 0.0, 10.0) == 0.0


def test_idle_gaps_are_named_by_the_host_range_inside():
    host = [("bench.submit", 0.0, 10.0), ("cudaGraphLaunch", 3.0, 4.5),
            ("cudaEventSynchronize", 6.0, 9.0)]
    assert stats.host_label(host, 3.5, 4.0) == "cudaGraphLaunch"
    assert stats.host_label(host, 5.0, 5.5) == "bench.submit"
    assert stats.host_label(host, 11.0, 12.0) == "host: none"
    assert stats.top([("a", 1.0), ("b", 3.0), ("c", 2.0)], 2) == \
        [("b", 3.0), ("c", 2.0)]
    assert stats.by_name([("k", 0.0, 1.0), ("k", 2.0, 2.5),
                          ("m", 0.0, 0.25)]) == {"k": 1.5, "m": 0.25}


@pytest.mark.parametrize("name,layer", [
    ("void vkrt::trace_closest_kernel<false, false, false>(float const*, "
     "int)", "rt"),
    ("void vkrt::occl_multi_kernel<4, false, false, false>(float const*)",
     "rt"),
    ("vkrt::trace_occluded_kernel(float const*)", "rt"),
    ("void vkrt::consolidate_kernel(int const*)", "reorder"),
    ("vkrt::scatter_back_kernel", "reorder"),
    ("void vkrt::lane_sort_kernel<8>(unsigned int*)", "reorder"),
    ("vkrt::lane_unsort_kernel", "reorder"),
    ("vkrt::raster_edge_kernel", "raster"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*)", "torch"),
    ("void vkrt::not_a_port_kernel(int)", "torch"),
    ("trace_closest_kernel", "torch"),
    ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ("Memset (Device)", "copy"),
])
def test_kernel_names_classify_by_layer(name, layer):
    assert stats.layer_of(name) == layer


def test_layer_readers_sum_a_layer_per_frame():
    ops = [("void vkrt::trace_closest_kernel<false>(x)", 0.0, 0.004),
           ("void vkrt::occl_multi_kernel<4>(x)", 0.005, 0.009),
           ("vkrt::lane_sort_kernel", 0.009, 0.0091),
           ("at::native::elementwise_kernel", 0.0091, 0.0191),
           ("Memcpy DtoH (Device -> Pinned)", 0.0191, 0.0192)]
    run = SimpleNamespace(trace=SimpleNamespace(
        ops=ops, host=[], lo=0.0, hi=0.02, frames=2, enqueue_ms=[0.5, 1.5]))
    assert spec.reader("rt_kernel_ms")(run) == pytest.approx(4.0)
    assert spec.reader("reorder_kernel_ms")(run) == pytest.approx(0.05)
    assert spec.reader("torch_ops_ms")(run) == pytest.approx(5.0)
    assert spec.reader("host_enqueue_ms")(run) == pytest.approx(1.0)
    # busy 0.0192 - 0.001 of 0.02
    assert spec.reader("device_idle_share")(run) == pytest.approx(
        100 * (0.02 - 0.0182) / 0.02)
    run.trace.ops = ops[:1]
    assert spec.reader("reorder_kernel_ms")(run) is None
    assert spec.reader("rt_kernel_ms")(SimpleNamespace(trace=None)) is None


def test_window_readers():
    win = SimpleNamespace(wall_s=2.0, frames=80, latency_ms=[20.0] * 76
                          + [90.0] * 4, rays_total=80 * 8_500_000)
    run = SimpleNamespace(window=win, setup_s=12.5, peak_bytes=2.5e9)
    assert spec.reader("frame_ms")(run) == pytest.approx(25.0)
    assert spec.reader("frame_p95_ms")(run) == 20.0
    assert spec.reader("mrays_per_s")(run) == pytest.approx(340.0)
    assert spec.reader("peak_mem_gb")(run) == pytest.approx(2.5)
    assert spec.reader("setup_s")(run) == 12.5
