"""`raster-fly` and `c4-fly-sync` at a size the CPU holds, with their own
limits and settings: a sound run is correct, a broken timed path and the
control are not (as test_faults.py checks the first cells)."""

import time
from types import SimpleNamespace

import pytest

import check
import run
import scene_gen
from faults import flipped, half, stale

CELLS = ["raster-fly", "c4-fly-sync"]


def _run(cell, fault):
    return run.run_cell(cell, 2**31 + 101, 1.5, 0, device="cpu",
                        t_start=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_cell, workload):
    out = _run(tiny_cell(workload), None)
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("fault", [stale, half, flipped],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(tiny_cell, workload, fault):
    out = _run(tiny_cell(workload), fault)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_cell, workload):
    """The reference at TF32 in the program's place fails the limits."""
    cell = tiny_cell(workload, 128, 64)
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = run.setup(cell, scene, "cpu", 7)
    idx = [0, 17]
    ref = {i: r for i, *r in run.reference_frames(state, scene, idx)}
    ctl = [check.compare(fb, n, *ref[i]) for i, fb, n, _ in
           run.reference_frames(state, scene, idx, tf32=True)]
    assert not check.verdict(check.worst(ctl), cell.check["limits"])


def test_raster_frames_go_through_the_scheduler_as_u8_and_a_count(
        tiny_cell):
    """The raster entry's frame is the port's quantized frame: a u8 image
    and its visibility queries, every inside sample at least once."""
    cell = tiny_cell("raster-fly")
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = run.setup(cell, scene, "cpu", 3)
    _, pose, m = state.frames(5)
    fb, n = state.entry.frame(pose, m)
    r = cell.config["render"]
    assert fb.dtype.is_floating_point is False and tuple(fb.shape) == (
        r["height"], r["width"], 3)
    assert int(n) >= r["width"] * r["height"] * cell.config["msaa"]
    with pytest.raises(ValueError, match="transform"):
        state.entry.frame(pose, [[1.0]])


def _raster_run(n=4, frames=None):
    """A fake traced run of the raster cell: per replayed frame a setup
    span, G's span and two sample spans (ms clock in s), the counters over
    n frames, G's lanes a frame, and device ops by kernel name."""
    from vkrt_tpu_torch.tracing import Span
    frame = [Span("frame", None, 0.0, 0.2, 0.0, 0),
             Span("raster_setup", "frame", 0.0, 0.003, 2.5, 40),
             Span("raster_edge_s0", "frame", 0.003, 0.1, 0.5, 3),
             Span("raster_sample", "frame", 0.1, 0.15, 40.0, 20),
             Span("raster_sample", "frame", 0.15, 0.19, 30.0, 20),
             Span("resolve", "frame", 0.19, 0.2, 1.0, 5)]
    win = SimpleNamespace(
        frames=[frame] * n if frames is None else frames,
        counters={"raster_live_r0": 800 * n, "raster_live_r1": 200 * n,
                  "live_closest_d0": 0},
        lanes=[("raster_edge", "raster_edge_s0", 1000)] * 4,
        replay=None, n=n, inflight=3, to_host=None, host={})
    ops = [("void vkrt::raster_edge_kernel<true>(...)", 0.0, 0.1)] * (2 * n)
    ops += [("elementwise_kernel", 0.0, 0.5)]
    return SimpleNamespace(_spans_window=win, cuda=True,
                           trace=SimpleNamespace(ops=ops, frames=n))


def test_raster_metrics_on_a_fake_window():
    import spec
    fake = _raster_run()
    read = {k: spec.reader(k)(fake) for k in (
        "raster_kernel_ms", "raster_sample_ms", "raster_setup_ms",
        "raster_live_share")}
    assert read == pytest.approx({"raster_kernel_ms": 200.0,
                                  "raster_sample_ms": 70.0,
                                  "raster_setup_ms": 2.5,
                                  "raster_live_share": 25.0})


def test_raster_metrics_read_nothing_where_nothing_is_there():
    """A traced run of the ray tracer (no G, no raster spans or counters)
    and an untraced run: every raster reader gives None, none raises."""
    import spec
    empty = _raster_run(frames=[])
    empty._spans_window.lanes = []
    empty.trace.ops = [("elementwise_kernel", 0.0, 0.5)]
    untraced = SimpleNamespace(trace=None, cuda=True)
    for fake in (empty, untraced):
        for k in ("raster_kernel_ms", "raster_sample_ms", "raster_setup_ms",
                  "raster_live_share"):
            assert spec.reader(k)(fake) is None, k
