"""vkrt_tpu_torch/tracing.py on the CPU: the spans and counters of a frame.

A mark exists only on the card (tests/test_torch_cuda.py replays marked
graphs and reads them back). Here the function a graph captures,
`Renderer.frame_body`, runs eagerly with tracing on: its span table
(what a capture records) nests as the engine's docstring says, once per
depth, and its counters add up to the frame's ray count; with tracing
off nothing is recorded and the frame is the same bits. `device_spans`
is checked on synthetic device ops, the CLI's spans.json on the CPU,
the scheduler's host spans under torch.profiler, and the listener hook
that chip_smoke.py and tools/ time spans through. The small scene at
32x24 on one intra-op thread keeps the file to seconds.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import runtime, tracing
from vkrt_tpu_torch.app import cli
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.app.metrics import spans_json
from vkrt_tpu_torch.raster.pipeline import Rasterizer
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

W, H = 32, 24
MARK = "void vkrt::span_mark_kernel()"


@pytest.fixture(scope="module")
def model():
    return procedural_model("small", seed=0)


CONFIGS = {
    "config4": (C.config4_flythrough, None),
    "config5_refit": (C.config5_stress,
                      np.array([[1, 0, 0, 0.3], [0, 1, 0, -0.2],
                                [0, 0, 1, 0.5], [0, 0, 0, 1]], np.float32)),
}


@pytest.fixture(scope="module")
def renderers(model):
    return {name: te.Renderer(model, dataclasses.replace(
        make(), width=W, height=H), "cpu", quantize=True)
        for name, (make, _) in CONFIGS.items()}


def start_camera() -> Camera:
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return cam


def traced_frame(r, m):
    """frame_body on a camera's inputs with tracing on: (outputs, the span
    table a capture would record, the counters it added)."""
    x = torch.from_numpy(r.frame_inputs(start_camera(), m))
    tracing.reset()
    with tracing.on(), tracing.record() as table:
        out = r.frame_body(x, m is not None)
    return out, table, {k: v for k, v in tracing.counters().items() if v}


def leaves(cfg, update: bool) -> set:
    names = {"camera_rays", "resolve"} | ({"accel_update"} if update
                                         else set())
    for d in range(cfg.max_depth):
        names |= {f"trace_closest_d{d}", f"shade_d{d}", f"sample_d{d}",
                  f"trace_shadow_d{d}"}
    return names


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_spans_nest_once_a_depth(renderers, name):
    """The table nests: `frame` holds every other span, which hold none;
    each depth opens its four spans (shade_d up to three times, around
    the sample and the shadow trace), in the engine's order."""
    r, m = renderers[name], CONFIGS[name][1]
    _, table, _ = traced_frame(r, m)
    stack = []
    for span, parent, opening in table.spans:
        if opening:
            assert parent == (stack[-1] if stack else None)
            stack.append(span)
        else:
            assert stack.pop() == span
            assert parent == (stack[-1] if stack else None)
    assert not stack
    assert table.spans[0] == ("frame", None, True)
    assert table.spans[-1] == ("frame", None, False)
    inner = [(s, p) for s, p, o in table.spans[1:-1] if o]
    assert all(p == "frame" for _, p in inner)
    assert {s for s, _ in inner} == leaves(r.cfg, m is not None)
    order = [s for s, _ in inner]
    for d in range(r.cfg.max_depth):
        seq = [s for s in order if s.endswith(f"_d{d}")]
        assert seq == [f"trace_closest_d{d}", f"shade_d{d}",
                       f"sample_d{d}", f"shade_d{d}",
                       f"trace_shadow_d{d}", f"shade_d{d}"]
    assert order[-1] == "resolve"
    assert (order[0] == "accel_update") == (m is not None)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counters_add_up_to_the_ray_count(renderers, name):
    """Per depth the live closest-hit rays and the cast shadow segments;
    summed over the depths, the frame's ray count exactly. The lanes
    kernels A and B are launched over: the whole wavefront, B once per
    light."""
    r, m = renderers[name], CONFIGS[name][1]
    (fb8, rays), table, counts = traced_frame(r, m)
    assert sum(counts.values()) == int(rays) > 0
    assert set(counts) <= {f"{k}_d{d}" for d in range(r.cfg.max_depth)
                           for k in ("live_closest", "cast_shadow")}
    assert counts["live_closest_d0"] == W * H
    wp, hp = te._pad_dims(W, H)
    n = wp * hp
    assert table.lanes == [
        x for d in range(r.cfg.max_depth)
        for x in (("trace_closest", f"trace_closest_d{d}", n),
                  ("occl_multi", f"trace_shadow_d{d}", r.cfg.num_lights * n))]


def test_tracing_off_records_nothing_and_changes_no_bit(renderers):
    """With tracing off a recording table stays empty, no counter moves,
    and the frame equals the composed frame and the traced frame."""
    r, m = renderers["config5_refit"], CONFIGS["config5_refit"][1]
    assert not tracing.enabled()
    before = tracing.counters()
    x = torch.from_numpy(r.frame_inputs(start_camera(), m))
    with tracing.record() as table:
        off = r.frame_body(x, True)
    assert table.spans == [] and table.lanes == []
    assert tracing.counters() == before
    on, _, _ = traced_frame(r, m)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    r4 = renderers["config4"]
    cam = start_camera()
    want = te.render_frame_u8(r4.backend, r4.tex,
                              torch.from_numpy(cam.proj_inverse),
                              torch.from_numpy(cam.view_inverse), r4.lights,
                              r4.cfg)
    got = r4.frame_body(torch.from_numpy(r4.frame_inputs(cam)), False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_graph_key_holds_the_tracing_state(renderers, model):
    """A traced frame is a graph of its own: Renderer's and Rasterizer's
    keys differ with tracing on and off, and nothing else does."""
    r = renderers["config4"]
    rast = Rasterizer(model, dataclasses.replace(C.reference_config(),
                                                 width=W, height=H),
                      "cpu", msaa=1)
    for key in (lambda: r.graph_key(True), rast.graph_key):
        off = key()
        with tracing.on():
            on = key()
            assert tracing.enabled()
        assert off != on and off[:-1] == on[:-1]
        assert off[-1] is False and on[-1] is True
        assert key() == off


def _ops(*spec, group=0):
    """Device ops of one launch `group` (its correlation id) from (name,
    start, end) in ms; 'M' is a mark."""
    return [((MARK if n == "M" else n), s * 1e-3, e * 1e-3, group)
            for n, s, e in spec]


TABLE = [("frame", None, True), ("a", "frame", True), ("a", "frame", False),
         ("b", "frame", True), ("b", "frame", False), ("a", "frame", True),
         ("a", "frame", False), ("frame", None, False)]


def test_device_spans_on_synthetic_ops():
    """Two frames of a table with nesting and two intervals of one span:
    each op goes to the innermost span open at its start, frames come in
    stream order whatever the ops' order, ops between frames go
    nowhere."""
    frame0 = _ops(("M", 0, 1), ("M", 1, 2), ("k1", 2, 5), ("k2", 5, 6),
                  ("M", 6, 7), ("M", 7, 8), ("k3", 8, 10), ("M", 10, 11),
                  ("M", 11, 12), ("k4", 12, 13), ("M", 13, 14),
                  ("M", 14, 15))
    between = _ops(("copy", 15, 17), group=1)
    frame1 = [(n, s + 0.02, e + 0.02, 2) for n, s, e, _ in frame0]
    ops = list(reversed(frame0 + between + frame1))
    frames = tracing.device_spans(ops, TABLE)
    assert len(frames) == 2
    for f, shift in zip(frames, (0.0, 20.0)):
        assert [(s.name, s.parent, s.ops) for s in f] == [
            ("frame", None, 0), ("a", "frame", 2), ("b", "frame", 1),
            ("a", "frame", 1)]
        ms = {(s.name, round(s.self_ms, 9)) for s in f}
        assert ms == {("frame", 0.0), ("a", 4.0), ("b", 2.0), ("a", 1.0)}
        whole = f[0]
        assert whole.start == pytest.approx((0 + shift) * 1e-3)
        assert whole.end == pytest.approx((15 + shift) * 1e-3)
        assert f[1].start == pytest.approx((1 + shift) * 1e-3)
        assert f[1].end == pytest.approx((7 + shift) * 1e-3)
    assert sum(s.ops for f in frames for s in f) == 8   # not the copy


def test_device_spans_find_an_op_outside_every_leaf():
    """An op that runs in `frame` but in none of its children shows as
    the frame's own time (a leaf span missing in the engine)."""
    ops = _ops(("M", 0, 1), ("stray", 1, 3), ("M", 3, 4), ("k", 4, 5),
               ("M", 5, 6), ("M", 6, 7), ("M", 7, 8), ("M", 8, 9),
               ("M", 9, 10), ("M", 10, 11))
    (f,) = tracing.device_spans(ops, TABLE)
    assert (f[0].name, f[0].ops, round(f[0].self_ms, 9)) == ("frame", 1, 2.0)


def test_device_spans_leave_out_what_is_not_a_whole_frame():
    """A launch with fewer marks than the table (a dropped record), marks
    of eager launches (each its own id) and an empty table give no
    frame; marks that do not nest as the table does raise."""
    assert tracing.device_spans(_ops(("M", 0, 1), ("M", 1, 2)), TABLE) == []
    eager = [o for i in range(len(TABLE))
             for o in _ops(("M", i, i + 1), group=i)]
    assert tracing.device_spans(eager, TABLE) == []
    assert tracing.device_spans(_ops(("M", 0, 1)), []) == []
    bad = [("frame", None, True), ("a", "frame", True),
           ("frame", None, False), ("a", "frame", False)]
    with pytest.raises(ValueError, match="closes"):
        tracing.device_spans(_ops(*[("M", i, i + 1) for i in range(4)]),
                             bad)


def test_spans_json_reads_frames_counters_and_lanes():
    table = tracing.Table()
    table.spans[:] = TABLE
    table.lanes[:] = [("trace_closest", "a", 512), ("occl_multi", "b", 2048)]
    ops = _ops(("M", 0, 1), ("M", 1, 2), ("k1", 2, 5), ("M", 5, 6),
               ("M", 6, 7), ("k2", 7, 8), ("M", 8, 9), ("M", 9, 10),
               ("k3", 10, 12), ("M", 12, 13), ("M", 13, 14))
    out = spans_json(ops, [table], {"live_closest_d0": 7})
    assert out["counters"] == {"live_closest_d0": 7}
    assert out["lanes_per_frame"] == {"trace_closest@a": 512,
                                      "occl_multi@b": 2048}
    (f,) = out["frames"]
    assert f["frame_ms"] == pytest.approx(14.0)
    assert f["spans"] == pytest.approx({"frame": 0.0, "a": 5.0, "b": 1.0})
    assert spans_json(ops, [], {})["frames"] == []


def test_cli_profile_dir_writes_spans_json(model, tmp_path):
    """--profile-dir turns tracing on: beside trace.json, spans.json holds
    the counters of the frames (no marks on the CPU, so no frames)."""
    d = tmp_path / "prof"
    assert cli.main(["--config", "4", "--width", str(W), "--height",
                     str(H), "--frames", "2", "--device", "cpu",
                     "--profile-dir", str(d)], scene=model) == 0
    assert (d / "trace.json").is_file()
    out = json.loads((d / "spans.json").read_text())
    assert out["frames"] == [] and out["traced_graphs"] == 0
    counts = out["counters"]
    assert counts["live_closest_d0"] == 2 * W * H
    assert counts["cast_shadow_d0"] > 0
    assert not tracing.enabled()


def test_scheduler_host_spans_under_the_profiler():
    """FrameScheduler's spans are host ranges, there while a profiler
    runs, tracing off: submit, then retire holding the conversion."""
    from torch.profiler import ProfilerActivity, profile

    sched = runtime.FrameScheduler(inflight=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            sched.submit(lambda k: (torch.full((2,), k),), i)
        list(sched.drain())
    dev, host = tracing.profile_ops(prof)
    assert dev == []                     # no device, no device ops
    names = [h[0] for h in host]
    assert names.count("vkrt.submit") == 3
    assert names.count("vkrt.retire") == 3
    assert names.count("vkrt.numpy") == 3
    assert "vkrt.wait" not in names      # CPU outputs wait for nothing


def test_listeners_see_device_spans_only():
    """listen() hears each device span's entry and exit, tracing on or
    off; a host span (no device) and code outside the block are
    unheard; with nothing on, span() does nothing."""
    heard = []
    with tracing.listen(lambda n, o: heard.append((n, o))):
        with tracing.span("outer", "cpu"):
            with tracing.span("vkrt.host"):
                with tracing.span("inner", torch.device("cpu")):
                    pass
    with tracing.span("after", "cpu"):
        pass
    assert heard == [("outer", True), ("inner", True), ("inner", False),
                     ("outer", False)]
    with tracing.record() as table:
        with tracing.span("quiet", "cpu"):
            tracing.lanes("trace_closest", 128)
            tracing.count("quiet", torch.ones(4, dtype=torch.bool))
    assert table.spans == [] and table.lanes == []
    assert "quiet" not in tracing.counters()


def test_counter_slots_accumulate_and_reset():
    mask = torch.zeros(L.LANES, dtype=torch.bool)
    mask[:5] = True
    tracing.reset()
    with tracing.on():
        tracing.count("test_slot", mask)
        tracing.count("test_slot", mask)
    assert tracing.counters("cpu")["test_slot"] == 10
    tracing.reset()
    assert tracing.counters()["test_slot"] == 0


def test_device_spans_by_replay_leave_out_a_frame_missing_a_mark():
    """Ops that name their replay (the launch's correlation id): each
    replay is a frame, in start order, its group on every Span; one whose
    marks are not the table's (a record the profiler dropped) is left
    out, and ops of other launches (copies between frames) go nowhere."""
    def replay(t0, group, drop=False):
        ops = _ops(("M", 0, 1), ("M", 1, 2), ("k1", 2, 5), ("M", 5, 6),
                   ("M", 6, 7), ("k2", 7, 8), ("M", 8, 9), ("M", 9, 10),
                   ("k3", 10, 12), ("M", 12, 13), ("M", 13, 14),
                   group=group)
        ops = [(n, s + t0, e + t0, g) for n, s, e, g in ops]
        return ops[1:] if drop else ops
    ops = (replay(0.0, 7) + [("copy", 0.0145, 0.0147, 8)]
           + replay(0.02, 9, drop=True) + replay(0.04, 11))
    frames = tracing.device_spans(list(reversed(ops)), TABLE)
    assert [f[0].group for f in frames] == [7, 11]
    assert all(s.group == f[0].group for f in frames for s in f)
    for f in frames:
        assert [(s.name, s.ops) for s in f] == [
            ("frame", 0), ("a", 1), ("b", 1), ("a", 1)]
    assert frames[1][0].start == pytest.approx(0.04)
