"""The raster path as the benchmark's `raster-fly` cell and the CLI's
fly-through drive it, on the CPU at 64x48, MSAA 8: the quantized frame
and its visibility queries (`Rasterizer(quantize=True)`), the traced
frame's spans, counters and lanes, and the frame against the benchmark's
plain reference (bench_torch/raster_reference.py) within the cell's
limits."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.app.flythrough import camera_path
from vkrt_tpu_torch.raster import pipeline as rp
from vkrt_tpu_torch.raster.edge import ZFAR_PARK
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine

BENCH = Path(__file__).resolve().parent.parent / "bench_torch"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import check  # noqa: E402
import raster_reference  # noqa: E402
import reference  # noqa: E402
import scene_gen  # noqa: E402

W, H = 64, 48
CAMERAS = list(camera_path(W, H))


def raster_cfg():
    return dataclasses.replace(C.reference_config(), width=W, height=H)


@pytest.fixture(scope="module")
def small():
    return procedural_model("small", seed=0)


@pytest.fixture(scope="module")
def frames(small):
    """One camera of the same scene: the f32 frame, the quantized
    rasterizer and its (u8 frame, count), and a plain recount of that
    frame: per call of G, the lanes its depth floor leaves unparked."""
    cam = CAMERAS[130]
    f32 = rp.Rasterizer(small, raster_cfg(), "cpu").render_async(cam)
    r = rp.Rasterizer(small, raster_cfg(), "cpu", quantize=True)
    seen = []
    inner = rp.raster_edge

    def recount(setup, scb, clb, px, py, zfloor):
        seen.append(int((zfloor < ZFAR_PARK).sum()))
        return inner(setup, scb, clb, px, py, zfloor)

    rp.raster_edge = recount
    try:
        q = r.render_async(cam)
    finally:
        rp.raster_edge = inner
    return f32, r, q, seen


def test_quantized_frame_is_the_truncating_cast_of_the_f32_frame(frames):
    f32, _, (fb8, count), _ = frames
    assert fb8.dtype == torch.uint8 and fb8.shape == (H, W, 3)
    assert count.dtype == torch.int64 and count.ndim == 0
    want = torch.clamp(f32 * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    assert torch.equal(fb8, want)


def test_count_is_the_live_lanes_as_each_round_enters_g(frames):
    """The count against the plain recount: every call of G (8 samples x
    4 rounds); round 0 is every pixel of every sample."""
    _, _, (_, count), seen = frames
    assert len(seen) == 8 * rp.MAX_DISCARD_ROUNDS
    assert seen[0::rp.MAX_DISCARD_ROUNDS] == [W * H] * 8
    assert sum(seen[1::rp.MAX_DISCARD_ROUNDS]) > 0   # discards happen
    assert int(count) == sum(seen)


def test_traced_frame_records_spans_counters_and_lanes(frames):
    """What a traced capture records (graphs.FrameGraph runs frame_body
    under tracing.record()): `frame` around everything, the raster spans,
    `resolve`, the per-round counters summing to the frame's count, G's
    lanes under its spans; the frame's bits as untraced."""
    _, r, plain, _ = frames
    cam = CAMERAS[130]
    x = torch.as_tensor(np.concatenate(
        [np.asarray(cam.view_matrix, np.float32).reshape(-1),
         np.asarray(cam.projection_matrix, np.float32).reshape(-1)]))
    tracing.reset()
    with tracing.on(), tracing.record() as table:
        fb8, count = r.frame_body(x)
        counts = tracing.counters("cpu")
    assert torch.equal(fb8, plain[0]) and torch.equal(count, plain[1])
    names = {n for n, _, _ in table.spans}
    assert names == {"frame", "raster_setup", "raster_sample", "resolve",
                     *(f"raster_edge_s{k}" for k in range(8))}
    assert table.spans[0] == ("frame", None, True)
    assert table.spans[-1] == ("frame", None, False)
    assert all(parent is not None for _, parent, _ in table.spans[1:-1])
    live = {f"raster_live_r{i}": counts[f"raster_live_r{i}"]
            for i in range(rp.MAX_DISCARD_ROUNDS)}
    assert live["raster_live_r0"] == W * H * 8
    assert sum(live.values()) == int(count)
    wp, hp = engine._pad_dims(W, H)          # the tiles' padded frame
    assert len(table.lanes) == 8 * rp.MAX_DISCARD_ROUNDS
    assert {(k, n) for k, _, n in table.lanes} == {("raster_edge", wp * hp)}
    assert {s for _, s, _ in table.lanes} == {f"raster_edge_s{k}"
                                               for k in range(8)}


def test_reference_msaa_table_is_the_ports():
    assert raster_reference.MSAA8.dtype == rp.MSAA8.dtype
    assert np.array_equal(raster_reference.MSAA8, rp.MSAA8)
    assert np.array_equal(np.asarray(raster_reference.CLEAR, np.float32),
                          rp.CLEAR_COLOR)
    assert raster_reference.ALPHA_DISCARD == rp.ALPHA_DISCARD
    assert raster_reference.ROUNDS == rp.MAX_DISCARD_ROUNDS


@pytest.mark.parametrize("seed,k", [(0, 0), (1, 60), (2, 130)])
def test_frame_matches_the_plain_reference(seed, k):
    """The port's quantized frame and count against the benchmark's
    reference, by check.py's numbers, within `raster-fly`'s limits. The
    two part only where a sample lies within rounding of a triangle's
    edge (G's float32 edge functions against the reference's
    Moller-Trumbore test) and picks the other triangle, or where an alpha
    at the 0.1 threshold rounds the other way: one sample of 8 moves a
    pixel by at most an eighth of a colour step, so a few pixels of a
    frame may pass OFF_LSB; the visibility queries part only where a
    discard does."""
    limits = json.loads((BENCH / "cells" / "raster-fly.json")
                        .read_text())["limits"]
    cam = CAMERAS[k]
    r = rp.Rasterizer(procedural_model("small", seed), raster_cfg(), "cpu",
                      quantize=True)
    fb8, count = r.render_async(cam)
    scene = scene_gen.make_scene("small", seed)
    geo = reference.geometry(scene, "cpu")
    ref = raster_reference.render(
        geo, reference.textures(scene, "cpu"), reference.build_tree(geo),
        dataclasses.asdict(raster_cfg()), cam, 8)
    got = check.compare(fb8.numpy(), int(count), ref[0].numpy(), ref[1],
                        ref[2].numpy())
    assert check.verdict(got, limits), got


def test_cli_raster_fly_through_keeps_frames_in_flight(small, tmp_path,
                                                       monkeypatch, capsys):
    """--raster --frames 2 goes through FrameScheduler with quantize: the
    u8 frames retire with their own visibility queries (the metrics' ray
    count), the FPS overlay is burned into the last one on the host and
    outside its box the PNG is the quantized frame of the path's second
    camera."""
    from PIL import Image

    from vkrt_tpu_torch import runtime
    from vkrt_tpu_torch.app import cli

    submitted = []
    real = runtime.FrameScheduler.submit

    def submit(self, fn, *args):
        submitted.append(self.inflight)
        return real(self, fn, *args)

    monkeypatch.setattr(runtime.FrameScheduler, "submit", submit)
    out = tmp_path / "fly.png"
    assert cli.main(["--raster", "--frames", "2", "--width", str(W),
                     "--height", str(H), "--device", "cpu", "--metrics",
                     "--output", str(out)], scene=small) == 0
    assert submitted == [3, 3]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want8, n = rp.Rasterizer(small, raster_cfg(), "cpu",
                             quantize=True).render_async(CAMERAS[1])
    got = np.asarray(Image.open(out))
    keep = np.ones((H, W), bool)
    keep[8:22, 8:] = False                      # the "FPS ..." text box
    np.testing.assert_array_equal(got[keep], want8.numpy()[keep])
    assert (got[~keep] == 255).any()
    assert summary["frames"] == 2 and summary["total_rays"] >= 2 * W * H * 8
