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
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.app.flythrough import camera_path
from vkrt_tpu_torch.raster import pipeline as rp
from vkrt_tpu_torch.raster import sample as rs
from vkrt_tpu_torch.raster.edge import (ZFAR_PARK, build_raster_setup,
                                        raster_edge_plain)
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade.sampling import sample_material
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine

BENCH = Path(__file__).resolve().parent.parent / "bench_torch"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import check  # noqa: E402
import raster_reference  # noqa: E402
import reference  # noqa: E402
import scene_gen  # noqa: E402
import torch_support  # noqa: E402,F401

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
    lanes under its spans, kernel I's under `raster_sample`; the frame's
    bits as untraced."""
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
    assert [k for k, _, _ in table.lanes] == (["raster_edge", "raster_sample"]
                                              * 8 * rp.MAX_DISCARD_ROUNDS)
    assert {n for _, _, n in table.lanes} == {wp * hp}
    assert {s for k, s, _ in table.lanes if k == "raster_edge"} == {
        f"raster_edge_s{k}" for k in range(8)}
    assert {s for k, s, _ in table.lanes if k == "raster_sample"} == {
        "raster_sample"}


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


def inline_round(tex, z, slot, u, v, mat, color):
    """The discard round's body as edge_color_lanes ran it inline before
    it became raster_sample_round, verbatim."""
    hit = slot >= 0
    texel, _, _ = sample_material(
        tex.texels_tri, tex.level_offset, tex.level_width,
        tex.level_height, mat, torch.stack([u, v]))
    opaque = hit & (texel[3] >= rp.ALPHA_DISCARD)
    discarded = hit & ~opaque
    color = L.where3(opaque, texel[:3], color)
    zfloor = torch.where(discarded, z, ZFAR_PARK)
    return color, zfloor


def g_rounds(r, cam, off):
    """Kernel G's plain outputs (z, slot, u, v, mat) for each discard
    round of one sample of `cam`, each round behind the last one's
    discards as edge_color_lanes runs them, beside the colour entering
    each round."""
    setup = build_raster_setup(
        r.backend.tree, torch.as_tensor(cam.view_matrix),
        torch.as_tensor(cam.projection_matrix), W, H)
    px, py, inside = rp.sample_pixel_lanes(r.cfg, off, "cpu")
    zfloor = torch.where(inside, 0.0, ZFAR_PARK)
    color = rp._clear(px.shape, "cpu")
    out = []
    for _ in range(rp.MAX_DISCARD_ROUNDS):
        g = raster_edge_plain(*setup, px, py, zfloor)
        out.append((g, color))
        color, zfloor = inline_round(r.tex, *g, color)
    return out


@pytest.mark.parametrize("off", [(0.5, 0.5), tuple(rp.MSAA8[5])])
def test_plain_round_is_the_inline_body(frames, off):
    """raster_sample_round_plain, and raster_sample_round on CPU tensors
    (no kernel launch; the round's lanes recorded), give the bits of the
    body edge_color_lanes ran inline, in every round of a sample of the
    small scene, the rounds behind a discard included (in this scene
    nothing lies behind a discarded fragment: rounds 1-3 all miss)."""
    _, r, _, _ = frames
    rounds = g_rounds(r, CAMERAS[130], off)
    before = rs.raster_sample_round.launches
    for k, (g, color) in enumerate(rounds):
        want = inline_round(r.tex, *g, color)
        if k == 0:                          # opaque hits and discards
            assert (want[1] < ZFAR_PARK).any()
            assert (want[1][g[1] >= 0] == ZFAR_PARK).any()
        for fn in (rs.raster_sample_round_plain, rp.raster_sample_round):
            with tracing.on(), tracing.record() as table:
                got = fn(r.tex, *g, color.clone())
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert table.lanes == [("raster_sample", None, g[1].numel())]
    assert rs.raster_sample_round.launches == before


def test_round_refuses_a_device_it_does_not_take(frames):
    """Tensors on neither the CPU nor a CUDA card: ValueError, no launch
    counted."""
    _, r, _, _ = frames
    meta = torch.zeros((2, 128), device="meta")
    slot = torch.zeros((2, 128), dtype=torch.int32, device="meta")
    before = rs.raster_sample_round.launches
    with pytest.raises(ValueError, match="unsupported device"):
        rp.raster_sample_round(r.tex, meta, slot, meta, meta, slot,
                               torch.zeros((3, 2, 128), device="meta"))
    assert rs.raster_sample_round.launches == before


def test_fetch_counters_are_the_hit_lanes(frames):
    """Traced, raster_fetch_r{r} is the lanes G hit in round r (those
    whose texel kernel I fetches) summed over the 8 samples, by a plain
    recount of G's calls, and at most raster_live_r{r}; round 0 fetches
    where G hit; round 1's lanes are live behind round 0's discards."""
    _, r, _, _ = frames
    hits = []
    inner = rp.raster_edge

    def recount(*args):
        out = inner(*args)
        hits.append(int((out[1] >= 0).sum()))
        return out

    tracing.reset()
    rp.raster_edge = recount
    try:
        with tracing.on():
            r.render_async(CAMERAS[130])
            counts = tracing.counters("cpu")
    finally:
        rp.raster_edge = inner
    n = rp.MAX_DISCARD_ROUNDS
    assert len(hits) == 8 * n
    for k in range(n):
        fetch, live = (counts[f"raster_{c}_r{k}"] for c in ("fetch", "live"))
        assert fetch == sum(hits[k::n]) <= live
    assert 0 < counts["raster_fetch_r0"] <= counts["raster_live_r0"] == (
        W * H * 8)
    assert counts["raster_live_r1"] > 0


def test_fetch_share_metric_reads_the_counters(monkeypatch):
    """bench_torch's raster_fetch_share: the fetch counters over G's
    lanes times the frames, in %; None for a program without them (as
    the parent of kernel I) or without a traced window."""
    import spans_window

    sys.path.insert(0, str(BENCH / "metrics"))
    try:
        import raster_fetch_share
    finally:
        sys.path.remove(str(BENCH / "metrics"))
    lanes = [("raster_edge", "raster_edge_s0", 1000)] * 4 + [
        ("raster_sample", "raster_sample", 1000)] * 4
    win = SimpleNamespace(counters={"raster_live_r0": 2000,
                                    "raster_fetch_r0": 1500,
                                    "raster_fetch_r1": 100}, lanes=lanes, n=2)
    monkeypatch.setattr(spans_window, "window", lambda run: win)
    assert raster_fetch_share.read(None) == pytest.approx(100.0 * 1600 / 8000)
    win.counters = {"raster_live_r0": 2000, "raster_live_r1": 30}
    assert raster_fetch_share.read(None) is None
    monkeypatch.setattr(spans_window, "window", lambda run: None)
    assert raster_fetch_share.read(None) is None
