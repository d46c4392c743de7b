"""Times of the port's kernels A, A', B, E, F and G, for comparing two checkouts on one card.

    python3 tools/port_kernel_timing.py [--frames N]
        [--parts trace,occluded,sort,unsort,raster,rebuild]

Run it from the root of a checkout of the repository on a machine with an
NVIDIA GPU and nvcc; it imports `vkrt_tpu_torch` (and chip_smoke.py's
recording helpers) from the working directory, so the same file run from
two checkouts (one unpacked beside the other, in turns) compares their
kernels on one card, minutes apart.

  * trace: A (`trace_dense`) and B (`occluded_multi`) on the full
    procedural scene at 1920x1080: config-4 frames at the shipped
    defaults and config-5 `refit` frames under a y-rotation that grows
    each frame, by CUDA events between frames enqueued back to back (one
    warm-up frame first); then A and B alone on the inputs one frame at
    the start camera gives them (config 4: depths 0-1; config 5 under
    rot_y(0.02): depths 0-3), per depth, mean of 10 calls after a
    warm-up.
  * occluded: A' (`trace_occluded`): config-4 frames with the per-light
    shadow dispatch (`DenseBackend.per_light`: 8 A' launches a frame, no
    B) by CUDA events as above; then the shadow segments of one config-4
    frame at the start camera, per depth: its NS point-origin A' calls
    (one per light, as the per-light dispatch makes them), mean of 10
    after a warm-up, beside B's one call on the same segments, and
    whether A''s masks equal B's.
  * sort: E (`lane_sort`) on the depth-1 call of that frame (4 channels,
    the packed prefix in blocks of 1024 lanes), device time on a filled
    queue as for unsort below, in the order kernel, sort, sort, kernel;
    `torch.sort(stable=True)` of the keys alone beside it as a note (E
    also moves the channels and writes the ranks); whether E equals its
    plain version.
  * unsort: F (`lane_unsort`) and `torch.gather` on the same inputs, at
    the shape a 1080p config-4 frame gives F (4 channels, 510 blocks of
    1024 lanes, random in-block permutations): device time on a filled
    queue, as chip_smoke.py's `queued_ms` reads it (a ~20 ms spin kernel
    first, 24 calls behind it, rotating over copies of the inputs that
    exceed the L2), in the order kernel, gather, gather, kernel; the
    host's enqueue time per call beside it.
  * raster: G (`raster_edge`): frames of Rasterizer(full procedural scene,
    1600x1200, msaa 8) by CUDA events, then G alone on one frame's 32
    recorded calls, summed per discard round.
  * rebuild: config-5 frames (1920x1080, depth 4) with rebuild="full"
    (the device SAH order every frame) and "full_morton" under the
    y-rotation that grows each frame, by CUDA events as above, then the
    same frames one at a time: the host's ms to enqueue each, and the
    caching allocator's cudaMalloc / cudaFree calls over them; then
    `device_sah_order` alone (the shipped mode) on the scene's
    triangles: device ms by CUDA events and the host's enqueue ms per
    call, mean of 5 after a warm-up. Not in the default --parts.

Prints the card's nvidia-smi name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from vkrt_tpu_torch import config as C                       # noqa: E402
from vkrt_tpu_torch import kernels, runtime                  # noqa: E402
from vkrt_tpu_torch.app.flythrough import camera_path        # noqa: E402
from vkrt_tpu_torch.raster import edge                       # noqa: E402
from vkrt_tpu_torch.raster import pipeline as rp             # noqa: E402
from vkrt_tpu_torch.rt.dense import trace_dense, trace_occluded  # noqa: E402
from vkrt_tpu_torch.rt.occl_multi import occluded_multi      # noqa: E402
from vkrt_tpu_torch.scene.procedural import procedural_model  # noqa: E402
from vkrt_tpu_torch.wavefront import lanesort                # noqa: E402
from vkrt_tpu_torch.wavefront.engine import (Renderer,       # noqa: E402
                                             render_frame_u8)

SPIN_CYCLES = 40_000_000
REPS = 24


def queued_ms(calls) -> dict:
    """Device ms per call of `calls` (taken in turn) behind a spin kernel,
    and the host's enqueue ms per call. Fails if the device reached the
    first call before the host had enqueued the last: the time read then
    would be the host's."""
    for f in calls:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(REPS):
        calls[i % len(calls)]()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    filled = not start.query()
    torch.cuda.synchronize()
    if not filled:
        raise AssertionError(f"the host took {host_ms:.1f} ms to enqueue "
                             f"{REPS} calls: the queue did not stay filled")
    return {"ms": start.elapsed_time(end) / REPS,
            "enqueue_ms": host_ms / REPS}


def time_unsort(dev) -> dict:
    rng = np.random.default_rng(0)
    block, nblocks, s = 1024, 510, 4
    copies = []
    for _ in range(6):                      # 6 x 19 MB > the 50 MB L2
        rank = np.stack([rng.permutation(block) for _ in range(nblocks)])
        rank = torch.as_tensor(rank.reshape(-1, 128).astype(np.int32),
                               device=dev)
        res = torch.rand((s, rank.shape[0], 128), device=dev)
        r3 = res.reshape(s, -1, block)
        idx = rank.reshape(1, -1, block).long().expand(s, -1, -1)
        copies.append((res, rank, r3, idx.contiguous()))
    res, rank, r3, idx = copies[0]
    same = torch.equal(lanesort.lane_unsort(res, rank, block=block),
                       torch.gather(r3, 2, idx).reshape(res.shape))
    f = [lambda c=c: lanesort.lane_unsort(c[0], c[1], block=block)
         for c in copies]
    g = [lambda c=c: torch.gather(c[2], 2, c[3]) for c in copies]
    runs = [queued_ms(f), queued_ms(g), queued_ms(g), queued_ms(f)]
    return {"shape": list(res.shape), "block": block,
            "equal_to_gather": same,
            "kernel": [runs[0], runs[3]], "gather": [runs[1], runs[2]]}


def time_raster(dev, frames: int) -> dict:
    cfg = C.reference_config()
    rast = rp.Rasterizer(procedural_model("full", seed=0), cfg, dev, msaa=8)
    cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                 frames + 1))
    rast.render_async(cams[0])
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(frames + 1)]
    ev[0].record()
    for k in range(frames):
        rast.render_async(cams[k + 1])
        ev[k + 1].record()
    torch.cuda.synchronize()
    frame_ms = [ev[k].elapsed_time(ev[k + 1]) for k in range(frames)]

    calls, inner = [], rp.raster_edge

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return inner(*args)

    rp.raster_edge = record
    try:
        eager = copy.copy(rast)         # a replayed graph runs no Python
        eager.graph = False
        eager.render_async(cams[0])
        torch.cuda.synchronize()
    finally:
        rp.raster_edge = inner
    edge.raster_edge(*calls[0])
    spans = []
    for c in calls:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        edge.raster_edge(*c)
        b.record()
        spans.append((a, b))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in spans]
    return {"frame_ms": frame_ms, "g_calls": len(ms), "g_ms_frame": sum(ms),
            "g_ms_by_round": [sum(ms[r::4]) for r in range(4)],
            "g_ms_round_max": [max(ms[r::4]) for r in range(4)]}


def event_ms(fn, reps: int) -> float:
    """Mean device ms of `fn()` by CUDA events, after one warm-up call."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def frames_ms(r, cams, transforms=None) -> list:
    """Device ms of each frame after a warm-up, enqueued back to back."""
    tf = (lambda k: ()) if transforms is None else (lambda k:
                                                    (transforms[k],))
    r.render_async(cams[0], *tf(0))
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in cams]
    ev[0].record()
    for k in range(1, len(cams)):
        r.render_async(cams[k], *tf(k))
        ev[k].record()
    torch.cuda.synchronize()
    return [ev[k - 1].elapsed_time(ev[k]) for k in range(1, len(cams))]


def kernels_by_depth(r, cam, transform=None) -> dict:
    """A and B alone on one frame's recorded inputs, ms per depth."""
    from chip_smoke import RecordingBackend
    backend = r.backend
    if transform is not None:
        backend = backend._replace(tree=r.update_tree(transform))
    rec = RecordingBackend(backend)
    render_frame_u8(rec, r.tex, torch.as_tensor(cam.proj_inverse, device=r.device),
                    torch.as_tensor(cam.view_inverse, device=r.device),
                    r.lights, r.cfg)
    torch.cuda.synchronize()
    tree = backend.tree
    a = [event_ms(lambda c=c: trace_dense(tree, *c), 10)
         for c in rec.closest_in]
    b = [event_ms(lambda c=c: occluded_multi(tree, *c), 10)
         for c in rec.occl_in]
    return {"A_ms": a, "B_ms": b, "A_frame_ms": sum(a), "B_frame_ms": sum(b)}


def record_frame(r, cam):
    """The trace inputs (chip_smoke's RecordingBackend) and the C-F inputs
    (RecordingMoves) of one frame of `r` at `cam`."""
    from chip_smoke import RecordingBackend, RecordingMoves
    rec = RecordingBackend(r.backend)
    with RecordingMoves() as moves:
        render_frame_u8(rec, r.tex,
                        torch.as_tensor(cam.proj_inverse, device=r.device),
                        torch.as_tensor(cam.view_inverse, device=r.device),
                        r.lights, r.cfg)
        torch.cuda.synchronize()
    return rec, moves


def time_occluded(r, cams, rec) -> dict:
    """Per-light frames, then A' per depth on the recorded segments (its
    NS point-origin calls) beside B on the same segments."""
    from chip_smoke import light_points
    pl = copy.copy(r)
    pl.backend = r.backend._replace(per_light=True)
    frame = frames_ms(pl, cams)
    tree = r.backend.tree
    a, b, equal = [], [], []
    for (lp, sd, st), block in zip(rec.occl_in, rec.occl_block):
        n = st[0].numel()
        calls = [(light_points(lp, s, n, block), sd[s].contiguous(),
                  st[s].contiguous()) for s in range(lp.shape[0])]

        def run_all(calls=calls, block=block):
            return [trace_occluded(tree, *c, block=block, point_origin=True)
                    for c in calls]

        kb = occluded_multi(tree, lp, sd, st)
        equal.append(all(torch.equal(out[1] >= 0, kb[s])
                         for s, out in enumerate(run_all())))
        a.append(event_ms(run_all, 10))
        b.append(event_ms(lambda: occluded_multi(tree, lp, sd, st), 10))
    return {"per_light_frame_ms": frame,
            "per_light_frame_ms_mean": float(np.mean(frame)),
            "launches_per_depth": [int(x[0].shape[0]) for x in rec.occl_in],
            "A'_ms": a, "B_ms": b, "A'_frame_ms": sum(a),
            "B_frame_ms": sum(b), "masks_equal_B": equal}


def time_sort(moves) -> dict:
    """E on the frame's depth-1 call and torch.sort of its keys alone, on
    a filled queue, rotating over copies that exceed the L2."""
    from chip_smoke import input_copies
    (x, key), kw = moves.inputs["E"][0]
    block = kw["block"]
    want = lanesort.lane_sort_plain(x, key, block)
    got = lanesort.lane_sort(x, key, block=block)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    copies = input_copies((x, key), 2 * x.numel() * 4 + 2 * key.numel() * 4)
    f = [lambda c=c: lanesort.lane_sort(*c, block=block) for c in copies]
    g = [lambda c=c: torch.sort(c[1].reshape(-1, block), dim=1, stable=True)
         for c in copies]
    runs = [queued_ms(f), queued_ms(g), queued_ms(g), queued_ms(f)]
    return {"shape": list(x.shape), "block": block, "equal_to_plain": same,
            "kernel": [runs[0], runs[3]], "keys_sort": [runs[1], runs[2]]}


def time_trace(dev, frames: int) -> dict:
    from chip_smoke import rot_y, start_camera
    cfg = C.config4_flythrough()
    r = Renderer(procedural_model("full", seed=0), cfg, dev, quantize=True)
    cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                 frames + 1))
    r5 = copy.copy(r)
    r5.cfg, r5.rebuild = C.config5_stress(), "refit"
    cam = start_camera(cfg.width, cfg.height)
    c4 = frames_ms(r, cams)
    c5 = frames_ms(r5, cams, [rot_y(0.01 * k) for k in range(len(cams))])
    return {"config4_frame_ms": c4, "config4_frame_ms_mean": float(np.mean(c4)),
            "config5_refit_frame_ms": c5,
            "config5_refit_frame_ms_mean": float(np.mean(c5)),
            "config4": kernels_by_depth(r, cam),
            "config5_refit": kernels_by_depth(r5, cam, rot_y(0.02))}


def time_rebuild(dev, frames: int) -> dict:
    from chip_smoke import rot_y
    from vkrt_tpu_torch.accel.device_sah import device_sah_order
    cfg = C.config5_stress()
    model = procedural_model("full", seed=0)
    cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                 frames + 1))
    tfs = [rot_y(0.01 * k) for k in range(len(cams))]
    out = {}
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    for mode in ("full", "full_morton"):
        r = Renderer(model, cfg, dev, quantize=True, rebuild=mode)
        ms = frames_ms(r, cams, tfs)
        out[f"config5_{mode}_frame_ms"] = ms
        out[f"config5_{mode}_frame_ms_mean"] = float(np.mean(ms))
        # the host's ms per frame alone (each frame waited for), and the
        # caching allocator's cudaMalloc / cudaFree calls over those frames
        before = torch.cuda.memory_stats(dev)
        host = []
        for k in range(1, len(cams)):
            t0 = time.perf_counter()
            r.render_async(cams[k], tfs[k])
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        after = torch.cuda.memory_stats(dev)
        out[f"config5_{mode}_host_ms"] = host
        out[f"config5_{mode}_allocator"] = {
            k: after.get(k, 0) - before.get(k, 0) for k in keys}
    tris = r.rebuild_inputs()[0]
    out["sah_order_ms"] = event_ms(lambda: device_sah_order(*tris), 5)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        device_sah_order(*tris)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out["sah_order_enqueue_ms"] = float(np.mean(host))
    out["triangles"] = int(tris[0].shape[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--parts", default="trace,occluded,sort,unsort,raster")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runtime.exact_f32()
    b = kernels.build()
    ptxas = [ln.strip() for ln in b.log.splitlines()   # -Xptxas -v
             if "Compiling" in ln or "registers" in ln or "spill" in ln]
    out = {"cwd": os.getcwd(), "build_s": b.seconds}
    if "trace" in parts:
        out["trace"] = time_trace(dev, args.frames)
    if "occluded" in parts or "sort" in parts:
        from chip_smoke import start_camera
        cfg = C.config4_flythrough()
        r = Renderer(procedural_model("full", seed=0), cfg, dev, quantize=True)
        rec, moves = record_frame(r, start_camera(cfg.width, cfg.height))
        if "occluded" in parts:
            cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                         args.frames + 1))
            out["occluded"] = time_occluded(r, cams, rec)
        if "sort" in parts:
            out["sort"] = time_sort(moves)
        del r, rec, moves
    if "unsort" in parts:
        out["unsort"] = time_unsort(dev)
    if "raster" in parts:
        out["raster"] = time_raster(dev, args.frames)
    if "rebuild" in parts:
        out["rebuild"] = time_rebuild(dev, args.frames)
    print(runtime.nvidia_smi_line())
    for ln in ptxas:
        print("ptxas:", ln)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
