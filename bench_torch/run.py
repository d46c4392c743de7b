#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once and prints its result line.

    python3 bench_torch/run.py --workload c4-fly --seed 7 --seconds 20 \\
        --trace 0

from the root of a checkout that holds BENCHMARK.json and the port's
package vkrt_tpu_torch, on a machine with an NVIDIA card. The pieces are
found by name (spec.py): the configuration and the program entry it
names, the traffic mix and the generator it names, the cell's check
limits and one reader per metric, so a new cell, mix, entry or metric is
a new file and a new entry in BENCHMARK.json.

A run: make the scene (scene_gen.py), build the program at the
configuration's settings (entries/, e.g. the port's Renderer), capture
its frame graph and run warm frames (all of that is `setup_s`); then,
for `--seconds`, submit frames of the traffic mix through the port's own
FrameScheduler (Renderer.render_async: one replayed CUDA graph a frame,
`inflight` frames queued) and drain them. With `--trace 1` a drained
window over fixed path frames follows under torch.profiler, then the
same frames once more, each submitted to an idle card, for the host's
own enqueue time. The device memory peak is read, the program is freed,
and the plain reference renders frames that the window retired, drawn
from the seed, to decide `correct` (check.py). The last line of stdout
is the result as JSON; the compared numbers and their limits are the
last lines of stderr too.

Without a CUDA card (or with fewer than the cell asks for) it exits 2
and prints no result. Kernel builds go under vkrt_tpu_torch/_build/ in
the checkout, so only a checkout's first run compiles.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "vkrt_tpu_torch" / "_build"
os.environ["VKRT_TORCH_CACHE"] = str(BUILD)      # the port's only build cache
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

import check  # noqa: E402
import scene_gen  # noqa: E402
import spec  # noqa: E402
import stats  # noqa: E402

KEEP_STRIDE = 16        # window frames kept for the check: every 16th


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def seed64(seed: int) -> int:
    return seed % (1 << 64)


def to_model(scene):
    """The benchmark's Scene as the port's Model."""
    from vkrt_tpu_torch.scene.model import Image, Material, Model, Submesh
    return Model(
        submeshes=[Submesh(s.positions, s.normals, s.uvs, s.tangents,
                           s.indices, s.material) for s in scene.submeshes],
        materials=[Material(*m) for m in scene.materials],
        images=[Image(width=im.shape[1], height=im.shape[0], data=im)
                for im in scene.images])


def power_limit() -> str:
    """The card's name and power limit (the benchmark's own reading)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def frames_of(cell, seed):
    """The traffic's frames at the configuration's size, from the seed."""
    r = cell.config["render"]
    return spec.generator(cell).Frames(cell.traffic, r["width"],
                                       r["height"], seed64(seed))


def setup(cell, scene, device, seed):
    """The program at the cell's configuration with its graph captured
    and warm frames run, and the traffic's frames."""
    import torch
    from vkrt_tpu_torch import runtime
    if torch.device(device).type == "cuda":
        runtime.initialize(device)
    entry = spec.entry(cell).build(to_model(scene), cell.config, device)
    frames = frames_of(cell, seed)
    inflight = int(cell.traffic["inflight"])
    warm = 2 * inflight + 2
    sched = runtime.FrameScheduler(inflight=inflight)
    for i in range(warm):
        _, pose, m = frames(i)
        sched.submit(entry.frame, pose, m)
    for _ in sched.drain():
        pass
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return SimpleNamespace(entry=entry, frames=frames, base=warm,
                           inflight=inflight, device=device, cell=cell)


def window(state, seconds, seed, fn=None):
    """Frames submitted for `seconds`, then drained: per frame the time
    from its submit to its u8 frame on the host and its ray count; every
    KEEP_STRIDE-th frame's outputs are kept for the check."""
    from vkrt_tpu_torch import runtime
    fn = fn or state.entry.frame
    phase = int(np.random.default_rng([seed64(seed), 2]).integers(
        KEEP_STRIDE))
    sched = runtime.FrameScheduler(inflight=state.inflight)
    submitted, latency, rays, kept = {}, [], {}, {}
    last = None

    def retired(r):
        nonlocal last
        idx, (fb, n) = r
        latency.append((time.perf_counter() - submitted[idx]) * 1e3)
        rays[idx] = int(n)
        last = idx, (fb, int(n))
        if idx % KEEP_STRIDE == phase:
            # a copy, so that the pinned buffer goes back to the host
            # allocator's cache and no frame pins new memory
            kept[idx] = fb.copy(), int(n)

    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or i == 0:
        _, pose, m = state.frames(state.base + i)
        submitted[i] = time.perf_counter()
        r = sched.submit(fn, pose, m)
        if r is not None:
            retired(r)
        i += 1
    for r in sched.drain():
        retired(r)
    wall = time.perf_counter() - t0
    if not kept:                       # a window shorter than the stride
        kept[last[0]] = last[1][0].copy(), last[1][1]
    return SimpleNamespace(wall_s=wall, submitted=i, latency_ms=latency,
                           rays=rays, kept=kept,
                           frames=len(rays), rays_total=sum(rays.values()))


def _kineto(prof):
    """(device ops, host ranges) of a profile as (name, start s, end s)."""
    import torch
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA
         else host).append((e.name(), s, s + e.duration_ns() * 1e-9))
    return dev, host


def trace_path_frames(state):
    """The path frames a traced window covers: every `trace_every`-th of
    the loop (cells/<workload>.json), the same on every seed."""
    return list(range(0, len(state.frames),
                      int(state.cell.check["trace_every"])))


def enqueue_probe(state, ks, fn=None):
    """Host ms of the frame call for path frames `ks`, each submitted to
    an idle card: the host's own work (inputs copied in, the graph
    launched, outputs cloned), where a queued launch would wait for the
    card to free room in its command buffer."""
    import torch
    render = fn or state.entry.frame
    cuda = torch.device(state.device).type == "cuda"
    out = []
    for k in ks:
        pose, m = state.frames.at(k)
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        r = render(pose, m)
        out.append((time.perf_counter() - t) * 1e3)
        del r
    if cuda:
        torch.cuda.synchronize()
    return out


def traced(state, fn=None):
    """A drained, profiled window over trace_path_frames through the
    window's own scheduler: device ops and host ranges, the window's
    bounds; then enqueue_probe over the same frames."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from vkrt_tpu_torch import runtime
    render = fn or state.entry.frame
    ks = trace_path_frames(state)
    acts = [ProfilerActivity.CPU]
    if torch.device(state.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sched = runtime.FrameScheduler(inflight=state.inflight)
    with profile(activities=acts) as prof:
        with record_function("bench.traced_window"):
            for k in ks:
                pose, m = state.frames.at(k)
                with record_function("bench.submit"):
                    sched.submit(render, pose, m)
            with record_function("bench.drain"):
                for _ in sched.drain():
                    pass
            if torch.device(state.device).type == "cuda":
                torch.cuda.synchronize()
    ops, host = _kineto(prof)
    # the profiler mirrors each host range onto the device's timeline
    # (gpu_user_annotation): only kernels, copies and sets are device ops
    named = {n for n, _, _ in host}
    ops = [o for o in ops if o[0] not in named]
    win = [(s, e) for name, s, e in host if name == "bench.traced_window"]
    lo, hi = win[0] if win else (min(s for _, s, _ in ops + host),
                                 max(e for _, _, e in ops + host))
    ops = [o for o in ops if o[2] > lo and o[1] < hi]
    return SimpleNamespace(ops=ops, host=host, lo=lo, hi=hi,
                           frames=len(ks),
                           enqueue_ms=enqueue_probe(state, ks, fn))


def breakdown(tr):
    """The device ops that took most time and the longest idle gaps, by
    what the host was doing."""
    ops = stats.top(stats.by_name(tr.ops).items())
    idle = [(stats.host_label(tr.host, s, e), e - s)
            for s, e in stats.gaps([(s, e) for _, s, e in tr.ops],
                                   tr.lo, tr.hi)]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in stats.top(idle)]}


def reference_frames(state, scene, idx, tf32=False):
    """(window index, u8 frame, rays, closest-hit rays per pixel) of the
    entry's reference for the window's frames `idx` (TF32 inputs to its
    matmuls: the control)."""
    items = [state.frames(state.base + i)[1:] for i in idx]
    refs = spec.entry(state.cell).reference_frames(
        scene, state.cell.config, items, state.device, tf32)
    for i, ref in zip(idx, refs):
        yield (i, *ref)


def compare(state, scene, win, seed):
    """check.py's numbers, the worst over the window's frames drawn from
    the seed, and those frames."""
    idx = check.sample(win.kept, int(state.cell.check["check_frames"]),
                       seed64(seed))
    readings = [check.compare(*win.kept[i], *ref)
                for i, *ref in reference_frames(state, scene, idx)]
    return check.worst(readings), idx


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None,
             fault=None):
    """One run of `cell`: the result dict (module docstring). `fault`, for
    tests, wraps the timed path's frame function."""
    import torch
    t_start = T0 if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = setup(cell, scene, device, seed)
    fn = fault(state.entry.frame) if fault else None
    setup_s = time.perf_counter() - t_start
    win = window(state, seconds, seed, fn)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = SimpleNamespace(setup_s=setup_s, window=win, peak_bytes=peak,
                          trace=None, state=state, cuda=cuda)
    if trace:
        run.trace = traced(state, fn)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    if cuda:          # a number from the CPU is never a device metric
        for m in wanted:
            v = spec.reader(m["name"], cell.here)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    state.entry.free()
    state.entry = None
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, frames = compare(state, scene, win, seed)
    print(f"bench: setup {setup_s:.2f} s, window {win.wall_s:.2f} s "
          f"({win.frames} frames), reference {time.perf_counter() - t_ref:.2f}"
          f" s ({len(frames)} frames)", file=sys.stderr)
    limits = cell.check["limits"]
    ok = check.verdict(numbers, limits)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": peak}
    if cuda:
        device_info["power"] = power_limit()
    if trace and cuda:
        device_info["busy_s"] = stats.busy(
            [(s, e) for _, s, e in run.trace.ops], run.trace.lo,
            run.trace.hi)
        device_info["window_s"] = run.trace.hi - run.trace.lo
    missing = win.submitted - win.frames
    out = {"correct": ok and missing == 0, "attempted": win.submitted,
           "failed": missing + (0 if ok else len(frames)),
           "metrics": metrics, "device": device_info}
    if trace and cuda:
        out["breakdown"] = breakdown(run.trace)
    out["frames_compared"] = frames
    out["check"] = check.report(numbers, limits)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_torch: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, args.trace)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
