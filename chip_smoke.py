"""Smoke run of vkrt_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:
  1. device   fail at once without CUDA; print the device report
  2. build    compile kernels A-F from vkrt_tpu_torch/csrc/ into one
              library (one nvcc per source, all started together)
  3. kernel A vs its plain PyTorch version on the card (~64k rays on the
              full procedural scene: camera + scattered rays, some parked)
  4. kernel B vs its plain version (shadow segments of phase 3's hits,
              with parked and near-light segments)
  5. C-F      kernels C, D (live-ray pack) and E, F (in-block lane sort)
              vs their plain versions on probes: liveness 0, 0.1, 0.27,
              0.9, 1 and clustered; keys with many ties; blocks 512 and
              1024; bit-equal, dead tail 0
  6. frame    a 64x48 config-4 frame of the small scene at the shipped
              defaults vs the numpy brute-force oracle
              (vkrt_tpu.golden.cpu_tracer)
  7. main     Renderer.render_async → render_frame_u8 at config 4's
              shipped defaults (the depth>=1 shadow reorder on),
              1920x1080, full procedural scene (262,267 triangles): one
              warm-up frame, then 8 timed frames along the fly-through
              camera path; exactly A 2, B 2, C 1, D 1, E 1, F 1 launches
              per frame
  8. flags off  the same frames with the three reorder flags off (the
              path before C-F): A 2, B 2 and no C-F launches per frame;
              its u8 frames and ray counts must equal phase 7's bit for bit
  9. shapes   kernels A-F vs their plain versions on the inputs one
              main-path frame gives them (recorded from the engine), and
              their times there
  then   two profiled main-path frames, then two flags-off frames (device
         time per engine range, busy share, top kernels)
Then the card's nvidia-smi name and power limit, one JSON line with each
kernel's launches in phase 7, its largest error in phases 3-5 and 9 and
its phase-9 times per frame, and, as the last line,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import sys
import time
import types

import numpy as np
import torch

from vkrt_tpu import config as C
from vkrt_tpu.app.camera import Camera
from vkrt_tpu.app.flythrough import camera_path
from vkrt_tpu.app.framebuffer import rmse
from vkrt_tpu.golden.cpu_tracer import render_golden
from vkrt_tpu.scene import build_texture_heap
from vkrt_tpu_torch import kernels, runtime
from vkrt_tpu_torch.rt.dense import trace_dense, trace_dense_plain
from vkrt_tpu_torch.rt.occl_multi import occluded_multi, occluded_multi_plain
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade import shading
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine, lanesort, pack
from vkrt_tpu_torch.wavefront.engine import (Renderer, camera_ray_blocks,
                                             render_frame_u8)

SEED = 0
N_FRAMES = 8
PROFILE_FRAMES = 2
HIT_AGREE = 0.999        # kernel A vs plain: hit masks
SLOT_AGREE = 0.999       # kernel A vs plain: slots (t, u, v, attrs
                         # bit-equal wherever the slots agree)
BLOCK_AGREE = 0.9999     # kernel B vs plain: blocked masks
T_RTOL = 1e-5            # kernel A vs plain: t where both hit
GOLDEN_RMSE = 1e-3       # frame vs oracle (BASELINE.json bar)
                         # C-F vs plain: equal (they move values, no math)
REORDER_OFF = dict(consolidate_secondary=False, group_sort_shadows=False,
                   partition_shadows=False)
# kernel → wrapper whose `launches` counts its launches
COUNTED = {"A": trace_dense, "B": occluded_multi, "C": pack.consolidate,
           "D": pack.scatter_back, "E": lanesort.lane_sort,
           "F": lanesort.lane_unsort}
PLAIN = {"C": pack.consolidate_plain, "D": pack.scatter_back_plain,
         "E": lanesort.lane_sort_plain, "F": lanesort.lane_unsort_plain}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of `fn()` on the card (CUDA events), after one
    warm-up call unless `warmup` is False."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def start_camera(width: int, height: int) -> Camera:
    cam = Camera(width, height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return cam


def probe_rays(device):
    """~64k lane-major rays: camera rays of a 256x128 view from the start
    pose, then as many scattered rays from inside the hall; 20% parked."""
    cfg = dataclasses.replace(C.config4_flythrough(), width=256, height=128)
    cam = start_camera(256, 128)
    pi = torch.as_tensor(cam.proj_inverse, device=device)
    vi = torch.as_tensor(cam.view_inverse, device=device)
    opt, cd, _ = camera_ray_blocks(pi, vi, cfg)
    nb = cd.shape[1]
    co = opt[:, None, None].expand(3, nb, L.LANES)
    rng = np.random.default_rng(SEED)
    n = nb * L.LANES
    so = rng.uniform([-17, -1, -10], [17, 13, 11], (n, 3)).astype(np.float32)
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    so = L.to_cvec(torch.as_tensor(so, device=device))
    sd = L.to_cvec(torch.as_tensor(sd, device=device))
    o = torch.cat([co, so], dim=1).contiguous()
    d = torch.cat([cd, sd], dim=1).contiguous()
    tmax = torch.as_tensor(
        np.where(rng.random((2 * nb, L.LANES)) < 0.2, 0.0, C.RAY_TMAX),
        dtype=torch.float32, device=device)
    return o, d, tmax


def shadow_inputs(u, v, attrs, hit, lights):
    """Shadow segments of a closest-hit result toward every light (parked
    where the ray missed), plus 16 near-light segments per light with an
    empty interval."""
    pos = shading.interpolate(attrs, u, v)[0]
    geo = [shading.light_geometry(pos, lights[s]) for s in range(len(lights))]
    sd = torch.stack([-g[0] for g in geo]).contiguous()
    st = torch.stack([torch.where(hit, g[1] - C.RAY_TMIN, 0.0) for g in geo])
    st[:, 0, :16] = 0.0009
    return lights.contiguous(), sd, st.contiguous()


def compare_closest(tree, o, d, tmax, label: str = "") -> dict:
    """Kernel A vs its plain version on the same inputs: hit masks and
    slots agree on at least HIT_AGREE / SLOT_AGREE of the rays, t to
    T_RTOL where both hit, and t, u, v and attrs are bit-equal on every
    ray whose slots agree (misses included: inf, 0, 0, 0)."""
    kt, ks, ku, kv, ka = trace_dense(tree, o, d, tmax)
    pt, ps, pu, pv, pa = trace_dense_plain(tree, o, d, tmax)
    torch.cuda.synchronize()
    kh, ph = ks >= 0, ps >= 0
    agree = (kh == ph).float().mean().item()
    both = kh & ph
    same = ks == ps
    t_err = (((kt - pt).abs() / pt.abs())[both].max().item()
             if both.any() else 0.0)
    hs = same & kh
    abs_err = max((kt - pt)[hs].abs().max().item(),
                  (ku - pu)[hs].abs().max().item(),
                  (kv - pv)[hs].abs().max().item(),
                  (ka - pa)[:, hs].abs().max().item()) if hs.any() else 0.0
    equal = {k: bool(torch.equal(a[..., same], b[..., same]))
             for k, a, b in (("t", kt, pt), ("u", ku, pu), ("v", kv, pv),
                             ("attrs", ka, pa))}
    out = dict(rays=int(o.shape[1] * L.LANES), live_frac=(tmax > 0).float()
               .mean().item(), hit_frac=kh.float().mean().item(),
               hit_agree=agree, slot_agree=same.float().mean().item(),
               slots_differ=int((~same).sum().item()), t_max_rel_err=t_err,
               bit_equal_where_slots_agree=equal, max_abs_err=abs_err)
    log(f"  kernel A vs plain{label}:", json.dumps(out))
    if (agree < HIT_AGREE or out["slot_agree"] < SLOT_AGREE
            or t_err > T_RTOL or not all(equal.values())):
        raise AssertionError(f"kernel A disagrees with its plain version: "
                             f"{out}")
    return out


def compare_occl(tree, lp, sd, st, near: bool = True,
                 label: str = "") -> dict:
    """Kernel B vs its plain version on the same inputs; parked
    segments, and the planted near-light ones (`near`), are not
    blocked."""
    kb = occluded_multi(tree, lp, sd, st)
    pb = occluded_multi_plain(tree, lp, sd, st)
    torch.cuda.synchronize()
    agree = (kb == pb).float().mean().item()
    live = st > C.RAY_TMIN
    out = dict(segments=int(st.numel()), live_frac=live.float().mean().item(),
               blocked_frac=kb.float().mean().item(), mask_agree=agree,
               masks_differ=int((kb != pb).sum().item()),
               near_light_blocked=near and bool(kb[:, 0, :16].any()),
               parked_blocked=bool(kb[st == 0].any()),
               max_abs_err=(kb.float() - pb.float()).abs().max().item())
    log(f"  kernel B vs plain{label}:", json.dumps(out))
    if (agree < BLOCK_AGREE or out["near_light_blocked"]
            or out["parked_blocked"]):
        raise AssertionError(f"kernel B disagrees with its plain version: "
                             f"{out}")
    return out


def compare_move(k: str, args, kw, label: str = "") -> float:
    """Kernel k (one of C-F) vs its plain version on the same inputs: the
    outputs must be equal (they move f32 values, no arithmetic), and C's
    output must be 0 past the last live rank. Returns the largest
    absolute difference (0.0)."""
    got = COUNTED[k](*args, **kw)
    want = PLAIN[k](*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(((g.float() - w.float()).abs().max().item()
               if g.numel() else 0.0) for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    tail = True
    if k == "C":
        nlive = int((args[1] >= 0).sum().item())
        tail = not got[0].reshape(got[0].shape[0], -1)[:, nlive:].any()
    if not (equal and tail):
        raise AssertionError(f"kernel {k} disagrees with its plain version"
                             f"{label}: equal {equal}, dead tail 0 {tail}, "
                             f"max abs err {err}")
    return err


def probe_moves(device) -> dict:
    """Phase 5: kernels C-F vs their plain versions on probes of 1024 rows
    (131,072 rays). C and D at liveness 0, 0.1, 0.27, 0.9, 1 and
    clustered, 16 channels (values past the last live rank planted as
    777, which must not come back); E and F at blocks 512 and 1024 with
    keys of many ties, mostly-dead keys and the full 18-bit range, and
    unsort(sort(x)) == x. C and D take no block. Returns each kernel's
    largest error."""
    rng = np.random.default_rng(SEED)
    nb = 1024
    errs = dict.fromkeys("CDEF", 0.0)
    x = torch.as_tensor(rng.normal(size=(16, nb, L.LANES)).astype(np.float32),
                        device=device)
    clustered = np.zeros((nb, L.LANES), bool)
    clustered[80:144] = True
    clustered[800:816] = True
    lives = {f"{f}": rng.random((nb, L.LANES)) < f
             for f in (0.0, 0.1, 0.27, 0.9, 1.0)}
    lives["clustered"] = clustered
    for name, live in lives.items():
        grank = pack.consolidate_plan(torch.as_tensor(live, device=device))
        errs["C"] = max(errs["C"], compare_move("C", (x, grank), {},
                                                f" (live {name})"))
        nlive = int(live.sum())
        res = x[:4].clone()
        res.reshape(4, -1)[:, nlive:] = 777.0
        errs["D"] = max(errs["D"], compare_move("D", (res, grank), {},
                                                f" (live {name})"))
        if (pack.scatter_back(res, grank) == 777.0).any():
            raise AssertionError(f"scatter_back leaked past the last live "
                                 f"rank (live {name})")
    dead = 1 << 18
    keys = {"ties": rng.integers(0, 40, (nb, L.LANES)),
            "mostly_dead": np.where(rng.random((nb, L.LANES)) < 0.27,
                                    rng.integers(0, dead, (nb, L.LANES)),
                                    dead),
            "full": rng.integers(0, dead + 1, (nb, L.LANES))}
    x4 = x[:4].contiguous()
    for block in (512, 1024):
        for name, key in keys.items():
            key = torch.as_tensor(key.astype(np.int32), device=device)
            label = f" (block {block}, keys {name})"
            errs["E"] = max(errs["E"], compare_move(
                "E", (x4, key), {"block": block}, label))
            srt, rank = lanesort.lane_sort(x4, key, block=block)
            errs["F"] = max(errs["F"], compare_move(
                "F", (srt, rank), {"block": block}, label))
            if not torch.equal(lanesort.lane_unsort(srt, rank, block=block),
                               x4):
                raise AssertionError(f"lane_unsort(lane_sort(x)) != x{label}")
    log(f"  C-F vs plain on probes: {len(lives)} liveness cases (C, D), "
        f"{2 * len(keys)} block/key cases (E, F), all equal; max abs err "
        + json.dumps(errs))
    return errs


class RecordingMoves:
    """While active, the engine's calls of kernels C-F go through wrappers
    that keep a copy of their inputs: the engine's `pack` and `lanesort`
    names are swapped for copies of those modules' namespaces with the
    four wrappers replaced (the modules themselves, and so the launch
    counts, are untouched)."""

    SITES = {"C": ("pack", "consolidate"), "D": ("pack", "scatter_back"),
             "E": ("lanesort", "lane_sort"), "F": ("lanesort", "lane_unsort")}

    def __init__(self):
        self.inputs = {k: [] for k in self.SITES}
        self.saved = {}

    def __enter__(self):
        for m in ("pack", "lanesort"):
            self.saved[m] = getattr(engine, m)
            setattr(engine, m, types.SimpleNamespace(**vars(self.saved[m])))
        for k, (m, name) in self.SITES.items():
            setattr(getattr(engine, m), name, self._recorder(k, COUNTED[k]))
        return self

    def __exit__(self, *exc):
        for m, mod in self.saved.items():
            setattr(engine, m, mod)

    def _recorder(self, k, fn):
        def call(*args, **kw):
            self.inputs[k].append((tuple(a.clone() for a in args), kw))
            return fn(*args, **kw)
        return call


class RecordingBackend:
    """Wraps a trace backend and keeps a copy of every input it is
    given, so the kernels can be checked on a frame's own wavefronts."""

    def __init__(self, inner):
        self.inner = inner
        self.scene_aabb = inner.scene_aabb
        self.closest_in, self.occl_in = [], []

    def closest(self, o, d, tmax):
        self.closest_in.append((o.clone(), d.clone(), tmax.clone()))
        return self.inner.closest(o, d, tmax)

    def occluded_multi(self, light_pts, sd, st):
        self.occl_in.append((light_pts.clone(), sd.clone(), st.clone()))
        return self.inner.occluded_multi(light_pts, sd, st)


def main_path_shapes(renderer: Renderer, cam: Camera) -> dict:
    """Phase 9: record the inputs kernels A-F get in one main-path frame,
    hold each kernel against its plain version on them, and time both
    there (kernel: mean of 5 after a warm-up; plain: one run). Also
    reports the depth-1 shadow wavefront's live share and how much of it
    the lane sort's capped prefix covers."""
    rec = RecordingBackend(renderer.backend)
    pi = torch.as_tensor(cam.proj_inverse, device=renderer.device)
    vi = torch.as_tensor(cam.view_inverse, device=renderer.device)
    with RecordingMoves() as moves:
        render_frame_u8(rec, renderer.tex, pi, vi, renderer.lights,
                        renderer.cfg)
        torch.cuda.synchronize()
    tree = renderer.backend.tree
    res = {k: [] for k in COUNTED}
    for depth, (o, d, tm) in enumerate(rec.closest_in):
        r = compare_closest(tree, o, d, tm, f" (main path, depth {depth})")
        r["ms"] = cuda_ms(lambda: trace_dense(tree, o, d, tm), 5)
        r["plain_ms"] = cuda_ms(lambda: trace_dense_plain(tree, o, d, tm),
                                1, warmup=False)
        res["A"].append(r)
    for depth, (lp, sd, st) in enumerate(rec.occl_in):
        r = compare_occl(tree, lp, sd, st, near=False,
                         label=f" (main path, depth {depth})")
        r["ms"] = cuda_ms(lambda: occluded_multi(tree, lp, sd, st), 5)
        r["plain_ms"] = cuda_ms(
            lambda: occluded_multi_plain(tree, lp, sd, st), 1, warmup=False)
        res["B"].append(r)
    for k, calls in moves.inputs.items():
        if len(calls) != 1:
            raise AssertionError(f"recorded {len(calls)} calls of kernel {k}"
                                 f" in one frame, want 1")
        args, kw = calls[0]
        r = {"shape": list(args[0].shape),
             "max_abs_err": compare_move(k, args, kw, " (main path)")}
        r["ms"] = cuda_ms(lambda: COUNTED[k](*args, **kw), 5)
        r["plain_ms"] = cuda_ms(lambda: PLAIN[k](*args, **kw), 1,
                                warmup=False)
        log(f"  kernel {k} vs plain (main path, depth 1):", json.dumps(r))
        res[k].append(r)
    grank = moves.inputs["C"][0][0][1]
    n = grank.numel()
    nlive = int((grank >= 0).sum().item())
    sorted_rays = moves.inputs["E"][0][0][1].numel()
    share = dict(rays=n, live=nlive, live_share=nlive / n,
                 lane_sorted_rays=sorted_rays,
                 live_sorted_share=min(nlive, sorted_rays) / max(nlive, 1))
    log("  depth-1 shadow wavefront:", json.dumps(share))
    for k, rows in res.items():
        log(f"  {k} per call: " + "; ".join(
            f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.1f} ms"
            for r in rows))
    want = renderer.cfg.max_depth
    if len(res["A"]) != want or len(res["B"]) != want:
        raise AssertionError(f"recorded {len(res['A'])} A and {len(res['B'])}"
                             f" B inputs, want {want} each")
    return res


def golden_frame(device) -> float:
    """Phase 6: small scene at 64x48, config 4 at the shipped defaults,
    port on `device` vs the brute-force oracle. Returns the RMSE."""
    model = procedural_model("small", seed=SEED)
    cfg = dataclasses.replace(C.config4_flythrough(), width=64, height=48)
    r = Renderer(model, cfg, device)
    cam = start_camera(64, 48)
    fb, rays = r.render(cam)
    want = render_golden(r.flat, build_texture_heap(model.images),
                         cam.proj_inverse, cam.view_inverse, cfg,
                         accel="brute")
    err = rmse(fb, want)
    log(f"  64x48 frame vs oracle: rmse {err:.3e} (bar {GOLDEN_RMSE}), "
        f"rays {rays}, finite {bool(np.isfinite(fb).all())}")
    if not (np.isfinite(fb).all() and fb.shape == (48, 64, 3)
            and err <= GOLDEN_RMSE):
        raise AssertionError(f"frame vs oracle failed: rmse {err}")
    return err


def drive(renderer: Renderer, cams, per_frame: dict, label: str):
    """Phases 7 and 8: a warm-up frame on cams[0], then one timed frame
    per further camera, enqueued back to back through render_async.
    Every launch count is set to 0 just before and read just after; each
    must be per_frame[k] times the number of frames. Returns (results,
    [(u8 frame, ray count)] per camera)."""
    cfg = renderer.cfg
    n = len(cams) - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in COUNTED.values():
        f.launches = 0
    wall0 = time.perf_counter()
    first = renderer.render_async(cams[0])                  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - wall0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    outs = []
    wall1 = time.perf_counter()
    events[0].record()
    for k in range(n):
        outs.append(renderer.render_async(cams[k + 1]))
        events[k + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall1
    launches = {k: f.launches for k, f in COUNTED.items()}
    frame_ms = [events[k].elapsed_time(events[k + 1]) for k in range(n)]
    ray_total = sum(int(r.item()) for _, r in outs)
    total_ms = sum(frame_ms)
    res = dict(frames=n, warmup_s=warm_s,
               frame_ms=float(np.mean(frame_ms)), frame_ms_each=frame_ms,
               wall_ms_per_frame=wall_s * 1e3 / n,
               rays_per_frame=ray_total / n,
               mrays_per_s=ray_total / (total_ms * 1e3),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    log(f"  {label}:", json.dumps(res))
    want = {k: per_frame.get(k, 0) * (n + 1) for k in COUNTED}
    if launches != want:
        raise AssertionError(f"{label}: expected launches {want} "
                             f"({per_frame} per frame), got {launches}")
    outs = [first] + outs
    for fb, r in outs:
        if fb.shape != (cfg.height, cfg.width, 3) or fb.dtype != torch.uint8:
            raise AssertionError(f"frame shape {tuple(fb.shape)} {fb.dtype}")
        if int(r.item()) <= cfg.width * cfg.height:
            raise AssertionError(f"ray count {int(r.item())} too small")
        if fb.float().std().item() < 1.0:
            raise AssertionError("frame is flat")
    return res, outs


def same_frames(outs, want) -> None:
    """Phase 8's contract: the flags-off frames equal the defaults frames
    bit for bit, with equal ray counts, camera by camera."""
    diff = [int((a != b).any(dim=-1).sum().item()) for (a, _), (b, _)
            in zip(outs, want)]
    rays = [(int(ra.item()), int(rb.item())) for (_, ra), (_, rb)
            in zip(outs, want)]
    log(f"  flags-off vs defaults: pixels that differ per frame {diff}, "
        f"rays equal {all(a == b for a, b in rays)}")
    if any(diff) or any(a != b for a, b in rays) or len(outs) != len(want):
        raise AssertionError(f"flags-off frames differ from the defaults "
                             f"frames: pixels {diff}, rays {rays}")


def profile_frames(renderer: Renderer, cam: Camera, label: str) -> dict:
    """PROFILE_FRAMES frames of `renderer` enqueued back to back under
    torch.profiler: device time per engine range (record_function in
    wavefront/engine.py) and outside them, per frame; the device's busy
    share of the wall clock from the first enqueue to the last result;
    the top device kernels."""
    from torch.profiler import ProfilerActivity, profile

    n = PROFILE_FRAMES
    renderer.render_async(cam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            renderer.render_async(cam)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    names = ("trace_closest_d", "sample_d", "trace_shadow_d")
    ranges = {e.key: e.device_time_total / 1e3 / n for e in ev
              if e.key.startswith(names)}
    # device events, less the ranges' own annotations (not kernels)
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith(names)]
    busy_us = sum(e.self_device_time_total for e in dev)
    res = dict(frames=n, wall_ms_per_frame=wall_us / 1e3 / n,
               device_busy_ms_per_frame=busy_us / 1e3 / n,
               busy_share=busy_us / wall_us,
               range_ms=dict(sorted(ranges.items())),
               other_ms=busy_us / 1e3 / n - sum(ranges.values()))
    log(f"  profiled frames ({label}):", json.dumps(res))
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / n:9.3f} ms/frame "
            f"x{e.count:<4d} {e.key[:90]}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runtime.exact_f32()

    log("== 1. device")
    info = runtime.device_info(dev)
    log(json.dumps(info))
    smi = runtime.nvidia_smi_line()

    log("== 2. build")
    b = kernels.build()
    log(f"  built {b.path} in {b.seconds:.1f} s (cached: {b.cached})")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())
    kernels.library()

    log("== setup: full procedural scene, config 4 (shipped defaults)")
    t0 = time.perf_counter()
    cfg = C.config4_flythrough()
    model = procedural_model("full", seed=SEED)
    renderer = Renderer(model, cfg, dev, quantize=True)
    torch.cuda.synchronize()
    tree = renderer.backend.tree
    log(f"  {model.num_triangles} triangles, {len(model.submeshes)} "
        f"submeshes, {len(model.images)} images, "
        f"{tree.num_clusters} clusters, setup {time.perf_counter() - t0:.1f} s")

    log("== 3. kernel A vs plain")
    o, d, tmax = probe_rays(dev)
    res_a = compare_closest(tree, o, d, tmax)

    log("== 4. kernel B vs plain")
    _, slot, u, v, attrs = trace_dense(tree, o, d, tmax)
    lp, sd, st = shadow_inputs(u, v, attrs, slot >= 0, renderer.lights)
    res_b = compare_occl(tree, lp, sd, st)

    log("== 5. kernels C-F vs plain on probes")
    probe_err = probe_moves(dev)
    probe_err.update(A=res_a["max_abs_err"], B=res_b["max_abs_err"])

    log("== 6. frame vs oracle")
    golden_frame(dev)

    cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                 N_FRAMES + 1))
    log("== 7. main path: config 4 at the shipped defaults")
    res_main, outs = drive(renderer, cams, dict(A=2, B=2, C=1, D=1, E=1, F=1),
                           "main path (defaults)")

    log("== 8. config 4 with the reorder flags off, same cameras")
    off = copy.copy(renderer)
    off.cfg = dataclasses.replace(cfg, **REORDER_OFF)
    res_off, outs_off = drive(off, cams, dict(A=2, B=2), "flags off")
    same_frames(outs_off, outs)
    del outs, outs_off
    log(f"  ms/frame: defaults {res_main['frame_ms']:.3f}, flags off "
        f"{res_off['frame_ms']:.3f}")

    log("== 9. kernels vs plain at the main path's shapes")
    cam = start_camera(cfg.width, cfg.height)
    res_9 = main_path_shapes(renderer, cam)

    log(f"== profile: {PROFILE_FRAMES} main-path frames, then "
        f"{PROFILE_FRAMES} flags-off frames")
    profile_frames(renderer, cam, "defaults")
    profile_frames(off, cam, "flags off")

    def entry(name, k, src, replaces):
        rows = res_9[k]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": res_main["launches"][k],
                "max_abs_err": max([probe_err[k]]
                                   + [r["max_abs_err"] for r in rows]),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows)}

    log(smi)
    log(json.dumps({"kernels": [
        entry("trace_closest", "A", "vkrt_tpu_torch/csrc/trace_closest.cu",
              "vkrt_tpu/rt/dense.py:238"),
        entry("occl_multi", "B", "vkrt_tpu_torch/csrc/occl_multi.cu",
              "vkrt_tpu/rt/occl_multi.py:40"),
        entry("consolidate", "C", "vkrt_tpu_torch/csrc/pack.cu",
              "vkrt_tpu/wavefront/pack.py:98"),
        entry("scatter_back", "D", "vkrt_tpu_torch/csrc/pack.cu",
              "vkrt_tpu/wavefront/pack.py:200"),
        entry("lane_sort", "E", "vkrt_tpu_torch/csrc/lanesort.cu",
              "vkrt_tpu/wavefront/lanesort.py:79"),
        entry("lane_unsort", "F", "vkrt_tpu_torch/csrc/lanesort.cu",
              "vkrt_tpu/wavefront/lanesort.py:162"),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
