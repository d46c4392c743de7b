"""Smoke run of vkrt_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases; any failure raises and the run exits non-zero. They run in this
order, except that 14-18 (which share the config-4 renderer) run between
the profile after phase 9 and phase 10, and 19-23 (the app surface, the
golden gate, the reference backend, mip_lod and the sharded frames) after
phase 13:
  1. device   fail at once without CUDA; print the device report
  2. build    compile kernels A-G and A' from vkrt_tpu_torch/csrc/ into
              one library (one nvcc per source, all started together)
  3. kernel A vs its plain PyTorch version on the card (~64k rays on the
              full procedural scene: camera + scattered rays, some parked),
              then the tie probe (the most-hit triangle copied into a
              padding cluster of a higher id under the scene's box, which
              the front-to-back walk visits first: no slot may differ from
              the plain version, and the lower slot must win)
  4. kernel B vs its plain version (shadow segments of phase 3's hits,
              with parked and near-light segments), then the same segments
              regrouped: in every set a group of only blocked, only parked,
              only empty-interval segments and one with one live lane
  5. C-F      kernels C, D (live-ray pack) and E, F (in-block lane sort)
              vs their plain versions on probes: liveness 0, 0.1, 0.27,
              0.9, 1 and clustered; keys with many ties at blocks 512 and
              1024; adversarial keys for E's radix passes (all equal,
              strictly descending, 2**24 - 1, all zero, dead tails of
              2**18, both signs) at blocks 128, 256, 512 and 1024;
              bit-equal, dead tail 0
  6. frame    a 64x48 config-4 frame of the small scene at the shipped
              defaults vs the numpy brute-force oracle
              (vkrt_tpu_torch.golden.cpu_tracer)
  7. main     Renderer.render_async → render_frame_u8 at config 4's
              shipped defaults (the depth>=1 shadow reorder on),
              1920x1080, full procedural scene (262,267 triangles): one
              warm-up frame, then N_FRAMES timed frames along the
              fly-through camera path; exactly A 2, B 2, C 1, D 1, E 1,
              F 1 launches per frame
  8. flags off  the same frames with the three reorder flags off (the
              path before C-F): A 2, B 2 and no C-F launches per frame;
              its u8 frames and ray counts must equal phase 7's bit for bit
  9. shapes   kernels A-F vs their plain versions on the inputs one
              main-path frame gives them (recorded from the engine), their
              times there (C-F on a filled queue, so that the device's
              time is read and not the host's enqueue time, which is
              printed beside it), the bounds of that work and the one
              PyTorch call that computes the same function where there
              is one (F: torch.gather); A's and B's ms per depth beside
              their bound and the unfused-rate ceiling (UNFUSED x bound)
  then   two profiled main-path frames, then two flags-off frames (device
         time per engine range, busy share, top kernels)
 10. kernel G vs its plain version on probes: the full and the small
              procedural scene, from the start pose and close to a wall
              (sheets behind the camera: full-screen boxes), at three
              sample offsets, with random and parked depth floors, then a
              continuation round behind every hit; per pose a tie probe
              (one triangle in two clusters, the copy of the higher slot
              in the cluster the front-to-back walk visits first: the
              lower slot must win)
 11. raster   64x48 raster frames of the small scene vs the raster oracle
              (vkrt_tpu_torch.golden.raster_oracle): edge method at msaa 1
              and 8 under the flip gate, ray-cast method at msaa 1 by RMSE
 12. raster main  Rasterizer(full scene, reference_config() = 1600x1200,
              "cuda", msaa=8): one warm-up frame, then RASTER_FRAMES timed
              frames along the fly-through path; exactly 32 launches of G
              and none of A-F per frame; then two profiled frames (device
              time per raster range) and one ray-cast frame on the first
              camera, which may differ from the edge frame on at most 1%
              of the pixels; the same gate on a frame close to a wall,
              where clusters wholly behind the camera exist and must have
              left the full-screen set
 13. G shapes kernel G's inputs recorded from one raster frame: kernel vs
              plain on sample 0, rounds 0 and 1; the kernel's time over
              all 32 calls, the plain version's on sample 0's 4 calls, the
              bound of each, and the setup's box rule at this pose
 14. kernel A' (any-hit, per-ray or per-block origins) vs its plain
              version on probes: phase 3's rays with per-ray origins, random
              block origins and phase 4's light segments at blocks 512 and
              1024, parked and empty-interval rays, and phase 4's edge
              groups (all blocked, parked, empty, one live lane) per light;
              the point-origin masks
              must equal kernel B's, and DenseBackend.occluded /
              occluded_point return the same masks; kernel A with point
              origins and without attributes vs A's plain version, and with
              point origins equal to the broadcast origins' result
 15. per light  config 4 with DenseBackend.per_light (one A' dispatch per
              light in place of B): A 2, A' 8, C-F 1 launches per frame and
              none of B; u8 frames and ray counts bit-equal to phase 7's
              first frames; then A' vs plain and vs B on one frame's recorded
              segments, its time there beside B's, and its bound
 16. config 5   Renderer at config5_stress() (1920x1080, depth 4, 4 lights,
              rebuild_per_frame) with a y-rotation that grows every frame,
              for rebuild = refit, full (device SAH), full_morton: a warm-up
              frame + CONFIG5_FRAMES timed frames each (A 4, B 4, C-F 3
              launches per frame), the accel update's own time (mean of 5),
              then per mode two profiled frames and two frames whose engine
              ranges are timed with CUDA events (they partition the frame)
 17. config-5 gates  identity refit frame bit-equal to the frame without a
              transform; at a fixed transform the full and full_morton f32
              frames within RMSE 1e-3 of the refit frame and their camera
              hit masks equal on >= 99.9% of the pixels; a 64x48 depth-4
              frame under a transform vs the numpy oracle on the
              transformed triangles (per mode); the device-SAH order a
              permutation whose cluster area is <= 1.30x the host build's
              and < 0.8x the Morton order's on the full scene
 18. config-5 shapes  phase 9 on config 5, per rebuild mode: kernels A and
              B at all four depths and C-F at depths 1-3, each vs its plain
              version on the inputs one 1080p frame gives it on the tree
              the accel update makes under rot_y(0.02); kernel ms per depth
 19. CLI       app/cli.main(["--config", "4", "--frames", "9", "--metrics",
              "--output", png, "--checkpoint", json], scene=model) on the
              card: the pipelined fly-through (3 frames in flight,
              runtime.FrameScheduler) at 1920x1080; exactly A 2, B 2, C-F
              1 launches a frame; its last frame bit-equal to
              Renderer.render of the ninth camera, the checkpoint at frame
              9; the FrameTimer summary (wall clock: device, u8 download
              and host work); then 40 frames, whose steady wall ms/frame
              (retirements 5-37) and Mrays/s are printed beside phase 7's
              CUDA-event ms/frame
 19b. CLI raster  --raster --frames 1 at 1600x1200, msaa 8 (32 launches of
              G): equal to Rasterizer.render_async of the start camera on
              every pixel outside the FPS text
 20. golden   bench.py's gate: a 640x480 reference_config() f32 frame from
              render_frame vs the native C++ oracle with its stability
              mask (golden_metrics): rmse_stable, rmse_trimmed and
              flip_frac each <= 1e-3; stable_frac printed beside 0.90
              (the oracle's mask on the stand-in scene is below it
              whatever tracer runs: PERF.md); the oracle's seconds; then
              golden/harness.main(--oracle native, 160x120) must exit 0
 21. reference  the reference backend (LBVH built on the card, plain-PyTorch
              traversal, no kernel launches) at 320x240, reference_config():
              RMSE <= 1e-3 against the dense frame, ray counts within 0.1%;
              the LBVH build ms and the frame's ms
 22. mip_lod  config 4 at 1080p with mip_lod (1 + 2 frames, their ms beside
              phase 7's); ray_diff_lod and sample_material_trilinear on
              one frame's depth-0 inputs, card vs CPU within rtol = atol =
              1e-6
 23. sharded  parallel/mesh.py on logical shards of the one card: config 4
              at 1920x1080 through render_frame_sharded on make_mesh() (the
              card) and on [card] * 2, 4, 7 (7 pads the 16,320 rows by 4),
              1 + SHARD_FRAMES frames each: f32 frames and ray grids
              torch.equal to render_frame's on the same cameras, launches A
              2k, B 2k, C-F k a frame; per k the device ms a frame back to
              back (CUDA events), the host's enqueue ms a frame
              (perf_counter, no wait; again from an idle stream), the
              device's busy ms a frame (torch.profiler) and peak memory,
              beside the unsharded frame's; the raster frame at 1600x1200,
              MSAA 8, on 1 and 4 shards bit-equal to
              render_raster_frame_edge's (32k launches of G); the dry run
              dryrun_multichip(4, "cuda"); the CLI's --shard (2 frames, last
              frame equal to Renderer.render's) and --shard 2, which must
              raise ValueError on one card
Then the card's nvidia-smi name and power limit, one JSON line with each
kernel's launches on its main path (phase 7 for A-F, phase 15 for A', phase
12 for G), its largest error, its time per frame and the bound of that
work, and, as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import kernels, runtime
from vkrt_tpu_torch.accel import clusters
from vkrt_tpu_torch.accel.clusters import K1, K2
from vkrt_tpu_torch.accel.device_sah import device_sah_order
from vkrt_tpu_torch.accel.lbvh import build_lbvh
from vkrt_tpu_torch.app import cli
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.app.flythrough import camera_path
from vkrt_tpu_torch.app.framebuffer import golden_metrics, rmse, to_unorm8
from vkrt_tpu_torch.app.state import load_state
from vkrt_tpu_torch.golden import harness
from vkrt_tpu_torch.golden.cpu_tracer import render_golden
from vkrt_tpu_torch.golden.raster_oracle import render_golden_raster
from vkrt_tpu_torch.parallel.dryrun import dryrun_multichip
from vkrt_tpu_torch.parallel.mesh import (make_mesh, render_frame_sharded,
                                          render_raster_frame_sharded,
                                          replicate)
from vkrt_tpu_torch.raster import edge
from vkrt_tpu_torch.raster import pipeline as rp
from vkrt_tpu_torch.rt.dense import (broadcast_points, gated_pairs,
                                     trace_dense, trace_dense_plain,
                                     trace_occluded, trace_occluded_plain)
from vkrt_tpu_torch.rt.occl_multi import occluded_multi, occluded_multi_plain
from vkrt_tpu_torch.scene import build_texture_heap
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade import sampling, shading
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine, lanesort, pack
from vkrt_tpu_torch.wavefront.engine import (REBUILD_MODES, Renderer,
                                             camera_ray_blocks,
                                             render_frame_u8)

SEED = 0
N_FRAMES = 8
RASTER_FRAMES = 4
PER_LIGHT_FRAMES = 4
CONFIG5_FRAMES = 4
PROFILE_FRAMES = 2
HIT_AGREE = 0.999        # kernel A vs plain: hit masks
SLOT_AGREE = 0.999       # kernel A vs plain: slots (t, u, v, attrs
                         # bit-equal wherever the slots agree)
BLOCK_AGREE = 0.9999     # kernel B vs plain: blocked masks
T_RTOL = 1e-5            # kernel A vs plain: t where both hit
GOLDEN_RMSE = 1e-3       # frame vs oracle (BASELINE.json bar)
                         # C-F vs plain: equal (they move values, no math)
FLIP = 0.02              # raster frames: a pixel "flips" if a channel
FLIP_SHARE = 0.01        # differs by more; at most this share may flip
G_AGREE = 0.999          # kernel G vs plain: hit masks and slots (z, u,
                         # v, mat bit-equal wherever the slots agree)
REBUILD_RMSE = 1e-3      # config 5: full-rebuild f32 frame vs refit frame
REBUILD_HIT_AGREE = 0.999  # ... and their camera-ray hit masks
SAH_VS_HOST = 1.30       # device-SAH cluster area vs the host build's
SAH_VS_MORTON = 0.8      # ... and vs the Morton order's
CLI_FRAMES = 9           # phase 19: the pipelined fly-through (3 in flight)
CLI_STEADY_FRAMES = 40   # ... and a longer one, read between its first 4
                         # retirements (warm-up) and its last 3 (drain)
OVERLAY_ROWS = slice(8, 22)   # raster CLI: rows of the FPS text (5x7 font,
                              # scale 2, at y 8); its columns start at x 8
GATE_RMSE = 1e-3         # golden gate (bench.py:150-160): rmse_stable,
GATE_FLIP = 1e-3         # rmse_trimmed <= 1e-3, flip_frac <= 1e-3,
GATE_STABLE = 0.90       # stable_frac >= 0.90 (printed: see phase 20)
GATE_SIZE = (640, 480)   # phase 20's frame (bench.py::golden_check)
HARNESS_SIZE = (160, 120)
REF_SIZE = (320, 240)    # phase 21's frame
REF_RMSE = 1e-3          # reference vs dense frame (test_backends.py:34)
REF_RAY_TOL = 1e-3       # ... ray counts, relative (two tracers may part
                         # on a boundary ray: tests/test_torch_engine.py)
MIP_TOL = 1e-6           # mip_lod card vs CPU, rtol and atol
                         # (tests/test_torch_mip.py)
SHARDS = (2, 4, 7)       # phase 23: logical shards of the one card, beside
                         # make_mesh()'s one (7 pads 16,320 rows by 4)
SHARD_FRAMES = 3         # ... timed frames after a warm-up frame
RASTER_SHARDS = (1, 4)
CONFIG4_LAUNCHES = dict(A=2, B=2, C=1, D=1, E=1, F=1)   # a config-4 frame
SHARD_KEYS = ("device_ms", "host_enqueue_ms", "host_enqueue_ms_idle_stream",
              "device_busy_ms", "peak_mem_gb")
REORDER_OFF = dict(consolidate_secondary=False, group_sort_shadows=False,
                   partition_shadows=False)
# kernel → wrapper whose `launches` counts its launches
COUNTED = {"A": trace_dense, "A'": trace_occluded, "B": occluded_multi,
           "C": pack.consolidate,
           "D": pack.scatter_back, "E": lanesort.lane_sort,
           "F": lanesort.lane_unsort, "G": edge.raster_edge}
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


SPIN_CYCLES = 40_000_000   # torch.cuda._sleep: ~20 ms at the H100's clock
L2_BYTES = 50e6            # the H100's L2: timed calls rotate over more


def queued_ms(calls, reps: int = 24) -> dict:
    """Device time of a kernel of a few microseconds. Timed through its
    Python wrapper on an empty stream, such a kernel shows how fast the
    host enqueues, not how fast the card runs. So the stream is first
    held busy by a spin kernel of ~20 ms; the host enqueues `reps` calls
    behind it, taken in turn from `calls` (the same function on separate
    copies of its inputs, so that no call finds them in L2), and the
    events around them read the device's time alone. `queue_filled` says
    that the device had not reached the first call when the host had
    enqueued the last (the spin is doubled, up to 4x, until it holds).
    Returns ms per call on the device and the host's enqueue ms per
    call."""
    for f in calls:
        f()                                                    # warm-up
    for spin in (SPIN_CYCLES, 2 * SPIN_CYCLES, 4 * SPIN_CYCLES):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for i in range(reps):
            calls[i % len(calls)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        filled = not start.query()
        torch.cuda.synchronize()
        if filled:
            break
    else:
        raise AssertionError(f"the host took {host_ms:.1f} ms to enqueue "
                             f"{reps} calls: the queue never stayed filled")
    return {"ms": start.elapsed_time(end) / reps,
            "enqueue_ms": host_ms / reps, "queue_filled": filled}


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


def compare_closest(tree, o, d, tmax, label: str = "", block: int = 0,
                    with_attributes: bool = True) -> dict:
    """Kernel A vs its plain version on the same inputs: hit masks and
    slots agree on at least HIT_AGREE / SLOT_AGREE of the rays, t to
    T_RTOL where both hit, and t, u, v and attrs are bit-equal on every
    ray whose slots agree (misses included: inf, 0, 0, 0). With `block`,
    `o` is one origin per `block` rays [N/block,3] (the kernel's
    point-origin form; the plain version gets them broadcast); with
    `with_attributes` False the kernel writes no attrs."""
    kw = dict(block=block, point_origin=True) if block else {}
    got = trace_dense(tree, o, d, tmax, with_attributes=with_attributes, **kw)
    full = broadcast_points(o, d, block) if block else o
    want = trace_dense_plain(tree, full, d, tmax)
    torch.cuda.synchronize()
    if len(got) != (5 if with_attributes else 4):
        raise AssertionError(f"kernel A returned {len(got)} outputs{label}")
    names = ("t", "u", "v", "attrs")[:len(got) - 1]
    k = dict(zip(("t", "slot", "u", "v", "attrs"), got))
    p = dict(zip(("t", "slot", "u", "v", "attrs"), want))
    kh, ph = k["slot"] >= 0, p["slot"] >= 0
    agree = (kh == ph).float().mean().item()
    both = kh & ph
    same = k["slot"] == p["slot"]
    t_err = (((k["t"] - p["t"]).abs() / p["t"].abs())[both].max().item()
             if both.any() else 0.0)
    hs = same & kh
    abs_err = max((k[n] - p[n])[..., hs].abs().max().item()
                  for n in names) if hs.any() else 0.0
    equal = {n: bool(torch.equal(k[n][..., same], p[n][..., same]))
             for n in names}
    out = dict(rays=int(d.shape[1] * L.LANES), live_frac=(tmax > 0).float()
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


def tie_tree(tree, slot: int, spare: int):
    """A probe of kernel A's tie rule: a copy of `tree` in which the
    padding cluster `spare` holds nothing but a copy of triangle `slot`'s
    row (geometry and attributes) as its triangle 0, under the box of the
    whole scene (and its supercluster's box grown to hold it), with
    `leaf_tri` (padded with -1 to every slot) mapping the copy to the
    same triangle. A ray that hits the triangle hits both copies at the
    same t, u and v, and its entry t into the copy's box is at most its
    entry t into the original's, so a walk by entry t meets the copy
    first; the lower slot must win."""
    sc_boxes, cl_boxes, tri, leaf = (x.clone() for x in tree)
    real = sc_boxes[0] <= sc_boxes[3]
    lo = sc_boxes[0:3][:, real].min(dim=1).values
    hi = sc_boxes[3:6][:, real].max(dim=1).values
    tri[spare] = 0.0
    tri[spare, 0] = tree.tri_data[slot // K1, slot % K1]
    s, c = divmod(spare, K2)
    cl_boxes[s, 0:3, c], cl_boxes[s, 3:6, c] = lo, hi
    sc_boxes[0:3, s], sc_boxes[3:6, s] = lo, hi
    leaf = torch.cat([leaf, leaf.new_full((tri.shape[0] * K1 - leaf.numel(),),
                                          -1)])
    leaf[spare * K1] = tree.leaf_tri[slot]
    return type(tree)(sc_boxes, cl_boxes, tri, leaf)


def tie_slots(tree, slot_out):
    """(slot, spare) for `tie_tree`: the slot most of `slot_out`'s rays hit
    and the last padding cluster, whose id is above that slot's cluster."""
    slots, counts = torch.unique(slot_out[slot_out >= 0], return_counts=True)
    slot = int(slots[counts.argmax()])
    spare = int(torch.nonzero(tree.cl_boxes[:, 0, :].reshape(-1)
                              > tree.cl_boxes[:, 3, :].reshape(-1))[-1])
    return slot, spare


def closest_tie_probe(tree, o, d, tmax, label: str = "") -> float:
    """What a front-to-back walk could get wrong: the most-hit triangle
    is copied into a padding cluster of a higher id under the scene's box
    (`tie_tree`), which the walk visits first. Kernel A must agree with
    its plain version on every ray (no slot differs), return the lower
    slot (every output equal to the run without the copy) and, with the
    original's row zeroed, hand the same rays to the copy."""
    want = trace_dense(tree, o, d, tmax)
    slot, spare = tie_slots(tree, want[1])
    tt = tie_tree(tree, slot, spare)
    out = compare_closest(tt, o, d, tmax, f" (tie probe{label})")
    got = trace_dense(tt, o, d, tmax)
    alone = tt._replace(tri_data=tt.tri_data.clone())
    alone.tri_data[slot // K1, slot % K1] = 0.0
    took = trace_dense(alone, o, d, tmax)
    seen = want[1] == slot
    res = dict(slot=slot, copy_slot=spare * K1, rays=int(seen.sum()),
               slots_differ=out["slots_differ"],
               unchanged=all(torch.equal(g, w) for g, w in zip(got, want)),
               copy_alone_takes_over=bool((took[1][seen] == spare * K1).all()))
    log(f"  kernel A tie probe{label}:", json.dumps(res))
    if not (spare > slot // K1 and res["rays"] >= 8 and res["slots_differ"] == 0
            and res["unchanged"] and res["copy_alone_takes_over"]):
        raise AssertionError(f"kernel A tie probe failed: {res}")
    return out["max_abs_err"]


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


def edge_groups(tree, lp, sd, st) -> tuple:
    """Phase 4's segments rearranged so that in every set group 0 holds
    only blocked segments (gathered from the plain version's), group 1
    only parked ones, group 2 only empty intervals (0 < tmax <= TMIN) and
    group 3 one live, blocked lane. Returns the new (sd, st)."""
    want = occluded_multi_plain(tree, lp, sd, st)
    sd, st = sd.clone(), st.clone()
    for s in range(lp.shape[0]):
        idx = torch.nonzero(want[s].reshape(-1))[:L.LANES, 0]
        if idx.numel() < L.LANES:
            raise AssertionError(f"set {s}: fewer than 128 blocked segments")
        sd[s, :, 0] = sd[s].reshape(3, -1)[:, idx]
        st[s, 0] = st[s].reshape(-1)[idx]
    st[:, 1] = 0.0
    st[:, 2] = 0.0009
    st[:, 3] = 0.0
    st[:, 3, 127] = st[:, 0, 5]
    sd[:, :, 3, 127] = sd[:, :, 0, 5]
    return sd, st


def edge_groups_ok(mask) -> bool:
    """Whether blocked masks [.., Nb, 128] of `edge_groups`' segments come
    out as those groups must."""
    return (bool(mask[..., 0, :].all()) and not bool(mask[..., 1:3, :].any())
            and not bool(mask[..., 3, :127].any())
            and bool(mask[..., 3, 127].all()))


def occl_group_probe(tree, lp, sd, st) -> float:
    """Phase 4's edge groups (`edge_groups`): kernel B's masks must equal
    the plain version's, and those four groups come out as they must.
    Returns the largest error."""
    sd, st = edge_groups(tree, lp, sd, st)
    out = compare_occl(tree, lp, sd, st, near=False,
                       label=" (edge groups: all blocked, parked, empty, "
                             "one live lane)")
    kb = occluded_multi(tree, lp, sd, st)
    if not (out["masks_differ"] == 0 and edge_groups_ok(kb)):
        raise AssertionError(f"kernel B edge groups: {out}")
    return out["max_abs_err"]


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


DEAD_KEY = 1 << 18       # cell_key_fine's key of a dead ray


def adversarial_keys(rng, nb: int, block: int) -> dict:
    """Key sets that stress kernel E's radix passes, i32 [nb,128] each:
    all equal, strictly descending, random 24-bit keys with a quarter at
    2**24 - 1 (three full passes), all zero (no pass), each block's
    tail from a random lane on at DEAD_KEY (the packed prefix's shape:
    live keys below 2**18, then the dead ones), and keys of both signs
    (four passes on the sign-flipped bits)."""
    n = nb * 128
    lane = np.arange(n) % block
    cut = np.repeat(rng.integers(0, block + 1, n // block), block)
    top = (1 << 24) - 1
    keys = {"equal": np.full(n, 12345),
            "descending": np.arange(n)[::-1],
            "max_key": np.where(rng.random(n) < 0.25, top,
                                rng.integers(0, top, n)),
            "zero": np.zeros(n),
            "dead_tail": np.where(lane < cut, rng.integers(0, DEAD_KEY, n),
                                  DEAD_KEY),
            "signed": rng.integers(-(1 << 23), 1 << 23, n)}
    return {k: v.reshape(nb, 128).astype(np.int32) for k, v in keys.items()}


def probe_moves(device) -> dict:
    """Phase 5: kernels C-F vs their plain versions on probes of 1024 rows
    (131,072 rays). C and D at liveness 0, 0.1, 0.27, 0.9, 1 and
    clustered, 16 channels (values past the last live rank planted as
    777, which must not come back); E and F at blocks 512 and 1024 with
    keys of many ties, mostly-dead keys and the full 18-bit range, and at
    blocks 128-1024 with `adversarial_keys`; unsort(sort(x)) == x. C and
    D take no block. Returns each kernel's largest error."""
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
    dead = DEAD_KEY
    keys = {"ties": rng.integers(0, 40, (nb, L.LANES)),
            "mostly_dead": np.where(rng.random((nb, L.LANES)) < 0.27,
                                    rng.integers(0, dead, (nb, L.LANES)),
                                    dead),
            "full": rng.integers(0, dead + 1, (nb, L.LANES))}
    cases = [(block, name, key) for block in (512, 1024)
             for name, key in keys.items()]
    cases += [(block, name, key) for block in (128, 256, 512, 1024)
              for name, key in adversarial_keys(rng, nb, block).items()]
    x4 = x[:4].contiguous()
    for block, name, key in cases:
        key = torch.as_tensor(key.astype(np.int32), device=device)
        label = f" (block {block}, keys {name})"
        errs["E"] = max(errs["E"], compare_move(
            "E", (x4, key), {"block": block}, label))
        srt, rank = lanesort.lane_sort(x4, key, block=block)
        errs["F"] = max(errs["F"], compare_move(
            "F", (srt, rank), {"block": block}, label))
        if not torch.equal(lanesort.lane_unsort(srt, rank, block=block), x4):
            raise AssertionError(f"lane_unsort(lane_sort(x)) != x{label}")
    log(f"  C-F vs plain on probes: {len(lives)} liveness cases (C, D), "
        f"{len(cases)} block/key cases (E, F), all equal; max abs err "
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
        self.closest_in, self.occl_in, self.occl_block = [], [], []

    def closest(self, o, d, tmax):
        self.closest_in.append((o.clone(), d.clone(), tmax.clone()))
        return self.inner.closest(o, d, tmax)

    def occluded_multi(self, light_pts, sd, st, block=engine.BLOCK):
        self.occl_in.append((light_pts.clone(), sd.clone(), st.clone()))
        self.occl_block.append(block)
        return self.inner.occluded_multi(light_pts, sd, st, block=block)


# --- bounds: the least time the card could take for a kernel's work ----
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
UNFUSED = 2   # the f32 rate above counts an FMA as two operations; the
              # trace kernels build with -fmad=false (bit-equal to their
              # plain versions), so the card issues at most half of it
              # (132 SMs x 128 lanes x ~1.98 GHz = 33.5 T operations/s):
              # their reachable time is UNFUSED x the bound
OPS_A = 46    # kernel A per (ray, triangle): Möller–Trumbore terms 41,
              # 1/det, u, v, t products, u + v
OPS_B = 47    # kernel B per (segment, triangle): terms 41, three sign
              # products, su + sv, two interval products
OPS_G = (4, 8, 7)   # kernel G per (pixel, triangle) pair: the first
                    # edge function a*px + b*py + c for every pair; the
                    # other two where it is >= 0; the edges' sum (2) and
                    # the depth sum(beta_i * Z_i) (5) where all are >= 0
PAIRS_G = 1 << 17   # (pixel, cluster) pairs evaluated at a time (bounds)


def bound(nbytes: float, ops: float) -> dict:
    """The larger of bytes over the memory rate and operations over the
    f32 rate, and which one binds."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": float(nbytes), "ops": float(ops)}


def add_bounds(rows) -> dict:
    nbytes = sum(r["bytes"] for r in rows)
    ops = sum(r["ops"] for r in rows)
    return bound(nbytes, ops)


def live_tris(rows) -> torch.Tensor:
    """Triangles with a non-zero geometry row, per cluster: [C1p] int64."""
    return (rows[..., :9] != 0).any(-1).sum(dim=1)


def tree_bytes(tree, cols: int) -> int:
    """Bytes of the tree a trace needs once: `cols` columns of every live
    triangle row, and the boxes."""
    return (int(live_tris(tree.tri_data).sum()) * cols * 4
            + (tree.sc_boxes.numel() + tree.cl_boxes.numel()) * 4)


def trace_pairs(tree, o, d, t_end, ntri) -> int:
    """(ray, triangle) pairs whose segment [TMIN, t_end] enters the
    triangle's cluster and supercluster boxes. o, d [3,N], t_end [N]."""
    return sum(int(ntri[cl].sum()) for _, cl in gated_pairs(tree, o, d,
                                                            t_end))


def closest_bound(tree, o, d, tm, t, ntri) -> dict:
    """Kernel A's work on one call: rays and outputs once, the tree's 36
    attribute columns once, OPS_A per (ray, triangle) pair up to the
    final hit (to tmax on a miss)."""
    n = tm.numel()
    t_end = torch.where(torch.isfinite(t), t, tm).reshape(n)
    pairs = trace_pairs(tree, o.reshape(3, n), d.reshape(3, n), t_end, ntri)
    return bound(n * 4 * (3 + 3 + 1) + n * 4 * (4 + 36)
                 + tree_bytes(tree, 36), pairs * OPS_A)


def occl_bound(tree, lp, sd, st, ntri, out_bytes: int = 1) -> dict:
    """Kernel B's work on one call: segments and masks once, the tree's
    9 geometry columns once, OPS_B per (segment, triangle) pair up to the
    segment's nearest blocker (found with kernel A; its end if none).
    `out_bytes` per segment: 1 for B's mask, 16 for the t, slot, u, v
    that kernel A' writes (one call per light; the same work in all)."""
    ns, _, nb, lanes = sd.shape
    n = nb * lanes
    pairs = 0
    for s in range(ns):
        o = lp[s][:, None, None].expand(3, nb, lanes).contiguous()
        t = trace_dense(tree, o, sd[s].contiguous(), st[s])[0]
        t_end = torch.minimum(t, st[s]).reshape(n)
        pairs += trace_pairs(tree, o.reshape(3, n), sd[s].reshape(3, n),
                             t_end, ntri)
    return bound(ns * 12 + ns * n * 4 * 4 + ns * n * out_bytes
                 + tree_bytes(tree, 9) * (ns if out_bytes > 1 else 1),
                 pairs * OPS_B)


def move_bound(k: str, args, kw) -> dict:
    """Kernels C-F move values: what the call must read once and write
    once. C and D touch the packed side only at live ranks (C reads a
    channel value per live ray and writes the whole zeroed output; D
    reads one per live ray and writes every ray), so their input counts
    this run's live rays, not the tensor's size. E also writes a rank
    per ray; its sort (a few integer operations a key and radix pass)
    is far below the bytes' time, so its bound is its bytes."""
    x, idx = args
    moved = x.numel()
    if k in "CD":
        moved = x.shape[0] * int((idx >= 0).sum())
    nbytes = moved * 4 + idx.numel() * 4 + x.numel() * 4
    if k == "E":
        nbytes += idx.numel() * 4                     # the ranks it writes
    return bound(nbytes, 0)


def library_move(k: str, args, kw):
    """The one PyTorch call that computes the same function as a move
    kernel, or None. F is torch.gather on the block-shaped layout:
    out[s, j] = res[s, base + rank[j]]. C and D need a scatter or gather
    plus a mask, and E a sort, a gather and a scatter (lane_sort_plain):
    no single call."""
    if k == "F":
        res, rank = args
        blk = kw["block"]
        r3 = res.reshape(res.shape[0], -1, blk)
        idx = rank.reshape(1, -1, blk).long().expand(res.shape[0], -1, -1)
        return lambda: torch.gather(r3, 2, idx)
    return None


def keys_sort(args, kw):
    """torch.sort(stable=True) of kernel E's block-shaped keys alone: a
    part of E's work (E also moves the channels and writes the inverse
    permutation), timed beside it as a note."""
    keys = args[1].reshape(-1, kw["block"])
    return lambda: torch.sort(keys, dim=1, stable=True)


def input_copies(args, nbytes: float) -> list:
    """Enough separate copies of a call's tensors that a round over them
    moves more than the L2 holds (2 to 8)."""
    n = int(min(8, max(2, -(-2 * L2_BYTES // max(nbytes, 1.0)))))
    return [tuple(a.clone() for a in args) for _ in range(n)]


def main_path_shapes(renderer: Renderer, cam: Camera, transform=None,
                     label: str = "main path") -> dict:
    """Phases 9 and 18: record the inputs kernels A-F get in one frame of
    `renderer` (every depth of its config; with `transform`, on the tree
    its accel update makes of it), hold each kernel against its plain
    version on them, and time both there (A, B: mean of 5 after a
    warm-up; C-F: `queued_ms`, the device's time on a filled queue, with
    the host's enqueue time beside it; plain: one run), with the bound of
    that work and, for F, the library call that computes the same
    function, timed as the kernel is (for E, a stable sort of its keys
    alone as a note). Also reports each depth>=1
    shadow wavefront's live share and how much of it the lane sort's
    capped prefix covers. Rows come back in depth order (C-F from depth
    1)."""
    backend = renderer.backend
    if transform is not None:
        backend = backend._replace(tree=renderer.update_tree(transform))
    rec = RecordingBackend(backend)
    pi = torch.as_tensor(cam.proj_inverse, device=renderer.device)
    vi = torch.as_tensor(cam.view_inverse, device=renderer.device)
    with RecordingMoves() as moves:
        render_frame_u8(rec, renderer.tex, pi, vi, renderer.lights,
                        renderer.cfg)
        torch.cuda.synchronize()
    tree = backend.tree
    ntri = live_tris(tree.tri_data)
    res = {k: [] for k in COUNTED if k not in ("G", "A'")}
    for depth, (o, d, tm) in enumerate(rec.closest_in):
        r = compare_closest(tree, o, d, tm, f" ({label}, depth {depth})")
        r["ms"] = cuda_ms(lambda: trace_dense(tree, o, d, tm), 5)
        r["plain_ms"] = cuda_ms(lambda: trace_dense_plain(tree, o, d, tm),
                                1, warmup=False)
        r.update(closest_bound(tree, o, d, tm,
                               trace_dense(tree, o, d, tm)[0], ntri))
        res["A"].append(r)
    for depth, ((lp, sd, st), block) in enumerate(zip(rec.occl_in,
                                                      rec.occl_block)):
        r = compare_occl(tree, lp, sd, st, near=False,
                         label=f" ({label}, depth {depth}, {st.shape[1]} "
                               f"rows, block {block})")
        r["ms"] = cuda_ms(lambda: occluded_multi(tree, lp, sd, st), 5)
        r["plain_ms"] = cuda_ms(
            lambda: occluded_multi_plain(tree, lp, sd, st), 1, warmup=False)
        r.update(occl_bound(tree, lp, sd, st, ntri))
        res["B"].append(r)
    want = renderer.cfg.max_depth
    for k, calls in moves.inputs.items():
        if len(calls) != want - 1:
            raise AssertionError(f"recorded {len(calls)} calls of kernel {k}"
                                 f" in one frame, want {want - 1}")
        for depth, (args, kw) in enumerate(calls, start=1):
            r = {"shape": list(args[0].shape), **kw,
                 "max_abs_err": compare_move(k, args, kw,
                                             f" ({label}, depth {depth})")}
            r.update(move_bound(k, args, kw))
            copies = input_copies(args, r["bytes"])
            r.update(queued_ms([lambda c=c: COUNTED[k](*c, **kw)
                                for c in copies]))
            r["plain_ms"] = cuda_ms(lambda: PLAIN[k](*args, **kw), 1,
                                    warmup=False)
            r["library_ms"] = r["library_enqueue_ms"] = None
            if library_move(k, args, kw):
                q = queued_ms([library_move(k, c, kw) for c in copies])
                r["library_ms"] = q["ms"]
                r["library_enqueue_ms"] = q["enqueue_ms"]
            if k == "E":
                r["keys_sort_ms"] = queued_ms(
                    [keys_sort(c, kw) for c in copies])["ms"]
            del copies
            log(f"  kernel {k} vs plain ({label}, depth {depth}):",
                json.dumps(r))
            res[k].append(r)
    for depth, (c, e) in enumerate(zip(moves.inputs["C"], moves.inputs["E"]),
                                   start=1):
        grank = c[0][1]
        n = grank.numel()
        nlive = int((grank >= 0).sum().item())
        sorted_rays = e[0][1].numel()
        share = dict(rays=n, live=nlive, live_share=nlive / n,
                     lane_sorted_rays=sorted_rays,
                     live_sorted_share=min(nlive, sorted_rays) / max(nlive, 1))
        log(f"  depth-{depth} shadow wavefront:", json.dumps(share))
    for k, rows in res.items():
        log(f"  {k} per call ({label}): " + "; ".join(
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.1f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']:.4g} B, "
            f"{r['ops']:.4g} ops)"
            + (f", host enqueue {r['enqueue_ms']:.4f} ms"
               if "enqueue_ms" in r else "")
            + (f", library call {r['library_ms']:.4f} ms"
               if r.get("library_ms") is not None else "")
            for r in rows))
    for k in "AB":
        log(f"  kernel {k} ms per depth ({label}): " + "; ".join(
            f"d{dep} {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} "
            f"({r['ms'] / r['bound_ms']:.1f}x; unfused ceiling "
            f"{UNFUSED * r['bound_ms']:.3f})" for dep, r in enumerate(res[k]))
            + f"; per frame {sum(r['ms'] for r in res[k]):.3f} ms, bound "
            f"{sum(r['bound_ms'] for r in res[k]):.3f} ms")
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


def drive(renderer: Renderer, cams, per_frame: dict, label: str,
          transforms=None):
    """Phases 7, 8, 15 and 16: a warm-up frame on cams[0], then one timed
    frame per further camera, enqueued back to back through render_async
    (with transforms[k] as the frame's instance transform, if given).
    Every launch count is set to 0 just before and read just after; each
    must be per_frame[k] times the number of frames. Returns (results,
    [(u8 frame, ray count)] per camera)."""
    cfg = renderer.cfg
    n = len(cams) - 1
    tf = (lambda k: ()) if transforms is None else (lambda k:
                                                    (transforms[k],))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in COUNTED.values():
        f.launches = 0
    wall0 = time.perf_counter()
    first = renderer.render_async(cams[0], *tf(0))          # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - wall0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    outs = []
    wall1 = time.perf_counter()
    events[0].record()
    for k in range(n):
        outs.append(renderer.render_async(cams[k + 1], *tf(k + 1)))
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


def same_frames(outs, want, label: str = "flags-off") -> None:
    """Phase 8's and 15's contract: these frames equal the defaults
    frames bit for bit, with equal ray counts, camera by camera."""
    diff = [int((a != b).any(dim=-1).sum().item()) for (a, _), (b, _)
            in zip(outs, want)]
    rays = [(int(ra.item()), int(rb.item())) for (_, ra), (_, rb)
            in zip(outs, want)]
    log(f"  {label} vs defaults: pixels that differ per frame {diff}, "
        f"rays equal {all(a == b for a, b in rays)}")
    if any(diff) or any(a != b for a, b in rays) or len(outs) != len(want):
        raise AssertionError(f"{label} frames differ from the defaults "
                             f"frames: pixels {diff}, rays {rays}")


class EventRanges:
    """While active, every `record_function(name)` scope of the engine
    records a CUDA event where it opens and where it closes, so that the
    ranges partition the stream's timeline: on one stream a range's time
    runs from the end of the work queued before it to the end of its own,
    any wait for the host included, and the ranges never overlap."""

    def __init__(self):
        self.spans = []           # (name, opening event, closing event)

    def __enter__(self):
        self.saved = engine.record_function
        engine.record_function = self._scope
        return self

    def __exit__(self, *exc):
        engine.record_function = self.saved

    def _scope(self, name):
        outer = self

        class Scope:
            def __enter__(self):
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()

            def __exit__(self, *exc):
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                outer.spans.append((name, self.start, end))

        return Scope()


def event_ranges(renderer: Renderer, cam: Camera, label: str,
                 transform=None) -> dict:
    """PROFILE_FRAMES frames of `renderer` enqueued back to back through
    render_async under EventRanges: the device's time per engine range
    and outside them, per frame. The parts sum to the frame."""
    n = PROFILE_FRAMES
    tf = () if transform is None else (transform,)
    renderer.render_async(cam, *tf)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with EventRanges() as ev:
        start.record()
        for _ in range(n):
            renderer.render_async(cam, *tf)
        end.record()
        torch.cuda.synchronize()
    ranges = {}
    for name, a, b in ev.spans:
        ranges[name] = ranges.get(name, 0.0) + a.elapsed_time(b) / n
    frame_ms = start.elapsed_time(end) / n
    res = dict(frames=n, frame_ms=frame_ms,
               range_ms=dict(sorted(ranges.items())),
               other_ms=frame_ms - sum(ranges.values()))
    log(f"  device time per range, CUDA events ({label}):", json.dumps(res))
    if res["other_ms"] < -0.05 or not ranges:     # events resolve ~1 us
        raise AssertionError(f"the ranges do not partition the frame: {res}")
    return res


ENGINE_RANGES = ("trace_closest_d", "sample_d", "trace_shadow_d")
CONFIG5_RANGES = ENGINE_RANGES + ("accel_update",)
RASTER_RANGES = ("raster_setup", "raster_edge_s", "raster_sample")


def profile_frames(render, label: str, names=ENGINE_RANGES) -> dict:
    """PROFILE_FRAMES frames of `render()` (a Renderer's or a Rasterizer's
    render_async of one camera, or a sharded frame) after a warm-up one,
    enqueued back to back under torch.profiler: device time per range
    whose name starts with one of `names` (record_function in
    wavefront/engine.py and raster/pipeline.py) and outside them, per
    frame; the device's busy share of the wall clock from the first
    enqueue to the last result; the top device kernels."""
    from torch.profiler import ProfilerActivity, profile

    n = PROFILE_FRAMES
    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            render()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
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


def compare_raster(setup, scb, clb, px, py, zf, label: str = "") -> dict:
    """Kernel G vs its plain version on the same inputs: hit masks and
    slots agree on at least G_AGREE of the pixels, and z, slot, u, v and
    mat are bit-equal on every pixel whose slots agree (misses: inf, -1,
    0, 0, 0). Returns the comparison (with the plain version's time) and
    the kernel's outputs."""
    got = edge.raster_edge(setup, scb, clb, px, py, zf)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = edge.raster_edge_plain(setup, scb, clb, px, py, zf)
    end.record()
    torch.cuda.synchronize()
    kh, ph = got[1] >= 0, want[1] >= 0
    same = got[1] == want[1]
    hs = same & kh
    equal = {k: bool(torch.equal(a[same], b[same]))
             for k, a, b in zip(("z", "slot", "u", "v", "mat"), got, want)}
    err = max(((a - b)[hs].abs().max().item() if hs.any() else 0.0)
              for a, b in zip(got, want))
    out = dict(pixels=px.numel(), live_frac=(zf < edge.ZFAR_PARK).float()
               .mean().item(), hit_frac=kh.float().mean().item(),
               hit_agree=(kh == ph).float().mean().item(),
               slot_agree=same.float().mean().item(),
               slots_differ=int((~same).sum().item()),
               bit_equal_where_slots_agree=equal, max_abs_err=err,
               plain_ms=start.elapsed_time(end))
    log(f"  kernel G vs plain{label}:", json.dumps(out))
    if (out["hit_agree"] < G_AGREE or out["slot_agree"] < G_AGREE
            or not all(equal.values())):
        raise AssertionError(f"kernel G disagrees with its plain version: "
                             f"{out}")
    return out, got


def wall_camera(width: int, height: int) -> Camera:
    """A pose close to the z- wall, looking along it: sheets pass behind
    the camera, so clusters get full-screen boxes."""
    cam = Camera(width, height)
    cam.set_position((2.0, 3.0, -10.2))
    cam.set_rotation((0.0, 3.0, 0.0))
    return cam


def duplicate_triangle(setup, scb, clb, slot: int, cluster: int):
    """A probe of kernel G's tie rule: copies of (setup, scb, clb) in which
    cluster `cluster` holds nothing but a copy of triangle `slot` (cluster
    id * 128 + triangle) as its triangle 0, under the screen box of that
    triangle's cluster with zmin 0. Both copies give every sample the
    same depth, so the lower slot must win, whichever cluster a
    rasterizer visits first; with `cluster` above `slot`'s own, a
    front-to-back walk meets the copy first."""
    setup, scb, clb = setup.clone(), scb.clone(), clb.clone()
    src = slot // K1
    setup[cluster] = 0.0
    setup[cluster, 0] = setup[src, slot % K1]
    box = clb[src // K2, :, src % K2].clone()
    box[2] = 0.0
    clb[cluster // K2, :, cluster % K2] = box
    s = cluster // K2
    scb[0:3, s] = torch.minimum(scb[0:3, s], box[0:3])
    scb[3:6, s] = torch.maximum(scb[3:6, s], box[3:6])
    return setup, scb, clb


def tie_probe(setup, scb, clb, px, py, inside, label: str) -> float:
    """What a front-to-back walk could get wrong: the most-seen triangle
    of a bounded cluster is duplicated into an empty cluster of a higher
    id, under a box with zmin 0 (`duplicate_triangle`), so the kernel
    meets the copy first and both give every sample the same depth. The
    kernel must agree with its plain version, return the lower slot
    (every output equal to the run without the copy) and, with the
    original's row zeroed, hand the same samples to the copy."""
    zf = torch.where(inside, 0.0, edge.ZFAR_PARK)
    want = edge.raster_edge(setup, scb, clb, px, py, zf)
    box = clb.permute(1, 0, 2).reshape(8, -1)
    slots, counts = torch.unique(want[1][want[1] >= 0], return_counts=True)
    cl = (slots // 128).long()
    ok = (box[0][cl] > -1e8) & (box[2][cl] > 0)
    slot = int(slots[ok][counts[ok].argmax()])
    spare = int(torch.nonzero(box[0] == 1e8)[-1])
    dup = duplicate_triangle(setup, scb, clb, slot, spare)
    out, got = compare_raster(*dup, px, py, zf, label + ", tie)")
    alone = dup[0].clone()
    alone[slot // 128, slot % 128] = 0.0
    took = edge.raster_edge(alone, dup[1], dup[2], px, py, zf)
    seen = want[1] == slot
    res = dict(slot=slot, copy_slot=spare * 128, samples=int(seen.sum()),
               copy_zmin_below=bool(dup[2][spare // K2, 2, spare % K2]
                                    < box[2][slot // 128]),
               unchanged=all(torch.equal(g, w) for g, w in zip(got, want)),
               copy_alone_takes_over=bool((took[1][seen] == spare * 128)
                                          .all()))
    log(f"  kernel G tie probe{label}):", json.dumps(res))
    if not (spare > slot // 128 and res["samples"] >= 1
            and res["copy_zmin_below"] and res["unchanged"]
            and res["copy_alone_takes_over"]):
        raise AssertionError(f"kernel G tie probe failed: {res}")
    return out["max_abs_err"]


def probe_raster(dev, scenes) -> float:
    """Phase 10: kernel G vs its plain version on probes. For each scene
    (name, tree, width, height): the start pose and a pose by a wall, at
    the pixel centre and two MSAA offsets, with depth floors 0 (60%),
    random in [0.9, 1) (25%) and parked (15%, and the tile padding), then
    a continuation round with the floor at every hit's depth; per pose
    the tie probe (`tie_probe`). Returns the largest error."""
    rng = np.random.default_rng(SEED)
    err, n = 0.0, 0
    for name, tree, w, h in scenes:
        cfg = dataclasses.replace(C.reference_config(), width=w, height=h)
        for pose, cam in (("start", start_camera(w, h)),
                          ("wall", wall_camera(w, h))):
            setup, scb, clb = edge.build_raster_setup(
                tree, torch.as_tensor(cam.view_matrix, device=dev),
                torch.as_tensor(cam.projection_matrix, device=dev), w, h)
            if not bool((clb[:, 0] == -1e8).any()):
                raise AssertionError(f"{name} {pose}: no full-screen box")
            for off in ((0.5, 0.5), tuple(rp.MSAA8[0]), tuple(rp.MSAA8[5])):
                px, py, inside = rp.sample_pixel_lanes(cfg, off, dev)
                r = rng.random(px.shape)
                zf = np.where(r < 0.6, 0.0, np.where(
                    r < 0.85, rng.uniform(0.9, 1.0, px.shape), 1e9))
                zf = torch.where(inside, torch.as_tensor(
                    zf.astype(np.float32), device=dev), edge.ZFAR_PARK)
                label = f" ({name} {w}x{h}, {pose}, offset {off}"
                out, got = compare_raster(setup, scb, clb, px, py, zf,
                                          label + ", round 0)")
                err = max(err, out["max_abs_err"])
                zf = torch.where(got[1] >= 0, got[0], edge.ZFAR_PARK)
                out, _ = compare_raster(setup, scb, clb, px, py, zf,
                                        label + ", behind every hit)")
                err = max(err, out["max_abs_err"])
                n += 2
            err = max(err, tie_probe(setup, scb, clb, px, py, inside,
                                     f" ({name} {w}x{h}, {pose}"))
            n += 1
    log(f"  G vs plain on probes: {n} cases agree; max abs err {err}")
    return err


def raster_frames_vs_oracle(dev) -> None:
    """Phase 11: the small scene at 64x48, port on `dev` vs the numpy
    raster oracle: the edge method at msaa 1 and 8 under the flip gate
    (at most FLIP_SHARE of the pixels differ by more than FLIP, the rest
    by at most FLIP), the ray-cast method at msaa 1 by RMSE."""
    model = procedural_model("small", seed=SEED)
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    cam = start_camera(64, 48)
    heap = build_texture_heap(model.images)
    rast = rp.Rasterizer(model, cfg, dev, msaa=1)
    for method, msaa in (("edge", 1), ("edge", 8), ("wavefront", 1)):
        rast.method, rast.msaa = method, msaa
        fb = rast.render(cam, show_fps=False)
        want = render_golden_raster(rast.flat, heap, cam.proj_inverse,
                                    cam.view_inverse, cfg, msaa=msaa)
        d = np.abs(fb - want).max(axis=-1)
        flipped = d > FLIP
        out = dict(method=method, msaa=msaa, flip_share=float(flipped.mean()),
                   max_other=float(d[~flipped].max()), rmse=rmse(fb, want),
                   finite=bool(np.isfinite(fb).all()))
        log("  64x48 raster frame vs oracle:", json.dumps(out))
        ok = out["finite"] and fb.shape == (48, 64, 3)
        if method == "edge":
            ok = ok and (out["flip_share"] <= FLIP_SHARE
                         and out["max_other"] <= FLIP)
        else:
            ok = ok and out["rmse"] <= GOLDEN_RMSE
        if not ok:
            raise AssertionError(f"raster frame vs oracle failed: {out}")


def drive_raster(rast, cams) -> tuple:
    """Phase 12: a warm-up frame on cams[0], then one timed frame per
    further camera, enqueued back to back (CUDA events between frames).
    Every launch count is set to 0 just before and read just after: G
    must have 32 launches per frame and A-F none. Returns (results, the
    first frame)."""
    n = len(cams) - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in COUNTED.values():
        f.launches = 0
    wall0 = time.perf_counter()
    first = rast.render_async(cams[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - wall0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    outs = []
    wall1 = time.perf_counter()
    events[0].record()
    for k in range(n):
        outs.append(rast.render_async(cams[k + 1]))
        events[k + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall1
    launches = {k: f.launches for k, f in COUNTED.items()}
    frame_ms = [events[k].elapsed_time(events[k + 1]) for k in range(n)]
    res = dict(frames=n, warmup_s=warm_s, frame_ms=float(np.mean(frame_ms)),
               frame_ms_each=frame_ms, wall_ms_per_frame=wall_s * 1e3 / n,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    want = {k: 0 for k in COUNTED}
    want["G"] = 32 * (n + 1)
    if launches != want:
        raise AssertionError(f"raster main path: expected launches {want}, "
                             f"got {launches}")
    cam0 = cams[0]
    setup_ms = cuda_ms(lambda: edge.build_raster_setup(
        rast.backend.tree,
        torch.as_tensor(cam0.view_matrix, device=rast.device),
        torch.as_tensor(cam0.projection_matrix, device=rast.device),
        rast.cfg.width, rast.cfg.height), 5)
    res.update(setup_ms=setup_ms, setup_share=setup_ms / res["frame_ms"])
    log("  raster main path:", json.dumps(res))
    for fb in [first] + outs:
        if fb.shape != (rast.cfg.height, rast.cfg.width, 3):
            raise AssertionError(f"raster frame shape {tuple(fb.shape)}")
        if not bool(torch.isfinite(fb).all()):
            raise AssertionError("raster frame is not finite")
        if fb.std().item() < 0.01:
            raise AssertionError("raster frame is flat")
    return res, first


def wavefront_vs_edge(rast, cam, edge_fb) -> float:
    """The ray-cast raster method (kernel A) on the first camera against
    the edge frame: at most FLIP_SHARE of the pixels may flip."""
    wf = copy.copy(rast)
    wf.method = "wavefront"
    fb = wf.render_async(cam)
    d = (fb - edge_fb).abs().amax(dim=-1)
    share = (d > FLIP).float().mean().item()
    log(f"  ray-cast vs edge raster frame ({rast.cfg.width}x"
        f"{rast.cfg.height}, msaa {rast.msaa}): flip share {share:.5f} "
        f"(bar {FLIP_SHARE})")
    if share > FLIP_SHARE:
        raise AssertionError(f"ray-cast raster frame flips {share} of the "
                             f"edge frame's pixels")
    return share


class RecordingRaster:
    """While active, the raster pipeline's calls of kernel G go through a
    wrapper that keeps a copy of their inputs (the pipeline module's
    `raster_edge` name is swapped; the launch count is untouched)."""

    def __enter__(self):
        self.saved = rp.raster_edge
        self.calls = []

        def call(*args):
            self.calls.append(tuple(a.clone() for a in args))
            return self.saved(*args)

        rp.raster_edge = call
        return self

    def __exit__(self, *exc):
        rp.raster_edge = self.saved


def raster_pairs(setup, clb, px, py, zf, z_out, tri_live) -> torch.Tensor:
    """(pixel, triangle) pairs that kernel G's inputs need, by how far the
    function must evaluate each: [every pair, pairs with edge 0 >= 0,
    pairs with all three edges >= 0] (int64 [3]). A pair counts if the
    triangle is in `tri_live` (bool [C1p, K1]), its cluster's padded box
    holds the pixel and the cluster's zmin is below the pixel's final
    depth (1e9 where nothing was hit); parked pixels need none. The edge
    functions are evaluated as the plain version evaluates them."""
    n_cl = clb.shape[0] * K2
    box = clb.permute(1, 0, 2).reshape(8, n_cl)
    cols = setup[..., :9].transpose(1, 2).contiguous()     # [C1p, 9, K1]
    live = torch.nonzero(zf.reshape(-1) < edge.ZFAR_PARK, as_tuple=True)[0]
    x, y = px.reshape(-1)[live], py.reshape(-1)[live]
    zend = torch.where(torch.isfinite(z_out), z_out, edge.ZFAR_PARK)
    zend = zend.reshape(-1)[live]
    total = torch.zeros(3, dtype=torch.int64, device=px.device)
    for r0 in range(0, live.numel(), edge.PIX_CHUNK):
        r1 = r0 + edge.PIX_CHUNK
        g = (edge.box_gate(box[0], box[1], box[3], box[4], x[r0:r1],
                           y[r0:r1])
             & (box[2][None] < zend[r0:r1, None]))
        p_all, c_all = torch.nonzero(g, as_tuple=True)
        for q0 in range(0, p_all.numel(), PAIRS_G):
            p, c = p_all[q0:q0 + PAIRS_G] + r0, c_all[q0:q0 + PAIRS_G]
            rows = cols[c]                                 # [P, 9, K1]
            b = edge._barycentrics(lambda j: rows[:, j], x[p][:, None],
                                   y[p][:, None])
            every = tri_live[c]
            past0 = every & (b[0] >= 0)
            past2 = past0 & (b[1] >= 0) & (b[2] >= 0)
            total += torch.stack([every.sum(), past0.sum(), past2.sum()])
    return total


def raster_bound(setup, scb, clb, px, py, zf, z_out, behind) -> dict:
    """Kernel G's work on one call: the 19 used setup columns of every
    live triangle and the boxes once, pixels in (3 x 4 B) and out
    (5 x 4 B) once, and OPS_G's operations per needed (pixel, triangle)
    pair by the stage the pair reaches (`raster_pairs`). The clusters of
    `behind` need neither bytes nor operations."""
    tri_live = (setup[..., :9] != 0).any(-1) & ~behind[:, None]
    nbytes = (int(tri_live.sum()) * edge.N_SETUP * 4
              + (scb.numel() + clb.numel()) * 4 + px.numel() * 4 * (3 + 5))
    pairs = raster_pairs(setup, clb, px, py, zf, z_out, tri_live).tolist()
    res = bound(nbytes, sum(n * k for n, k in zip(pairs, OPS_G)))
    res["pairs"] = pairs
    return res


def camera_classes(rast, cam) -> tuple:
    """Per cluster of the tree (bool [C1p] each), from the corners' clip w
    in float64: `behind`, every triangle of the cluster has all three
    corners at w <= 0 (no such triangle covers a pixel: its edge
    functions cannot all be >= 0 where sum_i beta_i w_i = 1); `crossing`,
    some triangle has a corner at w <= 1e-9 and another in front (the
    setup's full-screen rule); `near`, some triangle has a corner at
    w <= 1e-9 (the JAX package's full-screen rule, which counts those
    behind too)."""
    td = rast.backend.tree.tri_data
    wrow = (torch.as_tensor(cam.projection_matrix, device=rast.device).double()
            @ torch.as_tensor(cam.view_matrix, device=rast.device).double())[3]
    v0 = td[..., 0:3].double()
    live = (td[..., 0:9] != 0).any(-1)
    behind, near = live, torch.zeros_like(live)
    for p in (v0, v0 + td[..., 3:6], v0 + td[..., 6:9]):
        w = (p * wrow[:3]).sum(-1) + wrow[3]
        behind = behind & (w <= 0)
        near = near | (live & (w <= 1e-9))
    return ((behind | ~live).all(dim=1) & live.any(dim=1),
            (near & ~behind).any(dim=1), near.any(dim=1))


def full_screen_drop(rast, cam, clb, label: str) -> dict:
    """The setup's box rule at one pose: the clusters wholly behind the
    camera exist, have left the full-screen set (which is exactly the
    clusters with a triangle crossing w = 0) and have empty boxes."""
    behind, crossing, near = camera_classes(rast, cam)
    box = clb.permute(1, 0, 2).reshape(8, -1)
    full, empty = box[0] == -1e8, box[0] == 1e8
    res = dict(clusters=box.shape[1], full_screen_clusters=int(full.sum()),
               full_screen_jax_rule=int(near.sum()),
               behind_camera_clusters=int(behind.sum()),
               empty_clusters=int(empty.sum()),
               full_is_crossing=bool(torch.equal(full, crossing)),
               behind_are_empty=bool(empty[behind].all()))
    log(f"  screen boxes ({label}):", json.dumps(res))
    if not (res["behind_camera_clusters"] > 0 and res["full_is_crossing"]
            and res["behind_are_empty"]
            and res["full_screen_jax_rule"] - res["full_screen_clusters"]
            >= res["behind_camera_clusters"]):
        raise AssertionError(f"screen-box rule failed ({label}): {res}")
    return res


def wall_pose_frame(rast) -> None:
    """Phase 12's wall-pose probe at the full width: close to a wall,
    where clusters wholly behind the camera exist, the full-screen set
    dropped them and the edge frame still passes the ray-cast frame
    gate."""
    cam = wall_camera(rast.cfg.width, rast.cfg.height)
    _, _, clb = edge.build_raster_setup(
        rast.backend.tree,
        torch.as_tensor(cam.view_matrix, device=rast.device),
        torch.as_tensor(cam.projection_matrix, device=rast.device),
        rast.cfg.width, rast.cfg.height)
    full_screen_drop(rast, cam, clb, "wall pose")
    wavefront_vs_edge(rast, cam, rast.render_async(cam))


def raster_shapes(rast, cam) -> dict:
    """Phase 13: record kernel G's 32 calls of one raster frame (8
    samples x 4 rounds); hold the kernel against its plain version on
    sample 0, rounds 0 and 1; time the kernel over all 32 calls (each
    once, after a warm-up) and the plain version on sample 0's four calls
    (rounds 0 and 1 during the comparison, 2 and 3 once each); bound the
    work of the 32 calls and of sample 0's four (the clusters wholly
    behind the camera need none; `pairs_*`: the (pixel, triangle) pairs
    counted, [all, past edge 0, past all three edges]); check the setup's box rule at this pose
    (`full_screen_drop`)."""
    with RecordingRaster() as rec:
        rast.render_async(cam)
        torch.cuda.synchronize()
    calls = rec.calls
    if len(calls) != 32:
        raise AssertionError(f"recorded {len(calls)} calls of kernel G in "
                             f"one frame, want 32")
    # each sample's round-1 floors are its round-0 discards
    discards = [int((c[5] < edge.ZFAR_PARK).sum()) for c in calls[1::4]]
    live = [[int((c[5] < edge.ZFAR_PARK).sum()) for c in calls[4 * s:4 * s
                                                               + 4]]
            for s in range(8)]
    log(f"  live pixels per round, sample by sample: {live}")
    if sum(discards) == 0:
        raise AssertionError("no fragment was discarded in round 0")
    cmp = [compare_raster(*calls[k], label=f" (main path, sample 0, round "
                                           f"{k})")[0] for k in (0, 1)]
    err = max(r["max_abs_err"] for r in cmp)
    edge.raster_edge(*calls[0])                                # warm-up
    per_call = []
    for c in calls:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        edge.raster_edge(*c)
        end.record()
        per_call.append((start, end))
    torch.cuda.synchronize()
    per_call = [s.elapsed_time(e) for s, e in per_call]
    plain_s0 = sum(r["plain_ms"] for r in cmp) + sum(
        cuda_ms(lambda c=c: edge.raster_edge_plain(*c), 1, warmup=False)
        for c in calls[2:4])
    behind = camera_classes(rast, cam)[0]
    boxes = full_screen_drop(rast, cam, calls[0][2], "start pose")
    bounds = [raster_bound(*c, edge.raster_edge(*c)[0], behind)
              for c in calls]
    frame_b = add_bounds(bounds)
    s0_b = add_bounds(bounds[:4])
    res = dict(max_abs_err=err, ms=sum(per_call), **boxes,
               ms_mean_per_call=float(np.mean(per_call)),
               ms_sample0=sum(per_call[:4]), ms_sample0_each=per_call[:4],
               ms_round0_each_sample=per_call[0::4],
               ms_round1_each_sample=per_call[1::4],
               ms_round2_each_sample=per_call[2::4],
               plain_ms_sample0=plain_s0,
               round0_discards_each_sample=discards,
               bound_frame=frame_b, bound_sample0=s0_b,
               pairs_frame=np.sum([b["pairs"] for b in bounds], 0).tolist(),
               pairs_sample0=np.sum([b["pairs"] for b in bounds[:4]],
                                    0).tolist())
    log("  kernel G at the main path's shapes:", json.dumps(res))
    return res


def compare_occluded(tree, origins, d, tmax, block: int = 0,
                     label: str = "") -> tuple:
    """Kernel A' vs its plain version on the same inputs: per-ray origins
    [3,Nb,128] (block 0) or one origin per `block` rays [N/block,3].
    Masks agree on at least BLOCK_AGREE of the rays (B's gate); parked
    and empty-interval rays are free; t, slot, u, v are what the any-hit
    mode leaves (TMIN / inf, 1 / -1, 0, 0). Returns (comparison, the
    kernel's mask)."""
    kw = dict(block=block, point_origin=True) if block else {}
    t, slot, u, v = trace_occluded(tree, origins, d, tmax, **kw)
    full = broadcast_points(origins, d, block) if block else origins
    pb = trace_occluded_plain(tree, full, d, tmax)
    torch.cuda.synchronize()
    kb = slot >= 0
    agree = (kb == pb).float().mean().item()
    coded = (torch.equal(slot, torch.where(kb, 1, -1).to(torch.int32))
             and torch.equal(t, torch.where(kb, C.RAY_TMIN, torch.inf))
             and not bool(u.any()) and not bool(v.any()))
    out = dict(rays=int(tmax.numel()), block=block,
               live_frac=(tmax > C.RAY_TMIN).float().mean().item(),
               blocked_frac=kb.float().mean().item(), mask_agree=agree,
               masks_differ=int((kb != pb).sum().item()),
               dead_blocked=bool(kb[tmax <= C.RAY_TMIN].any()),
               outputs_coded=coded,
               max_abs_err=(kb.float() - pb.float()).abs().max().item())
    log(f"  kernel A' vs plain{label}:", json.dumps(out))
    if agree < BLOCK_AGREE or out["dead_blocked"] or not coded:
        raise AssertionError(f"kernel A' disagrees with its plain version: "
                             f"{out}")
    return out, kb


def light_points(lp, s: int, n_rays: int, block: int):
    """Light s as the origin of every block of `block` rays: [N/block,3]."""
    return lp[s][None, :].expand(n_rays // block, 3).contiguous()


def probe_occluded(backend, o, d, tmax, lp, sd, st) -> tuple:
    """Phase 14: kernel A' on probes. Per-ray origins: phase 3's rays cut
    to segments of 15 units (parked rays stay parked, 16 get an empty
    interval). Point origins at blocks 512 and 1024: random points in the
    hall, and phase 4's light segments and its edge groups
    (`edge_groups`), whose masks must equal kernel B's (the edge groups
    coming out as they must). `backend.occluded` and `backend.occluded_point` (the entry
    points a caller uses) must return the same masks. Kernel A's
    point-origin form (both blocks) and its form without attributes are
    held against A's plain version, and the point-origin form against the
    broadcast origins' result in every output. Returns the largest error
    of (A', A)."""
    tree = backend.tree
    n = tmax.numel()
    seg = torch.where(tmax > 0, 15.0, 0.0)
    seg[0, :16] = 0.0009
    r, mask = compare_occluded(tree, o, d, seg, label=" (per-ray origins)")
    errs = [r]
    if not torch.equal(backend.occluded(o, d, seg), mask):
        raise AssertionError("DenseBackend.occluded differs from kernel A'")
    errs_a = [compare_closest(tree, o, d, tmax, " (no attributes)",
                              with_attributes=False)]
    kb = occluded_multi(tree, lp, sd, st)
    gd, gt = edge_groups(tree, lp, sd, st)
    kg = occluded_multi(tree, lp, gd, gt)
    rng = np.random.default_rng(SEED + 14)
    for block in (512, 1024):
        pts = torch.as_tensor(rng.uniform([-15, 0, -9], [15, 12, 10],
                                          (n // block, 3)).astype(np.float32),
                              device=d.device)
        r, mask = compare_occluded(tree, pts, d, seg, block,
                                   f" (random block origins, {block})")
        errs.append(r)
        if not torch.equal(backend.occluded_point(pts, d, seg, block), mask):
            raise AssertionError(f"DenseBackend.occluded_point (block "
                                 f"{block}) differs from kernel A'")
        errs_a.append(compare_closest(tree, pts, d, tmax,
                                      f" (point origins, block {block})",
                                      block=block))
        got = trace_dense(tree, pts, d, tmax, block=block, point_origin=True)
        want = trace_dense(tree, broadcast_points(pts, d, block), d, tmax)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"kernel A with point origins (block "
                                 f"{block}) differs from broadcast origins")
        for s in range(lp.shape[0]):
            r, mask = compare_occluded(
                tree, light_points(lp, s, n, block), sd[s].contiguous(),
                st[s].contiguous(), block, f" (light {s}, block {block})")
            errs.append(r)
            if not torch.equal(mask, kb[s]):
                raise AssertionError(f"kernel A' (light {s}, block {block}) "
                                     f"and kernel B disagree on "
                                     f"{int((mask != kb[s]).sum())} segments")
            if bool(mask[0, :16].any()):
                raise AssertionError("near-light segment blocked")
            r, mask = compare_occluded(
                tree, light_points(lp, s, n, block), gd[s].contiguous(),
                gt[s].contiguous(), block,
                f" (edge groups, light {s}, block {block})")
            errs.append(r)
            if not (torch.equal(mask, kg[s]) and edge_groups_ok(mask)):
                raise AssertionError(f"kernel A' on the edge groups (light "
                                     f"{s}, block {block}): {r}")
    log(f"  A' vs plain on probes: {len(errs)} cases agree; the backend's "
        f"occluded / occluded_point return the same masks; point-origin "
        f"masks equal kernel B's, on the edge groups too; A with point "
        f"origins and A without "
        f"attributes agree with A's plain version ({len(errs_a)} cases)")
    return (max(r["max_abs_err"] for r in errs),
            max(r["max_abs_err"] for r in errs_a))


def per_light_shapes(renderer: Renderer, cam: Camera) -> list:
    """Phase 15: record the shadow segments of one main-path frame (per
    depth: lights, dirs, tmax and the block the engine passes), then per
    depth hold the NS point-origin A' calls against the plain version and
    against kernel B's masks, and time A' (the NS launches, mean of 5)
    beside B (one launch, mean of 5) and the plain version (once)."""
    rec = RecordingBackend(renderer.backend)
    pi = torch.as_tensor(cam.proj_inverse, device=renderer.device)
    vi = torch.as_tensor(cam.view_inverse, device=renderer.device)
    render_frame_u8(rec, renderer.tex, pi, vi, renderer.lights, renderer.cfg)
    torch.cuda.synchronize()
    tree = renderer.backend.tree
    ntri = live_tris(tree.tri_data)
    rows = []
    for depth, ((lp, sd, st), block) in enumerate(zip(rec.occl_in,
                                                      rec.occl_block)):
        ns, n = lp.shape[0], st[0].numel()
        kb = occluded_multi(tree, lp, sd, st)
        calls = [(light_points(lp, s, n, block), sd[s].contiguous(),
                  st[s].contiguous()) for s in range(ns)]
        err = 0.0
        for s, (pts, dd, tt) in enumerate(calls):
            r, mask = compare_occluded(
                tree, pts, dd, tt, block,
                f" (main path, depth {depth}, light {s})")
            err = max(err, r["max_abs_err"])
            if not torch.equal(mask, kb[s]):
                raise AssertionError(f"A' and B disagree at depth {depth}, "
                                     f"light {s}")

        def run_all():
            for pts, dd, tt in calls:
                trace_occluded(tree, pts, dd, tt, block=block,
                               point_origin=True)

        def run_plain():
            for pts, dd, tt in calls:
                trace_occluded_plain(tree, broadcast_points(pts, dd, block),
                                     dd, tt)

        r = dict(depth=depth, block=block, launches=ns, max_abs_err=err,
                 ms=cuda_ms(run_all, 5),
                 b_ms=cuda_ms(lambda: occluded_multi(tree, lp, sd, st), 5),
                 plain_ms=cuda_ms(run_plain, 1, warmup=False))
        r.update(occl_bound(tree, lp, sd, st, ntri, out_bytes=16))
        log(f"  kernel A' at the main path's shapes:", json.dumps(r))
        rows.append(r)
    return rows


def rot_y(angle: float) -> np.ndarray:
    """4x4 rotation about the y axis (the instance transform of the
    config-5 frames)."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def config5_modes(base: Renderer, cams) -> dict:
    """Phase 16: config 5 at full width on the full scene, per rebuild
    mode: a warm-up frame + CONFIG5_FRAMES timed frames under a y-rotation
    of 0.01 rad more every frame, then the accel update alone (CUDA
    events around Renderer.update_tree, mean of 5, and the host's time to
    enqueue one). `base` lends its scene, heap and host-built tree."""
    cfg = C.config5_stress()
    tfs = [rot_y(0.01 * k) for k in range(len(cams))]
    per_frame = dict(A=4, B=4, C=3, D=3, E=3, F=3)
    res = {}
    for mode in REBUILD_MODES:
        r = copy.copy(base)
        r.cfg, r.rebuild = cfg, mode
        out, _ = drive(r, cams, per_frame, f"config 5, rebuild={mode}", tfs)
        m = rot_y(0.02)
        out["update_ms"] = cuda_ms(lambda: r.update_tree(m), 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.update_tree(m)
        out["update_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out["update_share"] = out["update_ms"] / out["frame_ms"]
        log(f"  config 5, rebuild={mode}: {out['frame_ms']:.3f} ms/frame, "
            f"{out['mrays_per_s']:.1f} Mrays/s, peak "
            f"{out['peak_mem_gb']:.2f} GB, accel update "
            f"{out['update_ms']:.3f} ms ({out['update_share']:.1%} of the "
            f"frame; host enqueue {out['update_enqueue_ms']:.1f} ms)")
        res[mode] = out
    return res


def tree_area(tree) -> float:
    """Total surface-area proxy of a tree's real cluster boxes."""
    lo, hi = tree.cl_boxes[:, 0:3, :], tree.cl_boxes[:, 3:6, :]
    ext = torch.clamp(hi - lo, min=0.0).double()
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    return float(area[lo[:, 0, :] <= hi[:, 0, :]].sum())


def transformed_flat(flat, m):
    """The FlatScene under the affine m (numpy): positions moved, normals
    and tangent directions rotated."""
    a, b = m[:3, :3].astype(np.float64), m[:3, 3].astype(np.float64)
    tangents = np.array(flat.tangents, np.float32)
    tangents[:, :3] = (flat.tangents[:, :3].astype(np.float64) @ a.T)
    return dataclasses.replace(
        flat,
        positions=(flat.positions.astype(np.float64) @ a.T + b).astype(
            np.float32),
        normals=(flat.normals.astype(np.float64) @ a.T).astype(np.float32),
        tangents=tangents)


def config5_gates(base: Renderer, cam: Camera, dev) -> dict:
    """Phase 17. On the full scene at 1080p (f32 frames): the refit frame
    with the identity equals the frame without a transform bit for bit;
    at rot_y(0.05) the full and full_morton frames are within
    REBUILD_RMSE of the refit frame, with camera-ray hit masks equal on
    at least REBUILD_HIT_AGREE of the pixels. On the small scene at
    64x48, depth 4: each mode's frame under rot_y(0.05) vs the numpy
    oracle on the transformed triangles. The device-SAH order of the
    full scene is a permutation; its tree's cluster area against the
    host build's and the Morton order's."""
    cfg = C.config5_stress()
    r = copy.copy(base)
    r.cfg, r.quantize = cfg, False
    still = copy.copy(r)
    still.cfg = dataclasses.replace(cfg, rebuild_per_frame=False)
    want, want_rays = still.render_async(cam)
    out = {}
    for label, tf in (("no transform (identity refit)", ()),
                      ("identity transform", (np.eye(4, dtype=np.float32),))):
        fb, rays = r.render_async(cam, *tf)
        same = bool(torch.equal(fb, want) and torch.equal(rays, want_rays))
        log(f"  refit, {label}: frame and rays bit-equal to the frame "
            f"without an update: {same}")
        if not same:
            raise AssertionError(f"refit with {label} changed the frame")
    m = rot_y(0.05)
    pi = torch.as_tensor(cam.proj_inverse, device=dev)
    vi = torch.as_tensor(cam.view_inverse, device=dev)
    opt, dirs, valid = camera_ray_blocks(pi, vi, cfg)
    o = opt[:, None, None].expand(dirs.shape).contiguous()
    tmax = torch.where(valid, C.RAY_TMAX, 0.0)
    frames, hits, trees = {}, {}, {}
    for mode in REBUILD_MODES:
        r.rebuild = mode
        frames[mode] = r.render_async(cam, m)
        trees[mode] = r.update_tree(m)
        hits[mode] = trace_dense(trees[mode], o, dirs, tmax)[1] >= 0
    moved = (frames["refit"][0] - want).square().mean().sqrt().item()
    if moved < 10 * REBUILD_RMSE:
        raise AssertionError(f"the transform did not move the frame "
                             f"(rmse {moved})")
    for mode in ("full", "full_morton"):
        err = (frames[mode][0] - frames["refit"][0]).square().mean() \
            .sqrt().item()
        agree = (hits[mode] == hits["refit"]).float().mean().item()
        rays = (int(frames[mode][1].sum()), int(frames["refit"][1].sum()))
        out[mode] = dict(rmse_vs_refit=err, hit_agree=agree, rays=rays)
        log(f"  {mode} vs refit at rot_y(0.05), 1080p: "
            + json.dumps(out[mode]))
        if err > REBUILD_RMSE or agree < REBUILD_HIT_AGREE:
            raise AssertionError(f"{mode} frame differs from the refit "
                                 f"frame: {out[mode]}")
    del frames, hits

    model = procedural_model("small", seed=SEED)
    small_cfg = dataclasses.replace(cfg, width=64, height=48)
    small_cam = start_camera(64, 48)
    golden = None
    for mode in REBUILD_MODES:
        sr = Renderer(model, small_cfg, dev, rebuild=mode)
        fb, rays = sr.render(small_cam, m)
        if golden is None:
            golden = render_golden(
                transformed_flat(sr.flat, m), build_texture_heap(model.images),
                small_cam.proj_inverse, small_cam.view_inverse, small_cfg,
                accel="brute")
        err = rmse(fb, golden)
        log(f"  64x48 depth-4 frame under rot_y(0.05), rebuild={mode}, vs "
            f"oracle: rmse {err:.3e} (bar {GOLDEN_RMSE}), rays {rays}")
        out[f"golden_{mode}"] = err
        if not (np.isfinite(fb).all() and err <= GOLDEN_RMSE):
            raise AssertionError(f"config-5 frame ({mode}) vs oracle failed: "
                                 f"rmse {err}")

    geometry, _, _ = r.rebuild_inputs()
    order = device_sah_order(*geometry)
    n = geometry[0].shape[0]
    perm = bool(torch.equal(torch.sort(order.long()).values,
                            torch.arange(n, device=dev)))
    area = dict(host=tree_area(base.backend.tree),
                sah=tree_area(clusters.build_clusters(*geometry,
                                                      method="sah")),
                morton=tree_area(clusters.build_clusters(*geometry,
                                                         method="morton")))
    out["sah"] = dict(permutation=perm, triangles=n, area=area,
                      vs_host=area["sah"] / area["host"],
                      vs_morton=area["sah"] / area["morton"])
    log("  device-SAH order, full scene:", json.dumps(out["sah"]))
    if not (perm and out["sah"]["vs_host"] <= SAH_VS_HOST
            and out["sah"]["vs_morton"] < SAH_VS_MORTON):
        raise AssertionError(f"device-SAH order failed its gates: "
                             f"{out['sah']}")
    return out


def zero_counts() -> None:
    for f in COUNTED.values():
        f.launches = 0


def read_counts(label: str, want: dict) -> dict:
    """The launch counts since zero_counts(); each kernel must have been
    launched exactly want.get(k, 0) times."""
    got = {k: f.launches for k, f in COUNTED.items()}
    full = {k: want.get(k, 0) for k in COUNTED}
    log(f"  {label}: launches {json.dumps(got)}")
    if got != full:
        raise AssertionError(f"{label}: expected launches {full}, got {got}")
    return got


def run_cli(main_fn, argv, model) -> tuple:
    """main_fn(argv, scene=model) with its standard output and error
    captured (the CLI's metrics JSON, its per-frame lines); returns (exit
    code, stdout lines, stderr lines, wall s)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(argv, scene=model)
    torch.cuda.synchronize()
    return (rc, out.getvalue().strip().splitlines(),
            err.getvalue().strip().splitlines(), time.perf_counter() - t0)


def frame_walls(lines) -> list:
    """The CLI's per-frame wall ms from its "frame i: X ms" lines."""
    return [float(ln.split()[2][:-2]) for ln in lines
            if ln.startswith("frame ")]


def read_png(path) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def cli_rt(model, tmp: Path, event_ms: float, dev):
    """Phase 19: the CLI's pipelined fly-through at config 4, 1920x1080,
    on the card. Returns the synchronous Renderer it was checked with."""
    png, ckpt = tmp / "cli_rt.png", tmp / "cli_rt.json"
    argv = ["--config", "4", "--frames", str(CLI_FRAMES), "--metrics",
            "--output", str(png), "--checkpoint", str(ckpt)]
    zero_counts()
    rc, lines, errs, wall_s = run_cli(cli.main, argv, model)
    read_counts("CLI fly-through", {k: n * CLI_FRAMES for k, n in
                                    dict(A=2, B=2, C=1, D=1, E=1,
                                         F=1).items()})
    summary = json.loads(lines[-1])
    cfg = C.config4_flythrough()
    cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                 CLI_FRAMES))
    sync = Renderer(model, cfg, dev, quantize=True)
    want, rays = sync.render(cams[-1])
    got = read_png(png)
    _, ck_cam, ck_frame, _ = load_state(str(ckpt))
    diff = int((got != want).any(axis=-1).sum())
    log(f"  exit {rc}, {wall_s:.1f} s with setup; FrameTimer (wall clock "
        f"between retired frames: device, u8 download and host work): "
        f"{json.dumps(summary)}; per frame {frame_walls(errs)}")
    log(f"  last frame vs Renderer.render of camera {CLI_FRAMES - 1}: "
        f"{diff} pixels differ, rays {rays} (per frame in the CLI: "
        f"{summary['total_rays'] / summary['frames']:.0f}); checkpoint "
        f"frame {ck_frame}")
    if rc != 0 or diff or ck_frame != CLI_FRAMES or summary["frames"] != \
            CLI_FRAMES or summary["total_rays"] <= 0 or not np.array_equal(
                ck_cam.view_matrix, cams[-1].view_matrix):
        raise AssertionError("CLI fly-through failed its checks")
    argv = ["--config", "4", "--frames", str(CLI_STEADY_FRAMES), "--metrics"]
    rc, lines, errs, wall_s = run_cli(cli.main, argv, model)
    walls = frame_walls(errs)
    steady = walls[4:-3]
    rays = json.loads(lines[-1])["total_rays"] / len(walls)
    log(f"  {CLI_STEADY_FRAMES} frames: exit {rc}, {wall_s:.1f} s with "
        f"setup; FrameTimer {lines[-1]}; steady (retirements 5 to "
        f"{len(walls) - 3}): {np.mean(steady):.3f} ms a frame (wall), "
        f"{rays / np.mean(steady) / 1e3:.1f} Mrays/s; phase 7's CUDA-event "
        f"frame {event_ms:.3f} ms")
    if rc != 0 or len(walls) != CLI_STEADY_FRAMES:
        raise AssertionError("CLI steady fly-through failed")
    return sync


def cli_raster(model, rast, tmp: Path) -> None:
    """Phase 19b: the CLI's raster path, one frame at 1600x1200, MSAA 8:
    equal to Rasterizer.render_async of the start camera outside the FPS
    text (its pixels change with the measured rate)."""
    png = tmp / "cli_raster.png"
    zero_counts()
    rc, _, _, wall_s = run_cli(cli.main, ["--raster", "--frames", "1",
                                          "--output", str(png)], model)
    read_counts("CLI raster", {"G": 32})
    cfg = rast.cfg
    want = to_unorm8(rast.render_async(
        start_camera(cfg.width, cfg.height)).cpu().numpy())
    got = read_png(png)
    keep = np.ones((cfg.height, cfg.width), bool)
    keep[OVERLAY_ROWS, 8:] = False
    diff = int((got != want).any(axis=-1)[keep].sum())
    text = int((got != want).any(axis=-1)[~keep].sum())
    log(f"  exit {rc}, {wall_s:.1f} s with setup; {diff} pixels differ "
        f"outside the FPS text, {text} inside it")
    if rc != 0 or diff or got.shape != want.shape:
        raise AssertionError("CLI raster frame differs from render_async")


def golden_gate(model, sync, dev) -> dict:
    """Phase 20: bench.py's golden gate on the card: a 640x480
    reference_config() f32 frame through render_frame against the native
    oracle with its stability mask."""
    cfg = dataclasses.replace(C.reference_config(), width=GATE_SIZE[0],
                              height=GATE_SIZE[1])
    cam = start_camera(cfg.width, cfg.height)
    zero_counts()
    fb, _ = engine.render_frame(
        sync.backend, sync.tex, engine.upload_matrix(cam.proj_inverse, dev),
        engine.upload_matrix(cam.view_inverse, dev), sync.lights, cfg)
    fb = fb.cpu().numpy()
    read_counts("golden frame", dict(A=2, B=2, C=1, D=1, E=1, F=1))
    t0 = time.perf_counter()
    golden, stable = render_golden(
        sync.flat, build_texture_heap(model.images), cam.proj_inverse,
        cam.view_inverse, cfg, accel="native", with_stable=True)
    oracle_s = time.perf_counter() - t0
    m = golden_metrics(fb, golden, stable=stable)
    log(f"  native oracle {oracle_s:.2f} s; " + json.dumps(m))
    log(f"  bars: rmse_stable {m['rmse_stable']:.3e} <= {GATE_RMSE}, "
        f"rmse_trimmed {m['rmse_trimmed']:.3e} <= {GATE_RMSE}, flip_frac "
        f"{m['flip_frac']:.3e} <= {GATE_FLIP}; stable_frac "
        f"{m['stable_frac']:.4f} beside {GATE_STABLE} (the oracle's own "
        f"mask on this stand-in scene, whatever tracer runs: printed, "
        f"not a gate)")
    if not (np.isfinite(fb).all() and fb.shape == (cfg.height, cfg.width, 3)
            and m["rmse_stable"] <= GATE_RMSE
            and m["rmse_trimmed"] <= GATE_RMSE
            and m["flip_frac"] <= GATE_FLIP):
        raise AssertionError(f"golden gate failed: {m}")
    argv = ["--oracle", "native", "--width", str(HARNESS_SIZE[0]),
            "--height", str(HARNESS_SIZE[1])]
    zero_counts()
    rc, lines, _, wall_s = run_cli(harness.main, argv, model)
    read_counts("harness", dict(A=2, B=2, C=1, D=1, E=1, F=1))
    log(f"  harness {' '.join(argv)}: exit {rc}, {wall_s:.1f} s with "
        f"setup: {lines[-1]}")
    if rc != 0:
        raise AssertionError("golden harness failed")
    return {**m, "oracle_s": oracle_s}


def reference_backend(sync, dev) -> None:
    """Phase 21: the reference backend (LBVH, plain-PyTorch traversal)
    at 320x240, reference_config(), against the dense frame."""
    cfg = dataclasses.replace(C.reference_config(), width=REF_SIZE[0],
                              height=REF_SIZE[1])
    cam = start_camera(cfg.width, cfg.height)
    geometry = sync.rebuild_inputs()[0]
    build_ms = cuda_ms(lambda: build_lbvh(*geometry), reps=3)
    zero_counts()
    t0 = time.perf_counter()
    ref = engine.make_backend(sync.flat, "reference", dev)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    args = (sync.tex, engine.upload_matrix(cam.proj_inverse, dev),
            engine.upload_matrix(cam.view_inverse, dev), sync.lights, cfg)
    t0 = time.perf_counter()
    fb, rays = engine.render_frame(ref, *args)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    read_counts("reference backend (plain PyTorch)", {})
    want, want_rays = engine.render_frame(sync.backend, *args)
    fb, want = fb.cpu().numpy(), want.cpu().numpy()
    rays, want_rays = int(rays.sum()), int(want_rays.sum())
    err = rmse(fb, want)
    log(f"  LBVH build {build_ms:.2f} ms (CUDA events, mean of 3), "
        f"make_backend {make_s:.2f} s; frame {frame_s * 1e3:.1f} ms (host "
        f"clock: one host wait per traversal step); rmse vs dense "
        f"{err:.3e} (bar {REF_RMSE}); rays {rays} vs {want_rays} (bar "
        f"{REF_RAY_TOL} relative)")
    if not (np.isfinite(fb).all() and err <= REF_RMSE
            and abs(rays - want_rays) <= REF_RAY_TOL * want_rays):
        raise AssertionError("reference backend vs dense failed")


def mip_lod(sync, cams, event_ms: float, dev) -> None:
    """Phase 22: config 4 at 1080p with mip_lod; then ray_diff_lod and
    sample_material_trilinear on that frame's depth-0 inputs, on the
    card against the same calls on the CPU."""
    mr = copy.copy(sync)
    mr.cfg = dataclasses.replace(sync.cfg, mip_lod=True)
    res, outs = drive(mr, cams[:3], dict(A=2, B=2, C=1, D=1, E=1, F=1),
                      "mip_lod")
    log(f"  ms/frame: mip_lod {res['frame_ms']:.3f}, default (phase 7) "
        f"{event_ms:.3f}")
    del outs
    cam = start_camera(mr.cfg.width, mr.cfg.height)
    opt, dirs, valid = camera_ray_blocks(
        engine.upload_matrix(cam.proj_inverse, dev),
        engine.upload_matrix(cam.view_inverse, dev), mr.cfg)
    o = opt[:, None, None].expand(dirs.shape).contiguous()
    tmax = torch.where(valid, C.RAY_TMAX, 0.0)
    _, u, v, attrs, hitm = mr.backend.closest(o, dirs, tmax)
    _, _, uv, _, mat = shading.interpolate(attrs, u, v)
    hit, mat = hitm & valid, mat[0]
    tex = mr.tex
    cpu = [x.cpu() for x in (uv, hit, mat, tex.level_width,
                             tex.level_height)]
    lod = sampling.ray_diff_lod(uv, hit, mat, tex.level_width,
                                tex.level_height, mat)
    lod_cpu = sampling.ray_diff_lod(*cpu, cpu[2])
    tri = sampling.sample_material_trilinear(*tex, mat, uv, lod)
    tri_cpu = sampling.sample_material_trilinear(
        *(x.cpu() for x in tex), cpu[2], cpu[0], lod.cpu())
    errs = [float((lod.cpu() - lod_cpu).abs().max())] + [
        float((a.cpu() - b).abs().max()) for a, b in zip(tri, tri_cpu)]
    log(f"  depth-0 inputs: lod max {float(lod.max()):.3f}, mean "
        f"{float(lod[hit].mean()):.3f}; card vs CPU max |diff| lod "
        f"{errs[0]:.2e}, base/mr/normal {errs[1]:.2e} / {errs[2]:.2e} / "
        f"{errs[3]:.2e} (rtol = atol = {MIP_TOL})")
    np.testing.assert_allclose(lod.cpu().numpy(), lod_cpu.numpy(),
                               rtol=MIP_TOL, atol=MIP_TOL)
    for a, b in zip(tri, tri_cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=MIP_TOL,
                                   atol=MIP_TOL)


def time_frames(render, mats, label: str, per_frame: dict,
                want=None) -> tuple:
    """Phase 23: `render(m)` for the camera matrices m of each of `mats`,
    the first as a warm-up, the rest enqueued back to back: the host's
    enqueue ms of each call (perf_counter, no wait) and the device's ms
    between CUDA events recorded after each, which the host's pace bounds
    from below. The launch counts are zeroed before and read after:
    per_frame[k] times the number of frames. Every (frame, ray grid) must
    torch.equal want's (unless None). Then each frame once more from an
    idle stream (the host's enqueue ms with the card's launch queue empty
    at the start: a queue held full stops the host at its depth) and two
    frames under torch.profiler (the device's busy ms a frame, alone).
    Returns (results, outputs)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    outs = [render(mats[0])]
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in mats]
    host = []
    events[0].record()
    for i, m in enumerate(mats[1:]):
        t0 = time.perf_counter()
        outs.append(render(m))
        host.append((time.perf_counter() - t0) * 1e3)
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = read_counts(label, {k: n * len(mats)
                                   for k, n in per_frame.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    differ = [] if want is None else [
        (i, int((fb != w[0]).any(dim=-1).sum()), int((rays != w[1]).sum()))
        for i, ((fb, rays), w) in enumerate(zip(outs, want))
        if not (torch.equal(fb, w[0]) and torch.equal(rays, w[1]))]
    idle = []
    for m in mats[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(m)
        idle.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    prof = profile_frames(lambda: render(mats[1]), label)
    res = dict(frames=len(mats) - 1,
               device_ms=float(np.mean([events[i].elapsed_time(
                   events[i + 1]) for i in range(len(mats) - 1)])),
               host_enqueue_ms=float(np.mean(host)),
               host_enqueue_ms_each=host,
               host_enqueue_ms_idle_stream=float(np.mean(idle)),
               device_busy_ms=prof["device_busy_ms_per_frame"],
               busy_share_profiled=prof["busy_share"],
               peak_mem_gb=peak, launches=launches,
               frames_equal=not differ)
    log(f"  {label}:", json.dumps(res))
    if differ:
        raise AssertionError(f"{label}: (frame, pixels, rays) that differ "
                             f"from the unsharded frames: {differ}")
    return res, outs


def sharded(model, sync, cams, event_ms: float, dev, tmp: Path) -> dict:
    """Phase 23: multi-device rendering (parallel/mesh.py) on logical
    shards of the one card. Config 4 at 1920x1080 through
    render_frame_sharded on make_mesh() and on [card] * k, frames and ray
    grids bit-equal to render_frame's on the same cameras; the raster
    frame at 1600x1200, MSAA 8, sharded, bit-equal to
    render_raster_frame_edge's; the dry run; the CLI's --shard."""
    cfg = sync.cfg
    mats = [(engine.upload_matrix(c.proj_inverse, dev),
             engine.upload_matrix(c.view_inverse, dev))
            for c in cams[:SHARD_FRAMES + 1]]
    one, want = time_frames(
        lambda m: engine.render_frame(sync.backend, sync.tex, *m,
                                      sync.lights, cfg),
        mats, "unsharded render_frame", CONFIG4_LAUNCHES)
    rows = []
    for k in (None,) + SHARDS:
        mesh = make_mesh() if k is None else make_mesh([dev] * k)
        reps = replicate((sync.backend, sync.tex, sync.lights), mesh)
        n = mesh.size
        name = "make_mesh()" if k is None else f"[card] * {k}"
        res, _ = time_frames(
            lambda m: render_frame_sharded(sync.backend, sync.tex, *m,
                                           sync.lights, cfg, mesh,
                                           replicas=reps),
            mats, f"sharded, {name} ({n} shards)",
            {key: c * n for key, c in CONFIG4_LAUNCHES.items()}, want)
        rows.append(dict(shards=n, **{key: res[key] for key in SHARD_KEYS}))
    del want
    log("  config 4, 1920x1080, ms per frame (" + runtime.nvidia_smi_line()
        + "): unsharded " + json.dumps({key: one[key] for key in SHARD_KEYS})
        + f", phase 7 {event_ms:.3f}; sharded "
        + json.dumps(rows))

    rcfg = C.reference_config()
    cam = start_camera(rcfg.width, rcfg.height)
    view, proj = (engine.upload_matrix(m, dev) for m in (
        cam.view_matrix, cam.projection_matrix))
    tree = sync.backend.tree
    zero_counts()
    want = rp.render_raster_frame_edge(tree, sync.tex, view, proj, rcfg, 8)
    read_counts("raster unsharded", {"G": 32})
    raster = {}
    for k in RASTER_SHARDS:
        mesh = make_mesh() if k == 1 else make_mesh([dev] * k)
        torch.cuda.synchronize()
        zero_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        got = render_raster_frame_sharded(tree, sync.tex, view, proj, rcfg,
                                          mesh, msaa=8)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        read_counts(f"raster, {k} shards", {"G": 32 * k})
        equal = torch.equal(got, want)
        raster[k] = dict(device_ms=start.elapsed_time(end),
                         host_enqueue_ms=host_ms, equal=equal)
        if not equal:
            raise AssertionError(
                f"raster, {k} shards: {int((got != want).any(dim=-1).sum())}"
                " pixels differ from the unsharded frame")
    del want, got
    log("  raster 1600x1200, msaa 8, one frame (start camera):",
        json.dumps(raster))

    t0 = time.perf_counter()
    dryrun_multichip(4, "cuda")
    log(f"  dry run on [card] * 4: {time.perf_counter() - t0:.1f} s")

    png = tmp / "cli_shard.png"
    argv = ["--config", "4", "--shard", "--frames", "2", "--output",
            str(png)]
    zero_counts()
    rc, _, errs, wall_s = run_cli(cli.main, argv, model)
    read_counts("CLI --shard", {k: n * 2 for k, n in
                                CONFIG4_LAUNCHES.items()})
    want, _ = sync.render(cams[1])
    diff = int((read_png(png) != want).any(axis=-1).sum())
    log(f"  CLI {' '.join(argv[:-1])}: exit {rc}, {wall_s:.1f} s with "
        f"setup ({next((e for e in errs if 'sharding' in e), '')}); last "
        "frame vs Renderer.render "
        f"of camera 1: {diff} pixels differ")
    if rc != 0 or diff:
        raise AssertionError("CLI --shard: the last frame differs")
    try:
        cli.main(["--config", "4", "--shard", "2"], scene=model)
    except ValueError as e:
        log(f"  CLI --shard 2 on {torch.cuda.device_count()} card: "
            f"ValueError: {e}")
    else:
        raise AssertionError("CLI --shard 2 did not raise on one card")
    return dict(unsharded=one, sharded=rows, raster=raster)


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

    t_start = time.perf_counter()
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
    res_a["max_abs_err"] = max(res_a["max_abs_err"],
                               closest_tie_probe(tree, o, d, tmax))

    log("== 4. kernel B vs plain")
    _, slot, u, v, attrs = trace_dense(tree, o, d, tmax)
    lp, sd, st = shadow_inputs(u, v, attrs, slot >= 0, renderer.lights)
    res_b = compare_occl(tree, lp, sd, st)
    res_b["max_abs_err"] = max(res_b["max_abs_err"],
                               occl_group_probe(tree, lp, sd, st))

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
    first_outs = outs[:PER_LIGHT_FRAMES + 1]
    del outs, outs_off
    log(f"  ms/frame: defaults {res_main['frame_ms']:.3f}, flags off "
        f"{res_off['frame_ms']:.3f}")

    log("== 9. kernels vs plain at the main path's shapes")
    cam = start_camera(cfg.width, cfg.height)
    res_9 = main_path_shapes(renderer, cam)

    log(f"== profile: {PROFILE_FRAMES} main-path frames, then "
        f"{PROFILE_FRAMES} flags-off frames")
    profile_frames(lambda: renderer.render_async(cam), "defaults")
    profile_frames(lambda: off.render_async(cam), "flags off")

    log("== 14. kernel A' vs plain on probes")
    probe_err["A'"], err_a = probe_occluded(renderer.backend, o, d, tmax, lp,
                                            sd, st)
    probe_err["A"] = max(probe_err["A"], err_a)

    log("== 15. config 4 with the per-light shadow dispatch (kernel A')")
    pl = copy.copy(renderer)
    pl.backend = renderer.backend._replace(per_light=True)
    pl_cams = cams[:PER_LIGHT_FRAMES + 1]
    res_pl, outs_pl = drive(pl, pl_cams, {"A": 2, "A'": 8, "C": 1, "D": 1,
                                          "E": 1, "F": 1},
                            "per-light main path")
    same_frames(outs_pl, first_outs, "per-light")
    del outs_pl, first_outs
    log(f"  ms/frame: per light {res_pl['frame_ms']:.3f}, defaults "
        f"{res_main['frame_ms']:.3f}")
    res_15 = per_light_shapes(renderer, cam)
    log("  A' per frame: "
        f"{sum(r['ms'] for r in res_15):.3f} ms in "
        f"{sum(r['launches'] for r in res_15)} launches vs B "
        f"{sum(r['b_ms'] for r in res_15):.3f} ms in {len(res_15)}")

    log("== 16. config 5 at 1920x1080: refit, full (device SAH), full_morton")
    res_16 = config5_modes(renderer, cams[:CONFIG5_FRAMES + 1])
    log(f"== profile: {PROFILE_FRAMES} config-5 frames per rebuild mode")
    r5s = {}
    for mode in REBUILD_MODES:
        r5s[mode] = r5 = copy.copy(renderer)
        r5.cfg, r5.rebuild = C.config5_stress(), mode
        profile_frames(lambda: r5.render_async(cam), f"config 5, {mode}",
                       CONFIG5_RANGES)
        event_ranges(r5, cam, f"config 5, {mode}", rot_y(0.02))

    log("== 17. config-5 gates")
    config5_gates(renderer, cam, dev)

    log("== 18. kernels vs plain at the config-5 path's shapes")
    res_18 = {}
    for mode, r5 in r5s.items():
        res_18[mode] = main_path_shapes(r5, cam, rot_y(0.02),
                                        f"config 5, {mode}")
        log(f"  config 5, {mode}: kernel ms per frame by depth: " + json.dumps(
            {k: [round(r["ms"], 3) for r in rows]
             for k, rows in res_18[mode].items()}))
    del r5, r5s

    log("== 10. kernel G vs plain on probes")
    small = rp.Rasterizer(procedural_model("small", seed=SEED),
                          C.reference_config(), dev)
    probe_err["G"] = probe_raster(dev, [("full", tree, 160, 120),
                                        ("small", small.backend.tree, 64,
                                         48)])
    del small

    log("== 11. raster frames vs oracle")
    raster_frames_vs_oracle(dev)

    log("== 12. raster main path: 1600x1200, msaa 8, full scene")
    del renderer, off
    t0 = time.perf_counter()
    rcfg = C.reference_config()
    rast = rp.Rasterizer(model, rcfg, dev, msaa=8)
    log(f"  setup {time.perf_counter() - t0:.1f} s")
    rcams = list(itertools.islice(camera_path(rcfg.width, rcfg.height),
                                  RASTER_FRAMES + 1))
    res_raster, first = drive_raster(rast, rcams)
    wavefront_vs_edge(rast, rcams[0], first)
    del first
    wall_pose_frame(rast)
    log(f"== profile: {PROFILE_FRAMES} raster frames")
    profile_frames(lambda: rast.render_async(rcams[0]), "raster",
                   RASTER_RANGES)

    log("== 13. kernel G at the main path's shapes")
    res_13 = raster_shapes(rast, rcams[0])

    t_new = time.perf_counter()
    out_dir = kernels.BUILD_ROOT / "smoke"       # gitignored, in the checkout
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        log(f"== 19. CLI: config 4 fly-through, {CLI_FRAMES} frames at "
            "1920x1080, 3 in flight")
        sync = cli_rt(model, Path(tmp), res_main["frame_ms"], dev)
        log("== 19b. CLI: raster, one frame at 1600x1200, msaa 8")
        cli_raster(model, rast, Path(tmp))
    del rast
    log("== 20. golden gate: 640x480 reference frame vs the native oracle")
    golden_gate(model, sync, dev)
    log("== 21. reference backend at 320x240 vs dense")
    reference_backend(sync, dev)
    log("== 22. mip_lod at config 4, 1920x1080")
    mip_lod(sync, cams, res_main["frame_ms"], dev)
    log(f"  phases 19-22: {time.perf_counter() - t_new:.1f} s")
    log("== 23. sharded: config 4 at 1920x1080 and raster at 1600x1200 on "
        "logical shards of the card, the dry run, the CLI's --shard")
    t_new = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        sharded(model, sync, cams, res_main["frame_ms"], dev, Path(tmp))
    del sync
    log(f"  phase 23: {time.perf_counter() - t_new:.1f} s")

    def entry(name, k, src, replaces):
        rows = res_9[k]
        lib_ms = [r.get("library_ms") for r in rows]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": res_main["launches"][k],
                "max_abs_err": max(
                    [probe_err[k]] + [r["max_abs_err"] for r in rows]
                    + [r["max_abs_err"] for m in res_18.values()
                       for r in m[k]]),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                **{key: add_bounds(rows)[key]
                   for key in ("bound_ms", "bound_by")},
                "library_ms": (sum(lib_ms) if all(x is not None
                                                  for x in lib_ms) else None)}

    g = {"name": "raster_edge", "route": "cuda",
         "source": "vkrt_tpu_torch/csrc/raster_edge.cu",
         "replaces": "vkrt_tpu/raster/edge.py:204",
         "launches": res_raster["launches"]["G"],
         "max_abs_err": max(probe_err["G"], res_13["max_abs_err"]),
         "ms": res_13["ms_sample0"], "plain_ms": res_13["plain_ms_sample0"],
         "bound_ms": res_13["bound_sample0"]["bound_ms"],
         "bound_by": res_13["bound_sample0"]["bound_by"],
         "library_ms": None}
    a_prime = {"name": "trace_occluded", "route": "cuda",
               "source": "vkrt_tpu_torch/csrc/trace_occluded.cu",
               "replaces": "vkrt_tpu/rt/dense.py:367",
               "launches": res_pl["launches"]["A'"],
               "max_abs_err": max([probe_err["A'"]]
                                  + [r["max_abs_err"] for r in res_15]),
               "ms": sum(r["ms"] for r in res_15),
               "plain_ms": sum(r["plain_ms"] for r in res_15),
               **{key: add_bounds(res_15)[key]
                  for key in ("bound_ms", "bound_by")},
               "library_ms": None,
               "design": "redesigned: kernel B's group walk (walk.cuh) "
                         "with one segment set"}
    log(f"== total {time.perf_counter() - t_start:.1f} s from the build on")
    log(smi)
    log(json.dumps({"kernels": [
        entry("trace_closest", "A", "vkrt_tpu_torch/csrc/trace_closest.cu",
              "vkrt_tpu/rt/dense.py:238"),
        a_prime,
        entry("occl_multi", "B", "vkrt_tpu_torch/csrc/occl_multi.cu",
              "vkrt_tpu/rt/occl_multi.py:40"),
        entry("consolidate", "C", "vkrt_tpu_torch/csrc/pack.cu",
              "vkrt_tpu/wavefront/pack.py:98"),
        entry("scatter_back", "D", "vkrt_tpu_torch/csrc/pack.cu",
              "vkrt_tpu/wavefront/pack.py:200"),
        {**entry("lane_sort", "E", "vkrt_tpu_torch/csrc/lanesort.cu",
                 "vkrt_tpu/wavefront/lanesort.py:79"),
         "design": "redesigned: a shared-memory LSD radix sort, 8 bits a "
                   "pass"},
        entry("lane_unsort", "F", "vkrt_tpu_torch/csrc/lanesort.cu",
              "vkrt_tpu/wavefront/lanesort.py:162"),
        g,
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
