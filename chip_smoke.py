"""Smoke run of vkrt_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases; any failure raises and the run exits non-zero. They run in this
order, except that 14-18, 30, 24 and 25 (which share the config-4 renderer)
run between the profile after phase 9 and phase 10, and 19-23 (the app
surface, the golden gate, the reference backend, mip_lod and the sharded
frames) and 26 after phase 13. Each phase states its path: the renderers
of phases 7, 9, 12-14, 16-18, 24 and 25 and the sharded frames of 23 are
eager (graph=False: they record kernel inputs, time ranges by CUDA events
or profile per range, and their frames are phase 26's references);
phases 6, 8, 11, 15, 17's small frames, 19, 23's dry run, its 4-shard
raster frame and --shard, and 26 run the default, a CUDA graph a frame
(graphs.py). Launches are counted on the host by the kernels' wrappers
(an eager frame's, and a graph's warm-up and capture: a replay runs no
Python) and, for graphs, on the card by torch.profiler, which records
every kernel node of a replay by name (graphs.kernel_launches):
  1. device   fail at once without CUDA; print the device report
  2. build    compile kernels A-K and A' from vkrt_tpu_torch/csrc/ into
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
              shipped defaults (the depth>=1 shadow reorder on), eager,
              1920x1080, full procedural scene (262,267 triangles): one
              warm-up frame, then N_FRAMES timed frames along the
              fly-through camera path; exactly A 2, B 2, C 1, D 1, E 1,
              F 1, K 2, L1-L3 2 each launches per frame; device and host
              enqueue ms a frame
  8. flags off  the same frames with the three reorder flags off (the
              path before C-F), as CUDA graphs: A 2, B 2, K 2, L1-L3 2
              each and no C-F launches per frame; its u8 frames and ray
              counts must equal phase 7's bit for bit
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
              (sheets across w = 0: boxes from kernel J), at three
              sample offsets, with random and parked depth floors, then a
              continuation round behind every hit; per pose a tie probe
              (one triangle in two clusters, the copy of the higher slot
              in the cluster the front-to-back walk visits first: the
              lower slot must win); on the full scene (33 superclusters)
              per pose the chunk probe: G with its work list cut to
              G_CHUNK superclusters a chunk, torch.equal to G in one chunk
              and to the plain version
 11. raster   64x48 raster frames of the small scene vs the raster oracle
              (vkrt_tpu_torch.golden.raster_oracle): edge method at msaa 1
              and 8 under the flip gate, ray-cast method at msaa 1 by RMSE
 12. raster main  Rasterizer(full scene, reference_config() = 1600x1200,
              "cuda", msaa=8, eager): one warm-up frame, then RASTER_FRAMES
              timed frames along the fly-through path; exactly 32
              launches of G and of I and none of A-F or K per frame; then
              two
              profiled frames (device time per raster range) and one
              ray-cast frame on the first camera, which may differ from
              the edge frame on at most 1% of the pixels; the same gate on
              a frame close to a wall, where clusters wholly behind the
              camera exist and must be empty, and no cluster, those with
              a triangle across w = 0 included, may be full-screen
 13. G shapes kernel G's inputs recorded from one raster frame: kernel vs
              plain on sample 0, rounds 0 and 1; the kernel's time over
              all 32 calls, the plain version's on sample 0's 4 calls, the
              bound of each, and the setup's box rule at this pose
 28. I shapes kernel I's (raster_sample_round's) 32 calls recorded from
              the same frame: each bit-equal to raster_sample_round_plain
              on the same tensors (colour and depth floor); ms a launch on
              a filled queue, round 0 and rounds 1-3 apart, beside the
              plain version's and the bound (bytes: 8 a lane, 32 more a
              hit, 12 more an opaque hit); the lanes hit and live a round
 29. J shapes kernel J (raster/clip.py::clip_boxes) on the setup of the
              same frame's pose and on the crossing soup's
              (`crossing_soup`: sheets across w = 0 that reach the frame):
              bit-equal to clip_boxes_plain on the CPU copy; ms a launch
              on a filled queue beside the plain version's and the bound
              (bytes: a slot's mask byte and 20 bytes out, 48 bytes of
              rows a crossing slot); the slots crossing and kept
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
              light in place of B), as CUDA graphs: A 2, A' 8, C-F 1, K 2,
              L1-L3 2 launches per frame on the card and none of B; u8
              frames and ray counts bit-equal to phase 7's
              first frames; then A' vs plain and vs B on one frame's recorded
              segments, its time there beside B's, and its bound
 16. config 5   Renderer at config5_stress() (1920x1080, depth 4, 4 lights,
              rebuild_per_frame) with a y-rotation that grows every frame,
              for rebuild = refit, full (device SAH), full_morton: a warm-up
              frame + CONFIG5_FRAMES timed frames each (A 4, B 4, C-F 3,
              K 4, L1-L3 4 each launches per frame, and H 14 in full), the
              accel update's own time (mean of 5),
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
 27. kernel H (device_sah.cut_round, one cut round of the device SAH
              build) vs its plain version `_cut_round` on the card: the
              probes of `cut_case` (every size and kind, rounded either
              way), then the 14 rounds of one build of the full scene
              (2,049 chunks, recorded from device_sah_order), bit-equal,
              and that build's order equal to the one made with the plain
              rounds; ms per launch on a filled queue beside the plain
              version's, the bound and the host's enqueue ms
 18. config-5 shapes  phase 9 on config 5, per rebuild mode: kernels A and
              B at all four depths and C-F at depths 1-3, each vs its plain
              version on the inputs one 1080p frame gives it on the tree
              the accel update makes under rot_y(0.02); kernel ms per depth
 30. K shapes kernel K (shade/sampling.py::sample_hits) on the inputs the
              engine hands it at each depth of one frame at the start
              pose: config 4 (depths 0-1) and config 5 with the full
              rebuild under rot_y(0.02) (depths 0-3); each bit-equal to
              sample_hits_plain on every lane; ms a launch on a filled
              queue beside the plain version's (CUDA events, mean of 5)
              and the bound (bytes: every lane's mask byte and 7 channels
              out, a hit's slot and uv and the two 32-byte sectors of its
              48-byte heap row; OPS_K operations a hit); lanes and hits a
              depth
 31. L shapes kernel L's three steps (shade/shading.py::shade_interp,
              shade_lights, shade_combine) on the inputs the engine hands
              them at each depth of the same two frames; each bit-equal
              to its plain version on every output and every in-place
              update; ms a launch on a filled queue beside the plain
              version's (CUDA events, mean of 5) and the bound (bytes:
              BYTES_L per lane, live lane, hit and reflecting hit; OPS_L
              operations a hit); lanes, live lanes, hits and reflecting
              hits a depth
 19. CLI       app/cli.main(["--config", "4", "--frames", "9", "--metrics",
              "--output", png, "--checkpoint", json], scene=model) on the
              card: the pipelined fly-through (3 frames in flight,
              runtime.FrameScheduler) at 1920x1080, a CUDA graph a frame
              (the CLI's default); exactly A 2, B 2, C-F 1, K 2, L1-L3 2
              launches a frame; its last frame bit-equal to the eager
              Renderer.render of the ninth camera, the checkpoint at frame
              9; the FrameTimer summary (wall clock: device, u8 download
              and host work); then 40 frames, whose steady wall ms/frame
              (retirements 5-37) and Mrays/s are printed beside phase 7's
              CUDA-event ms/frame
 19b. CLI raster  --raster --frames 1 at 1600x1200, msaa 8 (32 launches of
              G and of I): equal to Rasterizer.render_async of the start
              camera on every pixel outside the FPS text
 20. golden   bench.py's gate: a 640x480 reference_config() f32 frame from
              render_frame vs the native C++ oracle with its stability
              mask (golden_metrics): rmse_stable, rmse_trimmed and
              flip_frac each <= 1e-3; stable_frac printed beside 0.90
              (the oracle's mask on the stand-in scene is below it
              whatever tracer runs: PERF.md); the oracle's seconds; then
              golden/harness.main(--oracle native, 160x120) must exit 0
 21. reference  the reference backend (LBVH built on the card, plain-PyTorch
              traversal, no trace kernel launches: K samples, 2 a frame)
              at 320x240, reference_config():
              RMSE <= 1e-3 against the dense frame, ray counts within 0.1%;
              the LBVH build ms and the frame's ms
 22. mip_lod  config 4 at 1080p with mip_lod (1 + 2 frames, their ms beside
              phase 7's); ray_diff_lod and sample_material_trilinear on
              one frame's depth-0 inputs, card vs CPU within rtol = atol =
              1e-6
 23. sharded  parallel/mesh.py on logical shards of the one card: config 4
              at 1920x1080 through render_frame_sharded on make_mesh() (the
              card) and on [card] * 2, 4, 7 (7 pads the 16,320 rows by 4),
              eagerly, 1 + SHARD_FRAMES frames each: f32 frames and grids
              torch.equal to render_frame's on the same cameras, launches A
              2k, B 2k, C-F k, K and L1-L3 2k a frame; per k the device ms
              a frame back to back (CUDA events), the host's enqueue ms a frame
              (perf_counter, no wait; again from an idle stream), the
              device's busy ms a frame (torch.profiler) and peak memory,
              beside the unsharded frame's; the raster frame at 1600x1200,
              MSAA 8, on 1 and 4 shards (and on 4 as graphs) bit-equal to
              render_raster_frame_edge's (32k launches of G and of I); the
              dry run
              dryrun_multichip(4, "cuda"); the CLI's --shard (2 frames, last
              frame equal to Renderer.render's) and --shard 2, which must
              raise ValueError on one card
 24. secondary  the five secondary-dispatch options and kernel A's and B's
              modes (sub_gate, pregate="recheck"). Kernels: each mode vs
              the default kernel (A: every output torch.equal; B: masks
              equal) and vs its plain version in the same mode (phase 3's
              and 4's gates) on phase 3's and 4's probes, A's tie probe and
              B's edge groups, then on one config-4 frame's recorded A and
              B inputs at both depths with the mode kernel's ms (recheck:
              less its prologue's), the default kernel's, the plain
              version's and the bound (sub_gate: the pairs whose sub-run
              box passes). Frames: config 4 (1 + N_FRAMES poses) and
              config 5 refit (1 + CONFIG5_FRAMES frames under the
              per-frame rotation) at the defaults, then with each option
              alone and with resort + recheck + both sub-run gates and
              partition_closest + both sub-run gates (SECONDARY_CASES):
              frames and ray counts torch.equal to the defaults', ms a
              frame by CUDA events, then (config 4) two profiled frames:
              the device's busy ms a frame and its ms per engine range, or
              (config 5) the ranges by CUDA events; launches a frame as
              `frame_launches` says (each mode counted on its own)
 25. modes    the JAX kernels' remaining modes (P25): A's stats, interval
              pregate, group_gate, sort=False and six ablate cuts; A''s
              sub_gate, recheck, interval, stats and ablate cuts (light
              0's segments, point origins); B's visit mid / far, interval,
              group_gate, sort=False and ablate cuts. On one config-4
              frame's recorded inputs at depths 0 and 1 each mode is
              launched once (those launches alone counted: 2 a mode),
              then held element by element against the default kernel (a
              cut: every ray a miss, nothing blocked) and against its
              plain version in the mode; stats lane 0 equal to the plain
              work-list length, lane 1 within `sweep_bounds`; each mode's
              ms (mean of 5; a pregate less its prologue) beside the
              default's, printed per depth as A's and B's phase
              decomposition; trace_closest_stats' iterations on phase
              21's frame; the kernels built once under $VKRT_TORCH_CACHE
              (a temporary directory) and kernel A launched from there
 26. graphs   the frames of phases 7, 16, 12, 23 and 19 on the default
              path, one CUDA graph per static key captured at the first
              frame and replayed: config 4 (1 + N_FRAMES poses), config 5
              in each rebuild mode under the growing rotation, the raster
              frame at 1600x1200, MSAA 8, render_frame_sharded on [card] *
              1, 2, 4, 7; frames and ray counts torch.equal to those
              phases' eager frames of the same cameras, launches a frame
              as they gate them (on the card, the frames replayed once
              more under torch.profiler; on the host, the captures); per
              run the device ms a frame (CUDA events back to back), the
              host's enqueue ms a frame, the busy share (torch.profiler),
              capture ms and peak memory, beside the eager run's; phase
              23's table again with graphs; then the CLI's 40-frame run
              eagerly (its Renderer patched to graph=False) beside phase
              19's, last frames equal
Then the card's nvidia-smi name and power limit, one JSON line with each
kernel's launches on its main path, on the card (phase 26's config-4 graph
frames for A-F and K, phase 15's graph frames for A', phase 26's raster graph
frames for G and I, phase 26's config-5 full-rebuild graph frames for H),
or on
the host for the modes (phase 24's eager frames for
the four mode rows, phase 25's drive for its rows), its largest error,
its time per frame and the bound of that
work, and, as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import itertools
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import graphs, kernels, runtime, tracing
from vkrt_tpu_torch.accel import clusters, device_sah
from vkrt_tpu_torch.accel.clusters import K1, K2, SUB_COL, SUBRUNS
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
from vkrt_tpu_torch.raster import sample as rs
from vkrt_tpu_torch.raster.clip import clip_boxes, clip_boxes_plain
from vkrt_tpu_torch.rt import traverse
from vkrt_tpu_torch.rt.dense import (ABLATES, CUTS, _safe_inv,
                                     broadcast_points, closest_worklists,
                                     gated_pairs, listed_bounds,
                                     listed_matrix, stats_lane0_of,
                                     sub_run_pass, sweep_bounds, trace_dense,
                                     trace_dense_plain, trace_occluded,
                                     trace_occluded_plain)
from vkrt_tpu_torch.rt.occl_multi import (multi_worklists, occluded_multi,
                                          occluded_multi_plain)
from vkrt_tpu_torch.scene import build_texture_heap
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade import sampling, shading
from vkrt_tpu_torch.utils.cache import ENV as CACHE_ENV
from vkrt_tpu_torch.utils.cache import build_root
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
REF_CHUNK = 4096         # phase 25: rays a trace_closest_stats call
REF_RAY_TOL = 1e-3       # ... ray counts, relative (two tracers may part
                         # on a boundary ray: tests/test_torch_engine.py)
MIP_TOL = 1e-6           # mip_lod card vs CPU, rtol and atol
                         # (tests/test_torch_mip.py)
SHARDS = (2, 4, 7)       # phase 23: logical shards of the one card, beside
                         # make_mesh()'s one (7 pads 16,320 rows by 4)
SHARD_FRAMES = 3         # ... timed frames after a warm-up frame
RASTER_SHARDS = (1, 4)
G_CHUNK = 4              # phase 10: kernel G's work list cut to 4
                         # superclusters a chunk (the full scene has 33)
def shade_launches(depths: int) -> dict:
    """Kernel L's launches in a frame of `depths` depths: each of its three
    steps (L1 shade_interp, L2 shade_lights, L3 shade_combine) once a
    depth."""
    return dict(L1=depths, L2=depths, L3=depths)


# a config-4 frame, a config-5 frame
CONFIG4_LAUNCHES = dict(A=2, B=2, C=1, D=1, E=1, F=1, K=2, **shade_launches(2))
CONFIG5_LAUNCHES = dict(A=4, B=4, C=3, D=3, E=3, F=3, K=4, **shade_launches(4))
SAH_ROUNDS = 14          # kernel H a device-SAH build (max_levels)
SHARD_KEYS = ("device_ms", "host_enqueue_ms", "host_enqueue_ms_idle_stream",
              "device_busy_ms", "busy_share_profiled", "peak_mem_gb")
REORDER_OFF = dict(consolidate_secondary=False, group_sort_shadows=False,
                   partition_shadows=False)


class ModeCount:
    """The launch count of one mode of kernel A or B: its wrapper's
    `mode_launches[mode]`, read and set as `launches`."""

    def __init__(self, fn, mode: str):
        self.fn, self.mode = fn, mode

    @property
    def launches(self) -> int:
        return self.fn.mode_launches[self.mode]

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.mode_launches[self.mode] = n


# kernel → wrapper whose `launches` counts its launches (A and B count
# every mode; their mode rows count the launches in that mode)
COUNTED = {"A": trace_dense, "A'": trace_occluded, "B": occluded_multi,
           "C": pack.consolidate,
           "D": pack.scatter_back, "E": lanesort.lane_sort,
           "F": lanesort.lane_unsort, "G": edge.raster_edge,
           "H": device_sah.cut_round, "I": rs.raster_sample_round,
           "J": clip_boxes, "K": sampling.sample_hits,
           "L1": shading.shade_interp, "L2": shading.shade_lights,
           "L3": shading.shade_combine,
           "A.sub_gate": ModeCount(trace_dense, "sub_gate"),
           "A.recheck": ModeCount(trace_dense, "recheck"),
           "B.sub_gate": ModeCount(occluded_multi, "sub_gate"),
           "B.recheck": ModeCount(occluded_multi, "recheck")}
# kernel → the name of its __global__ function (graphs.KERNELS), by which
# the profiler's device events count its launches on the card: a replayed
# graph's too, which run no Python and so move no wrapper's count
ON_CARD = {"A": "trace_closest", "A'": "trace_occluded", "B": "occl_multi",
           "C": "consolidate", "D": "scatter_back", "E": "lane_sort",
           "F": "lane_unsort", "G": "raster_edge", "H": "sah_cut",
           "I": "raster_sample", "J": "raster_clip", "K": "sample_hits",
           "L1": "shade_interp", "L2": "shade_lights", "L3": "shade_combine"}
# kernel A's and B's modes: wrapper arguments
MODES = {"sub_gate": dict(sub_gate=True), "recheck": dict(pregate="recheck")}
# phase 25: the JAX kernels' remaining modes, each a wrapper's
# mode_launches key and its arguments (ablate: every cut point)
ABLATE_KW = {f"ablate_{a}": dict(ablate=a) for a in ABLATES[1:]}
P25 = {
    "A": {"stats": dict(stats=True), "interval": dict(pregate="interval"),
          "group_gate": dict(group_gate=True), "no_sort": dict(sort=False),
          **ABLATE_KW},
    "A'": {"sub_gate": dict(sub_gate=True), "recheck": dict(pregate="recheck"),
           "interval": dict(pregate="interval"), "stats": dict(stats=True),
           **ABLATE_KW},
    "B": {"visit_mid": dict(visit="mid"), "visit_far": dict(visit="far"),
          "interval": dict(pregate="interval"),
          "group_gate": dict(group_gate=True), "no_sort": dict(sort=False),
          **ABLATE_KW}}
# phase 25: pairs of modes, each checked once a depth (not counted, and
# its error added to the row named first): the interval pregate's lists
# in id order (ablate "nosort"), and B's visit orders over a pregate's
# lists (recheck with a visit order needs sort=False)
_INTERVAL_NOSORT = ("interval", dict(pregate="interval", ablate="nosort"))
P25_PAIRS = {
    "A": {"interval_nosort": _INTERVAL_NOSORT},
    "A'": {"interval_nosort": _INTERVAL_NOSORT},
    "B": {"interval_nosort": _INTERVAL_NOSORT,
          "interval_visit_mid": ("interval", dict(pregate="interval",
                                                  visit="mid")),
          "recheck_visit_far": ("visit_far", dict(pregate="recheck",
                                                  sort=False, visit="far"))}}
COUNTED.update({f"{k}.{m}": ModeCount(COUNTED[k], m)
                for k, modes in P25.items() for m in modes})
P25_ROWS = tuple(f"{k}.{m}" for k, modes in P25.items() for m in modes)
PLAIN = {"C": pack.consolidate_plain, "D": pack.scatter_back_plain,
         "E": lanesort.lane_sort_plain, "F": lanesort.lane_unsort_plain}


def log(*a):
    print(*a, flush=True)


def eager(r):
    """A copy of renderer `r` (a Renderer or a Rasterizer) that runs every
    op from Python (graph=False): for the phases whose frames are the
    eager references, record a frame's kernel inputs, time engine ranges
    by CUDA events or profile per range (no host range shows inside a
    graph's replay; tracing.on()'s marks do)."""
    e = copy.copy(r)
    e.graph = False
    return e


def graphed(r):
    """A copy of renderer `r` on the default path (graph=None: a CUDA
    graph per static key, replayed), with a FrameGraph of its own."""
    g = copy.copy(r)
    g.graph, g.graphs = None, graphs.FrameGraph()
    return g


@contextlib.contextmanager
def eager_cli():
    """While active, the CLI's Renderer runs eagerly: the CLI has no flag
    for it (nor has the JAX CLI), so engine.Renderer, which cli.main
    imports when called, becomes Renderer with graph=False."""
    saved = engine.Renderer
    engine.Renderer = functools.partial(saved, graph=False)
    try:
        yield
    finally:
        engine.Renderer = saved


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


def plain_closest_mode(tree, o, d, tmax, mode: str = "", block: int = 0):
    """trace_dense_plain's arguments for kernel A's `mode` ("" default):
    sub_gate as is; the re-check's pairs from the kernel's own prologue
    (`closest_worklists`, on the same inputs)."""
    if mode == "sub_gate":
        return dict(sub_gate=True)
    if mode == "recheck":
        lists = closest_worklists(tree, o, d, tmax, point_origin=bool(block),
                                  block=block or engine.BLOCK)
        return dict(listed=listed_matrix(lists, tree.tri_data.shape[0]))
    return {}


def compare_closest(tree, o, d, tmax, label: str = "", block: int = 0,
                    with_attributes: bool = True, mode: str = "") -> dict:
    """Kernel A vs its plain version on the same inputs: hit masks and
    slots agree on at least HIT_AGREE / SLOT_AGREE of the rays, t to
    T_RTOL where both hit, and t, u, v and attrs are bit-equal on every
    ray whose slots agree (misses included: inf, 0, 0, 0). With `block`,
    `o` is one origin per `block` rays [N/block,3] (the kernel's
    point-origin form; the plain version gets them broadcast); with
    `with_attributes` False the kernel writes no attrs. `mode`: kernel
    A's mode (MODES) in both."""
    kw = dict(block=block, point_origin=True) if block else {}
    got = trace_dense(tree, o, d, tmax, with_attributes=with_attributes,
                      **kw, **MODES.get(mode, {}))
    full = broadcast_points(o, d, block) if block else o
    want = trace_dense_plain(tree, full, d, tmax,
                             **plain_closest_mode(tree, o, d, tmax, mode,
                                                  block))
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
    first; the lower slot must win. The copy's sub-run box is the
    scene's box as well."""
    sc_boxes, cl_boxes, tri, leaf = (x.clone() for x in tree)
    real = sc_boxes[0] <= sc_boxes[3]
    lo = sc_boxes[0:3][:, real].min(dim=1).values
    hi = sc_boxes[3:6][:, real].max(dim=1).values
    tri[spare] = 0.0
    tri[spare, 0] = tree.tri_data[slot // K1, slot % K1]
    # the copy's sub-run box (sub_gate): the scene's box too
    tri[spare, 0, SUB_COL:SUB_COL + 6] = torch.cat([lo, hi])
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


def closest_tie_probe(tree, o, d, tmax, label: str = "",
                      mode: str = "") -> float:
    """What a front-to-back walk could get wrong: the most-hit triangle
    is copied into a padding cluster of a higher id under the scene's box
    (`tie_tree`), which the walk visits first. Kernel A (in `mode`) must
    agree with its plain version on every ray (no slot differs), return
    the lower slot (every output equal to the run without the copy) and,
    with the original's row zeroed, hand the same rays to the copy."""
    kw = MODES.get(mode, {})
    want = trace_dense(tree, o, d, tmax, **kw)
    slot, spare = tie_slots(tree, want[1])
    tt = tie_tree(tree, slot, spare)
    out = compare_closest(tt, o, d, tmax, f" (tie probe{label})", mode=mode)
    got = trace_dense(tt, o, d, tmax, **kw)
    alone = tt._replace(tri_data=tt.tri_data.clone())
    alone.tri_data[slot // K1, slot % K1] = 0.0
    took = trace_dense(alone, o, d, tmax, **kw)
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


def plain_occl_mode(tree, lp, sd, st, mode: str = "") -> dict:
    """occluded_multi_plain's arguments for kernel B's `mode`."""
    if mode == "sub_gate":
        return dict(sub_gate=True)
    if mode == "recheck":
        return dict(lists=multi_worklists(tree, lp, sd, st))
    return {}


def compare_occl(tree, lp, sd, st, near: bool = True,
                 label: str = "", mode: str = "") -> dict:
    """Kernel B vs its plain version on the same inputs, both in `mode`
    (MODES; "" the default); parked segments, and the planted near-light
    ones (`near`), are not blocked."""
    kb = occluded_multi(tree, lp, sd, st, **MODES.get(mode, {}))
    pb = occluded_multi_plain(tree, lp, sd, st,
                              **plain_occl_mode(tree, lp, sd, st, mode))
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


def occl_group_probe(tree, lp, sd, st, mode: str = "") -> float:
    """Phase 4's edge groups (`edge_groups`): kernel B's masks (in
    `mode`) must equal the plain version's, and those four groups come
    out as they must. Returns the largest error."""
    sd, st = edge_groups(tree, lp, sd, st)
    out = compare_occl(tree, lp, sd, st, near=False,
                       label=" (edge groups: all blocked, parked, empty, "
                             "one live lane)" + (f", {mode}" if mode else ""),
                       mode=mode)
    kb = occluded_multi(tree, lp, sd, st, **MODES.get(mode, {}))
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


CUT_SIZES = (1, 2, 64, 65, 1025, 2049, 131072)   # chunks (c5 builds 2,049)
CUT_KINDS = ("one", "singles", "mixed", "padding", "ties")
CUT_LENGTHS = (1, 2, 3, 7, 40, 64, 65, 100, 129, 300)   # "mixed" segments


def cut_case(nc: int, kind: str, seed: int = SEED) -> tuple:
    """Inputs of one cut round (device_sah.cut_round) on the CPU: cb
    bool[nc], nmin / nmax f32[nc,3], ncnt f32[nc]. "one" segment;
    "singles", every chunk a segment of its own (no valid cut); "mixed",
    segments of CUT_LENGTHS chunks, some longer than K2 (K2-aligned
    cuts); "padding", mixed with a fifth of the chunks padding-only
    (+-_INF boxes, count 0), a padding tail, and a fifth of the segments
    holding triangles in their first chunk alone (no valid cut); "ties",
    mixed with one unit box and one count in every chunk, so that every
    valid cut of a segment costs exactly the same and the lowest must
    win."""
    rng = np.random.default_rng(seed + 7919 * nc)
    if kind == "one":
        cb = np.zeros(nc, bool)
    elif kind == "singles":
        cb = np.ones(nc, bool)
    else:
        lens = rng.choice(CUT_LENGTHS, size=nc)
        starts = np.cumsum(lens) - lens
        cb = np.zeros(nc, bool)
        cb[starts[starts < nc]] = True
    cb[0] = True
    lo = rng.uniform(-100.0, 100.0, (nc, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 20.0, (nc, 3))).astype(np.float32)
    cnt = rng.integers(1, K1, nc).astype(np.float32)    # sum below 2^24
    if kind == "ties":
        lo[:], hi[:], cnt[:] = 0.0, 1.0, 64.0
    if kind == "padding":
        sid = np.cumsum(cb) - 1
        alone = rng.random(sid[-1] + 1) < 0.2
        pad = (rng.random(nc) < 0.2) | (alone[sid] & ~cb)
        pad[-max(1, nc // 50):] = True
        lo[pad], hi[pad], cnt[pad] = clusters._INF, -clusters._INF, 0.0
    return tuple(torch.from_numpy(x) for x in (cb, lo, hi, cnt))


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

    def closest(self, o, d, tmax, **modes):
        self.closest_in.append((o.clone(), d.clone(), tmax.clone()))
        return self.inner.closest(o, d, tmax, **modes)

    def occluded_multi(self, light_pts, sd, st, block=engine.BLOCK,
                       **modes):
        self.occl_in.append((light_pts.clone(), sd.clone(), st.clone()))
        self.occl_block.append(block)
        return self.inner.occluded_multi(light_pts, sd, st, block=block,
                                         **modes)


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
LANE_BYTES_K = 1 + 7 * 4   # kernel K per lane: the hit mask, 7 channels out
HIT_BYTES_K = 4 + 8 + 64   # per hit: slot, uv, two sectors of the heap row
OPS_K = 90    # kernel K per hit: the bilinear weights and 7 four-term blends
# kernel L's bytes per lane, per live lane, per hit and per reflecting hit
# (step 2 also 4 a lane for the casts and 16 a light and lane for the
# shadow segments where it writes them; step 3 also 1 a light and hit for
# the blocked masks, and 16 a lane where it writes the colour and count
# in place of adding them: then 2 a live lane, not 34)
BYTES_L = {"shade_interp": (26, 1, 72, 0),     # masks, 24 out; u, v, 16 rows
           "shade_lights": (13, 0, 104, 0),    # mask, pn; u, v, 18 rows,
                                               # map_n, pos
           "shade_combine": (1, 34, 44, 40)}   # mask; hitm, accum and count
                                               # r/w, active; base, metallic,
                                               # pn, pos, attenuation; carry
OPS_L = {"shade_interp": (24, 0), "shade_lights": (70, 20),
         "shade_combine": (40, 25)}   # a hit's operations, + per light


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


def sub_tris(rows) -> torch.Tensor:
    """Live triangles per cluster and sub-run: [C1p, SUBRUNS] int64."""
    live = (rows[..., :9] != 0).any(-1)
    return live.reshape(rows.shape[0], SUBRUNS, -1).sum(dim=2)


def trace_pairs(tree, o, d, t_end, ntri, sub: bool = False) -> int:
    """(ray, triangle) pairs whose segment [TMIN, t_end] enters the
    triangle's cluster and supercluster boxes. o, d [3,N], t_end [N].
    With `sub` (ntri from `sub_tris`), only the triangles whose sub-run
    box (widened, as sub_gate tests it) the segment enters as well."""
    if not sub:
        return sum(int(ntri[cl].sum()) for _, cl in gated_pairs(tree, o, d,
                                                                t_end))
    inv = _safe_inv(d)
    return sum(int((sub_run_pass(tree, cl, o[:, r], inv[:, r], t_end[r])
                    * ntri[cl]).sum())
               for r, cl in gated_pairs(tree, o, d, t_end))


def closest_bound(tree, o, d, tm, t, ntri, sub: bool = False) -> dict:
    """Kernel A's work on one call: rays and outputs once, the tree's 36
    attribute columns once, OPS_A per (ray, triangle) pair up to the
    final hit (to tmax on a miss); with `sub`, the pairs of sub_gate."""
    n = tm.numel()
    t_end = torch.where(torch.isfinite(t), t, tm).reshape(n)
    pairs = trace_pairs(tree, o.reshape(3, n), d.reshape(3, n), t_end, ntri,
                        sub)
    return bound(n * 4 * (3 + 3 + 1) + n * 4 * (4 + 36)
                 + tree_bytes(tree, 36), pairs * OPS_A)


def occl_bound(tree, lp, sd, st, ntri, out_bytes: int = 1,
               sub: bool = False) -> dict:
    """Kernel B's work on one call: segments and masks once, the tree's
    9 geometry columns once, OPS_B per (segment, triangle) pair up to the
    segment's nearest blocker (found with kernel A; its end if none).
    `out_bytes` per segment: 1 for B's mask, 16 for the t, slot, u, v
    that kernel A' writes (one call per light; the same work in all).
    With `sub`, the pairs of sub_gate."""
    ns, _, nb, lanes = sd.shape
    n = nb * lanes
    pairs = 0
    for s in range(ns):
        o = lp[s][:, None, None].expand(3, nb, lanes).contiguous()
        t = trace_dense(tree, o, sd[s].contiguous(), st[s])[0]
        t_end = torch.minimum(t, st[s]).reshape(n)
        pairs += trace_pairs(tree, o.reshape(3, n), sd[s].reshape(3, n),
                             t_end, ntri, sub)
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
    log(f"  64x48 frame vs oracle ({'graph' if r.captured() else 'eager'}):"
        f" rmse {err:.3e} (bar {GOLDEN_RMSE}), "
        f"rays {rays}, finite {bool(np.isfinite(fb).all())}")
    if not (np.isfinite(fb).all() and fb.shape == (48, 64, 3)
            and err <= GOLDEN_RMSE):
        raise AssertionError(f"frame vs oracle failed: rmse {err}")
    return err


def drive(renderer: Renderer, cams, per_frame: dict, label: str,
          transforms=None):
    """Phases 7, 8, 15, 16 and 26: a warm-up frame on cams[0] (a graph's
    capture), then one timed frame per further camera, enqueued back to
    back through render_async (with transforms[k] as the frame's instance
    transform, if given), the host's ms to enqueue each (perf_counter, no
    wait) beside the device's (CUDA events). Every launch count is set to
    0 just before and read just after (`host_launches`), and must be
    per_frame[k] a frame eagerly; on a graph, per_frame[k] twice for the
    first frame's warm-up and capture and nothing for a replay. A graph's
    frames then replay once more, the same cameras back to back, under
    torch.profiler (`launches`: each kernel's launches on the card, which
    must be per_frame[k] a frame; `profile`: the busy share). Returns
    (results, [(u8 frame, ray count)] per camera)."""
    cfg = renderer.cfg
    n = len(cams) - 1
    tf = (lambda k: ()) if transforms is None else (lambda k:
                                                    (transforms[k],))
    graph = renderer.captured()
    held = len(renderer.graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    wall0 = time.perf_counter()
    first = renderer.render_async(cams[0], *tf(0))          # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - wall0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    outs, host = [], []
    wall1 = time.perf_counter()
    events[0].record()
    for k in range(n):
        t0 = time.perf_counter()
        outs.append(renderer.render_async(cams[k + 1], *tf(k + 1)))
        host.append((time.perf_counter() - t0) * 1e3)
        events[k + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frame_ms = [events[k].elapsed_time(events[k + 1]) for k in range(n)]
    prof = None
    if graph:
        prof = profiled([functools.partial(renderer.render_async, c, *tf(k))
                         for k, c in enumerate(cams)], f"{label}, replays",
                        per_frame=per_frame)
    launches = {k: f.launches for k, f in COUNTED.items()}
    captured = len(renderer.graphs) > held
    host_frames = (2 * captured) if graph else n + 1
    ray_total = sum(int(r.item()) for _, r in outs)
    total_ms = sum(frame_ms)
    res = dict(frames=n, path="graph" if graph else "eager",
               warmup_s=warm_s,
               frame_ms=float(np.mean(frame_ms)), frame_ms_each=frame_ms,
               host_enqueue_ms=float(np.mean(host)),
               wall_ms_per_frame=wall_s * 1e3 / n,
               rays_per_frame=ray_total / n,
               mrays_per_s=ray_total / (total_ms * 1e3),
               peak_mem_gb=peak,
               launches=prof["launches"] if graph else launches,
               host_launches=launches, profile=prof)
    log(f"  {label}:", json.dumps({k: v for k, v in res.items()
                                   if k != "profile"}))
    want = {k: per_frame.get(k, 0) * host_frames for k in COUNTED}
    if launches != want:
        raise AssertionError(f"{label}: expected launches on the host "
                             f"{want} ({per_frame} per frame, path "
                             f"{res['path']}), got {launches}")
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
    """While active, every span of the engine (tracing.span, through
    tracing.listen) records a CUDA event where it opens and where it
    closes; the time between two consecutive events goes to the innermost
    span open between them (`spans`), so that the spans partition the
    stream's timeline: on one stream a span's time runs from the end of
    the work queued before it to the end of its own, any wait for the
    host included, and no two spans share time."""

    def __init__(self):
        self.events = []          # (innermost span after it or None, event)
        self._open = []

    def __enter__(self):
        self._hook = tracing.listen(self._on_span)
        self._hook.__enter__()
        return self

    def __exit__(self, *exc):
        self._hook.__exit__(*exc)

    def _on_span(self, name, opening):
        if opening:
            self._open.append(name)
        else:
            self._open.pop()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((self._open[-1] if self._open else None, ev))

    @property
    def spans(self):
        """(span, start event, end event) of each interval between two
        consecutive events that a span holds."""
        return [(name, a, b) for (name, a), (_, b)
                in zip(self.events, self.events[1:]) if name is not None]


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


def profile_frames(render, label: str, names=ENGINE_RANGES,
                   per_frame: dict | None = None) -> dict:
    """PROFILE_FRAMES frames of `render()` (a Renderer's or a Rasterizer's
    render_async of one camera, or a sharded frame) after a warm-up one,
    through `profiled`."""
    render()
    torch.cuda.synchronize()
    return profiled([render] * PROFILE_FRAMES, label, names, per_frame)


def profiled(calls, label: str, names=ENGINE_RANGES,
             per_frame: dict | None = None) -> dict:
    """The frames of `calls` enqueued back to back under torch.profiler:
    device time per range whose name starts with one of `names`
    (tracing.span's host ranges in wavefront/engine.py and
    raster/pipeline.py; a graph's replay shows none: tracing's marks
    time a replay's spans, which bench_torch reads) and outside them,
    per frame; the device's busy share of the wall clock from the first
    enqueue to the last result; the top device kernels; each counted
    kernel's launches on the card (`launches`: graphs.kernel_launches,
    replays included), which with `per_frame` must be per_frame[k] a
    frame."""
    from torch.profiler import ProfilerActivity, profile

    n = len(calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    ranges = {e.key: e.device_time_total / 1e3 / n for e in ev
              if e.key.startswith(names)}
    # device events, less the ranges' own annotations (not kernels)
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith(names)]
    busy_us = sum(e.self_device_time_total for e in dev)
    on_card = graphs.kernel_launches(ev)
    launches = {k: on_card[name] for k, name in ON_CARD.items()}
    res = dict(frames=n, wall_ms_per_frame=wall_us / 1e3 / n,
               device_busy_ms_per_frame=busy_us / 1e3 / n,
               busy_share=busy_us / wall_us,
               range_ms=dict(sorted(ranges.items())),
               other_ms=busy_us / 1e3 / n - sum(ranges.values()),
               launches=launches)
    log(f"  profiled frames ({label}):", json.dumps(res))
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / n:9.3f} ms/frame "
            f"x{e.count:<4d} {e.key[:90]}")
    if per_frame is not None:
        want = {k: per_frame.get(k, 0) * n for k in ON_CARD}
        if launches != want:
            raise AssertionError(f"{label}: expected launches on the card "
                                 f"{want} ({per_frame} per frame), got "
                                 f"{launches}")
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
    the camera, so triangles cross w = 0."""
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


def crossing_slots(tree, setup, view, proj):
    """bool [C1p, 128]: the slots kernel J clips (a corner at w <= 1e-9,
    another in front, setup rows kept), from the corners' w in
    float64."""
    wrow = (proj.double() @ view.double())[3]
    td = tree.tri_data.double()
    v0 = td[..., 0:3]
    ws = [(p * wrow[:3]).sum(-1) + wrow[3]
          for p in (v0, v0 + td[..., 3:6], v0 + td[..., 6:9])]
    near = (ws[0] <= 1e-9) | (ws[1] <= 1e-9) | (ws[2] <= 1e-9)
    behind = (ws[0] <= 0) & (ws[1] <= 0) & (ws[2] <= 0)
    return (setup[..., :9] != 0).any(-1) & near & ~behind


def clip_shapes(rast, cam) -> dict:
    """Phase 29: kernel J on the setup of `rast`'s tree at `cam` and on
    the crossing soup's at the same pose (module docstring)."""
    w, h = rast.cfg.width, rast.cfg.height
    view = torch.as_tensor(cam.view_matrix, device=rast.device)
    proj = torch.as_tensor(cam.projection_matrix, device=rast.device)
    res = {}
    for name, tree in (("scene", rast.backend.tree),
                       ("soup", crossing_soup(cam, rast.device))):
        setup = edge.build_raster_setup(tree, view, proj, w, h)[0]
        crossing = crossing_slots(tree, setup, view, proj)
        got = clip_boxes(setup, crossing, w, h)
        want = clip_boxes_plain(setup.cpu(), crossing.cpu(), w, h)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"kernel J ({name}): differs from "
                                 f"clip_boxes_plain")
        q = queued_ms([lambda: clip_boxes(setup, crossing, w, h)])
        n, nc = crossing.numel(), int(crossing.sum())
        r = dict(slots=n, crossing=nc,
                 kept=int((crossing & (got[0] <= got[2])).sum()),
                 bit_equal=True, ms=q["ms"], enqueue_ms=q["enqueue_ms"],
                 plain_ms=cuda_ms(lambda: clip_boxes_plain(
                     setup, crossing, w, h), 3),
                 **bound(n * 21 + nc * 48, 0))
        log(f"  kernel J ({name}, {w}x{h}):", json.dumps(r))
        res[name] = r
    return res


def crossing_soup(cam: Camera, device, seed: int = 5):
    """A tree (Morton-ordered, on `device`) in which many triangles cross
    w = 0 of `cam` and their sheets reach its frame, as no pose of the
    procedural scenes has them: 1,000 triangles with one corner 0.2-3
    units behind the camera plane and two 1-15 units in front inside the
    view, two floor triangles 40 units across 1.5 units below the eye
    (half behind the camera), and 7,000 small triangles 2-30 units in
    front. Built in view space and carried to the world by
    cam.view_inverse, like test_torch_cuda.py's soup."""
    rng = np.random.default_rng(seed)
    n_cross, n_small = 1000, 7000
    a = np.stack([rng.uniform(-3, 3, n_cross), rng.uniform(-3, 3, n_cross),
                  rng.uniform(0.2, 3, n_cross)], 1)
    b = np.stack([rng.uniform(-8, 8, n_cross), rng.uniform(-6, 6, n_cross),
                  rng.uniform(-15, -1, n_cross)], 1)
    c = b + rng.uniform(-3, 3, (n_cross, 3))
    c[:, 2] = np.minimum(c[:, 2], -0.5)
    f = np.array([[-40.0, -1.5, 40.0], [40.0, -1.5, 40.0],
                  [40.0, -1.5, -40.0], [-40.0, -1.5, -40.0]])
    s0 = np.stack([rng.uniform(-15, 15, n_small),
                   rng.uniform(-10, 10, n_small),
                   rng.uniform(-30, -2, n_small)], 1)
    v0 = np.concatenate([a, f[[0, 0]], s0])
    e1 = np.concatenate([b - a, f[[1, 2]] - f[[0, 0]],
                         rng.uniform(-0.5, 0.5, (n_small, 3))])
    e2 = np.concatenate([c - a, f[[2, 3]] - f[[0, 0]],
                         rng.uniform(-0.5, 0.5, (n_small, 3))])
    vi = np.asarray(cam.view_inverse, np.float64)
    v0 = v0 @ vi[:3, :3].T + vi[:3, 3]
    e1, e2 = e1 @ vi[:3, :3].T, e2 @ vi[:3, :3].T
    return clusters.build_clusters(
        *(torch.as_tensor(x, dtype=torch.float32, device=device)
          for x in (v0, e1, e2)), method="morton")


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


def chunk_probe(setup, scb, clb, px, py, inside, label: str) -> None:
    """Kernel G on a tree beyond one chunk: the work list cut to G_CHUNK
    superclusters, so the kernel walks the tree chunk by chunk, carrying
    each pixel's depth and slot; every output must be torch.equal to the
    kernel's in one chunk and to the plain version's."""
    zf = torch.where(inside, 0.0, edge.ZFAR_PARK)
    got = edge.raster_edge(setup, scb, clb, px, py, zf, chunk=G_CHUNK)
    one = edge.raster_edge(setup, scb, clb, px, py, zf)
    want = edge.raster_edge_plain(setup, scb, clb, px, py, zf)
    n_sc = clb.shape[0]
    res = dict(superclusters=n_sc, chunk=G_CHUNK,
               chunks=-(-n_sc // G_CHUNK),
               hit_frac=(got[1] >= 0).float().mean().item(),
               equal_one_chunk=all(torch.equal(a, b)
                                   for a, b in zip(got, one)),
               equal_plain=all(torch.equal(a, b) for a, b in zip(got, want)))
    log(f"  kernel G in chunks{label}):", json.dumps(res))
    if not (res["chunks"] > 1 and res["equal_one_chunk"]
            and res["equal_plain"]):
        raise AssertionError(f"kernel G in chunks failed: {res}")


def probe_raster(dev, scenes) -> float:
    """Phase 10: kernel G vs its plain version on probes. For each scene
    (name, tree, width, height): the start pose and a pose by a wall, at
    the pixel centre and two MSAA offsets, with depth floors 0 (60%),
    random in [0.9, 1) (25%) and parked (15%, and the tile padding), then
    a continuation round with the floor at every hit's depth; per pose
    the tie probe (`tie_probe`) and, on a tree of more than G_CHUNK
    superclusters, the chunk probe (`chunk_probe`). Returns the largest
    error."""
    rng = np.random.default_rng(SEED)
    err, n = 0.0, 0
    for name, tree, w, h in scenes:
        cfg = dataclasses.replace(C.reference_config(), width=w, height=h)
        for pose, cam in (("start", start_camera(w, h)),
                          ("wall", wall_camera(w, h))):
            setup, scb, clb = edge.build_raster_setup(
                tree, torch.as_tensor(cam.view_matrix, device=dev),
                torch.as_tensor(cam.projection_matrix, device=dev), w, h)
            if bool((clb[:, 0] == -1e8).any()):
                raise AssertionError(f"{name} {pose}: a full-screen box")
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
            if clb.shape[0] > G_CHUNK:
                chunk_probe(setup, scb, clb, px, py, inside,
                            f" ({name} {w}x{h}, {pose}")
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
        out = dict(method=method, msaa=msaa,
                   path="graph" if rast.captured() else "eager",
                   flip_share=float(flipped.mean()),
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
    """Phases 12 and 26: a warm-up frame on cams[0], then one timed frame
    per further camera, enqueued back to back (CUDA events between
    frames; the host's enqueue ms of each, no wait). Every launch count
    is set to 0 just before and read just after: G and I must have 32
    launches per frame and A-F none, counted as `drive` says (on a graph: the
    host counts the first frame's warm-up and capture, and the card,
    under torch.profiler, the frames replayed once more). Returns
    (results, the frames)."""
    n = len(cams) - 1
    per_frame = {"G": 32, "I": 32, "J": 1}
    graph = rast.captured()
    held = len(rast.graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    wall0 = time.perf_counter()
    first = rast.render_async(cams[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - wall0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    outs, host = [], []
    wall1 = time.perf_counter()
    events[0].record()
    for k in range(n):
        t0 = time.perf_counter()
        outs.append(rast.render_async(cams[k + 1]))
        host.append((time.perf_counter() - t0) * 1e3)
        events[k + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frame_ms = [events[k].elapsed_time(events[k + 1]) for k in range(n)]
    prof = None
    if graph:
        prof = profiled([functools.partial(rast.render_async, c)
                         for c in cams], "raster main path, replays",
                        RASTER_RANGES, per_frame)
    launches = {k: f.launches for k, f in COUNTED.items()}
    host_frames = 2 * (len(rast.graphs) > held) if graph else n + 1
    res = dict(frames=n, path="graph" if graph else "eager",
               warmup_s=warm_s, frame_ms=float(np.mean(frame_ms)),
               frame_ms_each=frame_ms, host_enqueue_ms=float(np.mean(host)),
               wall_ms_per_frame=wall_s * 1e3 / n, peak_mem_gb=peak,
               launches=prof["launches"] if graph else launches,
               host_launches=launches, profile=prof)
    want = {k: per_frame.get(k, 0) * host_frames for k in COUNTED}
    if launches != want:
        raise AssertionError(f"raster main path: expected launches on the "
                             f"host {want}, got {launches}")
    cam0 = cams[0]
    setup_ms = cuda_ms(lambda: edge.build_raster_setup(
        rast.backend.tree,
        torch.as_tensor(cam0.view_matrix, device=rast.device),
        torch.as_tensor(cam0.projection_matrix, device=rast.device),
        rast.cfg.width, rast.cfg.height), 5)
    res.update(setup_ms=setup_ms, setup_share=setup_ms / res["frame_ms"])
    log("  raster main path:", json.dumps({k: v for k, v in res.items()
                                           if k != "profile"}))
    outs = [first] + outs
    for fb in outs:
        if fb.shape != (rast.cfg.height, rast.cfg.width, 3):
            raise AssertionError(f"raster frame shape {tuple(fb.shape)}")
        if not bool(torch.isfinite(fb).all()):
            raise AssertionError("raster frame is not finite")
        if fb.std().item() < 0.01:
            raise AssertionError("raster frame is flat")
    return res, outs


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
    """While active, the raster pipeline's calls of `name` (raster_edge:
    kernel G; raster_sample_round: kernel I) go through a wrapper that
    keeps a copy of their tensor inputs (the pipeline module's name is
    swapped; the launch count is untouched)."""

    def __init__(self, name: str = "raster_edge"):
        self.name = name

    def __enter__(self):
        self.saved = getattr(rp, self.name)
        self.calls = []

        def call(*args):
            self.calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args))
            return self.saved(*args)

        setattr(rp, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(rp, self.name, self.saved)


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
    some triangle has a corner at w <= 1e-9 and another in front (those
    kernel J clips); `near`, some triangle has a corner at w <= 1e-9 (the
    JAX package's full-screen rule, which counts those behind too)."""
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


def screen_boxes(rast, cam, clb, label: str) -> dict:
    """The setup's box rule at one pose: no cluster is full-screen; the
    clusters wholly behind the camera exist and have empty boxes; of the
    clusters with a triangle crossing w = 0 (the JAX package's rule would
    make them and those behind full-screen), `crossing_on_screen` still
    reach the screen, with `crossing_screen_share` the largest share of
    it one covers."""
    behind, crossing, near = camera_classes(rast, cam)
    box = clb.permute(1, 0, 2).reshape(8, -1)
    full, empty = box[0] == -1e8, box[0] == 1e8
    w, h = rast.cfg.width, rast.cfg.height
    span = ((box[3].clamp(0, w) - box[0].clamp(0, w)).clamp(min=0)
            * (box[4].clamp(0, h) - box[1].clamp(0, h)).clamp(min=0))
    on = crossing & ~empty & (span > 0)
    res = dict(clusters=box.shape[1], full_screen_clusters=int(full.sum()),
               full_screen_jax_rule=int(near.sum()),
               crossing_clusters=int(crossing.sum()),
               crossing_on_screen=int(on.sum()),
               crossing_screen_share=float(span[crossing].max() / (w * h))
               if bool(crossing.any()) else 0.0,
               behind_camera_clusters=int(behind.sum()),
               empty_clusters=int(empty.sum()),
               behind_are_empty=bool(empty[behind].all()))
    log(f"  screen boxes ({label}):", json.dumps(res))
    if not (res["behind_camera_clusters"] > 0 and res["crossing_clusters"] > 0
            and res["full_screen_clusters"] == 0
            and res["behind_are_empty"]):
        raise AssertionError(f"screen-box rule failed ({label}): {res}")
    return res


def wall_pose_frame(rast) -> None:
    """Phase 12's wall-pose probe at the full width: close to a wall,
    where clusters wholly behind the camera exist and are empty, no
    cluster is full-screen and the edge frame still passes the ray-cast
    frame gate."""
    cam = wall_camera(rast.cfg.width, rast.cfg.height)
    _, _, clb = edge.build_raster_setup(
        rast.backend.tree,
        torch.as_tensor(cam.view_matrix, device=rast.device),
        torch.as_tensor(cam.projection_matrix, device=rast.device),
        rast.cfg.width, rast.cfg.height)
    screen_boxes(rast, cam, clb, "wall pose")
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
    (`screen_boxes`)."""
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
    boxes = screen_boxes(rast, cam, calls[0][2], "start pose")
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


def sample_hits_shapes(renderer: Renderer, cam: Camera, transform=None,
                       label: str = "config 4") -> list:
    """Phase 30: record the inputs the engine hands kernel K
    (sampling.sample_hits) at each depth of one eager frame of `renderer`
    (with `transform`, on the tree its accel update makes); each call
    against sample_hits_plain on the same tensors, every output bit for
    bit; ms a launch on a filled queue (`queued_ms`) beside the plain
    version's (CUDA events, mean of 5) and the bound of that call's
    lanes and hits (LANE_BYTES_K, HIT_BYTES_K, OPS_K). Rows in depth
    order."""
    backend = renderer.backend
    if transform is not None:
        backend = backend._replace(tree=renderer.update_tree(transform))
    calls, inner = [], engine.sample_hits

    def recorded(tex, slot_ids, uv, hit):
        calls.append((slot_ids.clone(), uv.clone(), hit.clone()))
        return inner(tex, slot_ids, uv, hit)

    engine.sample_hits = recorded
    try:
        render_frame_u8(backend, renderer.tex,
                        engine.upload_matrix(cam.proj_inverse,
                                             renderer.device),
                        engine.upload_matrix(cam.view_inverse,
                                             renderer.device),
                        renderer.lights, renderer.cfg)
        torch.cuda.synchronize()
    finally:
        engine.sample_hits = inner
    if len(calls) != renderer.cfg.max_depth:
        raise AssertionError(f"recorded {len(calls)} calls of kernel K in "
                             f"one frame ({label}), want "
                             f"{renderer.cfg.max_depth}")
    tex, rows = renderer.tex, []
    for depth, (slot_ids, uv, hit) in enumerate(calls):
        got = sampling.sample_hits(tex, slot_ids, uv, hit)
        want = sampling.sample_hits_plain(tex, slot_ids, uv, hit)
        n, hits = hit.numel(), int(hit.sum())
        r = dict(depth=depth, lanes=n, hits=hits, hit_share=hits / n,
                 equal=all(torch.equal(a, b) for a, b in zip(got, want)),
                 max_abs_err=max(float((a - b).abs().max())
                                 for a, b in zip(got, want)),
                 **bound(n * LANE_BYTES_K + hits * HIT_BYTES_K,
                         OPS_K * hits))
        copies = input_copies((slot_ids, uv, hit), r["bytes"])
        r.update(queued_ms([functools.partial(sampling.sample_hits, tex, *c)
                            for c in copies]))
        r["plain_ms"] = cuda_ms(lambda: sampling.sample_hits_plain(
            tex, slot_ids, uv, hit), 5)
        del copies, got, want
        log(f"  kernel K vs plain ({label}, depth {depth}):", json.dumps(r))
        rows.append(r)
    log(f"  kernel K ms per depth ({label}): " + "; ".join(
        f"d{r['depth']} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
        f"({r['ms'] / r['bound_ms']:.2f}x), plain {r['plain_ms']:.3f}, "
        f"hits {r['hit_share']:.1%}" for r in rows))
    bad = [r["depth"] for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"kernel K differs from its plain version at "
                             f"depths {bad} ({label})")
    return rows


def clone_args(args) -> tuple:
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


def queued_once_ms(calls) -> dict:
    """queued_ms for calls that update their inputs in place: each call
    once, none warmed up (the kernel has run before), behind a spin four
    times queued_ms's first."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4 * SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for f in calls:
        f()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    filled = not start.query()
    torch.cuda.synchronize()
    if not filled:
        raise AssertionError(f"the host took {host_ms:.1f} ms to enqueue "
                             f"{len(calls)} calls: the queue never stayed "
                             f"filled")
    return {"ms": start.elapsed_time(end) / len(calls),
            "enqueue_ms": host_ms / len(calls), "queue_filled": filled}


def shade_bound(step: str, args, out, n: int, live: int, hits: int,
                refl: int) -> dict:
    """The bound (bytes, operations) of one call of kernel L's `step` on
    its recorded arguments and its outputs (BYTES_L, OPS_L)."""
    per_lane, per_live, per_hit, per_refl = BYTES_L[step]
    nl, extra = 0, 0
    if step == "shade_lights":
        nl = 0 if args[6] is None else args[6].shape[0]
        extra = (4 * (out[1] is not None) + 16 * nl * (out[2] is not None))
    elif step == "shade_combine":
        nl = 0 if args[6] is None else args[6].shape[0]
        if args[11] is None:                   # colour and count written
            per_lane, per_live = per_lane + 16, 2
        per_hit += nl * (args[7] is not None)
    base, per_light = OPS_L[step]
    return bound(n * (per_lane + extra) + live * per_live + hits * per_hit
                 + refl * per_refl, hits * (base + per_light * nl))


def shade_hits_shapes(renderer: Renderer, cam: Camera, transform=None,
                      label: str = "config 4") -> list:
    """Phase 31: record the inputs the engine hands kernel L's three
    steps (engine.shade_interp, shade_lights, shade_combine) at each
    depth of one eager frame of `renderer` (with `transform`, on the tree
    its accel update makes); each call against its plain version on
    copies of the same tensors, every output and every in-place update
    bit for bit; ms a launch on a filled queue (`queued_ms`; the combine,
    which updates its inputs, on a copy a call, `queued_once_ms`) beside
    the plain version's (CUDA events, mean of 5) and the bound of that
    call's lanes, live lanes, hits and reflecting hits (`shade_bound`).
    Rows in call order."""
    backend = renderer.backend
    if transform is not None:
        backend = backend._replace(tree=renderer.update_tree(transform))
    steps = ("shade_interp", "shade_lights", "shade_combine")
    inner = {k: getattr(engine, k) for k in steps}
    calls = []

    def recorder(step):
        def recorded(*args, **kw):
            calls.append((step, clone_args(args), dict(kw)))
            return inner[step](*args, **kw)
        return recorded

    for k in steps:
        setattr(engine, k, recorder(k))
    try:
        render_frame_u8(backend, renderer.tex,
                        engine.upload_matrix(cam.proj_inverse,
                                             renderer.device),
                        engine.upload_matrix(cam.view_inverse,
                                             renderer.device),
                        renderer.lights, renderer.cfg)
        torch.cuda.synchronize()
    finally:
        for k in steps:
            setattr(engine, k, inner[k])
    depths = renderer.cfg.max_depth
    if [c[0] for c in calls] != list(steps) * depths:
        raise AssertionError(f"recorded {[c[0] for c in calls]} in one "
                             f"frame ({label}), want {list(steps)} x "
                             f"{depths}")
    rows = []
    for j, (step, args, kw) in enumerate(calls):
        fn, plain = inner[step], getattr(shading, f"{step}_plain")
        got_args, want_args = clone_args(args), clone_args(args)
        got = fn(*got_args, **kw)
        want = plain(*want_args, **kw)
        outs = list(got or ()) + list(got_args)
        wants = list(want or ()) + list(want_args)
        equal = len(outs) == len(wants) and all(
            (a is None and b is None) or (
                torch.is_tensor(a) and torch.is_tensor(b)
                and a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.view(torch.int32) if a.dtype ==
                                torch.float32 else a,
                                b.view(torch.int32) if b.dtype ==
                                torch.float32 else b))
            or (not torch.is_tensor(a) and a == b)
            for a, b in zip(outs, wants))
        errs = [float((a - b).abs().max()) for a, b in zip(outs, wants)
                if torch.is_tensor(a) and a.dtype == torch.float32
                and a.numel()]
        active = args[0]
        hit = (got[3] if step == "shade_interp" else
               args[0] if step == "shade_lights" else args[1] & args[0])
        n, live, hits = active.numel(), int(active.sum()), int(hit.sum())
        refl = int(got_args[0].sum()) if step == "shade_combine" else 0
        r = dict(depth=j // len(steps), step=step, lanes=n, live=live,
                 hits=hits, reflecting=refl, equal=equal,
                 max_abs_err=max(errs, default=0.0),
                 **shade_bound(step, args, got or (), n, live, hits, refl))
        del got, want, got_args, want_args, outs, wants
        if step == "shade_combine":
            copies = [clone_args(args) for _ in range(24)]
            r.update(queued_once_ms([functools.partial(fn, *c, **kw)
                                     for c in copies]))
        else:
            m = int(min(8, max(2, -(-2 * L2_BYTES // max(r["bytes"], 1.0)))))
            copies = [clone_args(args) for _ in range(m)]
            r.update(queued_ms([functools.partial(fn, *c, **kw)
                                for c in copies]))
        del copies
        mine = clone_args(args)
        r["plain_ms"] = cuda_ms(lambda: plain(*mine, **kw), 5)
        del mine
        log(f"  kernel L vs plain ({label}, depth {r['depth']}, {step}):",
            json.dumps(r))
        rows.append(r)
    log(f"  kernel L ms per depth ({label}): " + "; ".join(
        f"d{d} " + ", ".join(
            f"{r['step'][6:]} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, "
            f"plain {r['plain_ms']:.3f})"
            for r in rows if r["depth"] == d)
        + f", live {rows[3 * d]['live'] / rows[3 * d]['lanes']:.1%}, hits "
          f"{rows[3 * d]['hits'] / rows[3 * d]['lanes']:.1%}"
        for d in range(depths)))
    bad = [(r["depth"], r["step"]) for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"kernel L differs from its plain version at "
                             f"{bad} ({label})")
    return rows


def raster_sample_shapes(rast, cam) -> dict:
    """Phase 28: record kernel I's 32 calls of one raster frame (8 samples
    x 4 rounds); each against raster_sample_round_plain on the same
    tensors, colour and depth floor bit for bit; ms a launch on a filled
    queue (`queued_ms`), round 0 (8 calls) and rounds 1-3 (24) apart, the
    plain version's ms a call on round 0 and round 1 of sample 0; the
    bound of each (bytes: every lane reads its slot and writes its floor,
    a hit reads u, v, mat, z and a 16-byte quad, an opaque hit writes 12
    bytes of colour; ~40 float operations a hit)."""
    with RecordingRaster("raster_sample_round") as rec:
        rast.render_async(cam)
        torch.cuda.synchronize()
    calls = rec.calls
    if len(calls) != 32:
        raise AssertionError(f"recorded {len(calls)} calls of kernel I in "
                             f"one frame, want 32")
    mismatched, rows = [], []
    for k, (tex, z, slot, u, v, mat, color) in enumerate(calls):
        got = rs.raster_sample_round(tex, z, slot, u, v, mat, color.clone())
        want = rs.raster_sample_round_plain(tex, z, slot, u, v, mat, color)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            mismatched.append(k)
        hit = int((slot >= 0).sum())
        opaque = int(((slot >= 0) & (want[1] == edge.ZFAR_PARK)).sum())
        rows.append(dict(lanes=slot.numel(), hit=hit, opaque=opaque,
                         **bound(8 * slot.numel() + 32 * hit + 12 * opaque,
                                 40 * hit)))
    torch.cuda.synchronize()

    def timed_rounds(rounds):
        picked = [calls[k] for k in range(32) if k % 4 in rounds]
        return queued_ms([functools.partial(rs.raster_sample_round, *c)
                          for c in picked], reps=2 * len(picked))

    r0, r13 = timed_rounds((0,)), timed_rounds((1, 2, 3))
    plain = [queued_ms([functools.partial(rs.raster_sample_round_plain,
                                          *calls[k])], reps=4)["ms"]
             for k in (0, 1)]
    b0 = add_bounds(rows[0::4])
    b13 = add_bounds([r for k, r in enumerate(rows) if k % 4])
    res = dict(mismatched=mismatched, ms_round0=r0["ms"],
               ms_rounds13=r13["ms"], enqueue_ms=r13["enqueue_ms"],
               ms_frame=8 * r0["ms"] + 24 * r13["ms"],
               plain_ms_round0=plain[0], plain_ms_round1=plain[1],
               bound_ms_round0=b0["bound_ms"] / 8,
               bound_ms_rounds13=b13["bound_ms"] / 24,
               bound_ms_frame=add_bounds(rows)["bound_ms"],
               bound_by=add_bounds(rows)["bound_by"],
               hit_each_round=[[r["hit"] for r in rows[4 * s:4 * s + 4]]
                               for s in range(8)],
               lanes=rows[0]["lanes"])
    log("  kernel I at the main path's shapes:", json.dumps(res))
    if mismatched:
        raise AssertionError(f"kernel I differs from its plain version on "
                             f"calls {mismatched}")
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


def config5_tfs(n: int) -> list:
    """The config-5 frames' instance transforms: a y-rotation of 0.01 rad
    more every frame."""
    return [rot_y(0.01 * k) for k in range(n)]


def config5_launches(mode: str) -> dict:
    """A config-5 frame's launches in a rebuild mode: the full rebuild
    runs kernel H once a level."""
    return {**CONFIG5_LAUNCHES, "H": SAH_ROUNDS * (mode == "full")}


def config5_modes(base: Renderer, cams) -> tuple:
    """Phase 16: config 5 at full width on the full scene, per rebuild
    mode: a warm-up frame + CONFIG5_FRAMES timed frames under the
    growing rotation (`config5_tfs`), then the accel update alone (CUDA
    events around Renderer.update_tree, mean of 5, and the host's time to
    enqueue one). `base` lends its scene, heap and host-built tree, and
    its path (eager: these frames are phase 26's references). Returns
    ({mode: results}, {mode: frames})."""
    cfg = C.config5_stress()
    tfs = config5_tfs(len(cams))
    res, frames = {}, {}
    for mode in REBUILD_MODES:
        r = copy.copy(base)
        r.cfg, r.rebuild = cfg, mode
        out, frames[mode] = drive(r, cams, config5_launches(mode),
                                  f"config 5, rebuild={mode}", tfs)
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
    return res, frames


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
        log(f"  64x48 depth-4 frame under rot_y(0.05), rebuild={mode} "
            f"({'graph' if sr.captured() else 'eager'}), vs "
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


def sah_cut_shapes(base: Renderer, dev) -> dict:
    """Phase 27: kernel H (device_sah.cut_round) vs its plain version
    `_cut_round` on the card, bit for bit: on `cut_case`'s probes, then on
    the cut rounds of one device-SAH build of the full scene (config 5's
    per-frame rebuild) made with the plain rounds, whose inputs are
    recorded, and whose order must equal the kernel's build's. Times at
    the build's shape on
    a filled queue (`queued_ms`; a round's inputs are the previous
    kernels' outputs, in L2 as there): H's ms per launch over the 14
    rounds, the plain version's per round over rounds 0, 4, 9 and 13, the
    host's enqueue ms of each; the bound of the
    work (the inputs read once, the output written once; ~20 float
    operations a chunk)."""
    mismatched = []
    for nc in CUT_SIZES:
        for kind in CUT_KINDS:
            args = [x.to(dev) for x in cut_case(nc, kind)]
            for fused in (False, True):
                if not torch.equal(device_sah.cut_round(*args, fused),
                                   device_sah._cut_round(*args, fused)):
                    mismatched.append((nc, kind, fused))
    geometry, _, _ = base.rebuild_inputs()
    kernel = device_sah.cut_round
    rounds = []

    def record(*args):            # the plain rounds' inputs, in order
        rounds.append([x.clone() if torch.is_tensor(x) else x
                       for x in args])
        return device_sah._cut_round(*args)

    try:
        device_sah.cut_round = record
        order_plain = device_sah_order(*geometry)
    finally:
        device_sah.cut_round = kernel
    same_order = bool(torch.equal(device_sah_order(*geometry), order_plain))
    for k, r in enumerate(rounds):
        if not torch.equal(kernel(*r), device_sah._cut_round(*r)):
            mismatched.append(("build round", k))
    nc = rounds[0][0].shape[0]
    h = queued_ms([functools.partial(kernel, *r) for r in rounds],
                  reps=2 * len(rounds))
    # the plain round enqueues ~500 PyTorch calls (~8 ms of host): four
    # rounds across the levels fit behind queued_ms's spin
    plain = queued_ms([functools.partial(device_sah._cut_round, *rounds[k])
                       for k in (0, 4, 9, 13)], reps=4)
    res = dict(chunks=nc, rounds=len(rounds), mismatched=mismatched,
               order_equal=same_order, ms=h["ms"],
               enqueue_ms=h["enqueue_ms"], plain_ms=plain["ms"],
               plain_enqueue_ms=plain["enqueue_ms"],
               **bound(30 * nc, 20 * nc))
    log("  kernel H vs plain:", json.dumps(res))
    if mismatched or not same_order or len(rounds) != SAH_ROUNDS:
        raise AssertionError(f"kernel H differs from _cut_round: {res}")
    return res


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


@contextlib.contextmanager
def measured(label: str, per_frame: dict, frames: int, graph: bool,
             captures: int = 1):
    """A run of `frames` frames of per_frame's launches, counted on the
    card (torch.profiler, graphs.kernel_launches: replays included) and
    on the host (every count set to 0 just before and read just after).
    Eager, both must be per_frame[k] a frame. On graphs, with `captures`
    of the frames captured in the run: the card runs per_frame[k] a frame
    and once more a capture (its warm-up), and the host counts
    per_frame[k] twice a capture (warm-up and capture) and nothing for a
    replay. Yields a dict that gets `card` and `host`."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    torch.cuda.synchronize()
    zero_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    on_card = graphs.kernel_launches(prof.key_averages())
    out.update(card={k: on_card[name] for k, name in ON_CARD.items()},
               host={k: f.launches for k, f in COUNTED.items()})
    card_frames = frames + captures if graph else frames
    host_frames = 2 * captures if graph else frames
    want = dict(card={k: per_frame.get(k, 0) * card_frames for k in ON_CARD},
                host={k: per_frame.get(k, 0) * host_frames for k in COUNTED})
    log(f"  {label} ({'graph' if graph else 'eager'}): launches on the "
        f"card {json.dumps(out['card'])}, on the host "
        f"{json.dumps({k: v for k, v in out['host'].items() if v})}")
    if out != want:
        raise AssertionError(f"{label}: expected launches {want}, got {out}")


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


def cli_steady(model, png: Path, event_ms: float, label: str) -> dict:
    """The CLI's pipelined CLI_STEADY_FRAMES-frame config-4 run (3 in
    flight), its last frame written to `png`: the steady wall ms a frame
    (retirements 5 to CLI_STEADY_FRAMES - 3) and Mrays/s."""
    argv = ["--config", "4", "--frames", str(CLI_STEADY_FRAMES), "--metrics",
            "--output", str(png)]
    rc, lines, errs, wall_s = run_cli(cli.main, argv, model)
    walls = frame_walls(errs)
    steady = walls[4:-3]
    rays = json.loads(lines[-1])["total_rays"] / len(walls)
    log(f"  {CLI_STEADY_FRAMES} frames ({label}): exit {rc}, {wall_s:.1f} s "
        f"with setup; FrameTimer {lines[-1]}; steady (retirements 5 to "
        f"{len(walls) - 3}): {np.mean(steady):.3f} ms a frame (wall), "
        f"{rays / np.mean(steady) / 1e3:.1f} Mrays/s; phase 7's CUDA-event "
        f"frame {event_ms:.3f} ms")
    if rc != 0 or len(walls) != CLI_STEADY_FRAMES:
        raise AssertionError(f"CLI steady fly-through ({label}) failed")
    return dict(steady_wall_ms=float(np.mean(steady)),
                mrays_per_s=rays / np.mean(steady) / 1e3, setup_s=wall_s)


def cli_rt(model, tmp: Path, event_ms: float, dev):
    """Phase 19: the CLI's pipelined fly-through at config 4, 1920x1080,
    on the card, on its default path (a CUDA graph a frame: the CLI has
    no flag for it). Returns the synchronous eager Renderer it was
    checked with and the steady run's numbers."""
    png, ckpt = tmp / "cli_rt.png", tmp / "cli_rt.json"
    argv = ["--config", "4", "--frames", str(CLI_FRAMES), "--metrics",
            "--output", str(png), "--checkpoint", str(ckpt)]
    with measured("CLI fly-through", CONFIG4_LAUNCHES, CLI_FRAMES,
                  graph=True):
        rc, lines, errs, wall_s = run_cli(cli.main, argv, model)
    summary = json.loads(lines[-1])
    cfg = C.config4_flythrough()
    cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                 CLI_FRAMES))
    sync = Renderer(model, cfg, dev, quantize=True, graph=False)
    want, rays = sync.render(cams[-1])
    got = read_png(png)
    _, ck_cam, ck_frame, _ = load_state(str(ckpt))
    diff = int((got != want).any(axis=-1).sum())
    log(f"  path: graph (the CLI's default); exit {rc}, {wall_s:.1f} s with "
        f"setup; FrameTimer (wall clock "
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
    steady = cli_steady(model, tmp / "cli_steady_graph.png", event_ms,
                        "graph")
    return sync, {**steady, "frame": read_png(tmp / "cli_steady_graph.png")}


def cli_raster(model, rast, tmp: Path) -> None:
    """Phase 19b: the CLI's raster path, one frame at 1600x1200, MSAA 8:
    equal to Rasterizer.render_async of the start camera outside the FPS
    text (its pixels change with the measured rate)."""
    png = tmp / "cli_raster.png"
    with measured("CLI raster", {"G": 32, "I": 32, "J": 1}, 1, graph=True):
        rc, _, _, wall_s = run_cli(cli.main, ["--raster", "--frames", "1",
                                              "--output", str(png)], model)
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
    read_counts("golden frame", CONFIG4_LAUNCHES)
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
    read_counts("harness", CONFIG4_LAUNCHES)
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
    read_counts("reference backend (plain PyTorch)",
                {"K": cfg.max_depth, **shade_launches(cfg.max_depth)})
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
    res, outs = drive(mr, cams[:3], {**CONFIG4_LAUNCHES, "K": 1},
                      "mip_lod")                 # depth 0 samples trilinear
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
                want=None, graph: bool = False) -> tuple:
    """Phases 23 and 26: `render(m)` for the camera matrices m of each of
    `mats`, the first as a warm-up (on graphs: the capture), the rest
    enqueued back to back: the host's enqueue ms of each call
    (perf_counter, no wait) and the device's ms between CUDA events
    recorded after each, which the host's pace bounds from below. The
    launch counts are zeroed before and read after: per_frame[k] times
    the number of frames eagerly, per_frame[k] twice (the warm-up and the
    capture) on graphs. Every (frame, ray grid) must torch.equal want's
    (unless None). Then each frame once more from an idle stream (the
    host's enqueue ms with the card's launch queue empty at the start: a
    queue held full stops the host at its depth) and two frames under
    torch.profiler (the device's busy ms a frame, alone, and each
    kernel's launches on the card: per_frame[k] a frame). Returns
    (results, outputs)."""
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
    launches = read_counts(label, {k: n * (2 if graph else len(mats))
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
    prof = profile_frames(lambda: render(mats[1]), label,
                          per_frame=per_frame)
    res = dict(frames=len(mats) - 1, path="graph" if graph else "eager",
               device_ms=float(np.mean([events[i].elapsed_time(
                   events[i + 1]) for i in range(len(mats) - 1)])),
               host_enqueue_ms=float(np.mean(host)),
               host_enqueue_ms_each=host,
               host_enqueue_ms_idle_stream=float(np.mean(idle)),
               device_busy_ms=prof["device_busy_ms_per_frame"],
               busy_share_profiled=prof["busy_share"],
               peak_mem_gb=peak, launches=launches,
               card_launches=prof["launches"], frames_equal=not differ)
    log(f"  {label}:", json.dumps(res))
    if differ:
        raise AssertionError(f"{label}: (frame, pixels, rays) that differ "
                             f"from the unsharded frames: {differ}")
    return res, outs


def sharded(model, sync, cams, event_ms: float, dev, tmp: Path) -> dict:
    """Phase 23: multi-device rendering (parallel/mesh.py) on logical
    shards of the one card. Config 4 at 1920x1080 through
    render_frame_sharded on make_mesh() and on [card] * k, eagerly
    (graph=False: phase 26 runs them as graphs), frames and ray grids
    bit-equal to render_frame's on the same cameras; the raster frame at
    1600x1200, MSAA 8, sharded, eagerly, bit-equal to
    render_raster_frame_edge's; the dry run and the CLI's --shard on
    their default path (graphs). Returns the results, with the cameras
    and the unsharded frames for phase 26."""
    cfg = sync.cfg
    mats = [(engine.upload_matrix(c.proj_inverse, dev),
             engine.upload_matrix(c.view_inverse, dev))
            for c in cams[:SHARD_FRAMES + 1]]
    one, frames4 = time_frames(
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
                                           replicas=reps, graph=False),
            mats, f"sharded, eager, {name} ({n} shards)",
            {key: c * n for key, c in CONFIG4_LAUNCHES.items()}, frames4)
        rows.append(dict(shards=n, **{key: res[key] for key in SHARD_KEYS}))
    log("  config 4, 1920x1080, ms per frame, eager (" +
        runtime.nvidia_smi_line()
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
    read_counts("raster unsharded", {"G": 32, "I": 32, "J": 1})
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
                                          mesh, msaa=8, graph=False)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        read_counts(f"raster, {k} shards",
                    {"G": 32 * k, "I": 32 * k, "J": 1})
        equal = torch.equal(got, want)
        raster[k] = dict(device_ms=start.elapsed_time(end),
                         host_enqueue_ms=host_ms, equal=equal)
        if not equal:
            raise AssertionError(
                f"raster, {k} shards: {int((got != want).any(dim=-1).sum())}"
                " pixels differ from the unsharded frame")
    del got
    log("  raster 1600x1200, msaa 8, one frame (start camera, eager):",
        json.dumps(raster))

    mesh = make_mesh([dev] * 4)
    with measured("raster, 4 shards, graph",
                  {"G": 32 * 4, "I": 32 * 4, "J": 1}, 1,
                  graph=True):
        got = render_raster_frame_sharded(tree, sync.tex, view, proj, rcfg,
                                          mesh, msaa=8,
                                          replicas=replicate(sync.tex, mesh))
    if not torch.equal(got, want):
        raise AssertionError("raster, 4 shards, graph: the frame differs "
                             "from the unsharded frame")
    del want, got
    t0 = time.perf_counter()
    dryrun_multichip(4, "cuda")
    log(f"  dry run on [card] * 4 (graphs but the reference backend and "
        f"recheck): {time.perf_counter() - t0:.1f} s")

    png = tmp / "cli_shard.png"
    argv = ["--config", "4", "--shard", "--frames", "2", "--output",
            str(png)]
    with measured("CLI --shard", CONFIG4_LAUNCHES, 2, graph=True):
        rc, _, errs, wall_s = run_cli(cli.main, argv, model)
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
    return dict(unsharded=one, sharded=rows, raster=raster, mats=mats,
                frames=frames4)


# --- phase 24: the secondary-dispatch options ---------------------------
SECONDARY_CASES = {          # the five RenderConfig options alone, then two
    "resort_secondary": dict(resort_secondary=True),        # combinations
    "recheck_secondary": dict(recheck_secondary=True),
    "partition_closest": dict(partition_closest=True),
    "sub_gate_closest": dict(sub_gate_closest=True),
    "sub_gate_shadows": dict(sub_gate_shadows=True),
    "resort+recheck+sub_gate": dict(resort_secondary=True,
                                    recheck_secondary=True,
                                    sub_gate_closest=True,
                                    sub_gate_shadows=True),
    "partition_closest+sub_gate": dict(partition_closest=True,
                                       sub_gate_closest=True,
                                       sub_gate_shadows=True),
}
MODE_ROWS = ("A.sub_gate", "A.recheck", "B.sub_gate", "B.recheck")


def frame_launches(cfg) -> dict:
    """Launches a frame of each counted kernel on the dense backend at
    `cfg`, by the engine's conditions: A and B once a depth; C, D at
    depth >= 1 with consolidate_secondary; E, F at depth >= 1 with
    partition_shadows (resort_secondary and recheck_secondary turn the
    three reorders off, group_sort_shadows launches none) and again with
    partition_closest (which yields to resort_secondary); the modes of A
    (recheck at depth >= 1) and B (every depth); K and L's three steps
    once a depth."""
    d = cfg.max_depth
    deeper = d - 1
    rs, rc = cfg.resort_secondary, cfg.recheck_secondary
    cons = cfg.consolidate_secondary and not (rs or rc)
    part = cfg.partition_shadows and not (rs or rc)
    pc = cfg.partition_closest and not rs
    return {"A": d, "B": d, "C": deeper * cons, "D": deeper * cons,
            "E": deeper * (part + pc), "F": deeper * (part + pc),
            "A.sub_gate": d * cfg.sub_gate_closest,
            "A.recheck": deeper * rc,
            "B.sub_gate": d * cfg.sub_gate_shadows, "B.recheck": d * rc,
            "K": d, **shade_launches(d)}


def closest_equal(tree, o, d, tmax, mode: str, label: str, block: int = 0):
    """Kernel A in `mode` vs the default kernel on the same rays: every
    output torch.equal. Returns the default's outputs."""
    kw = dict(block=block, point_origin=True) if block else {}
    want = trace_dense(tree, o, d, tmax, **kw)
    got = trace_dense(tree, o, d, tmax, **kw, **MODES[mode])
    names = ("t", "slot", "u", "v", "attrs")
    bad = [n for n, g, w in zip(names, got, want) if not torch.equal(g, w)]
    slots = int((got[1] != want[1]).sum().item())
    log(f"  kernel A {mode} vs default kernel ({label}): outputs that "
        f"differ {bad}, slots that differ {slots}")
    if bad:
        raise AssertionError(f"kernel A {mode} differs from the default "
                             f"kernel ({label}): {bad}, {slots} slots")
    return want


def occl_equal(tree, lp, sd, st, mode: str, label: str) -> None:
    """Kernel B in `mode` vs the default kernel: masks torch.equal."""
    want = occluded_multi(tree, lp, sd, st)
    got = occluded_multi(tree, lp, sd, st, **MODES[mode])
    n = int((got != want).sum().item())
    log(f"  kernel B {mode} vs default kernel ({label}): masks that "
        f"differ {n}")
    if n:
        raise AssertionError(f"kernel B {mode} differs from the default "
                             f"kernel ({label}): {n} masks")


def mode_probes(tree, o, d, tmax, lp, sd, st) -> dict:
    """Phase 24, kernels: each mode of A and B against the default kernel
    (equal) and against its plain version in the same mode (phase 3's and
    4's gates) on phase 3's and 4's probes, A's tie probe and B's edge
    groups. Returns each mode row's largest error."""
    errs = {}
    esd, est = edge_groups(tree, lp, sd, st)
    for m in MODES:
        closest_equal(tree, o, d, tmax, m, "probe rays")
        r = compare_closest(tree, o, d, tmax, f" ({m}, probe rays)", mode=m)
        errs[f"A.{m}"] = max(r["max_abs_err"],
                             closest_tie_probe(tree, o, d, tmax, f", {m}", m))
        occl_equal(tree, lp, sd, st, m, "phase 4's segments")
        occl_equal(tree, lp, esd, est, m, "edge groups")
        r = compare_occl(tree, lp, sd, st, label=f" ({m})", mode=m)
        errs[f"B.{m}"] = max(r["max_abs_err"],
                             occl_group_probe(tree, lp, sd, st, m))
    return errs


def mode_shapes(renderer: Renderer, cam: Camera, label: str,
                bounds=None) -> dict:
    """Phase 24, kernels at the main path's shapes: one config-4 frame's
    recorded inputs of A and B at every depth; per mode, equal to the
    default kernel, against its plain version, the kernel's ms (mean of
    5; under recheck the wrapper's ms less its prologue's, both by CUDA
    events), the default kernel's and the plain version's ms, and the
    bound (sub_gate: only the pairs whose sub-run box passes; recheck:
    the default's, taken from `bounds` {"A": rows, "B": rows} where phase
    9 computed them on the same frame's inputs)."""
    rec = RecordingBackend(renderer.backend)
    pi = torch.as_tensor(cam.proj_inverse, device=renderer.device)
    vi = torch.as_tensor(cam.view_inverse, device=renderer.device)
    render_frame_u8(rec, renderer.tex, pi, vi, renderer.lights, renderer.cfg)
    torch.cuda.synchronize()
    tree = renderer.backend.tree
    ntri, nsub = live_tris(tree.tri_data), sub_tris(tree.tri_data)
    rows = {k: [] for k in MODE_ROWS}
    for depth, (o, d, tm) in enumerate(rec.closest_in):
        where = f"{label}, depth {depth}"
        want = closest_equal(tree, o, d, tm, "sub_gate", where)
        closest_equal(tree, o, d, tm, "recheck", where)
        base_ms = cuda_ms(lambda: trace_dense(tree, o, d, tm), 5)
        for m, kw in MODES.items():
            r = compare_closest(tree, o, d, tm, f" ({m}, {where})", mode=m)
            r["ms"] = cuda_ms(lambda: trace_dense(tree, o, d, tm, **kw), 5)
            if m == "recheck":
                r["wrapper_ms"] = r["ms"]
                r["prologue_ms"] = cuda_ms(
                    lambda: closest_worklists(tree, o, d, tm), 5)
                r["ms"] = r["wrapper_ms"] - r["prologue_ms"]
            pk = plain_closest_mode(tree, o, d, tm, m)
            r["plain_ms"] = cuda_ms(
                lambda: trace_dense_plain(tree, o, d, tm, **pk), 1,
                warmup=False)
            r["default_ms"] = base_ms
            sub = m == "sub_gate"
            if bounds is not None and not sub:
                r.update({k: bounds["A"][depth][k]
                          for k in ("bound_ms", "bound_by", "bytes", "ops")})
            else:
                r.update(closest_bound(tree, o, d, tm, want[0],
                                       nsub if sub else ntri, sub))
            rows[f"A.{m}"].append(r)
    for depth, (lp, sd, st) in enumerate(rec.occl_in):
        where = f"{label}, depth {depth}"
        for m in MODES:
            occl_equal(tree, lp, sd, st, m, where)
        base_ms = cuda_ms(lambda: occluded_multi(tree, lp, sd, st), 5)
        for m, kw in MODES.items():
            r = compare_occl(tree, lp, sd, st, near=False,
                             label=f" ({m}, {where})", mode=m)
            r["ms"] = cuda_ms(lambda: occluded_multi(tree, lp, sd, st, **kw),
                              5)
            if m == "recheck":
                r["wrapper_ms"] = r["ms"]
                r["prologue_ms"] = cuda_ms(
                    lambda: multi_worklists(tree, lp, sd, st), 5)
                r["ms"] = r["wrapper_ms"] - r["prologue_ms"]
            pk = plain_occl_mode(tree, lp, sd, st, m)
            r["plain_ms"] = cuda_ms(
                lambda: occluded_multi_plain(tree, lp, sd, st, **pk), 1,
                warmup=False)
            r["default_ms"] = base_ms
            sub = m == "sub_gate"
            if bounds is not None and not sub:
                r.update({k: bounds["B"][depth][k]
                          for k in ("bound_ms", "bound_by", "bytes", "ops")})
            else:
                r.update(occl_bound(tree, lp, sd, st, nsub if sub else ntri,
                                    sub=sub))
            rows[f"B.{m}"].append(r)
    for k, rs in rows.items():
        log(f"  {k} per depth ({label}): " + "; ".join(
            f"d{dep} {r['ms']:.3f} ms (default {r['default_ms']:.3f}"
            + (f", prologue {r['prologue_ms']:.3f}" if "prologue_ms" in r
               else "")
            + f"), plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.3f} "
            f"({r['bound_by']}: {r['ops']:.4g} ops)"
            for dep, r in enumerate(rs)))
    return rows


def secondary_frames(renderer: Renderer, cams, cam: Camera, cfg, label: str,
                     transforms=None, transform=None,
                     profile: bool = True) -> dict:
    """Phase 24, frames: the defaults at `cfg`, then every case of
    SECONDARY_CASES, each through `drive` (launch counts by
    `frame_launches`; ms a frame by CUDA events, which the host paces
    when it enqueues slower than the card runs), then, with `profile`,
    `profile_frames` (the device's busy ms a frame and its time per
    engine range, which the host's pace does not move; ~3 s a case) or
    else `event_ranges` (the ranges by CUDA events); every case's frames
    and ray counts torch.equal to the defaults'. Returns {case: (ms a
    frame, device busy ms or None, ranges, launches a frame)}."""
    out = {}
    want = None
    for name, flags in {"defaults": {}, **SECONDARY_CASES}.items():
        r = copy.copy(renderer)
        r.cfg = dataclasses.replace(cfg, **flags)
        per_frame = frame_launches(r.cfg)
        res, outs = drive(r, cams, per_frame, f"{label}, {name}",
                          transforms)
        if want is None:
            want = outs
        else:
            same_frames(outs, want, f"{label}, {name}")
        tf = () if transform is None else (transform,)
        if profile:
            prof = profile_frames(lambda: r.render_async(cam, *tf),
                                  f"{label}, {name}")
            busy, ranges = prof["device_busy_ms_per_frame"], prof["range_ms"]
        else:
            busy = None
            ranges = {k: v for k, v in event_ranges(
                r, cam, f"{label}, {name}", transform)["range_ms"].items()
                if k.startswith(ENGINE_RANGES)}
        out[name] = dict(frame_ms=res["frame_ms"], busy_ms=busy,
                         range_ms=ranges,
                         launches={k: v for k, v in per_frame.items() if v},
                         run_launches=res["launches"])
    log(f"  {label}: ms a frame (CUDA events) " + json.dumps(
        {k: round(v["frame_ms"], 3) for k, v in out.items()}))
    if profile:
        log(f"  {label}: device busy ms a frame (profiler) " + json.dumps(
            {k: round(v["busy_ms"], 3) for k, v in out.items()}))
    return out


def secondary_options(renderer: Renderer, cams, cam: Camera, probes,
                      bounds=None) -> dict:
    """Phase 24 (see the module docstring). `probes`: phase 3's rays and
    phase 4's segments; `bounds`: phase 9's A and B rows at `cam`, if
    run. Config 4's cases are profiled, config 5's timed by CUDA events
    (the profiler costs ~3 s a case). Returns the mode rows, their
    largest errors, the frames' results and each mode's launches over
    the frame runs."""
    tree = renderer.backend.tree
    t0 = time.perf_counter()
    errs = mode_probes(tree, *probes)
    rows = mode_shapes(renderer, cam, "config 4", bounds)
    t1 = time.perf_counter()
    cfg5 = C.config5_stress()
    r5 = copy.copy(renderer)
    r5.rebuild = "refit"
    cams5 = cams[:CONFIG5_FRAMES + 1]
    frames = {
        "config 4": secondary_frames(renderer, cams, cam, renderer.cfg,
                                     "config 4"),
        "config 5 refit": secondary_frames(
            r5, cams5, cam, cfg5, "config 5 refit",
            [rot_y(0.01 * k) for k in range(len(cams5))], rot_y(0.02),
            profile=False)}
    launches = {k: sum(case["run_launches"][k] for f in frames.values()
                       for case in f.values()) for k in MODE_ROWS}
    log(f"  phase 24: kernels {t1 - t0:.1f} s, frames "
        f"{time.perf_counter() - t1:.1f} s; mode launches {launches}")
    return dict(rows=rows, errs=errs, frames=frames, launches=launches)


# --- phase 25: the JAX kernels' remaining modes --------------------------
P25_INTERVAL_STRIDE = 64   # depth >= 1: the interval pregate's plain
                           # version on every 64th 128-ray group
# where each mode sits in the TPU kernels (the kernels line's "replaces")
P25_REPLACES = {
    ("A", "stats"): "vkrt_tpu/rt/dense.py:247",
    ("A", "interval"): "vkrt_tpu/rt/dense.py:589",
    ("A", "group"): "vkrt_tpu/rt/dense.py:540",
    ("A", "no"): "vkrt_tpu/rt/dense.py:670",
    ("A", "ablate"): "vkrt_tpu/rt/dense.py:573",
    ("A'", "sub"): "vkrt_tpu/rt/dense.py:438",
    ("A'", "recheck"): "vkrt_tpu/rt/dense.py:674",
    ("A'", "interval"): "vkrt_tpu/rt/dense.py:589",
    ("A'", "stats"): "vkrt_tpu/rt/dense.py:247",
    ("A'", "ablate"): "vkrt_tpu/rt/dense.py:573",
    ("B", "visit"): "vkrt_tpu/rt/occl_multi.py:244",
    ("B", "interval"): "vkrt_tpu/rt/occl_multi.py:611",
    ("B", "group"): "vkrt_tpu/rt/occl_multi.py:55",
    ("B", "no"): "vkrt_tpu/rt/occl_multi.py:394",
    ("B", "ablate"): "vkrt_tpu/rt/occl_multi.py:297"}


def timed(fn):
    """(fn(), its ms by CUDA events): one call, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def p25_inputs(renderer: Renderer, cam: Camera) -> list:
    """One config-4 frame's recorded inputs per depth: kernel A's rays,
    kernel B's segments, and light 0's segments as kernel A''s
    point-origin call (one origin per engine block)."""
    rec = RecordingBackend(renderer.backend)
    pi = torch.as_tensor(cam.proj_inverse, device=renderer.device)
    vi = torch.as_tensor(cam.view_inverse, device=renderer.device)
    render_frame_u8(rec, renderer.tex, pi, vi, renderer.lights, renderer.cfg)
    torch.cuda.synchronize()
    out = []
    for (o, d, tm), (lp, sd, st), block in zip(rec.closest_in, rec.occl_in,
                                               rec.occl_block):
        n = st[0].numel()
        out.append({"A": (o, d, tm), "B": (lp, sd, st),
                    "A'": (light_points(lp, 0, n, block), sd[0].contiguous(),
                           st[0].contiguous()), "block": block})
    return out


def p25_block(kind: str, inp: dict) -> int:
    """The dispatch block of kernel `kind`'s phase-25 call: A' takes the
    block the engine passed B (its point origins'), A the wrapper's
    default (engine.BLOCK rays: its stats' unit)."""
    return inp["block"] if kind == "A'" else engine.BLOCK


def p25_call(kind: str, tree, args, block: int, kw: dict):
    """One wrapper call of kernel `kind` on `args` in the mode `kw`."""
    if kind == "A":
        return trace_dense(tree, *args, block=block, **kw)
    if kind == "A'":
        return trace_occluded(tree, *args, block=block, point_origin=True,
                              **kw)
    return occluded_multi(tree, *args, **kw)


def p25_rows(kind: str, args, rows: slice):
    """Kernel `kind`'s lane-major inputs (or outputs) cut to the 128-ray
    groups `rows` (A' with its origins broadcast to every ray)."""
    if kind == "B":
        lp, sd, st = args
        return lp, sd[:, :, rows].contiguous(), st[:, rows].contiguous()
    return tuple(x[..., rows, :].contiguous() for x in args)


def p25_plain(kind: str, tree, args, block: int, kw: dict,
              rows: slice = slice(None)):
    """The plain version of kernel `kind` in the mode `kw` on the 128-ray
    groups `rows`: the same lists as the wrapper's (closest_worklists /
    multi_worklists, made for every group and cut to `rows`: a group's
    list is its own) where a pregate asks for them; the visit order,
    group_gate, sort and stats change no plain output. A' returns its
    blocked mask."""
    pregate = "interval" if kw.get("pregate") == "interval" else (
        kw.get("pregate") or "")
    ablate = kw.get("ablate", "")
    sub = kw.get("sub_gate", False)
    lists = None
    if pregate:
        lists = (multi_worklists(tree, *args) if kind == "B" else
                 closest_worklists(tree, *args, block=block,
                                   point_origin=kind == "A'"))
        lists = type(lists)(*(None if x is None else x[rows].contiguous()
                              for x in lists))
    if kind == "A'":
        args = (broadcast_points(args[0], args[1], block),) + args[1:]
    args = p25_rows(kind, args, rows)
    if kind == "B":
        return occluded_multi_plain(tree, *args, sub_gate=sub, lists=lists,
                                    pregate=pregate or "recheck",
                                    ablate=ablate)
    maxc = tree.tri_data.shape[0]
    lkw = {}
    if pregate:
        lkw = (dict(bounds=listed_bounds(lists, maxc))
               if pregate == "interval"
               else dict(listed=listed_matrix(lists, maxc)))
    plain = trace_dense_plain if kind == "A" else trace_occluded_plain
    return plain(tree, *args, sub_gate=sub, ablate=ablate, **lkw)


def p25_expected(kind: str, default, kw: dict):
    """The outputs kernel `kind` must give in the mode `kw`: the default
    kernel's, or for an `ablate` cut those of a walk that commits nothing
    (A: every ray a miss; A': none blocked, coded; B: none blocked)."""
    if kw.get("ablate", "") not in CUTS:
        return default
    if kind == "B":
        return (torch.zeros_like(default[0]),)
    t, slot = default[0], default[1]
    miss = [torch.full_like(t, torch.inf), torch.full_like(slot, -1)]
    return tuple(miss + [torch.zeros_like(x) for x in default[2:4 + (
        kind == "A")]])


def p25_outputs(kind: str, out):
    """A mode call's outputs without stats: A (t, slot, u, v, attrs),
    A' (t, slot, u, v), B the mask."""
    if kind == "B":
        return (out,)
    return tuple(out[:5 if kind == "A" else 4])


def p25_plain_outputs(kind: str, plain):
    """The plain version's outputs as the kernel's (A' coded)."""
    if kind == "A":
        return tuple(plain)
    if kind == "B":
        return (plain,)
    zero = torch.zeros(plain.shape, device=plain.device)
    return (torch.where(plain, C.RAY_TMIN, torch.inf),
            torch.where(plain, 1, -1).to(torch.int32), zero, zero)


def p25_err(got, want) -> float:
    """The largest |difference| of the float outputs of two output tuples
    (elements equal, infinities too, count 0) plus the number of integer
    or boolean elements (slots, masks) that differ."""
    err, n = 0.0, 0
    for g, w in zip(got, want):
        if g.is_floating_point():
            d = torch.where(g == w, 0.0, (g - w).abs())
            err = max(err, d.max().item() if d.numel() else 0.0)
        else:
            n += int((g != w).sum().item())
    return err + n


def p25_check(kind: str, tree, args, block: int, kw: dict, out, default,
              base_plain, groups: slice, where: str):
    """One mode call's outputs `out` against the default kernel's (or, for
    an `ablate` cut, a walk that commits nothing) element by element, and
    the 128-ray groups `groups` of them against the plain version in the
    mode (`base_plain`, the default's plain outputs and ms, where the
    mode changes no plain output; `groups` is then every group). Raises on any difference; returns
    (max_abs_err, plain ms)."""
    got = p25_outputs(kind, out)
    want = p25_expected(kind, default, kw)
    if kw.get("sub_gate") or kw.get("pregate") or kw.get("ablate") in CUTS:
        plain, plain_ms = timed(
            lambda: p25_plain(kind, tree, args, block, kw, groups))
    else:
        plain, plain_ms = base_plain
    plain = p25_plain_outputs(kind, plain)
    cut = p25_rows(kind, got, groups) if kind != "B" else tuple(
        x[:, groups] for x in got)
    bad = [i for i, (g, w, p) in enumerate(zip(got, want, plain))
           if not (torch.equal(g, w) and torch.equal(cut[i], p))]
    err = max(p25_err(got, want), p25_err(cut, plain))
    if bad or len(got) != len(want):
        raise AssertionError(f"phase 25: {where}: outputs {bad} differ from "
                             f"the default kernel's or the plain version's "
                             f"({err})")
    return err, plain_ms


def p25_stats(tree, kind, args, block, out, kw) -> dict:
    """A's or A''s stats against the plain version: lane 0 equal to the
    JAX work-list length (`stats_lane0_of` without the kernel's bits),
    lane 1 within `sweep_bounds` (lo: the clusters some ray of a group
    enters at or before its final far bound; hi: those the group gates
    at tmax). Returns their means per dispatch block."""
    o, d, tm = args
    st = out[-1]
    point = kind == "A'"
    lane0 = stats_lane0_of(tree, o, d, tm, block=block, point_origin=point,
                           pregate="", ablate="")
    full = broadcast_points(o, d, block) if point else o
    blocked = out[1] >= 0
    far = (torch.where(blocked, 0.0, tm) if point
           else torch.where(blocked, out[0], tm))
    n = tm.numel()
    lo, hi = sweep_bounds(tree, full.reshape(3, n), d.reshape(3, n),
                          tm.reshape(n), far.reshape(n), block)
    res = dict(lane0_mean=st[:, 0].float().mean().item(),
               lane1_mean=st[:, 1].float().mean().item(),
               lo_mean=lo.float().mean().item(),
               hi_mean=hi.float().mean().item(),
               lane0_equal=bool(torch.equal(st[:, 0], lane0)),
               lane1_in_bounds=bool(((lo <= st[:, 1]) & (st[:, 1] <= hi))
                                    .all()))
    if not (res["lane0_equal"] and res["lane1_in_bounds"]):
        raise AssertionError(f"kernel {kind} stats vs plain: {res}")
    return res


def closest_stats_frame(renderer: Renderer) -> dict:
    """trace_closest_stats (the reference backend's walk) on phase 21's
    frame (320x240 reference_config() from the start pose), in chunks of
    REF_CHUNK rays: the lock-step iterations of each chunk."""
    cfg = dataclasses.replace(C.reference_config(), width=REF_SIZE[0],
                              height=REF_SIZE[1])
    cam = start_camera(cfg.width, cfg.height)
    dev = renderer.device
    ref = engine.make_backend(renderer.flat, "reference", dev)
    opt, d, valid = camera_ray_blocks(
        torch.as_tensor(cam.proj_inverse, device=dev),
        torch.as_tensor(cam.view_inverse, device=dev), cfg)
    d = L.from_cvec(d).contiguous()
    tmax = torch.where(valid.reshape(-1), C.RAY_TMAX, 0.0)
    iters = []
    for r0 in range(0, d.shape[0], REF_CHUNK):
        dc = d[r0:r0 + REF_CHUNK]
        oc = opt[None, :].expand(dc.shape[0], 3).contiguous()
        iters.append(int(traverse.trace_closest_stats(
            ref.bvh, oc, dc, C.RAY_TMIN, tmax[r0:r0 + REF_CHUNK])[4]))
    return dict(chunks=len(iters), rays_per_chunk=REF_CHUNK,
                mean_iterations=float(np.mean(iters)),
                max_iterations=max(iters))


def build_in_cache_dir(tree, args) -> dict:
    """The kernels built once into a temporary directory named by the
    build-root variable (utils/cache.py), kernel A launched from that
    library on `args` (equal to the default library's outputs), then the
    default root restored."""
    want = trace_dense(tree, *args)
    old = os.environ.get(CACHE_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[CACHE_ENV] = tmp
        kernels.library.cache_clear()
        try:
            info = kernels.build()
            got = trace_dense(tree, *args)
            torch.cuda.synchronize()
        finally:
            if old is None:
                os.environ.pop(CACHE_ENV)
            else:
                os.environ[CACHE_ENV] = old
            kernels.library.cache_clear()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        res = dict(path_in_dir=info.path.is_relative_to(tmp),
                   cached=info.cached, seconds=info.seconds, equal=equal)
    log("  kernels built under $VKRT_TORCH_CACHE (a temporary directory):",
        json.dumps(res))
    if not (res["path_in_dir"] and not res["cached"] and equal):
        raise AssertionError(f"build under {CACHE_ENV} failed: {res}")
    return res


def item15_modes(renderer: Renderer, cam: Camera, bounds) -> dict:
    """Phase 25 (see the module docstring): every mode of P25 launched
    once a depth on one config-4 frame's inputs (those launches alone
    counted), each held element by element against the default kernel
    and against its plain version; ms of each (mean of 5; the pregates
    less their prologue's), the ablate split, the stats, then
    trace_closest_stats and the build under the cache variable.
    `bounds`: phase 9's A and B rows at `cam`."""
    tree = renderer.backend.tree
    ntri = live_tris(tree.tri_data)
    inputs = p25_inputs(renderer, cam)
    zero_counts()
    outs = {}
    for depth, inp in enumerate(inputs):
        for kind, modes in P25.items():
            for m, kw in modes.items():
                outs[kind, m, depth] = p25_call(kind, tree, inp[kind],
                                                p25_block(kind, inp), kw)
    torch.cuda.synchronize()
    launches = {k: COUNTED[k].launches for k in P25_ROWS}
    log("  phase 25 launches (one a mode a depth):", json.dumps(launches))
    if any(v != len(inputs) for v in launches.values()):
        raise AssertionError(f"phase 25 launches {launches}")
    rows = {k: [] for k in P25_ROWS}
    pairs = {f"{k}.{m}": [] for k, ms in P25_PAIRS.items() for m in ms}
    stats = {}
    for depth, inp in enumerate(inputs):
        for kind, modes in P25.items():
            args, block = inp[kind], p25_block(kind, inp)
            default = p25_outputs(kind, p25_call(kind, tree, args, block, {}))
            full_ms = cuda_ms(lambda: p25_call(kind, tree, args, block, {}),
                              5)
            base_plain, base_plain_ms = timed(
                lambda: p25_plain(kind, tree, args, block, {}))
            if kind == "A'":
                bnd = occl_bound(tree, inp["B"][0][:1], inp["B"][1][:1],
                                 inp["B"][2][:1], ntri, out_bytes=16)
            else:
                bnd = bounds[kind][depth]
            for m, kw in modes.items():
                out = outs[kind, m, depth]
                # the interval pregate past depth 0: a scattered group's
                # interval lists nearly every cluster, and its plain
                # version tests every listed pair (78 s for A at depth 1
                # on the H100), so it runs on every P25_INTERVAL_STRIDE-th
                # group, against those groups of the kernel's outputs
                groups = slice(None, None, P25_INTERVAL_STRIDE if (
                    depth and kw.get("pregate") == "interval") else 1)
                err, plain_ms = p25_check(
                    kind, tree, args, block, kw, out, default,
                    (base_plain, base_plain_ms), groups,
                    f"{kind} {m}, depth {depth}")
                if kw.get("stats"):
                    stats[kind, depth] = p25_stats(tree, kind, args, block,
                                                   out, kw)
                ms = cuda_ms(lambda: p25_call(kind, tree, args, block, kw), 5)
                if kw.get("pregate"):
                    lists = (multi_worklists if kind == "B" else
                             lambda t, *a: closest_worklists(
                                 t, *a, block=block,
                                 point_origin=kind == "A'"))
                    ms -= cuda_ms(lambda: lists(tree, *args), 5)
                cuts = kw.get("ablate") in CUTS
                r = dict(ms=ms, default_ms=full_ms, plain_ms=plain_ms,
                         plain_groups_step=groups.step, max_abs_err=err,
                         **bound(bnd["bytes"], 0 if cuts else bnd["ops"]))
                rows[f"{kind}.{m}"].append(r)
            for m, (row, kw) in P25_PAIRS.get(kind, {}).items():
                # not counted: compared with the default kernel, and with
                # the plain version on every P25_INTERVAL_STRIDE-th group
                groups = slice(None, None, P25_INTERVAL_STRIDE)
                err, _ = p25_check(
                    kind, tree, args, block, kw,
                    p25_call(kind, tree, args, block, kw), default,
                    (base_plain, base_plain_ms), groups,
                    f"{kind} {m}, depth {depth}")
                pairs[f"{kind}.{m}"].append(err)
                rows[f"{kind}.{row}"][-1]["max_abs_err"] = max(
                    rows[f"{kind}.{row}"][-1]["max_abs_err"], err)
    log("  phase 25 pairs of modes (max_abs_err per depth):",
        json.dumps(pairs))
    for kind in ("A", "B"):
        for depth in range(len(inputs)):
            cells = [f"full {rows[f'{kind}.no_sort'][depth]['default_ms']:.3f}"]
            cells += [f"{a} {rows[f'{kind}.ablate_{a}'][depth]['ms']:.3f}"
                      for a in ABLATES[1:]]
            log(f"  phase decomposition, kernel {kind}, depth {depth} (ms, "
                f"CUDA events, mean of 5): " + " | ".join(cells))
    for (kind, depth), r in stats.items():
        log(f"  stats, kernel {kind}, depth {depth}, per block of "
            f"{p25_block(kind, inputs[depth])} rays:", json.dumps(r))
    for k, rs in rows.items():
        log(f"  {k} per depth: " + "; ".join(
            f"d{d} {r['ms']:.3f} ms (default {r['default_ms']:.3f}), plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.3f} "
            f"({r['bound_by']})" for d, r in enumerate(rs)))
    ref = closest_stats_frame(renderer)
    log("  trace_closest_stats on phase 21's frame:", json.dumps(ref))
    build_in_cache_dir(tree, inputs[0]["A"])
    return dict(rows=rows, launches=launches, stats=stats, ref=ref)


# --- phase 26: the frames as CUDA graphs ---------------------------------
GRAPH_KEYS = ("device_ms", "host_enqueue_ms", "busy_share", "device_busy_ms",
              "peak_mem_gb", "capture_ms")


def graph_row(res: dict, prof: dict, frame_graphs=None) -> dict:
    """One side of phase 26's table: device ms a frame (CUDA events back
    to back), host enqueue ms a frame, the profiled busy share and busy
    ms, peak memory and, for the graph side, the capture ms (warm-up and
    capture of every graph held) and the memory the card holds reserved."""
    row = dict(device_ms=res.get("frame_ms", res.get("device_ms")),
               host_enqueue_ms=res["host_enqueue_ms"],
               busy_share=prof.get("busy_share", prof.get("busy_share_profiled")),
               device_busy_ms=prof.get("device_busy_ms_per_frame",
                                       prof.get("device_busy_ms")),
               peak_mem_gb=res["peak_mem_gb"])
    if frame_graphs is not None:
        row.update(capture_ms=sum(frame_graphs.capture_ms().values()),
                   graphs=len(frame_graphs),
                   reserved_gb=torch.cuda.memory_reserved() / 2 ** 30)
    return row


def same_raster(outs, want, label: str) -> None:
    """Raster frames torch.equal, camera by camera."""
    differ = [i for i, (a, b) in enumerate(zip(outs, want))
              if not torch.equal(a, b)]
    log(f"  {label}: frames that differ from the eager frames {differ}")
    if differ or len(outs) != len(want):
        raise AssertionError(f"{label}: frames {differ} differ")


def graph_frames(model, sync, rast, cams, rcams, ref: dict, dev,
                 tmp: Path) -> dict:
    """Phase 26: the frames of phases 7, 16, 12, 23 and 19 on the default
    path, a CUDA graph per static key replayed a frame (graphs.py), side
    by side with the eager runs of those phases (`ref`): config 4 (1 +
    N_FRAMES poses), config 5 in each rebuild mode under the growing
    rotation, the raster frame (1600x1200, MSAA 8), render_frame_sharded
    on [card] * k, then the CLI's 40-frame run eagerly beside phase 19's
    (graphs). Every frame and ray count torch.equal to the eager one of
    the same camera, the launches a frame as those phases gate them
    (`drive`, `time_frames`: on the card by torch.profiler, replays
    included; on the host the captures alone), device ms, host enqueue
    ms, the profiled busy share (replays show no ranges), capture ms and
    peak memory; each renderer's graphs are freed after its part. Returns
    the table and the launches on the card of the config-4, config-5
    full-rebuild and raster runs (the default path of phases 7, 16 and 12:
    the kernels' line)."""
    rows = {}
    cam = start_camera(sync.cfg.width, sync.cfg.height)
    g = graphed(sync)
    res, outs = drive(g, cams, CONFIG4_LAUNCHES, "graph: config 4")
    launches = dict(config4=res["launches"])
    same_frames(outs, ref["config4_outs"], "graph: config 4")
    prof = profile_frames(lambda: g.render_async(cam), "graph: config 4")
    rows["config 4"] = dict(eager=graph_row(ref["config4"],
                                            ref["config4_prof"]),
                            graph=graph_row(res, prof, g.graphs))
    g.free_graphs()
    del outs
    c5cams = cams[:CONFIG5_FRAMES + 1]
    for mode in REBUILD_MODES:
        g = graphed(sync)
        g.cfg, g.rebuild = C.config5_stress(), mode
        res, outs = drive(g, c5cams, config5_launches(mode),
                          f"graph: config 5, rebuild={mode}",
                          config5_tfs(len(c5cams)))
        if mode == "full":
            launches.update(config5_full=res["launches"])
        same_frames(outs, ref["config5_outs"][mode],
                    f"graph: config 5, {mode}")
        prof = profile_frames(lambda: g.render_async(cam),
                              f"graph: config 5, {mode}")
        rows[f"config 5 {mode}"] = dict(
            eager=graph_row(ref["config5"][mode], ref["config5_prof"][mode]),
            graph=graph_row(res, prof, g.graphs))
        g.free_graphs()
        del outs
    g = graphed(rast)
    res, outs = drive_raster(g, rcams)
    launches.update(raster=res["launches"])
    same_raster(outs, ref["raster_outs"], "graph: raster")
    prof = profile_frames(lambda: g.render_async(rcams[0]), "graph: raster",
                          RASTER_RANGES)
    rows["raster"] = dict(eager=graph_row(ref["raster"], ref["raster_prof"]),
                          graph=graph_row(res, prof, g.graphs))
    g.free_graphs()
    del outs, g
    sh = ref["sharded"]
    shard_rows = []
    for k, eager_row in zip((1,) + SHARDS, sh["sharded"]):
        mesh = make_mesh([dev] * k)
        reps = replicate((sync.backend, sync.tex, sync.lights), mesh)
        res, _ = time_frames(
            lambda m: render_frame_sharded(sync.backend, sync.tex, *m,
                                           sync.lights, sync.cfg, mesh,
                                           replicas=reps),
            sh["mats"], f"sharded, graph, [card] * {k} ({k} shards)",
            {key: c * k for key, c in CONFIG4_LAUNCHES.items()},
            sh["frames"], graph=True)
        shard_rows.append(dict(shards=k, **{key: res[key]
                                            for key in SHARD_KEYS},
                               capture_ms=sum(reps.graphs.capture_ms()
                                              .values())))
        rows[f"sharded k={k}"] = dict(eager=graph_row(eager_row, eager_row),
                                      graph=graph_row(res, res, reps.graphs))
        del reps
    log("  config 4, 1920x1080, ms per frame, graphs (" +
        runtime.nvidia_smi_line() + "): sharded " + json.dumps(shard_rows))
    with eager_cli():
        cli_eager = cli_steady(model, tmp / "cli_steady_eager.png",
                               ref["config4"]["frame_ms"], "eager")
    same = bool(np.array_equal(read_png(tmp / "cli_steady_eager.png"),
                               ref["cli"]["frame"]))
    rows["CLI 40 frames"] = {
        "eager": {k: v for k, v in cli_eager.items()},
        "graph": {k: v for k, v in ref["cli"].items() if k != "frame"},
        "last_frames_equal": same}
    if not same:
        raise AssertionError("CLI: the eager run's last frame differs from "
                             "the graph run's")
    log(f"  graph vs eager, a frame ({runtime.nvidia_smi_line()}):")
    for name, row in rows.items():
        log(f"    {name}: {json.dumps(row)}")
    return rows, launches


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
    # eager (graph=False), and so every copy of it: phases 7, 9, 14, 16-18,
    # 24 and 25 record kernel inputs or time ranges; phase 26 replays the
    # same frames as graphs (graphed() copies it onto the default path)
    renderer = Renderer(model, cfg, dev, quantize=True, graph=False)
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
    log("== 7. main path: config 4 at the shipped defaults (eager)")
    res_main, outs = drive(renderer, cams, CONFIG4_LAUNCHES,
                           "main path (defaults)")

    log("== 8. config 4 with the reorder flags off, same cameras (graphs)")
    off = graphed(renderer)
    off.cfg = dataclasses.replace(cfg, **REORDER_OFF)
    res_off, outs_off = drive(off, cams,
                              dict(A=2, B=2, K=2, **shade_launches(2)),
                              "flags off")
    same_frames(outs_off, outs)
    off.free_graphs()
    off.graph = False            # the profile below reads per-range tables
    first_outs = outs[:PER_LIGHT_FRAMES + 1]
    del outs_off
    log(f"  ms/frame: defaults {res_main['frame_ms']:.3f}, flags off "
        f"{res_off['frame_ms']:.3f}")

    log("== 9. kernels vs plain at the main path's shapes")
    cam = start_camera(cfg.width, cfg.height)
    res_9 = main_path_shapes(renderer, cam)

    log(f"== profile: {PROFILE_FRAMES} main-path frames, then "
        f"{PROFILE_FRAMES} flags-off frames")
    prof_main = profile_frames(lambda: renderer.render_async(cam),
                               "defaults")
    profile_frames(lambda: off.render_async(cam), "flags off")

    log("== 14. kernel A' vs plain on probes")
    probe_err["A'"], err_a = probe_occluded(renderer.backend, o, d, tmax, lp,
                                            sd, st)
    probe_err["A"] = max(probe_err["A"], err_a)

    log("== 15. config 4 with the per-light shadow dispatch (kernel A'), "
        "as CUDA graphs")
    pl = graphed(renderer)
    pl.backend = renderer.backend._replace(per_light=True)
    pl_cams = cams[:PER_LIGHT_FRAMES + 1]
    res_pl, outs_pl = drive(pl, pl_cams, {"A": 2, "A'": 8, "C": 1, "D": 1,
                                          "E": 1, "F": 1, "K": 2,
                                          **shade_launches(2)},
                            "per-light main path")
    same_frames(outs_pl, first_outs, "per-light")
    pl.free_graphs()
    del outs_pl, first_outs, pl
    log(f"  ms/frame: per light {res_pl['frame_ms']:.3f}, defaults "
        f"{res_main['frame_ms']:.3f}")
    res_15 = per_light_shapes(renderer, cam)
    log("  A' per frame: "
        f"{sum(r['ms'] for r in res_15):.3f} ms in "
        f"{sum(r['launches'] for r in res_15)} launches vs B "
        f"{sum(r['b_ms'] for r in res_15):.3f} ms in {len(res_15)}")

    log("== 16. config 5 at 1920x1080: refit, full (device SAH), full_morton")
    res_16, frames_16 = config5_modes(renderer, cams[:CONFIG5_FRAMES + 1])
    log(f"== profile: {PROFILE_FRAMES} config-5 frames per rebuild mode")
    r5s, prof_16 = {}, {}
    for mode in REBUILD_MODES:
        r5s[mode] = r5 = copy.copy(renderer)
        r5.cfg, r5.rebuild = C.config5_stress(), mode
        prof_16[mode] = profile_frames(lambda: r5.render_async(cam),
                                       f"config 5, {mode}", CONFIG5_RANGES)
        event_ranges(r5, cam, f"config 5, {mode}", rot_y(0.02))

    log("== 17. config-5 gates")
    config5_gates(renderer, cam, dev)

    log("== 27. kernel H vs plain: cut-round probes and a full-scene build")
    res_27 = sah_cut_shapes(renderer, dev)

    log("== 18. kernels vs plain at the config-5 path's shapes")
    res_18 = {}
    for mode, r5 in r5s.items():
        res_18[mode] = main_path_shapes(r5, cam, rot_y(0.02),
                                        f"config 5, {mode}")
        log(f"  config 5, {mode}: kernel ms per frame by depth: " + json.dumps(
            {k: [round(r["ms"], 3) for r in rows]
             for k, rows in res_18[mode].items()}))

    log("== 30. kernel K at the main path's shapes: config 4, config 5 full")
    res_30 = {"config4": sample_hits_shapes(renderer, cam),
              "config5_full": sample_hits_shapes(r5s["full"], cam,
                                                 rot_y(0.02),
                                                 "config 5, full")}

    log("== 31. kernel L at the main path's shapes: config 4, config 5 full")
    res_31 = {"config4": shade_hits_shapes(renderer, cam),
              "config5_full": shade_hits_shapes(r5s["full"], cam,
                                                rot_y(0.02),
                                                "config 5, full")}
    del r5, r5s

    log("== 24. the secondary-dispatch options: kernel modes, then config 4 "
        "and config 5 (refit) with each option")
    t_new = time.perf_counter()
    res_24 = secondary_options(renderer, cams, cam, (o, d, tmax, lp, sd, st),
                               res_9)
    log(f"  phase 24: {time.perf_counter() - t_new:.1f} s")

    log("== 25. the JAX kernels' remaining modes: stats, ablate, interval, "
        "group_gate / sort, visit, kernel A''s modes")
    t_new = time.perf_counter()
    res_25 = item15_modes(renderer, cam, res_9)
    log(f"  phase 25: {time.perf_counter() - t_new:.1f} s")

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
    rast = rp.Rasterizer(model, rcfg, dev, msaa=8, graph=False)
    log(f"  setup {time.perf_counter() - t0:.1f} s")
    rcams = list(itertools.islice(camera_path(rcfg.width, rcfg.height),
                                  RASTER_FRAMES + 1))
    res_raster, raster_outs = drive_raster(rast, rcams)
    wavefront_vs_edge(rast, rcams[0], raster_outs[0])
    wall_pose_frame(rast)
    log(f"== profile: {PROFILE_FRAMES} raster frames")
    prof_raster = profile_frames(lambda: rast.render_async(rcams[0]),
                                 "raster", RASTER_RANGES)

    log("== 13. kernel G at the main path's shapes")
    res_13 = raster_shapes(rast, rcams[0])
    log("== 28. kernel I at the main path's shapes")
    res_28 = raster_sample_shapes(rast, rcams[0])
    log("== 29. kernel J at the main path's shapes")
    res_29 = clip_shapes(rast, rcams[0])

    t_new = time.perf_counter()
    out_dir = build_root() / "smoke"      # gitignored by default, in the checkout
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        log(f"== 19. CLI: config 4 fly-through, {CLI_FRAMES} frames at "
            "1920x1080, 3 in flight")
        sync, cli_graph = cli_rt(model, Path(tmp), res_main["frame_ms"],
                                 dev)
        log("== 19b. CLI: raster, one frame at 1600x1200, msaa 8")
        cli_raster(model, rast, Path(tmp))
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
        res_23 = sharded(model, sync, cams, res_main["frame_ms"], dev,
                         Path(tmp))
    log(f"  phase 23: {time.perf_counter() - t_new:.1f} s")
    log("== 26. graphs: configs 4 and 5, the raster frame, sharded frames "
        "and the CLI, each as a CUDA graph a frame, beside the eager runs")
    t_new = time.perf_counter()
    ref = dict(config4=res_main, config4_outs=outs, config4_prof=prof_main,
               config5=res_16, config5_outs=frames_16, config5_prof=prof_16,
               raster=res_raster, raster_outs=raster_outs,
               raster_prof=prof_raster, sharded=res_23, cli=cli_graph)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        _, main_launches = graph_frames(model, sync, rast, cams, rcams, ref,
                                        dev, Path(tmp))
    del sync, rast, ref, outs, frames_16, raster_outs, res_23
    log(f"  phase 26: {time.perf_counter() - t_new:.1f} s")

    def entry(name, k, src, replaces):
        rows = res_9[k]
        lib_ms = [r.get("library_ms") for r in rows]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": main_launches["config4"][k],
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
         "launches": main_launches["raster"]["G"],
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
    def mode_entry(k, name, src, replaces):
        rows = res_24["rows"][k]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": res_24["launches"][k],
                "max_abs_err": max([res_24["errs"][k]]
                                   + [r["max_abs_err"] for r in rows]),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                **{key: add_bounds(rows)[key]
                   for key in ("bound_ms", "bound_by")},
                "library_ms": None}

    def p25_entry(key):
        kind, mode = key.split(".", 1)
        rows = res_25["rows"][key]
        name = {"A": "trace_closest", "A'": "trace_occluded",
                "B": "occl_multi"}[kind]
        return {"name": f"{name}.{mode}", "route": "cuda",
                "source": {"A": "vkrt_tpu_torch/csrc/trace_closest.cu",
                           "A'": "vkrt_tpu_torch/csrc/trace_occluded.cu",
                           "B": "vkrt_tpu_torch/csrc/occl_multi.cu"}[kind],
                "replaces": P25_REPLACES[kind, mode.split("_")[0]],
                "launches": res_25["launches"][key],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                **{k: add_bounds(rows)[k] for k in ("bound_ms", "bound_by")},
                "library_ms": None}

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
        mode_entry("A.sub_gate", "trace_closest.sub_gate",
                   "vkrt_tpu_torch/csrc/trace_closest.cu",
                   "vkrt_tpu/rt/dense.py:438"),
        mode_entry("A.recheck", "trace_closest.recheck",
                   "vkrt_tpu_torch/csrc/trace_closest.cu",
                   "vkrt_tpu/rt/dense.py:674"),
        mode_entry("B.sub_gate", "occl_multi.sub_gate",
                   "vkrt_tpu_torch/csrc/occl_multi.cu",
                   "vkrt_tpu/rt/occl_multi.py:157"),
        mode_entry("B.recheck", "occl_multi.recheck",
                   "vkrt_tpu_torch/csrc/occl_multi.cu",
                   "vkrt_tpu/rt/occl_multi.py:404"),
        *[p25_entry(k) for k in P25_ROWS],
        {"name": "sah_cut", "route": "cuda",
         "source": "vkrt_tpu_torch/csrc/sah_cut.cu",
         "replaces": "none: vkrt_tpu/accel/device_sah.py's cut rounds "
                     "(:387) are XLA",
         "launches": main_launches["config5_full"]["H"],
         "max_abs_err": len(res_27["mismatched"]),
         "ms": res_27["ms"] * SAH_ROUNDS,
         "ms_per_launch": res_27["ms"],
         "plain_ms": res_27["plain_ms"] * SAH_ROUNDS,
         "bound_ms": res_27["bound_ms"] * SAH_ROUNDS,
         "bound_by": res_27["bound_by"], "library_ms": None,
         "design": "one block: segmented box scans by warp shuffles, tiles "
                   "of 1024 chunks"},
        {"name": "raster_sample", "route": "cuda",
         "source": "vkrt_tpu_torch/csrc/raster_sample.cu",
         "replaces": "none: vkrt_tpu/raster/pipeline.py's discard rounds "
                     "sample in XLA",
         "launches": main_launches["raster"]["I"],
         "max_abs_err": len(res_28["mismatched"]),
         "ms": res_28["ms_frame"], "ms_round0": res_28["ms_round0"],
         "ms_rounds13": res_28["ms_rounds13"],
         "plain_ms": 8 * res_28["plain_ms_round0"]
         + 24 * res_28["plain_ms_round1"],
         "bound_ms": res_28["bound_ms_frame"],
         "bound_by": res_28["bound_by"], "library_ms": None,
         "design": "one thread a lane; a hit reads the base map's 16-byte "
                   "quad alone"},
        {"name": "raster_clip", "route": "cuda",
         "source": "vkrt_tpu_torch/csrc/raster_clip.cu",
         "replaces": "none: vkrt_tpu/raster/edge.py gives such clusters "
                     "full-screen boxes",
         "launches": main_launches["raster"]["J"],
         "max_abs_err": 0.0, "ms": res_29["scene"]["ms"],
         "ms_soup": res_29["soup"]["ms"],
         "plain_ms": res_29["scene"]["plain_ms"],
         "bound_ms": res_29["scene"]["bound_ms"],
         "bound_by": res_29["scene"]["bound_by"], "library_ms": None,
         "design": "one thread a triangle slot, float64 Sutherland-Hodgman; "
                   "a slot not crossing w = 0 writes the empty box"},
        {"name": "sample_hits", "route": "cuda",
         "source": "vkrt_tpu_torch/csrc/sample_hits.cu",
         "replaces": "none: vkrt_tpu/shade/sampling.py's sample_material "
                     "(:24) is XLA",
         "launches": main_launches["config4"]["K"],
         "max_abs_err": max(r["max_abs_err"] for rows in res_30.values()
                            for r in rows),
         "ms": sum(r["ms"] for r in res_30["config4"]),
         "ms_config5_full": sum(r["ms"] for r in res_30["config5_full"]),
         "plain_ms": sum(r["plain_ms"] for r in res_30["config4"]),
         **{k: add_bounds(res_30["config4"])[k]
            for k in ("bound_ms", "bound_by")},
         "bound_ms_config5_full": add_bounds(
             res_30["config5_full"])["bound_ms"],
         "library_ms": None,
         "design": "one thread a lane; a hit reads its 48-byte heap row as "
                   "three 16-byte loads, a miss writes zeros"},
        {"name": "shade_hits", "route": "cuda",
         "source": "vkrt_tpu_torch/csrc/shade_hits.cu",
         "replaces": "none: vkrt_tpu/shade/shading.py and the engine's "
                     "combine (vkrt_tpu/wavefront/engine.py:700-736) are XLA",
         "launches": sum(main_launches["config4"][k]
                         for k in ("L1", "L2", "L3")),
         "max_abs_err": max(r["max_abs_err"] for rows in res_31.values()
                            for r in rows),
         "ms": sum(r["ms"] for r in res_31["config4"]),
         "ms_config5_full": sum(r["ms"] for r in res_31["config5_full"]),
         "plain_ms": sum(r["plain_ms"] for r in res_31["config4"]),
         **{k: add_bounds(res_31["config4"])[k]
            for k in ("bound_ms", "bound_by")},
         "bound_ms_config5_full": add_bounds(
             res_31["config5_full"])["bound_ms"],
         "plain_ms_config5_full": sum(r["plain_ms"]
                                      for r in res_31["config5_full"]),
         "library_ms": None,
         "design": "three steps a depth, one thread a lane each; a lane "
                   "that did not hit writes zeros or nothing"},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
