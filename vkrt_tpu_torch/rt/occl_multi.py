"""Multi-light occlusion trace — counterpart of vkrt_tpu/rt/occl_multi.py.

`occluded_multi` is kernel B's wrapper. On a CUDA tensor it launches the
hand-written kernel in csrc/occl_multi.cu (which replaces the Pallas
kernel `_occl_multi_kernel`, occl_multi.py:40) or raises; on a CPU
tensor it runs `occluded_multi_plain`, the plain PyTorch version.

NS segment sets share one surface wavefront: set s starts at light point
light_pts[s], runs along dirs[s] and ends at tmax[s] (0 = parked).
Returns blocked bool[NS, Nb, 128]. A segment with 0 < tmax <= TMIN is
not blocked: its interval is empty.

Every keyword of the JAX `occluded_multi` but the TPU-only `interpret`
is taken, with the JAX package's masks. Kernel B's modes `sub_gate`,
the pregates ("recheck", "interval") and `ablate` are kernel A's
(rt/dense.py); the pregates' prologue here is the per-set form of the
JAX kernel's caller (occl_multi.py:611-630): one interval gate per
segment set, their OR, the least of their entry bounds and the sets'
bits per candidate (`multi_worklists`). `visit` orders the walk's lists
("near", "mid", "far"; occl_multi.py:244-290). `group_gate` and `sort`
are met by the walk's structure (per 128-ray group, front to back).
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels, tracing
from vkrt_tpu_torch.rt.dense import (_INF, ABLATES, LANES, WorkLists,
                                     _ablate, _check_block, _check_tree,
                                     _count, _mode_counts, _plain_lists,
                                     _pregate, interval_gate, list_args,
                                     recheck_lists, trace_occluded_plain)
from vkrt_tpu_torch.accel.clusters import ClusterTree

MAX_SETS = 4          # kernel B keeps a group's 128 x NS segments in shared
                      # memory; it is built for NS = 1..4
VISITS = ("near", "mid", "far")   # csrc/walk.cuh's VISIT_* order


def multi_interval_gate(tree: ClusterTree, light_pts, dirs, tmax, *,
                        block: int):
    """The per-set interval gate of kernel B's re-check: per block of
    `block` surface points, set s's segments from light s summed up by
    `interval_gate` (point origin); the gates OR-ed, the least entry bound
    of the sets that gate, and bit s set where set s gates. → (gate
    bool[nblocks, maxc], tlb f32 (0 where not gated), bits i32)."""
    ns = light_pts.shape[0]
    nblocks = tmax[0].numel() // block
    gate = tlb = bits = None
    for s in range(ns):
        pts = light_pts[s][None, :].expand(nblocks, 3)
        g, t, _ = interval_gate(tree, pts, dirs[s], tmax[s], block=block,
                                point_origin=True)
        t = torch.where(g, t, _INF)
        b = torch.where(g, 1 << s, 0).to(torch.int32)
        gate = g if gate is None else gate | g
        tlb = t if tlb is None else torch.minimum(tlb, t)
        bits = b if bits is None else bits | b
    return gate, torch.where(gate, tlb, 0.0), bits


def multi_worklists(tree: ClusterTree, light_pts, dirs, tmax) -> WorkLists:
    """Kernel B's re-check prologue: `multi_interval_gate` per 128-lane
    group (the walk's unit), as `recheck_lists` with the set bits."""
    return recheck_lists(*multi_interval_gate(tree, light_pts, dirs, tmax,
                                              block=LANES))


def occluded_multi_plain(tree: ClusterTree, light_pts, dirs, tmax, *,
                         sub_gate: bool = False,
                         lists: WorkLists | None = None,
                         pregate: str = "recheck", ablate: str = ""):
    """Plain PyTorch version of kernel B (same inputs and outputs as
    `occluded_multi`): every (set, ray) is one segment from its set's
    light point, traced by the plain any-hit version; sub_gate, the
    `lists` of `pregate` ("recheck" or "interval") and `ablate` as in
    kernel A's plain version (a segment's candidates are its group's
    clusters with its set's bit). The visit order changes no mask."""
    ns, nb = dirs.shape[0], dirs.shape[2]
    d = dirs.permute(1, 0, 2, 3).reshape(3, ns * nb, LANES)
    o = light_pts.T[:, :, None, None].expand(3, ns, nb, LANES)
    kw = _plain_lists(tree, lists, pregate if lists is not None else "", ns)
    blocked = trace_occluded_plain(tree, o.reshape(3, ns * nb, LANES), d,
                                   tmax.reshape(ns * nb, LANES),
                                   sub_gate=sub_gate, ablate=ablate, **kw)
    return blocked.reshape(ns, nb, LANES)


def occluded_multi(tree: ClusterTree, light_pts, dirs, tmax, *,
                   block: int = 512, sort: bool = True,
                   group_gate: bool = False, pregate=False, ablate: str = "",
                   visit: str = "near", sub_gate: bool = False):
    """NS-segment-set occlusion trace (lane-major I/O).

    light_pts: f32[NS, 3]; dirs: f32[NS, 3, Nb, 128]; tmax: f32[NS, Nb, 128].
    `block`: the JAX dispatch block, a multiple of 128 (else ValueError).
    Kernel B's modes, none of which changes a mask: sub_gate,
    pregate="recheck" and pregate=True / "interval" (exclusive with
    group_gate) as kernel A's; visit "mid" or "far" orders the walk's
    lists by the entry's distance from half the segments' far bound, or
    farthest first (under a pregate the lists keep their own order, as
    the JAX kernel's, whose visit keys order only its in-kernel prepass;
    pregate="recheck" with sort and visit other than "near" raises
    ValueError, as the JAX entry asserts); ablate as kernel A's (a cut
    blocks nothing); group_gate and sort are met by the walk's structure.
    A CUDA tensor launches kernel B in that mode (NS from 1 to MAX_SETS;
    other counts raise) and counts it in `occluded_multi.launches` and
    each mode asked for in `occluded_multi.mode_launches`; a CPU tensor
    runs `occluded_multi_plain` in the same mode."""
    pregate = _pregate(pregate, group_gate)
    ablate = _ablate(ablate, pregate)
    if visit not in VISITS:
        raise ValueError(f"visit={visit!r}: expected one of {VISITS}")
    if pregate == "recheck" and sort and visit != "near":
        raise ValueError("recheck with sort orders by the interval bound "
                         "(visit='near' only)")
    dev = dirs.device
    ns, nb = dirs.shape[0], dirs.shape[2]
    _check_block("occluded_multi", block, block)
    tracing.lanes("occl_multi", ns * nb * LANES)
    lists = (multi_worklists(tree, light_pts, dirs, tmax)
             if pregate else None)
    if dev.type == "cpu":
        return occluded_multi_plain(tree, light_pts, dirs, tmax,
                                    sub_gate=sub_gate, lists=lists,
                                    pregate=pregate, ablate=ablate)
    if dev.type != "cuda":
        raise ValueError(f"occluded_multi: unsupported device {dev}")
    if not 1 <= ns <= MAX_SETS:
        raise ValueError(f"occluded_multi: {ns} segment sets; kernel B "
                         f"takes 1 to {MAX_SETS}")
    if (dirs.shape != (ns, 3, nb, LANES) or tmax.shape != (ns, nb, LANES)
            or light_pts.shape != (ns, 3)):
        raise ValueError(f"occluded_multi: shapes lights "
                         f"{tuple(light_pts.shape)} d {tuple(dirs.shape)} "
                         f"tmax {tuple(tmax.shape)}")
    for name, x in (("light_pts", light_pts), ("dirs", dirs), ("tmax", tmax)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"occluded_multi: {name} must be f32 on {dev}")
    _check_tree(tree, dev)
    light_pts, dirs, tmax = (x.contiguous() for x in (light_pts, dirs, tmax))
    blocked = torch.empty(ns, nb, LANES, dtype=torch.bool, device=dev)
    walk_visit = "near" if pregate else visit
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_occl_multi(
            tree.sc_boxes.data_ptr(), tree.sc_boxes.shape[1],
            tree.num_superclusters, tree.cl_boxes.data_ptr(),
            tree.tri_data.data_ptr(), light_pts.data_ptr(), dirs.data_ptr(),
            tmax.data_ptr(), ns, nb * LANES, int(sub_gate),
            *list_args(lists), ABLATES.index(ablate),
            VISITS.index(walk_visit), int(pregate == "interval"),
            blocked.data_ptr(), stream)
    kernels.check(err, "occl_multi")
    _count(occluded_multi, sub_gate=sub_gate, recheck=pregate == "recheck",
           interval=pregate == "interval", ablate=ablate,
           visit_mid=visit == "mid", visit_far=visit == "far",
           group_gate=group_gate, no_sort=not sort)
    return blocked


occluded_multi.launches = 0       # kernel B, every mode
occluded_multi.mode_launches = _mode_counts(
    "sub_gate", "recheck", "interval", "visit_mid", "visit_far",
    "group_gate", "no_sort")
