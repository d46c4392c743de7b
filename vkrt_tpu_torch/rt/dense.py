"""Dense cluster trace — counterpart of vkrt_tpu/rt/dense.py.

`trace_dense` is the wrapper of kernel A (closest hit, with or without
the 36-attribute select) and of kernel A' (`occlusion=True`: any-hit,
division-free), each with per-ray origins or one origin per block of
rays (`point_origin=True`). On a CUDA tensor it launches the
hand-written kernel in csrc/trace_closest.cu or csrc/trace_occluded.cu
(which replace the Pallas kernel `_trace_kernel`, dense.py:238, in those
modes) or raises; on a CPU tensor it runs `trace_dense_plain` or
`trace_occluded_plain`, the plain PyTorch versions of the same
functions. `trace_occluded` is A' under its own name, with its own
launch count.

Outputs, as trace_dense in the JAX package: t (inf on a miss), slot
(leaf order, -1 on a miss), u, v — all [Nb, 128] — and, with
with_attributes, attrs f32[36, Nb, 128] (tri_data columns 0-35 of the
hit, 0 on a miss). The answer is the nearest hit of the gated clusters,
and among hits of equal t the lowest slot, whatever order a kernel visits
the clusters in: kernel A walks them front to back by entry t and commits
a hit where t < the committed t, or t equals it and the slot is lower. In
occlusion mode slot >= 0 means blocked: a blocked ray reads slot 1,
t = TMIN, a free one slot -1, t = inf; u, v (and attrs) are 0.

Every keyword of the JAX `trace_dense` but the TPU-only `interpret` and
`approx_recip` is taken, with the JAX package's outputs. Kernel A's and
A''s modes: `sub_gate` (the sub-run box test, `sub_run_pass`), the
pregates "recheck" and "interval" (per-group candidate lists from an
interval prologue, `interval_gate`, `partition_worklists`,
`cluster_bounds`, `recheck_lists`: the JAX package's XLA prologue,
dense.py:73-211; "interval" trusts the lists' bounds, "recheck" re-tests
each listed box per ray), `stats` (a work-list length and a sweep count
per dispatch block) and `ablate` (the JAX kernel's phase-timing cut
points). Only a cut `ablate` changes an output: it commits nothing.
`group_gate` and `sort` are accepted and met by the walk's structure:
every walk gates per 128-ray group and visits front to back, so each
value gives the default outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkrt_tpu_torch import kernels, tracing
from vkrt_tpu_torch.accel.clusters import (K1, K2, ROWS, SUB_COL, SUBRUNS,
                                           ClusterTree)

TMIN = 0.001          # ref: shaders/shader.rgen:59
_DET_EPS = 1e-12
_N_ATTR = 36
LANES = 128
RAY_CHUNK = 8192      # plain versions: rays gated at a time
PAIR_CHUNK = 16384    # plain versions: (ray, cluster) pairs tested at a time


_INF = 3.0e38         # the interval gate's "unbounded"
SUB_MARGIN_ABS = 1e-3  # sub-run box widening (csrc/walk.cuh `sub_pass`):
SUB_MARGIN_REL = 1e-4  # abs + rel x the corner's magnitude, each axis
PREGATES = ("", "interval", "recheck")
# the JAX kernels' `ablate` cut points, in csrc/walk.cuh's order (Modes)
ABLATES = ("", "onlysc", "noemit", "nodma_nosort", "nodma", "nosweep",
           "nosort")
CUTS = ABLATES[1:6]    # the modes that cut the walk: nothing commits


def _safe_inv(x):
    tiny = 1e-20
    return 1.0 / torch.where(x.abs() < tiny,
                             torch.where(x < 0, -tiny, tiny), x)


def _pregate(pregate, group_gate: bool = False) -> str:
    """The JAX `pregate` argument as a mode name: "" (False: the kernel's
    own gates), "interval" (True) or "recheck". The interval pregate and
    group_gate are exclusive, as the JAX kernel asserts (dense.py:944)."""
    mode = ("interval" if pregate is True
            else "" if pregate is False or pregate is None else pregate)
    if mode not in PREGATES:
        raise ValueError(f"pregate={pregate!r}: expected False, True or one "
                         f"of {PREGATES}")
    if mode == "interval" and group_gate:
        raise ValueError("the interval pregate and group_gate are exclusive")
    return mode


def _ablate(ablate: str, pregate: str) -> str:
    """The cut point a walk takes for the JAX `ablate` argument: under a
    pregate the JAX kernel skips the prepass that "onlysc" and "noemit"
    cut (dense.py:589-629), so they walk in full there."""
    if ablate not in ABLATES:
        raise ValueError(f"ablate={ablate!r}: expected one of {ABLATES}")
    return "" if pregate and ablate in ("onlysc", "noemit") else ablate


def _check_block(what: str, block: int, n: int) -> None:
    """The JAX dispatch block: a multiple of 128 that divides the rays."""
    if block <= 0 or block % LANES or n % block:
        raise ValueError(f"{what}: ray count {n} is not a multiple of block "
                         f"{block} (itself a multiple of {LANES})")


def interval_gate(tree: ClusterTree, origins, dirs, tmax, *, block: int,
                  point_origin: bool):
    """Conservative per-(block, cluster) gate and entry lower bound by
    interval slab tests (vkrt_tpu/rt/dense.py::_interval_gate, the same
    operations): the live rays of each block of `block` rays are summed up
    as per-axis origin and direction intervals. A cluster is gated unless
    the interval test rules out every ray, so every (block, cluster) pair
    that a ray's own slab test passes at its tmax is gated (monotone
    rounding keeps the intervals' products around each ray's).

    origins f32[3,Nb,128] (point_origin: f32[N/block, 3]), dirs
    f32[3,Nb,128], tmax f32[Nb,128] → (gate bool[nblocks, maxc], tlb
    f32[nblocks, maxc], nblocks); tlb = 0.9999 x max(entry bound, 0)."""
    maxc = tree.tri_data.shape[0]
    nblocks = tmax.numel() // block
    live = tmax.reshape(nblocks, block) > TMIN
    d = dirs.reshape(3, nblocks, block)
    big = _INF

    def masked_minmax(v):
        return (torch.where(live, v, big).amin(dim=1),
                torch.where(live, v, -big).amax(dim=1))

    dmin, dmax = zip(*[masked_minmax(d[a]) for a in range(3)])
    if point_origin:
        ob = origins.T                                   # [3, nblocks]
        omin = omax = [ob[a] for a in range(3)]
    else:
        o = origins.reshape(3, nblocks, block)
        omin, omax = zip(*[masked_minmax(o[a]) for a in range(3)])
    tmax_max = torch.where(live, tmax.reshape(nblocks, block),
                           0.0).amax(dim=1)
    lo = [tree.cl_boxes[:, a, :].reshape(-1)[:maxc] for a in range(3)]
    hi = [tree.cl_boxes[:, a + 3, :].reshape(-1)[:maxc] for a in range(3)]

    tn_low = torch.full((nblocks, maxc), -big, device=dirs.device)
    tf_high = torch.full((nblocks, maxc), big, device=dirs.device)
    for a in range(3):
        bounded = (dmin[a] > 1e-20) | (dmax[a] < -1e-20)
        # reciprocal interval [1/dmax, 1/dmin] of an axis whose directions
        # share one sign; a sign-spanning axis adds no constraint
        i_lo = torch.where(bounded, 1.0 / torch.where(bounded, dmax[a], 1.0),
                           -big)[:, None]
        i_hi = torch.where(bounded, 1.0 / torch.where(bounded, dmin[a], 1.0),
                           big)[:, None]

        def hull(nl, nh):
            c = [nl * i_lo, nl * i_hi, nh * i_lo, nh * i_hi]
            return (torch.minimum(torch.minimum(c[0], c[1]),
                                  torch.minimum(c[2], c[3])),
                    torch.maximum(torch.maximum(c[0], c[1]),
                                  torch.maximum(c[2], c[3])))

        t0_lo, t0_hi = hull(lo[a][None, :] - omax[a][:, None],
                            lo[a][None, :] - omin[a][:, None])
        t1_lo, t1_hi = hull(hi[a][None, :] - omax[a][:, None],
                            hi[a][None, :] - omin[a][:, None])
        unb = ~bounded[:, None]
        tn_low = torch.maximum(tn_low, torch.where(
            unb, -big, torch.minimum(t0_lo, t1_lo)))
        tf_high = torch.minimum(tf_high, torch.where(
            unb, big, torch.maximum(t0_hi, t1_hi)))

    valid = lo[0] <= hi[0]                               # padding clusters
    gate = ((tn_low <= tf_high) & (tf_high >= TMIN)
            & (tn_low <= tmax_max[:, None]) & valid[None, :])
    tlb = 0.9999 * torch.clamp(torch.where(tn_low <= -big, 0.0, tn_low),
                               min=0.0)
    return gate, tlb, nblocks


def partition_worklists(gate, tlb, extra=None):
    """Gated clusters of each row to the front, in id order, without a
    sort (vkrt_tpu/rt/dense.py::_partition_worklists): a stable partition,
    the rest behind them in id order; rows padded to a multiple of 64
    (order 0, tlb 0). gate bool[nb, maxc], tlb f32[nb, maxc], extra
    i32[nb, maxc] or None → (order i32[nb, cp], tlb f32[nb, cp], count
    i32[nb][, extra i32[nb, cp]]); tlb is 0 where not gated."""
    nb, maxc = gate.shape
    g = gate.to(torch.int32)
    iota = torch.arange(maxc, dtype=torch.int32, device=gate.device)[None, :]
    ones = torch.cumsum(g, dim=1, dtype=torch.int32)
    count = ones[:, -1]
    pos = torch.where(gate, ones - 1, count[:, None] + iota - ones).long()
    order = torch.empty_like(g).scatter_(1, pos, iota.expand(nb, -1))
    tlb_s = torch.where(gate, tlb, 0.0).gather(1, order.long())
    pad = -(-maxc // 64) * 64 - maxc
    out = (torch.nn.functional.pad(order, (0, pad)),
           torch.nn.functional.pad(tlb_s, (0, pad)), count)
    if extra is not None:
        out += (torch.nn.functional.pad(extra.gather(1, order.long()),
                                        (0, pad)),)
    return out


def cluster_bounds(tree: ClusterTree):
    """Every cluster's box as a flat table f32[6, maxc] (lo xyz, hi xyz),
    cluster id order (vkrt_tpu/rt/dense.py::_cluster_bounds_smem: what
    its re-check reads for a candidate; here the plain versions' gate)."""
    maxc = tree.tri_data.shape[0]
    return torch.cat([tree.cl_boxes[:, a, :].reshape(1, -1)[:, :maxc]
                      for a in range(6)])


class WorkLists(NamedTuple):
    """Per-group candidate lists of the re-check (kernels A and B with
    pregate="recheck"): row g holds count[g] cluster ids in ascending
    order of their entry lower bound, then padding."""
    cid: torch.Tensor                 # i32[G, cp]
    tlb: torch.Tensor                 # f32[G, cp]
    count: torch.Tensor               # i32[G]
    smask: torch.Tensor | None        # i32[G, cp]: kernel B's set bits


def recheck_lists(gate, tlb, extra=None) -> WorkLists:
    """`partition_worklists`, then each row's gated prefix sorted by tlb
    (stable): the order in which a block can stop at the first entry that
    no lane's far bound reaches."""
    out = partition_worklists(gate, tlb, extra)
    order, tlb_p, count = out[:3]
    used = (torch.arange(order.shape[1], device=order.device)[None, :]
            < count[:, None])
    srt = torch.sort(torch.where(used, tlb_p, torch.inf), dim=1,
                     stable=True).indices
    smask = out[3].gather(1, srt).contiguous() if extra is not None else None
    return WorkLists(order.gather(1, srt).contiguous(),
                     tlb_p.gather(1, srt).contiguous(), count.contiguous(),
                     smask)


def closest_worklists(tree: ClusterTree, origins, dirs, tmax, *,
                      point_origin: bool = False,
                      block: int = 512) -> WorkLists:
    """Kernel A's re-check prologue: one interval gate per 128-ray group
    (the walk's unit; the JAX kernel's lists are per `block`, which gives
    wider intervals), as `recheck_lists`. With point_origin, `origins` is
    one point per `block` rays."""
    if point_origin:
        origins = origins.repeat_interleave(block // LANES, dim=0)
    gate, tlb, _ = interval_gate(tree, origins, dirs, tmax, block=LANES,
                                 point_origin=point_origin)
    return recheck_lists(gate, tlb)


def listed_bounds(lists: WorkLists, maxc: int, nsets: int = 1):
    """The lists' entry bounds as a matrix f32[nsets * G, maxc]: row
    s * G + g holds tlb of each cluster listed for set s of group g
    (nsets > 1: the set bits decide), +inf where none is listed."""
    ng, cp = lists.cid.shape
    used = (torch.arange(cp, device=lists.cid.device)[None, :]
            < lists.count[:, None])
    out = torch.full((nsets, ng, maxc + 1), torch.inf,
                     device=lists.cid.device)
    for s in range(nsets):
        on = used if lists.smask is None else (
            used & (((lists.smask >> s) & 1) > 0))
        out[s].scatter_(1, torch.where(on, lists.cid.long(), maxc),
                        torch.where(on, lists.tlb, torch.inf))
    return out[:, :, :maxc].reshape(nsets * ng, maxc)


def listed_matrix(lists: WorkLists, maxc: int, nsets: int = 1):
    """The (row, cluster) pairs the lists nominate: bool[nsets * G, maxc],
    row s * G + g for set s of group g (nsets > 1: the set bits decide)."""
    return listed_bounds(lists, maxc, nsets) < torch.inf


def _check_tree(tree: ClusterTree, device) -> None:
    if tree.tri_data.shape[1:] != (K1, ROWS):
        raise ValueError(f"tree rows {tuple(tree.tri_data.shape[1:])} != "
                         f"({K1}, {ROWS})")
    for name, x in zip(tree._fields, tree):
        if x.device != device:
            raise ValueError(f"tree.{name} on {x.device}, rays on {device}")
        if not x.is_contiguous():
            raise ValueError(f"tree.{name} is not contiguous")
    if tree.tri_data.data_ptr() % 16:      # kernels A, B copy 16-byte pieces
        raise ValueError("tree.tri_data is not 16-byte aligned")


def _slab_tn(o, inv, lo, hi, t_s):
    """Slab test of R rays (o, inv [3,R], far bound t_s [R]) against B
    boxes (lo, hi [3,B]) → (bool [R,B], entry t [R,B]); the kernels'
    `slab`."""
    tn = tf = None
    for a in range(3):
        t0 = (lo[a][None, :] - o[a][:, None]) * inv[a][:, None]
        t1 = (hi[a][None, :] - o[a][:, None]) * inv[a][:, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    t_s = t_s[:, None]
    return (tn <= tf) & (tf >= TMIN) & (tn <= t_s) & (t_s > TMIN), tn


def _slab(o, inv, lo, hi, t_s):
    """`_slab_tn`'s test alone."""
    return _slab_tn(o, inv, lo, hi, t_s)[0]


def _tree_gates(tree, ro, ri, rt, rows=None, listed=None, bounds=None):
    """bool[R, maxc]: the kernels' gate of each (ray, cluster) of R rays
    (origins, inverse directions ro, ri [3,R], far bounds rt [R]) — the
    ray's own test of the cluster's box and of its supercluster's; with
    `listed` (the re-check) the cluster's box listed for the ray's row
    `rows` [R]; with `bounds` (the interval pregate) no box test, the
    cluster listed for the row with a bound the far bound reaches."""
    bounds_ = cluster_bounds(tree)
    valid = bounds_[0] <= bounds_[3]                  # padding clusters
    if bounds is not None:
        return (bounds[rows] <= rt[:, None]) & (rt > TMIN)[:, None]
    gate = _slab(ro, ri, bounds_[0:3], bounds_[3:6], rt) & valid[None]
    if listed is not None:
        return gate & listed[rows]
    n_sc = tree.num_superclusters
    g_sc = _slab(ro, ri, tree.sc_boxes[0:3, :n_sc], tree.sc_boxes[3:6, :n_sc],
                 rt)
    return gate & g_sc.repeat_interleave(K2, dim=1)


def gated_pairs(tree: ClusterTree, o, d, tmax, listed=None, bounds=None):
    """Yield (ray index, cluster id) pairs, RAY_CHUNK rays gated at a time
    and at most PAIR_CHUNK pairs per yield (so memory stays bounded at
    any ray count): every cluster whose box, and whose supercluster's box,
    the ray's slab test passes against its own tmax. o, d [3,N], tmax [N].
    The gate is the kernels' own, evaluated with tmax for the far bound
    (the kernels shrink it to the nearest hit so far, which only skips
    clusters that cannot hold a nearer hit). With `listed` (bool[N/128,
    maxc], `listed_matrix`: the re-check's candidates of each 128-ray
    row) a pair needs its cluster listed for the ray's row and the ray's
    own test of the cluster's box, the kernels' re-check; with `bounds`
    (f32[N/128, maxc], `listed_bounds`: the interval pregate) a live ray
    pairs with every cluster listed for its row whose bound its tmax
    reaches."""
    inv = _safe_inv(d)
    n = tmax.shape[0]
    for r0 in range(0, n, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, n)
        rt = tmax[r0:r1]
        if not bool((rt > TMIN).any()):
            continue
        rows = torch.arange(r0, r1, device=o.device) // LANES
        gate = _tree_gates(tree, o[:, r0:r1], inv[:, r0:r1], rt, rows,
                           listed, bounds)
        ray, cl = torch.nonzero(gate, as_tuple=True)
        for p0 in range(0, ray.shape[0], PAIR_CHUNK):
            yield ray[p0:p0 + PAIR_CHUNK] + r0, cl[p0:p0 + PAIR_CHUNK]


def stats_lane0(tree: ClusterTree, o, d, tmax, block: int):
    """The JAX kernel's work-list length per dispatch block of `block` rays
    (stats lane 0; dense.py:527-582 with t = tmax): the clusters of every
    supercluster whose box some ray of the block passes at its tmax, whose
    own box some ray of the block passes with entry t below the block's
    largest tmax, by the JAX slab arithmetic (a padding cluster's inverted
    box passes it). o, d [3,N], tmax [N] → i32[N/block]."""
    n_sc = tree.num_superclusters
    n = tmax.shape[0]
    nblocks = n // block
    dev = tmax.device
    inv = _safe_inv(d)
    bounds = cluster_bounds(tree)
    btmax = tmax.reshape(nblocks, block).amax(dim=1)
    sc_n = torch.zeros(nblocks, n_sc, dtype=torch.int32, device=dev)
    cl_n = torch.zeros(nblocks, bounds.shape[1], dtype=torch.int32,
                       device=dev)
    for r0 in range(0, n, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, n)
        ro, ri, rt = o[:, r0:r1], inv[:, r0:r1], tmax[r0:r1]
        blk = torch.arange(r0, r1, device=dev) // block
        sc_n.index_add_(0, blk, _slab(ro, ri, tree.sc_boxes[0:3, :n_sc],
                                      tree.sc_boxes[3:6, :n_sc],
                                      rt).to(torch.int32))
        hit, tn = _slab_tn(ro, ri, bounds[0:3], bounds[3:6], rt)
        cl_n.index_add_(0, blk, (hit & (tn < btmax[blk][:, None]))
                        .to(torch.int32))
    return ((sc_n > 0).repeat_interleave(K2, dim=1) & (cl_n > 0)).sum(
        dim=1, dtype=torch.int32)


def sweep_bounds(tree: ClusterTree, o, d, tmax, far, block: int,
                 listed=None, bounds=None):
    """Bounds of stats lane 1 (the (128-ray group, cluster) sweeps a walk
    runs) per dispatch block of `block` rays → (lo, hi) i32[N/block]. lo:
    the clusters that some ray of a group enters at or before its final
    far bound `far` [N] (the nearest hit's t, else tmax; 0 for a blocked
    any-hit ray), each of which every walk sweeps; hi: the clusters the
    group's gate passes at tmax (`_tree_gates`; with `listed` or `bounds`
    as there), beyond which no walk sweeps. o, d [3,N], tmax [N]."""
    n = tmax.shape[0]
    inv = _safe_inv(d)
    lo = torch.zeros(n // LANES, dtype=torch.int32, device=tmax.device)
    hi = torch.zeros_like(lo)
    for r0 in range(0, n, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, n)
        ro, ri = o[:, r0:r1], inv[:, r0:r1]
        rows = torch.arange(r0, r1, device=tmax.device) // LANES
        g0, g1 = r0 // LANES, r1 // LANES
        for out, rt, kw in ((lo, far[r0:r1], {}),
                            (hi, tmax[r0:r1],
                             dict(listed=listed, bounds=bounds))):
            gate = _tree_gates(tree, ro, ri, rt, rows, **kw)
            out[g0:g1] = gate.reshape(g1 - g0, LANES, -1).any(dim=1).sum(
                dim=1, dtype=torch.int32)
    per = block // LANES
    return (lo.reshape(-1, per).sum(dim=1, dtype=torch.int32),
            hi.reshape(-1, per).sum(dim=1, dtype=torch.int32))


def _mt_terms(tri, o, d):
    """Möller–Trumbore terms of pairs: tri [P,K1,9] geometry rows, o, d
    [3,P] → det, up, vp, tp [P,K1], in the kernels' operation order."""
    v0x, v0y, v0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3], tri[..., 4], tri[..., 5]
    e2x, e2y, e2z = tri[..., 6], tri[..., 7], tri[..., 8]
    ox, oy, oz = (o[a][:, None] for a in range(3))
    dx, dy, dz = (d[a][:, None] for a in range(3))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    up = sx * hx + sy * hy + sz * hz
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vp = dx * qx + dy * qy + dz * qz
    tp = e2x * qx + e2y * qy + e2z * qz
    return det, up, vp, tp


def sub_run_pass(tree: ClusterTree, cl, o, inv, t_s):
    """Sub-run box tests of pairs (the kernels' `sub_pass`): cluster ids
    cl [P], ray origins and inverse directions o, inv [3,P], far bounds
    t_s [P] → bool[P, SUBRUNS]. Each box (tri_data rows 0-7, cols 40-45)
    is widened by SUB_MARGIN_ABS + SUB_MARGIN_REL x max(|lo|, |hi|) per
    axis before the slab test, so that a hit on a box face survives the
    rounding; an inverted box (an empty sub-run: zeroed rows, which hold
    no hit) fails."""
    b = tree.tri_data[cl, :SUBRUNS, SUB_COL:SUB_COL + 6]       # [P, 8, 6]
    lo, hi = b[..., 0:3], b[..., 3:6]
    m = SUB_MARGIN_ABS + SUB_MARGIN_REL * torch.maximum(lo.abs(), hi.abs())
    wlo, whi = lo - m, hi + m
    tn = tf = None
    for a in range(3):
        t0 = (wlo[..., a] - o[a][:, None]) * inv[a][:, None]
        t1 = (whi[..., a] - o[a][:, None]) * inv[a][:, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    t_s = t_s[:, None]
    return ((lo[..., 0] <= hi[..., 0]) & (tn <= tf) & (tf >= TMIN)
            & (tn <= t_s) & (t_s > TMIN))


def _sub_gated(tree, ok, cl, o, d, tm):
    """`ok` [P,K1] of pairs restricted to the triangles whose sub-run box
    the ray's test passes at its tmax (sub_gate)."""
    keep = sub_run_pass(tree, cl, o, _safe_inv(d), tm)
    return ok & keep.repeat_interleave(K1 // SUBRUNS, dim=1)


def trace_dense_plain(tree: ClusterTree, origins, dirs, tmax, *,
                      sub_gate: bool = False, listed=None, bounds=None,
                      ablate: str = ""):
    """Plain PyTorch version of kernel A (same inputs and outputs as
    `trace_dense`). Works through gated (ray, cluster) pairs in chunks,
    so memory stays bounded at any ray count. sub_gate: only the
    triangles whose sub-run box passes (`sub_run_pass`); listed, bounds:
    the re-check's and the interval pregate's pairs (`gated_pairs`). Each
    gives the default's outputs; an `ablate` cut (CUTS) commits nothing
    (every ray misses), "nosort" is the default."""
    nb = dirs.shape[1]
    n = nb * LANES
    dev = dirs.device
    o, d, tm = origins.reshape(3, n), dirs.reshape(3, n), tmax.reshape(n)
    geo = tree.tri_data[:, :, 0:9].contiguous()       # [C1p, K1, 9]
    kidx = torch.arange(K1, device=dev)
    rays, ts, slots, us, vs = [], [], [], [], []
    pairs = () if ablate in CUTS else gated_pairs(tree, o, d, tm, listed,
                                                  bounds)
    for ray, cl in pairs:
        det, up, vp, tp = _mt_terms(geo[cl], o[:, ray], d[:, ray])
        adet = det.abs()
        rec = 1.0 / torch.where(det == 0, 1.0, det)
        inv_det = torch.where(adet > _DET_EPS, rec, 0.0)
        uu, vv, tt = up * inv_det, vp * inv_det, tp * inv_det
        ok = ((adet > _DET_EPS) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1)
              & (tt > TMIN) & (tt < tm[ray][:, None]))
        if sub_gate:
            ok = _sub_gated(tree, ok, cl, o[:, ray], d[:, ray], tm[ray])
        tt = torch.where(ok, tt, torch.inf)
        tmin = tt.min(dim=1).values
        ksel = torch.where(ok & (tt == tmin[:, None]), kidx, K1).min(dim=1).values
        keep = ksel < K1
        ksel = ksel[keep]
        rays.append(ray[keep])
        ts.append(tmin[keep])
        slots.append(cl[keep] * K1 + ksel)
        us.append(uu[keep].gather(1, ksel[:, None])[:, 0])
        vs.append(vv[keep].gather(1, ksel[:, None])[:, 0])

    t = torch.full((n,), torch.inf, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    attrs = torch.zeros(_N_ATTR, n, device=dev)
    if rays:
        ray, tp_, sp = torch.cat(rays), torch.cat(ts), torch.cat(slots)
        t = t.scatter_reduce(0, ray, tp_, "amin")
        cand = tp_ == t[ray]                           # nearest per ray
        big = torch.iinfo(torch.int64).max
        best = torch.full((n,), big, dtype=torch.int64, device=dev)
        best = best.scatter_reduce(0, ray[cand], sp[cand], "amin")
        win = cand & (sp == best[ray])                 # then lowest slot
        wr, ws = ray[win], sp[win]
        slot[wr] = ws.to(torch.int32)
        u[wr] = torch.cat(us)[win]
        v[wr] = torch.cat(vs)[win]
        attrs[:, wr] = tree.tri_data.reshape(-1, tree.tri_data.shape[2])[
            ws, :_N_ATTR].T
    return (t.reshape(nb, LANES), slot.reshape(nb, LANES),
            u.reshape(nb, LANES), v.reshape(nb, LANES),
            attrs.reshape(_N_ATTR, nb, LANES))


def trace_occluded_plain(tree: ClusterTree, origins, dirs, tmax, *,
                         sub_gate: bool = False, listed=None, bounds=None,
                         ablate: str = ""):
    """Plain PyTorch version of kernel A' with per-ray origins (same
    inputs as `trace_dense`) → blocked bool[Nb,128]: any gated triangle
    that passes the division-free test blocks the ray. Same arithmetic,
    in the same order, as `occluded_multi_plain`, which passes kernel B's
    modes on (sub_gate, listed, bounds, ablate: see
    `trace_dense_plain`; a cut blocks nothing)."""
    nb = dirs.shape[1]
    n = nb * LANES
    o, d, tm = origins.reshape(3, n), dirs.reshape(3, n), tmax.reshape(n)
    geo = tree.tri_data[:, :, 0:9].contiguous()
    blocked = torch.zeros(n, dtype=torch.bool, device=dirs.device)
    pairs = () if ablate in CUTS else gated_pairs(tree, o, d, tm, listed,
                                                  bounds)
    for ray, cl in pairs:
        det, up, vp, tp = _mt_terms(geo[cl], o[:, ray], d[:, ray])
        adet = det.abs()
        sgn = torch.where(det < 0, -1.0, 1.0)
        su, sv, st = up * sgn, vp * sgn, tp * sgn
        ok = ((adet > _DET_EPS) & (su >= 0) & (sv >= 0) & (su + sv <= adet)
              & (st > TMIN * adet) & (st < tm[ray][:, None] * adet))
        if sub_gate:
            ok = _sub_gated(tree, ok, cl, o[:, ray], d[:, ray], tm[ray])
        blocked[ray[ok.any(dim=1)]] = True
    return blocked.reshape(nb, LANES)


def broadcast_points(o_pts, dirs, block: int):
    """[N/block, 3] per-block origin points → full [3,Nb,128] origins."""
    o = o_pts.repeat_interleave(block // LANES, dim=0).T[:, :, None]
    return o.expand(dirs.shape).contiguous()


def _check_rays(what, origins, dirs, tmax, block: int, point_origin: bool,
                stats: bool = False):
    """Validate a trace wrapper's ray arguments; returns (device, Nb).
    `block` is a multiple of 128; with point origins or stats, whose
    unit it is, it also divides the rays."""
    dev = dirs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    nb = dirs.shape[1]
    n = nb * LANES
    _check_block(what, block, n if point_origin or stats else block)
    o_shape = (n // block, 3) if point_origin else (3, nb, LANES)
    if (dirs.shape != (3, nb, LANES) or origins.shape != o_shape
            or tmax.shape != (nb, LANES)):
        raise ValueError(f"{what}: shapes o {tuple(origins.shape)} "
                         f"d {tuple(dirs.shape)} tmax {tuple(tmax.shape)}")
    for name, x in (("origins", origins), ("dirs", dirs), ("tmax", tmax)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{what}: {name} must be f32 on {dev}")
    return dev, nb


def _kernel_args(tree: ClusterTree, origins, block: int, dirs, tmax):
    """The leading arguments both trace kernels' C entry points share."""
    return (tree.sc_boxes.data_ptr(), tree.sc_boxes.shape[1],
            tree.num_superclusters, tree.cl_boxes.data_ptr(),
            tree.tri_data.data_ptr(), origins.data_ptr(), block,
            dirs.data_ptr(), tmax.data_ptr(), tmax.numel())


def _plain_lists(tree: ClusterTree, lists, pregate: str, nsets: int = 1):
    """The plain versions' keywords for a pregate's candidate lists."""
    if not pregate:
        return {}
    maxc = tree.tri_data.shape[0]
    if pregate == "interval":
        return dict(bounds=listed_bounds(lists, maxc, nsets))
    return dict(listed=listed_matrix(lists, maxc, nsets))


def popcount_rows(mask):
    """Set bits of each row of an i32 matrix → i32[rows]."""
    bit = torch.arange(32, dtype=torch.int32, device=mask.device)
    return ((mask[..., None] >> bit) & 1).sum(dim=(1, 2), dtype=torch.int32)


def stats_lane0_of(tree: ClusterTree, origins, dirs, tmax, *, block: int,
                   point_origin: bool, pregate: str, ablate: str,
                   mask=None, lists=None):
    """Stats lane 0 per dispatch block, as the JAX kernel counts it: 0
    where the walk is cut before its lists ("onlysc", "noemit"); under a
    pregate the prologue's interval-gated count at `block` (the JAX
    kernel copies it, dense.py:596): at block 128 the counts of the
    walk's own `lists` (`closest_worklists` gates per 128-ray group), at
    a wider block a gate of its own, whose intervals span the whole
    block as the JAX kernel's do; else the work list's length, from the
    kernel's cluster bits `mask` or, without, `stats_lane0`."""
    n = tmax.numel()
    if ablate in ("onlysc", "noemit"):
        return torch.zeros(n // block, dtype=torch.int32, device=tmax.device)
    if pregate and block == LANES and lists is not None:
        return lists.count
    if pregate:
        gate = interval_gate(tree, origins, dirs, tmax, block=block,
                             point_origin=point_origin)[0]
        return gate.sum(dim=1, dtype=torch.int32)
    if mask is not None:
        return popcount_rows(mask)
    if point_origin:
        origins = broadcast_points(origins, dirs, block)
    return stats_lane0(tree, origins.reshape(3, n), dirs.reshape(3, n),
                       tmax.reshape(n), block)


def plain_stats(tree: ClusterTree, origins, dirs, tmax, *, block: int,
                point_origin: bool, pregate: str, ablate: str, lists=None):
    """The plain versions' stats i32[N/block, 2]: lane 0 as the JAX
    kernel's (`stats_lane0_of`); lane 1 the sweeps of a walk that never
    prunes (`sweep_bounds`' hi), 0 where the walk is cut before its
    sweeps."""
    lane0 = stats_lane0_of(tree, origins, dirs, tmax, block=block,
                           point_origin=point_origin, pregate=pregate,
                           ablate=ablate, lists=lists)
    n = tmax.numel()
    if ablate in CUTS and ablate != "nosweep":
        lane1 = torch.zeros_like(lane0)
    else:
        if point_origin:
            origins = broadcast_points(origins, dirs, block)
        tm = tmax.reshape(n)
        lane1 = sweep_bounds(tree, origins.reshape(3, n), dirs.reshape(3, n),
                             tm, tm, block,
                             **_plain_lists(tree, lists, pregate))[1]
    return torch.stack([lane0, lane1], dim=1)


def _stat_buffers(tree: ClusterTree, tmax, block: int):
    """Kernel-side stats buffers (zeroed: the kernel adds into them):
    (stats i32[N/block, 2], cluster bits i32[N/block, words], the
    blocks' largest tmax f32[N/block])."""
    nblocks = tmax.numel() // block
    words = -(-tree.tri_data.shape[0] // 32)
    return (torch.zeros(nblocks, 2, dtype=torch.int32, device=tmax.device),
            torch.zeros(nblocks, words, dtype=torch.int32,
                        device=tmax.device),
            tmax.reshape(nblocks, block).amax(dim=1).contiguous())


def mode_args(ablate: str, interval: bool, bufs, block: int):
    """The C entry points' run-time mode arguments (ablate, interval,
    stats, stat_mask, mask_words, stat_groups, stat_btmax)."""
    if bufs is None:
        return ABLATES.index(ablate), int(interval), None, None, 0, 0, None
    out, mask, btmax = bufs
    return (ABLATES.index(ablate), int(interval), out.data_ptr(),
            mask.data_ptr(), mask.shape[1], block // LANES, btmax.data_ptr())


def _count(fn, **modes) -> None:
    """Count a launch in `fn.launches` and each mode it asked for in
    `fn.mode_launches` (the key "ablate_<cut>" for an `ablate`)."""
    fn.launches += 1
    for key, on in modes.items():
        if key == "ablate":
            if on:
                fn.mode_launches[f"ablate_{on}"] += 1
        else:
            fn.mode_launches[key] += int(bool(on))


def _mode_counts(*keys) -> dict:
    return dict.fromkeys(keys + tuple(f"ablate_{a}" for a in ABLATES[1:]), 0)


def trace_occluded(tree: ClusterTree, origins, dirs, tmax, *,
                   block: int = 512, point_origin: bool = False,
                   sub_gate: bool = False, pregate=False, ablate: str = "",
                   stats: bool = False):
    """Any-hit trace (kernel A' and its wrapper): `trace_dense`'s
    occlusion mode, same ray arguments and modes (sub_gate, pregate,
    ablate, stats: see `trace_dense`). Returns (t, slot, u, v[, stats]),
    all [Nb,128]: slot 1, t = TMIN on a blocked ray, slot -1, t = inf on
    a free one, u = v = 0. A CUDA tensor launches kernel A' and counts it
    in `trace_occluded.launches` (each mode asked for in
    `trace_occluded.mode_launches`); a CPU tensor runs
    `trace_occluded_plain` in the same mode."""
    pregate = _pregate(pregate)
    ablate = _ablate(ablate, pregate)
    dev, nb = _check_rays("trace_occluded", origins, dirs, tmax, block,
                          point_origin, stats)
    tracing.lanes("trace_occluded", nb * LANES)
    lists = (closest_worklists(tree, origins, dirs, tmax,
                               point_origin=point_origin, block=block)
             if pregate else None)
    sk = dict(block=block, point_origin=point_origin, pregate=pregate,
              ablate=ablate)
    if dev.type == "cpu":
        full = broadcast_points(origins, dirs, block) if point_origin \
            else origins
        blocked = trace_occluded_plain(tree, full, dirs, tmax,
                                       sub_gate=sub_gate, ablate=ablate,
                                       **_plain_lists(tree, lists, pregate))
        zero = torch.zeros(nb, LANES)
        out = (torch.where(blocked, TMIN, torch.inf),
               torch.where(blocked, 1, -1).to(torch.int32), zero, zero)
        if stats:
            out += (plain_stats(tree, origins, dirs, tmax, lists=lists,
                                **sk),)
        return out
    _check_tree(tree, dev)
    origins, dirs, tmax = (x.contiguous() for x in (origins, dirs, tmax))
    t = torch.empty(nb, LANES, device=dev)
    slot = torch.empty(nb, LANES, dtype=torch.int32, device=dev)
    u = torch.empty(nb, LANES, device=dev)
    v = torch.empty(nb, LANES, device=dev)
    bufs = _stat_buffers(tree, tmax, block) if stats else None
    cid, tlb, _, count, stride = list_args(lists)
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.vkrt_trace_occluded(
            *_kernel_args(tree, origins, block if point_origin else 0, dirs,
                          tmax), int(sub_gate), cid, tlb, count, stride,
            *mode_args(ablate, pregate == "interval", bufs, block),
            t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "trace_occluded")
    _count(trace_occluded, sub_gate=sub_gate, recheck=pregate == "recheck",
           interval=pregate == "interval", stats=stats, ablate=ablate)
    if not stats:
        return t, slot, u, v
    bufs[0][:, 0] = stats_lane0_of(tree, origins, dirs, tmax, mask=bufs[1],
                                   lists=lists, **sk)
    return t, slot, u, v, bufs[0]


trace_occluded.launches = 0       # kernel A', every mode
trace_occluded.mode_launches = _mode_counts("sub_gate", "recheck",
                                            "interval", "stats")


def list_args(lists: WorkLists | None):
    """The C entry points' candidate-list arguments (cid, tlb, smask,
    count, row stride; the default walk without lists)."""
    if lists is None:
        return None, None, None, None, 0
    smask = lists.smask.data_ptr() if lists.smask is not None else None
    return (lists.cid.data_ptr(), lists.tlb.data_ptr(), smask,
            lists.count.data_ptr(), lists.cid.shape[1])


def trace_dense(tree: ClusterTree, origins, dirs, tmax, *, block: int = 512,
                occlusion: bool = False, with_attributes: bool = True,
                stats: bool = False, point_origin: bool = False,
                sort: bool = True, group_gate: bool = False, pregate=False,
                ablate: str = "", sub_gate: bool = False):
    """Trace rays against the cluster tree (lane-major I/O).

    origins, dirs: f32[3, Nb, 128]; tmax: f32[Nb, 128] (0 = parked ray).
    N must be a multiple of `block`, the JAX kernel's dispatch block (a
    multiple of 128; else ValueError). point_origin=True: the rays of
    each block of `block` share one origin and `origins` is f32[N/block,
    3]. Returns (t, slot, u, v[, attrs][, stats]) — see the module
    docstring; unlike the JAX function, with_attributes defaults to True.
    occlusion=True is `trace_occluded` (kernel A', the same modes; attrs
    are zeros).

    The JAX kernel's modes (dense.py:802-890), each with the default's
    outputs bit for bit: sub_gate sweeps only the 16-triangle sub-runs
    whose widened box a ray enters before its t_cur; pregate="recheck"
    walks per-group candidate lists from an interval prologue
    (`closest_worklists`) in place of the kernel's own supercluster and
    cluster gates, re-testing each listed box per ray; pregate=True or
    "interval" walks the same lists trusting their bounds (exclusive
    with group_gate, as in JAX). stats=True appends i32[N/block, 2] per
    dispatch block: lane 0 the JAX work-list length (equal to the JAX
    kernel's), lane 1 the (128-ray group, cluster) sweeps run (the JAX
    kernel counts clusters per block; `sweep_bounds` bounds the port's).
    ablate (phase timing, csrc/walk.cuh's map): the cut points "onlysc",
    "noemit", "nodma_nosort", "nodma", "nosweep" commit nothing (every
    ray misses), "nosort" walks each list in id order (outputs
    unchanged). group_gate and sort are met by the walk's structure (it
    gates per 128-ray group and visits front to back whatever they say):
    accepted, counted, no output changes. A CUDA tensor launches kernel A
    in the asked mode and counts it in `trace_dense.launches` and each
    mode asked for in `trace_dense.mode_launches`; a CPU tensor runs
    `trace_dense_plain` in the same mode (with the same prologue)."""
    pregate = _pregate(pregate, group_gate)
    ablate = _ablate(ablate, pregate)
    if occlusion:
        out = trace_occluded(tree, origins, dirs, tmax, block=block,
                             point_origin=point_origin, sub_gate=sub_gate,
                             pregate=pregate, ablate=ablate, stats=stats)
        if with_attributes:
            out = out[:4] + (torch.zeros((_N_ATTR,) + tmax.shape,
                                         device=tmax.device),) + out[4:]
        return out
    dev, nb = _check_rays("trace_dense", origins, dirs, tmax, block,
                          point_origin, stats)
    tracing.lanes("trace_closest", nb * LANES)
    lists = (closest_worklists(tree, origins, dirs, tmax,
                               point_origin=point_origin, block=block)
             if pregate else None)
    sk = dict(block=block, point_origin=point_origin, pregate=pregate,
              ablate=ablate)
    if dev.type == "cpu":
        full = broadcast_points(origins, dirs, block) if point_origin \
            else origins
        out = trace_dense_plain(tree, full, dirs, tmax, sub_gate=sub_gate,
                                ablate=ablate,
                                **_plain_lists(tree, lists, pregate))
        out = out if with_attributes else out[:4]
        if stats:
            out += (plain_stats(tree, origins, dirs, tmax, lists=lists,
                                **sk),)
        return out
    _check_tree(tree, dev)
    origins, dirs, tmax = (x.contiguous() for x in (origins, dirs, tmax))
    t = torch.empty(nb, LANES, device=dev)
    slot = torch.empty(nb, LANES, dtype=torch.int32, device=dev)
    u = torch.empty(nb, LANES, device=dev)
    v = torch.empty(nb, LANES, device=dev)
    attrs = (torch.empty(_N_ATTR, nb, LANES, device=dev)
             if with_attributes else None)
    bufs = _stat_buffers(tree, tmax, block) if stats else None
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.vkrt_trace_closest(
            *_kernel_args(tree, origins, block if point_origin else 0, dirs,
                          tmax), int(sub_gate), *list_args(lists),
            *mode_args(ablate, pregate == "interval", bufs, block),
            t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
            attrs.data_ptr() if with_attributes else None,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "trace_closest")
    _count(trace_dense, sub_gate=sub_gate, recheck=pregate == "recheck",
           interval=pregate == "interval", stats=stats, ablate=ablate,
           group_gate=group_gate, no_sort=not sort)
    out = (t, slot, u, v, attrs) if with_attributes else (t, slot, u, v)
    if stats:
        bufs[0][:, 0] = stats_lane0_of(tree, origins, dirs, tmax,
                                       mask=bufs[1], lists=lists, **sk)
        out += (bufs[0],)
    return out


trace_dense.launches = 0          # kernel A, every mode
trace_dense.mode_launches = _mode_counts("sub_gate", "recheck", "interval",
                                         "stats", "group_gate", "no_sort")


def trace_dense_rays(tree: ClusterTree, origins, dirs, tmax, *,
                     with_attributes: bool = False, **kw):
    """`trace_dense` over row-major rays (origins, dirs [N,3], tmax [N]),
    the JAX package's test and tooling wrapper (dense.py:1066-1083):
    converts to lane-major, traces, converts back → (t, slot, u, v [N][,
    attrs [N,36]][, stats]); with_attributes defaults to False, as
    there."""
    from vkrt_tpu_torch.utils import layout as L

    out = trace_dense(tree, L.to_cvec(origins), L.to_cvec(dirs),
                      L.to_lanes(tmax), with_attributes=with_attributes,
                      **kw)
    flat = [L.from_lanes(x) for x in out[:4]]
    rest = out[4:]
    if with_attributes:
        attrs = rest[0]
        flat.append(torch.movedim(attrs, 0, -1).reshape(-1, attrs.shape[0]))
        rest = rest[1:]
    return tuple(flat) + tuple(rest)
