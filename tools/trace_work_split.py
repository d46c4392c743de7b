"""Work split of kernels A and B: the (ray, triangle) pairs that walks sweep.

    python3 tools/trace_work_split.py [--sample 8]

Run it from the root of a checkout on a machine with an NVIDIA GPU. It
records the inputs that kernels A (closest hit) and B (multi-light
shadow) get in one config-4 frame at the start camera (depths 0 and 1)
and in one config-5 `refit` frame under rot_y(0.02) (depths 0-3), the way
chip_smoke.py's `main_path_shapes` records them, keeps every `sample`-th
128-lane group, and counts per depth and kernel, with plain torch on the
card, the (ray, triangle) pairs that these walks sweep (live triangles
only; a shadow segment stops at its first blocker, inside that cluster
too):

  bound           pairs whose segment up to the final hit (A) or the
                  nearest blocker (B) enters the cluster: the pairs that
                  chip_smoke.py's bound counts (`trace_pairs`)
  ascending       a per-ray walk over clusters in ascending id with a
                  shrinking t_cur: the per-lane work of a one-thread-a-
                  ray kernel that walks the tree in id order
  ascending_warp  the same walk as a warp issues it: for every (warp of
                  32 lanes, cluster) where any lane sweeps, 32 x the
                  rows the furthest lane sweeps
  nearest         a per-ray walk in the order of the ray's own entry t
  group_*         the walk of a block that owns a 128-lane group: one
                  cluster order for the group, by the least entry t of
                  any of its lanes (and, for B, of any light's segment);
                  `two_level` orders the superclusters by that key, then
                  the clusters inside each, `whole_tree` orders all
                  clusters at once; each lane still sweeps only where
                  its own entry t <= its own t_cur. `_warp` is the
                  warp-issued count, as above.

It also counts the (lane, cluster box) tests of the two designs: a
one-thread-a-ray kernel tests every cluster of every supercluster a lane
enters (per warp: the union), a group kernel every cluster of every
supercluster that some lane of the group enters, for all 128 lanes (x NS
for B).

Prints the card's nvidia-smi name and power limit, then one JSON object.
The walk functions also run on the CPU (tests/test_torch_trace.py holds
their final hits against the plain versions of A and B).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from vkrt_tpu_torch.accel.clusters import K1, K2              # noqa: E402
from vkrt_tpu_torch.rt.dense import (TMIN, _DET_EPS, _mt_terms,  # noqa: E402
                                     _safe_inv)

RAY_CHUNK = 4096       # rays gated at a time
PAIR_CHUNK = 32768     # (ray, cluster) pairs intersected at a time
WARP = 32
GROUP = 128
INF = float("inf")


def _slab_tn(o, inv, lo, hi, t_s):
    """Slab test of R rays against B boxes, as the kernels' `slab`:
    (gate bool[R,B], entry t tn f32[R,B])."""
    tn = tf = None
    for a in range(3):
        t0 = (lo[a][None, :] - o[a][:, None]) * inv[a][:, None]
        t1 = (hi[a][None, :] - o[a][:, None]) * inv[a][:, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    t_s = t_s[:, None]
    return (tn <= tf) & (tf >= TMIN) & (tn <= t_s) & (t_s > TMIN), tn


def pair_table(tree, o, d, tmax, occlusion: bool) -> dict:
    """Every (ray, cluster) pair that the ray's slab tests pass at its
    tmax (supercluster and cluster box), o, d [3,N], tmax [N]:
    ray, cluster, sc_tn and cl_tn (entry t of the two boxes); the
    cluster's closest hit t below tmax (inf if none) and its slot (the
    lowest of equal t; -1 if none), in kernel A's arithmetic; with
    `occlusion`, also `blk_rows`, the live rows up to and including the
    first blocker in kernel B's division-free test (-1 if none)."""
    dev = d.device
    n_sc = tree.num_superclusters
    inv = _safe_inv(d)
    sc_lo, sc_hi = tree.sc_boxes[0:3, :n_sc], tree.sc_boxes[3:6, :n_sc]
    cl_lo = tree.cl_boxes[:, 0:3, :].permute(1, 0, 2).reshape(3, -1)
    cl_hi = tree.cl_boxes[:, 3:6, :].permute(1, 0, 2).reshape(3, -1)
    valid = cl_lo[0] <= cl_hi[0]
    geo = tree.tri_data[:, :, 0:9].contiguous()
    live_cum = torch.cumsum(live_rows(tree), dim=1)          # [C1p, K1]
    kidx = torch.arange(K1, device=dev)
    cols = {k: [] for k in ("ray", "cl", "sc_tn", "cl_tn", "hit_t",
                            "hit_slot") + (("blk_rows",) if occlusion else ())}
    for r0 in range(0, tmax.shape[0], RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, tmax.shape[0])
        ro, ri, rt = o[:, r0:r1], inv[:, r0:r1], tmax[r0:r1]
        if not bool((rt > TMIN).any()):
            continue
        g_sc, tn_sc = _slab_tn(ro, ri, sc_lo, sc_hi, rt)
        g_cl, tn_cl = _slab_tn(ro, ri, cl_lo, cl_hi, rt)
        gate = g_cl & valid[None] & g_sc.repeat_interleave(K2, dim=1)
        ray, cl = torch.nonzero(gate, as_tuple=True)
        sc_tn = tn_sc[ray, cl // K2]
        cl_tn = tn_cl[ray, cl]
        for p0 in range(0, ray.shape[0], PAIR_CHUNK):
            pr, pc = ray[p0:p0 + PAIR_CHUNK] + r0, cl[p0:p0 + PAIR_CHUNK]
            det, up, vp, tp = _mt_terms(geo[pc], o[:, pr], d[:, pr])
            adet = det.abs()
            rec = 1.0 / torch.where(det == 0, 1.0, det)
            inv_det = torch.where(adet > _DET_EPS, rec, 0.0)
            uu, vv, tt = up * inv_det, vp * inv_det, tp * inv_det
            tm = tmax[pr][:, None]
            ok = ((adet > _DET_EPS) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1)
                  & (tt > TMIN) & (tt < tm))
            tt = torch.where(ok, tt, INF)
            tbest = tt.min(dim=1).values
            kbest = torch.where(ok & (tt == tbest[:, None]), kidx,
                                K1).min(dim=1).values
            cols["hit_t"].append(tbest)
            cols["hit_slot"].append(torch.where(kbest < K1, pc * K1 + kbest,
                                                -1))
            if occlusion:
                sgn = torch.where(det < 0, -1.0, 1.0)
                su, sv, st = up * sgn, vp * sgn, tp * sgn
                blk = ((adet > _DET_EPS) & (su >= 0) & (sv >= 0)
                       & (su + sv <= adet) & (st > TMIN * adet)
                       & (st < tm * adet))
                first = torch.where(blk, kidx, K1).min(dim=1).values
                rows = live_cum[pc, first.clamp(max=K1 - 1)]
                cols["blk_rows"].append(torch.where(first < K1, rows, -1))
        cols["ray"].append(ray + r0)
        cols["cl"].append(cl)
        cols["sc_tn"].append(sc_tn)
        cols["cl_tn"].append(cl_tn)
    longs = ("ray", "cl", "hit_slot", "blk_rows")
    return {k: (torch.cat(v) if v else torch.empty(
        0, dtype=torch.long if k in longs else torch.float32, device=dev))
        for k, v in cols.items()}


def live_rows(tree) -> torch.Tensor:
    """Rows with a non-zero geometry row: bool [C1p, K1]."""
    return (tree.tri_data[..., :9] != 0).any(-1)


def _order(ray, *keys):
    """Permutation sorting pairs by ray, then keys[0], keys[1], ...
    (stable: equal keys keep the pair table's ascending-id order)."""
    idx = torch.arange(ray.numel(), device=ray.device)
    for k in reversed((ray,) + keys):
        idx = idx[torch.sort(k[idx], stable=True).indices]
    return idx


def _dense(ray, order, n):
    """Row (ray) and column (visit position) of each pair in `order`."""
    r = ray[order]
    counts = torch.bincount(r, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(r.numel(), device=r.device) - start[r]
    width = int(counts.max()) if r.numel() else 0
    return r, pos, width


def walk(tab, n, tmax, order, occlusion: bool):
    """Run every ray's walk over its gated pairs in `order` (a
    permutation of the pair table, grouped by ray): a pair is swept where
    max(sc_tn, cl_tn) <= the ray's t_cur, which starts at tmax and (A)
    falls to each swept cluster's closest hit, or (B) the walk stops
    after the first swept cluster with a blocker. Returns bool [P] in
    the table's order."""
    r, pos, width = _dense(tab["ray"], order, n)
    dev = r.device
    entry = torch.full((n, width), INF, device=dev)
    entry[r, pos] = torch.maximum(tab["sc_tn"], tab["cl_tn"])[order]
    if occlusion:
        stop = torch.zeros((n, width), dtype=torch.bool, device=dev)
        stop[r, pos] = (tab["blk_rows"] >= 0)[order]
    else:
        hit = torch.full((n, width), INF, device=dev)
        hit[r, pos] = tab["hit_t"][order]
    t_cur = tmax.clone()
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    swept = torch.zeros((n, width), dtype=torch.bool, device=dev)
    for j in range(width):
        s = (entry[:, j] <= t_cur) & ~done
        swept[:, j] = s
        if occlusion:
            done = done | (s & stop[:, j])
        else:
            t_cur = torch.where(s, torch.minimum(t_cur, hit[:, j]), t_cur)
    out = torch.zeros_like(tab["cl_tn"], dtype=torch.bool)
    out[order] = swept[r, pos]
    return out


def final_hit(tab, swept, n):
    """(t, slot) [n] each ray's walk ends at: the smallest t of its swept
    clusters' hits, then the lowest slot (inf, -1 on a miss)."""
    dev = swept.device
    t = torch.full((n,), INF, device=dev)
    slot = torch.full((n,), -1, dtype=torch.long, device=dev)
    h = swept & (tab["hit_slot"] >= 0)
    ray, ht, hs = tab["ray"][h], tab["hit_t"][h], tab["hit_slot"][h]
    if ray.numel():
        t = t.scatter_reduce(0, ray, ht, "amin")
        cand = ht == t[ray]
        big = torch.iinfo(torch.int64).max
        best = torch.full((n,), big, dtype=torch.long, device=dev)
        best = best.scatter_reduce(0, ray[cand], hs[cand], "amin")
        slot = torch.where(best < big, best, -1)
    return t, slot


def _group_keys(tab, group, n_groups, n_sc, n_cl):
    """Per pair, the group's sort keys: the least sc_tn over the group's
    pairs of that supercluster, and the least cl_tn of that cluster."""
    dev = group.device
    sc = tab["cl"] // K2
    sc_key = torch.full((n_groups * n_sc,), INF, device=dev).scatter_reduce(
        0, group * n_sc + sc, tab["sc_tn"], "amin")
    cl_key = torch.full((n_groups * n_cl,), INF, device=dev).scatter_reduce(
        0, group * n_cl + tab["cl"], tab["cl_tn"], "amin")
    return sc_key[group * n_sc + sc], cl_key[group * n_cl + tab["cl"]]


def _rows(tab, swept, ntri, occlusion):
    """Live rows each swept pair sweeps (B: up to its first blocker)."""
    rows = ntri[tab["cl"]]
    if occlusion:
        rows = torch.where(tab["blk_rows"] >= 0, tab["blk_rows"], rows)
    return torch.where(swept, rows, 0)


def _warp_union(tab, rows, n_cl):
    """32 x the rows the furthest lane sweeps, per (warp, cluster)."""
    key = (tab["ray"] // WARP) * n_cl + tab["cl"]
    uniq, inv = torch.unique(key, return_inverse=True)
    top = torch.zeros(uniq.numel(), dtype=torch.long, device=key.device)
    top = top.scatter_reduce(0, inv, rows.long(), "amax")
    return int(top.sum()) * WARP


def _sc_entered(tab, swept, unit):
    """Distinct (unit, supercluster) pairs with a swept cluster, where
    `unit` is each pair's warp or group."""
    key = unit[swept] * 1_000_003 + (tab["cl"][swept] // K2)
    return int(torch.unique(key).numel())


def walks(tree, o, d, tmax, occlusion: bool = False, lanes_per_ray=1):
    """All the walks of the module docstring over one call's rays, o, d
    [3,N] (N a multiple of 128), tmax [N]. For B pass the NS sets'
    segments concatenated set-major (N = NS x the wavefront) and
    `lanes_per_ray` = the wavefront's size, so that a group spans the
    same 128 lanes of every set. Returns (counts dict, {walk: (t, slot)}
    for A or {walk: blocked} for B)."""
    n = tmax.shape[0]
    tab = pair_table(tree, o, d, tmax, occlusion)
    ntri = live_rows(tree).sum(dim=1)
    n_cl, n_sc = tree.tri_data.shape[0], tree.num_superclusters
    ray = tab["ray"]
    wave = lanes_per_ray if occlusion else n
    group = (ray % wave) // GROUP
    n_groups = max(wave // GROUP, 1)
    counts, ends = {}, {}

    # bound: pairs entered up to the final hit / nearest blocker
    t_fin, _ = final_hit(tab, torch.ones_like(ray, dtype=torch.bool), n)
    t_end = torch.minimum(t_fin, tmax)
    entry = torch.maximum(tab["sc_tn"], tab["cl_tn"])
    in_bound = entry <= t_end[ray]
    counts["bound"] = int(ntri[tab["cl"]][in_bound].sum())

    sc_key, cl_key = _group_keys(tab, group, n_groups, n_sc, n_cl)
    orders = {"ascending": _order(ray, tab["cl"].float()),
              "nearest": _order(ray, tab["cl_tn"]),
              "group_two_level": _order(ray, sc_key, cl_key),
              "group_whole_tree": _order(ray, cl_key)}
    for name, order in orders.items():
        swept = walk(tab, n, tmax, order, occlusion)
        rows = _rows(tab, swept, ntri, occlusion)
        counts[name] = int(rows.sum())
        if name != "nearest":
            counts[name + "_warp"] = _warp_union(tab, rows, n_cl)
        if occlusion:
            blocked = torch.zeros(n, dtype=torch.bool, device=d.device)
            blocked[ray[swept & (tab["blk_rows"] >= 0)]] = True
            ends[name] = blocked
        else:
            ends[name] = final_hit(tab, swept, n)
        if name == "ascending":
            counts["boxes_ascending_warp"] = (
                _sc_entered(tab, swept, ray // WARP) * K2 * WARP)
        if name == "group_two_level":
            sets = n // wave
            counts["boxes_group"] = (_sc_entered(tab, swept, group)
                                     * K2 * GROUP * sets)
    counts["rays"] = n
    counts["live_rays"] = int((tmax > TMIN).sum())
    counts["gated_pairs_at_tmax"] = int(ntri[tab["cl"]].sum())
    return counts, ends


def sample_groups(x, sample: int):
    """Every `sample`-th 128-lane group of a lane-major tensor [..., Nb,
    128], flattened to [..., N']."""
    sel = x[..., ::sample, :]
    return sel.reshape(*x.shape[:-2], -1).contiguous()


def closest_split(tree, o, d, tm, sample: int) -> dict:
    counts, _ = walks(tree, sample_groups(o, sample), sample_groups(d, sample),
                      sample_groups(tm, sample))
    return counts


def occl_split(tree, lp, sd, st, sample: int) -> dict:
    ns = lp.shape[0]
    d = sample_groups(sd, sample)                       # [NS, 3, N']
    tm = sample_groups(st, sample)                      # [NS, N']
    n = tm.shape[1]
    o = lp.T[:, :, None].expand(3, ns, n).reshape(3, ns * n)
    d = d.permute(1, 0, 2).reshape(3, ns * n)
    counts, _ = walks(tree, o.contiguous(), d.contiguous(), tm.reshape(-1),
                      occlusion=True, lanes_per_ray=n)
    return counts


def ratios(c: dict) -> dict:
    b = max(c["bound"], 1)
    return {k: c[k] / b for k in c
            if k not in ("bound", "rays", "live_rays") and
            not k.startswith("boxes")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sample", type=int, default=8,
                    help="keep every N-th 128-lane group")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import RecordingBackend, rot_y, start_camera
    from vkrt_tpu_torch import config as C
    from vkrt_tpu_torch import runtime
    from vkrt_tpu_torch.scene.procedural import procedural_model
    from vkrt_tpu_torch.wavefront.engine import Renderer, render_frame_u8

    dev = torch.device("cuda", 0)
    runtime.exact_f32()
    t0 = time.perf_counter()
    cfg = C.config4_flythrough()
    renderer = Renderer(procedural_model("full", seed=0), cfg, dev,
                        quantize=True)
    r5 = copy.copy(renderer)
    r5.cfg, r5.rebuild = C.config5_stress(), "refit"
    cam = start_camera(cfg.width, cfg.height)
    out = {"sample": args.sample}
    for label, r, m in (("config4", renderer, None),
                        ("config5_refit", r5, rot_y(0.02))):
        backend = r.backend
        if m is not None:
            backend = backend._replace(tree=r.update_tree(m))
        rec = RecordingBackend(backend)
        pi = torch.as_tensor(cam.proj_inverse, device=dev)
        vi = torch.as_tensor(cam.view_inverse, device=dev)
        render_frame_u8(rec, r.tex, pi, vi, r.lights, r.cfg)
        torch.cuda.synchronize()
        tree = backend.tree
        rows = []
        for depth, ((o, d, tm), (lp, sd, st)) in enumerate(
                zip(rec.closest_in, rec.occl_in)):
            a = closest_split(tree, o, d, tm, args.sample)
            b = occl_split(tree, lp, sd, st, args.sample)
            row = {"depth": depth, "A": a, "A_ratio_to_bound": ratios(a),
                   "B": b, "B_ratio_to_bound": ratios(b)}
            print(f"{label} depth {depth}:", json.dumps(row), flush=True)
            rows.append(row)
        out[label] = rows
    out["seconds"] = time.perf_counter() - t0
    print(runtime.nvidia_smi_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
