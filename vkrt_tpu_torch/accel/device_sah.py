"""Device-side variable-cut SAH cluster order — counterpart of
vkrt_tpu/accel/device_sah.py, its shipped mode (binned axis choice,
stable sort, one cut per level).

The host build's recursion (accel/clusters.split_permutation: triangle
granularity, variable K1-aligned cuts) as fixed-shape batched passes on
the tensors' device, every level processing ALL current segments at once:

  1. per-segment axis choice from an nbins-binned SAH estimate at
     triangle granularity (per-chunk bin tables, then a segment reduce);
  2. ONE stable sort of all triangles by (segment, quantised centroid
     along the segment's axis) and ONE gather of the packed carry;
  3. chunk-granular segmented prefix/suffix AABB scans over the sorted
     order, exact SAH at every K1-aligned cut (K1*K2-aligned while the
     segment exceeds a supercluster, so superclusters stay subtrees);
  4. each segment's best cut becomes one new boundary bit.

The result feeds accel/clusters._assemble. Plain PyTorch with no host
wait (no .item(), no nonzero) in the level loop: the per-frame rebuild
calls this every frame. The JAX package computes the same passes in XLA,
outside any Pallas kernel.

torch has no associative_scan, so the segmented box scans run as ONE
cummin / cummax over int64 keys: segment ids are monotone along the
chunks, so a key of (segment rank << 32 | order-preserving bits of the
f32 value), with the rank falling (cummin) or rising (cummax) along the
scan, confines the running extreme to the current segment exactly.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch.accel.clusters import _INF, K1, K2

NBINS = 16   # axis-choice SAH bins
_CEN_BITS = 18            # quantised centroid bits in the composite key
_M32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _area(ext):
    return (ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2]
            + ext[..., 2] * ext[..., 0])


def _ordered_bits(x):
    """f32 → int64 in [0, 2^32) whose integer order is the float order."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where(b >= _SIGN, ~b & _M32, b | _SIGN)


def _from_ordered_bits(u):
    b = torch.where(u >= _SIGN, u & (_SIGN - 1), ~u & _M32)
    return b.to(torch.int32).view(torch.float32)   # wraps to the same bits


def _seg_scan_box(sid, bmin, bmax, cnt, reverse: bool = False):
    """Segmented inclusive scan of AABB union + count over chunks: sid
    i64[Nc] nondecreasing segment ids, bmin/bmax f32[Nc,3], cnt f32[Nc]
    (whole numbers). reverse=True scans each segment from its end."""
    nc = sid.shape[0]
    if reverse:
        sid, bmin, bmax, cnt = (x.flip(0) for x in (sid, bmin, bmax, cnt))
    # the rank must fall along the scan for cummin, rise for cummax
    fall, rise = (sid, nc - sid) if reverse else (nc - sid, sid)
    mn = torch.cummin((fall << 32)[:, None] | _ordered_bits(bmin),
                      dim=0).values
    mx = torch.cummax((rise << 32)[:, None] | _ordered_bits(bmax),
                      dim=0).values
    mn, mx = _from_ordered_bits(mn & _M32), _from_ordered_bits(mx & _M32)
    # count: running sum minus the sum before the segment's first chunk
    cs = torch.cumsum(cnt.to(torch.float64), dim=0)
    first = torch.ones(nc, dtype=torch.bool, device=sid.device)
    first[1:] = sid[1:] != sid[:-1]
    iota = torch.arange(nc, device=sid.device)
    start = torch.cummax(torch.where(first, iota, 0), dim=0).values
    ct = (cs - (cs - cnt)[start]).to(torch.float32)
    if reverse:
        mn, mx, ct = mn.flip(0), mx.flip(0), ct.flip(0)
    return mn, mx, ct


def _segment_reduce(src, sid, nseg: int, reduce: str, empty: float):
    """Per-segment reduction over dim 0 of src [Nc, ...] → [nseg, ...];
    segments without a chunk read `empty`."""
    flat = src.reshape(src.shape[0], -1)
    out = torch.full((nseg, flat.shape[1]), empty, dtype=src.dtype,
                     device=src.device)
    out = out.scatter_reduce(0, sid[:, None].expand_as(flat), flat, reduce,
                             include_self=True)
    return out.reshape((nseg,) + src.shape[1:])


def _level(S, cb, nbins: int):
    """One level: S f32[Tp,11] packed carry in current order (cen | tmin |
    tmax | weight | original index), cb bool[Nc] segment-start bits →
    (S in the new order, cb with each segment's best cut added)."""
    tp = S.shape[0]
    nc = tp // K1
    dev = S.device
    cen_s, w_s = S[:, 0:3], S[:, 9]
    iota_c = torch.arange(nc, device=dev)
    sid_c = torch.cumsum(cb.to(torch.int64), dim=0) - 1          # [Nc]

    # --- 1. axis choice per segment (triangle-granularity binned SAH) ----
    cen_o = cen_s.reshape(nc, K1, 3)
    omin = S[:, 3:6].reshape(nc, K1, 3)
    omax = S[:, 6:9].reshape(nc, K1, 3)
    tw = w_s.reshape(nc, K1)
    tvalid = tw > 0
    smin = _segment_reduce(torch.where(tvalid[..., None], cen_o, _INF)
                           .amin(dim=1), sid_c, nc, "amin", torch.inf)
    smax = _segment_reduce(torch.where(tvalid[..., None], cen_o, -_INF)
                           .amax(dim=1), sid_c, nc, "amax", -torch.inf)
    lo_c = smin[sid_c]                                           # [Nc,3]
    span_c = torch.clamp(smax[sid_c] - lo_c, min=1e-12)
    bin_t = torch.clamp((cen_o - lo_c[:, None, :]) / span_c[:, None, :]
                        * nbins, 0.0, nbins - 1.0).to(torch.int32)
    bid = torch.arange(nbins, dtype=torch.int32, device=dev)
    bmn_ax, bmx_ax, bct_ax = [], [], []
    for ax in range(3):
        oh = (bin_t[..., ax][..., None] == bid) & tvalid[..., None]
        bmn_ax.append(torch.where(oh[..., None], omin[:, :, None, :], _INF)
                      .amin(dim=1))                              # [Nc,NB,3]
        bmx_ax.append(torch.where(oh[..., None], omax[:, :, None, :], -_INF)
                      .amax(dim=1))
        bct_ax.append((oh * tw[..., None]).sum(dim=1))           # [Nc,NB]
    bmn = _segment_reduce(torch.stack(bmn_ax, dim=1), sid_c, nc, "amin",
                          torch.inf)                             # [S,3,NB,3]
    bmx = _segment_reduce(torch.stack(bmx_ax, dim=1), sid_c, nc, "amax",
                          -torch.inf)
    pct = torch.cumsum(_segment_reduce(torch.stack(bct_ax, dim=1), sid_c,
                                       nc, "sum", 0.0), dim=2)   # [S,3,NB]
    pmn = torch.cummin(bmn, dim=2).values
    pmx = torch.cummax(bmx, dim=2).values
    smn = torch.cummin(bmn.flip(2), dim=2).values.flip(2)
    smx = torch.cummax(bmx.flip(2), dim=2).values.flip(2)
    tot = pct[:, :, -1:]
    sct = tot - torch.cat([torch.zeros_like(tot), pct[:, :, :-1]], dim=2)
    a_l = _area(torch.clamp(pmx - pmn, min=0.0))                 # [S,3,NB]
    a_r = _area(torch.clamp(smx - smn, min=0.0))
    # cut AFTER bin b: left = prefix[b], right = suffix[b+1]
    cost = a_l[:, :, :-1] * pct[:, :, :-1] + a_r[:, :, 1:] * sct[:, :, 1:]
    cost = torch.where((pct[:, :, :-1] > 0) & (sct[:, :, 1:] > 0), cost,
                       _INF)
    # first minimum wins, as jnp.argmin: axes 0, 1, 2 in turn, strict <
    cmin = cost.amin(dim=2)                                      # [S,3]
    best_ax = ((cmin[:, 1] < cmin[:, 0]).to(torch.int64))
    best_ax = torch.where(cmin[:, 2] < torch.minimum(cmin[:, 0], cmin[:, 1]),
                          2, best_ax)

    # --- 2. ONE stable sort by (segment, centroid on the chosen axis) ----
    ax_c = best_ax[sid_c][:, None]                               # [Nc,1]
    key_cen = cen_o.gather(2, ax_c[:, :, None].expand(nc, K1, 1))[..., 0]
    lo_t = lo_c.gather(1, ax_c)
    span_t = span_c.gather(1, ax_c)
    qmax = (1 << _CEN_BITS) - 1
    q = torch.clamp((key_cen - lo_t) / span_t * qmax, 0.0, float(qmax))
    # dead padding sorts to its segment's tail
    q = torch.where(tvalid, q.to(torch.int64), qmax)
    key = ((sid_c << _CEN_BITS)[:, None] | q).reshape(tp)
    pos_new = torch.sort(key, stable=True).indices
    # ONE wide-row gather applies the level's permutation to the carry
    S_new = S[pos_new]

    # --- 3. exact SAH over the sorted order (chunk granularity) ----------
    nmin = S_new[:, 3:6].reshape(nc, K1, 3).amin(dim=1)
    nmax = S_new[:, 6:9].reshape(nc, K1, 3).amax(dim=1)
    ncnt = S_new[:, 9].reshape(nc, K1).sum(dim=1)
    seg_start = torch.cummax(torch.where(cb, iota_c, 0), dim=0).values
    off = iota_c - seg_start
    nxt = torch.full((nc,), nc, device=dev)
    nxt[:-1] = torch.where(cb, iota_c, nc)[1:]
    nxt = torch.cummin(nxt.flip(0), dim=0).values.flip(0)
    seg_len = nxt - seg_start                                    # chunks
    pmn, pmx, pct = _seg_scan_box(sid_c, nmin, nmax, ncnt)
    smn, smx, sct = _seg_scan_box(sid_c, nmin, nmax, ncnt, reverse=True)

    align = torch.where(seg_len > K2, K2, 1)
    cost_l = _area(torch.clamp(pmx - pmn, min=0.0)) * pct        # at k-1
    cost_r = _area(torch.clamp(smx - smn, min=0.0)) * sct        # at k
    cost_l_prev = torch.cat([cost_l.new_full((1,), _INF), cost_l[:-1]])
    pct_prev = torch.cat([pct.new_zeros(1), pct[:-1]])
    # a valid cut is aligned AND leaves real triangles on BOTH sides
    valid_cut = ((off > 0) & (off % align == 0) & (pct_prev > 0)
                 & (sct > 0))
    cut_cost = torch.where(valid_cut, cost_l_prev + cost_r, _INF)

    # --- 4. per-segment best cut: the lowest chunk index at the minimum --
    best_cost = _segment_reduce(cut_cost, sid_c, nc, "amin", torch.inf)
    is_best = ((cut_cost == best_cost[sid_c]) & valid_cut
               & (best_cost[sid_c] < _INF))
    first_best = _segment_reduce(torch.where(is_best, iota_c, nc), sid_c, nc,
                                 "amin", nc)
    # scatter-MAX: unused segment slots all point at Nc-1 with value 0
    # and must not clear a genuine bit there
    bits = torch.zeros(nc, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.clamp(first_best, 0, nc - 1),
        (first_best < nc).to(torch.int64), "amax", include_self=True)
    return S_new, cb | (bits > 0)


def device_sah_order(v0, e1, e2, max_levels: int = 14,
                     axis_mode: str = "binned", stable: bool = True,
                     cuts: int = 1, nbins: int = NBINS):
    """Device variable-cut SAH triangle permutation.

    v0/e1/e2 f32[T,3] torch tensors on one device. Returns i32[T], a
    permutation of 0..T-1 whose consecutive K1-runs are the clusters.
    One stable sort + segmented scans per level. Only the shipped mode is
    ported: any other `axis_mode`, `cuts` > 1 or `stable=False` raises
    NotImplementedError naming ROADMAP.md queue 1 item 13 (item 15 lists
    them, still to port: ablations that measured worse)."""
    if axis_mode != "binned" or cuts != 1 or not stable:
        raise NotImplementedError(
            f"device_sah_order(axis_mode={axis_mode!r}, cuts={cuts}, "
            f"stable={stable}): only axis_mode='binned', cuts=1, "
            "stable=True is ported (ROADMAP.md queue 1 item 13: the other "
            "modes are ablations that measured worse)")
    T = v0.shape[0]
    tp = -(-T // K1) * K1
    pad = tp - T
    dev = v0.device

    p1, p2 = v0 + e1, v0 + e2
    tmin = torch.minimum(torch.minimum(v0, p1), p2)
    tmax = torch.maximum(torch.maximum(v0, p1), p2)
    cen = v0 + (e1 + e2) / 3.0
    w = torch.ones(T, 1, device=dev)
    S = torch.cat([cen, tmin, tmax, w], dim=1)
    if pad:             # padding rows: cen, tmin = INF, tmax = -INF, w = 0
        S = torch.cat([S, torch.cat([S.new_full((pad, 6), _INF),
                                     S.new_full((pad, 3), -_INF),
                                     S.new_zeros((pad, 1))], dim=1)])
    # packed carry: cen | tmin | tmax | w | original index (exact in f32
    # for Tp < 2**24)
    if tp >= 1 << 24:
        raise ValueError(f"device_sah_order: {T} triangles exceed 2^24")
    S = torch.cat([S, torch.arange(tp, dtype=torch.float32,
                                   device=dev)[:, None]], dim=1)  # [Tp,11]
    cb = torch.zeros(tp // K1, dtype=torch.bool, device=dev)
    cb[0] = True
    for _ in range(max_levels):
        S, cb = _level(S, cb, nbins)
    order = S[:, 10].to(torch.int32)
    if pad:
        # strip padding slots, preserving order (stable compaction)
        order = order[torch.sort((order >= T).to(torch.int8),
                                 stable=True).indices][:T]
    return order
