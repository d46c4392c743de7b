"""Device-side variable-cut SAH cluster order — counterpart of
vkrt_tpu/accel/device_sah.py, with every mode of the JAX function: the
shipped one (binned axis choice, stable sort, one cut per level) and its
ablations (`axis_mode` "extent", "hybrid:N", "sampled:S", "variance",
"slab"; `cuts` > 1; `stable=False`), which measured worse there.

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

The result feeds accel/clusters._assemble. No host wait (no .item(), no
nonzero) in the level loop: the per-frame rebuild calls this every frame,
captured in its CUDA graph. Steps 1-2 are plain PyTorch; steps 3-4, a cut
round, are `cut_round`: on a CUDA tensor kernel H (csrc/sah_cut.cu), one
launch a round, on a CPU tensor its plain version `_cut_round`, bit for
bit the same. The JAX package computes the same passes in XLA, outside
any Pallas kernel.

The JAX function's float sums of products are compiled by XLA on the
CPU into fused multiply-adds. The ablation modes round the same ones
once (`_fma`, fused=True), so that ties between axes or cuts fall alike
(tests/test_torch_device_build.py holds every mode equal to the JAX
order; sampled:8 meets an exact tie there). The shipped mode keeps
float32 products and sums: the per-frame rebuild runs it, and the fused
rounding costs it three float64 casts a product sum.

In the plain `_cut_round` (the CPU path, and the specification kernel H
is held to) the segmented box scans run, as torch has no
associative_scan, as ONE cummin / cummax over int64 keys: segment ids
are monotone along the chunks, so a key of (segment rank << 32 |
order-preserving bits of the f32 value), with the rank falling (cummin)
or rising (cummax) along the scan, confines the running extreme to the
current segment exactly. Kernel H scans the same order-preserving bits
segment by segment.
"""

from __future__ import annotations

import re

import torch

from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.accel.clusters import _INF, K1, K2

NBINS = 16   # axis-choice SAH bins
_MULTI_CUT_LEVELS = 4     # trailing levels that run cuts > 1 rounds a sort
_CEN_BITS = 18            # quantised centroid bits in the composite key
AXIS_MODES = re.compile(r"binned|extent|variance|slab|hybrid:\d+"
                        r"|sampled:\d+")
_M32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _fma(a, b, c, fused: bool):
    """a * b + c: fused, rounded once as XLA's CPU code contracts the JAX
    function's product sums (in float64: the product is exact, the sum
    rounds, then float32); else the float32 product, then the sum."""
    if not fused:
        return a * b + c
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _area(ext, fused: bool):
    """Half the surface area of boxes of extents ext [..., 3] (`_fma`'s
    rounding)."""
    return _fma(ext[..., 2], ext[..., 0],
                _fma(ext[..., 0], ext[..., 1], ext[..., 1] * ext[..., 2],
                     fused), fused)


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


def _first_min(cost):
    """Index of the least of the 3 columns of cost [S,3], the first on a
    tie (as jnp.argmin): strict < from axis 0 on."""
    best = (cost[:, 1] < cost[:, 0]).to(torch.int64)
    return torch.where(cost[:, 2] < torch.minimum(cost[:, 0], cost[:, 1]),
                       2, best)


def _first_max(x):
    """Index of the greatest of the 3 columns of x [S,3], the first on a
    tie (as jnp.argmax)."""
    return _first_min(-x)


def _axis_binned(cen_o, omin, omax, tw, tvalid, lo_c, span_c, sid_c,
                 nbins: int, stride: int, fused: bool):
    """Triangle-granularity binned SAH axis choice per segment (every
    `stride`-th triangle of each chunk: "sampled:S")."""
    nc = cen_o.shape[0]
    dev = cen_o.device
    cen_b, omin_b, omax_b = (x[:, ::stride] for x in (cen_o, omin, omax))
    tval_b, tw_b = tvalid[:, ::stride], tw[:, ::stride]
    bin_t = torch.clamp((cen_b - lo_c[:, None, :]) / span_c[:, None, :]
                        * nbins, 0.0, nbins - 1.0).to(torch.int32)
    bid = torch.arange(nbins, dtype=torch.int32, device=dev)
    bmn_ax, bmx_ax, bct_ax = [], [], []
    for ax in range(3):
        oh = (bin_t[..., ax][..., None] == bid) & tval_b[..., None]
        bmn_ax.append(torch.where(oh[..., None], omin_b[:, :, None, :], _INF)
                      .amin(dim=1))                              # [Nc,NB,3]
        bmx_ax.append(torch.where(oh[..., None], omax_b[:, :, None, :],
                                  -_INF).amax(dim=1))
        bct_ax.append((oh * tw_b[..., None]).sum(dim=1))         # [Nc,NB]
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
    a_l = _area(torch.clamp(pmx - pmn, min=0.0), fused)          # [S,3,NB]
    a_r = _area(torch.clamp(smx - smn, min=0.0), fused)
    # cut AFTER bin b: left = prefix[b], right = suffix[b+1]
    cost = _fma(a_l[:, :, :-1], pct[:, :, :-1],
                a_r[:, :, 1:] * sct[:, :, 1:], fused)
    cost = torch.where((pct[:, :, :-1] > 0) & (sct[:, :, 1:] > 0), cost,
                       _INF)
    return _first_min(cost.amin(dim=2))


def _axis_chunks(omin, omax, ccnt, lo_c, span_c, sid_c, nbins: int,
                 fused: bool):
    """Chunk-granularity binned SAH axis choice ("hybrid:N" after its
    first N levels): the [Nc] chunk boxes binned by their centres."""
    nc = omin.shape[0]
    cmin, cmax = omin.amin(dim=1), omax.amax(dim=1)              # [Nc,3]
    nonempty = ccnt > 0
    ccen = torch.where(nonempty[:, None], (cmin + cmax) * 0.5, _INF)
    bin_c = torch.clamp((ccen - lo_c) / span_c * nbins, 0.0,
                        nbins - 1.0).to(torch.int32)             # [Nc,3]
    costs = []
    for ax in range(3):
        bmn, bmx, bct = [], [], []
        for b in range(nbins):
            m = nonempty & (bin_c[:, ax] == b)
            bmn.append(_segment_reduce(torch.where(m[:, None], cmin, _INF),
                                       sid_c, nc, "amin", torch.inf))
            bmx.append(_segment_reduce(torch.where(m[:, None], cmax, -_INF),
                                       sid_c, nc, "amax", -torch.inf))
            bct.append(_segment_reduce(torch.where(m, ccnt, 0.0), sid_c, nc,
                                       "sum", 0.0))
        bmn, bmx = torch.stack(bmn, dim=1), torch.stack(bmx, dim=1)
        bct = torch.stack(bct, dim=1)                            # [S,NB]
        pmn = torch.cummin(bmn, dim=1).values
        pmx = torch.cummax(bmx, dim=1).values
        pct = torch.cumsum(bct, dim=1)
        smn = torch.cummin(bmn.flip(1), dim=1).values.flip(1)
        smx = torch.cummax(bmx.flip(1), dim=1).values.flip(1)
        sct = torch.cumsum(bct.flip(1), dim=1).flip(1)
        a_l = _area(torch.clamp(pmx - pmn, min=0.0), fused)
        a_r = _area(torch.clamp(smx - smn, min=0.0), fused)
        cost = a_l[:, :-1] * pct[:, :-1] + a_r[:, 1:] * sct[:, 1:]
        costs.append(torch.where((pct[:, :-1] > 0) & (sct[:, 1:] > 0), cost,
                                 _INF).amin(dim=1))
    return _first_min(torch.stack(costs, dim=1))


def _axis_slab(cen_o, tw, tvalid, lo_c, span_c, smin, smax, sid_c,
               nbins: int):
    """Counts-only binned SAH ("slab"): a bin side's box is its occupied
    bins' slab along the axis by the segment's extents on the other
    two."""
    nc = cen_o.shape[0]
    dev = cen_o.device
    bid = torch.arange(nbins, dtype=torch.int32, device=dev)
    bin_t = torch.clamp((cen_o - lo_c[:, None, :]) / span_c[:, None, :]
                        * nbins, 0.0, nbins - 1.0).to(torch.int32)
    ext = torch.clamp(smax - smin, min=1e-12)                    # [S,3]
    costs = []
    for ax in range(3):
        oh = (bin_t[..., ax][..., None] == bid) & tvalid[..., None]
        bct = _segment_reduce((oh * tw[..., None]).sum(dim=1), sid_c, nc,
                              "sum", 0.0)                        # [S,NB]
        occ = bct > 0
        pmax = torch.cummax(torch.where(occ, bid, -1), dim=1).values
        smin_b = torch.cummin(torch.where(occ, bid, nbins).flip(1),
                              dim=1).values.flip(1)
        pct = torch.cumsum(bct, dim=1)
        tot = pct[:, -1:]
        unit = ext[:, ax:ax + 1] / ext.new_full((), nbins)   # as `cen`
        e_l = (pmax[:, :-1].to(torch.float32) + 1.0) * unit
        e_r = (nbins - smin_b[:, 1:].to(torch.float32)) * unit
        o1 = ext[:, (ax + 1) % 3][:, None]
        o2 = ext[:, (ax + 2) % 3][:, None]
        a_l = e_l * o1 + o1 * o2 + o2 * e_l
        a_r = e_r * o1 + o1 * o2 + o2 * e_r
        n_l = pct[:, :-1]
        n_r = tot - n_l
        costs.append(torch.where((n_l > 0) & (n_r > 0),
                                 a_l * n_l + a_r * n_r, _INF).amin(dim=1))
    return _first_min(torch.stack(costs, dim=1))


def _axis_variance(cen_o, tvalid, ccnt, lo_c, sid_c):
    """Largest weighted centroid variance per segment ("variance"),
    centred on the segment's least centroid."""
    nc = cen_o.shape[0]
    cen_rel = torch.where(tvalid[..., None], cen_o - lo_c[:, None, :], 0.0)
    s1 = _segment_reduce(cen_rel.sum(dim=1), sid_c, nc, "sum", 0.0)
    s2 = _segment_reduce((cen_rel * cen_rel).sum(dim=1), sid_c, nc, "sum",
                         0.0)
    cnt = torch.clamp(_segment_reduce(ccnt, sid_c, nc, "sum", 0.0), min=1.0)
    mean = s1 / cnt[:, None]
    return _first_max(s2 / cnt[:, None] - mean * mean)


def _cut_round(cb, nmin, nmax, ncnt, fused: bool):
    """One cut round over the sorted order: chunk-granular segmented
    prefix / suffix box scans, exact SAH at every K1-aligned cut (K1*K2-
    aligned while a segment exceeds a supercluster), and each segment's
    best cut (its lowest chunk index at the minimum) as a new boundary.
    The plain PyTorch version of kernel H (`cut_round`)."""
    nc = cb.shape[0]
    dev = cb.device
    iota_c = torch.arange(nc, device=dev)
    sid_c = torch.cumsum(cb.to(torch.int64), dim=0) - 1
    seg_start = torch.cummax(torch.where(cb, iota_c, 0), dim=0).values
    off = iota_c - seg_start
    nxt = torch.full((nc,), nc, device=dev)
    nxt[:-1] = torch.where(cb, iota_c, nc)[1:]
    nxt = torch.cummin(nxt.flip(0), dim=0).values.flip(0)
    seg_len = nxt - seg_start                                    # chunks
    pmn, pmx, pct = _seg_scan_box(sid_c, nmin, nmax, ncnt)
    smn, smx, sct = _seg_scan_box(sid_c, nmin, nmax, ncnt, reverse=True)

    align = torch.where(seg_len > K2, K2, 1)
    cost_l = _area(torch.clamp(pmx - pmn, min=0.0), fused) * pct  # at k-1
    cost_r = _area(torch.clamp(smx - smn, min=0.0), fused) * sct  # at k
    cost_l_prev = torch.cat([cost_l.new_full((1,), _INF), cost_l[:-1]])
    pct_prev = torch.cat([pct.new_zeros(1), pct[:-1]])
    # a valid cut is aligned AND leaves real triangles on BOTH sides
    valid_cut = ((off > 0) & (off % align == 0) & (pct_prev > 0)
                 & (sct > 0))
    cut_cost = torch.where(valid_cut, cost_l_prev + cost_r, _INF)
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
    return cb | (bits > 0)


def _check_cut(cb, nmin, nmax, ncnt):
    """Raise unless cb is bool[Nc], nmin / nmax f32[Nc,3] and ncnt f32[Nc],
    all contiguous on cb's device (what kernel H takes)."""
    nc = cb.shape[0] if cb.dim() == 1 else -1
    if (cb.dtype != torch.bool or nc < 0
            or any(t.dtype != torch.float32 for t in (nmin, nmax, ncnt))
            or nmin.shape != (nc, 3) or nmax.shape != (nc, 3)
            or ncnt.shape != (nc,)):
        raise ValueError(
            f"cut_round: want bool[Nc], f32[Nc,3], f32[Nc,3], f32[Nc], got "
            + ", ".join(f"{t.dtype}{tuple(t.shape)}"
                        for t in (cb, nmin, nmax, ncnt)))
    for t in (nmin, nmax, ncnt, cb):
        if t.device != cb.device or not t.is_contiguous():
            raise ValueError(f"cut_round: inputs must be contiguous on "
                             f"{cb.device}")


def cut_round(cb, nmin, nmax, ncnt, fused: bool):
    """One cut round: cb bool[Nc] segment heads (cb[0] set), the sorted
    order's chunk boxes nmin / nmax f32[Nc,3] (finite, or the padding's
    +-_INF) and triangle counts ncnt f32[Nc] (whole numbers, sum below
    2^24) → cb with each segment's best cut added (`_cut_round`).
    A CUDA tensor launches kernel H (csrc/sah_cut.cu) and counts it in
    `cut_round.launches`; a CPU tensor runs `_cut_round`."""
    _check_cut(cb, nmin, nmax, ncnt)
    dev = cb.device
    if dev.type == "cpu":
        return _cut_round(cb, nmin, nmax, ncnt, fused)
    if dev.type != "cuda":
        raise ValueError(f"cut_round: unsupported device {dev}")
    nc = cb.shape[0]
    out = torch.empty_like(cb)
    scratch = torch.empty(3 * nc, dtype=torch.int32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_sah_cut(cb.data_ptr(), nmin.data_ptr(),
                               nmax.data_ptr(), ncnt.data_ptr(), nc, K2,
                               _INF, int(fused), scratch.data_ptr(),
                               out.data_ptr(), stream)
    kernels.check(err, "cut_round")
    cut_round.launches += 1
    return out


cut_round.launches = 0


def _level(S, cb, nbins: int, axis_mode: str = "binned",
           tri_bins: bool = True, n_cuts: int = 1, stable: bool = True,
           fused: bool = False):
    """One level: S f32[Tp,11] packed carry in current order (cen | tmin |
    tmax | weight | original index), cb bool[Nc] segment-start bits →
    (S in the new order, cb with each segment's best cut added, `n_cuts`
    rounds: the later ones cut each child along its parent's axis without
    a new sort). `axis_mode` as device_sah_order's; tri_bins=False bins
    chunk boxes ("hybrid:N" after its first N levels); `fused`: `_fma`'s
    rounding."""
    tp = S.shape[0]
    nc = tp // K1
    cen_s, w_s = S[:, 0:3], S[:, 9]
    sid_c = torch.cumsum(cb.to(torch.int64), dim=0) - 1          # [Nc]

    # --- 1. axis choice per segment --------------------------------------
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
    if axis_mode == "extent":
        best_ax = _first_max(smax - smin)
    elif axis_mode == "slab":
        best_ax = _axis_slab(cen_o, tw, tvalid, lo_c, span_c, smin, smax,
                             sid_c, nbins)
    elif axis_mode == "variance":
        best_ax = _axis_variance(cen_o, tvalid, tw.sum(dim=1), lo_c, sid_c)
    elif not tri_bins:
        best_ax = _axis_chunks(omin, omax, tw.sum(dim=1), lo_c, span_c,
                               sid_c, nbins, fused)
    else:
        stride = (int(axis_mode.split(":")[1])
                  if axis_mode.startswith("sampled") else 1)
        best_ax = _axis_binned(cen_o, omin, omax, tw, tvalid, lo_c, span_c,
                               sid_c, nbins, stride, fused)

    # --- 2. ONE sort by (segment, centroid on the chosen axis) -----------
    ax_c = best_ax[sid_c][:, None]                               # [Nc,1]
    key_cen = cen_o.gather(2, ax_c[:, :, None].expand(nc, K1, 1))[..., 0]
    lo_t = lo_c.gather(1, ax_c)
    span_t = span_c.gather(1, ax_c)
    qmax = (1 << _CEN_BITS) - 1
    q = torch.clamp((key_cen - lo_t) / span_t * qmax, 0.0, float(qmax))
    # dead padding sorts to its segment's tail
    q = torch.where(tvalid, q.to(torch.int64), qmax)
    key = ((sid_c << _CEN_BITS)[:, None] | q).reshape(tp)
    pos_new = torch.sort(key, stable=stable).indices
    # ONE wide-row gather applies the level's permutation to the carry
    S_new = S[pos_new]

    # --- 3-4. exact SAH over the sorted order, `n_cuts` rounds -----------
    nmin = S_new[:, 3:6].reshape(nc, K1, 3).amin(dim=1)
    nmax = S_new[:, 6:9].reshape(nc, K1, 3).amax(dim=1)
    ncnt = S_new[:, 9].reshape(nc, K1).sum(dim=1)
    for _ in range(n_cuts):
        cb = cut_round(cb, nmin, nmax, ncnt, fused)
    return S_new, cb


def device_sah_order(v0, e1, e2, max_levels: int = 14,
                     axis_mode: str = "binned", stable: bool = True,
                     cuts: int = 1, nbins: int = NBINS):
    """Device variable-cut SAH triangle permutation.

    v0/e1/e2 f32[T,3] torch tensors on one device. Returns i32[T], a
    permutation of 0..T-1 whose consecutive K1-runs are the clusters.
    One sort + segmented scans per level. axis_mode: "binned" (shipped),
    "extent" (largest centroid extent), "hybrid:N" (triangle bins for the
    first N levels, chunk bins after), "sampled:S" (every S-th triangle
    of a chunk binned), "variance" (largest centroid variance), "slab"
    (counts-only bins); `cuts` > 1 runs that many cut rounds a sort on
    the last 4 levels; `stable=False` sorts without keeping the order of
    equal keys (which neither package defines). The JAX function's modes;
    every one but the shipped one rounds its product sums as XLA on the
    CPU contracts them (see the module docstring)."""
    if not AXIS_MODES.fullmatch(axis_mode):
        raise ValueError(
            f"axis_mode {axis_mode!r} invalid: expected 'binned', 'extent', "
            f"'variance', 'slab', 'hybrid:N' or 'sampled:S' (N/S integers)")
    T = v0.shape[0]
    tp = -(-T // K1) * K1
    pad = tp - T
    dev = v0.device

    p1, p2 = v0 + e1, v0 + e2
    tmin = torch.minimum(torch.minimum(v0, p1), p2)
    tmax = torch.maximum(torch.maximum(v0, p1), p2)
    # a tensor divisor: on CUDA, PyTorch divides by a Python number as a
    # product with its reciprocal, which rounds 1/3 and so parts from the
    # CPU's quotient (and the JAX order's) in the last bit
    cen = v0 + (e1 + e2) / v0.new_full((), 3.0)
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
    # one segment: the first chunk starts it (a comparison, not an item
    # store, whose host-side scalar a CUDA graph capture refuses)
    cb = torch.arange(tp // K1, device=dev) == 0
    if axis_mode.startswith("hybrid"):
        n_tri = min(int(axis_mode.split(":")[1]), max_levels)
        plan = [dict(tri_bins=k < n_tri) for k in range(max_levels)]
    elif cuts > 1:
        n_single = max(max_levels - _MULTI_CUT_LEVELS, 0)
        plan = [dict(n_cuts=1 if k < n_single else cuts)
                for k in range(max_levels)]
    else:
        plan = [{}] * max_levels
    fused = not (axis_mode == "binned" and cuts == 1 and stable)
    for kw in plan:
        S, cb = _level(S, cb, nbins, axis_mode, stable=stable, fused=fused,
                       **kw)
    order = S[:, 10].to(torch.int32)
    if pad:
        # strip padding slots, preserving order (stable compaction)
        order = order[torch.sort((order >= T).to(torch.int8),
                                 stable=True).indices][:T]
    return order
