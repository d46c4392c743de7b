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
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.accel.clusters import K1, K2, ROWS, ClusterTree

TMIN = 0.001          # ref: shaders/shader.rgen:59
_DET_EPS = 1e-12
_N_ATTR = 36
LANES = 128
RAY_CHUNK = 8192      # plain versions: rays gated at a time
PAIR_CHUNK = 16384    # plain versions: (ray, cluster) pairs tested at a time


def _safe_inv(x):
    tiny = 1e-20
    return 1.0 / torch.where(x.abs() < tiny,
                             torch.where(x < 0, -tiny, tiny), x)


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


def _slab(o, inv, lo, hi, t_s):
    """Slab test of R rays (o, inv [3,R], far bound t_s [R]) against B
    boxes (lo, hi [3,B]) → bool [R,B]; the kernels' `slab`."""
    tn = tf = None
    for a in range(3):
        t0 = (lo[a][None, :] - o[a][:, None]) * inv[a][:, None]
        t1 = (hi[a][None, :] - o[a][:, None]) * inv[a][:, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    t_s = t_s[:, None]
    return (tn <= tf) & (tf >= TMIN) & (tn <= t_s) & (t_s > TMIN)


def gated_pairs(tree: ClusterTree, o, d, tmax):
    """Yield (ray index, cluster id) pairs, RAY_CHUNK rays gated at a time
    and at most PAIR_CHUNK pairs per yield (so memory stays bounded at
    any ray count): every cluster whose box, and whose supercluster's box,
    the ray's slab test passes against its own tmax. o, d [3,N], tmax [N].
    The gate is the kernels' own, evaluated with tmax for the far bound
    (the kernels shrink it to the nearest hit so far, which only skips
    clusters that cannot hold a nearer hit)."""
    n_sc = tree.num_superclusters
    inv = _safe_inv(d)
    sc_lo, sc_hi = tree.sc_boxes[0:3, :n_sc], tree.sc_boxes[3:6, :n_sc]
    cl_lo = tree.cl_boxes[:, 0:3, :].permute(1, 0, 2).reshape(3, -1)
    cl_hi = tree.cl_boxes[:, 3:6, :].permute(1, 0, 2).reshape(3, -1)
    valid = cl_lo[0] <= cl_hi[0]                      # padding clusters
    n = tmax.shape[0]
    for r0 in range(0, n, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, n)
        ro, ri, rt = o[:, r0:r1], inv[:, r0:r1], tmax[r0:r1]
        if not bool((rt > TMIN).any()):
            continue
        g_sc = _slab(ro, ri, sc_lo, sc_hi, rt)
        gate = (_slab(ro, ri, cl_lo, cl_hi, rt) & valid[None]
                & g_sc.repeat_interleave(K2, dim=1))
        ray, cl = torch.nonzero(gate, as_tuple=True)
        for p0 in range(0, ray.shape[0], PAIR_CHUNK):
            yield ray[p0:p0 + PAIR_CHUNK] + r0, cl[p0:p0 + PAIR_CHUNK]


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


def trace_dense_plain(tree: ClusterTree, origins, dirs, tmax):
    """Plain PyTorch version of kernel A (same inputs and outputs as
    `trace_dense`). Works through gated (ray, cluster) pairs in chunks,
    so memory stays bounded at any ray count."""
    nb = dirs.shape[1]
    n = nb * LANES
    dev = dirs.device
    o, d, tm = origins.reshape(3, n), dirs.reshape(3, n), tmax.reshape(n)
    geo = tree.tri_data[:, :, 0:9].contiguous()       # [C1p, K1, 9]
    kidx = torch.arange(K1, device=dev)
    rays, ts, slots, us, vs = [], [], [], [], []
    for ray, cl in gated_pairs(tree, o, d, tm):
        det, up, vp, tp = _mt_terms(geo[cl], o[:, ray], d[:, ray])
        adet = det.abs()
        rec = 1.0 / torch.where(det == 0, 1.0, det)
        inv_det = torch.where(adet > _DET_EPS, rec, 0.0)
        uu, vv, tt = up * inv_det, vp * inv_det, tp * inv_det
        ok = ((adet > _DET_EPS) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1)
              & (tt > TMIN) & (tt < tm[ray][:, None]))
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


def trace_occluded_plain(tree: ClusterTree, origins, dirs, tmax):
    """Plain PyTorch version of kernel A' with per-ray origins (same
    inputs as `trace_dense`) → blocked bool[Nb,128]: any gated triangle
    that passes the division-free test blocks the ray. Same arithmetic,
    in the same order, as `occluded_multi_plain`."""
    nb = dirs.shape[1]
    n = nb * LANES
    o, d, tm = origins.reshape(3, n), dirs.reshape(3, n), tmax.reshape(n)
    geo = tree.tri_data[:, :, 0:9].contiguous()
    blocked = torch.zeros(n, dtype=torch.bool, device=dirs.device)
    for ray, cl in gated_pairs(tree, o, d, tm):
        det, up, vp, tp = _mt_terms(geo[cl], o[:, ray], d[:, ray])
        adet = det.abs()
        sgn = torch.where(det < 0, -1.0, 1.0)
        su, sv, st = up * sgn, vp * sgn, tp * sgn
        ok = ((adet > _DET_EPS) & (su >= 0) & (sv >= 0) & (su + sv <= adet)
              & (st > TMIN * adet) & (st < tm[ray][:, None] * adet))
        blocked[ray[ok.any(dim=1)]] = True
    return blocked.reshape(nb, LANES)


def broadcast_points(o_pts, dirs, block: int):
    """[N/block, 3] per-block origin points → full [3,Nb,128] origins."""
    o = o_pts.repeat_interleave(block // LANES, dim=0).T[:, :, None]
    return o.expand(dirs.shape).contiguous()


def _check_rays(what, origins, dirs, tmax, block: int, point_origin: bool):
    """Validate a trace wrapper's ray arguments; returns (device, Nb)."""
    dev = dirs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    nb = dirs.shape[1]
    n = nb * LANES
    if point_origin:
        if block <= 0 or block % LANES or n % block:
            raise ValueError(f"{what}: ray count {n} is not a multiple of "
                             f"block {block} (itself a multiple of {LANES})")
        o_shape = (n // block, 3)
    else:
        o_shape = (3, nb, LANES)
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


def trace_occluded(tree: ClusterTree, origins, dirs, tmax, *,
                   block: int = 512, point_origin: bool = False):
    """Any-hit trace (kernel A' and its wrapper): `trace_dense`'s
    occlusion mode, same ray arguments. Returns (t, slot, u, v), all
    [Nb,128]: slot 1, t = TMIN on a blocked ray, slot -1, t = inf on a
    free one, u = v = 0. A CUDA tensor launches kernel A' and counts it
    in `trace_occluded.launches`; a CPU tensor runs
    `trace_occluded_plain`."""
    dev, nb = _check_rays("trace_occluded", origins, dirs, tmax, block,
                          point_origin)
    if dev.type == "cpu":
        if point_origin:
            origins = broadcast_points(origins, dirs, block)
        blocked = trace_occluded_plain(tree, origins, dirs, tmax)
        zero = torch.zeros(nb, LANES)
        return (torch.where(blocked, TMIN, torch.inf),
                torch.where(blocked, 1, -1).to(torch.int32), zero, zero)
    _check_tree(tree, dev)
    origins, dirs, tmax = (x.contiguous() for x in (origins, dirs, tmax))
    t = torch.empty(nb, LANES, device=dev)
    slot = torch.empty(nb, LANES, dtype=torch.int32, device=dev)
    u = torch.empty(nb, LANES, device=dev)
    v = torch.empty(nb, LANES, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.vkrt_trace_occluded(
            *_kernel_args(tree, origins, block if point_origin else 0, dirs,
                          tmax),
            t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "trace_occluded")
    trace_occluded.launches += 1
    return t, slot, u, v


trace_occluded.launches = 0


def trace_dense(tree: ClusterTree, origins, dirs, tmax, *, block: int = 512,
                occlusion: bool = False, with_attributes: bool = True,
                point_origin: bool = False):
    """Trace rays against the cluster tree (lane-major I/O).

    origins, dirs: f32[3, Nb, 128]; tmax: f32[Nb, 128] (0 = parked ray).
    point_origin=True: the rays of each block of `block` share one origin
    and `origins` is f32[N/block, 3]; N must then be a multiple of
    `block` (a multiple of 128). Returns (t, slot, u, v[, attrs]) — see
    the module docstring. occlusion=True is `trace_occluded` (kernel A').
    Otherwise a CUDA tensor launches kernel A and counts it in
    `trace_dense.launches`; a CPU tensor runs `trace_dense_plain`."""
    if occlusion:
        out = trace_occluded(tree, origins, dirs, tmax, block=block,
                             point_origin=point_origin)
        if with_attributes:
            out += (torch.zeros((_N_ATTR,) + tmax.shape, device=tmax.device),)
        return out
    dev, nb = _check_rays("trace_dense", origins, dirs, tmax, block,
                          point_origin)
    if dev.type == "cpu":
        if point_origin:
            origins = broadcast_points(origins, dirs, block)
        out = trace_dense_plain(tree, origins, dirs, tmax)
        return out if with_attributes else out[:4]
    _check_tree(tree, dev)
    origins, dirs, tmax = (x.contiguous() for x in (origins, dirs, tmax))
    t = torch.empty(nb, LANES, device=dev)
    slot = torch.empty(nb, LANES, dtype=torch.int32, device=dev)
    u = torch.empty(nb, LANES, device=dev)
    v = torch.empty(nb, LANES, device=dev)
    attrs = (torch.empty(_N_ATTR, nb, LANES, device=dev)
             if with_attributes else None)
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.vkrt_trace_closest(
            *_kernel_args(tree, origins, block if point_origin else 0, dirs,
                          tmax),
            t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
            attrs.data_ptr() if with_attributes else None,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "trace_closest")
    trace_dense.launches += 1
    return (t, slot, u, v, attrs) if with_attributes else (t, slot, u, v)


trace_dense.launches = 0
