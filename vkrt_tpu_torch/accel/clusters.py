"""Cluster tree — counterpart of vkrt_tpu/accel/clusters.py.

Two builds of the same layout. The host build is the JAX package's numpy
code (`split_permutation`, `_assemble_host`, `scene_attrs`), ending in
torch tensors instead of jax arrays, so trees are byte-equal between the
two packages; the JAX module imports jax at its top, so the numpy code
is carried here as a copy. The device build (`build_clusters` on torch
tensors: the per-frame rebuild) orders the triangles on the tensors'
device — `device_sah_order` or a Morton argsort — and packs them with
`_assemble`, plain torch with no host wait.

Layout (see vkrt_tpu/accel/clusters.py for the column table):
  sc_boxes  f32[8, C2p]      supercluster AABBs, rows 0-2 min, 3-5 max
  cl_boxes  f32[C2, 8, K2]   per-supercluster cluster AABBs
  tri_data  f32[C1p, K1, ROWS] per-triangle rows: cols 0-8 v0/e1/e2,
                             9-35 shading attributes, 40-45 sub-run boxes
  leaf_tri  i32[Tp]          slot → original triangle id (-1 = padding)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.scene.textures import material_slots

K1 = 128      # triangles per cluster
K2 = 64       # clusters per supercluster
SUBRUNS = 8   # 16-tri sub-run AABBs per cluster (cols SUB_COL..SUB_COL+5)
SUB_COL = 40
ROWS = 128    # columns per triangle row (36 attributes + pad)

_INF = 3.0e38
AREA_SCALE = 1 << 16   # cluster_area_fixed's unit: 1/2^16 squared world units


class ClusterTree(NamedTuple):
    sc_boxes: torch.Tensor   # f32[8, C2p]
    cl_boxes: torch.Tensor   # f32[C2, 8, K2]
    tri_data: torch.Tensor   # f32[C1p, K1, ROWS]
    leaf_tri: torch.Tensor   # i32[Tp]

    @property
    def num_clusters(self) -> int:
        return int(self.tri_data.shape[0])

    @property
    def num_superclusters(self) -> int:
        return int(self.cl_boxes.shape[0])


def tree_from_numpy(sc_boxes, cl_boxes, tri_data, leaf_tri,
                    device) -> ClusterTree:
    """A ClusterTree on `device` from numpy arrays in the shared layout —
    how a tree built by the JAX package (or saved from one) is carried
    across. k1 is read from tri_data and must be K1."""
    tri_data = np.asarray(tri_data, np.float32)
    if tri_data.ndim != 3 or tri_data.shape[1] != K1 \
            or tri_data.shape[2] != ROWS:
        raise ValueError(f"tri_data must be [C1p, {K1}, {ROWS}], got "
                         f"{tri_data.shape}")

    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    return ClusterTree(sc_boxes=put(sc_boxes, np.float32),
                       cl_boxes=put(cl_boxes, np.float32),
                       tri_data=put(tri_data, np.float32),
                       leaf_tri=put(leaf_tri, np.int32))


def build_clusters(v0, e1, e2, attrs=None, with_attributes: bool = False,
                   device="cuda", method: str = "split", aabb=None,
                   sah_opts: dict | None = None) -> ClusterTree:
    """Build the cluster tree.

    numpy inputs with method="split" (the default): the static host build
    (the JAX package's `device=False, method="split"`), moved to torch
    `device` when done: the card unless the caller asks for the CPU.

    torch tensors (or method "sah" / "morton"): the device build on the
    tensors' device (numpy inputs go to `device` first), the per-frame
    rebuild path. method="sah" or "split" orders with
    accel/device_sah.device_sah_order (`sah_opts` forwards its keywords:
    max_levels, nbins, axis_mode, cuts, stable), method="morton" with
    one stable argsort of 30-bit Morton codes quantised inside
    `aabb=(lo, hi)` (the centroids' own bounds if omitted; conservative
    bounds are fine). `attrs` then holds tensors
    (or arrays) keyed as `scene_attrs`. The order step runs in the span
    `accel_order` (tracing.py)."""
    if method not in ("split", "sah", "morton"):
        raise ValueError(f"build_clusters: unknown method {method!r}")
    on_host = not isinstance(v0, torch.Tensor)
    if on_host and method == "split":
        v0, e1, e2 = (np.asarray(a, np.float32) for a in (v0, e1, e2))
        order = split_permutation(v0, e1, e2)
        return tree_from_numpy(*_assemble_host(v0, e1, e2, order, attrs,
                                               with_attributes),
                               device=device)
    dev = torch.device(device) if on_host else v0.device

    def put(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    v0, e1, e2 = put(v0), put(e1), put(e2)
    if attrs is not None:
        attrs = {k: put(x) for k, x in attrs.items()}
    with tracing.span("accel_order", dev):
        if method == "morton":
            from vkrt_tpu_torch.accel.lbvh import morton30
            # a tensor divisor, as in device_sah.py: on CUDA a Python
            # number divides as a product with its rounded reciprocal
            cen = v0 + (e1 + e2) / v0.new_full((), 3.0)
            lo, hi = ((cen.amin(dim=0), cen.amax(dim=0)) if aabb is None
                      else (put(aabb[0]), put(aabb[1])))
            order = torch.argsort(morton30(cen, lo, hi), stable=True)
        else:
            from vkrt_tpu_torch.accel.device_sah import device_sah_order
            order = device_sah_order(v0, e1, e2, **(sah_opts or {}))
    return _assemble(v0, e1, e2, order, attrs, with_attributes)


def cluster_area_fixed(cl_boxes):
    """The summed surface area of a tree's cluster boxes (cl_boxes
    f32[C2,8,K2]; a padding cluster's inverted box counts 0) as an int64
    0-dim tensor in units of 1/AREA_SCALE squared world units: each box's
    area, in float64, is rounded to that unit before the sum, so the sum
    is exact and the same on any device. No host wait."""
    b = cl_boxes.to(torch.float64)
    ext = b[:, 3:6, :] - b[:, 0:3, :]
    ext = torch.where((ext >= 0).all(dim=1, keepdim=True), ext, 0.0)
    x, y, z = ext[:, 0], ext[:, 1], ext[:, 2]
    area = (x * y + y * z + z * x) * (2.0 * AREA_SCALE)
    return torch.round(area).to(torch.int64).sum()


def pack_boxes(cl_min, cl_max, c2p: int):
    """Cluster AABBs f32[C1p,3] (padding clusters inverted) → the tree's
    (sc_boxes f32[8,c2p], cl_boxes f32[C2,8,K2])."""
    c2 = cl_min.shape[0] // K2
    dev = cl_min.device
    cmin, cmax = cl_min.reshape(c2, K2, 3), cl_max.reshape(c2, K2, 3)
    sc_boxes = torch.full((8, c2p), _INF, device=dev)
    sc_boxes[3:6, :] = -_INF               # padding lanes: inverted box
    sc_boxes[0:3, :c2] = cmin.amin(dim=1).T
    sc_boxes[3:6, :c2] = cmax.amax(dim=1).T
    cl_boxes = torch.zeros((c2, 8, K2), device=dev)
    cl_boxes[:, 0:3, :] = cmin.permute(0, 2, 1)
    cl_boxes[:, 3:6, :] = cmax.permute(0, 2, 1)
    return sc_boxes, cl_boxes


def subrun_boxes(tri_data, lmin, lmax) -> None:
    """Write the 16-triangle sub-run AABBs of the leaf boxes lmin, lmax
    f32[C,K1,3] into tri_data[:C]'s pad columns (rows 0-7, cols 40-45),
    in place. Kept for layout parity with the JAX package; the CUDA
    kernels do not read them."""
    c = lmin.shape[0]
    run = K1 // SUBRUNS
    tri_data[:c, 0:SUBRUNS, SUB_COL:SUB_COL + 3] = \
        lmin.reshape(c, SUBRUNS, run, 3).amin(dim=2)
    tri_data[:c, 0:SUBRUNS, SUB_COL + 3:SUB_COL + 6] = \
        lmax.reshape(c, SUBRUNS, run, 3).amax(dim=2)


def _assemble(v0, e1, e2, order, attrs=None,
              with_attributes: bool = False) -> ClusterTree:
    """torch twin of `_assemble_host` on the inputs' device: v0, e1, e2
    f32[T,3] and the permutation `order` i[T] → the packed tree. The same
    layout and the same values (gathers, min/max and copies only), so a
    given order yields a byte-equal tree."""
    dev = v0.device
    T = v0.shape[0]
    Tp = -(-T // K1) * K1
    C1 = Tp // K1
    C1p = -(-C1 // K2) * K2
    order = order.to(torch.int64)

    def sorted_rows(x):                    # [T,k] → [C1,K1,k], zero padded
        x = torch.nn.functional.pad(x[order], (0, 0, 0, Tp - T))
        return x.reshape(C1, K1, -1)

    sv0, se1, se2 = sorted_rows(v0), sorted_rows(e1), sorted_rows(e2)
    leaf_tri = torch.nn.functional.pad(order.to(torch.int32), (0, Tp - T),
                                       value=-1)
    valid = (torch.arange(Tp, device=dev) < T).reshape(C1, K1, 1)
    p1, p2 = sv0 + se1, sv0 + se2
    lmin = torch.where(valid, torch.minimum(torch.minimum(sv0, p1), p2),
                       _INF)
    lmax = torch.where(valid, torch.maximum(torch.maximum(sv0, p1), p2),
                       -_INF)
    cl_min = torch.full((C1p, 3), _INF, device=dev)
    cl_max = torch.full((C1p, 3), -_INF, device=dev)
    cl_min[:C1], cl_max[:C1] = lmin.amin(dim=1), lmax.amax(dim=1)
    C2 = C1p // K2
    sc_boxes, cl_boxes = pack_boxes(cl_min, cl_max,
                                    max(128, -(-C2 // 128) * 128))

    tri_data = torch.zeros((C1p, K1, ROWS), device=dev)
    tri_data[:C1, :, 0:3], tri_data[:C1, :, 3:6] = sv0, se1
    tri_data[:C1, :, 6:9] = se2
    if with_attributes:
        col = 9
        for key in ("n0", "n1", "n2", "uv0", "uv1", "uv2", "t0", "t1", "t2",
                    "mat"):
            x = sorted_rows(attrs[key])
            tri_data[:C1, :, col:col + x.shape[2]] = x
            col += x.shape[2]
    subrun_boxes(tri_data, lmin, lmax)
    return ClusterTree(sc_boxes=sc_boxes, cl_boxes=cl_boxes,
                       tri_data=tri_data, leaf_tri=leaf_tri)


def split_permutation(v0, e1, e2):
    """Top-down aligned SAH-split triangle ordering (host, numpy) — the
    same recursion as vkrt_tpu.accel.clusters.split_permutation with
    sah=True: consecutive K1-runs are the clusters, and cuts fall at
    multiples of K1*K2 while nodes are larger, so superclusters are
    subtrees too."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    c = v0 + (e1 + e2) / 3.0
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    T = c.shape[0]
    order = np.arange(T, dtype=np.int64)
    big = K1 * K2

    def area(ext):
        return (ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2]
                + ext[..., 2] * ext[..., 0])

    stack = [(0, T)]
    while stack:
        lo, hi = stack.pop()
        n = hi - lo
        if n <= K1:
            continue
        align = big if n > big else K1
        ncuts = (n - 1) // align      # cuts at align, 2*align, ...
        if ncuts == 0:
            continue
        sub = order[lo:hi]
        best_cost, best_perm, best_cut = None, None, None
        for ax in range(3):
            srt = np.argsort(c[sub, ax], kind="stable")
            s = sub[srt]
            pmin = np.minimum.accumulate(tmin[s], axis=0)
            pmax = np.maximum.accumulate(tmax[s], axis=0)
            smin = np.minimum.accumulate(tmin[s][::-1], axis=0)[::-1]
            smax = np.maximum.accumulate(tmax[s][::-1], axis=0)[::-1]
            cuts = (np.arange(ncuts) + 1) * align
            a_l = area(pmax[cuts - 1] - pmin[cuts - 1])
            a_r = area(smax[cuts] - smin[cuts])
            cost = a_l * cuts + a_r * (n - cuts)
            j = int(np.argmin(cost))
            if best_cost is None or cost[j] < best_cost:
                best_cost, best_perm, best_cut = cost[j], s, int(cuts[j])
        order[lo:hi] = best_perm
        stack.append((lo + best_cut, hi))
        stack.append((lo, lo + best_cut))
    return order.astype(np.int32)


def _assemble_host(v0, e1, e2, order, attrs=None,
                   with_attributes: bool = False):
    """numpy twin of vkrt_tpu.accel.clusters._assemble_host. Returns the
    four numpy arrays (sc_boxes, cl_boxes, tri_data, leaf_tri)."""
    T = v0.shape[0]
    Tp = -(-T // K1) * K1
    C1 = Tp // K1
    C1p = -(-C1 // K2) * K2
    C2 = C1p // K2

    def pad(x, n, fill=0.0):
        if n <= x.shape[0]:
            return x
        return np.concatenate(
            [x, np.full((n - x.shape[0],) + x.shape[1:], fill, x.dtype)])

    sv0 = pad(v0[order], Tp)
    se1 = pad(e1[order], Tp)
    se2 = pad(e2[order], Tp)
    leaf_tri = pad(order.astype(np.int32), Tp, fill=-1)

    valid = (np.arange(Tp) < T)[:, None]
    lmin = np.where(valid, np.minimum(np.minimum(sv0, sv0 + se1), sv0 + se2),
                    _INF)
    lmax = np.where(valid, np.maximum(np.maximum(sv0, sv0 + se1), sv0 + se2),
                    -_INF)

    cl_min = pad(lmin.reshape(C1, K1, 3).min(axis=1).astype(np.float32),
                 C1p, _INF)
    cl_max = pad(lmax.reshape(C1, K1, 3).max(axis=1).astype(np.float32),
                 C1p, -_INF)
    sc_min = cl_min.reshape(C2, K2, 3).min(axis=1)
    sc_max = cl_max.reshape(C2, K2, 3).max(axis=1)

    C2p = max(128, -(-C2 // 128) * 128)
    sc_boxes = np.full((8, C2p), _INF, np.float32)
    sc_boxes[3:6, :] = -_INF
    sc_boxes[0:3, :C2] = sc_min.T
    sc_boxes[3:6, :C2] = sc_max.T

    cl_boxes = np.zeros((C2, 8, K2), np.float32)
    cl_boxes[:, 0:3, :] = cl_min.reshape(C2, K2, 3).transpose(0, 2, 1)
    cl_boxes[:, 3:6, :] = cl_max.reshape(C2, K2, 3).transpose(0, 2, 1)

    def cols(x):
        return x.reshape(C1, K1, -1).astype(np.float32)

    rows = [cols(sv0), cols(se1), cols(se2)]
    if with_attributes:
        a = {k: np.asarray(x) for k, x in attrs.items()}
        for key in ("n0", "n1", "n2", "uv0", "uv1", "uv2", "t0", "t1", "t2"):
            rows.append(cols(pad(a[key][order], Tp)))
        rows.append(cols(pad(a["mat"][order].astype(np.float32), Tp)))
    else:
        rows.append(np.zeros((C1, K1, 27), np.float32))
    tri_data = np.concatenate(rows, axis=2)
    if tri_data.shape[2] < ROWS:
        tri_data = np.concatenate(
            [tri_data, np.zeros((C1, K1, ROWS - tri_data.shape[2]),
                                np.float32)], axis=2)
    # 16-tri sub-run boxes in the pad columns (kept for layout parity;
    # the CUDA kernels do not read them)
    rmin = lmin.reshape(C1, SUBRUNS, K1 // SUBRUNS, 3).min(axis=2)
    rmax = lmax.reshape(C1, SUBRUNS, K1 // SUBRUNS, 3).max(axis=2)
    tri_data[:, 0:SUBRUNS, SUB_COL:SUB_COL + 3] = rmin
    tri_data[:, 0:SUBRUNS, SUB_COL + 3:SUB_COL + 6] = rmax
    tri_data = pad(tri_data, C1p)
    return sc_boxes, cl_boxes, tri_data, leaf_tri


def scene_attrs(flat) -> dict:
    """Per-triangle attribute arrays (numpy) from a FlatScene."""
    idx = np.asarray(flat.indices, dtype=np.int64)
    out = {}
    for i in range(3):
        out[f"n{i}"] = flat.normals[idx[:, i]]
        out[f"uv{i}"] = flat.uvs[idx[:, i]]
        out[f"t{i}"] = flat.tangents[idx[:, i], :3]
    # material SLOT id (packed triple heap) in col 33; the raw
    # metallic-roughness / normal image ids ride along in 34-35
    _, tri_slot = material_slots(flat)
    out["mat"] = np.stack([tri_slot, flat.tri_metallic_roughness,
                           flat.tri_normal], axis=1).astype(np.float32)
    return out
