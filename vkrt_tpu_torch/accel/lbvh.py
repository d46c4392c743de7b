"""LBVH build — counterpart of vkrt_tpu/accel/lbvh.py.

A binary linear BVH (Karras 2012) over triangles, built with fixed-shape
tensor code so it runs on the card: 30-bit Morton codes of the triangle
centroids, a stable argsort, the internal-node ranges and splits by
vectorised binary searches over longest-common-prefix values (ties
broken by leaf index, so duplicate codes still give a valid tree), and
every node's box from a doubling range-min/max table over the sorted
leaf boxes. `morton30` also orders the per-frame Morton rebuild
(accel/clusters.build_clusters method="morton").

Layout is traversal-first, as in the JAX package: each internal node
holds both children's boxes ([12] floats) and links (a leaf is -(slot+1)),
and the triangles are stored in leaf order. rt/traverse.py walks it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _expand_bits10(v):
    """Spread 10 bits so there are 2 zero bits between each."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton30(points, lo, hi):
    """30-bit Morton codes i32[N] of points f32[N,3] normalised into
    [lo, hi] (f32[3] each)."""
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((points - lo) / extent * 1024.0, 0.0, 1023.0)
    q = q.to(torch.int32)
    return ((_expand_bits10(q[:, 0]) << 2) | (_expand_bits10(q[:, 1]) << 1)
            | _expand_bits10(q[:, 2]))


def _clz32(x):
    """Leading zeros of non-negative int32 values: 32 less their bit
    length, which frexp's exponent is (exact in float64 below 2^53)."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent


class BVH2(NamedTuple):
    """Binary LBVH in traversal-first layout; NI = T-1 internal nodes."""

    boxes: torch.Tensor     # f32[NI,12] = [lmin, lmax, rmin, rmax]
    kids: torch.Tensor      # i32[NI,2]: >= 0 internal node, < 0 leaf -(slot+1)
    tri_v0: torch.Tensor    # f32[T,3], leaf order
    tri_e1: torch.Tensor    # f32[T,3]
    tri_e2: torch.Tensor    # f32[T,3]
    leaf_tri: torch.Tensor  # i32[T]: leaf slot → original triangle id

    @property
    def num_tris(self) -> int:
        return int(self.tri_v0.shape[0])


def build_lbvh(v0, e1, e2) -> BVH2:
    """An LBVH over the triangles (v0, e1, e2), f32[T,3] each, on their
    device. No host wait: every loop has a fixed trip count."""
    T = v0.shape[0]
    if T < 2:
        raise ValueError(f"an LBVH needs at least 2 triangles, got {T}")
    NI = T - 1
    dev = v0.device

    # 1. Morton codes of the centroids; 2. stable sort
    centroid = v0 + (e1 + e2) / 3.0
    codes = morton30(centroid, centroid.min(dim=0).values,
                     centroid.max(dim=0).values)
    order = torch.argsort(codes, stable=True)
    sc = codes[order]
    sv0, se1, se2 = v0[order], e1[order], e2[order]

    # 3. Karras topology
    def delta(i, j):
        # longest common prefix of sorted codes, ties broken by leaf index
        valid = (j >= 0) & (j < T)
        jc = torch.clamp(j, 0, T - 1)
        x = sc[i] ^ sc[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(valid, d, -1)

    i = torch.arange(NI, dtype=torch.int32, device=dev)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1)).to(torch.int32)
    dmin = delta(i, i - d)

    # upper bound of the range length by doubling (2^21 > 2 * max T)
    lmax = torch.full((NI,), 2, dtype=torch.int32, device=dev)
    grow = torch.ones(NI, dtype=torch.bool, device=dev)
    for _ in range(21):
        cond = grow & (delta(i, i + lmax * d) > dmin)
        lmax = torch.where(cond, lmax * 2, lmax)
        grow = cond
    # binary refinement of the exact length
    ln = torch.zeros(NI, dtype=torch.int32, device=dev)
    t = lmax >> 1
    for _ in range(21):
        cond = (t >= 1) & (delta(i, (ln + t) * d + i) > dmin)
        ln = torch.where(cond, ln + t, ln)
        t = t >> 1
    j = i + ln * d

    # split: the highest s with delta(i, i+(s+t)d) > delta(i, j)
    dnode = delta(i, j)
    s = torch.zeros(NI, dtype=torch.int32, device=dev)
    t = (ln + 1) >> 1
    for _ in range(21):
        cond = (t >= 1) & (delta(i, (s + t) * d + i) > dnode)
        s = torch.where(cond, s + t, s)
        t = torch.where(t == 1, 0, (t + 1) >> 1)
    gamma = i + s * d + torch.clamp(d, max=0)

    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    left = torch.where(first == gamma, -(gamma + 1), gamma)
    right = torch.where(last == gamma + 1, -(gamma + 2), gamma + 1)
    kids = torch.stack([left, right], dim=1).to(torch.int32)

    # 4. boxes from a doubling range-min/max table over the leaf boxes
    p1, p2 = sv0 + se1, sv0 + se2
    mins = [torch.minimum(torch.minimum(sv0, p1), p2)]
    maxs = [torch.maximum(torch.maximum(sv0, p1), p2)]
    idx = torch.arange(T, device=dev)
    for k in range(1, max(1, (T - 1).bit_length()) + 1):
        nxt = torch.clamp(idx + (1 << (k - 1)), max=T - 1)
        mins.append(torch.minimum(mins[-1], mins[-1][nxt]))
        maxs.append(torch.maximum(maxs[-1], maxs[-1][nxt]))
    table_min = torch.stack(mins)          # [K+1, T, 3]
    table_max = torch.stack(maxs)

    def range_box(lo, hi):
        k = (31 - _clz32(hi - lo + 1)).long()      # floor(log2(length))
        second = (hi - (torch.ones_like(k) << k) + 1).long()
        lo = lo.long()
        return (torch.minimum(table_min[k, lo], table_min[k, second]),
                torch.maximum(table_max[k, lo], table_max[k, second]))

    # the left child covers [first, gamma], the right [gamma+1, last]
    lmin_box, lmax_box = range_box(first, gamma)
    rmin_box, rmax_box = range_box(gamma + 1, last)
    boxes = torch.cat([lmin_box, lmax_box, rmin_box, rmax_box], dim=1)
    return BVH2(boxes=boxes.to(torch.float32), kids=kids, tri_v0=sv0,
                tri_e1=se1, tri_e2=se2, leaf_tri=order.to(torch.int32))
