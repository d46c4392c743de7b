"""Per-frame refit of the cluster tree — counterpart of
vkrt_tpu/accel/refit.py.

`refit_clusters` keeps the tree's topology (triangle order, cluster
assignment) and applies an affine instance transform to the packed
geometry rows, then recomputes every AABB with dense reshaped reductions:
no gathers, no host wait, all on the tree's device. It is the fast
per-frame accel update; `accel.clusters.build_clusters` on device tensors
is the full rebuild, for when geometry deforms enough that the kept
topology degrades.

Every 3x3 product goes through `layout.mat_rows3` (elementwise float32),
never a matmul.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.accel.clusters import (_INF, K1, K2, SUB_COL,
                                           ClusterTree, pack_boxes,
                                           subrun_boxes)
from vkrt_tpu_torch.utils import layout as L


def refit_clusters(tree: ClusterTree, matrix) -> ClusterTree:
    """Apply a 4x4 affine transform (f32[4,4] on the tree's device) to
    the tree's geometry and refit all AABBs.

    Vertex normals (cols 9-17) and tangents (24-32) rotate with the 3x3
    part (a uniform scale is normalised away in shading; a non-uniform
    one would need the inverse transpose, which the reference's instance
    transform never is); uvs and material ids stay. All of it runs in
    the span `accel_refit` (tracing.py)."""
    with tracing.span("accel_refit", tree.tri_data.device):
        a = matrix[:3, :3]
        b = matrix[:3, 3]
        td = tree.tri_data                               # [C1p, K1, ROWS]
        c1p = td.shape[0]

        def rot(c):
            return L.mat_rows3(td[:, :, c:c + 3], a)

        v0 = rot(0) + b
        e1, e2 = rot(3), rot(6)
        p1, p2 = v0 + e1, v0 + e2
        lmin = torch.minimum(torch.minimum(v0, p1), p2)  # [C1p, K1, 3]
        lmax = torch.maximum(torch.maximum(v0, p1), p2)
        # padding slots (leaf_tri < 0, and whole padding clusters) neutral
        valid = tree.leaf_tri >= 0
        valid = torch.nn.functional.pad(valid,
                                        (0, c1p * K1 - valid.shape[0]))
        valid = valid.reshape(c1p, K1, 1)
        lmin = torch.where(valid, lmin, _INF)
        lmax = torch.where(valid, lmax, -_INF)

        sc_boxes, cl_boxes = pack_boxes(lmin.amin(dim=1),
                                        lmax.amax(dim=1),
                                        tree.sc_boxes.shape[1])
        out = td.clone()
        out[:, :, 0:3], out[:, :, 3:6], out[:, :, 6:9] = v0, e1, e2
        for c in (9, 12, 15, 24, 27, 30):                # n0-n2, t0-t2
            out[:, :, c:c + 3] = rot(c)
        # the sub-run boxes (cols 40-45) follow the transform too
        out[:, :, SUB_COL:SUB_COL + 6] = 0.0
        subrun_boxes(out, lmin, lmax)
    return ClusterTree(sc_boxes=sc_boxes, cl_boxes=cl_boxes, tri_data=out,
                       leaf_tri=tree.leaf_tri)
