"""Roofline bounds of the port's steps, counted here from the shapes of
what a step works on, so that a change to the program cannot move them.

A bound is the least time an H100 could take for the work: the larger of
its bytes over the card's memory bandwidth and its float32 operations
over the card's float32 rate outside the tensor cores (NVIDIA's data
sheet, SXM part, at its 700 W limit). A step's share of its roofline is
the bound over its measured device time.

The refit (the port's `accel/refit.py::refit_clusters`, `rebuild="refit"`)
keeps the tree's topology and moves its geometry under a 4x4 affine
instance transform. Whatever its implementation, a refit of the cluster
tree's layout (C1p clusters of K1 triangle slots, grouped 64 to a
supercluster) has to:

  * per slot: read and write the 27 float32 columns the transform moves
    (v0, e1, e2 and the normals and tangents n0-n2, t0-t2: columns 0-17
    and 24-32), 216 bytes, and read the slot's `leaf_tri` entry (4 bytes),
    which says whether the slot holds a triangle;
  * per cluster: write its 8 sub-run boxes and its own box, 6 float32
    each (216 bytes);
  * per supercluster: write its box (24 bytes).

It need not copy the columns it does not move: a refit into a buffer
made at set-up leaves them in place. Operations a slot: the 9 row
transforms (3x3 by a row: 9 products and 6 sums, 15 each), the
translation of v0 (3), the two other vertices (v0 + e1, v0 + e2: 6),
the slot's box (min and max of three vertices: 12), and its box folded
into its sub-run's (6), 162 in all; a cluster folds its 8 sub-run boxes
into its own and its own into its supercluster's (6 each, 54).
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12        # HBM3 bandwidth, bytes/s
PEAK_F32_S = 67e12            # float32 outside the tensor cores, FLOP/s

MOVED_COLS = 18 + 9           # columns 0-17 and 24-32
BOX = 6 * 4                   # a min and a max corner, float32
SUBRUNS = 8                   # sub-run boxes a cluster

SLOT_BYTES = 2 * 4 * MOVED_COLS + 4
CLUSTER_BYTES = (SUBRUNS + 1) * BOX
SUPERCLUSTER_BYTES = BOX
SLOT_OPS = 9 * 15 + 3 + 6 + 12 + 6
CLUSTER_OPS = (SUBRUNS + 1) * 6


def bound_ms(nbytes: float, ops: float) -> float:
    """The roofline bound in ms of `nbytes` moved and `ops` float32
    operations."""
    return 1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def refit_counts(clusters: int, k1: int, superclusters: int):
    """(bytes, float32 operations) of one refit of a tree of `clusters`
    clusters (padding clusters included: C1p) of `k1` slots and
    `superclusters` superclusters."""
    slots = clusters * k1
    nbytes = (slots * SLOT_BYTES + clusters * CLUSTER_BYTES
              + superclusters * SUPERCLUSTER_BYTES)
    return nbytes, slots * SLOT_OPS + clusters * CLUSTER_OPS


def refit_bound_ms(tree) -> float:
    """The refit's bound in ms for the layout of `tree` (the program's
    ClusterTree: tri_data [C1p, K1, ROWS], cl_boxes [C2, 8, K2]; only
    their shapes are read)."""
    clusters, k1 = tree.tri_data.shape[:2]
    return bound_ms(*refit_counts(int(clusters), int(k1),
                                  int(tree.cl_boxes.shape[0])))
