"""Ray-triangle and ray-box tests — counterpart of vkrt_tpu/rt/intersect.py.

Möller–Trumbore without culling (the reference sets no cull flags, so
both faces hit); zero-area triangles, the synthetic scene's padding, are
rejected by the determinant guard. Vectorised over leading dims, [...,3]
vectors.
"""

from __future__ import annotations

import torch

DET_EPS = 1e-12


def _dot(a, b):
    return (a * b).sum(dim=-1)


def moller_trumbore(o, d, v0, e1, e2, tmin, tmax):
    """Returns (t, u, v, valid)."""
    h = torch.linalg.cross(d, e2)
    det = _dot(e1, h)
    safe_det = torch.where(det == 0, 1.0, det)
    inv_det = torch.where(torch.abs(det) > DET_EPS, 1.0 / safe_det, 0.0)
    s = o - v0
    u = _dot(s, h) * inv_det
    q = torch.linalg.cross(s, e1)
    v = _dot(d, q) * inv_det
    t = _dot(e2, q) * inv_det
    valid = ((torch.abs(det) > DET_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t > tmin) & (t < tmax))
    return t, u, v, valid


def safe_inv_dir(d):
    """Reciprocal direction without inf or NaN for axis-parallel rays."""
    tiny = 1e-20
    safe = torch.where(torch.abs(d) < tiny,
                       torch.where(d < 0, -tiny, tiny), d)
    return 1.0 / safe


def slab_test(bmin, bmax, o, inv_d, tmin, tmax):
    """Ray-AABB test. Returns (t_near, t_entry, hit): t_near is the slab
    entry before the clip to tmin, which orders a traversal's children."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
    return tn, torch.clamp(tn, min=tmin), hit
