"""Hit shading — counterpart of vkrt_tpu/shade/shading.py.

The closest-hit shader contract (shaders/shader.rchit:86-172) over
lane-major ray batches: barycentric attribute interpolation, TBN normal
mapping, per-light geometry and the reflection direction. The same
float32 operations in the same order as the JAX package.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.utils import layout as L


def interpolate(attrs, u, v):
    """Split the per-corner attr block [36,Nb,128] and interpolate.
    Returns (position, normal, uv, tangent, mat_ids); see the JAX
    function for the row layout."""
    w = 1.0 - u - v
    position = attrs[0:3] + u[None] * attrs[3:6] + v[None] * attrs[6:9]
    normal = attrs[9:12] * w[None] + attrs[12:15] * u[None] + attrs[15:18] * v[None]
    uv = attrs[18:20] * w[None] + attrs[20:22] * u[None] + attrs[22:24] * v[None]
    tangent = attrs[24:27] * w[None] + attrs[27:30] * u[None] + attrs[30:33] * v[None]
    mat_ids = attrs[33:36].to(torch.int32)
    return position, normal, uv, tangent, mat_ids


def perturbed_normal(world_normal, tangent, map_normal):
    """TBN normal mapping (ref: shader.rchit:78-84,105-108)."""
    n = L.normalize3(world_normal)
    t = L.normalize3(tangent)
    b = L.cross3(t, n)
    m = L.normalize3(map_normal * 2.0 - 1.0)
    return L.normalize3(t * m[0][None] + b * m[1][None] + n * m[2][None])


def light_geometry(position, light_pos):
    """Per-light direction/distance/power (ref: shader.rchit:121-126).
    position cvec [3,Nb,128]; light_pos [3]. Returns (ldir cvec, ldist,
    power)."""
    lvec = light_pos[:, None, None] - position
    ldist = L.norm3(lvec)
    ldir = lvec / torch.clamp(ldist, min=1e-20)[None]
    power = C.LIGHT_INTENSITY / torch.clamp(ldist * ldist, min=1e-20)
    return ldir, ldist, power


def reflect(d, n):
    """GLSL reflect (ref: shader.rchit:170). cvec in, cvec out."""
    return d - 2.0 * L.dot3(d, n)[None] * n
