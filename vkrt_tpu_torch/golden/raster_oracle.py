"""Brute-force oracle for the raster pipeline contract.

Independent numpy implementation of the raster path's visible behavior
(ref: shaders/shader.frag:13-22 unlit textured + alpha discard;
src/Rasterizer.cpp:119 clear color; src/Rasterizer.cpp:17 8xMSAA):
per sample, the nearest surface with baseColor.a >= 0.1 wins; surfaces
below the threshold are transparent (fragment kill).
"""

from __future__ import annotations

import numpy as np

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.golden.cpu_tracer import closest_hit, sample_texture
from vkrt_tpu_torch.raster.pipeline import ALPHA_DISCARD, CLEAR_COLOR, MSAA8
from vkrt_tpu_torch.scene.flatten import FlatScene
from vkrt_tpu_torch.scene.textures import TextureHeap


def _rays_offset(width, height, proj_inverse, view_inverse, off):
    xs = (np.arange(width, dtype=np.float32) + off[0]) / width * 2 - 1
    ys = (np.arange(height, dtype=np.float32) + off[1]) / height * 2 - 1
    gx, gy = np.meshgrid(xs, ys)
    uvn = np.stack([gx, gy, np.ones_like(gx), np.ones_like(gx)], axis=-1)
    target = uvn @ proj_inverse.T
    d_view = target[..., :3]
    d_view = d_view / np.maximum(
        np.linalg.norm(d_view, axis=-1, keepdims=True), 1e-20)
    d4 = np.concatenate([d_view, np.zeros_like(d_view[..., :1])], axis=-1)
    dirs = (d4 @ view_inverse.T)[..., :3]
    origin = (view_inverse @ np.array([0, 0, 0, 1], np.float32))[:3]
    return (np.broadcast_to(origin, dirs.shape).reshape(-1, 3).astype(np.float32),
            dirs.reshape(-1, 3).astype(np.float32))


def render_golden_raster(flat: FlatScene, heap: TextureHeap, proj_inverse,
                         view_inverse, cfg: C.RenderConfig,
                         msaa: int = 1) -> np.ndarray:
    idx = flat.indices.astype(np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0

    offsets = MSAA8 if msaa == 8 else np.array([[0.5, 0.5]], np.float32)
    acc = np.zeros((cfg.height * cfg.width, 3), np.float32)
    for off in offsets:
        o, d = _rays_offset(cfg.width, cfg.height, proj_inverse, view_inverse, off)
        n = o.shape[0]
        color = np.broadcast_to(CLEAR_COLOR, (n, 3)).copy()
        live = np.ones(n, dtype=bool)
        for _ in range(4):
            if not live.any():
                break
            t, tri, u, v = closest_hit(o[live], d[live], C.RAY_TMIN,
                                       C.RAY_TMAX, v0, e1, e2)
            hit = tri >= 0
            live_idx = np.flatnonzero(live)
            hid = live_idx[hit]
            h_tri = tri[hit]
            hu = u[hit][:, None]
            hv = v[hit][:, None]
            hw = 1.0 - hu - hv
            vi = idx[h_tri]
            uv = (flat.uvs[vi[:, 0]] * hw + flat.uvs[vi[:, 1]] * hu
                  + flat.uvs[vi[:, 2]] * hv)
            texel = sample_texture(heap, flat.tri_base_color[h_tri], uv)
            opaque = texel[:, 3] >= ALPHA_DISCARD
            color[hid[opaque]] = texel[opaque, :3]
            # continue behind discarded fragments
            pos = (flat.positions[vi[:, 0]] * hw + flat.positions[vi[:, 1]] * hu
                   + flat.positions[vi[:, 2]] * hv)
            new_live = np.zeros(n, dtype=bool)
            disc = hid[~opaque]
            new_live[disc] = True
            o[disc] = pos[~opaque] + d[disc] * 1e-4
            live = new_live
        acc += color
    return (acc / len(offsets)).reshape(cfg.height, cfg.width, 3)
