"""Raster pipeline — counterpart of vkrt_tpu/raster/pipeline.py.

The reference's second renderer (ref: src/Rasterizer.{hpp,cpp}) draws the
scene with one WVP matrix, 8x MSAA with an averaged resolve (ref:
Rasterizer.cpp:17, 266-338), an unlit textured fragment shader that
discards fragments below alpha 0.1 (ref: shaders/shader.frag:13-22),
clear color (0, 0, 0.2) (ref: Rasterizer.cpp:119) and an FPS overlay
(ref: Rasterizer.cpp:151-161).

Two methods, as in the JAX package:

  * "edge" (the default): the vertex/setup stage once per pose
    (raster/edge.py::build_raster_setup), then per MSAA sample
    MAX_DISCARD_ROUNDS passes of kernel G. A discarded fragment's depth
    becomes the pixel's floor for the next round, so the next round
    finds the nearest fragment strictly behind it; every other pixel
    parks (zfloor 1e9), and a block of G without a live pixel leaves at
    once. The rounds always run: no host wait decides to stop early. An
    MSAA-8 frame is 8 samples x 4 rounds = 32 launches of G.
  * "wavefront": the ray-cast equivalent on kernel A, a discarded hit
    continuing its ray just behind the surface.

Frames are f32[H,W,3] on the device; `Rasterizer.render` adds the FPS
overlay on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.app.overlay import draw_text
from vkrt_tpu_torch.raster.edge import ZFAR_PARK, build_raster_setup, raster_edge
from vkrt_tpu_torch.shade import shading
from vkrt_tpu_torch.shade.sampling import sample_material
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine

CLEAR_COLOR = np.array([0.0, 0.0, 0.2], dtype=np.float32)  # ref: Rasterizer.cpp:119
ALPHA_DISCARD = 0.1        # ref: shaders/shader.frag:16-20
MAX_DISCARD_ROUNDS = 4

# Standard 8x MSAA sample positions (pixel space, Vulkan/D3D pattern;
# ref MSAA config: VK_SAMPLE_COUNT_8_BIT at Rasterizer.cpp:17)
MSAA8 = np.array([
    [0.5625, 0.3125], [0.4375, 0.6875], [0.8125, 0.5625], [0.3125, 0.1875],
    [0.1875, 0.8125], [0.0625, 0.4375], [0.6875, 0.9375], [0.9375, 0.0625],
], dtype=np.float32)


def sample_offsets(msaa: int) -> np.ndarray:
    """The sample positions inside a pixel for msaa 1 (the centre) or 8."""
    if msaa == 8:
        return MSAA8
    if msaa == 1:
        return np.array([[0.5, 0.5]], np.float32)
    raise ValueError(f"msaa must be 1 or 8, got {msaa}")


def _clear(shape, device):
    return torch.stack([torch.full(shape, float(c), device=device)
                        for c in CLEAR_COLOR])


def _to_image(color, cfg: C.RenderConfig):
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    return torch.stack([engine.untile(color[k], hp, wp)[: cfg.height,
                                                       : cfg.width]
                        for k in range(3)], dim=-1)


def _inside(cfg: C.RenderConfig, device):
    """bool[Nb,128]: False on the tile padding around the frame."""
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    ones = torch.ones((cfg.height, cfg.width), dtype=torch.bool,
                      device=device)
    return engine.tile(engine._pad_grid(ones, wp, hp, False))


def _visibility_sample(backend, tex, proj_inverse, view_inverse,
                       cfg: C.RenderConfig, off):
    """One MSAA sample pass of the ray-cast method: unlit color with
    alpha-discard continuation."""
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    o, d = engine.generate_rays(proj_inverse, view_inverse,
                                cfg.width, cfg.height, off=off)
    origins = torch.stack([engine.tile(engine._pad_grid(c, wp, hp, 0.0))
                           for c in o])
    dirs = L.normalize3(torch.stack(
        [engine.tile(engine._pad_grid(c, wp, hp, 1.0)) for c in d]))
    live = _inside(cfg, dirs.device)       # padding rays never trace
    color = _clear(live.shape, dirs.device)
    for _ in range(MAX_DISCARD_ROUNDS):
        tmax = torch.where(live, C.RAY_TMAX, 0.0)
        _, u, v, attrs, hitm = backend.closest(origins, dirs, tmax)
        hit = hitm & live
        pos, _, uv, _, mat_ids = shading.interpolate(attrs, u, v)
        texel, _, _ = sample_material(tex.texels_tri, tex.level_offset,
                                      tex.level_width, tex.level_height,
                                      mat_ids[0], uv)
        opaque = hit & (texel[3] >= ALPHA_DISCARD)
        discarded = hit & ~opaque
        color = L.where3(opaque, texel[:3], color)
        # fragment kill: the ray continues just behind the surface
        origins = L.where3(discarded, pos + dirs * 1e-4, origins)
        live = discarded
    return _to_image(color, cfg)


def render_raster_frame(backend, tex, proj_inverse, view_inverse,
                        cfg: C.RenderConfig, msaa: int = 8):
    """Ray-cast raster frame: one visibility pass per MSAA sample,
    averaged resolve. Needs the inverse matrices."""
    offsets = sample_offsets(msaa)
    acc = None
    for off in offsets:
        s = _visibility_sample(backend, tex, proj_inverse, view_inverse, cfg,
                               off)
        acc = s if acc is None else acc + s
    return acc / float(len(offsets))


def sample_pixel_lanes(cfg: C.RenderConfig, off, device):
    """Tiled lane-major sample positions px, py f32[Nb,128] (pixel index
    + offset) and the inside mask bool[Nb,128] for one MSAA offset."""
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    gx = torch.arange(wp, dtype=torch.float32, device=device) + float(off[0])
    gy = torch.arange(hp, dtype=torch.float32, device=device) + float(off[1])
    px = engine.tile(gx[None, :].expand(hp, wp))
    py = engine.tile(gy[:, None].expand(hp, wp))
    return px, py, _inside(cfg, device)


def edge_color_lanes(tex, setup, scb, clb, px, py, inside,
                     label: str = "s0"):
    """Lane-space body of one edge-rasterizer sample pass: coverage and
    depth test (kernel G), alpha discard as depth-floor continuation
    rounds. px/py/inside are lane-major [Nb,128]; returns unlit color
    [3,Nb,128]. `label` names the profiler range of G's launches
    (`raster_edge_{label}`)."""
    color = _clear(px.shape, px.device)
    zfloor = torch.where(inside, 0.0, ZFAR_PARK)              # pads park
    for _ in range(MAX_DISCARD_ROUNDS):
        with record_function(f"raster_edge_{label}"):
            z, slot, u, v, mat = raster_edge(setup, scb, clb, px, py, zfloor)
        with record_function("raster_sample"):
            hit = slot >= 0
            texel, _, _ = sample_material(
                tex.texels_tri, tex.level_offset, tex.level_width,
                tex.level_height, mat, torch.stack([u, v]))
            opaque = hit & (texel[3] >= ALPHA_DISCARD)
            discarded = hit & ~opaque
            color = L.where3(opaque, texel[:3], color)
            # fragment kill: the next round takes only deeper fragments
            zfloor = torch.where(discarded, z, ZFAR_PARK)
    return color


def _edge_sample(tex, cfg: C.RenderConfig, off, setup, scb, clb,
                 label: str):
    """One MSAA sample pass through the edge-function rasterizer, as an
    f32[H,W,3] image."""
    px, py, inside = sample_pixel_lanes(cfg, off, setup.device)
    return _to_image(edge_color_lanes(tex, setup, scb, clb, px, py, inside,
                                      label), cfg)


def render_raster_frame_edge(tree, tex, view, proj, cfg: C.RenderConfig,
                             msaa: int = 8):
    """Edge-rasterizer frame: the setup stage once per pose, then one
    coverage pass per MSAA sample, averaged resolve. Needs the forward
    view and projection matrices (the WVP of the reference's UBO, ref:
    Rasterizer.cpp:172-195)."""
    with record_function("raster_setup"):
        setup, scb, clb = build_raster_setup(tree, view, proj, cfg.width,
                                             cfg.height)
    offsets = sample_offsets(msaa)
    acc = None
    for k, off in enumerate(offsets):
        s = _edge_sample(tex, cfg, off, setup, scb, clb, f"s{k}")
        acc = s if acc is None else acc + s
    return acc / float(len(offsets))


class Rasterizer(engine.SceneOnDevice):
    """The reference Rasterizer's shape (ref: src/Rasterizer.hpp:12-18):
    the constructor builds the scene on `device` (the card unless the
    caller asks for the CPU), render() draws a frame with the FPS overlay
    of the raster path (ref: Rasterizer.cpp:151-161).

    method "edge" (what "auto" picks on the dense backend) runs the
    edge-function rasterizer (kernel G); "wavefront" (what "auto" picks
    on the reference backend) the ray-cast equivalent through the
    backend's closest-hit trace."""

    def __init__(self, scene, cfg: C.RenderConfig, device="cuda",
                 msaa: int = 8, method: str = "auto", backend: str = "dense",
                 max_texture_dim: int = 0):
        sample_offsets(msaa)                       # raises on a bad msaa
        if method == "auto":
            method = "edge" if backend == "dense" else "wavefront"
        if method not in ("edge", "wavefront"):
            raise ValueError(f"method must be 'auto', 'edge' or "
                             f"'wavefront', got {method!r}")
        if method == "edge" and backend != "dense":
            raise ValueError("the edge rasterizer needs the dense backend's "
                             "cluster tree")
        super().__init__(scene, cfg, device, backend, max_texture_dim)
        self.msaa = msaa
        self.method = method

    def render_async(self, camera):
        """Enqueue a frame; returns the device f32[H,W,3] frame without
        waiting for the card."""
        if self.method == "edge":
            return render_raster_frame_edge(
                self.backend.tree, self.tex,
                engine.upload_matrix(camera.view_matrix, self.device),
                engine.upload_matrix(camera.projection_matrix, self.device),
                self.cfg, self.msaa)
        return render_raster_frame(
            self.backend, self.tex,
            engine.upload_matrix(camera.proj_inverse, self.device),
            engine.upload_matrix(camera.view_inverse, self.device),
            self.cfg, self.msaa)

    def render(self, camera, show_fps: bool = True):
        """Synchronous frame as numpy f32[H,W,3], with the FPS of this
        frame (enqueue to host copy) burned in when `show_fps`."""
        t0 = time.perf_counter()
        fb = self.render_async(camera).cpu().numpy()
        dt = time.perf_counter() - t0
        if show_fps:
            fb = draw_text(fb, f"FPS {1.0 / max(dt, 1e-9):.1f}", 8, 8)
        return fb
