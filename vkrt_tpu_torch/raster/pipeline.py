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
overlay on the host. With `quantize`, a frame is (u8[H,W,3], visibility
queries) on the device instead, as `Renderer(quantize=True)` gives (u8
frame, rays): the MSAA resolve and the truncating UNORM8 cast run on the
card, and the count is the lanes live as each discard round enters the
rasterizer (G, or kernel A in the ray-cast method), summed over the
samples: every inside pixel in round 0, then the samples whose fragment
was discarded. It is the raster path's counterpart of rays traced.

After each launch of G, raster/sample.py's `raster_sample_round` samples
the base map where G hit, applies the alpha test and sets the next
round's depth floor: kernel I (csrc/raster_sample.cu) on the card,
`raster_sample_round_plain` on the CPU. The ray-cast method keeps
shade/sampling.py's three-map sampler, as the ray tracer does.

Spans (tracing.py): `frame` holds `raster_setup` (edge), per sample k and
round `raster_edge_s{k}` (G, and the round's live and hit counts) and
`raster_sample` (kernel I), and `resolve` (each sample into the image
and the sum, the average, the cast). Counters: `raster_live_r{r}`, the
live lanes at round r's entry, and `raster_fetch_r{r}`, the lanes G hit
in round r (those whose texel kernel I fetches), each summed over the
samples; G and kernel I record the lanes they are launched over
(tracing.lanes).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.app.overlay import draw_text
from vkrt_tpu_torch.raster.edge import ZFAR_PARK, build_raster_setup, raster_edge
from vkrt_tpu_torch.raster.sample import ALPHA_DISCARD, raster_sample_round
from vkrt_tpu_torch.shade import shading
from vkrt_tpu_torch.shade.sampling import sample_material
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine

CLEAR_COLOR = np.array([0.0, 0.0, 0.2], dtype=np.float32)  # ref: Rasterizer.cpp:119
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


def _count_round(r: int, live, queries) -> None:
    """Round r's live lanes (`live()`, a bool mask, made only when asked
    for): appended to `queries` where it is a list, and counted as
    `raster_live_r{r}` while tracing is on."""
    if queries is None and not tracing.enabled():
        return
    mask = live()
    tracing.count(f"raster_live_r{r}", mask)
    if queries is not None:
        queries.append(mask.sum())


def _resolve_add(acc, color, cfg: C.RenderConfig):
    """acc plus one sample's lane colors as an image (acc None: the
    first sample's image), in the `resolve` span."""
    with tracing.span("resolve", color.device):
        s = _to_image(color, cfg)
        return s if acc is None else acc + s


def _resolve(acc, n: int):
    """The MSAA resolve's average of the n samples' summed images."""
    with tracing.span("resolve", acc.device):
        return acc / float(n)


def _visibility_sample(backend, tex, proj_inverse, view_inverse,
                       cfg: C.RenderConfig, off, queries=None):
    """One MSAA sample pass of the ray-cast method: unlit lane colors
    [3,Nb,128] with alpha-discard continuation (`queries`: as
    edge_color_lanes')."""
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    o, d = engine.generate_rays(proj_inverse, view_inverse,
                                cfg.width, cfg.height, off=off)
    origins = torch.stack([engine.tile(engine._pad_grid(c, wp, hp, 0.0))
                           for c in o])
    dirs = L.normalize3(torch.stack(
        [engine.tile(engine._pad_grid(c, wp, hp, 1.0)) for c in d]))
    live = _inside(cfg, dirs.device)       # padding rays never trace
    color = _clear(live.shape, dirs.device)
    for r in range(MAX_DISCARD_ROUNDS):
        _count_round(r, lambda: live, queries)
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
    return color


def render_raster_frame(backend, tex, proj_inverse, view_inverse,
                        cfg: C.RenderConfig, msaa: int = 8, queries=None):
    """Ray-cast raster frame: one visibility pass per MSAA sample,
    averaged resolve. Needs the inverse matrices. `queries`: as
    edge_color_lanes'."""
    offsets = sample_offsets(msaa)
    acc = None
    for off in offsets:
        acc = _resolve_add(acc, _visibility_sample(
            backend, tex, proj_inverse, view_inverse, cfg, off, queries),
            cfg)
    return _resolve(acc, len(offsets))


def sample_pixel_lanes(cfg: C.RenderConfig, off, device,
                       rows: range | None = None):
    """Tiled lane-major sample positions px, py f32[Nb,128] (pixel index
    + offset) and the inside mask bool[Nb,128] for one MSAA offset, lane
    by lane (engine.lane_pixels). With `rows`, only those lane rows (rows
    past Nb are padding, never inside): the whole frame's values there."""
    if rows is None:
        wp, hp = engine._pad_dims(cfg.width, cfg.height)
        rows = range(wp * hp // L.LANES)
    x, y, inside = engine.lane_pixels(cfg, rows, device)
    return (x.to(torch.float32) + float(off[0]),
            y.to(torch.float32) + float(off[1]), inside)


def edge_color_lanes(tex, setup, scb, clb, px, py, inside,
                     label: str = "s0", queries=None):
    """Lane-space body of one edge-rasterizer sample pass: coverage and
    depth test (kernel G), alpha discard as depth-floor continuation
    rounds. px/py/inside are lane-major [Nb,128]; returns unlit color
    [3,Nb,128]. `label` names the span of G's launches
    (`raster_edge_{label}`; tracing.span). `queries`, where a list, gets
    each round's live lanes appended (an i64 scalar on the device; the
    lanes not parked as the round enters G)."""
    color = _clear(px.shape, px.device)
    zfloor = torch.where(inside, 0.0, ZFAR_PARK)              # pads park
    for r in range(MAX_DISCARD_ROUNDS):
        with tracing.span(f"raster_edge_{label}", px.device):
            _count_round(r, lambda: zfloor < ZFAR_PARK, queries)
            z, slot, u, v, mat = raster_edge(setup, scb, clb, px, py, zfloor)
            if tracing.enabled():
                tracing.count(f"raster_fetch_r{r}", slot >= 0)
        with tracing.span("raster_sample", px.device):
            color, zfloor = raster_sample_round(tex, z, slot, u, v, mat,
                                                color)
    return color


def render_raster_frame_edge(tree, tex, view, proj, cfg: C.RenderConfig,
                             msaa: int = 8, queries=None):
    """Edge-rasterizer frame: the setup stage once per pose, then one
    coverage pass per MSAA sample, averaged resolve. Needs the forward
    view and projection matrices (the WVP of the reference's UBO, ref:
    Rasterizer.cpp:172-195). `queries`: as edge_color_lanes'."""
    with tracing.span("raster_setup", view.device):
        setup, scb, clb = build_raster_setup(tree, view, proj, cfg.width,
                                             cfg.height)
    offsets = sample_offsets(msaa)
    acc = None
    for k, off in enumerate(offsets):
        px, py, inside = sample_pixel_lanes(cfg, off, setup.device)
        acc = _resolve_add(acc, edge_color_lanes(
            tex, setup, scb, clb, px, py, inside, f"s{k}", queries), cfg)
    return _resolve(acc, len(offsets))


class Rasterizer(engine.SceneOnDevice):
    """The reference Rasterizer's shape (ref: src/Rasterizer.hpp:12-18):
    the constructor builds the scene on `device` (the card unless the
    caller asks for the CPU), render() draws a frame with the FPS overlay
    of the raster path (ref: Rasterizer.cpp:151-161).

    method "edge" (what "auto" picks on the dense backend) runs the
    edge-function rasterizer (kernel G); "wavefront" (what "auto" picks
    on the reference backend) the ray-cast equivalent through the
    backend's closest-hit trace.

    `graph`: as Renderer's. On a CUDA device render_async replays one
    captured CUDA graph per (method, msaa, quantize, cfg, scene); the
    ray-cast method on the reference backend stays eager (`captured`).

    `quantize`: frames as (u8[H,W,3], visibility queries) on the device
    (module docstring), what FrameScheduler carries in flight; else the
    f32[H,W,3] frame."""

    def __init__(self, scene, cfg: C.RenderConfig, device="cuda",
                 msaa: int = 8, method: str = "auto", backend: str = "dense",
                 max_texture_dim: int = 0, graph: bool | None = None,
                 quantize: bool = False):
        sample_offsets(msaa)                       # raises on a bad msaa
        if method == "auto":
            method = "edge" if backend == "dense" else "wavefront"
        if method not in ("edge", "wavefront"):
            raise ValueError(f"method must be 'auto', 'edge' or "
                             f"'wavefront', got {method!r}")
        if method == "edge" and backend != "dense":
            raise ValueError("the edge rasterizer needs the dense backend's "
                             "cluster tree")
        super().__init__(scene, cfg, device, backend, max_texture_dim, graph)
        self.msaa = msaa
        self.method = method
        self.quantize = quantize

    def render_async(self, camera):
        """Enqueue a frame; returns the device f32[H,W,3] frame (with
        `quantize`, the u8 frame and its visibility queries, an i64
        scalar) without waiting for the card, new ones each call."""
        mats = ((camera.view_matrix, camera.projection_matrix)
                if self.method == "edge"
                else (camera.proj_inverse, camera.view_inverse))
        x = np.concatenate([np.asarray(m, np.float32).reshape(-1)
                            for m in mats])
        if not self.captured():
            return self.frame_body(engine.upload_matrix(x, self.device))
        return self.graphs.run(self.graph_key(), self.frame_body, (x,),
                               self.device, holds=(self.backend, self.tex))

    def graph_key(self) -> tuple:
        """The static key of a captured frame, tracing's state with it."""
        return ("raster", str(self.device), self.cfg, self.method,
                self.msaa, self.quantize, id(self.backend), id(self.tex),
                tracing.enabled())

    def frame_body(self, x):
        """The frame as the graph captures it, reading only `x` on the
        device: the view and projection matrices (edge) or their inverses
        (wavefront), 16 floats each; all of it in the span `frame`."""
        a, b = x[0:16].reshape(4, 4), x[16:32].reshape(4, 4)
        with tracing.span("frame", x.device):
            queries = [] if self.quantize else None
            if self.method == "edge":
                fb = render_raster_frame_edge(self.backend.tree, self.tex, a,
                                              b, self.cfg, self.msaa, queries)
            else:
                fb = render_raster_frame(self.backend, self.tex, a, b,
                                         self.cfg, self.msaa, queries)
            if not self.quantize:
                return fb
            with tracing.span("resolve", x.device):
                fb8 = torch.clamp(fb * 255.0 + 0.5, 0.0, 255.0).to(
                    torch.uint8)
                return fb8, torch.stack(queries).sum()

    def render(self, camera, show_fps: bool = True):
        """Synchronous frame as numpy f32[H,W,3] (u8 with `quantize`),
        with the FPS of this frame (enqueue to host copy) burned in when
        `show_fps`."""
        t0 = time.perf_counter()
        out = self.render_async(camera)
        fb = (out[0] if self.quantize else out).cpu().numpy()
        dt = time.perf_counter() - t0
        if show_fps:
            fb = fps_overlay(fb, 1.0 / max(dt, 1e-9))
        return fb


def fps_overlay(fb: np.ndarray, fps: float) -> np.ndarray:
    """A copy of the host frame fb (f32 or u8 [H,W,3]) with "FPS x" burned
    in, in white (ref: Rasterizer.cpp:151-161)."""
    white = 255 if fb.dtype == np.uint8 else 1.0
    return draw_text(fb, f"FPS {fps:.1f}", 8, 8, color=(white,) * 3)
