"""Multi-device rendering — counterpart of vkrt_tpu/parallel/mesh.py.

Frames split over a 1-D list of devices along the block axis of the
lane-major wavefront: rays for the ray tracer, pixel blocks for the
edge rasterizer. The scene (trace backend, material heap, lights) and,
for the rasterizer, the frame's triangle setup are replicated on every
device; the only traffic between devices is the framebuffer gather onto
the first device of the mesh.

The JAX package writes this as one `shard_map` program. Here one host
thread enqueues each shard's work on its device in turn: the same
program written out. No shard reads another's rays, so no collective
exists beyond the gather, which is a plain `.to()` per shard. On CUDA
devices each shard's work is one captured CUDA graph (graphs.py), kept in
the `Replicas` that `replicate` returns: a frame copies the camera into
every shard's inputs and replays the k graphs from the one thread, so a
shard costs one graph launch and not its whole launch list.

Every shard holds whole 512-ray trace blocks (4 groups of 128 lanes), so
each 128-lane group a kernel walks holds the same rays as in the frame
rendered on one device. Kernel A resolves every tie to the lowest slot,
B and A' return masks, and the reorder kernels C-F only move rays, so a
sharded frame equals the unsharded one bit for bit.

A mesh may list one device several times (logical shards: the tests do
so on the CPU, chip_smoke.py on one card); such a device holds one copy
of the scene. Nothing here waits for the card: frames stay in flight.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import graphs, tracing
from vkrt_tpu_torch.raster.edge import build_raster_setup
from vkrt_tpu_torch.raster.pipeline import (_to_image, edge_color_lanes,
                                            sample_offsets,
                                            sample_pixel_lanes)
from vkrt_tpu_torch.runtime import map_tensors
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine

ROWS_PER_BLOCK = engine.BLOCK // L.LANES   # 4 rows of 128: one trace block


class Mesh(NamedTuple):
    """A 1-D device mesh: one torch.device per shard (repeats allowed)."""
    devices: tuple
    axis: str = "rays"

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, axis: str = "rays") -> Mesh:
    """A mesh of `devices` (torch devices or their names, in shard order;
    a device may repeat), or of every visible CUDA card when None. There
    is no CPU fallback: with None and no card it raises; pass ["cpu"] * k
    to shard on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): torch sees no CUDA card; pass "
                               "the devices (e.g. ['cpu'] * k) to shard on "
                               "the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh(): the device list is empty")
    return Mesh(devices, axis)


class Replicas(dict):
    """`replicate`'s result: {device: the tree there}, and `graphs`, the
    FrameGraph in which the sharded renderers keep each shard's captured
    graph for the frames that pass these replicas."""

    def __init__(self, items):
        super().__init__(items)
        self.graphs = graphs.FrameGraph()


def replicate(tree, mesh: Mesh) -> Replicas:
    """`tree` (tensors inside nested tuples and NamedTuples, such as
    (backend, tex, lights)) placed on each distinct device of `mesh`:
    {device: tree there}. Each tensor is copied once per device with
    `.to`, which returns it unchanged on its own device; a device listed
    k times holds one copy."""
    return Replicas((dev, map_tensors(lambda t: t.to(dev, non_blocking=True),
                                      tree))
                    for dev in dict.fromkeys(mesh.devices))


def shard_blocks(nb: int, n: int) -> tuple:
    """(rows per shard, padding rows) for `nb` rows of 128 lanes over `n`
    shards: every shard gets whole 512-ray trace blocks (the JAX
    package's per_dev, vkrt_tpu/parallel/mesh.py:64)."""
    per = -(-nb // (n * ROWS_PER_BLOCK)) * ROWS_PER_BLOCK
    return per, per * n - nb


def _ray_shard(backend, tex, lights, cfg: C.RenderConfig, rows: range,
               proj_inverse, view_inverse):
    """One shard of render_frame_sharded, on its device: the camera rays
    of its lane `rows` (those past the frame's are padding, which never
    trace), made there alone, and the rounds. Returns (accum
    f32[3,per,128], ray counts i32[per,128])."""
    origin_pt, dirs, valid = engine.camera_ray_blocks(proj_inverse,
                                                      view_inverse, cfg, rows)
    return engine.wavefront_rounds(backend, tex, origin_pt, dirs, lights,
                                   cfg, valid)


def render_frame_sharded(backend, tex, proj_inverse, view_inverse, lights,
                         cfg: C.RenderConfig, mesh: Mesh, replicas=None,
                         graph: bool | None = None):
    """engine.render_frame with the rays split over `mesh`: the same
    (framebuffer f32[H,W,3], rays i32[Nb,128]), on mesh.devices[0].

    `replicas` is replicate((backend, tex, lights), mesh), for a caller
    that renders many frames; made here when None (no copy on the
    devices where the scene already lies). `graph` is the renderers'
    (graphs.resolve, per device, with engine.host_wait), with `replicas`
    to keep the graphs in: captured, each shard's camera rays and rounds
    are one CUDA graph per (shard, device, rows, cfg, scene) in
    `replicas.graphs`, replayed after the camera is copied into its
    inputs; the gather stays eager. Without `replicas`, None is eager: a
    graph captured for one call would be replayed once."""
    home = mesh.devices[0]
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    nb = wp * hp // L.LANES
    per, _ = shard_blocks(nb, mesh.size)
    if replicas is None:
        graph = graph or False
        replicas = replicate((backend, tex, lights), mesh)
    wait = engine.host_wait(backend, cfg)
    accum, counts = [], []
    for k, dev in enumerate(mesh.devices):
        be, tx, li = replicas[dev]
        body = functools.partial(_ray_shard, be, tx, li, cfg,
                                 range(k * per, (k + 1) * per))
        if graphs.resolve(graph, dev, wait):
            key = ("rays", k, str(dev), per, cfg, id(be), id(tx), id(li),
                   tracing.enabled())
            a, c = replicas.graphs.run(key, body, (proj_inverse, view_inverse),
                                       dev, holds=(be, tx, li), copy=False)
        else:
            a, c = body(proj_inverse.to(dev), view_inverse.to(dev))
        accum.append(a.to(home, non_blocking=True))
        counts.append(c.to(home, non_blocking=True))
    accum = torch.cat(accum, dim=1)[:, :nb]
    fb = torch.stack([engine.untile(accum[k], hp, wp)[: cfg.height,
                                                      : cfg.width]
                      for k in range(3)], dim=-1)
    return fb, torch.cat(counts)[:nb]


def _setup(tree, cfg: C.RenderConfig, view, proj):
    with tracing.span("raster_setup", view.device):
        return build_raster_setup(tree, view, proj, cfg.width, cfg.height)


def _raster_shard(tex, cfg: C.RenderConfig, offsets, rows: range, setup,
                  scb, clb):
    """One shard of render_raster_frame_sharded, on its device: per MSAA
    sample, the pixel lanes of its lane `rows` (those past the frame's
    are padding, which never covers), made there alone, through
    edge_color_lanes. Returns f32[S,3,per,128]."""
    colors = []
    for s, off in enumerate(offsets):
        px, py, inside = sample_pixel_lanes(cfg, off, setup.device, rows)
        colors.append(edge_color_lanes(tex, setup, scb, clb, px, py, inside,
                                       f"s{s}"))
    return torch.stack(colors)


def render_raster_frame_sharded(tree, tex, view, proj, cfg: C.RenderConfig,
                                mesh: Mesh, msaa: int = 1, replicas=None,
                                graph: bool | None = None):
    """raster.pipeline.render_raster_frame_edge with the pixel blocks of
    every MSAA sample split over `mesh`: the same f32[H,W,3] frame, on
    mesh.devices[0]. The setup stage runs once, on the first device, and
    each shard's inputs get a copy of its rows. `tree` lies on the first
    device; `replicas` is replicate(tex, mesh), made here when None.
    `graph` as render_frame_sharded's (None without `replicas` is eager):
    captured, the setup is one CUDA graph on the first device and each
    shard's samples one on its device."""
    home = mesh.devices[0]
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    nb = wp * hp // L.LANES
    per, _ = shard_blocks(nb, mesh.size)
    offsets = sample_offsets(msaa)
    if replicas is None:
        graph = graph or False
        replicas = replicate(tex, mesh)
    if graphs.resolve(graph, home):
        setup = replicas.graphs.run(
            ("setup", str(home), id(tree), cfg.width, cfg.height,
             tracing.enabled()),
            functools.partial(_setup, tree, cfg), (view, proj), home,
            holds=(tree,), copy=False)
    else:
        setup = _setup(tree, cfg, view.to(home), proj.to(home))
    colors = []
    for k, dev in enumerate(mesh.devices):
        tx = replicas[dev]
        body = functools.partial(_raster_shard, tx, cfg, offsets,
                                 range(k * per, (k + 1) * per))
        if graphs.resolve(graph, dev):
            key = ("raster", k, str(dev), per, cfg, msaa, id(tx),
                   tracing.enabled())
            c = replicas.graphs.run(key, body, setup, dev, holds=(tx,),
                                    copy=False)
        else:
            c = body(*(x.to(dev, non_blocking=True) for x in setup))
        colors.append(c.to(home, non_blocking=True))
    acc = None
    for s in range(len(offsets)):
        img = _to_image(torch.cat([c[s] for c in colors], dim=1)[:, :nb],
                        cfg)
        acc = img if acc is None else acc + img
    return acc / float(len(offsets))
