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
exists beyond the gather, which is a plain `.to()` per shard.

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

from typing import NamedTuple

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from vkrt_tpu_torch import config as C
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


def replicate(tree, mesh: Mesh) -> dict:
    """`tree` (tensors inside nested tuples and NamedTuples, such as
    (backend, tex, lights)) placed on each distinct device of `mesh`:
    {device: tree there}. Each tensor is copied once per device with
    `.to`, which returns it unchanged on its own device; a device listed
    k times holds one copy."""
    return {dev: map_tensors(lambda t: t.to(dev, non_blocking=True), tree)
            for dev in dict.fromkeys(mesh.devices)}


def shard_blocks(nb: int, n: int) -> tuple:
    """(rows per shard, padding rows) for `nb` rows of 128 lanes over `n`
    shards: every shard gets whole 512-ray trace blocks (the JAX
    package's per_dev, vkrt_tpu/parallel/mesh.py:64)."""
    per = -(-nb // (n * ROWS_PER_BLOCK)) * ROWS_PER_BLOCK
    return per, per * n - nb


def _part(x, rows: slice, dev):
    """Rows `rows` of x (along axis -2) contiguous on `dev`: kernels C-F
    refuse strided views and every wrapper passes data_ptr()."""
    return x[..., rows, :].to(dev, non_blocking=True).contiguous()


def _pad_rows(x, pad: int, value):
    return F.pad(x, (0, 0, 0, pad), value=value)


def render_frame_sharded(backend, tex, proj_inverse, view_inverse, lights,
                         cfg: C.RenderConfig, mesh: Mesh, replicas=None):
    """engine.render_frame with the rays split over `mesh`: the same
    (framebuffer f32[H,W,3], rays i32[Nb,128]), on mesh.devices[0].

    `replicas` is replicate((backend, tex, lights), mesh), for a caller
    that renders many frames; made here when None (no copy on the
    devices where the scene already lies)."""
    home = mesh.devices[0]
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    origin_pt, dirs, valid = engine.camera_ray_blocks(
        proj_inverse.to(home), view_inverse.to(home), cfg)
    nb = dirs.shape[1]
    per, pad = shard_blocks(nb, mesh.size)
    # padding rays: direction (1,1,1) normalised, never valid; the real
    # rays are not normalised again, which could move their last bit
    fill = L.normalize3(torch.ones((3, pad, L.LANES), device=home))
    dirs = torch.cat([dirs, fill], dim=1)
    valid = _pad_rows(valid, pad, False)
    if replicas is None:
        replicas = replicate((backend, tex, lights), mesh)
    accum, counts = [], []
    for k, dev in enumerate(mesh.devices):
        be, tx, li = replicas[dev]
        rows = slice(k * per, (k + 1) * per)
        a, c = engine.wavefront_rounds(be, tx, origin_pt.to(dev), _part(
            dirs, rows, dev), li, cfg, _part(valid, rows, dev))
        accum.append(a.to(home, non_blocking=True))
        counts.append(c.to(home, non_blocking=True))
    accum = torch.cat(accum, dim=1)[:, :nb]
    fb = torch.stack([engine.untile(accum[k], hp, wp)[: cfg.height,
                                                      : cfg.width]
                      for k in range(3)], dim=-1)
    return fb, torch.cat(counts)[:nb]


def render_raster_frame_sharded(tree, tex, view, proj, cfg: C.RenderConfig,
                                mesh: Mesh, msaa: int = 1, replicas=None):
    """raster.pipeline.render_raster_frame_edge with the pixel blocks of
    every MSAA sample split over `mesh`: the same f32[H,W,3] frame, on
    mesh.devices[0]. The setup stage runs once, on the first device, and
    its rows are replicated like the scene. `tree` lies on the first
    device; `replicas` is replicate(tex, mesh), made here when None."""
    home = mesh.devices[0]
    with record_function("raster_setup"):
        setup = build_raster_setup(tree, view.to(home), proj.to(home),
                                   cfg.width, cfg.height)
    parts = replicate(setup, mesh)
    if replicas is None:
        replicas = replicate(tex, mesh)
    offsets = sample_offsets(msaa)
    acc = None
    for s, off in enumerate(offsets):
        px, py, inside = sample_pixel_lanes(cfg, off, home)
        nb = px.shape[0]
        per, pad = shard_blocks(nb, mesh.size)
        px, py = _pad_rows(px, pad, 0.0), _pad_rows(py, pad, 0.0)
        inside = _pad_rows(inside, pad, False)
        colors = []
        for k, dev in enumerate(mesh.devices):
            rows = slice(k * per, (k + 1) * per)
            color = edge_color_lanes(
                replicas[dev], *parts[dev], _part(px, rows, dev),
                _part(py, rows, dev), _part(inside, rows, dev), f"s{s}")
            colors.append(color.to(home, non_blocking=True))
        img = _to_image(torch.cat(colors, dim=1)[:, :nb], cfg)
        acc = img if acc is None else acc + img
    return acc / float(len(offsets))
