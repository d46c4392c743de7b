"""Wavefront frame engine — counterpart of vkrt_tpu/wavefront/engine.py.

Flat wavefront rounds over the whole frame, as in the JAX package:

  ray gen → closest-hit trace with attributes (kernel A) → shade →
  one shadow trace for all lights (kernel B) → reflection carry →
  repeat up to max_depth → framebuffer

Per-ray state is lane-major ([Nb,128] scalars, [3,Nb,128] vectors) in
the engine's tiled ray order (16x32-pixel tiles, one 8x16 subtile per
128-ray group), so frames and every intermediate compare element by
element with the JAX engine. Dead rays park with tmax = 0.

At depth >= 1 the shadow wavefront is reordered before kernel B and
restored after it, as RenderConfig's defaults ask (consolidate_secondary,
group_sort_shadows, partition_shadows): the live-ray pack (kernels C, D),
the in-block lane sort (E, F) and the group partition. Blocked masks do
not depend on the order, so every combination of the three flags gives
the same frame.

Only the dense backend is ported. RenderConfig flags that need machinery
not yet ported raise NotImplementedError naming the ROADMAP.md item;
none is silently ignored.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from vkrt_tpu import config as C
from vkrt_tpu.scene import flatten_model, load_model
from vkrt_tpu.scene.textures import build_material_heap, material_slots
from vkrt_tpu_torch import runtime
from vkrt_tpu_torch.accel.clusters import build_clusters, scene_attrs
from vkrt_tpu_torch.rt.dense import trace_dense
from vkrt_tpu_torch.rt.occl_multi import occluded_multi
from vkrt_tpu_torch.shade import shading
from vkrt_tpu_torch.shade.sampling import (sample_material,
                                           sample_material_compact)
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import lanesort, pack, resort

TILE_Y, TILE_X = 16, 32           # 512 pixels = one tile
PIXEL_CENTER = (0.5, 0.5)         # sample offset inside each pixel

# flag → the ROADMAP.md item that ports it (checked before any frame)
_UNPORTED_FLAGS = {
    "rebuild_per_frame": "queue 1 item 8 (per-frame accel update)",
    "mip_lod": "queue 1 item 4 (trilinear sampling, ray_diff_lod)",
    "resort_secondary": "queue 1 item 13 (not ported this round)",
    "recheck_secondary": "queue 1 item 13 (not ported this round)",
    "partition_closest": "queue 1 item 13 (not ported this round)",
    "sub_gate_shadows": "queue 1 item 13 (not ported this round)",
    "sub_gate_closest": "queue 1 item 13 (not ported this round)",
}


def check_supported(cfg: C.RenderConfig) -> None:
    """Raise NotImplementedError if `cfg` turns on unported machinery."""
    on = [f for f in _UNPORTED_FLAGS if getattr(cfg, f)]
    if on:
        items = "; ".join(f"{f}: ROADMAP.md {_UNPORTED_FLAGS[f]}" for f in on)
        raise NotImplementedError(
            f"RenderConfig flags not ported to vkrt_tpu_torch yet — {items}. "
            "Turn them off (dataclasses.replace(cfg, flag=False)).")


class TextureArrays(NamedTuple):
    """Packed per-material-slot triple heap (scene/textures.py
    build_material_heap): one 48-byte row per texel."""
    texels_tri: torch.Tensor    # u8[N,48]
    level_offset: torch.Tensor  # i32[M,L]
    level_width: torch.Tensor   # i32[M,L]
    level_height: torch.Tensor  # i32[M,L]


def texture_arrays_from_numpy(texels_tri, level_offset, level_width,
                              level_height, device) -> TextureArrays:
    """TextureArrays on `device` from numpy arrays (a heap built by the
    shared scene code, or carried from the JAX package)."""
    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(device)
    return TextureArrays(texels_tri=put(texels_tri, np.uint8),
                         level_offset=put(level_offset, np.int32),
                         level_width=put(level_width, np.int32),
                         level_height=put(level_height, np.int32))


def texture_arrays(images, flat, device) -> TextureArrays:
    """Build TextureArrays from model images + a FlatScene (slots agree
    with accel/clusters.scene_attrs by construction)."""
    triples, _ = material_slots(flat)
    heap = build_material_heap(images, triples)
    return texture_arrays_from_numpy(heap.texels_tri, heap.level_offset,
                                     heap.level_width, heap.level_height,
                                     device)


def generate_rays(proj_inverse, view_inverse, width: int, height: int):
    """Camera rays through the pixel centres (ref: shaders/shader.rgen:
    30-38) as [H,W] component grids: ((ox,oy,oz), (dx,dy,dz))."""
    dev = proj_inverse.device
    ox, oy = PIXEL_CENTER
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + ox) \
        / width * 2.0 - 1.0
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + oy) \
        / height * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pi, vi = proj_inverse, view_inverse
    tgt = [pi[k, 0] * gx + pi[k, 1] * gy + pi[k, 2] + pi[k, 3]
           for k in range(3)]
    n = torch.sqrt(torch.clamp(tgt[0] * tgt[0] + tgt[1] * tgt[1]
                               + tgt[2] * tgt[2], min=1e-24))
    dv = [t / n for t in tgt]
    d = [vi[k, 0] * dv[0] + vi[k, 1] * dv[1] + vi[k, 2] * dv[2]
         for k in range(3)]
    o = [vi[k, 3].expand(d[0].shape) for k in range(3)]
    return o, d


def tile(img):
    """[H,W] scalar grid → [Nb,128] lane-major, tile-major ray order (each
    128-lane group is one 8x16-pixel subtile of a 16x32 tile)."""
    h, w = img.shape
    ty, tx = TILE_Y, TILE_X
    x = img.reshape(h // ty, 2, ty // 2, w // tx, 2, tx // 2)
    flat = x.permute(0, 3, 1, 4, 2, 5).reshape(-1)
    return flat.reshape(-1, L.LANES)


def untile(lanes, height: int, width: int):
    """[Nb,128] → [H,W] (inverse of tile)."""
    flat = lanes.reshape(-1)
    ty, tx = TILE_Y, TILE_X
    x = flat.reshape(height // ty, width // tx, 2, 2, ty // 2, tx // 2)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(height, width)


def _pad_dims(width, height):
    return -(-width // TILE_X) * TILE_X, -(-height // TILE_Y) * TILE_Y


def _pad_grid(g, wp, hp, value):
    h, w = g.shape
    return torch.nn.functional.pad(g, (0, wp - w, 0, hp - h), value=value)


BLOCK = 512                       # rays per trace block (= TILE_Y*TILE_X)
OCCL_BLOCK = 1024                 # rays per occlusion block where it divides


def _occl_block(n_rays: int) -> int:
    """Block of the depth>=1 shadow reorder: the JAX engine's occlusion
    block (OCCL_BLOCK, else BLOCK), which sets the lane sort's blocks and
    the packed prefix's cap."""
    return OCCL_BLOCK if n_rays % OCCL_BLOCK == 0 else BLOCK


class DenseBackend(NamedTuple):
    """Cluster tree traced by kernels A and B; `scene_aabb` f32[2,3]
    (min, max of the scene's vertices) bounds the reorder's cell keys."""
    tree: object  # ClusterTree
    scene_aabb: torch.Tensor

    def closest(self, o, d, tmax):
        t, slot, u, v, attrs = trace_dense(self.tree, o, d, tmax)
        return t, u, v, attrs, slot >= 0

    def occluded_multi(self, light_pts, sd, st):
        return occluded_multi(self.tree, light_pts, sd, st)


def make_backend(flat, kind: str, device) -> DenseBackend:
    """Build a trace backend from a FlatScene on `device`."""
    if kind != "dense":
        raise NotImplementedError(
            f"backend {kind!r} is not ported (ROADMAP.md queue 1 item 10); "
            "only 'dense' is")
    idx = np.asarray(flat.indices, dtype=np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0
    tree = build_clusters(v0, e1, e2, attrs=scene_attrs(flat),
                          with_attributes=True, device=device)
    pos = np.asarray(flat.positions, dtype=np.float32)
    aabb = torch.from_numpy(np.stack([pos.min(axis=0), pos.max(axis=0)]))
    return DenseBackend(tree=tree, scene_aabb=aabb.to(device))


def render_frame(backend, tex: TextureArrays, proj_inverse, view_inverse,
                 lights, cfg: C.RenderConfig):
    """Render one frame. Returns (framebuffer f32[H,W,3], rays i32[Nb,128]
    traced per pixel)."""
    wp, hp = _pad_dims(cfg.width, cfg.height)
    origin_pt, dirs, valid = camera_ray_blocks(proj_inverse, view_inverse,
                                               cfg)
    accum, ray_count = wavefront_rounds(backend, tex, origin_pt, dirs,
                                        lights, cfg, valid)
    fb = torch.stack([untile(accum[k], hp, wp)[: cfg.height, : cfg.width]
                      for k in range(3)], dim=-1)
    return fb, ray_count


def render_frame_u8(backend, tex: TextureArrays, proj_inverse, view_inverse,
                    lights, cfg: C.RenderConfig):
    """render_frame + on-device UNORM8 quantization (truncating cast, as
    the JAX engine) and the ray-count sum."""
    fb, ray_count = render_frame(backend, tex, proj_inverse, view_inverse,
                                 lights, cfg)
    fb8 = torch.clamp(fb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return fb8, ray_count.sum()


def camera_ray_blocks(proj_inverse, view_inverse, cfg: C.RenderConfig):
    """Camera rays padded to tile multiples, lane-major coherent blocks.
    Returns (origin_pt f32[3], dirs f32[3,Nb,128], valid bool[Nb,128] —
    False on tile-padding rays, which neither trace nor count)."""
    wp, hp = _pad_dims(cfg.width, cfg.height)
    _, d = generate_rays(proj_inverse, view_inverse, cfg.width, cfg.height)
    origin_pt = view_inverse[:3, 3]
    d = torch.stack([tile(_pad_grid(c, wp, hp, 1.0)) for c in d])
    ones = torch.ones((cfg.height, cfg.width), dtype=torch.bool,
                      device=d.device)
    valid = tile(_pad_grid(ones, wp, hp, False))
    return origin_pt, L.normalize3(d), valid


def wavefront_rounds(backend, tex: TextureArrays, origin_pt, dirs, lights,
                     cfg: C.RenderConfig, valid):
    """The trace→shade rounds over a lane-major wavefront ([3,Nb,128]);
    `valid` marks the rays that trace (False on tile padding). Returns
    (accum [3,Nb,128], ray_count i32[Nb,128])."""
    check_supported(cfg)
    dev = dirs.device
    nb = dirs.shape[1]
    shape = (nb, L.LANES)
    accum = torch.zeros((3,) + shape, device=dev)
    attenuation = torch.ones(shape, device=dev)
    active = valid
    ray_count = torch.zeros(shape, dtype=torch.int32, device=dev)
    lights = lights[:cfg.num_lights]
    origins = origin_pt[:, None, None].expand((3,) + shape).contiguous()

    for depth in range(cfg.max_depth):
        # record_function ranges name the layers in torch.profiler traces
        # (the JAX engine's jax.named_scope ranges)
        with record_function(f"trace_closest_d{depth}"):
            tmax = torch.where(active, C.RAY_TMAX, 0.0)
            t, u, v, attrs, hitm = backend.closest(origins, dirs, tmax)
        dcount = active.to(torch.float32)
        hit = hitm & active
        miss = active & ~hitm

        # miss shader: sky, unattenuated (ref: shader.rmiss:17); Python
        # scalars, so no host-to-device copy waits for the card
        dacc = torch.stack([torch.where(miss, float(c), 0.0)
                            for c in C.SKY_COLOR])

        pos, normal, uv, tangent, mat_ids = shading.interpolate(attrs, u, v)
        with record_function(f"sample_d{depth}"):
            if depth == 0:
                base4, mr4, nmap4 = sample_material(
                    tex.texels_tri, tex.level_offset, tex.level_width,
                    tex.level_height, mat_ids[0], uv)
            else:
                # sparse depth>=1 wavefront: sample live rows only
                base4, mr4, nmap4 = sample_material_compact(
                    tex.texels_tri, tex.level_offset, tex.level_width,
                    tex.level_height, mat_ids[0], uv, hit)
        base = base4[:3]

        if cfg.flat_albedo:
            accum = accum + dacc + torch.where(hit[None], base, 0.0)
            ray_count = ray_count + dcount.to(torch.int32)
            break

        map_n = nmap4[:3]
        metallic = mr4[2]
        pn = shading.perturbed_normal(normal, tangent, map_n)

        total_light = torch.zeros(shape, device=dev)
        nl = cfg.num_lights
        geo = [shading.light_geometry(pos, lights[li]) for li in range(nl)]
        ndotls = [L.dot3(pn, g[0]) for g in geo]
        occs = [None] * nl
        if cfg.enable_shadows and nl > 0:
            casts = [hit & (nd > 0) for nd in ndotls]
            with record_function(f"trace_shadow_d{depth}"):
                occs = list(trace_shadows(backend, lights, pos, geo,
                                          casts, cfg, depth))
            for c in casts:
                dcount = dcount + c.to(torch.float32)

        if cfg.enable_reflections:
            reflective = hit & (metallic > C.METALLIC_THRESHOLD)
            # attenuation updates BEFORE the (1 - attenuation) scale —
            # order quirk preserved (ref: shader.rchit:165-167)
            new_att = attenuation * (C.REFLECT_SCALE * metallic)
            att_updated = torch.where(reflective, new_att, attenuation)
        else:
            reflective = torch.zeros_like(hit)
            att_updated = attenuation

        for li in range(nl):
            diffuse = torch.clamp(ndotls[li], 0.0, 1.0)
            mult = torch.ones(shape, device=dev)
            if cfg.enable_shadows:
                cast = hit & (ndotls[li] > 0)
                mult = torch.where(cast & occs[li], C.SHADOW_MULTIPLIER, 1.0)
            total_light = total_light + diffuse * geo[li][2] * mult

        hit_value = (base * (total_light * attenuation)[None]
                     + base * C.AMBIENT)
        if cfg.enable_reflections:
            hit_value = torch.where(reflective[None],
                                    hit_value * (1.0 - att_updated)[None],
                                    hit_value)
        dacc = dacc + torch.where(hit[None], hit_value, 0.0)

        attenuation = att_updated
        origins = L.where3(reflective, pos, origins)
        dirs = L.where3(reflective, shading.reflect(dirs, pn), dirs)
        active = reflective
        accum = accum + dacc
        ray_count = ray_count + dcount.to(torch.int32)

    return accum, ray_count


def trace_shadows(backend, lights, pos, geo, casts, cfg: C.RenderConfig,
                  depth: int):
    """Blocked masks bool[L,Nb,128] of all lights' shadow segments in ONE
    kernel-B dispatch, traced from the light toward the surface point;
    rays a hit does not cast (`casts`) park at tmax 0.

    At depth >= 1 the wavefront is reordered before B and restored after
    it (vkrt_tpu/wavefront/engine.py:550-701): with partition_shadows,
    `partition_points` and `unpartition` (pack first when
    consolidate_secondary is on); otherwise the group sort
    (group_sort_shadows) and the pack of all 16 segment channels
    (consolidate_secondary), each optional."""
    nl = len(casts)
    oblk = _occl_block(pos.shape[1] * L.LANES)
    if cfg.partition_shadows and depth >= 1:
        castmask = casts[0].to(torch.float32)
        for s in range(1, nl):
            castmask = castmask + casts[s].to(torch.float32) * float(1 << s)
        pos_p, cmi, undo = partition_points(
            pos, castmask, backend.scene_aabb, cfg.consolidate_secondary,
            oblk)
        # sd/st from the moved points: light_geometry is elementwise, so
        # they are bit-equal to the moved precomputed arrays
        sd, st = [], []
        for li in range(nl):
            ldir, ldist, _ = shading.light_geometry(pos_p, lights[li])
            sd.append(-ldir)
            st.append(torch.where(((cmi >> li) & 1) > 0,
                                  ldist - C.RAY_TMIN, 0.0))
        occ = backend.occluded_multi(lights, torch.stack(sd),
                                     torch.stack(st))
        return unpartition(occ, undo)

    sd = torch.stack([-g[0] for g in geo])                  # [L,3,Nb,128]
    st = torch.stack([torch.where(c, g[1] - C.RAY_TMIN, 0.0)
                      for c, g in zip(casts, geo)])         # [L,Nb,128]
    gsort = cfg.group_sort_shadows and depth >= 1
    cons = cfg.consolidate_secondary and depth >= 1
    if gsort:
        gperm = resort.radix_partition_perm(
            resort.group_cell_key(pos, (st > 0).any(dim=0),
                                  backend.scene_aabb))
        sd = resort.permute_groups(sd, gperm)
        st = resort.permute_groups(st, gperm)
    if cons:
        grank = pack.consolidate_plan((st > 0).any(dim=0))
        nb = st.shape[1]
        pk = pack.consolidate(
            torch.cat([sd.reshape(3 * nl, nb, L.LANES), st]), grank)
        sd = pk[:3 * nl].reshape(nl, 3, nb, L.LANES)
        st = pk[3 * nl:]
    occ = backend.occluded_multi(lights, sd, st)
    if cons:
        occ = pack.scatter_back(occ.to(torch.float32), grank) > 0.5
    if gsort:
        occ = resort.permute_groups(occ, resort.inverse_permutation(gperm))
    return occ


class Undo(NamedTuple):
    """What `unpartition` needs to restore the original ray order."""
    grank: torch.Tensor | None  # pack's live ranks (None: no pack)
    rank: torch.Tensor          # lane sort's ranks of the first capr rows
    ginv: torch.Tensor          # inverse group permutation
    block: int                  # lane sort block


def partition_points(pos, castmask, scene_aabb, pack_first: bool,
                     block: int):
    """The depth>=1 shadow repartition (vkrt_tpu/wavefront/engine.py
    :588-639): optionally pack the live rays (castmask > 0) to the front
    (kernel C), stable-sort each block's lanes by the fine surface-point
    cell (kernel E) — after a pack only the leading quarter of the rows,
    once there are 8 blocks or more — then sort whole 128-lane groups by
    their mean live cell. Only the point and the cast bitmask move.

    pos f32[3,Nb,128], castmask f32[Nb,128] (bit s: light s casts).
    Returns (moved points f32[3,Nb,128], moved bitmask i32[Nb,128],
    Undo)."""
    x = torch.cat([pos, castmask[None]])                    # [4,Nb,128]
    grank = None
    if pack_first:
        grank = pack.consolidate_plan(castmask > 0)
        x = pack.consolidate(x, grank)
    nb = x.shape[1]
    rpb = block // L.LANES
    capr = nb
    if pack_first and nb // rpb >= 8:
        # the pack left every live ray in the leading rows; the tail
        # beyond the cap passes through unsorted
        capr = -(-(nb // rpb) // 4) * rpb
    head = x[:, :capr].contiguous()
    key = lanesort.cell_key_fine(head[:3], head[3] > 0, scene_aabb)
    srt, rank = lanesort.lane_sort(head, key, block=block)
    if capr < nb:
        srt = torch.cat([srt, x[:, capr:]], dim=1)
    gperm = resort.radix_partition_perm(
        resort.group_cell_key(srt[:3], srt[3] > 0, scene_aabb))
    srt = resort.permute_groups(srt, gperm)
    return (srt[:3], srt[3].to(torch.int32),
            Undo(grank, rank, resort.inverse_permutation(gperm), block))


def unpartition(occ, undo: Undo):
    """Blocked masks bool[L,Nb,128] of `partition_points`' order → the
    original ray order (vkrt_tpu/wavefront/engine.py:684-697): inverse
    group permutation, lane unsort of the first capr rows (kernel F),
    scatter back from the pack (kernel D)."""
    occ_f = resort.permute_groups(occ.to(torch.float32), undo.ginv)
    capr = undo.rank.shape[0]
    inv = lanesort.lane_unsort(occ_f[:, :capr].contiguous(), undo.rank,
                               block=undo.block)
    if capr < occ_f.shape[1]:
        inv = torch.cat([inv, occ_f[:, capr:]], dim=1)
    if undo.grank is not None:
        inv = pack.scatter_back(inv, undo.grank)
    return inv > 0.5


class Renderer:
    """High-level renderer: scene in, frames out (the Raytracer analogue).

    `scene` is a `vkrt_tpu.scene.Model` or the path of a glTF file. The
    constructor builds the cluster tree on the host and moves it and the
    material heap to `device`; render_async() enqueues one frame."""

    def __init__(self, scene, cfg: C.RenderConfig, device,
                 quantize: bool = False):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.quantize = quantize    # u8 fb + scalar ray count on device
        runtime.exact_f32()
        if isinstance(scene, (str, os.PathLike)):
            scene = load_model(os.fspath(scene))
        self.model = scene
        self.flat = flatten_model(scene)
        self.tex = texture_arrays(scene.images, self.flat, self.device)
        self.backend = make_backend(self.flat, "dense", self.device)
        self.lights = torch.as_tensor(C.LIGHT_POSITIONS, device=self.device)

    def render_async(self, camera):
        """Enqueue a frame; returns device tensors (fb, ray_count) without
        waiting for the card. Per-frame accel updates (the JAX Renderer's
        `transform`) are ROADMAP.md queue 1 item 8."""

        def mat(m):
            # a blocking host-to-device copy would wait for the frames
            # already queued; from pinned memory the copy is queued too
            m = torch.from_numpy(np.array(m, np.float32))
            if self.device.type == "cuda":
                m = m.pin_memory()
            return m.to(self.device, non_blocking=True)

        frame = render_frame_u8 if self.quantize else render_frame
        return frame(self.backend, self.tex, mat(camera.proj_inverse),
                     mat(camera.view_inverse), self.lights, self.cfg)

    def render(self, camera):
        """Synchronous render: enqueue + materialize on host."""
        fb, rays = self.render_async(camera)
        return fb.cpu().numpy(), int(rays.sum())
