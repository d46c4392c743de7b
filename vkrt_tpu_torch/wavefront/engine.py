"""Wavefront frame engine — counterpart of vkrt_tpu/wavefront/engine.py.

Flat wavefront rounds over the whole frame, as in the JAX package:

  ray gen → closest-hit trace with attributes (kernel A) → shade
  (kernels L and K) → one shadow trace for all lights (kernel B) →
  reflection carry (kernel L) → repeat up to max_depth → framebuffer

Per-ray state is lane-major ([Nb,128] scalars, [3,Nb,128] vectors) in
the engine's tiled ray order (16x32-pixel tiles, one 8x16 subtile per
128-ray group), so frames and every intermediate compare element by
element with the JAX engine. Dead rays park with tmax = 0.

At depth >= 1 the shadow wavefront is reordered before kernel B and
restored after it, as RenderConfig's defaults ask (consolidate_secondary,
group_sort_shadows, partition_shadows): the live-ray pack (kernels C, D),
the in-block lane sort (E, F) and the group partition. Blocked masks do
not depend on the order, so every combination of the three flags gives
the same frame. A backend with `per_light` set traces each light's
segments with kernel A' instead of B, to the same masks.

The five secondary-dispatch options of RenderConfig, all off by default,
run as in the JAX engine (vkrt_tpu/wavefront/engine.py:344-425, :511-701)
and leave the frame as it is: `resort_secondary` sorts the reflection
rays by direction octant and every depth's shadow segments by surface
cell (ray granularity, inverted after the trace); `partition_closest`
runs each depth >= 1 iteration in lane-sorted, group-partitioned order
(kernels E, F) and returns only its contributions; `recheck_secondary`
and `sub_gate_{closest,shadows}` select kernel A's and B's modes
(rt/dense.py). Kernel A's tie rule makes the nearest hit independent of
the ray order; masks are any-hits.

`Renderer` also runs the per-frame accel update (RenderConfig
.rebuild_per_frame, or a `transform` per frame): a refit of the tree's
boxes, or a full device rebuild (SAH or Morton order).

Two trace backends, as in the JAX package: "dense" (the cluster tree and
kernels A, A', B) and "reference" (an LBVH and its plain-PyTorch
traversal, rt/traverse.py: slow, independent of the kernels; it takes
`resort_secondary` and ignores the kernel modes, as in the JAX package).
With `mip_lod` the depth-0 samples are trilinear at a per-ray level from
lane-neighbour differentials.

On a CUDA device `Renderer.render_async` replays one captured CUDA graph
per static key (graphs.py; the JAX engine's jitted frame): the accel
update and the frame, reading only the frame's inputs (`frame_inputs`:
the camera matrices, the transform, the Morton AABB). `host_wait` names
the frames that stay eager.

Spans (tracing.py; they survive the replay as marks on the card):
`frame` holds `accel_update`, `camera_rays`, per depth d
`trace_closest_d{d}`, `shade_d{d}`, `sample_d{d}`, `trace_shadow_d{d}`,
and `resolve`; every kernel falls in one of them. A full rebuild's
`accel_update` holds `accel_order` (the Morton sort or the device SAH
order); the instance transform and the packing run in `accel_update`
itself. A refit's `accel_update` holds `accel_refit`, which runs all of
the refit (accel/refit.py::refit_clusters: the transform, the boxes,
the copy of the rows). While tracing is on, `accel_area` follows
`accel_update` and counts the new tree's cluster area.
`shade_d{d}` covers the three steps of kernel L (shade/shading.py):
the interpolation before `sample_d{d}`, the perturbed normal and the
shadow rays before `trace_shadow_d{d}`, and after it the miss shader,
the light sum, the colour and ray count and the reflection carry (which
it updates in place): up to three intervals a depth. Counters per
depth: `live_closest_d{d}` (the rays kernel A traces live) and
`cast_shadow_d{d}` (the segments kernel B traces live, summed over the
lights); summed over the depths they are the frame's ray count. `sample_fetch_d{d}` (in `sample_d{d}`): the lanes
that hit, whose heap row the material sample (kernel K) reads.
`sample_d{d}` runs kernel K (shade/sampling.py::sample_hits), but with
`mip_lod` at depth 0. With an accel update, `accel_cl_area`: the
summed surface area of the updated tree's cluster boxes
(accel/clusters.py::cluster_area_fixed, 1/2^16 squared world units),
counted in `frame_body`'s `accel_area` span, outside `accel_update`,
and not in `_update_tree`, which a caller may capture alone. Kernels
A, A', B, K and L record the lanes they are launched over
(tracing.lanes).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import graphs, runtime, tracing
from vkrt_tpu_torch.accel.clusters import (build_clusters,
                                           cluster_area_fixed, scene_attrs)
from vkrt_tpu_torch.accel.lbvh import build_lbvh
from vkrt_tpu_torch.accel.refit import refit_clusters
from vkrt_tpu_torch.rt import traverse
from vkrt_tpu_torch.rt.dense import trace_dense
from vkrt_tpu_torch.rt.occl_multi import occluded_multi
from vkrt_tpu_torch.scene import flatten_model, load_model
from vkrt_tpu_torch.scene.textures import build_material_heap, material_slots
from vkrt_tpu_torch.shade import shading
from vkrt_tpu_torch.shade.shading import (cast_bits, shade_combine,
                                          shade_interp, shade_lights)
from vkrt_tpu_torch.shade.sampling import (ray_diff_lod, sample_hits,
                                           sample_material_trilinear)
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import lanesort, pack, resort

TILE_Y, TILE_X = 16, 32           # 512 pixels = one tile
PIXEL_CENTER = (0.5, 0.5)         # sample offset inside each pixel

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


def generate_rays(proj_inverse, view_inverse, width: int, height: int,
                  off=PIXEL_CENTER):
    """Camera rays through the point `off` of each pixel (the centre by
    default; the raster path passes its MSAA sample offsets) (ref:
    shaders/shader.rgen:30-38) as [H,W] component grids: ((ox,oy,oz),
    (dx,dy,dz))."""
    dev = proj_inverse.device
    ox, oy = (float(c) for c in off)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + ox) \
        / width * 2.0 - 1.0
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + oy) \
        / height * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d = _ray_dirs(proj_inverse, view_inverse, gx, gy)
    o = [view_inverse[k, 3].expand(d[0].shape) for k in range(3)]
    return o, d


def _ray_dirs(pi, vi, gx, gy):
    """World-space directions (dx, dy, dz) of the rays through the NDC
    points (gx, gy), elementwise: any grid of them gives the same bits at
    the same point."""
    tgt = [pi[k, 0] * gx + pi[k, 1] * gy + pi[k, 2] + pi[k, 3]
           for k in range(3)]
    n = torch.sqrt(torch.clamp(tgt[0] * tgt[0] + tgt[1] * tgt[1]
                               + tgt[2] * tgt[2], min=1e-24))
    dv = [t / n for t in tgt]
    return [vi[k, 0] * dv[0] + vi[k, 1] * dv[1] + vi[k, 2] * dv[2]
            for k in range(3)]


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
    the packed prefix's cap. partition_closest's lane sort takes the same
    block (the JAX engine's `cblk`)."""
    return OCCL_BLOCK if n_rays % OCCL_BLOCK == 0 else BLOCK


class DenseBackend(NamedTuple):
    """Cluster tree traced by kernels A, A' and B; `scene_aabb` f32[2,3]
    (min, max of the scene's vertices) bounds the reorder's cell keys.

    `per_light=True` (set with `_replace`) makes `occluded_multi` trace
    each light's segments in its own kernel-A' dispatch, every block's
    origin the light, in place of one kernel-B dispatch for all lights —
    the JAX engine's VKRT_NO_MULTI_OCCL path. Masks, hence frames, are
    the same either way."""
    tree: object  # ClusterTree
    scene_aabb: torch.Tensor
    per_light: bool = False

    def closest(self, o, d, tmax, sub_gate=False, pregate=""):
        t, slot, u, v, attrs = trace_dense(self.tree, o, d, tmax,
                                           sub_gate=sub_gate, pregate=pregate)
        return t, u, v, attrs, slot >= 0

    def occluded(self, o, d, tmax):
        """Blocked mask bool[Nb,128] of segments with per-ray origins."""
        _, slot, _, _ = trace_dense(self.tree, o, d, tmax, occlusion=True,
                                    with_attributes=False)
        return slot >= 0

    def occluded_point(self, o_pts, d, tmax, block=BLOCK):
        """As `occluded`, all rays of a block of `block` sharing one
        origin: o_pts f32[N/block, 3]."""
        _, slot, _, _ = trace_dense(self.tree, o_pts, d, tmax, occlusion=True,
                                    with_attributes=False, point_origin=True,
                                    block=block)
        return slot >= 0

    def occluded_multi(self, light_pts, sd, st, block=BLOCK, sub_gate=False,
                       pregate=""):
        """Kernel B in the asked mode; per light, kernel A' (which has no
        modes: the JAX engine's per-light path passes none)."""
        if self.per_light:
            nob = sd.shape[2] * L.LANES // block
            return torch.stack([
                self.occluded_point(light_pts[s][None, :].expand(nob, 3)
                                    .contiguous(), sd[s], st[s], block)
                for s in range(light_pts.shape[0])])
        return occluded_multi(self.tree, light_pts, sd, st,
                              sub_gate=sub_gate, pregate=pregate)


class ReferenceBackend(NamedTuple):
    """LBVH traced by rt/traverse.py (plain PyTorch) and a per-triangle
    attribute table gathered after the trace: the JAX package's XLA
    reference backend. Shadows trace each light's segments from the
    light, one traversal per light."""
    bvh: object                # BVH2
    attr_table: torch.Tensor   # f32[T,36], original triangle order
    scene_aabb: torch.Tensor   # f32[2,3], as DenseBackend's

    def closest(self, o, d, tmax, sub_gate=False, pregate=""):
        """(sub_gate, pregate: the dense kernels' modes; ignored.)"""
        t, tri, u, v = traverse.trace_closest(
            self.bvh, L.from_cvec(o), L.from_cvec(d), C.RAY_TMIN,
            L.from_lanes(tmax))
        attrs = self.attr_table[torch.clamp(tri, min=0).long()]   # [N,36]
        attrs = torch.movedim(attrs.reshape(-1, L.LANES, 36), -1, 0)
        return (L.to_lanes(t), L.to_lanes(u), L.to_lanes(v), attrs,
                L.to_lanes(tri >= 0))

    def occluded(self, o, d, tmax):
        return L.to_lanes(traverse.trace_occluded(
            self.bvh, L.from_cvec(o), L.from_cvec(d), C.RAY_TMIN,
            L.from_lanes(tmax)))

    def occluded_multi(self, light_pts, sd, st, block=BLOCK, sub_gate=False,
                       pregate=""):
        return torch.stack([
            self.occluded(light_pts[s][:, None, None].expand(sd[s].shape),
                          sd[s], st[s])
            for s in range(light_pts.shape[0])])


BACKENDS = ("dense", "reference")


def make_backend(flat, kind: str, device):
    """Build a trace backend ("dense" or "reference") from a FlatScene
    on `device`."""
    if kind not in BACKENDS:
        raise ValueError(f"backend {kind!r} not in {BACKENDS}")
    idx = np.asarray(flat.indices, dtype=np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0
    pos = np.asarray(flat.positions, dtype=np.float32)
    aabb = torch.from_numpy(np.stack([pos.min(axis=0), pos.max(axis=0)]))
    attrs = scene_attrs(flat)
    if kind == "dense":
        tree = build_clusters(v0, e1, e2, attrs=attrs, with_attributes=True,
                              device=device)
        return DenseBackend(tree=tree, scene_aabb=aabb.to(device))

    def put(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    table = np.concatenate([v0, e1, e2] + [attrs[k] for k in (
        "n0", "n1", "n2", "uv0", "uv1", "uv2", "t0", "t1", "t2", "mat")],
        axis=1)
    return ReferenceBackend(bvh=build_lbvh(put(v0), put(e1), put(e2)),
                            attr_table=put(table), scene_aabb=aabb.to(device))


def render_frame(backend, tex: TextureArrays, proj_inverse, view_inverse,
                 lights, cfg: C.RenderConfig):
    """Render one frame. Returns (framebuffer f32[H,W,3], rays i32[Nb,128]
    traced per pixel)."""
    wp, hp = _pad_dims(cfg.width, cfg.height)
    dev = proj_inverse.device
    with tracing.span("camera_rays", dev):
        origin_pt, dirs, valid = camera_ray_blocks(proj_inverse,
                                                   view_inverse, cfg)
    accum, ray_count = wavefront_rounds(backend, tex, origin_pt, dirs,
                                        lights, cfg, valid)
    with tracing.span("resolve", dev):
        fb = torch.stack([untile(accum[k], hp, wp)[: cfg.height, : cfg.width]
                          for k in range(3)], dim=-1)
    return fb, ray_count


def render_frame_u8(backend, tex: TextureArrays, proj_inverse, view_inverse,
                    lights, cfg: C.RenderConfig):
    """render_frame + on-device UNORM8 quantization (truncating cast, as
    the JAX engine) and the ray-count sum."""
    fb, ray_count = render_frame(backend, tex, proj_inverse, view_inverse,
                                 lights, cfg)
    with tracing.span("resolve", fb.device):
        fb8 = torch.clamp(fb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        return fb8, ray_count.sum()


def lane_pixels(cfg: C.RenderConfig, rows: range, device):
    """The pixel of each lane of the lane rows `rows` in `tile`'s order,
    of a frame padded to tile multiples (Nb rows of 128 lanes; a row at
    or past Nb is padding): x, y i64[len(rows),128] and inside
    bool[len(rows),128], False on the tile padding and the padding rows.
    Row ((ty * (Wp / TILE_X) + tx) * 2 + a) * 2 + b holds the 8x16
    subtile (a, b) of tile (ty, tx)."""
    wp, hp = _pad_dims(cfg.width, cfg.height)
    r = torch.arange(rows.start, rows.stop, device=device)[:, None]
    lane = torch.arange(L.LANES, device=device)[None, :]
    t, a, b = r // 4, (r // 2) % 2, r % 2
    sy, sx = TILE_Y // 2, TILE_X // 2
    y = (t // (wp // TILE_X)) * TILE_Y + a * sy + lane // sx
    x = (t % (wp // TILE_X)) * TILE_X + b * sx + lane % sx
    inside = (x < cfg.width) & (y < cfg.height) & (r < wp * hp // L.LANES)
    return x, y, inside


def camera_ray_blocks(proj_inverse, view_inverse, cfg: C.RenderConfig,
                      rows: range | None = None):
    """Camera rays padded to tile multiples, lane-major coherent blocks,
    made lane by lane (`lane_pixels`). Returns (origin_pt f32[3], dirs
    f32[3,Nb,128], valid bool[Nb,128] — False on tile-padding rays,
    which neither trace nor count, with direction (1,1,1) normalised).
    With `rows`, only those lane rows (rows past Nb are padding): the
    same bits as those rows of the whole frame's, so a shard makes only
    its own."""
    if rows is None:
        wp, hp = _pad_dims(cfg.width, cfg.height)
        rows = range(wp * hp // L.LANES)
    x, y, valid = lane_pixels(cfg, rows, proj_inverse.device)
    ox, oy = PIXEL_CENTER
    gx = (x.to(torch.float32) + ox) / cfg.width * 2.0 - 1.0
    gy = (y.to(torch.float32) + oy) / cfg.height * 2.0 - 1.0
    d = _ray_dirs(proj_inverse, view_inverse, gx, gy)
    d = torch.stack([torch.where(valid, c, 1.0) for c in d])
    return view_inverse[:3, 3], L.normalize3(d), valid


def wavefront_rounds(backend, tex: TextureArrays, origin_pt, dirs, lights,
                     cfg: C.RenderConfig, valid):
    """The trace→shade rounds over a lane-major wavefront ([3,Nb,128]);
    `valid` marks the rays that trace (False on tile padding). Returns
    (accum [3,Nb,128], ray_count i32[Nb,128])."""
    dev = dirs.device
    nb = dirs.shape[1]
    shape = (nb, L.LANES)
    with tracing.span("camera_rays", dev):
        # the carry, which shade_combine updates in place, is the rounds'
        # own: the caller's dirs and valid are left as they are
        accum = torch.zeros((3,) + shape, device=dev)
        attenuation = torch.ones(shape, device=dev)
        active = valid.clone(memory_format=torch.contiguous_format)
        ray_count = torch.zeros(shape, dtype=torch.int32, device=dev)
        lights = lights[:cfg.num_lights]
        origins = origin_pt[:, None, None].expand((3,) + shape).contiguous()
        dirs = dirs.clone(memory_format=torch.contiguous_format)
    cblk = _occl_block(nb * L.LANES)

    for depth in range(cfg.max_depth):
        # spans name the layers in torch.profiler traces, and in a
        # replayed graph by their marks (the JAX engine's jax.named_scope)
        with tracing.span(f"trace_closest_d{depth}", dev):
            tmax = torch.where(active, C.RAY_TMAX, 0.0)
            # resort_secondary: the reflection rays by direction octant,
            # dead rays last; results inverted after the trace
            rs_closest = cfg.resort_secondary and depth >= 1
            # partition_closest: the whole iteration in sorted order (it
            # yields to resort_secondary and needs the dense kernels)
            pt_closest = (cfg.partition_closest and depth >= 1
                          and not rs_closest
                          and isinstance(backend, DenseBackend))
            if pt_closest:
                origins, dirs, attenuation, undo_c = partition_rays(
                    origins, dirs, active, attenuation, backend.scene_aabb,
                    cblk)
                active = attenuation > 0
                tmax = torch.where(active, C.RAY_TMAX, 0.0)
            tracing.count(f"live_closest_d{depth}", active)
            o_t, d_t, tm_t = origins, dirs, tmax
            if rs_closest:
                perm = resort.radix_partition_perm(
                    resort.octant_key(dirs, active))
                o_t, d_t, tm_t = (resort.permute_rays(x, perm)
                                  for x in (origins, dirs, tmax))
            pregate = "recheck" if cfg.recheck_secondary and depth >= 1 \
                else ""
            t, u, v, attrs, hitm = backend.closest(
                o_t, d_t, tm_t, sub_gate=cfg.sub_gate_closest,
                pregate=pregate)
            if rs_closest:
                inv = resort.inverse_permutation(perm)
                t, u, v, attrs, hitm = (resort.permute_rays(x, inv)
                                        for x in (t, u, v, attrs, hitm))
        with tracing.span(f"shade_d{depth}", dev):
            # kernel L's first step on the card: what the sample needs,
            # zeros on lanes that did not hit
            pos, uv, slot, hit = shade_interp(active, hitm, u, v, attrs)
        with tracing.span(f"sample_d{depth}", dev):
            if depth == 0 and cfg.mip_lod:
                # beyond parity: trilinear at a per-ray level from
                # lane-neighbour differentials (config.mip_lod)
                lod = ray_diff_lod(uv, hit, slot, tex.level_width,
                                   tex.level_height, slot)
                base4, mr4, nmap4 = sample_material_trilinear(
                    tex.texels_tri, tex.level_offset, tex.level_width,
                    tex.level_height, slot, uv, lod)
                base, metallic, map_n = base4[:3], mr4[2], nmap4[:3]
            else:
                # only hit lanes read the heap (kernel K on the card);
                # every use below is masked by hit or reflective <= hit
                tracing.count(f"sample_fetch_d{depth}", hit)
                base, metallic, map_n = sample_hits(tex, slot, uv, hit)

        if cfg.flat_albedo:
            with tracing.span(f"shade_d{depth}", dev):
                shade_combine(active, hitm, base, None, None, None, None,
                              None, None, None, None, accum, ray_count,
                              flat=True)
            break

        shadows = cfg.enable_shadows and cfg.num_lights > 0
        with tracing.span(f"shade_d{depth}", dev):
            # the shadow rays in kernel B's layout, unless the depth's
            # repartition makes its own from the moved points
            pn, castmask, sd, st = shade_lights(
                hit, u, v, attrs, map_n, pos, lights if shadows else None,
                segments=not _moves_points(backend, cfg, depth))
        occ = None
        if shadows:
            with tracing.span(f"trace_shadow_d{depth}", dev):
                if tracing.enabled():
                    tracing.count(f"cast_shadow_d{depth}",
                                  cast_bits(castmask, len(lights)))
                occ = trace_shadows(backend, lights, pos, hit, castmask, sd,
                                    st, cfg, depth)
        with tracing.span(f"shade_d{depth}", dev):
            if pt_closest:
                # one inverse returns the contributions, and the reflection
                # carry while depths remain, to the original ray order
                dacc, dcount = shade_combine(
                    active, hitm, base, metallic, pn, pos, lights, occ,
                    origins, dirs, attenuation, None, None,
                    reflections=cfg.enable_reflections)
                more = depth + 1 < cfg.max_depth
                back = unpartition_rays(dacc, dcount, origins, dirs,
                                        attenuation, active, undo_c, more)
                accum = accum + back[:3]
                ray_count = ray_count + back[3].to(torch.int32)
                if more:
                    origins, dirs = back[4:7], back[7:10]
                    attenuation, active = back[10], back[11] > 0.5
            else:
                shade_combine(
                    active, hitm, base, metallic, pn, pos, lights, occ,
                    origins, dirs, attenuation, accum, ray_count,
                    reflections=cfg.enable_reflections)

    return accum, ray_count


class UndoRays(NamedTuple):
    """What `unpartition_rays` needs: the lane sort's ranks, the inverse
    group permutation and the sort's block."""
    rank: torch.Tensor
    ginv: torch.Tensor
    block: int


def partition_rays(origins, dirs, active, attenuation, scene_aabb,
                   block: int):
    """partition_closest's re-tiling of a reflection wavefront
    (vkrt_tpu/wavefront/engine.py:364-400): a stable sort of each block's
    lanes by `dir_cell_key_fine` (kernel E, 7 channels), then whole
    128-lane groups by `group_dir_key`. Attenuation rides as
    where(active, attenuation, 0), one channel for liveness and value: a
    live ray's attenuation is > 0. Returns the sorted (origins, dirs,
    attenuation) and the UndoRays."""
    combo = torch.where(active, attenuation, 0.0)
    key = lanesort.dir_cell_key_fine(dirs, origins, active, scene_aabb)
    srt, rank = lanesort.lane_sort(
        torch.cat([origins, dirs, combo[None]]).contiguous(), key,
        block=block)
    gperm = resort.radix_partition_perm(
        resort.group_dir_key(srt[3:6], srt[0:3], srt[6] > 0, scene_aabb))
    srt = resort.permute_groups(srt, gperm)
    return (srt[0:3], srt[3:6], srt[6],
            UndoRays(rank, resort.inverse_permutation(gperm), block))


def unpartition_rays(dacc, dcount, origins, dirs, attenuation, active,
                     undo: UndoRays, carry: bool):
    """The inverse of `partition_rays` on one iteration's results
    (vkrt_tpu/wavefront/engine.py:738-760): the inverse group permutation
    and the lane unsort (kernel F) of 4 channels (colour, ray count) or,
    with `carry`, 12 (and origins, dirs, attenuation, liveness)."""
    chans = [dacc, dcount[None]]
    if carry:
        chans += [origins, dirs, torch.where(active, attenuation, 0.0)[None],
                  active.to(torch.float32)[None]]
    stk = resort.permute_groups(torch.cat(chans), undo.ginv)
    return lanesort.lane_unsort(stk.contiguous(), undo.rank,
                                block=undo.block)


def _moves_points(backend, cfg: C.RenderConfig, depth: int) -> bool:
    """Whether trace_shadows repartitions the depth's surface points
    (`partition_points`) and makes the segments from the moved points."""
    return (cfg.partition_shadows and depth >= 1
            and not isinstance(backend, ReferenceBackend)
            and not cfg.resort_secondary and not cfg.recheck_secondary)


def trace_shadows(backend, lights, pos, hit, castmask, sd, st,
                  cfg: C.RenderConfig, depth: int):
    """Blocked masks bool[L,Nb,128] of all lights' shadow segments in ONE
    kernel-B dispatch (or one kernel-A' dispatch per light where the
    backend has `per_light` set), traced from the light toward the point;
    rays a hit does not cast (bit s of `castmask` clear) park at tmax 0.
    pos, hit, castmask, sd and st are shade_lights' (sd and st
    None where `_moves_points`).

    The reorders and modes follow the JAX engine's conditions
    (vkrt_tpu/wavefront/engine.py:511-701). resort_secondary, at every
    depth, sorts the segments by the Morton cell of their surface point
    (`hit` rays first) and inverts after B; it turns the three shipped
    reorders off. recheck_secondary (B's re-check, every depth) turns
    partition_shadows and consolidate_secondary off. At depth >= 1 the
    rest reorder: with partition_shadows, `partition_points` and
    `unpartition` (pack first when consolidate_secondary is on);
    otherwise the group sort (group_sort_shadows) and the pack of all 16
    segment channels (consolidate_secondary), each optional. Partition
    and pack serve the dense kernels only: the reference backend gets the
    sorts alone. sub_gate_shadows is B's sub-run mode."""
    nl = lights.shape[0]
    oblk = _occl_block(pos.shape[1] * L.LANES)
    dense = not isinstance(backend, ReferenceBackend)
    rs = cfg.resort_secondary
    pregate = "recheck" if cfg.recheck_secondary else ""
    modes = dict(block=oblk, sub_gate=cfg.sub_gate_shadows, pregate=pregate)
    if _moves_points(backend, cfg, depth):
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
                                     torch.stack(st), **modes)
        return unpartition(occ, undo)

    gsort = cfg.group_sort_shadows and depth >= 1 and not rs
    cons = (cfg.consolidate_secondary and depth >= 1 and dense and not rs
            and not pregate)
    if rs:
        sperm = resort.radix_partition_perm(
            resort.cell_key(pos, hit, backend.scene_aabb))
        sd = resort.permute_rays(sd, sperm)
        st = resort.permute_rays(st, sperm)
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
    occ = backend.occluded_multi(lights, sd, st, **modes)
    if cons:
        occ = pack.scatter_back(occ.to(torch.float32), grank) > 0.5
    if gsort:
        occ = resort.permute_groups(occ, resort.inverse_permutation(gperm))
    if rs:
        occ = resort.permute_rays(occ, resort.inverse_permutation(sperm))
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


def upload_matrix(m, device):
    """A small numpy array (a camera or instance matrix) as f32 on
    `device`, without a host wait: a blocking host-to-device copy would
    wait for the frames already queued; from pinned memory the copy is
    queued too."""
    m = torch.from_numpy(np.array(m, np.float32))
    if device.type == "cuda":
        m = m.pin_memory()
    return m.to(device, non_blocking=True)


# In-process scene cache (vkrt_tpu/wavefront/engine.py:767-801): a glTF
# file is loaded and flattened once a process per (path, texture size),
# and its material heap and trace backends are uploaded once per device.
_MODEL_CACHE: dict = {}
_SCENE_CACHE: dict = {}


def cached_model(model_path, max_texture_dim: int = 0):
    """The Model loaded from `model_path` (textures cut to
    `max_texture_dim`, 0 = full size), loaded once a process."""
    key = (os.fspath(model_path), max_texture_dim)
    if key not in _MODEL_CACHE:
        model = load_model(key[0], max_texture_dim=max_texture_dim)
        _MODEL_CACHE[key] = (model, flatten_model(model))
    return _MODEL_CACHE[key][0]


def load_scene_assets(model_path, max_texture_dim: int = 0, device="cuda"):
    """(FlatScene, TextureArrays on `device`, {backend kind: backend}) of
    the scene at `model_path`: cached per (path, texture size, device),
    the backends filled by `cached_backend`."""
    dev = torch.device(device)
    key = (os.fspath(model_path), max_texture_dim, str(dev))
    if key not in _SCENE_CACHE:
        model = cached_model(model_path, max_texture_dim)
        flat = _MODEL_CACHE[key[:2]][1]
        _SCENE_CACHE[key] = (flat, texture_arrays(model.images, flat, dev),
                             {})
    return _SCENE_CACHE[key]


def cached_backend(model_path, max_texture_dim: int, kind: str,
                   device="cuda"):
    """(FlatScene, TextureArrays, backend `kind`) of the scene at
    `model_path` on `device`, each made once a process."""
    flat, tex, backends = load_scene_assets(model_path, max_texture_dim,
                                            device)
    if kind not in backends:
        backends[kind] = make_backend(flat, kind, torch.device(device))
    return flat, tex, backends[kind]


def host_wait(backend, cfg: C.RenderConfig) -> str:
    """Why a frame of `backend` at `cfg` waits on the host, so that no
    CUDA graph can hold it ('' if it does not): the reference backend's
    traversal asks the card once a step whether a ray is live (JAX
    compiles that as a while_loop), and recheck_secondary's plain-torch
    prologue reads tensor values on the host."""
    if isinstance(backend, ReferenceBackend):
        return ("the reference backend asks the card once a traversal step "
                "whether a ray is live (rt/traverse.py)")
    if cfg.recheck_secondary:
        return ("recheck_secondary's prologue reads tensor values on the "
                "host (rt/dense.py::closest_worklists, "
                "rt/occl_multi.py::multi_worklists)")
    return ""


class SceneOnDevice:
    """What both renderers build from a scene: the flattened scene, the
    material heap and the trace backend ("dense" or "reference") on
    `device`, with TF32 off.

    `scene` is a `vkrt_tpu_torch.scene.Model` or the path of a glTF file
    (loaded with its textures cut to `max_texture_dim`, 0 = full size,
    through `cached_backend`: once a process, shared by every instance
    on the device); `cfg` must be this package's RenderConfig.

    `graph` (True, False or None) says whether the renderers' frames are
    captured and replayed as CUDA graphs (`captured`; graphs.resolve);
    `graphs` holds them, and a copy made with copy.copy shares it."""

    def __init__(self, scene, cfg: C.RenderConfig, device,
                 backend: str = "dense", max_texture_dim: int = 0,
                 graph: bool | None = None):
        if not isinstance(cfg, C.RenderConfig):
            raise TypeError(f"cfg must be vkrt_tpu_torch.config.RenderConfig,"
                            f" got {type(cfg).__module__}.{type(cfg).__name__}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.graph = graph
        self.graphs = graphs.FrameGraph()
        runtime.exact_f32()
        if isinstance(scene, (str, os.PathLike)):
            self.model = cached_model(scene, max_texture_dim)
            self.flat, self.tex, self.backend = cached_backend(
                scene, max_texture_dim, backend, self.device)
        else:
            self.model = scene
            self.flat = flatten_model(scene)
            self.tex = texture_arrays(scene.images, self.flat, self.device)
            self.backend = make_backend(self.flat, backend, self.device)
        self.captured()                # graph=True raises here if it cannot

    def captured(self) -> bool:
        """Whether render_async replays a CUDA graph: `graph` resolved
        (graphs.resolve) on this device, backend and cfg. None captures
        on a CUDA device, except a frame that waits on the host
        (`host_wait`: the reference backend, recheck_secondary), which
        runs eagerly, as every frame on the CPU does; True raises
        ValueError where the frame cannot be captured; False is eager."""
        return graphs.resolve(self.graph, self.device,
                              host_wait(self.backend, self.cfg))

    def free_graphs(self) -> None:
        """Drop the captured graphs and their memory pools (those of the
        copies that share them too)."""
        self.graphs.free()


REBUILD_MODES = ("refit", "full", "full_morton")


class Renderer(SceneOnDevice):
    """High-level renderer: scene in, frames out (the Raytracer analogue).

    The constructor builds the cluster tree on the host and moves it and
    the material heap to `device` (the card unless the caller asks for
    the CPU); render_async() enqueues one frame.

    `rebuild` picks the per-frame accel update that a `transform` (or
    cfg.rebuild_per_frame) triggers: "refit" keeps the tree's topology
    and refits its boxes (accel/refit.py), "full" re-orders the
    transformed triangles with the device SAH build and "full_morton"
    with a Morton sort (accel/clusters.build_clusters on device
    tensors); `sah_opts` forwards to device_sah_order. The reference
    backend has no accel update (as in the JAX package): an identity
    update is skipped, any other transform raises ValueError.

    `graph` (the counterpart of jax.jit against jax.disable_jit): on a
    CUDA device render_async captures the accel update and the frame as
    one CUDA graph per static key (cfg, quantize, rebuild, whether the
    frame updates the tree, the scene's tensors) and replays it (see
    `captured` for which frames stay eager; graph=False runs every op
    from Python, as profiling by ranges needs)."""

    def __init__(self, scene, cfg: C.RenderConfig, device="cuda",
                 quantize: bool = False, rebuild: str = "refit",
                 sah_opts: dict | None = None, backend: str = "dense",
                 max_texture_dim: int = 0, graph: bool | None = None):
        if rebuild not in REBUILD_MODES:
            raise ValueError(f"rebuild {rebuild!r} not in {REBUILD_MODES}")
        super().__init__(scene, cfg, device, backend, max_texture_dim, graph)
        self.quantize = quantize    # u8 fb + scalar ray count on device
        self.rebuild = rebuild
        self.sah_opts = sah_opts
        self.lights = torch.as_tensor(C.LIGHT_POSITIONS, device=self.device)
        self._rebuild_inputs = None     # made by the first full rebuild

    def rebuild_inputs(self):
        """What a full rebuild starts from, on the device, made once:
        ((v0, e1, e2), attrs) of the untransformed scene and the 8
        corners (numpy) of its centroid AABB."""
        if self._rebuild_inputs is None:
            idx = np.asarray(self.flat.indices, dtype=np.int64)
            p = np.asarray(self.flat.positions, np.float32)
            v0 = p[idx[:, 0]]
            e1, e2 = p[idx[:, 1]] - v0, p[idx[:, 2]] - v0

            def put(x):
                return torch.from_numpy(np.array(x, np.float32)).to(
                    self.device)

            c = v0 + (e1 + e2) / 3.0
            lo, hi = c.min(axis=0), c.max(axis=0)
            corners = np.array(
                [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                 for z in (lo[2], hi[2])], np.float32)
            self._rebuild_inputs = (
                (put(v0), put(e1), put(e2)),
                {k: put(x) for k, x in scene_attrs(self.flat).items()},
                corners)
        return self._rebuild_inputs

    def render_async(self, camera, transform=None):
        """Enqueue a frame; returns device tensors (fb, ray_count) without
        waiting for the card, new ones each call.

        `transform` (4x4 affine, the instance-transform analogue) — or
        cfg.rebuild_per_frame, with the identity — triggers the per-frame
        accel update chosen by `rebuild` before the frame is traced."""
        update = self.cfg.rebuild_per_frame or transform is not None
        m = None
        if update:
            m = np.eye(4, dtype=np.float32) if transform is None \
                else np.asarray(transform, np.float32)
            if isinstance(self.backend, ReferenceBackend):
                if not np.array_equal(m, np.eye(4, dtype=np.float32)):
                    raise ValueError(
                        "the reference backend has no accel update: a "
                        "non-identity transform would render the unmoved "
                        "scene")
                m = None
        x = self.frame_inputs(camera, m)
        update = m is not None
        if not self.captured():
            return self.frame_body(upload_matrix(x, self.device), update)
        return self.graphs.run(
            self.graph_key(update), lambda xs: self.frame_body(xs, update),
            (x,), self.device, holds=(self.backend, self.tex, self.lights,
                                      self._rebuild_inputs))

    def graph_key(self, update: bool) -> tuple:
        """The static key of a captured frame: all it reads but its
        inputs, and whether tracing is on (a traced frame carries marks
        and counters)."""
        return ("frame", str(self.device), self.cfg, self.quantize, update,
                self.rebuild, repr(self.sah_opts), id(self.backend),
                id(self.tex), id(self.lights), tracing.enabled())

    def frame_inputs(self, camera, m=None) -> np.ndarray:
        """All that a frame reads that may change from frame to frame, as
        one f32 vector: the camera's proj_inverse and view_inverse (16
        each), then, with an accel update by the 4x4 affine `m`,
        `update_inputs(m)`."""
        parts = [np.asarray(camera.proj_inverse, np.float32).reshape(-1),
                 np.asarray(camera.view_inverse, np.float32).reshape(-1)]
        if m is not None:
            parts.append(self.update_inputs(m))
        return np.concatenate(parts)

    def update_inputs(self, m) -> np.ndarray:
        """The accel update's inputs, f32[22]: the 4x4 affine `m` (numpy),
        then the Morton range of "full_morton" (lo, hi: the scene's
        centroid AABB, its corners transformed on the host; zeros in the
        other modes)."""
        m = np.asarray(m, np.float32)
        lo = hi = np.zeros(3, np.float32)
        if self.rebuild != "refit":
            corners = self.rebuild_inputs()[2]
            if self.rebuild == "full_morton":
                corners = L.mat_rows3(corners, m[:3, :3]) + m[:3, 3]
                lo, hi = corners.min(axis=0), corners.max(axis=0)
        return np.concatenate([m.reshape(-1), lo, hi]).astype(np.float32)

    def frame_body(self, x, update: bool):
        """The frame as the graph captures it, reading only `x`
        (`frame_inputs` on the device) beside the scene: the accel update
        when `update`, then render_frame_u8 (quantize) or render_frame;
        all of it in the span `frame`."""
        backend = self.backend
        with tracing.span("frame", x.device):
            if update:
                with tracing.span("accel_update", x.device):
                    tree = self._update_tree(x[32:])
                if tracing.enabled():
                    with tracing.span("accel_area", x.device):
                        tracing.count("accel_cl_area",
                                      cluster_area_fixed(tree.cl_boxes))
                backend = backend._replace(tree=tree)
            frame = render_frame_u8 if self.quantize else render_frame
            return frame(backend, self.tex, x[0:16].reshape(4, 4),
                         x[16:32].reshape(4, 4), self.lights, self.cfg)

    def render(self, camera, transform=None):
        """Synchronous render: enqueue + materialize on host."""
        fb, rays = self.render_async(camera, transform)
        return fb.cpu().numpy(), int(rays.sum())

    def update_tree(self, m):
        """The cluster tree of the scene under the 4x4 affine `m` (numpy),
        by this renderer's `rebuild` mode; enqueued, no host wait."""
        return self._update_tree(upload_matrix(self.update_inputs(m),
                                               self.device))

    def _update_tree(self, u):
        """update_tree on `update_inputs` on the device: a refit, or a
        full rebuild (transform geometry and attribute directions on the
        device, re-order, assemble)."""
        m = u[0:16].reshape(4, 4)
        if self.rebuild == "refit":
            return refit_clusters(self.backend.tree, m)
        geometry, attrs, _ = self.rebuild_inputs()
        v0, e1, e2, attrs = _transform_geometry(*geometry, attrs, m)
        if self.rebuild == "full":
            return build_clusters(v0, e1, e2, attrs=attrs,
                                  with_attributes=True, method="sah",
                                  sah_opts=self.sah_opts)
        return build_clusters(v0, e1, e2, attrs=attrs, with_attributes=True,
                              method="morton", aabb=(u[16:19], u[19:22]))


def _transform_geometry(v0, e1, e2, attrs, m):
    """Affine transform of triangle geometry + directional attributes
    (elementwise float32 products, no matmul)."""
    a, b = m[:3, :3], m[:3, 3]
    out = dict(attrs)
    for k in ("n0", "n1", "n2", "t0", "t1", "t2"):
        out[k] = L.mat_rows3(attrs[k], a)
    return (L.mat_rows3(v0, a) + b, L.mat_rows3(e1, a), L.mat_rows3(e2, a),
            out)
