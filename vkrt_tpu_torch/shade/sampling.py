"""Material sampling — counterpart of vkrt_tpu/shade/sampling.py.

Bilinear, repeat-wrapped samples of a material slot's three maps
(base color, metallic-roughness, normal) from the packed 48-byte material
heap (vkrt_tpu/scene/textures.py build_material_heap): one gather per ray.
Lane-major interface: slot_ids [Nb,128], uv [2,Nb,128] → three
rgba [4,Nb,128]. The trilinear mip-LOD variant (config.mip_lod) blends
two such samples at per-ray levels from lane-neighbour differentials.
"""

from __future__ import annotations

import torch


def sample_material(texels_tri, level_offset, level_width, level_height,
                    slot_ids, uv, lod=0):
    """Returns (base, mr, normal) each [4,Nb,128] at mip level `lod`, an
    int or a per-ray integer tensor [Nb,128]. Texel indices wrap with a
    floor modulo (`torch.remainder`, as jnp.mod), so negative uvs
    repeat."""
    sid = slot_ids.long()
    if torch.is_tensor(lod):
        lod = lod.long()
    off = level_offset[sid, lod]
    w = level_width[sid, lod]
    h = level_height[sid, lod]

    x = uv[0] * w - 0.5
    y = uv[1] * h - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0
    fy = y - y0

    xi = torch.remainder(x0, w)
    yi = torch.remainder(y0, h)
    rows = texels_tri[(off + yi * w + xi).long()]     # [...,48] u8, one gather
    q = rows.to(torch.float32) / 255.0
    w00 = ((1 - fx) * (1 - fy))[..., None]
    w10 = (fx * (1 - fy))[..., None]
    w01 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]

    def lerp(base):
        rgba = (q[..., base + 0:base + 4] * w00
                + q[..., base + 4:base + 8] * w10
                + q[..., base + 8:base + 12] * w01
                + q[..., base + 12:base + 16] * w11)
        return torch.movedim(rgba, -1, 0)

    return lerp(0), lerp(16), lerp(32)


def sample_material_trilinear(texels_tri, level_offset, level_width,
                              level_height, slot_ids, uv, lod_f):
    """Per-ray mip LOD lod_f f32[Nb,128] (clamped to the chain): the two
    bracketing levels sampled and blended linearly. Beyond parity: the
    reference's ray-tracing stage always samples level 0, so this is off
    by default (config.mip_lod) and never on in golden-gated paths."""
    levels = level_offset.shape[1]
    l0 = torch.clamp(torch.floor(lod_f).to(torch.int32), 0, levels - 1)
    l1 = torch.clamp(l0 + 1, max=levels - 1)
    f = torch.clamp(lod_f - l0.to(torch.float32), 0.0, 1.0)[None]
    lo = sample_material(texels_tri, level_offset, level_width,
                         level_height, slot_ids, uv, lod=l0)
    hi = sample_material(texels_tri, level_offset, level_width,
                         level_height, slot_ids, uv, lod=l1)
    return tuple(a * (1.0 - f) + b * f for a, b in zip(lo, hi))


def ray_diff_lod(uv, hit, mat_ids, level_width, level_height, slot_ids):
    """Screen-space mip LOD f32[Nb,128] from lane-neighbour differentials.

    A 128-lane group is one 8x16-pixel subtile (wavefront.engine.tile),
    so the +x neighbour is lane+1 and the +y neighbour lane+16: uv
    differences across lanes stand in for fragment derivatives. lod =
    log2 of the larger texel footprint (the GL rho formula); a
    difference across a surface boundary (another material, or a miss)
    counts as one texel, so edges stay sharp."""
    sid = slot_ids.long()
    w0 = level_width[sid, 0].to(torch.float32)
    h0 = level_height[sid, 0].to(torch.float32)
    lane = torch.arange(uv.shape[-1], dtype=torch.int32, device=uv.device)

    def diff(a, shift, use_fwd):
        # backward difference, except at the subtile's wrap lanes (lane
        # 0's +1-roll neighbour is lane 127, 8 pixel rows away), where
        # the forward difference is the in-subtile neighbour
        back = a - torch.roll(a, shift, dims=-1)
        fwd = torch.roll(a, -shift, dims=-1) - a
        return torch.where(use_fwd, fwd, back)

    def nbr_ok(shift, use_fwd):
        def ok(s):
            return (hit & torch.roll(hit, s, dims=-1)
                    & (mat_ids == torch.roll(mat_ids, s, dims=-1)))
        return torch.where(use_fwd, ok(-shift), ok(shift))

    fwd_x = (lane % 16) == 0
    fwd_y = lane < 16
    dx = [diff(uv[0], 1, fwd_x) * w0, diff(uv[1], 1, fwd_x) * h0]
    dy = [diff(uv[0], 16, fwd_y) * w0, diff(uv[1], 16, fwd_y) * h0]
    rho_x = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1])
    rho_y = torch.sqrt(dy[0] * dy[0] + dy[1] * dy[1])
    rho = torch.maximum(torch.where(nbr_ok(1, fwd_x), rho_x, 1.0),
                        torch.where(nbr_ok(16, fwd_y), rho_y, 1.0))
    return torch.clamp(torch.log2(torch.clamp(rho, min=1.0)), min=0.0)


def sample_material_compact(texels_tri, level_offset, level_width,
                            level_height, slot_ids, uv, live):
    """The JAX function's values: on every 128-lane row with a live lane,
    sample_material with dead lanes at slot 0, uv (0, 0); rows with no
    live lane are 0. The JAX version packs live rows and samples them in
    `cap_rows` chunks, a TPU gather-cost trick; here every row is sampled
    and dead rows are zeroed, which needs no live-row count on the host
    and so never makes the host wait for the card."""
    sid = torch.where(live, slot_ids, 0)
    uvm = torch.where(live[None], uv, 0.0)
    row_live = live.any(dim=1)[None, :, None]
    return tuple(torch.where(row_live, p, 0.0)
                 for p in sample_material(texels_tri, level_offset,
                                          level_width, level_height, sid,
                                          uvm))
