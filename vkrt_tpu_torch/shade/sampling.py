"""Material sampling — counterpart of vkrt_tpu/shade/sampling.py.

Bilinear, repeat-wrapped samples of a material slot's three maps
(base color, metallic-roughness, normal) from the packed 48-byte material
heap (vkrt_tpu/scene/textures.py build_material_heap): one gather per ray.
Lane-major interface: slot_ids [Nb,128], uv [2,Nb,128] → three
rgba [4,Nb,128]. The trilinear mip-LOD variant (config.mip_lod) blends
two such samples at per-ray levels from lane-neighbour differentials.

`sample_hits` is what the wavefront engine samples with at every depth
(but mip_lod's depth 0): on a CUDA tensor kernel K (csrc/sample_hits.cu),
which reads the heap row of a lane that hit alone; on a CPU tensor
`sample_hits_plain`, `sample_material` on the hit lanes.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels, tracing


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


def sample_hits_plain(tex, slot_ids, uv, hit):
    """Plain PyTorch version of kernel K (same inputs and outputs as
    `sample_hits`): `sample_material` at level 0 on inputs that are slot
    0, uv (0, 0) where `hit` is False, of which base rgb, metallic (the
    metallic-roughness map's blue) and normal rgb are kept where it is
    True and zeroed elsewhere."""
    sid = torch.where(hit, slot_ids, 0)
    uvm = torch.where(hit[None], uv, 0.0)
    base, mr, nmap = sample_material(tex.texels_tri, tex.level_offset,
                                     tex.level_width, tex.level_height, sid,
                                     uvm)
    return (torch.where(hit[None], base[:3], 0.0),
            torch.where(hit, mr[2], 0.0),
            torch.where(hit[None], nmap[:3], 0.0))


def _check_hits_inputs(tex, slot_ids, uv, hit) -> None:
    dev = slot_ids.device
    shape = slot_ids.shape
    if (slot_ids.dtype != torch.int32 or len(shape) != 2
            or shape[-1] != 128 or 7 * slot_ids.numel() >= 2 ** 31):
        raise ValueError("sample_hits: slot_ids must be i32[Nb,128] "
                         "(7 * Nb * 128 < 2^31)")
    if uv.dtype != torch.float32 or uv.shape != (2, *shape):
        raise ValueError("sample_hits: uv must be f32[2,Nb,128]")
    if hit.dtype != torch.bool or hit.shape != shape:
        raise ValueError("sample_hits: hit must be bool[Nb,128]")
    texels = tex.texels_tri
    if (texels.dtype != torch.uint8 or texels.dim() != 2
            or texels.shape[1] != 48 or not texels.is_contiguous()
            or texels.data_ptr() % 16):
        raise ValueError("sample_hits: the heap must be a contiguous "
                         "u8[N,48], 16-byte aligned")
    levels = (tex.level_offset, tex.level_width, tex.level_height)
    if any(t.dtype != torch.int32 or t.dim() != 2
           or t.shape != levels[0].shape for t in levels):
        raise ValueError("sample_hits: the level tables must be i32[M,L]")
    if any(t.device != dev for t in (uv, hit, texels, *levels)):
        raise ValueError("sample_hits: every input must be on one device")


def sample_hits(tex, slot_ids, uv, hit):
    """The level-0 material sample of the lanes that hit: slot_ids
    i32[Nb,128] (mat_ids[0]), uv f32[2,Nb,128], hit bool[Nb,128] and the
    heap `tex` (TextureArrays). Returns (base rgb f32[3,Nb,128], metallic
    f32[Nb,128], normal map rgb f32[3,Nb,128]): where `hit`,
    `sample_material`'s channels bit for bit; elsewhere 0. A CUDA tensor
    launches kernel K (csrc/sample_hits.cu), which reads a hit lane's
    48-byte heap row alone, and counts it in `sample_hits.launches`; a
    CPU tensor runs `sample_hits_plain`. Either records the Nb * 128
    lanes it is launched over (tracing.lanes). Raises ValueError on a
    wrong dtype, shape or device, or a heap not 16-byte aligned."""
    dev = slot_ids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_hits: unsupported device {dev}")
    _check_hits_inputs(tex, slot_ids, uv, hit)
    tracing.lanes("sample_hits", slot_ids.numel())
    if dev.type == "cpu":
        return sample_hits_plain(tex, slot_ids, uv, hit)
    slot_ids, uv, hit = (t.contiguous() for t in (slot_ids, uv, hit))
    off, wid, hgt = (t.contiguous() for t in (
        tex.level_offset, tex.level_width, tex.level_height))
    out = torch.empty((7, *slot_ids.shape), device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_sample_hits(
            slot_ids.data_ptr(), uv.data_ptr(), hit.data_ptr(),
            tex.texels_tri.data_ptr(), off.data_ptr(), wid.data_ptr(),
            hgt.data_ptr(), off.shape[1], slot_ids.numel(), out.data_ptr(),
            stream)
    kernels.check(err, "sample_hits")
    sample_hits.launches += 1
    return out[:3], out[3], out[4:]


sample_hits.launches = 0
