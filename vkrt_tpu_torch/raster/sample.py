"""The raster path's alpha-discard round after kernel G: kernel I's
wrapper and its plain version.

  * `raster_sample_round`: on a CUDA tensor it launches the hand-written
    kernel in csrc/raster_sample.cu, which fetches the base map's texel
    quad only where G hit; on a CPU tensor it runs
    `raster_sample_round_plain`, the plain PyTorch version: the ray
    tracer's three-map sampler (shade/sampling.py::sample_material) over
    every lane, of which the base map's colour and alpha are kept. The
    kernel replaces no Pallas kernel (the JAX package's discard rounds
    sample in XLA) and shares no code with the ray tracer's sampler:
    the heap layout (scene/textures.py::MaterialHeap) is all they have
    in common.

raster/pipeline.py's edge_color_lanes calls it once a round.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels, tracing
from vkrt_tpu_torch.raster.edge import ZFAR_PARK
from vkrt_tpu_torch.shade.sampling import sample_material
from vkrt_tpu_torch.utils import layout as L

ALPHA_DISCARD = 0.1        # ref: shaders/shader.frag:16-20


def raster_sample_round_plain(tex, z, slot, u, v, mat, color):
    """Plain PyTorch version of kernel I (same inputs and outputs as
    `raster_sample_round`; `color` is not written, a new one is
    returned): every lane's level-0 material sample, of which the base
    map's colour and alpha are kept where G hit."""
    hit = slot >= 0
    texel, _, _ = sample_material(
        tex.texels_tri, tex.level_offset, tex.level_width,
        tex.level_height, mat, torch.stack([u, v]))
    opaque = hit & (texel[3] >= ALPHA_DISCARD)
    discarded = hit & ~opaque
    color = L.where3(opaque, texel[:3], color)
    # fragment kill: the next round takes only deeper fragments
    zfloor = torch.where(discarded, z, ZFAR_PARK)
    return color, zfloor


def raster_sample_round(tex, z, slot, u, v, mat, color):
    """One alpha-discard round after kernel G: G's outputs z, slot, u, v,
    mat [Nb,128] and the sample's colour so far f32[3,Nb,128]. Returns
    (colour, the next round's zfloor f32[Nb,128]): where G hit and the
    base map's bilinear level-0 alpha at (u, v) is >= ALPHA_DISCARD the
    fragment's rgb is the colour and the lane parks (ZFAR_PARK); where it
    hit and the alpha is lower the colour stays and the floor is the
    fragment's z; a miss parks. A CUDA tensor launches kernel I
    (csrc/raster_sample.cu), which reads the base map's quad of a hit
    lane alone and writes `color` in place, and counts it in
    `raster_sample_round.launches`; a CPU tensor runs
    `raster_sample_round_plain`. Either records the Nb * 128 lanes it is
    launched over (tracing.lanes)."""
    dev = slot.device
    tracing.lanes("raster_sample", slot.numel())
    if dev.type == "cpu":
        return raster_sample_round_plain(tex, z, slot, u, v, mat, color)
    if dev.type != "cuda":
        raise ValueError(f"raster_sample_round: unsupported device {dev}")
    shape = slot.shape
    lanes = [(z, torch.float32), (slot, torch.int32), (u, torch.float32),
             (v, torch.float32), (mat, torch.int32)]
    if any(t.shape != shape or t.dtype != dt or t.device != dev
           for t, dt in lanes):
        raise ValueError("raster_sample_round: z, slot, u, v, mat must be "
                         "[Nb,128] f32 / i32 / f32 / f32 / i32 on one device")
    if (color.shape != (3, *shape) or color.dtype != torch.float32
            or color.device != dev or not color.is_contiguous()):
        raise ValueError("raster_sample_round: color must be a contiguous "
                         "f32[3,Nb,128] on the lanes' device")
    texels = tex.texels_tri.contiguous()
    if (texels.dtype != torch.uint8 or texels.shape[1:] != (48,)
            or texels.data_ptr() % 16):
        raise ValueError("raster_sample_round: the heap must be u8[N,48], "
                         "16-byte aligned")
    z, slot, u, v, mat = (t.contiguous() for t, _ in lanes)
    off, wid, hgt = (t.contiguous() for t in (
        tex.level_offset, tex.level_width, tex.level_height))
    zfloor = torch.empty(shape, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_raster_sample(
            slot.data_ptr(), u.data_ptr(), v.data_ptr(), mat.data_ptr(),
            z.data_ptr(), texels.data_ptr(), off.data_ptr(), wid.data_ptr(),
            hgt.data_ptr(), off.shape[1], slot.numel(), ALPHA_DISCARD,
            ZFAR_PARK, color.data_ptr(), zfloor.data_ptr(), stream)
    kernels.check(err, "raster_sample")
    raster_sample_round.launches += 1
    return color, zfloor


raster_sample_round.launches = 0
