"""Re-tiling of secondary wavefronts by stable partitions — counterpart of
vkrt_tpu/wavefront/resort.py.

Plain PyTorch: the JAX package computes these in XLA, not in Pallas.

  * Ray granularity (`resort_secondary`): `octant_key` (reflection rays
    by direction octant) and `cell_key` (shadow segments by the Morton
    cell of their surface point) order `permute_rays`.
  * Group granularity: whole 128-lane rows (the engine's 8x16-pixel
    subtiles) move by `permute_groups`, sorted by the Morton cell of their
    mean live surface point (`group_cell_key`, the depth>=1 shadow
    reorder) or by mean direction octant and origin cell
    (`group_dir_key`, `partition_closest`).

Each permutation is used around a dispatch and inverted after it.
Blocked masks are any-hits, and kernel A commits the nearest hit with
ties to the lowest slot, so neither depends on the ray order.
"""

from __future__ import annotations

import torch

OCTANT_BITS = 4
CELL_BITS_PER_AXIS = 3
CELL_KEY_BITS = 3 * CELL_BITS_PER_AXIS + 1        # + dead-tail bit
GROUP_CELL_BITS_PER_AXIS = 4
GROUP_CELL_KEY_BITS = 3 * GROUP_CELL_BITS_PER_AXIS + 1   # + dead-tail bit
GROUP_DIR_KEY_BITS = 3 + 3 * GROUP_CELL_BITS_PER_AXIS + 1


def radix_partition_perm(key):
    """Stable ascending permutation of small integer keys: key int[N] →
    perm int64[N] with key[perm] sorted and ties in index order. A stable
    sort has exactly one such permutation, so `torch.sort(stable=True)`
    gives the one the JAX package's LSD radix passes build."""
    return torch.sort(key, stable=True).indices


def inverse_permutation(perm):
    """inv with inv[perm[i]] = i."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def permute_rays(arr, perm):
    """Apply a RAY permutation to a lane-major array [..., Nb, 128]:
    out.flat[..., i] = arr.flat[..., perm[i]]."""
    flat = arr.reshape(arr.shape[:-2] + (-1,))
    return flat.index_select(-1, perm).reshape(arr.shape)


def octant_key(d, live):
    """Direction-octant key: live rays 0-7 (bit a set where d[a] < 0),
    dead rays 8, the tail. d [3,Nb,128], live bool[Nb,128] → i32[N]."""
    k = ((d[0] < 0).to(torch.int32) | ((d[1] < 0).to(torch.int32) << 1)
         | ((d[2] < 0).to(torch.int32) << 2))
    return torch.where(live, k, 8).reshape(-1)


def _morton(p, lo, span, bits: int, shape):
    """Morton-interleave points p [3, ...] quantized to `bits` bits per
    axis inside the box (lo, lo + span) → i32 of `shape`."""
    nbins = (1 << bits) - 1
    key = torch.zeros(shape, dtype=torch.int32, device=p.device)
    for a in range(3):
        q = torch.clamp((p[a].reshape(shape) - lo[a]) / span[a] * (nbins + 1),
                        0.0, float(nbins)).to(torch.int32)
        for b in range(bits):
            key = key | (((q >> b) & 1) << (3 * b + a))
    return key


def cell_key(p, live, scene_aabb):
    """Morton cell of a surface point, CELL_BITS_PER_AXIS bits per axis
    inside the scene's box; dead rays get 2**9, the tail. p [3,Nb,128],
    live bool[Nb,128], scene_aabb f32[2,3] → i32[N], below
    2**CELL_KEY_BITS. Elementwise, the JAX function's operations in its
    order: the keys are equal."""
    span = torch.clamp(scene_aabb[1] - scene_aabb[0], min=1e-6)
    key = _morton(p, scene_aabb[0], span, CELL_BITS_PER_AXIS,
                  (p[0].numel(),))
    return torch.where(live.reshape(-1), key, 1 << (3 * CELL_BITS_PER_AXIS))


def permute_groups(arr, perm):
    """Apply a GROUP permutation to a lane-major array [..., Nb, 128]:
    whole 128-lane rows move; lane order inside a row is untouched."""
    return arr.index_select(-2, perm)


def group_live_mean3(p, live):
    """Per-group live-ray mean of a lane-major vector.
    p [3,Nb,128], live bool[Nb,128] → (mean f32[3,Nb], any bool[Nb])."""
    cnt = torch.clamp(live.to(torch.float32).sum(dim=-1), min=1.0)
    s = torch.where(live[None], p, 0.0).sum(dim=-1)              # [3, Nb]
    return s / cnt[None], live.any(dim=-1)


def _quant_cell(mean, scene_aabb, bits: int):
    """Morton-interleave a [3,Nb] point into 3*bits-bit cells."""
    span = torch.clamp(scene_aabb[1] - scene_aabb[0], min=1e-6)
    return _morton(mean, scene_aabb[0], span, bits, (mean.shape[1],))


def group_cell_key(p, live, scene_aabb):
    """Per-group Morton cell of the mean live surface point; all-dead
    groups get the tail bucket 2**12. p [3,Nb,128], live bool[Nb,128],
    scene_aabb f32[2,3] → i32[Nb], below 2**GROUP_CELL_KEY_BITS.

    The mean sums 128 lanes in torch's order, which need not be XLA's: a
    mean on a cell boundary can quantize to the neighbouring cell, so a
    few groups may key (and move) differently from the JAX package. The
    masks do not depend on the order."""
    mean, anyl = group_live_mean3(p, live)
    key = _quant_cell(mean, scene_aabb, GROUP_CELL_BITS_PER_AXIS)
    return torch.where(anyl, key, 1 << (3 * GROUP_CELL_BITS_PER_AXIS))


def group_dir_key(d, o, live, scene_aabb):
    """Per-group mean-direction octant (major) and mean-origin Morton cell
    (minor); all-dead groups get the tail bucket 2**15. d, o [3,Nb,128],
    live bool[Nb,128] → i32[Nb], below 2**GROUP_DIR_KEY_BITS. Its means
    are `group_live_mean3`'s, so a mean on a cell boundary may key
    differently from the JAX package (see `group_cell_key`)."""
    md, anyl = group_live_mean3(d, live)
    mo, _ = group_live_mean3(o, live)
    oct_ = ((md[0] < 0).to(torch.int32) | ((md[1] < 0).to(torch.int32) << 1)
            | ((md[2] < 0).to(torch.int32) << 2))
    cell = _quant_cell(mo, scene_aabb, GROUP_CELL_BITS_PER_AXIS)
    key = (oct_ << (3 * GROUP_CELL_BITS_PER_AXIS)) | cell
    return torch.where(anyl, key, 1 << (3 * GROUP_CELL_BITS_PER_AXIS + 3))
