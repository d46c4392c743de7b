"""Group (128-lane) re-tiling of depth>=1 shadow wavefronts — counterpart
of the group half of vkrt_tpu/wavefront/resort.py.

Plain PyTorch: the JAX package computes these in XLA, not in Pallas.
Whole 128-lane rows (the engine's 8x16-pixel subtiles) are sorted by the
Morton cell of their mean live surface point; blocked masks come back
through the inverse permutation. Occlusion is an any-hit per segment, so
masks do not depend on the order.

Not ported: the ray-granular `cell_key` / `octant_key` / `permute_rays`
and `group_dir_key`, which serve `resort_secondary` and
`partition_closest` (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import torch

GROUP_CELL_BITS_PER_AXIS = 4
GROUP_CELL_KEY_BITS = 3 * GROUP_CELL_BITS_PER_AXIS + 1   # + dead-tail bit


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
    nbins = (1 << bits) - 1
    lo = scene_aabb[0]
    span = torch.clamp(scene_aabb[1] - scene_aabb[0], min=1e-6)
    key = torch.zeros(mean.shape[1], dtype=torch.int32, device=mean.device)
    for a in range(3):
        q = torch.clamp((mean[a] - lo[a]) / span[a] * (nbins + 1),
                        0.0, float(nbins)).to(torch.int32)
        for b in range(bits):
            key = key | (((q >> b) & 1) << (3 * b + a))
    return key


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
