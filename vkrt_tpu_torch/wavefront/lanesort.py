"""Block-local stable per-ray sort — counterpart of
vkrt_tpu/wavefront/lanesort.py.

Inside each block of R lanes (one trace block, R = 512 or 1024), rays
re-order by a stable ascending sort of an integer key; `lane_unsort`
returns per-ray results to the original lane order. Sorting the packed
depth-1 shadow prefix by a fine surface-point cell makes every 128-lane
group key-contiguous, so the group partition after it (resort.py) sees
meaningful group keys.

`lane_sort` is kernel E's wrapper and `lane_unsort` kernel F's
(csrc/lanesort.cu). On a CUDA tensor each launches its kernel or raises;
on a CPU tensor it runs its plain PyTorch version. Both move f32 values
without arithmetic, so kernel and plain version agree bit for bit.

Keys and ranks are int32 here (the JAX package carries them as f32,
exact below 2**24). `cell_key_fine` keys the depth>=1 shadow points,
`dir_cell_key_fine` the reflection rays that `partition_closest` sorts.
"""

from __future__ import annotations

import contextlib

import torch

from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.utils.layout import LANES
from vkrt_tpu_torch.wavefront.pack import _check as _check_layout
from vkrt_tpu_torch.wavefront.resort import _morton

CELL_BITS = 6          # bits per axis of cell_key_fine (the shadow points)
DIR_CELL_BITS = 5      # ... of dir_cell_key_fine (partition_closest)


def cell_key_fine(p, live, scene_aabb, bits: int = CELL_BITS):
    """Per-ray Morton cell of a surface point at `bits` bits per axis;
    dead rays get the max key 2**(3 bits) (they sort to each block's
    tail). p [3,Nb,128], live bool[Nb,128], scene_aabb f32[2,3] →
    i32[Nb,128]. The same f32 operations in the same order as the JAX
    function, so the keys are bit-equal."""
    span = torch.clamp(scene_aabb[1] - scene_aabb[0], min=1e-6)
    key = _morton(p, scene_aabb[0], span, bits, p.shape[1:])
    return torch.where(live, key, 1 << (3 * bits))


def dir_cell_key_fine(d, o, live, scene_aabb, bits: int = DIR_CELL_BITS):
    """Per-ray direction octant (major) and origin Morton cell at `bits`
    bits per axis (minor), the ray-granular form of
    resort.group_dir_key; dead rays get 2**(3 bits + 3). d, o
    [3,Nb,128], live bool[Nb,128] → i32[Nb,128], bit-equal to the JAX
    function's keys."""
    oct_ = ((d[0] < 0).to(torch.int32) | ((d[1] < 0).to(torch.int32) << 1)
            | ((d[2] < 0).to(torch.int32) << 2))
    span = torch.clamp(scene_aabb[1] - scene_aabb[0], min=1e-6)
    cell = _morton(o, scene_aabb[0], span, bits, d.shape[1:])
    return torch.where(live, (oct_ << (3 * bits)) | cell, 1 << (3 * bits + 3))


def _check(name, x, idx, block, dev):
    _check_layout(name, x, idx, dev)
    if block % LANES or not LANES <= block <= 1024 or idx.numel() % block:
        raise ValueError(f"{name}: block {block} must be a multiple of "
                         f"{LANES} in [{LANES}, 1024] dividing "
                         f"{idx.numel()} rays")


def _on_device(dev):
    """A scope in which `dev` is the current device for a launch: none
    where it already is (the usual case), which spares the call two
    device switches."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def lane_sort_plain(x, key, block: int):
    """Plain PyTorch version of kernel E: a stable sort of each block's
    keys (a [nbk, block] view), channels gathered in that order."""
    c = x.shape[0]
    perm = torch.sort(key.reshape(-1, block), dim=1, stable=True).indices
    xs = x.reshape(c, -1, block).gather(2, perm.expand(c, -1, -1))
    rank = torch.empty_like(perm)
    rank.scatter_(1, perm, torch.arange(block, device=key.device)
                  .expand_as(perm).contiguous())
    return xs.reshape(x.shape), rank.to(torch.int32).reshape(key.shape)


def lane_sort(x, key, *, block: int):
    """Stable in-block sort of lane-major channels by an integer key.

    x f32[C,Nb,128], key i32[Nb,128] with values below 2**24 (larger keys
    are the caller's fault: the JAX package's f32 keys are exact only
    below that; kernel E, a radix sort of as many 8-bit passes as the
    block's keys need, and the plain version agree on any int32 key).
    Returns (sorted f32[C,Nb,128], rank i32[Nb,128]): rank[j]
    is the position in its block that lane j moved to, in ORIGINAL lane
    order — `lane_unsort` inverts with it. A CUDA tensor launches kernel E
    and counts it in `lane_sort.launches`; a CPU tensor runs
    `lane_sort_plain`."""
    dev = x.device
    if dev.type == "cpu":
        return lane_sort_plain(x, key, block)
    if dev.type != "cuda":
        raise ValueError(f"lane_sort: unsupported device {dev}")
    _check("lane_sort", x, key, block, dev)
    out = torch.empty_like(x)
    rank = torch.empty_like(key)
    lib = kernels.library()
    with _on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_lane_sort(x.data_ptr(), key.data_ptr(), x.shape[0],
                                 key.numel(), block, out.data_ptr(),
                                 rank.data_ptr(), stream)
    kernels.check(err, "lane_sort")
    lane_sort.launches += 1
    return out, rank


lane_sort.launches = 0


def lane_unsort_plain(res, rank, block: int):
    """Plain PyTorch version of kernel F: a gather in each block."""
    s = res.shape[0]
    r = rank.reshape(1, -1, block).long().expand(s, -1, -1)
    return res.reshape(s, -1, block).gather(2, r).reshape(res.shape)


def lane_unsort(res, rank, *, block: int):
    """Invert `lane_sort` on per-ray results of the sorted dispatch:
    res f32[S,Nb,128] in sorted order, rank from `lane_sort` →
    f32[S,Nb,128] in original order, out[s, j] = res[s, base + rank[j]]
    with base the first lane of j's block. A CUDA tensor launches kernel
    F and counts it in `lane_unsort.launches`; a CPU tensor runs
    `lane_unsort_plain`."""
    dev = res.device
    if dev.type == "cpu":
        return lane_unsort_plain(res, rank, block)
    if dev.type != "cuda":
        raise ValueError(f"lane_unsort: unsupported device {dev}")
    _check("lane_unsort", res, rank, block, dev)
    out = torch.empty_like(res)
    ptrs = (res.data_ptr(), rank.data_ptr(), out.data_ptr())
    if ptrs[1] % 16 or ptrs[2] % 16:
        raise ValueError("lane_unsort: rank must start on a 16-byte "
                         "boundary (the kernel moves four lanes at a time)")
    with _on_device(dev):
        err = kernels.library().vkrt_lane_unsort(
            ptrs[0], ptrs[1], res.shape[0], rank.numel(), block, ptrs[2],
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "lane_unsort")
    lane_unsort.launches += 1
    return out


lane_unsort.launches = 0
