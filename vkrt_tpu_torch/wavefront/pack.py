"""Live-ray consolidation — counterpart of vkrt_tpu/wavefront/pack.py.

A stable compaction of a lane-major wavefront by global live rank: the
ray whose rank is p moves to flat position p, so every live ray lands in
the leading rows in its original (camera-tile) order and the dead tail is
0. After the trace, `scatter_back` returns per-ray results to the
original order.

  grank[ray] = number of live rays before it, -1 on a dead ray

`consolidate` is kernel C's wrapper and `scatter_back` kernel D's
(csrc/pack.cu). On a CUDA tensor each launches its kernel or raises; on
a CPU tensor it runs its plain PyTorch version. Both move f32 values
without arithmetic, so kernel and plain version agree bit for bit.

grank is int32 here (the JAX package carries it as f32, a TPU lane-layout
choice), and the per-destination source ranges `src_lo`/`src_hi` are not
computed: the JAX kernel walks them to gather into a destination block,
a scatter needs none.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.utils.layout import LANES


def consolidate_plan(live):
    """Global live rank: live bool[Nb,128] → grank i32[Nb,128] (-1 dead)."""
    incl = torch.cumsum(live.reshape(-1), 0, dtype=torch.int32)
    return torch.where(live.reshape(-1), incl - 1, -1).reshape(live.shape)


def _check(name, x, idx, dev):
    """Raise unless x is f32[C,Nb,128] and idx i32[Nb,128], both
    contiguous on `dev` (the layout kernels C-F take)."""
    if (x.dim() != 3 or x.shape[1:] != idx.shape or x.shape[2] != LANES
            or x.dtype != torch.float32 or idx.dtype != torch.int32):
        raise ValueError(f"{name}: want f32[C,Nb,{LANES}] and i32[Nb,{LANES}]"
                         f", got {x.dtype}{tuple(x.shape)} and "
                         f"{idx.dtype}{tuple(idx.shape)}")
    for t in (x, idx):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on {dev}")


def consolidate_plain(x, grank):
    """Plain PyTorch version of kernel C: an index scatter (dead rays are
    sent to a spare column past the end and dropped)."""
    c = x.shape[0]
    n = grank.numel()
    g = grank.reshape(-1).long()
    idx = torch.where(g >= 0, g, n)
    out = torch.zeros(c, n + 1, device=x.device)
    out.scatter_(1, idx.expand(c, n), x.reshape(c, n))
    return out[:, :n].reshape(x.shape)


def consolidate(x, grank):
    """Pack channels by live rank.

    x f32[C,Nb,128], grank from `consolidate_plan` → f32[C,Nb,128] with
    the ray of rank p at flat position p and 0 after the last live ray.
    A CUDA tensor launches kernel C and counts it in
    `consolidate.launches`; a CPU tensor runs `consolidate_plain`."""
    dev = x.device
    if dev.type == "cpu":
        return consolidate_plain(x, grank)
    if dev.type != "cuda":
        raise ValueError(f"consolidate: unsupported device {dev}")
    _check("consolidate", x, grank, dev)
    out = torch.zeros_like(x)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_consolidate(x.data_ptr(), grank.data_ptr(), x.shape[0],
                                   grank.numel(), out.data_ptr(), stream)
    kernels.check(err, "consolidate")
    consolidate.launches += 1
    return out


consolidate.launches = 0


def scatter_back_plain(res, grank):
    """Plain PyTorch version of kernel D: a gather, 0 on dead rays."""
    s = res.shape[0]
    g = grank.reshape(1, -1).long()
    got = res.reshape(s, -1).gather(1, g.clamp(min=0).expand(s, -1))
    return torch.where(g >= 0, got, 0.0).reshape(res.shape)


def scatter_back(res, grank):
    """Inverse of `consolidate` for per-ray results of the packed
    dispatch: res f32[S,Nb,128] in packed order → original order, with
    out[s, j] = res[s, grank[j]] and 0 on dead rays (values past the last
    live rank never leak). A CUDA tensor launches kernel D and counts it
    in `scatter_back.launches`; a CPU tensor runs `scatter_back_plain`."""
    dev = res.device
    if dev.type == "cpu":
        return scatter_back_plain(res, grank)
    if dev.type != "cuda":
        raise ValueError(f"scatter_back: unsupported device {dev}")
    _check("scatter_back", res, grank, dev)
    out = torch.empty_like(res)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_scatter_back(res.data_ptr(), grank.data_ptr(),
                                    res.shape[0], grank.numel(),
                                    out.data_ptr(), stream)
    kernels.check(err, "scatter_back")
    scatter_back.launches += 1
    return out


scatter_back.launches = 0
