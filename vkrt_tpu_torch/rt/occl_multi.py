"""Multi-light occlusion trace — counterpart of vkrt_tpu/rt/occl_multi.py.

`occluded_multi` is kernel B's wrapper. On a CUDA tensor it launches the
hand-written kernel in csrc/occl_multi.cu (which replaces the Pallas
kernel `_occl_multi_kernel`, occl_multi.py:40) or raises; on a CPU
tensor it runs `occluded_multi_plain`, the plain PyTorch version.

NS segment sets share one surface wavefront: set s starts at light point
light_pts[s], runs along dirs[s] and ends at tmax[s] (0 = parked).
Returns blocked bool[NS, Nb, 128]. A segment with 0 < tmax <= TMIN is
not blocked: its interval is empty.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.rt.dense import (LANES, _check_tree,
                                     trace_occluded_plain)
from vkrt_tpu_torch.accel.clusters import ClusterTree


def occluded_multi_plain(tree: ClusterTree, light_pts, dirs, tmax):
    """Plain PyTorch version of kernel B (same inputs and outputs as
    `occluded_multi`): every (set, ray) is one segment from its set's
    light point, traced by the plain any-hit version."""
    ns, nb = dirs.shape[0], dirs.shape[2]
    d = dirs.permute(1, 0, 2, 3).reshape(3, ns * nb, LANES)
    o = light_pts.T[:, :, None, None].expand(3, ns, nb, LANES)
    blocked = trace_occluded_plain(tree, o.reshape(3, ns * nb, LANES), d,
                                   tmax.reshape(ns * nb, LANES))
    return blocked.reshape(ns, nb, LANES)


def occluded_multi(tree: ClusterTree, light_pts, dirs, tmax):
    """NS-segment-set occlusion trace (lane-major I/O).

    light_pts: f32[NS, 3]; dirs: f32[NS, 3, Nb, 128]; tmax: f32[NS, Nb, 128].
    A CUDA tensor launches kernel B and counts it in
    `occluded_multi.launches`; a CPU tensor runs `occluded_multi_plain`."""
    dev = dirs.device
    if dev.type == "cpu":
        return occluded_multi_plain(tree, light_pts, dirs, tmax)
    if dev.type != "cuda":
        raise ValueError(f"occluded_multi: unsupported device {dev}")
    ns, nb = dirs.shape[0], dirs.shape[2]
    if (dirs.shape != (ns, 3, nb, LANES) or tmax.shape != (ns, nb, LANES)
            or light_pts.shape != (ns, 3)):
        raise ValueError(f"occluded_multi: shapes lights "
                         f"{tuple(light_pts.shape)} d {tuple(dirs.shape)} "
                         f"tmax {tuple(tmax.shape)}")
    for name, x in (("light_pts", light_pts), ("dirs", dirs), ("tmax", tmax)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"occluded_multi: {name} must be f32 on {dev}")
    _check_tree(tree, dev)
    light_pts, dirs, tmax = (x.contiguous() for x in (light_pts, dirs, tmax))
    blocked = torch.empty(ns, nb, LANES, dtype=torch.bool, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_occl_multi(
            tree.sc_boxes.data_ptr(), tree.sc_boxes.shape[1],
            tree.num_superclusters, tree.cl_boxes.data_ptr(),
            tree.tri_data.data_ptr(), light_pts.data_ptr(), dirs.data_ptr(),
            tmax.data_ptr(), ns, nb * LANES, blocked.data_ptr(), stream)
    kernels.check(err, "occl_multi")
    occluded_multi.launches += 1
    return blocked


occluded_multi.launches = 0
