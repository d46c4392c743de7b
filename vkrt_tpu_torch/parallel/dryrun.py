"""Multi-device dry run — the port's copy of the JAX package's
`__graft_entry__.dryrun_multichip` (__graft_entry__.py:72-305).

Renders 64x48 frames of the small procedural scene (in memory) on a mesh
of `n_devices` shards of one device and holds each sharded frame against
the same frame rendered unsharded, bit for bit (mesh.py says why the bar
is equality):

  * the reference backend (LBVH) and the dense backend (kernels A-F);
  * dense, the three depth>=1 reorder flags off: the same frame;
  * dense, on a refit tree and on a full device-SAH rebuild;
  * the edge rasterizer (kernel G), sharded against unsharded.

    python -c "from vkrt_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               dryrun_multichip(8, 'cpu')"

The JAX run's resort, recheck and partition-closest steps are variants
this port leaves out (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.parallel.mesh import (make_mesh,
                                          render_frame_sharded,
                                          render_raster_frame_sharded)
from vkrt_tpu_torch.raster.pipeline import render_raster_frame_edge
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine

W, H = 64, 48
REORDER_OFF = dict(consolidate_secondary=False, group_sort_shadows=False,
                   partition_shadows=False)


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Every check above on make_mesh([device] * n_devices); raises
    AssertionError on the first frame that differs. Returns {check: rays
    traced} (0 for the raster frame)."""
    mesh = make_mesh([device] * n_devices)
    dev = mesh.devices[0]
    cfg = C.RenderConfig(width=W, height=H, max_depth=2, num_lights=2,
                         enable_shadows=True, enable_reflections=True)
    r = engine.Renderer(procedural_model("small", seed=0), cfg, dev)
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    pi = engine.upload_matrix(cam.proj_inverse, dev)
    vi = engine.upload_matrix(cam.view_inverse, dev)
    out = {}

    def check(label, backend, cfg_=cfg, want=None):
        if want is None:
            want = engine.render_frame(backend, r.tex, pi, vi, r.lights, cfg_)
        fb, rays = render_frame_sharded(backend, r.tex, pi, vi, r.lights,
                                        cfg_, mesh)
        n = int(rays.sum())
        same = torch.equal(fb, want[0]) and torch.equal(rays, want[1])
        print(f"dryrun_multichip({n_devices}, {dev}): {label}: sharded "
              f"{'==' if same else '!='} unsharded, {n} rays", flush=True)
        if not same or n < W * H or fb.shape != (H, W, 3):
            raise AssertionError(f"{label}: the sharded frame differs "
                                 "from the unsharded frame")
        out[label] = n
        return fb, rays

    check("reference backend", engine.make_backend(r.flat, "reference", dev))
    dense = check("dense backend", r.backend)
    check("dense, reorder flags off", r.backend,
          dataclasses.replace(cfg, **REORDER_OFF), want=dense)
    full = copy.copy(r)
    full.rebuild = "full"
    for label, tree in (("dense, refit tree", r.update_tree(_rot_y(0.05))),
                        ("dense, device-SAH rebuild", full.update_tree(
                            np.eye(4, dtype=np.float32)))):
        check(label, r.backend._replace(tree=tree))

    vm = engine.upload_matrix(cam.view_matrix, dev)
    pm = engine.upload_matrix(cam.projection_matrix, dev)
    want = render_raster_frame_edge(r.backend.tree, r.tex, vm, pm, cfg, 1)
    got = render_raster_frame_sharded(r.backend.tree, r.tex, vm, pm, cfg,
                                      mesh, msaa=1)
    same = torch.equal(got, want)
    print(f"dryrun_multichip({n_devices}, {dev}): edge raster: sharded "
          f"{'==' if same else '!='} unsharded", flush=True)
    if not same:
        raise AssertionError("edge raster: the sharded frame differs from "
                             "the unsharded frame")
    out["edge raster"] = 0
    return out
