"""The port's raster renderer as a run drives it:
`Rasterizer(quantize=True).render_async` (raster/pipeline.py), one
replayed CUDA graph a frame giving (u8 frame, visibility queries), the
CLI's raster fly-through; and raster_reference.py's plain frame.

The entry interface is entries/renderer.py's: `build(model, config,
device)` and `reference_frames(scene, config, items, device, tf32)`.
The configuration names the raster settings beside `render`: `msaa`,
`method` and `backend`. The raster path has no accel update, so a
transform is refused.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, NamedTuple

import numpy as np


class Entry(NamedTuple):
    frame: Callable
    free: Callable
    program: Any          # what per-layer readers may look into


def _inverse(m):
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)


def camera(pose):
    """What Rasterizer.render_async reads of a camera, from a Pose: the
    forward view and projection (the edge method's WVP) from the Pose's
    inverses, and the inverses themselves (the ray-cast method's)."""
    return SimpleNamespace(view_matrix=_inverse(pose.view_inverse),
                           projection_matrix=_inverse(pose.proj_inverse),
                           proj_inverse=pose.proj_inverse,
                           view_inverse=pose.view_inverse)


def build(model, config: dict, device) -> Entry:
    from vkrt_tpu_torch.config import RenderConfig
    from vkrt_tpu_torch.raster.pipeline import Rasterizer
    r = Rasterizer(model, RenderConfig(**config["render"]), device,
                   config["msaa"], config["method"], config["backend"],
                   quantize=True)

    def frame(pose, m):
        if m is not None:
            raise ValueError("the raster path has no instance transform")
        return r.render_async(camera(pose))
    return Entry(frame, r.free_graphs, r)


def reference_frames(scene, config: dict, items, device, tf32=False):
    import raster_reference as RR
    import reference as R
    geo = R.geometry(scene, device)
    tex = R.textures(scene, device)
    tree = R.build_tree(geo)
    for pose, m in items:
        if m is not None:
            raise ValueError("the raster path has no instance transform")
        fb, queries, layers = RR.render(geo, tex, tree, config["render"],
                                        pose, config["msaa"], tf32)
        yield fb.cpu().numpy(), queries, layers.cpu().numpy()
