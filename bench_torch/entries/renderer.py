"""The port's ray tracer as a run drives it: `Renderer.render_async`
(wavefront/engine.py), one replayed CUDA graph a frame, the CLI's own
path; and reference.py's plain renderer for the frames it must give.

An entry module (a configuration's `"entry"`) exposes

  build(model, config, device) -> Entry   the program, built at the
      configuration's settings: `frame(pose, transform)` enqueues a frame
      and returns device tensors (u8 framebuffer, ray count) without
      waiting; `free()` drops what the program holds on the card
  reference_frames(scene, config, items, device, tf32)
      for each (pose, transform) of `items`, the reference's (u8
      framebuffer, rays, closest-hit rays per pixel), computed with
      nothing the program made; tf32 puts TF32 inputs under its matmuls
      (the control)
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple


class Entry(NamedTuple):
    frame: Callable
    free: Callable
    program: Any          # what per-layer readers may look into


def build(model, config: dict, device) -> Entry:
    from vkrt_tpu_torch.config import RenderConfig
    from vkrt_tpu_torch.wavefront.engine import Renderer
    r = Renderer(model, RenderConfig(**config["render"]), device,
                 quantize=True, rebuild=config["rebuild"])
    return Entry(r.render_async, r.free_graphs, r)


def reference_frames(scene, config: dict, items, device, tf32=False):
    import reference as R
    geo = R.geometry(scene, device)
    tex = R.textures(scene, device)
    tree = None
    for pose, m in items:
        if m is not None:
            g = R.transformed(geo, m, tf32)
            t = R.build_tree(g)
        else:
            g = geo
            tree = tree or R.build_tree(geo)
            t = tree
        fb, rays, segments = R.render(g, tex, t, config["render"], pose,
                                      tf32)
        yield fb.cpu().numpy(), rays, segments.cpu().numpy()
