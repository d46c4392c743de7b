"""Golden-image harness CLI — counterpart of vkrt_tpu/golden/harness.py.

Renders one frame from the start pose through the port's engine (the
card unless --device cpu) and through an independent CPU oracle (numpy
brute force, or the native C++ BVH tracer), and prints one JSON line
with their RMSE; exits 1 when it is above --threshold. Takes the CLI's
flags, plus:

  python -m vkrt_tpu_torch.golden.harness --scene Sponza.gltf --config 3 \\
      --width 96 --height 64
  python -m vkrt_tpu_torch.golden.harness --scene Sponza.gltf --config 2 \\
      --submeshes 10 --oracle native --save-diff diff.png

`main(argv, scene=model)` takes an in-memory Model in place of --scene.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vkrt_tpu_torch.app.cli import build_parser, resolve_config


def main(argv=None, scene=None) -> int:
    base = build_parser()
    p = argparse.ArgumentParser(parents=[base], add_help=False,
                                prog="vkrt-tpu-torch-golden")
    p.add_argument("--submeshes", type=int, default=0,
                   help="limit to the first N submeshes (keeps the brute "
                        "oracle tractable; 0 = all)")
    p.add_argument("--oracle", choices=["brute", "native"], default="brute")
    p.add_argument("--save-diff", help="write |engine - oracle| heatmap PNG")
    p.add_argument("--threshold", type=float, default=1e-3)
    args = p.parse_args(argv)
    cfg = resolve_config(args)
    if scene is None and not args.scene:
        p.error("--scene is required")

    from vkrt_tpu_torch import config as C
    from vkrt_tpu_torch import runtime
    from vkrt_tpu_torch.app.camera import Camera
    from vkrt_tpu_torch.app.framebuffer import rmse, write_png
    from vkrt_tpu_torch.golden.cpu_tracer import render_golden
    from vkrt_tpu_torch.scene import (build_texture_heap, flatten_model,
                                      load_model)
    from vkrt_tpu_torch.scene.model import Model
    from vkrt_tpu_torch.wavefront.engine import (make_backend, render_frame,
                                                 texture_arrays,
                                                 upload_matrix)

    runtime.initialize(args.device)
    dev = torch.device(args.device)
    model = scene if scene is not None else load_model(
        args.scene, max_texture_dim=args.max_texture_dim or 64)
    if args.submeshes:
        model = Model(submeshes=model.submeshes[: args.submeshes],
                      materials=model.materials, images=model.images)
    flat = flatten_model(model)
    tex = texture_arrays(model.images, flat, dev)
    heap = build_texture_heap(model.images)   # the oracle's own (independent)
    backend = make_backend(flat, args.backend, dev)
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)

    fb, _ = render_frame(backend, tex, upload_matrix(cam.proj_inverse, dev),
                         upload_matrix(cam.view_inverse, dev),
                         upload_matrix(C.LIGHT_POSITIONS, dev), cfg)
    fb = fb.cpu().numpy()
    golden = render_golden(flat, heap, cam.proj_inverse, cam.view_inverse,
                           cfg, accel=args.oracle)

    err = rmse(fb, golden)
    result = {
        "rmse": err,
        "threshold": args.threshold,
        "pass": bool(err <= args.threshold),
        "resolution": [cfg.width, cfg.height],
        "backend": args.backend,
        "oracle": args.oracle,
        "submeshes": args.submeshes or len(model.submeshes),
    }
    if args.save_diff:
        diff = np.abs(np.clip(fb, 0, 1) - np.clip(golden, 0, 1))
        write_png(args.save_diff, diff / max(diff.max(), 1e-6))
        result["diff_png"] = args.save_diff
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
