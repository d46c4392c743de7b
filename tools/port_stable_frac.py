"""The native oracle's stability mask on the port's stand-in scene, from
both packages' copies of the C++ tracer.

    JAX_PLATFORMS=cpu python3 tools/port_stable_frac.py [--width 640]
        [--height 480] [--seed 0]

Renders `render_golden(accel="native", with_stable=True)` of
`procedural_model("full", seed)` at the reference workload
(`reference_config()`: depth 2, 4 lights) from the start pose through
vkrt_tpu.golden and through vkrt_tpu_torch.golden, and prints one JSON
line: each package's `stable_frac` (the certified share of the pixels,
which bench.py's golden gate wants >= 0.90), their oracle seconds, and
whether images and masks are equal. CPU only: it needs the JAX package
(numpy paths, no JAX device code) and g++; no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from vkrt_tpu import config as JC  # noqa: E402
from vkrt_tpu.golden import render_golden as jax_golden  # noqa: E402
from vkrt_tpu_torch import config as TC  # noqa: E402
from vkrt_tpu_torch.app.camera import Camera  # noqa: E402
from vkrt_tpu_torch.golden.cpu_tracer import render_golden  # noqa: E402
from vkrt_tpu_torch.scene import (build_texture_heap,  # noqa: E402
                                  flatten_model)
from vkrt_tpu_torch.scene.procedural import procedural_model  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    model = procedural_model("full", seed=args.seed)
    flat = flatten_model(model)
    heap = build_texture_heap(model.images)
    cam = Camera(args.width, args.height)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    out = {"scene": f"procedural_model('full', seed={args.seed})",
           "resolution": [args.width, args.height]}
    frames = {}
    for name, fn, cfgmod in (("vkrt_tpu", jax_golden, JC),
                             ("vkrt_tpu_torch", render_golden, TC)):
        cfg = dataclasses.replace(cfgmod.reference_config(),
                                  width=args.width, height=args.height)
        t0 = time.perf_counter()
        img, stable = fn(flat, heap, cam.proj_inverse, cam.view_inverse, cfg,
                         accel="native", with_stable=True)
        out[name] = {"stable_frac": float(stable.mean()),
                     "oracle_s": time.perf_counter() - t0,
                     "finite": bool(np.isfinite(img).all())}
        frames[name] = (img, stable)
    (a, sa), (b, sb) = frames.values()
    out["equal"] = bool(np.array_equal(a, b) and np.array_equal(sa, sb))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
