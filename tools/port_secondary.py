"""Phase 24 of chip_smoke.py alone: kernel A's and B's modes and the five
secondary-dispatch options, on the card, without the other phases.

    python3 tools/port_secondary.py

Run it from the root of a checkout on a machine with an NVIDIA GPU and
nvcc. It builds the kernels (printing ptxas's registers and shared
memory per kernel), sets up the full procedural scene at config 4, and
runs `chip_smoke.secondary_options` on phase 3's probe rays and phase
4's segments: each mode against the default kernel and its plain
version, the modes' times on one config-4 frame's inputs, and config 4
and config 5 refit frames with each option (bit-equal to the defaults).
Prints the card's nvidia-smi name and power limit, then one JSON object
with each mode row and each case's ms a frame, device busy ms, ranges
and launches a frame.
"""

import itertools
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from vkrt_tpu_torch import config as C, kernels, runtime  # noqa: E402
from vkrt_tpu_torch.app.flythrough import camera_path  # noqa: E402
from vkrt_tpu_torch.scene.procedural import procedural_model  # noqa: E402
from vkrt_tpu_torch.wavefront.engine import Renderer  # noqa: E402


def main() -> int:
    dev = torch.device("cuda", 0)
    runtime.exact_f32()
    b = kernels.build()
    print(f"built in {b.seconds:.1f} s", flush=True)
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    kernels.library()
    cfg = C.config4_flythrough()
    r = Renderer(procedural_model("full", seed=cs.SEED), cfg, dev,
                 quantize=True)
    tree = r.backend.tree
    o, d, tmax = cs.probe_rays(dev)
    _, slot, u, v, attrs = cs.trace_dense(tree, o, d, tmax)
    lp, sd, st = cs.shadow_inputs(u, v, attrs, slot >= 0, r.lights)
    cams = list(itertools.islice(camera_path(cfg.width, cfg.height),
                                 cs.N_FRAMES + 1))
    cam = cs.start_camera(cfg.width, cfg.height)
    t0 = time.perf_counter()
    res = cs.secondary_options(r, cams, cam, (o, d, tmax, lp, sd, st))
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    rows = {k: dict(launches=res["launches"][k], max_abs_err=res["errs"][k],
                    ms=sum(x["ms"] for x in rs),
                    default_ms=sum(x["default_ms"] for x in rs),
                    plain_ms=sum(x["plain_ms"] for x in rs),
                    bound_ms=cs.add_bounds(rs)["bound_ms"])
            for k, rs in res["rows"].items()}
    frames = {c: {k: {key: v[key] for key in ("frame_ms", "busy_ms",
                                              "range_ms", "launches")}
                  for k, v in f.items()} for c, f in res["frames"].items()}
    print(runtime.nvidia_smi_line())
    print(json.dumps({"modes": rows, "frames": frames}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
