"""Phase 31 of chip_smoke.py alone: kernel L's three shading steps on the
inputs the engine hands them at each depth of a config-4 frame and a
config-5 (full rebuild) frame at 1920x1080, on the card.

    python3 tools/port_shade.py

Run it from the root of a checkout on a machine with an NVIDIA GPU and
nvcc. It builds the kernels (printing ptxas's registers and spills per
kernel), sets up the full procedural scene, and runs
`chip_smoke.shade_hits_shapes` on config 4 at the start pose and on
config 5 with the full rebuild under rot_y(0.02): each call bit-equal to
its plain version, its ms a launch on a filled queue, the plain
version's ms and the call's bound. Prints the card's nvidia-smi name and
power limit, then one JSON object with each configuration's rows and
their sums per step.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from vkrt_tpu_torch import config as C, kernels, runtime  # noqa: E402
from vkrt_tpu_torch.scene.procedural import procedural_model  # noqa: E402
from vkrt_tpu_torch.wavefront.engine import Renderer  # noqa: E402


def main() -> int:
    dev = torch.device("cuda", 0)
    runtime.exact_f32()
    b = kernels.build()
    print(f"built in {b.seconds:.1f} s", flush=True)
    for line in b.log.splitlines():
        if "shade" in line or "spill" in line:
            print("  ptxas:", line.strip())
    kernels.library()
    model = procedural_model("full", seed=cs.SEED)
    r4 = Renderer(model, C.config4_flythrough(), dev, quantize=True,
                  graph=False)
    r5 = Renderer(model, C.config5_stress(), dev, quantize=True,
                  rebuild="full", graph=False)
    cam = cs.start_camera(1920, 1080)
    t0 = time.perf_counter()
    res = {"config4": cs.shade_hits_shapes(r4, cam),
           "config5_full": cs.shade_hits_shapes(r5, cam, cs.rot_y(0.02),
                                                "config 5, full")}
    print(f"phase 31: {time.perf_counter() - t0:.1f} s")
    sums = {c: {s: {k: sum(r[k] for r in rows if r["step"] == s)
                    for k in ("ms", "plain_ms", "bound_ms")}
                for s in ("shade_interp", "shade_lights", "shade_combine")}
            for c, rows in res.items()}
    print(runtime.nvidia_smi_line())
    print(json.dumps({"rows": res, "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
