"""Phase 25 of chip_smoke.py alone: the JAX kernels' remaining modes
(stats, ablate, the interval pregate, group_gate / sort, visit, kernel
A''s sub_gate and pregates) on the card, without the other phases.

    python3 tools/port_modes.py

Run it from the root of a checkout on a machine with an NVIDIA GPU and
nvcc. It builds the kernels (printing ptxas's registers per kernel),
sets up the full procedural scene at config 4, records one 1080p
frame's kernel inputs at the start camera, computes kernel A's and B's
bounds there (as phase 9 does), and runs `chip_smoke.item15_modes`:
every mode launched once a depth and held against the default kernel
and its plain version, the ablate split of A and B, the stats,
trace_closest_stats on phase 21's frame and a build under
$VKRT_TORCH_CACHE. Prints the card's nvidia-smi name and power limit,
then one JSON object with each mode row's ms, plain ms and bound.
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
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    kernels.library()
    cfg = C.config4_flythrough()
    r = Renderer(procedural_model("full", seed=cs.SEED), cfg, dev,
                 quantize=True)
    tree = r.backend.tree
    cam = cs.start_camera(cfg.width, cfg.height)
    ntri = cs.live_tris(tree.tri_data)
    bounds = {"A": [], "B": []}
    for inp in cs.p25_inputs(r, cam):
        o, d, tm = inp["A"]
        bounds["A"].append(cs.closest_bound(
            tree, o, d, tm, cs.trace_dense(tree, o, d, tm)[0], ntri))
        bounds["B"].append(cs.occl_bound(tree, *inp["B"], ntri))
    t0 = time.perf_counter()
    res = cs.item15_modes(r, cam, bounds)
    print(f"phase 25: {time.perf_counter() - t0:.1f} s")
    rows = {k: dict(launches=res["launches"][k],
                    ms=[round(x["ms"], 4) for x in rs],
                    default_ms=[round(x["default_ms"], 4) for x in rs],
                    plain_ms=sum(x["plain_ms"] for x in rs),
                    bound_ms=cs.add_bounds(rs)["bound_ms"],
                    bound_by=cs.add_bounds(rs)["bound_by"])
            for k, rs in res["rows"].items()}
    print(runtime.nvidia_smi_line())
    print(json.dumps({"modes": rows, "ref": res["ref"],
                      "stats": {f"{k} d{d}": v
                                for (k, d), v in res["stats"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
