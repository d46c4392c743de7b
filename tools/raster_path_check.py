"""The raster renderer along the whole fly path on one card, for comparing
two checkouts: each frame's digest, and kernel G's time at the path's
first pose.

    python3 tools/raster_path_check.py --out FILE.json [--frames 240]
        [--shapes]
    python3 tools/raster_path_check.py --compare A.json B.json

Run it from the root of a checkout of the repository on a machine with an
NVIDIA GPU and nvcc; it imports `vkrt_tpu_torch` (and, with --shapes,
chip_smoke.py) from the working directory, so the same file run from two
checkouts (one unpacked beside the other, in turns) compares them on one
card.

  * frames: Rasterizer(full procedural scene, reference_config() =
    1600x1200, msaa 8, quantize=True), the raster benchmark cell's
    renderer on its default graph path, renders each of the first
    --frames frames of the fly path (app/flythrough.py::camera_path, 240
    frames); the sha256 of each u8 frame's bytes and its visibility query
    count go to --out, with the device ms of the frames by CUDA events.
  * --shapes: chip_smoke.py's phase 13 (`raster_shapes`) on an eager
    Rasterizer at the path's first frame: G over the frame's 32 recorded
    calls (ms in all, per sample, per round), its bound and the (pixel,
    triangle) pairs counted, the setup's box rule.
  * --compare: the frames whose digests or counts differ between two
    such files; exit code 1 if any does.

Prints the card's nvidia-smi name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from vkrt_tpu_torch import config as C                       # noqa: E402
from vkrt_tpu_torch import runtime                           # noqa: E402
from vkrt_tpu_torch.app.flythrough import camera_path        # noqa: E402
from vkrt_tpu_torch.raster import pipeline as rp             # noqa: E402
from vkrt_tpu_torch.scene.procedural import procedural_model  # noqa: E402


def path_frames(model, frames: int) -> dict:
    cfg = C.reference_config()
    r = rp.Rasterizer(model, cfg, "cuda", msaa=8, quantize=True)
    cams = list(itertools.islice(camera_path(cfg.width, cfg.height), frames))
    r.render_async(cams[0])                     # capture
    torch.cuda.synchronize()
    digests, counts, ms = [], [], []
    for cam in cams:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fb8, n = r.render_async(cam)
        b.record()
        host = fb8.cpu().numpy()
        digests.append(hashlib.sha256(host.tobytes()).hexdigest())
        counts.append(int(n))
        ms.append(a.elapsed_time(b))
    r.free_graphs()
    return {"frames": len(cams), "digests": digests, "queries": counts,
            "frame_ms": ms, "frame_ms_mean": sum(ms) / len(ms)}


def shapes(model) -> dict:
    from chip_smoke import raster_shapes
    cfg = C.reference_config()
    r = rp.Rasterizer(model, cfg, "cuda", msaa=8, graph=False)
    cam = next(camera_path(cfg.width, cfg.height))
    res = raster_shapes(r, cam)
    res["ms_per_sample"] = res["ms"] / 8
    return res


def compare(a: str, b: str) -> int:
    with open(a) as f:
        x = json.load(f)
    with open(b) as f:
        y = json.load(f)
    fx, fy = x["path"], y["path"]
    differ = [k for k in range(min(fx["frames"], fy["frames"]))
              if fx["digests"][k] != fy["digests"][k]
              or fx["queries"][k] != fy["queries"][k]]
    same = fx["frames"] == fy["frames"] and not differ
    print(json.dumps({"frames": [fx["frames"], fy["frames"]],
                      "differ": differ, "bit_equal": same,
                      "frame_ms_mean": [fx["frame_ms_mean"],
                                        fy["frame_ms_mean"]]}))
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.out:
        ap.error("--out or --compare")
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    runtime.exact_f32()
    t0 = time.perf_counter()
    model = procedural_model("full", seed=0)
    out = {"cwd": os.getcwd(), "path": path_frames(model, args.frames)}
    if args.shapes:
        out["shapes"] = shapes(model)
    out["seconds"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(runtime.nvidia_smi_line())
    print(json.dumps({k: v for k, v in out.items() if k != "path"}
                     | {"frame_ms_mean": out["path"]["frame_ms_mean"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
