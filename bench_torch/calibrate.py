#!/usr/bin/env python3
"""Readings from which a cell's check limits are set (check.py).

    python3 bench_torch/calibrate.py --workload c4-fly --seeds 1 2 3 \\
        --control 3 --seconds 3

In one process (set-up once): for each seed, a short window of the
cell's own traffic and load through the same timed path as run.py, and
check.py's numbers of the frames drawn from that seed against the
reference; for the first `--control` seeds also the control's: the
reference with TF32 inputs to its matmuls (the nearest precision below
the configuration's float32 with TF32 off) in the program's place,
against the reference. One JSON line a reading; the limits in
cells/<workload>.json lie between the program's largest and the
control's smallest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run

import check
import faults
import scene_gen
import spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", type=int, default=0,
                    help="for the first N seeds also the readings with "
                    "faults.py's faults planted in the timed path")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load(args.workload, run.ROOT)
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = run.setup(cell, scene, "cuda", args.seeds[0])
    for k, seed in enumerate(args.seeds):
        state.frames = run.frames_of(cell, seed)
        win = run.window(state, args.seconds, seed)
        t = time.perf_counter()
        numbers, idx = run.compare(state, scene, win, seed)
        print(json.dumps({"seed": seed, "side": "program", "frames": idx,
                          **numbers,
                          "reference_s": time.perf_counter() - t}),
              flush=True)
        if k < args.control:
            ref = {i: r for i, *r in run.reference_frames(state, scene, idx)}
            ctl = [check.compare(fb, n, *ref[i]) for i, fb, n, _ in
                   run.reference_frames(state, scene, idx, tf32=True)]
            print(json.dumps({"seed": seed, "side": "control", "frames": idx,
                              **check.worst(ctl)}), flush=True)
        if k < args.faults:
            for fault in faults.ALL:
                win = run.window(state, args.seconds, seed,
                                 fault(state.entry.frame))
                numbers, idx = run.compare(state, scene, win, seed)
                print(json.dumps({"seed": seed, "side": fault.__name__,
                                  "frames": idx, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
