"""Where the host's time goes when it enqueues a config-4 frame, unsharded
and split over logical shards of one card.

    python3 tools/port_host_enqueue.py [--shards 1,2,4,7] [--frames 3]

Run it from the root of a checkout on a machine with an NVIDIA GPU and
nvcc; it imports `vkrt_tpu_torch` from the working directory. On the full
procedural scene at 1920x1080 and config 4's shipped defaults:

  * sync check: one unsharded and one 2-shard frame under
    `torch.cuda.set_sync_debug_mode("warn")`; the synchronizing calls
    PyTorch reports (a prototype detector: it does not see every kind);
  * per shard count (0 = `engine.render_frame`, unsharded; k =
    `parallel.mesh.render_frame_sharded` on [card] * k): `--frames`
    frames enqueued back to back, the host's ms a frame (perf_counter,
    no wait) and its share inside each engine range (the
    `record_function` scopes of wavefront/engine.py, timed on the host),
    the rest outside them; then the same frames each from an idle stream
    (a synchronize before each).

Prints the card's nvidia-smi name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
import warnings

import torch

sys.path.insert(0, os.getcwd())

from vkrt_tpu_torch import config as C  # noqa: E402
from vkrt_tpu_torch import runtime  # noqa: E402
from vkrt_tpu_torch.app.flythrough import camera_path  # noqa: E402
from vkrt_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                          render_frame_sharded)
from vkrt_tpu_torch.scene.procedural import procedural_model  # noqa: E402
from vkrt_tpu_torch.wavefront import engine  # noqa: E402


class HostRanges:
    """While active, every engine `record_function(name)` scope adds its
    host time (ms) to `ms[name]`."""

    def __init__(self):
        self.ms = {}

    def __enter__(self):
        self.saved = engine.record_function
        engine.record_function = self._scope
        return self

    def __exit__(self, *exc):
        engine.record_function = self.saved

    def _scope(self, name):
        outer = self

        class Scope:
            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                outer.ms[name] = outer.ms.get(name, 0.0) + (
                    time.perf_counter() - self.t) * 1e3

        return Scope()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", default="0,1,2,4,7")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runtime.initialize(dev)
    cfg = C.config4_flythrough()
    r = engine.Renderer(procedural_model("full", seed=0), cfg, dev)
    mats = [(engine.upload_matrix(c.proj_inverse, dev),
             engine.upload_matrix(c.view_inverse, dev))
            for c in itertools.islice(camera_path(cfg.width, cfg.height),
                                      args.frames + 1)]

    def frame(k, m):
        if k == 0:
            return engine.render_frame(r.backend, r.tex, *m, r.lights, cfg)
        return render_frame_sharded(r.backend, r.tex, *m, r.lights, cfg,
                                    make_mesh([dev] * k))

    frame(2, mats[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        frame(0, mats[0])
        frame(2, mats[0])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sorted({f"{w.filename}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message).lower()
                    and "prototype" not in str(w.message)})

    out = {"sync_calls": syncs, "shards": {}}
    for k in (int(x) for x in args.shards.split(",")):
        frame(k, mats[0])
        torch.cuda.synchronize()
        with HostRanges() as hr:
            t0 = time.perf_counter()
            for m in mats[1:]:
                frame(k, m)
            host = (time.perf_counter() - t0) * 1e3 / args.frames
        torch.cuda.synchronize()
        idle = []
        for m in mats[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(k, m)
            idle.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ranges = {n: v / args.frames for n, v in sorted(hr.ms.items())}
        out["shards"][k] = dict(
            host_ms=host, host_ms_idle_stream=sum(idle) / len(idle),
            range_host_ms=ranges,
            outside_ranges_ms=host - sum(ranges.values()))
    print(runtime.nvidia_smi_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
