"""Where the primary rays of the mirror mix land: the share of each path
frame's primary hits on a metallic material (metallic > 0.1, the shaders'
reflection threshold), from the benchmark's plain reference.

    python3 tools/mirror_poses.py [--device cpu]

Run it from the root of a checkout. It reads bench_torch/traffic/
mirror.json through the benchmark's `lookat` generator (bench_torch/
generators/lookat.py), makes the benchmark's full scene (bench_torch/
scene_gen.py, seed 0), builds the reference's own tree (bench_torch/
reference.py) and casts every path frame's primary rays through the
pixel centres at 480x270, the size the mix's `what` states. A hit's
metallic value is sampled from its material's metallic-roughness map at
the hit's texture coordinates, as the reference shades it. Prints one line a frame (path frame, keyframe,
share of pixels hit, share of the hits that are metallic) and last one
JSON line: per keyframe the smallest metallic share over its frames, and
the smallest over the path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
sys.path.insert(0, str(BENCH))
MIX = BENCH / "traffic" / "mirror.json"
WIDTH, HEIGHT = 480, 270

import reference as R  # noqa: E402
import scene_gen  # noqa: E402
import spec  # noqa: E402


def metallic_share(geo, tex, tree, pose, width, height, device):
    """(share of pixels hit, share of hits whose metallic > 0.1)."""
    o, d = R.camera_rays(width, height, pose.proj_inverse,
                         pose.view_inverse, device)
    _, tri, u, v = R.trace(tree, o, d, torch.full_like(o[:, 0], R.TMAX))
    hit = tri >= 0
    th = tri[hit]
    bary = torch.stack([1.0 - u[hit] - v[hit], u[hit], v[hit]], dim=1)
    uv = (bary[:, :, None] * geo.uv[th]).sum(dim=1)
    metal = R.sample(tex, geo.img[th, 1], uv)[:, 2] > R.METALLIC_THRESHOLD
    n = int(hit.sum())
    return n / hit.numel(), (int(metal.sum()) / n if n else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    mix = json.loads(MIX.read_text())
    gen = spec.module("generators", mix["generator"], BENCH)
    frames = gen.Frames(mix, WIDTH, HEIGHT, 0)
    starts, k = [], 0
    for _, _, n in mix["keyframes"]:
        starts.append(k)
        k += int(n)
    scene = scene_gen.make_scene("full", 0)
    geo = R.geometry(scene, args.device)
    tex = R.textures(scene, args.device)
    tree = R.build_tree(geo)
    worst = {}
    t0 = time.perf_counter()
    for k in range(len(frames)):
        pose, m = frames.at(k)
        g = geo if m is None else R.transformed(geo, m)
        t = tree if m is None else R.build_tree(g)
        hit, metal = metallic_share(g, tex, t, pose, WIDTH, HEIGHT,
                                    args.device)
        key = max(i for i, s in enumerate(starts) if s <= k)
        worst[key] = min(worst.get(key, 1.0), metal)
        print(f"frame {k} keyframe {key} hit {hit:.4f} metallic "
              f"{metal:.4f} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    print(json.dumps({"mix": MIX.name, "size": [WIDTH, HEIGHT],
                      "keyframe_min_metallic_share": [
                          round(worst[i], 4) for i in sorted(worst)],
                      "path_min_metallic_share": round(min(worst.values()),
                                                       4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
