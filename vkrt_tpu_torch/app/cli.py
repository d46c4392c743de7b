"""CLI entry point — counterpart of vkrt_tpu/app/cli.py.

Every constant the reference bakes in is a flag, as in the JAX package,
plus `--device` (the card by default; `--device cpu` runs the plain
PyTorch versions of the kernels, as the tests do). Examples:

  python -m vkrt_tpu_torch.app.cli --config 1 --output frame.png
  python -m vkrt_tpu_torch.app.cli --config 4 --frames 240 --metrics
  python -m vkrt_tpu_torch.app.cli --raster --frames 1 --output raster.png
  python -m vkrt_tpu_torch.app.cli --config 4 --shard --output frame.png

A fly-through (--frames > 1) keeps up to 3 frames in flight
(runtime.FrameScheduler), u8 frames quantized on the device; the raster
path burns the FPS overlay into each retired frame on the host. A single
frame, a .npy output and --check-finite (which need the f32 image) render
serially, the raster path with its overlay too. --shard splits each
frame over devices (parallel/mesh.py) and renders serially, as the JAX
CLI does.
`main(argv, scene=model)` takes an in-memory `Model` in place of
--scene. Unlike the JAX CLI, --scene has no default path: the Sponza
glTF is not part of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vkrt-tpu-torch",
        description="Wavefront ray tracer on PyTorch + CUDA (vkrt port)")
    p.add_argument("--scene", help="glTF scene path (required unless the "
                   "caller passes a Model to main)")
    p.add_argument("--config", type=int, choices=[1, 2, 3, 4, 5],
                   help="BASELINE.json benchmark config")
    p.add_argument("--width", type=int, help="override resolution width")
    p.add_argument("--height", type=int, help="override resolution height")
    p.add_argument("--max-depth", type=int, help="override bounce depth")
    p.add_argument("--lights", type=int, help="override light count (0-4)")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--no-reflections", action="store_true")
    p.add_argument("--backend", choices=["dense", "reference"],
                   default="dense")
    p.add_argument("--frames", type=int, default=1,
                   help=">1 renders the scripted fly-through path")
    p.add_argument("--output", help="PNG (or .npy) output path")
    p.add_argument("--max-texture-dim", type=int, default=0,
                   help="downsample textures at load (0 = full res)")
    p.add_argument("--metrics", action="store_true", help="print metrics JSON")
    p.add_argument("--profile-dir",
                   help="turn tracing on and write a torch.profiler "
                        "Chrome trace (trace.json) and the frames' span "
                        "times and counters (spans.json) here")
    p.add_argument("--check-finite", action="store_true",
                   help="NaN/Inf sentinel on every frame")
    p.add_argument("--checkpoint",
                   help="checkpoint path: saved every frame; resumes if "
                        "present")
    p.add_argument("--raster", action="store_true",
                   help="use the classic raster pipeline instead of RT")
    p.add_argument("--shard", type=int, nargs="?", const=-1, default=None,
                   metavar="N",
                   help="shard rays (or raster pixel blocks) across "
                        "devices of --device's type: bare --shard = all "
                        "visible ones; --shard N = the first N (raises "
                        "when fewer are visible; with --device cpu, N "
                        "logical shards on the CPU)")
    p.add_argument("--msaa", type=int, default=8, choices=[1, 8],
                   help="raster-path MSAA sample count")
    p.add_argument("--raster-method", choices=["auto", "edge", "wavefront"],
                   default="auto",
                   help="raster machinery: 'edge' = edge-function "
                        "rasterizer (kernel G), 'wavefront' = ray-cast "
                        "equivalent; 'auto' = edge on the dense backend")
    p.add_argument("--mip-lod", action="store_true",
                   help="beyond parity: trilinear mip filtering from "
                        "wavefront ray differentials (the reference's RT "
                        "stage always samples mip 0, so golden configs "
                        "keep this off)")
    p.add_argument("--resort", action="store_true",
                   help="secondary-dispatch resort: reflection rays by "
                        "direction octant, shadow segments by surface "
                        "cell (off by default; the frame is the same)")
    p.add_argument("--no-resort", action="store_true",
                   help="secondary-dispatch resort off (its default)")
    p.add_argument("--recheck", action="store_true",
                   help="two-level gate of kernels A (depth >= 1) and B: "
                        "interval candidate lists re-tested per ray (off "
                        "by default; the frame is the same)")
    p.add_argument("--rebuild", choices=["refit", "full", "full_morton"],
                   default="refit",
                   help="per-frame accel update when the config rebuilds "
                        "(config 5): 'refit' = box refit, 'full' = device "
                        "SAH rebuild, 'full_morton' = Morton (LBVH) order, "
                        "then the cluster assembly")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without a "
                        "card) or 'cpu' (the kernels' plain versions)")
    return p


def resolve_config(args):
    from vkrt_tpu_torch import config as C
    cfg = C.BASELINE_CONFIGS[args.config]() if args.config \
        else C.reference_config()
    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.max_depth:
        overrides["max_depth"] = args.max_depth
    if args.lights is not None:
        overrides["num_lights"] = args.lights
    if args.no_shadows:
        overrides["enable_shadows"] = False
    if args.no_reflections:
        overrides["enable_reflections"] = False
    if args.mip_lod:
        overrides["mip_lod"] = True
    if args.resort:
        overrides["resort_secondary"] = True
    if args.no_resort:
        overrides["resort_secondary"] = False
    if args.recheck:
        overrides["recheck_secondary"] = True
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _shard_mesh(n: int, device):
    """The mesh of --shard N on --device's type: all visible devices for
    a bare --shard (n = -1), else the first n. The JAX CLI re-execs onto a
    virtual CPU mesh when fewer devices are visible; this one raises
    ValueError instead (a card is never swapped for the CPU unasked).
    With --device cpu, N shards of the one CPU device."""
    import torch

    from vkrt_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(device)
    if device.type == "cpu":
        return make_mesh([device] * max(n, 1))
    visible = torch.cuda.device_count() if device.type == "cuda" else 0
    if n > visible or visible == 0:
        raise ValueError(f"--shard{'' if n < 0 else f' {n}'}: {visible} "
                         f"{device.type} device(s) visible (pass --device "
                         "cpu for logical shards on the CPU)")
    return make_mesh([torch.device(device.type, i)
                      for i in range(visible if n < 0 else n)])


def _sharded_renderer(src, cfg, args, mesh):
    """A renderer for --shard with render(camera) → (f32 frame, rays), or
    the raster frame with --raster. The scene is built on the mesh's
    first device and replicated once; as in the JAX CLI there is no
    per-frame accel update, and the raster path draws no FPS overlay."""
    import torch

    from vkrt_tpu_torch import config as C
    from vkrt_tpu_torch.parallel.mesh import (render_frame_sharded,
                                              render_raster_frame_sharded,
                                              replicate)
    from vkrt_tpu_torch.wavefront.engine import SceneOnDevice, upload_matrix

    home = mesh.devices[0]
    if args.raster and (args.backend != "dense"
                        or args.raster_method == "wavefront"):
        raise ValueError("--raster --shard runs the edge rasterizer: it "
                         "needs --backend dense and --raster-method edge")
    scene = SceneOnDevice(src, cfg, home, args.backend, args.max_texture_dim)
    print(f"sharding {'raster pixels' if args.raster else 'rays'} over "
          f"{mesh.size} devices", file=sys.stderr)
    if args.raster:
        replicas = replicate(scene.tex, mesh)

        class ShardedRaster:
            def render(self, camera):
                return render_raster_frame_sharded(
                    scene.backend.tree, scene.tex,
                    upload_matrix(camera.view_matrix, home),
                    upload_matrix(camera.projection_matrix, home), cfg, mesh,
                    msaa=args.msaa, replicas=replicas).cpu().numpy()

        return ShardedRaster()
    lights = torch.as_tensor(C.LIGHT_POSITIONS, device=home)
    replicas = replicate((scene.backend, scene.tex, lights), mesh)

    class Sharded:
        def render(self, camera):
            fb, rays = render_frame_sharded(
                scene.backend, scene.tex,
                upload_matrix(camera.proj_inverse, home),
                upload_matrix(camera.view_inverse, home), lights, cfg, mesh,
                replicas=replicas)
            return fb.cpu().numpy(), int(rays.sum())

    return Sharded()


def main(argv=None, scene=None) -> int:
    """Run the CLI. `scene` (a vkrt_tpu_torch.scene.Model) replaces
    --scene, for callers that build their scene in memory."""
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = resolve_config(args)
    if scene is None and not args.scene:
        parser.error("--scene is required")
    mesh = _shard_mesh(args.shard, args.device) if args.shard else None

    from vkrt_tpu_torch import config as C
    from vkrt_tpu_torch import runtime
    from vkrt_tpu_torch.app import framebuffer
    from vkrt_tpu_torch.app.camera import Camera
    from vkrt_tpu_torch.app.flythrough import camera_path
    from vkrt_tpu_torch.app.metrics import FrameTimer, check_finite, profile
    from vkrt_tpu_torch.app.state import load_state, save_state
    from vkrt_tpu_torch.wavefront.engine import Renderer

    runtime.initialize(args.device)
    src = args.scene if scene is None else scene
    # quantize on the device (u8 frame + scalar ray or visibility-query
    # count) unless the caller needs the f32 image on the host
    quantize = not args.check_finite and not (
        args.output and args.output.endswith(".npy"))
    # frames in flight: up to 3 frames queued on the card while the host
    # prepares the next camera and checkpoints the last retired frame
    # (the reference's 3 swapchain images, Context.cpp:141-180; its
    # raster path keeps them too). The raster path's f32 frames and the
    # sharded paths stay serial, as in the JAX CLI.
    pipeline = args.frames > 1 and mesh is None and (
        quantize or not args.raster)
    if mesh is not None:
        renderer = _sharded_renderer(src, cfg, args, mesh)
    elif args.raster:
        from vkrt_tpu_torch.raster.pipeline import Rasterizer, fps_overlay
        renderer = Rasterizer(src, cfg, args.device, msaa=args.msaa,
                              method=args.raster_method, backend=args.backend,
                              max_texture_dim=args.max_texture_dim,
                              quantize=pipeline)
    else:
        renderer = Renderer(src, cfg, args.device, quantize=quantize,
                            rebuild=args.rebuild, backend=args.backend,
                            max_texture_dim=args.max_texture_dim)

    start_frame = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        _, _, start_frame, _ = load_state(args.checkpoint)
        print(f"resuming at frame {start_frame}", file=sys.stderr)

    if args.frames > 1:
        cams = camera_path(cfg.width, cfg.height)
    else:
        cam = Camera(cfg.width, cfg.height)
        cam.set_position(C.CAMERA_START_POSITION)
        cam.set_rotation(C.CAMERA_START_ROTATION)
        cams = iter([cam])

    timer = FrameTimer()
    fb = None

    def finish(idx, cam, fb_, stats):
        if args.check_finite:
            check_finite(fb_, f"frame {idx}")
        if args.checkpoint:
            save_state(args.checkpoint, cfg, cam, idx + 1)
        if args.metrics:
            print(f"frame {idx}: {stats.frame_ms:.1f}ms "
                  f"{stats.mrays_per_s:.2f} Mrays/s", file=sys.stderr)

    def traced_tables():
        held = getattr(renderer, "graphs", None)
        return held.tables().values() if held is not None else ()

    with profile(args.profile_dir, args.device, traced_tables):
        if pipeline:
            sched = runtime.FrameScheduler(inflight=3)
            in_flight_cams = {}

            def retire(idx, out):
                nonlocal fb
                idx += start_frame
                fb, rays_arr = out
                stats = timer.end(int(np.asarray(rays_arr).sum()))
                timer.begin()
                if args.raster:
                    fb = fps_overlay(fb, stats.fps)
                finish(idx, in_flight_cams.pop(idx), fb, stats)

            timer.begin()
            for i in range(args.frames):
                try:
                    cam = next(cams)
                except StopIteration:
                    break
                if i < start_frame:
                    continue  # fast-forward a resumed fly-through
                in_flight_cams[i] = cam
                retired = sched.submit(renderer.render_async, cam)
                if retired is not None:
                    retire(*retired)
            for retired in sched.drain():
                retire(*retired)
        else:
            for i in range(args.frames):
                try:
                    cam = next(cams)
                except StopIteration:
                    break
                if i < start_frame:
                    continue  # fast-forward a resumed fly-through
                timer.begin()
                if args.raster:
                    fb = renderer.render(cam)
                    rays = cfg.num_pixels * args.msaa
                else:
                    fb, rays = renderer.render(cam)
                finish(i, cam, fb, timer.end(rays))

    if args.output and fb is not None:
        if args.output.endswith(".npy"):
            framebuffer.write_npy(args.output, fb)
        else:
            framebuffer.write_png(args.output, fb)
        print(f"wrote {args.output}", file=sys.stderr)

    if args.metrics:
        print(json.dumps(timer.summary()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
