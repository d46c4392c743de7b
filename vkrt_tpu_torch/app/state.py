"""Checkpoint and resume — counterpart of vkrt_tpu/app/state.py.

The whole state of a render (config, camera pose, frame index) as JSON,
so an interrupted fly-through resumes at the exact frame. The format is the
JAX package's: a checkpoint written by either package loads in the
other. The port's RenderConfig has no `ray_block`, so load_state drops
that one key of a JAX checkpoint; any other unknown key still raises.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.app.camera import Camera

_DROPPED = ("ray_block",)     # JAX-only RenderConfig fields


def save_state(path: str, cfg: C.RenderConfig, camera: Camera,
               frame_index: int, extra: dict | None = None) -> None:
    state = {
        "version": 1,
        "config": dataclasses.asdict(cfg),
        "camera": {
            "position": camera.position.tolist(),
            "rotation": camera.rotation.tolist(),
            "width": cfg.width,
            "height": cfg.height,
        },
        "frame_index": frame_index,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, path)      # atomic: a crash never corrupts a checkpoint


def load_state(path: str):
    """Returns (cfg, camera, frame_index, extra)."""
    with open(path) as f:
        state = json.load(f)
    if state.get("version") != 1:
        raise ValueError(f"{path}: checkpoint version "
                         f"{state.get('version')!r}, expected 1")
    fields = {k: v for k, v in state["config"].items() if k not in _DROPPED}
    cfg = C.RenderConfig(**fields)
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(np.asarray(state["camera"]["position"], np.float32))
    cam.set_rotation(np.asarray(state["camera"]["rotation"], np.float32))
    return cfg, cam, int(state["frame_index"]), state.get("extra", {})
