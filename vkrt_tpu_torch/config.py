"""Render configuration.

The reference has no config system — everything is a compile-time constant
(SURVEY.md §5: window size src/Utils.hpp:32-33, lights src/Raytracer.cpp:26-31,
camera start src/Raytracer.cpp:267-271, recursion depth src/Raytracer.cpp:978).
Here that constant set is promoted to a real config object, parameterized for
the five BASELINE.json benchmark configs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# --- Behavioral contract constants (golden table, SURVEY.md §7) -----------

# ref: src/Raytracer.cpp:26-31
LIGHT_POSITIONS = np.array(
    [[6.0, 6.0, 0.0], [2.0, 5.0, 0.0], [-2.0, 4.0, 0.0], [-6.0, 3.0, 0.0]],
    dtype=np.float32,
)
LIGHT_INTENSITY = 10.0          # ref: shaders/shader.rchit:111
SHADOW_MULTIPLIER = 0.3         # ref: shaders/shader.rchit:147
AMBIENT = 0.1                   # ref: shaders/shader.rchit:154
SKY_COLOR = np.array([0.8, 0.8, 1.0], dtype=np.float32)  # ref: shader.rmiss:17
METALLIC_THRESHOLD = 0.1        # ref: shaders/shader.rchit:162
REFLECT_SCALE = 0.5             # ref: shaders/shader.rchit:165
RAY_TMIN = 0.001                # ref: shaders/shader.rgen:59, shader.rchit:139
RAY_TMAX = 1000.0               # ref: shaders/shader.rgen:61
SCENE_SCALE = 0.01              # TLAS instance transform, ref: src/Raytracer.cpp:1165-1169
CAMERA_START_POSITION = (6.3, 4.5, -0.7)   # ref: src/Raytracer.cpp:267-268
CAMERA_START_ROTATION = (0.0, 1.57, 0.0)   # ref: src/Raytracer.cpp:269-270
TRANSLATION_SPEED = 5.0         # units/s, ref: src/Raytracer.cpp:288
ROTATION_SPEED = 1.5            # rad/s,   ref: src/Raytracer.cpp:289
REF_WIDTH, REF_HEIGHT = 1600, 1200  # ref: src/Utils.hpp:32-33


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """One renderable configuration (a BASELINE.json config row)."""

    width: int = REF_WIDTH
    height: int = REF_HEIGHT
    max_depth: int = 2            # trace iterations: primary + (max_depth-1) bounces
    num_lights: int = 4
    enable_shadows: bool = True
    enable_reflections: bool = True
    flat_albedo: bool = False     # config 1: base color only, no lighting
    rebuild_per_frame: bool = False  # config 5: LBVH rebuilt every frame
    # BEYOND-PARITY: per-ray mip LOD from wavefront-neighbor ray
    # differentials (trilinear). The reference's RT stage has no
    # derivatives and always samples level 0 (shader.rchit texture()),
    # so this must stay off in every golden-gated config.
    mip_lod: bool = False
    # Output-neutral reorderings of the secondary wavefronts. The three
    # shipped on (depth>=1 shadows only) are run by the port's engine
    # (wavefront/engine.py::trace_shadows): pack the live rays
    # (consolidate_secondary), sort 128-lane groups by surface cell
    # (group_sort_shadows) and sort rays inside each block before the
    # group sort (partition_shadows). Frames are bit-equal with any of
    # them off. The rest default off and are refused by the port's engine
    # (ROADMAP.md queue 1 item 13).
    resort_secondary: bool = False
    recheck_secondary: bool = False
    consolidate_secondary: bool = True
    group_sort_shadows: bool = True
    partition_shadows: bool = True
    partition_closest: bool = False
    sub_gate_shadows: bool = False
    sub_gate_closest: bool = False

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


# --- The five BASELINE.json configs ---------------------------------------

def config1_primary() -> RenderConfig:
    """Sponza, primary-visibility rays only (flat albedo), 800x600."""
    return RenderConfig(width=800, height=600, max_depth=1, num_lights=0,
                        enable_shadows=False, enable_reflections=False,
                        flat_albedo=True)


def config2_shadows() -> RenderConfig:
    """Sponza + hard shadows (1 shadow ray/hit to point light), 1280x720."""
    return RenderConfig(width=1280, height=720, max_depth=1, num_lights=1,
                        enable_shadows=True, enable_reflections=False)


def config3_reflections() -> RenderConfig:
    """Sponza + single-bounce mirror reflections + shadows, 1280x720."""
    return RenderConfig(width=1280, height=720, max_depth=2, num_lights=1,
                        enable_shadows=True, enable_reflections=True)


def config4_flythrough() -> RenderConfig:
    """Interactive fly-through (240-frame camera path), full shading, 1080p."""
    return RenderConfig(width=1920, height=1080, max_depth=2, num_lights=4,
                        enable_shadows=True, enable_reflections=True)


def config5_stress() -> RenderConfig:
    """Stress: 4-bounce reflections, 4 lights, per-frame LBVH rebuild, 1080p."""
    return RenderConfig(width=1920, height=1080, max_depth=4, num_lights=4,
                        enable_shadows=True, enable_reflections=True,
                        rebuild_per_frame=True)


def reference_config() -> RenderConfig:
    """The reference's own fixed workload: 1600x1200, depth 2, 4 lights."""
    return RenderConfig()


BASELINE_CONFIGS = {
    1: config1_primary,
    2: config2_shadows,
    3: config3_reflections,
    4: config4_flythrough,
    5: config5_stress,
}
