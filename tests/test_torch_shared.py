"""The port's own copies of the JAX package's numpy modules vs the
originals, on the same inputs.

vkrt_tpu_torch carries config, scene (model, synth, gltf, flatten,
textures), utils (mathutils, log), app (camera, flythrough, framebuffer,
overlay), golden (cpu_tracer, raster_oracle) and version so that it
imports nothing of vkrt_tpu. These are numpy code run the same way on both
sides, so every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from vkrt_tpu import config as JC
from vkrt_tpu.app import camera as jcam
from vkrt_tpu.app import flythrough as jfly
from vkrt_tpu.app import framebuffer as jfb
from vkrt_tpu.golden import cpu_tracer as jgold
from vkrt_tpu.golden import raster_oracle as jraster
from vkrt_tpu.scene import flatten as jflat
from vkrt_tpu.scene import synth as jsynth
from vkrt_tpu.scene import textures as jtex
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.app import camera as tcam
from vkrt_tpu_torch.app import flythrough as tfly
from vkrt_tpu_torch.app import framebuffer as tfb
from vkrt_tpu_torch.golden import cpu_tracer as tgold
from vkrt_tpu_torch.golden import raster_oracle as traster
from vkrt_tpu_torch.scene import flatten as tflat
from vkrt_tpu_torch.scene import synth as tsynth
from vkrt_tpu_torch.scene import textures as ttex
from vkrt_tpu_torch.scene.procedural import procedural_model
from test_torch_native import jax_native
import torch_support  # noqa: F401

CONSTANTS = ("LIGHT_POSITIONS", "LIGHT_INTENSITY", "SHADOW_MULTIPLIER",
             "AMBIENT", "SKY_COLOR", "METALLIC_THRESHOLD", "REFLECT_SCALE",
             "RAY_TMIN", "RAY_TMAX", "SCENE_SCALE", "CAMERA_START_POSITION",
             "CAMERA_START_ROTATION", "TRANSLATION_SPEED", "ROTATION_SPEED",
             "REF_WIDTH", "REF_HEIGHT")


def port_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(TC.RenderConfig)}


def assert_same_arrays(a, b):
    """Every field of two dataclasses equal, arrays bit for bit."""
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k


@pytest.fixture(scope="module")
def small():
    return procedural_model("small", seed=0)


@pytest.mark.parametrize("name", CONSTANTS)
def test_config_constants_equal(name):
    np.testing.assert_array_equal(np.asarray(getattr(TC, name)),
                                  np.asarray(getattr(JC, name)))


def test_version_equal():
    import vkrt_tpu_torch
    from vkrt_tpu.version import __version__ as jax_version
    from vkrt_tpu_torch.version import __version__

    assert __version__ == vkrt_tpu_torch.__version__ == jax_version


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_baseline_configs_equal(n):
    """Every field of the port's RenderConfig has the JAX value; the JAX
    config has one more field, the dead `ray_block`."""
    got, want = TC.BASELINE_CONFIGS[n](), JC.BASELINE_CONFIGS[n]()
    assert port_fields(got) == port_fields(want)
    extra = ({f.name for f in dataclasses.fields(JC.RenderConfig)}
             - set(port_fields(got)))
    assert extra == {"ray_block"}
    assert port_fields(TC.reference_config()) == port_fields(
        JC.reference_config())


def test_flatten_model_equal(small):
    assert_same_arrays(tflat.flatten_model(small),
                       jflat.flatten_model(small))


def test_material_slots_and_heap_equal(small):
    flat = tflat.flatten_model(small)
    t_triples, t_slot = ttex.material_slots(flat)
    j_triples, j_slot = jtex.material_slots(flat)
    np.testing.assert_array_equal(t_triples, j_triples)
    np.testing.assert_array_equal(t_slot, j_slot)
    assert_same_arrays(ttex.build_material_heap(small.images, t_triples),
                       jtex.build_material_heap(small.images, j_triples))
    assert_same_arrays(ttex.build_texture_heap(small.images),
                       jtex.build_texture_heap(small.images))


def test_synthesized_primitives_equal():
    """The glTF loader's stand-in geometry (synth.py) from one accessor
    table: identical submeshes."""
    gltf = {"accessors": [
        {"count": 300, "min": [-1.0, 0.0, -2.0], "max": [1.0, 3.0, 2.0]},
        {"count": 3 * 500},
        {"count": 90, "min": [0.0, 0.0, 0.0], "max": [5.0, 0.1, 4.0]},
        {"count": 3 * 160}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "TANGENT": 0}, "indices": 1,
             "material": 2},
            {"attributes": {"POSITION": 2}, "indices": 3}]}]}
    got = tsynth.synthesize_primitives(gltf)
    want = jsynth.synthesize_primitives(gltf)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same_arrays(g, w)


def test_camera_matrices_and_path_equal():
    for w, h in ((64, 48), (1600, 1200)):
        t, j = tcam.Camera(w, h), jcam.Camera(w, h)
        for c in (t, j):
            c.set_position(TC.CAMERA_START_POSITION)
            c.set_rotation(TC.CAMERA_START_ROTATION)
            c.translate([0.3, -0.2, 0.1])
            c.rotate([0.0, 1.0, 0.0], 0.25)
        for attr in ("view_matrix", "projection_matrix", "view_inverse",
                     "proj_inverse", "position", "rotation"):
            np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr),
                                          err_msg=attr)
    tp = list(tfly.camera_path(1920, 1080))
    jp = list(jfly.camera_path(1920, 1080))
    assert len(tp) == len(jp) == 240
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(t.view_inverse, j.view_inverse)
        np.testing.assert_array_equal(t.proj_inverse, j.proj_inverse)


def test_framebuffer_helpers_equal(rng):
    a = rng.uniform(-0.2, 1.2, (16, 24, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.01, a.shape).astype(np.float32)
    np.testing.assert_array_equal(tfb.to_unorm8(a), jfb.to_unorm8(a))
    assert tfb.rmse(a, b) == jfb.rmse(a, b)


def test_golden_brute_render_equal(small):
    """render_golden(accel="brute") at 32x16, config 4: the same frame;
    and accel="native" (each package's copy of the C++ tracer) too."""
    flat = tflat.flatten_model(small)
    heap = ttex.build_texture_heap(small.images)
    cam = tcam.Camera(32, 16)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    tcfg = dataclasses.replace(TC.config4_flythrough(), width=32, height=16)
    jcfg = dataclasses.replace(JC.config4_flythrough(), width=32, height=16)
    got = tgold.render_golden(flat, heap, cam.proj_inverse, cam.view_inverse,
                              tcfg, accel="brute")
    want = jgold.render_golden(flat, heap, cam.proj_inverse,
                               cam.view_inverse, jcfg, accel="brute")
    assert got.shape == (16, 32, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    got = tgold.render_golden(flat, heap, cam.proj_inverse, cam.view_inverse,
                              tcfg, accel="native")
    jax_native()                     # its library built whole, first
    want = jgold.render_golden(flat, heap, cam.proj_inverse,
                               cam.view_inverse, jcfg, accel="native")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("msaa", [1, 8])
def test_golden_raster_equal(small, msaa):
    """render_golden_raster at 32x24 from the start pose: the same frame
    (the oracle the port's raster frames are held against)."""
    flat = tflat.flatten_model(small)
    heap = ttex.build_texture_heap(small.images)
    cam = tcam.Camera(32, 24)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    tcfg = dataclasses.replace(TC.reference_config(), width=32, height=24)
    jcfg = dataclasses.replace(JC.reference_config(), width=32, height=24)
    got = traster.render_golden_raster(flat, heap, cam.proj_inverse,
                                       cam.view_inverse, tcfg, msaa=msaa)
    want = jraster.render_golden_raster(flat, heap, cam.proj_inverse,
                                        cam.view_inverse, jcfg, msaa=msaa)
    assert got.shape == (24, 32, 3) and np.isfinite(got).all()
    assert got.std() > 0.01
    np.testing.assert_array_equal(got, want)
