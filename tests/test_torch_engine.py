"""The vkrt_tpu_torch frame engine vs the JAX engine (whole slice, CPU).

The small procedural scene at 64x48, every config at RenderConfig's
shipped defaults (the depth>=1 shadow reorder on). Config 4 is held
against the JAX dense backend with its Pallas kernels in interpret mode
(equal ray counts), configs 1-3 against the JAX reference (LBVH) backend.
Bars: frame RMSE <= 1e-3 (BASELINE.json) and traced-ray counts within
0.1%. The JAX dense frames are rendered once per module (~15 s each
here). The reorder flags only move rays, so the port's frames must be
bit-equal across all of their combinations.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as C
from vkrt_tpu.app.camera import Camera
from vkrt_tpu.app.framebuffer import rmse
from vkrt_tpu.scene import flatten_model
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te

W, H = 64, 48
RMSE_BAR = 1e-3
RAY_TOL = 1e-3


REORDER_FLAGS = ("consolidate_secondary", "group_sort_shadows",
                 "partition_shadows")


def config(n: int, width: int = W, height: int = H) -> C.RenderConfig:
    return dataclasses.replace(C.BASELINE_CONFIGS[n](), width=width,
                               height=height)


def reorder(cfg: C.RenderConfig, on) -> C.RenderConfig:
    return dataclasses.replace(cfg, **dict(zip(REORDER_FLAGS, on)))


def port_config(cfg: C.RenderConfig) -> TC.RenderConfig:
    """The port's RenderConfig with the same values as a JAX one (the
    port's has no `ray_block`)."""
    return TC.RenderConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(TC.RenderConfig)})


@pytest.fixture(scope="module")
def scene():
    model = procedural_model("small", seed=0)
    flat = flatten_model(model)
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    jtex = je.texture_arrays(model.images, flat)
    jargs = (jnp.asarray(cam.proj_inverse), jnp.asarray(cam.view_inverse),
             jnp.asarray(C.LIGHT_POSITIONS))
    return model, flat, cam, jtex, jargs


@pytest.fixture(scope="module")
def jax_dense_frames(scene):
    """JAX dense backend (Pallas interpret) at config 4's shipped
    defaults: the f32 frame with its ray grid, and the u8 frame with its
    ray sum."""
    _, flat, _, jtex, jargs = scene
    be = je.make_backend(flat, "dense")
    fb, rays = je.render_frame(be, jtex, *jargs, config(4), interpret=True)
    fb8, rsum = je.render_frame_u8(be, jtex, *jargs, config(4),
                                   interpret=True)
    return (np.asarray(fb), int(np.asarray(rays).sum()),
            np.asarray(fb8), int(rsum))


def port_frame(scene, cfg, quantize=False, cam=None):
    model, _, start, _, _ = scene
    r = te.Renderer(model, port_config(cfg), "cpu", quantize=quantize)
    fb, rays = r.render_async(cam or start)
    return fb.numpy(), int(rays.sum())


@pytest.fixture(scope="module")
def port_frame_flags_off(scene):
    return port_frame(scene, reorder(config(4), (False,) * 3))


def assert_rays_close(got, want):
    assert abs(got - want) <= RAY_TOL * want, (got, want)


def test_config4_matches_jax_dense(scene, jax_dense_frames):
    fb, rays = port_frame(scene, config(4))
    want_fb, want_rays, _, _ = jax_dense_frames
    assert fb.shape == (H, W, 3) and np.isfinite(fb).all()
    assert rmse(fb, want_fb) <= RMSE_BAR
    assert rays == want_rays
    # reflections and shadows ran: more rays than pixels + one light each
    assert rays > 2 * W * H


def test_config4_u8_matches_jax_dense(scene, jax_dense_frames):
    fb8, rays = port_frame(scene, config(4), quantize=True)
    _, _, want8, want_rays = jax_dense_frames
    assert fb8.dtype == np.uint8 and fb8.shape == (H, W, 3)
    assert rmse(fb8 / 255.0, want8 / 255.0) <= RMSE_BAR
    assert (np.abs(fb8.astype(int) - want8.astype(int)) <= 1).mean() > 0.999
    assert_rays_close(rays, want_rays)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_configs_1_to_3_match_jax_reference(scene, n):
    _, flat, _, jtex, jargs = scene
    be = je.make_backend(flat, "reference")
    want_fb, want_rays = je.render_frame(be, jtex, *jargs, config(n))
    fb, rays = port_frame(scene, config(n))
    assert rmse(fb, np.asarray(want_fb)) <= RMSE_BAR
    assert_rays_close(rays, int(np.asarray(want_rays).sum()))


def test_tile_and_camera_rays_match_jax(scene, rng):
    _, _, cam, _, _ = scene
    img = rng.normal(size=(H, W)).astype(np.float32)
    tiled = te.tile(torch.from_numpy(img))
    np.testing.assert_array_equal(tiled.numpy(),
                                  np.asarray(je.tile(jnp.asarray(img))))
    np.testing.assert_array_equal(te.untile(tiled, H, W).numpy(), img)
    cfg = dataclasses.replace(config(4), width=50, height=40)   # padded
    jo, jd, jv = je.camera_ray_blocks(jnp.asarray(cam.proj_inverse),
                                      jnp.asarray(cam.view_inverse), cfg)
    to, td, tv = te.camera_ray_blocks(torch.from_numpy(cam.proj_inverse),
                                      torch.from_numpy(cam.view_inverse), cfg)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("on", list(itertools.product([False, True],
                                                      repeat=3)),
                         ids=lambda on: "".join("01"[b] for b in on))
def test_reorder_flags_give_identical_frames(scene, port_frame_flags_off, on):
    """Any combination of consolidate_secondary, group_sort_shadows and
    partition_shadows renders the flags-off frame bit for bit (the JAX
    package's test_backends.py contract)."""
    fb, rays = port_frame(scene, reorder(config(4), on))
    want, want_rays = port_frame_flags_off
    np.testing.assert_array_equal(fb, want)
    assert rays == want_rays


def test_capped_partition_is_bit_exact(scene):
    """At 128x96 the packed depth-1 wavefront has 12 blocks of 1024, so
    the lane sort covers only its first quarter (the `capr` cap) and the
    rows beyond pass through; the frame still equals the unpartitioned
    one bit for bit."""
    model = scene[0]
    cam = Camera(128, 96)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    cfg = config(4, 128, 96)
    nb = 128 * 96 // 128
    rpb = te.OCCL_BLOCK // 128
    assert te._occl_block(nb * 128) == te.OCCL_BLOCK and nb // rpb >= 8
    fb, rays = port_frame(scene, cfg, cam=cam)
    want, want_rays = port_frame(
        scene, dataclasses.replace(cfg, partition_shadows=False), cam=cam)
    np.testing.assert_array_equal(fb, want)
    assert rays == want_rays
    assert fb.shape == (96, 128, 3) and np.isfinite(fb).all()


def test_shipped_defaults_accepted_and_unported_flags_raise(scene):
    """Every field of the JAX package's RenderConfig but the dead
    `ray_block` is a field of the port's, and a Renderer takes each of
    them switched from its default (a render is not needed here:
    tests/test_torch_secondary.py renders the five secondary-dispatch
    options). The name is kept from when five flags raised."""
    model = scene[0]
    names = {f.name for f in dataclasses.fields(C.RenderConfig)} - {
        "ray_block"}
    assert names == {f.name for f in dataclasses.fields(TC.RenderConfig)}
    base = port_config(config(4))
    for f in dataclasses.fields(TC.RenderConfig):
        if f.type in (bool, "bool"):
            cfg = dataclasses.replace(base, **{f.name: not getattr(base,
                                                                   f.name)})
            te.Renderer(model, cfg, "cpu")
    assert not hasattr(te, "check_supported")
    assert not hasattr(te, "_UNPORTED_FLAGS")


def test_unported_backend_raises(scene):
    """Both backends are ported; an unknown kind raises."""
    flat = scene[1]
    with pytest.raises(ValueError, match="backend 'bvh4'"):
        te.make_backend(flat, "bvh4", "cpu")
