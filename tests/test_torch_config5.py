"""Config 5 (depth 4, 4 lights, per-frame accel update) on the CPU: the
port's Renderer vs the JAX engine.

The small procedural scene at 64x48 under a small y-rotation. The JAX
frame is `render_frame` (dense backend, Pallas in interpret mode) on
`refit_clusters(tree, m)`, rendered once per module (the slow part).
Bars: the port's refit frame within RMSE 1e-3 of it with the same ray
count; the full-rebuild frames (device SAH, Morton) within RMSE 1e-3 of
the port's refit frame (tests/test_rebuild.py's bar); the refit with the
identity bit-equal to the frame without any transform.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as C
from vkrt_tpu.accel.refit import refit_clusters as jax_refit_clusters
from vkrt_tpu.app.camera import Camera
from vkrt_tpu.app.framebuffer import rmse
from vkrt_tpu.scene import flatten_model
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te

W, H = 64, 48
RMSE_BAR = 1e-3


def rot_y(ang):
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


M = rot_y(0.05)


def config5(**kw) -> TC.RenderConfig:
    return dataclasses.replace(TC.config5_stress(), width=W, height=H, **kw)


@pytest.fixture(scope="module")
def scene():
    model = procedural_model("small", seed=0)
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return model, cam


@pytest.fixture(scope="module")
def frames(scene):
    """The port's f32 frame and ray count under M for each rebuild mode."""
    model, cam = scene
    out = {}
    for mode in te.REBUILD_MODES:
        r = te.Renderer(model, config5(), "cpu", rebuild=mode)
        out[mode] = r.render(cam, transform=M)
    return out


def test_config5_is_depth4_four_lights_rebuild():
    cfg = TC.config5_stress()
    assert (cfg.max_depth, cfg.num_lights, cfg.rebuild_per_frame) == (4, 4,
                                                                      True)
    assert (cfg.width, cfg.height) == (1920, 1080)
    assert not hasattr(te, "check_supported")


def test_refit_frame_matches_jax(scene, frames):
    model, cam = scene
    flat = flatten_model(model)
    be = je.make_backend(flat, "dense")
    be = be._replace(tree=jax_refit_clusters(be.tree, jnp.asarray(M)))
    cfg = dataclasses.replace(C.config5_stress(), width=W, height=H)
    want, want_rays = je.render_frame(
        be, je.texture_arrays(model.images, flat),
        jnp.asarray(cam.proj_inverse), jnp.asarray(cam.view_inverse),
        jnp.asarray(C.LIGHT_POSITIONS), cfg, interpret=True)
    fb, rays = frames["refit"]
    assert fb.shape == (H, W, 3) and np.isfinite(fb).all()
    assert rmse(fb, np.asarray(want)) <= RMSE_BAR
    assert rays == int(np.asarray(want_rays).sum())
    # all four depths ran: more rays than depth 2 traces
    r2 = te.Renderer(model, config5(max_depth=2), "cpu")
    assert rays > r2.render(cam, transform=M)[1] > 2 * W * H


@pytest.mark.parametrize("mode", ["full", "full_morton"])
def test_full_rebuild_matches_refit_frame(frames, mode):
    fb, rays = frames[mode]
    want, want_rays = frames["refit"]
    assert np.isfinite(fb).all()
    assert rmse(fb, want) <= RMSE_BAR
    assert abs(rays - want_rays) <= 1e-3 * want_rays


def test_transform_moves_the_frame(scene, frames):
    model, cam = scene
    still, _ = te.Renderer(model, config5(), "cpu").render(cam)
    assert rmse(frames["refit"][0], still) > 10 * RMSE_BAR


@pytest.mark.parametrize("mode", te.REBUILD_MODES)
def test_identity_update_is_bit_equal_to_no_update(scene, mode):
    """rebuild_per_frame with no transform refits (or rebuilds) with the
    identity. The refit keeps the tree, so its frame is bit-equal to the
    frame of a renderer that never updates; a full rebuild re-orders the
    triangles, so its frame is held to the RMSE bar."""
    model, cam = scene
    want, want_rays = te.Renderer(
        model, config5(rebuild_per_frame=False), "cpu").render(cam)
    r = te.Renderer(model, config5(), "cpu", rebuild=mode)
    for fb, rays in (r.render(cam), r.render(cam, transform=np.eye(4))):
        if mode == "refit":
            np.testing.assert_array_equal(fb, want)
            assert rays == want_rays
        else:
            assert rmse(fb, want) <= RMSE_BAR


def test_update_tree_follows_the_rebuild_mode(scene):
    """`update_tree` returns a new tree on the renderer's device and
    leaves the renderer's own untouched; "refit" keeps the triangle
    order, the full rebuilds change it."""
    model, _ = scene
    for mode in te.REBUILD_MODES:
        r = te.Renderer(model, config5(), "cpu", rebuild=mode)
        before = [x.clone() for x in r.backend.tree]
        tree = r.update_tree(M)
        assert all(torch.equal(a, b) for a, b in zip(before, r.backend.tree))
        assert tree.tri_data.shape == r.backend.tree.tri_data.shape
        same_order = torch.equal(tree.leaf_tri, r.backend.tree.leaf_tri)
        assert same_order == (mode == "refit")
        assert not torch.equal(tree.cl_boxes, r.backend.tree.cl_boxes)


def test_renderer_rejects_unknown_rebuild_and_unported_sah_opts(scene):
    """An unknown rebuild mode raises; every device-SAH option renders
    (the ablation modes were unported when this test was named): a full
    rebuild with sah_opts permutes the same triangles, and its frame
    stays within RMSE_BAR of the default full rebuild's."""
    model, cam = scene
    with pytest.raises(ValueError, match="rebuild"):
        te.Renderer(model, config5(), "cpu", rebuild="lbvh")
    base = te.Renderer(model, config5(), "cpu", rebuild="full")
    want = base.render(cam, transform=M)[0]
    for opts in (dict(axis_mode="extent"), dict(max_levels=6),
                 dict(axis_mode="slab", cuts=2, stable=False)):
        r = te.Renderer(model, config5(), "cpu", rebuild="full",
                        sah_opts=opts)
        fb = r.render(cam, transform=M)[0]
        assert np.isfinite(fb).all() and rmse(fb, want) <= RMSE_BAR
        leaf = r.update_tree(M).leaf_tri
        assert torch.equal(leaf.sort().values,
                           base.update_tree(M).leaf_tri.sort().values)
