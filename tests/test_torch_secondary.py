"""The five secondary-dispatch options of RenderConfig on the port (CPU):
resort_secondary, recheck_secondary, partition_closest, sub_gate_closest
and sub_gate_shadows, each alone and in the two combinations that
chip_smoke.py phase 24 runs.

The small procedural scene at 64x48, config 4 and config 5 (refit under
a y-rotation). Every option leaves the frame as it is: each frame and
its ray grid are torch.equal to the port's default frame (kernel A's tie
rule makes the nearest hit independent of the ray order, masks are
any-hits, and the kernel modes only skip work). Against the JAX engine
with the same fields (dense backend, Pallas in interpret mode, ~15 s a
frame here, so three frames): RMSE <= 1e-3 and equal ray counts, the
bars of tests/test_torch_engine.py (each of the five fields is on in
one of them). A frame sharded over ["cpu"] * 3 with partition_closest
equals the unsharded one; the reference backend takes resort_secondary
and ignores the kernel modes, as in the JAX package.
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
from vkrt_tpu_torch.parallel.mesh import make_mesh, render_frame_sharded
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

W, H = 64, 48
RMSE_BAR = 1e-3
CASES = {
    "resort_secondary": dict(resort_secondary=True),
    "recheck_secondary": dict(recheck_secondary=True),
    "partition_closest": dict(partition_closest=True),
    "sub_gate_closest": dict(sub_gate_closest=True),
    "sub_gate_shadows": dict(sub_gate_shadows=True),
    "resort+recheck+sub_gate": dict(resort_secondary=True,
                                    recheck_secondary=True,
                                    sub_gate_closest=True,
                                    sub_gate_shadows=True),
    "partition_closest+sub_gate": dict(partition_closest=True,
                                       sub_gate_closest=True,
                                       sub_gate_shadows=True),
}


def rot_y(ang):
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


M = rot_y(0.05)
CONFIGS = {"config4": (TC.config4_flythrough, None),
           "config5": (TC.config5_stress, M)}


@pytest.fixture(scope="module")
def scene():
    model = procedural_model("small", seed=0)
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return model, cam, te.Renderer(model, TC.config4_flythrough(), "cpu")


def port_frame(scene, cfg, transform=None, backend=None):
    """(f32 frame, ray grid) of `cfg` at 64x48 on the scene's renderer
    (its tree, heap and lights), with `transform` as the accel update."""
    model, cam, base = scene
    r = te.Renderer.__new__(te.Renderer)
    r.__dict__.update(base.__dict__)
    r.cfg = dataclasses.replace(cfg, width=W, height=H)
    if backend is not None:
        r.backend = backend
    return r.render_async(cam, transform)


@pytest.fixture(scope="module")
def defaults(scene):
    return {name: port_frame(scene, make(), m)
            for name, (make, m) in CONFIGS.items()}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_option_frame_equals_default(scene, defaults, config, case):
    make, m = CONFIGS[config]
    fb, rays = port_frame(scene, dataclasses.replace(make(), **CASES[case]),
                          m)
    want_fb, want_rays = defaults[config]
    assert torch.equal(fb, want_fb)
    assert torch.equal(rays, want_rays)
    assert fb.shape == (H, W, 3) and torch.isfinite(fb).all()


def jax_config(**flags):
    return dataclasses.replace(C.config4_flythrough(), width=W, height=H,
                               **flags)


@pytest.fixture(scope="module")
def jax_scene(scene):
    model, cam, _ = scene
    flat = flatten_model(model)
    return (je.make_backend(flat, "dense"), je.texture_arrays(model.images,
                                                              flat),
            (jnp.asarray(cam.proj_inverse), jnp.asarray(cam.view_inverse),
             jnp.asarray(C.LIGHT_POSITIONS)))


@pytest.mark.parametrize("case", ["resort+recheck+sub_gate",
                                  "partition_closest+sub_gate"])
def test_option_frame_matches_jax(scene, jax_scene, case):
    """The JAX engine with the same fields (its kernels in interpret mode,
    their modes too) and the port: RMSE <= 1e-3, equal ray counts."""
    be, tex, args = jax_scene
    fb, rays = je.render_frame(be, tex, *args, jax_config(**CASES[case]),
                               interpret=True)
    got, got_rays = port_frame(
        scene, dataclasses.replace(TC.config4_flythrough(), **CASES[case]))
    assert rmse(got.numpy(), np.asarray(fb)) <= RMSE_BAR
    assert int(got_rays.sum()) == int(np.asarray(rays).sum())


def test_config5_recheck_matches_jax_refit(scene):
    """Config 5's depth-4 frame with recheck and both sub-run gates on a
    refit tree, against the JAX engine on its refit tree (interpret)."""
    model, _, _ = scene
    flat = flatten_model(model)
    be = je.make_backend(flat, "dense")
    be = be._replace(tree=jax_refit_clusters(be.tree, jnp.asarray(M)))
    cam = scene[1]
    flags = dict(recheck_secondary=True, sub_gate_closest=True,
                 sub_gate_shadows=True)
    cfg = dataclasses.replace(C.config5_stress(), width=W, height=H, **flags)
    fb, rays = je.render_frame(be, je.texture_arrays(model.images, flat),
                               jnp.asarray(cam.proj_inverse),
                               jnp.asarray(cam.view_inverse),
                               jnp.asarray(C.LIGHT_POSITIONS), cfg,
                               interpret=True)
    got, got_rays = port_frame(
        scene, dataclasses.replace(TC.config5_stress(), **flags), M)
    assert rmse(got.numpy(), np.asarray(fb)) <= RMSE_BAR
    assert int(got_rays.sum()) == int(np.asarray(rays).sum())


def test_sharded_partition_closest_equals_unsharded(scene, defaults):
    """render_frame_sharded on ["cpu"] * 3 with partition_closest (each
    shard sorts its own rows): the unsharded frame, bit for bit."""
    model, cam, base = scene
    cfg = dataclasses.replace(TC.config4_flythrough(), width=W, height=H,
                              partition_closest=True)
    pi = te.upload_matrix(cam.proj_inverse, base.device)
    vi = te.upload_matrix(cam.view_inverse, base.device)
    fb, rays = render_frame_sharded(base.backend, base.tex, pi, vi,
                                    base.lights, cfg, make_mesh(["cpu"] * 3))
    want_fb, want_rays = defaults["config4"]
    assert torch.equal(fb, want_fb)
    assert torch.equal(rays, want_rays)


def test_reference_backend_takes_the_options(scene):
    """The reference backend: resort_secondary reorders its rays, the
    kernel modes and partition_closest (dense only) leave it alone; the
    frame is its default frame."""
    model, _, base = scene
    ref = te.make_backend(base.flat, "reference", "cpu")
    cfg = dataclasses.replace(TC.config4_flythrough(), max_depth=2,
                              num_lights=1)
    want_fb, want_rays = port_frame(scene, cfg, backend=ref)
    flags = dict(resort_secondary=True, recheck_secondary=True,
                 partition_closest=True, sub_gate_closest=True,
                 sub_gate_shadows=True)
    fb, rays = port_frame(scene, dataclasses.replace(cfg, **flags),
                          backend=ref)
    assert torch.equal(fb, want_fb)
    assert torch.equal(rays, want_rays)
