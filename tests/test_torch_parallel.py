"""Multi-device rendering of vkrt_tpu_torch (parallel/mesh.py) on the CPU.

The port splits a frame over a device list; here the list repeats the
CPU device k times (logical shards), the counterpart of the virtual
8-device CPU mesh that tests/conftest.py gives JAX. At 64x48 a frame has
24 rows of 128 rays, so k = 1 and 3 need no padding, k = 5 pads 16 rows
and k = 8 leaves shards 6 and 7 with padding only.

Bars: a sharded port frame equals the unsharded port frame bit for bit
(torch.equal on the f32 frame and the ray grid: no ray's result depends
on its shard, mesh.py's docstring says why); against the JAX package's
shard_map frames the bars of tests/test_torch_engine.py (RMSE <= 1e-3,
equal ray sums) and tests/test_torch_raster_edge.py (the flip gate).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as JC
from vkrt_tpu.app.framebuffer import rmse
from vkrt_tpu.parallel import mesh as jmesh
from vkrt_tpu.scene import flatten_model
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.app import cli
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.parallel import mesh as tmesh
from vkrt_tpu_torch.parallel.dryrun import dryrun_multichip
from vkrt_tpu_torch.raster.pipeline import (Rasterizer,
                                            render_raster_frame_edge)
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

W, H = 64, 48
SHARDS = [1, 3, 5, 8]
RMSE_BAR = 1e-3
FLIP, FLIP_SHARE = 0.02, 0.01          # tests/test_torch_raster_edge.py
REORDER_OFF = dict(consolidate_secondary=False, group_sort_shadows=False,
                   partition_shadows=False)
VARIANTS = {"defaults": ({}, "dense"), "flags_off": (REORDER_OFF, "dense"),
            "reference": ({}, "reference")}


def start_camera(w=W, h=H):
    cam = Camera(w, h)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    return cam


def cpu_mesh(k):
    return tmesh.make_mesh(["cpu"] * k)


@pytest.fixture(scope="module")
def scene():
    model = procedural_model("small", seed=0)
    cfg = dataclasses.replace(TC.config4_flythrough(), width=W, height=H)
    r = te.Renderer(model, cfg, "cpu")
    backends = {"dense": r.backend,
                "reference": te.make_backend(r.flat, "reference", "cpu")}
    cam = start_camera()
    mats = (torch.from_numpy(cam.proj_inverse),
            torch.from_numpy(cam.view_inverse))
    return r, backends, cam, mats


def variant(scene, name):
    r, backends, _, _ = scene
    flags, kind = VARIANTS[name]
    return backends[kind], dataclasses.replace(r.cfg, **flags)


@pytest.fixture(scope="module")
def unsharded(scene):
    r, _, _, mats = scene
    return {name: te.render_frame(variant(scene, name)[0], r.tex, *mats,
                                  r.lights, variant(scene, name)[1])
            for name in VARIANTS}


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("k", SHARDS)
def test_sharded_frame_equals_unsharded(scene, unsharded, k, name):
    r, _, _, mats = scene
    backend, cfg = variant(scene, name)
    fb, rays = tmesh.render_frame_sharded(backend, r.tex, *mats, r.lights,
                                          cfg, cpu_mesh(k))
    want_fb, want_rays = unsharded[name]
    assert fb.shape == (H, W, 3) and rays.shape == (W * H // 128, 128)
    assert torch.equal(fb, want_fb)
    assert torch.equal(rays, want_rays)


@pytest.mark.parametrize("k", SHARDS)
def test_sharded_raster_equals_unsharded(scene, k):
    r, _, cam, _ = scene
    view, proj = (torch.from_numpy(m) for m in (cam.view_matrix,
                                                 cam.projection_matrix))
    want = render_raster_frame_edge(r.backend.tree, r.tex, view, proj, r.cfg,
                                    msaa=8)
    got = tmesh.render_raster_frame_sharded(r.backend.tree, r.tex, view,
                                            proj, r.cfg, cpu_mesh(k), msaa=8)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jax_scene():
    model = procedural_model("small", seed=0)
    flat = flatten_model(model)
    mesh = jmesh.make_mesh()
    assert mesh.devices.size == 8, "conftest should provide 8 CPU devices"
    return flat, je.texture_arrays(model.images, flat), mesh


@pytest.mark.parametrize("kind", ["reference", "dense"])
def test_sharded_frame_matches_jax_sharded(scene, jax_scene, kind):
    """JAX's shard_map frame (dense: Pallas in interpret mode) on its
    8-device CPU mesh against the port's frame on 8 CPU shards."""
    r, _, cam, mats = scene
    flat, jtex, mesh = jax_scene
    jcfg = dataclasses.replace(JC.config4_flythrough(), width=W, height=H)
    render = jax.jit(functools.partial(
        jmesh.render_frame_sharded, cfg=jcfg, mesh=mesh,
        interpret=kind == "dense"))
    want_fb, want_rays = render(
        je.make_backend(flat, kind), jtex, jnp.asarray(cam.proj_inverse),
        jnp.asarray(cam.view_inverse), jnp.asarray(JC.LIGHT_POSITIONS))
    backend, cfg = variant(scene, "defaults" if kind == "dense" else kind)
    fb, rays = tmesh.render_frame_sharded(backend, r.tex, *mats, r.lights,
                                          cfg, cpu_mesh(8))
    assert np.isfinite(fb.numpy()).all()
    assert rmse(fb.numpy(), np.asarray(want_fb)) <= RMSE_BAR
    assert int(rays.sum()) == int(np.asarray(want_rays).sum())


def test_sharded_raster_matches_jax_sharded(jax_scene):
    """The edge raster frame at 64x32, MSAA 1: JAX's shard_map (kernel G
    in interpret mode) against the port's, both over 8 shards."""
    flat, jtex, mesh = jax_scene
    w, h = 64, 32
    cam = start_camera(w, h)
    jcfg = dataclasses.replace(JC.reference_config(), width=w, height=h)
    want = np.asarray(jax.jit(functools.partial(
        jmesh.render_raster_frame_sharded, cfg=jcfg, mesh=mesh, msaa=1,
        interpret=True))(je.make_backend(flat, "dense").tree, jtex,
                         jnp.asarray(cam.view_matrix),
                         jnp.asarray(cam.projection_matrix)))
    model = procedural_model("small", seed=0)
    tcfg = dataclasses.replace(TC.reference_config(), width=w, height=h)
    rast = Rasterizer(model, tcfg, "cpu", msaa=1)
    fb = tmesh.render_raster_frame_sharded(
        rast.backend.tree, rast.tex, torch.from_numpy(cam.view_matrix),
        torch.from_numpy(cam.projection_matrix), tcfg, cpu_mesh(8)).numpy()
    assert fb.shape == (h, w, 3) and np.isfinite(fb).all()
    d = np.abs(fb - want).max(axis=-1)
    flipped = d > FLIP
    assert flipped.mean() <= FLIP_SHARE and d[~flipped].max() <= FLIP


def test_make_mesh(monkeypatch):
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.axis == "rays"
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="empty"):
        tmesh.make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmesh.make_mesh()


def test_replicate_keeps_one_copy_per_device(scene):
    """A device listed k times holds one copy; on the device where the
    scene lies `.to` returns the same tensors (no copy at all)."""
    r, backends, _, _ = scene
    scene_parts = (backends["reference"], r.tex, r.lights)
    reps = tmesh.replicate(scene_parts, cpu_mesh(4))
    assert list(reps) == [torch.device("cpu")]
    be, tex, lights = reps[torch.device("cpu")]
    assert type(be) is type(backends["reference"]) and type(be.bvh) is \
        type(backends["reference"].bvh)
    assert be.bvh.boxes is backends["reference"].bvh.boxes
    assert tex.texels_tri is r.tex.texels_tri and lights is r.lights


@pytest.mark.parametrize("nb, n, per, pad", [
    (24, 1, 24, 0), (24, 3, 8, 0), (24, 5, 8, 16), (24, 8, 4, 8),
    (16320, 1, 16320, 0), (16320, 2, 8160, 0), (16320, 4, 4080, 0),
    (16320, 7, 2332, 4)])
def test_shard_blocks(nb, n, per, pad):
    """Whole 512-ray blocks (4 rows) per shard, the fewest that hold all
    rows (1080p: 16,320 rows; 7 shards leave a 4-row pad)."""
    assert tmesh.shard_blocks(nb, n) == (per, pad)
    assert per % tmesh.ROWS_PER_BLOCK == 0 and per * n == nb + pad
    assert pad < n * tmesh.ROWS_PER_BLOCK


def test_dryrun_multichip_on_cpu(capsys):
    out = dryrun_multichip(8, "cpu")
    assert list(out) == ["reference backend", "dense backend",
                         "dense, reorder flags off",
                         "dense, resort_secondary",
                         "dense, recheck_secondary",
                         "dense, partition_closest", "dense, refit tree",
                         "dense, device-SAH rebuild", "edge raster"]
    assert all(n >= W * H for n in list(out.values())[:-1])
    assert capsys.readouterr().out.count("sharded == unsharded") == 9


SMALL = ["--config", "4", "--width", str(W), "--height", str(H)]


def test_cli_shard_on_cpu_equals_unsharded(scene, tmp_path):
    """--shard 3 --device cpu: the last frame of a 2-frame fly-through
    equals the unsharded CLI's, f32 bit for bit."""
    r = scene[0]
    out = {}
    for name, extra in (("one", []), ("sharded", ["--shard", "3"])):
        out[name] = tmp_path / f"{name}.npy"
        assert cli.main(SMALL + extra + ["--device", "cpu", "--frames", "2",
                                         "--output", str(out[name])],
                        scene=r.model) == 0
    np.testing.assert_array_equal(np.load(out["sharded"]), np.load(out["one"]))


def test_cli_raster_shard_on_cpu(scene, tmp_path):
    """--raster --shard 2 --device cpu equals Rasterizer.render_async of
    the start camera (the sharded raster path draws no FPS overlay, as in
    the JAX CLI)."""
    r = scene[0]
    out = tmp_path / "raster.npy"
    assert cli.main(["--raster", "--msaa", "1", "--width", str(W),
                     "--height", str(H), "--shard", "2", "--device", "cpu",
                     "--output", str(out)], scene=r.model) == 0
    cfg = dataclasses.replace(TC.reference_config(), width=W, height=H)
    want = Rasterizer(r.model, cfg, "cpu", msaa=1).render_async(
        start_camera()).numpy()
    np.testing.assert_array_equal(np.load(out), want)


def test_cli_shard_needs_the_cards(scene, monkeypatch):
    """--shard N on the card with fewer than N cards raises ValueError (the
    JAX CLI re-execs onto a virtual CPU mesh; the port never swaps the
    card for the CPU unasked), and so does a bare --shard with none."""
    r = scene[0]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--shard 2: 1 cuda"):
        cli.main(SMALL + ["--shard", "2"], scene=r.model)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="--shard: 0 cuda"):
        cli.main(SMALL + ["--shard"], scene=r.model)
    with pytest.raises(ValueError, match="--backend dense"):
        cli.main(["--raster", "--shard", "2", "--device", "cpu", "--backend",
                  "reference"], scene=r.model)
