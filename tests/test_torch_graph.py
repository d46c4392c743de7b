"""The captured frame of vkrt_tpu_torch (graphs.py) on the CPU.

A CUDA graph exists only on the card (tests/test_torch_cuda.py captures
and replays it). Here the function a graph of `Renderer.render_async`
captures, `Renderer.frame_body`, which reads only its inputs
(`frame_inputs`: the camera matrices, the transform, the Morton AABB)
beside the scene and the lights, runs eagerly on the CPU and is held
against the frame composed from the engine's functions (bit for bit)
and against the JAX engine's jitted frame (tests/test_torch_engine.py's
bars: RMSE <= 1e-3, ray counts within 0.1%). Also: the rule that decides
which frames are captured, the reading of a replay's launches from the
profiler's kernel names, and the shards' own rows of rays and pixels.
The small scene at 32x24 keeps the file to seconds.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as JC
from vkrt_tpu.app.framebuffer import rmse
from vkrt_tpu.scene import flatten_model
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import graphs
from vkrt_tpu_torch.accel.refit import refit_clusters
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.parallel.mesh import (make_mesh, render_frame_sharded,
                                          shard_blocks)
from vkrt_tpu_torch.raster import pipeline as tpipe
from vkrt_tpu_torch.raster.pipeline import Rasterizer
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

W, H = 32, 24
RMSE_BAR = 1e-3
RAY_TOL = 1e-3


def small(cfg: C.RenderConfig, **kw) -> C.RenderConfig:
    return dataclasses.replace(cfg, width=W, height=H, **kw)


def start_camera() -> Camera:
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return cam


def transform() -> np.ndarray:
    c, s = np.cos(0.1), np.sin(0.1)
    return np.array([[c, 0, s, 0.3], [0, 1, 0, -0.2], [-s, 0, c, 0.5],
                     [0, 0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def model():
    return procedural_model("small", seed=0)


def composed(r: te.Renderer, cam: Camera, tree=None):
    """The frame composed from the engine's functions, the accel update
    (if `tree`) made outside it: what render_async did before frames
    were captured."""
    backend = r.backend if tree is None else r.backend._replace(tree=tree)
    frame = te.render_frame_u8 if r.quantize else te.render_frame
    return frame(backend, r.tex, torch.from_numpy(cam.proj_inverse),
                 torch.from_numpy(cam.view_inverse), r.lights, r.cfg)


@pytest.mark.parametrize("quantize", [True, False], ids=["u8", "f32"])
def test_frame_body_equals_the_eager_frame(model, quantize):
    """Config 4: the captured function on its inputs is the composed
    frame and render_async's, bit for bit."""
    r = te.Renderer(model, small(C.config4_flythrough()), "cpu",
                    quantize=quantize)
    cam = start_camera()
    x = r.frame_inputs(cam)
    assert x.dtype == np.float32 and x.shape == (32,)
    got = r.frame_body(torch.from_numpy(x), False)
    for want in (composed(r, cam), r.render_async(cam)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == (torch.uint8 if quantize else torch.float32)


def test_frame_body_with_refit_equals_the_eager_frame(model):
    """Config 5, refit under a transform: the update inside the captured
    function (its 4x4 among the inputs) gives the frame of a refit made
    beside it, and render_async's."""
    r = te.Renderer(model, small(C.config5_stress()), "cpu")
    cam, m = start_camera(), transform()
    x = r.frame_inputs(cam, m)
    assert x.shape == (32 + 22,)
    np.testing.assert_array_equal(x[32:48], m.reshape(-1))
    got = r.frame_body(torch.from_numpy(x), True)
    want = composed(r, cam, refit_clusters(r.backend.tree,
                                           torch.from_numpy(m)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = r.render_async(cam, m)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    moved = r.render_async(cam, np.eye(4, dtype=np.float32))
    assert not torch.equal(got[0], moved[0])


def test_morton_range_is_an_input(model):
    """full_morton's AABB comes from the transform on the host: it is
    the corners of the scene's centroid box moved by the transform, and
    the other modes carry zeros there."""
    m = transform()
    for mode in te.REBUILD_MODES:
        r = te.Renderer(model, small(C.config5_stress()), "cpu",
                        rebuild=mode)
        u = r.update_inputs(m)
        lo, hi = u[16:19], u[19:22]
        if mode != "full_morton":
            assert not lo.any() and not hi.any()
            continue
        corners = r.rebuild_inputs()[2] @ m[:3, :3].T + m[:3, 3]
        np.testing.assert_allclose(lo, corners.min(axis=0), atol=1e-5)
        np.testing.assert_allclose(hi, corners.max(axis=0), atol=1e-5)


def test_frame_body_matches_jax(model):
    """The captured function at config 4's shipped defaults against the
    JAX engine's jitted u8 frame (Pallas kernels in interpret mode). The
    JAX frame is taken with the three reorder flags off: they only move
    rays, the JAX package pins its frames bit-equal either way
    (tests/test_backends.py::test_consolidate_secondary_bit_exact,
    ::test_partition_shadows_bit_exact), and without kernels C-F its
    interpret-mode compile takes 19 s here rather than 27."""
    jcfg = dataclasses.replace(JC.config4_flythrough(), width=W, height=H)
    cfg = C.RenderConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(C.RenderConfig)})
    r = te.Renderer(model, cfg, "cpu", quantize=True)
    cam = start_camera()
    fb8, rays = r.frame_body(torch.from_numpy(r.frame_inputs(cam)), False)
    flat = flatten_model(model)
    want8, want_rays = je.render_frame_u8(
        je.make_backend(flat, "dense"), je.texture_arrays(model.images, flat),
        jnp.asarray(cam.proj_inverse), jnp.asarray(cam.view_inverse),
        jnp.asarray(JC.LIGHT_POSITIONS),
        dataclasses.replace(jcfg, consolidate_secondary=False,
                            group_sort_shadows=False,
                            partition_shadows=False), interpret=True)
    want8, want_rays = np.asarray(want8), int(want_rays)
    fb8, rays = fb8.numpy(), int(rays)
    assert fb8.shape == want8.shape == (H, W, 3)
    assert rmse(fb8 / 255.0, want8 / 255.0) <= RMSE_BAR
    assert abs(rays - want_rays) <= RAY_TOL * want_rays
    assert rays > 2 * W * H


def test_graph_resolution_rule(model):
    """graph=None captures on a CUDA device only, and never a frame that
    waits on the host; graph=True raises there, naming why; False is
    eager."""
    assert graphs.resolve(None, "cuda") is True
    assert graphs.resolve(None, "cpu") is False
    assert graphs.resolve(False, "cuda") is False
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.resolve(True, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        te.Renderer(model, small(C.config4_flythrough()), "cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        Rasterizer(model, small(C.reference_config()), "cpu", msaa=1,
                   graph=True)
    r = te.Renderer(model, small(C.config4_flythrough()), "cpu")
    assert r.graph is None and not r.captured()
    assert te.host_wait(r.backend, r.cfg) == ""
    ref = te.make_backend(r.flat, "reference", "cpu")
    recheck = small(C.config4_flythrough(), recheck_secondary=True)
    for backend, cfg, why in ((ref, r.cfg, "reference backend"),
                              (r.backend, recheck, "recheck_secondary")):
        wait = te.host_wait(backend, cfg)
        assert why in wait
        assert graphs.resolve(None, "cuda", wait) is False
        with pytest.raises(ValueError, match=why):
            graphs.resolve(True, "cuda", wait)
    with pytest.raises(ValueError, match="CUDA device"):
        cam = start_camera()
        render_frame_sharded(r.backend, r.tex,
                             torch.from_numpy(cam.proj_inverse),
                             torch.from_numpy(cam.view_inverse), r.lights,
                             r.cfg, make_mesh(["cpu"] * 2), graph=True)


def test_kernel_launches_read_the_profiler_names():
    """What a replay launches is read from the profiler's device events:
    each of the port's kernels by its demangled name (any template
    arguments), PyTorch's kernels and host events ignored."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        SimpleNamespace(key="void vkrt::trace_closest_kernel<false, false, "
                            "false>(float const*, int, int)", count=4,
                        device_type=cuda),
        SimpleNamespace(key="void vkrt::trace_closest_kernel<true, false, "
                            "false>(float const*, int, int)", count=1,
                        device_type=cuda),
        SimpleNamespace(key="void vkrt::occl_multi_kernel<4, false, false, "
                            "false>(float const*)", count=4, device_type=cuda),
        SimpleNamespace(key="void vkrt::lane_unsort_kernel(float const*)",
                        count=2, device_type=cuda),
        SimpleNamespace(key="void vkrt::lane_sort_kernel(float const*)",
                        count=3, device_type=cuda),
        SimpleNamespace(key="void at::native::vectorized_gather_kernel<16, "
                            "long>(char*)", count=9, device_type=cuda),
        SimpleNamespace(key="void vkrt::raster_edge_kernel(float const*)",
                        count=7, device_type=cpu),
        SimpleNamespace(key="vkrt::raster_sample_kernel(int const*, float "
                            "const*)", count=32, device_type=cuda),
        SimpleNamespace(key="vkrt::raster_clip_kernel(float const*, "
                            "unsigned char const*)", count=1,
                        device_type=cuda),
        SimpleNamespace(key="vkrt::sample_hits_kernel(int const*, float "
                            "const*)", count=4, device_type=cuda),
        SimpleNamespace(key="vkrt::shade_interp_kernel(unsigned char "
                            "const*)", count=4, device_type=cuda),
        SimpleNamespace(key="void vkrt::shade_lights_kernel<4>(unsigned "
                            "char const*)", count=3, device_type=cuda),
        SimpleNamespace(key="void vkrt::shade_lights_kernel<1>(unsigned "
                            "char const*)", count=1, device_type=cuda),
        SimpleNamespace(key="void vkrt::shade_combine_kernel<4>(unsigned "
                            "char*)", count=4, device_type=cuda),
        SimpleNamespace(key="cudaGraphLaunch", count=2, device_type=cpu)]
    assert graphs.kernel_name(events[0].key) == "trace_closest"
    assert graphs.kernel_name(events[5].key) is None
    assert graphs.kernel_launches(events) == dict(
        trace_closest=5, trace_occluded=0, occl_multi=4, consolidate=0,
        scatter_back=0, lane_sort=3, lane_unsort=2, raster_edge=0,
        sah_cut=0, raster_sample=32, raster_clip=1, sample_hits=4,
        shade_interp=4, shade_lights=4, shade_combine=4)


@pytest.mark.parametrize("shards", [2, 5, 7])
def test_shard_rows_equal_the_frame_rows(shards):
    """A shard makes only its own lane rows (camera rays, and each MSAA
    sample's pixel lanes): the same bits as those rows of the whole
    frame's, and its padding rows past the frame never trace or cover."""
    cfg = dataclasses.replace(C.config4_flythrough(), width=100, height=37)
    cam = start_camera()
    pi, vi = (torch.from_numpy(m) for m in (cam.proj_inverse,
                                            cam.view_inverse))
    origin, dirs, valid = te.camera_ray_blocks(pi, vi, cfg)
    lanes = [tpipe.sample_pixel_lanes(cfg, off, "cpu")
             for off in tpipe.sample_offsets(8)]
    nb = valid.shape[0]
    per, pad = shard_blocks(nb, shards)
    assert (pad > 0) == (shards != 2)
    for k in range(shards):
        rows = range(k * per, (k + 1) * per)
        n = max(0, min(nb, rows.stop) - rows.start)
        o, d, v = te.camera_ray_blocks(pi, vi, cfg, rows)
        assert torch.equal(o, origin)
        assert torch.equal(d[:, :n], dirs[:, rows.start:rows.start + n])
        assert torch.equal(v[:n], valid[rows.start:rows.start + n])
        assert not v[n:].any() and torch.isfinite(d).all()
        for off, whole in zip(tpipe.sample_offsets(8), lanes):
            part = tpipe.sample_pixel_lanes(cfg, off, "cpu", rows)
            for a, b in zip(part, whole):
                assert torch.equal(a[:n], b[rows.start:rows.start + n])
            assert not part[2][n:].any()
