"""Kernels A-G on the card vs their plain PyTorch versions.

Marked `cuda`: these need an NVIDIA GPU with nvcc and skip elsewhere (the
CUDA kernels have no CPU or interpret mode; their plain versions are
covered on the CPU by test_torch_trace.py, test_torch_pack.py,
test_torch_lanesort.py and test_torch_raster_edge.py). C-F move f32
values without arithmetic, so they must equal their plain versions
exactly. Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.app.framebuffer import rmse
from vkrt_tpu_torch.raster import edge
from vkrt_tpu_torch.raster.pipeline import MSAA8, Rasterizer, sample_pixel_lanes
from vkrt_tpu_torch.rt.dense import trace_dense, trace_dense_plain
from vkrt_tpu_torch.rt.occl_multi import occluded_multi, occluded_multi_plain
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import lanesort, pack
from vkrt_tpu_torch.wavefront.engine import Renderer

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda", 0)


def small_config(**flags) -> C.RenderConfig:
    return dataclasses.replace(C.config4_flythrough(), width=64, height=48,
                               **flags)


FLAGS_OFF = dict(consolidate_secondary=False, group_sort_shadows=False,
                 partition_shadows=False)


@pytest.fixture(scope="module")
def renderer(card):
    return Renderer(procedural_model("small", seed=0),
                    small_config(**FLAGS_OFF), card)


def start_camera():
    cam = Camera(64, 48)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return cam


def random_rays(card, n=4096, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-17, -1, -10], [17, 13, 11], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.2, 0.0, C.RAY_TMAX).astype(np.float32)
    cv = lambda x: torch.as_tensor(np.moveaxis(x.reshape(-1, 128, 3), -1, 0)
                                   .copy(), device=card)
    return cv(o), cv(d), torch.as_tensor(tmax.reshape(-1, 128), device=card)


def test_kernel_a_matches_plain(renderer, card):
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card)
    before = trace_dense.launches
    got = trace_dense(tree, o, d, tmax)
    want = trace_dense_plain(tree, o, d, tmax)
    torch.cuda.synchronize()
    assert trace_dense.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_b_matches_plain(renderer, card):
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, seed=2)
    lights = renderer.lights
    st = torch.stack([tmax * 0.01] * len(lights))
    st[:, 0, :8] = 0.0009                     # empty intervals
    sd = torch.stack([d] * len(lights)).contiguous()
    got = occluded_multi(tree, lights, sd, st)
    want = occluded_multi_plain(tree, lights, sd, st)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[:, 0, :8].any()


def test_frame_on_card_matches_cpu(renderer):
    cam = start_camera()
    fb, rays = renderer.render(cam)
    cpu = Renderer(renderer.model, renderer.cfg, "cpu")
    want, want_rays = cpu.render(cam)
    assert rmse(fb, want) <= 1e-3
    assert abs(rays - want_rays) <= 1e-3 * want_rays


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.27, 0.9, 1.0])
def test_kernels_c_d_match_plain(card, frac):
    rng = np.random.default_rng(int(frac * 100))
    live = torch.as_tensor(rng.random((64, 128)) < frac, device=card)
    x = torch.as_tensor(rng.normal(size=(16, 64, 128)).astype(np.float32),
                        device=card)
    grank = pack.consolidate_plan(live)
    c0, d0 = pack.consolidate.launches, pack.scatter_back.launches
    got = pack.consolidate(x, grank)
    assert pack.consolidate.launches == c0 + 1
    assert torch.equal(got, pack.consolidate_plain(x, grank))
    nlive = int(live.sum())
    assert not got.reshape(16, -1)[:, nlive:].any()
    res = x[:4].clone()
    res.reshape(4, -1)[:, nlive:] = 777.0
    back = pack.scatter_back(res, grank)
    assert pack.scatter_back.launches == d0 + 1
    assert torch.equal(back, pack.scatter_back_plain(res, grank))
    assert not (back == 777.0).any()


@pytest.mark.parametrize("block", [512, 1024])
def test_kernels_e_f_match_plain(card, block):
    rng = np.random.default_rng(block)
    key = torch.as_tensor(rng.integers(0, 40, (64, 128)).astype(np.int32),
                          device=card)                       # many ties
    key[:8] = 1 << 18                                        # dead lanes
    x = torch.as_tensor(rng.normal(size=(4, 64, 128)).astype(np.float32),
                        device=card)
    e0, f0 = lanesort.lane_sort.launches, lanesort.lane_unsort.launches
    got, rank = lanesort.lane_sort(x, key, block=block)
    assert lanesort.lane_sort.launches == e0 + 1
    want, want_rank = lanesort.lane_sort_plain(x, key, block)
    assert torch.equal(got, want) and torch.equal(rank, want_rank)
    back = lanesort.lane_unsort(got, rank, block=block)
    assert lanesort.lane_unsort.launches == f0 + 1
    assert torch.equal(back, lanesort.lane_unsort_plain(got, rank, block))
    assert torch.equal(back, x)


def test_shipped_defaults_frame_equals_flags_off_on_card(renderer):
    """The depth>=1 reorder (C-F + group partition) on the card renders
    the flags-off frame bit for bit, with the same ray count."""
    cam = start_camera()
    want, want_rays = renderer.render(cam)
    on = Renderer(renderer.model, small_config(), renderer.device)
    counts = [f.launches for f in (pack.consolidate, pack.scatter_back,
                                   lanesort.lane_sort, lanesort.lane_unsort)]
    fb, rays = on.render(cam)
    after = [f.launches for f in (pack.consolidate, pack.scatter_back,
                                  lanesort.lane_sort, lanesort.lane_unsort)]
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1, 1]
    np.testing.assert_array_equal(fb, want)
    assert rays == want_rays


@pytest.mark.parametrize("off", [(0.5, 0.5), tuple(MSAA8[5])])
def test_kernel_g_matches_plain(renderer, card, off):
    """Kernel G vs its plain version at 64x48 from the start pose: first
    round (zfloor 0, padding parked) and a continuation round behind
    every hit; slots agree on >= 99.9% of the pixels, and z, u, v, mat
    are bit-equal wherever they agree."""
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    cam = start_camera()
    setup, scb, clb = edge.build_raster_setup(
        renderer.backend.tree, torch.as_tensor(cam.view_matrix, device=card),
        torch.as_tensor(cam.projection_matrix, device=card), 64, 48)
    px, py, inside = sample_pixel_lanes(cfg, off, card)
    zf = torch.where(inside, 0.0, edge.ZFAR_PARK)
    for _ in range(2):
        before = edge.raster_edge.launches
        got = edge.raster_edge(setup, scb, clb, px, py, zf)
        want = edge.raster_edge_plain(setup, scb, clb, px, py, zf)
        torch.cuda.synchronize()
        assert edge.raster_edge.launches == before + 1
        same = got[1] == want[1]
        assert same.float().mean().item() >= 0.999
        for g, w in zip(got, want):
            assert torch.equal(g[same], w[same])
        zf = torch.where(got[1] >= 0, got[0], edge.ZFAR_PARK)


def test_raster_frame_on_card_matches_cpu(renderer):
    """The msaa-8 edge frame on the card (32 launches of G) against the
    same frame on the CPU (plain version)."""
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    cam = start_camera()
    before = edge.raster_edge.launches
    fb = Rasterizer(renderer.model, cfg, renderer.device).render(
        cam, show_fps=False)
    assert edge.raster_edge.launches == before + 32
    want = Rasterizer(renderer.model, cfg, "cpu").render(cam, show_fps=False)
    assert (np.abs(fb - want).max(-1) > 0.02).mean() <= 0.001
