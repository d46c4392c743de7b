"""Kernels A-G and A' on the card vs their plain PyTorch versions, and
the per-frame accel update (refit, device SAH and Morton rebuilds) on the
card vs the CPU.

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
from vkrt_tpu_torch.accel.device_sah import device_sah_order
from vkrt_tpu_torch.accel.refit import refit_clusters
from vkrt_tpu_torch.rt.dense import (broadcast_points, trace_dense,
                                     trace_dense_plain, trace_occluded,
                                     trace_occluded_plain)
from vkrt_tpu_torch.rt.occl_multi import occluded_multi, occluded_multi_plain
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import lanesort, pack
from vkrt_tpu_torch.wavefront.engine import REBUILD_MODES, Renderer

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


def rot_y(ang):
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


@pytest.mark.parametrize("block", [0, 512, 1024])
def test_kernel_a_prime_matches_plain(renderer, card, block):
    """Kernel A' vs its plain version: per-ray origins (block 0) and one
    origin per block of 512 / 1024 rays; masks equal, parked and
    empty-interval rays free, outputs as the JAX kernel leaves them."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, seed=3)
    tmax = torch.where(tmax > 0, 12.0, 0.0)
    tmax[0, :8] = 0.0009
    kw = {}
    if block:
        pts = o.reshape(3, -1)[:, ::block].T.contiguous()
        o, kw = broadcast_points(pts, d, block), dict(block=block,
                                                      point_origin=True)
    before = trace_occluded.launches
    t, slot, u, v = trace_occluded(tree, pts if block else o, d, tmax, **kw)
    want = trace_occluded_plain(tree, o, d, tmax)
    torch.cuda.synchronize()
    assert trace_occluded.launches == before + 1
    assert torch.equal(slot >= 0, want)
    assert 0.05 < want.float().mean().item() < 0.95
    assert not want[0, :8].any() and not want[tmax == 0].any()
    assert torch.equal(slot, torch.where(want, 1, -1).to(torch.int32))
    assert torch.equal(t, torch.where(want, 0.001, torch.inf))
    assert not u.any() and not v.any()
    if block:       # closest hit, point origins == broadcast origins
        got = trace_dense(tree, pts, d, tmax, **kw)
        for g, w in zip(got, trace_dense(tree, o, d, tmax)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("form", ["no_attributes", "point_512",
                                  "point_1024"])
def test_kernel_a_forms_match_plain(renderer, card, form):
    """Kernel A without its attribute output, and with one origin per
    block of rays, vs A's plain version: every output equal."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, seed=5)
    if form == "no_attributes":
        got = trace_dense(tree, o, d, tmax, with_attributes=False)
        assert len(got) == 4
    else:
        block = int(form.split("_")[1])
        pts = o.reshape(3, -1)[:, ::block].T.contiguous()
        o = broadcast_points(pts, d, block)
        got = trace_dense(tree, pts, d, tmax, block=block, point_origin=True)
        assert len(got) == 5
    want = trace_dense_plain(tree, o, d, tmax)
    torch.cuda.synchronize()
    assert (want[1] >= 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_backend_occluded_entry_points_on_card(renderer, card):
    """DenseBackend.occluded and occluded_point return the plain
    version's masks."""
    be = renderer.backend
    o, d, tmax = random_rays(card, seed=7)
    tmax = torch.where(tmax > 0, 12.0, 0.0)
    assert torch.equal(be.occluded(o, d, tmax),
                       trace_occluded_plain(be.tree, o, d, tmax))
    pts = o.reshape(3, -1)[:, ::512].T.contiguous()
    assert torch.equal(
        be.occluded_point(pts, d, tmax, 512),
        trace_occluded_plain(be.tree, broadcast_points(pts, d, 512), d, tmax))


def test_per_light_frame_equals_kernel_b_frame_on_card(renderer):
    """DenseBackend.per_light: 4 lights x 2 depths = 8 launches of A' and
    none of B; the frame and its ray count equal the kernel-B frame."""
    cam = start_camera()
    want, want_rays = renderer.render(cam)
    pl = Renderer(renderer.model, small_config(), renderer.device)
    pl.backend = pl.backend._replace(per_light=True)
    a0, b0 = trace_occluded.launches, occluded_multi.launches
    fb, rays = pl.render(cam)
    assert trace_occluded.launches == a0 + 8
    assert occluded_multi.launches == b0
    np.testing.assert_array_equal(fb, want)
    assert rays == want_rays


def test_refit_on_card_matches_cpu(renderer):
    """refit_clusters is elementwise float32: the card's tree equals the
    CPU's bit for bit."""
    m = rot_y(0.3)
    m[:3, 3] = (0.5, -1.0, 2.0)
    got = refit_clusters(renderer.backend.tree,
                         torch.as_tensor(m, device=renderer.device))
    cpu_tree = type(renderer.backend.tree)(*(x.cpu() for x in
                                             renderer.backend.tree))
    want = refit_clusters(cpu_tree, torch.as_tensor(m))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_device_sah_order_on_card_matches_cpu(renderer, card):
    flat = renderer.flat
    idx = np.asarray(flat.indices, dtype=np.int64)
    p = np.asarray(flat.positions, np.float32)
    v0 = p[idx[:, 0]]
    tris = [torch.as_tensor(x) for x in (v0, p[idx[:, 1]] - v0,
                                         p[idx[:, 2]] - v0)]
    want = device_sah_order(*tris)
    got = device_sah_order(*(x.to(card) for x in tris))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", REBUILD_MODES)
def test_config5_frame_on_card_matches_cpu(renderer, mode):
    """64x48, depth 4, 4 lights under a rotation, each rebuild mode: the
    card's frame within RMSE 1e-3 of the CPU's, ray counts within 0.1%."""
    cfg = dataclasses.replace(C.config5_stress(), width=64, height=48)
    cam = start_camera()
    m = rot_y(0.05)
    fb, rays = Renderer(renderer.model, cfg, renderer.device,
                        rebuild=mode).render(cam, transform=m)
    want, want_rays = Renderer(renderer.model, cfg, "cpu",
                               rebuild=mode).render(cam, transform=m)
    assert np.isfinite(fb).all()
    assert rmse(fb, want) <= 1e-3
    assert abs(rays - want_rays) <= 1e-3 * want_rays
