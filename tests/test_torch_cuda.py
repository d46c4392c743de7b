"""Kernels A-G and A' on the card vs their plain PyTorch versions, the
per-frame accel update (refit, device SAH and Morton rebuilds) on the
card vs the CPU, the app surface on the card (FrameScheduler on CUDA
events, the CLI's fly-through, the reference backend (LBVH) vs dense),
and a frame split over logical shards of the card vs the unsharded one.

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

from chip_smoke import (adversarial_keys, duplicate_triangle, tie_slots,
                        tie_tree)
from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.accel.lbvh import build_lbvh
from vkrt_tpu_torch.app import cli
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.app.flythrough import camera_path
from vkrt_tpu_torch.app.framebuffer import rmse
from vkrt_tpu_torch.parallel.mesh import (make_mesh, render_frame_sharded,
                                          render_raster_frame_sharded)
from vkrt_tpu_torch.raster import edge
from vkrt_tpu_torch.raster.pipeline import (MSAA8, Rasterizer,
                                            render_raster_frame_edge,
                                            sample_pixel_lanes)
from vkrt_tpu_torch.accel.device_sah import device_sah_order
from vkrt_tpu_torch.accel.refit import refit_clusters
from vkrt_tpu_torch.rt.dense import (broadcast_points, trace_dense,
                                     trace_dense_plain, trace_occluded,
                                     trace_occluded_plain)
from vkrt_tpu_torch.rt.occl_multi import (MAX_SETS, occluded_multi,
                                          occluded_multi_plain)
from vkrt_tpu_torch.runtime import FrameScheduler
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import lanesort, pack
from vkrt_tpu_torch.wavefront.engine import (REBUILD_MODES, Renderer,
                                             camera_ray_blocks, render_frame,
                                             upload_matrix)

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


def camera_rays(renderer, card):
    """The 64x48 start-pose camera rays of the small scene, lane-major."""
    cfg = small_config()
    cam = start_camera()
    opt, d, valid = camera_ray_blocks(
        torch.as_tensor(cam.proj_inverse, device=card),
        torch.as_tensor(cam.view_inverse, device=card), cfg)
    o = opt[:, None, None].expand(d.shape).contiguous()
    return o, d.contiguous(), torch.where(valid, C.RAY_TMAX, 0.0)


def test_kernel_a_tie_goes_to_lower_slot(renderer, card):
    """The most-hit triangle copied into a padding cluster of a higher id
    under the scene's box, which kernel A's front-to-back walk visits
    first: every output equals the run without the copy (the lower slot
    won each tie) and the plain version's; with the original row zeroed
    the copy takes those rays."""
    tree = renderer.backend.tree
    o, d, tmax = camera_rays(renderer, card)
    want = trace_dense(tree, o, d, tmax)
    slot, spare = tie_slots(tree, want[1])
    assert spare > slot // 128
    tt = tie_tree(tree, slot, spare)
    before = trace_dense.launches
    got = trace_dense(tt, o, d, tmax)
    assert trace_dense.launches == before + 1
    seen = want[1] == slot
    assert int(seen.sum()) >= 8
    for g, w, p in zip(got, want, trace_dense_plain(tt, o, d, tmax)):
        assert torch.equal(g, w) and torch.equal(g, p)
    alone = tt._replace(tri_data=tt.tri_data.clone())
    alone.tri_data[slot // 128, slot % 128] = 0.0
    took = trace_dense(alone, o, d, tmax)
    assert (took[1][seen] == spare * 128).all()


@pytest.mark.parametrize("live", ["one_lane", "one_lane_a_warp"])
def test_kernel_a_sparse_groups_match_plain(renderer, card, live):
    """Groups with a single live lane (every 7th group: lane 77) or one
    live lane a warp, the rest parked: every output equals the plain
    version's, and parked lanes miss."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, n=8192, seed=11)
    keep = torch.zeros_like(tmax, dtype=torch.bool)
    if live == "one_lane":
        keep[::7, 77] = True
    else:
        keep[:, ::32] = True
    tmax = torch.where(keep, C.RAY_TMAX, 0.0)
    got = trace_dense(tree, o, d, tmax)
    want = trace_dense_plain(tree, o, d, tmax)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][~keep] == -1).all() and (got[1][keep] >= 0).any()


@pytest.mark.parametrize("ns", [1, 2, 3, 4])
def test_kernel_b_edge_groups_match_plain(renderer, card, ns):
    """Kernel B at NS 1-4 on groups that are all blocked, all parked, all
    empty-interval (0 < tmax <= TMIN), one live lane, and random: masks
    equal to the plain version's; the first three as they must be."""
    tree = renderer.backend.tree
    lights = renderer.lights[:ns].contiguous()
    o, d, tmax = random_rays(card, n=16384, seed=20 + ns)
    pts = o + d * 6.0                       # points in and beyond the hall
    seg = pts[None] - lights[:, :, None, None]
    dist = seg.norm(dim=1)
    sd = (seg / dist[:, None]).contiguous()
    st = (dist - C.RAY_TMIN).contiguous()
    blk = occluded_multi_plain(tree, lights, sd, st)
    # group 0: the first 128 blocked segments of each set, gathered
    for s in range(ns):
        idx = torch.nonzero(blk[s].reshape(-1))[:128, 0]
        assert idx.numel() == 128
        sd[s, :, 0] = sd[s].reshape(3, -1)[:, idx]
        st[s, 0] = st[s].reshape(-1)[idx]
    st[:, 1] = 0.0                          # group 1: parked
    st[:, 2] = 0.0009                       # group 2: empty intervals
    st[:, 3, :127] = 0.0                    # group 3: one live lane
    st[:, 3, 127] = st[:, 0, 5]             # (a blocked one)
    sd[:, :, 3, 127] = sd[:, :, 0, 5]
    before = occluded_multi.launches
    got = occluded_multi(tree, lights, sd, st)
    assert occluded_multi.launches == before + 1
    assert torch.equal(got, occluded_multi_plain(tree, lights, sd, st))
    assert got[:, 0].all() and not got[:, 1:3].any()
    assert not got[:, 3, :127].any()
    assert 0.05 < got[:, 4:].float().mean().item() < 0.95


@pytest.mark.parametrize("ns", [0, MAX_SETS + 1])
def test_kernel_b_refuses_set_counts_it_does_not_take(renderer, card, ns):
    """NS outside 1..MAX_SETS: the wrapper raises, no launch counted."""
    o, d, tmax = random_rays(card, n=256)
    lights = torch.zeros(ns, 3, device=card)
    before = occluded_multi.launches
    with pytest.raises(ValueError, match="segment sets"):
        occluded_multi(renderer.backend.tree, lights,
                       d[None].expand(ns, -1, -1, -1).contiguous(),
                       tmax[None].expand(ns, -1, -1).contiguous())
    assert occluded_multi.launches == before


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


@pytest.mark.parametrize("block", [128, 256, 512, 1024])
@pytest.mark.parametrize("keys", ["equal", "descending", "max_key", "zero",
                                  "dead_tail", "signed"])
def test_kernel_e_adversarial_keys_match_plain(card, block, keys):
    """Kernel E's radix sort on keys that stress its passes (none for all
    zero, three full 8-bit passes for 2**24 - 1, four for keys of both
    signs, ties everywhere, a reversed block, dead tails): channels and
    ranks equal the plain version's (torch.sort, stable)."""
    rng = np.random.default_rng(block)
    nb = 64
    key = torch.as_tensor(adversarial_keys(rng, nb, block)[keys], device=card)
    x = torch.as_tensor(rng.normal(size=(4, nb, 128)).astype(np.float32),
                        device=card)
    e0 = lanesort.lane_sort.launches
    got, rank = lanesort.lane_sort(x, key, block=block)
    assert lanesort.lane_sort.launches == e0 + 1
    want, want_rank = lanesort.lane_sort_plain(x, key, block)
    assert torch.equal(got, want) and torch.equal(rank, want_rank)


@pytest.mark.parametrize("block", [512, 1024])
@pytest.mark.parametrize("channels", [1, 4, 5])
def test_kernel_f_channels_match_plain(card, block, channels):
    """Kernel F moves four lanes a thread and up to four channels a pass:
    1, 4 and 5 channels (a full pass, and one past it), random in-block
    permutations as ranks, plus ranks outside [0, block), which give 0."""
    rng = np.random.default_rng(7 * block + channels)
    nb = 64
    rank = np.stack([rng.permutation(block) for _ in range(nb * 128 // block)])
    rank = torch.as_tensor(rank.reshape(nb, 128).astype(np.int32), device=card)
    res = torch.as_tensor(rng.normal(size=(channels, nb, 128))
                          .astype(np.float32), device=card)
    f0 = lanesort.lane_unsort.launches
    got = lanesort.lane_unsort(res, rank, block=block)
    assert lanesort.lane_unsort.launches == f0 + 1
    assert torch.equal(got, lanesort.lane_unsort_plain(res, rank, block))
    bad = rank.clone()
    bad[3, 5], bad[9, 127] = -1, block
    got = lanesort.lane_unsort(res, bad, block=block)
    want = lanesort.lane_unsort_plain(res, rank, block)
    want[:, 3, 5] = 0.0
    want[:, 9, 127] = 0.0
    assert torch.equal(got, want)


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


def raster_inputs(renderer, card, off=(0.5, 0.5)):
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    cam = start_camera()
    setup, scb, clb = edge.build_raster_setup(
        renderer.backend.tree, torch.as_tensor(cam.view_matrix, device=card),
        torch.as_tensor(cam.projection_matrix, device=card), 64, 48)
    px, py, inside = sample_pixel_lanes(cfg, off, card)
    return setup, scb, clb, px, py, torch.where(inside, 0.0, edge.ZFAR_PARK)


def test_kernel_g_tie_goes_to_lower_slot(renderer, card):
    """The same triangle in two clusters, the copy in the cluster of the
    higher id and the lower zmin, which the kernel's front-to-back walk
    visits first: every output equals the run without the copy, so the
    lower slot won each tie."""
    setup, scb, clb, px, py, zf = raster_inputs(renderer, card)
    want = edge.raster_edge(setup, scb, clb, px, py, zf)
    box = clb.permute(1, 0, 2).reshape(8, -1)
    slots, counts = torch.unique(want[1][want[1] >= 0], return_counts=True)
    cl = (slots // 128).long()
    ok = (box[0][cl] > -1e8) & (box[2][cl] > 0)
    slot = int(slots[ok][counts[ok].argmax()])
    spare = int(torch.nonzero(box[0] == 1e8)[-1])
    assert spare > slot // 128
    dup = duplicate_triangle(setup, scb, clb, slot, spare)
    before = edge.raster_edge.launches
    got = edge.raster_edge(*dup, px, py, zf)
    assert edge.raster_edge.launches == before + 1
    assert (got[1] == slot).sum() == counts[ok].max() >= 8
    for g, w, p in zip(got, want,
                       edge.raster_edge_plain(*dup, px, py, zf)):
        assert torch.equal(g, w) and torch.equal(g, p)
    alone = dup[0].clone()
    alone[slot // 128, slot % 128] = 0.0
    took = edge.raster_edge(alone, dup[1], dup[2], px, py, zf)
    assert (took[1][want[1] == slot] == spare * 128).all()


def test_kernel_g_single_live_pixel(renderer, card):
    """Blocks with one live pixel, as the alpha-discard rounds leave them:
    every pixel parked but a few scattered ones, one of them behind its
    first hit; the live pixels get the plain version's answer and every
    parked one a miss."""
    setup, scb, clb, px, py, zf0 = raster_inputs(renderer, card,
                                                 tuple(MSAA8[5]))
    first = edge.raster_edge(setup, scb, clb, px, py, zf0)
    zf = torch.full_like(zf0, edge.ZFAR_PARK)
    hits = torch.nonzero(first[1].reshape(-1) >= 0).reshape(-1)
    picks = hits[torch.linspace(0, hits.numel() - 1, 5).long()]
    zf.reshape(-1)[picks] = 0.0
    zf.reshape(-1)[picks[2]] = first[0].reshape(-1)[picks[2]]
    got = edge.raster_edge(setup, scb, clb, px, py, zf)
    want = edge.raster_edge_plain(setup, scb, clb, px, py, zf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    live = zf < edge.ZFAR_PARK
    assert int(live.sum()) == 5 and (got[1][~live] == -1).all()
    assert torch.isinf(got[0][~live]).all()
    assert (got[1][live] >= 0).sum() >= 4
    assert torch.equal(got[1].reshape(-1)[picks[:2]],
                       first[1].reshape(-1)[picks[:2]])


def test_kernel_g_refuses_a_tree_beyond_its_work_list(card):
    """More superclusters than the kernel's shared-memory work list
    holds: the wrapper raises, and no launch is counted."""
    n_sc = edge.MAX_SUPERCLUSTERS + 1
    setup = torch.zeros((n_sc * 64, 128, edge.SETUP_W), device=card)
    scb = torch.zeros((8, n_sc), device=card)
    clb = torch.zeros((n_sc, 8, 64), device=card)
    px = torch.zeros((2, 128), device=card)
    before = edge.raster_edge.launches
    with pytest.raises(ValueError, match="superclusters"):
        edge.raster_edge(setup, scb, clb, px, px, px)
    assert edge.raster_edge.launches == before


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


def occluded_coded(out, blocked) -> bool:
    """Kernel A''s outputs as the any-hit mode leaves them."""
    t, slot, u, v = out
    return (torch.equal(slot, torch.where(blocked, 1, -1).to(torch.int32))
            and torch.equal(t, torch.where(blocked, 0.001, torch.inf))
            and not u.any() and not v.any())


@pytest.mark.parametrize("case", ["all_blocked", "all_parked", "one_live",
                                  "empty", "mixed_origins"])
def test_kernel_a_prime_edge_groups_match_plain(renderer, card, case):
    """Kernel A' on edge groups (group 0: all blocked, all parked, one
    live and blocked lane, or all empty intervals 0 < tmax <= TMIN) of
    light 0's segments, with per-ray origins and with one origin per 512
    rays: masks equal the plain version's and, in the point-origin form,
    kernel B's at NS 1; outputs coded. "mixed_origins": per-ray origins
    that differ inside every group (random points in the hall)."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, n=16384, seed=40)
    if case == "mixed_origins":
        tmax = torch.where(tmax > 0, 12.0, 0.0)
        out = trace_occluded(tree, o, d, tmax)
        want = trace_occluded_plain(tree, o, d, tmax)
        assert torch.equal(out[1] >= 0, want) and occluded_coded(out, want)
        assert 0.05 < want.float().mean().item() < 0.95
        return
    light = renderer.lights[:1].contiguous()
    seg = o + d * 6.0 - light[0][:, None, None]
    dist = seg.norm(dim=0)
    sd, st = (seg / dist).contiguous(), (dist - C.RAY_TMIN).contiguous()
    blk = occluded_multi_plain(tree, light, sd[None], st[None])[0]
    idx = torch.nonzero(blk.reshape(-1))[:128, 0]
    assert idx.numel() == 128
    sd[:, 0] = sd.reshape(3, -1)[:, idx]
    st[0] = st.reshape(-1)[idx]
    if case == "all_parked":
        st[0] = 0.0
    elif case == "empty":
        st[0] = 0.0009
    elif case == "one_live":
        st[0, :127] = 0.0
    want = trace_occluded_plain(
        tree, light[0][:, None, None].expand(sd.shape).contiguous(), sd, st)
    assert bool(want[0].any()) == (case in ("all_blocked", "one_live"))
    assert case != "all_blocked" or bool(want[0].all())
    assert case != "one_live" or (bool(want[0, 127])
                                  and not want[0, :127].any())
    before = trace_occluded.launches
    per_ray = trace_occluded(
        tree, light[0][:, None, None].expand(sd.shape).contiguous(), sd, st)
    pts = light.expand(sd[0].numel() // 512, 3).contiguous()
    point = trace_occluded(tree, pts, sd, st, block=512, point_origin=True)
    assert trace_occluded.launches == before + 2
    kb = occluded_multi(tree, light, sd[None], st[None])[0]
    for out in (per_ray, point):
        assert torch.equal(out[1] >= 0, want) and occluded_coded(out, want)
    assert torch.equal(point[1] >= 0, kb)


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


def test_frame_scheduler_on_events(card):
    """FrameScheduler on the card: submitting frames behind a busy
    stream does not wait for them; each retires once, in order, with
    its own values, as numpy arrays."""
    def frame(i):
        torch.cuda._sleep(2_000_000)             # ~1 ms of device work
        return (torch.full((4, 4), float(i), device=card),
                torch.full((), 2 * i, dtype=torch.int64, device=card))

    warm = FrameScheduler(inflight=2)            # pinned host blocks cached
    for i in range(6):
        warm.submit(frame, i)
    del warm
    sched = FrameScheduler(inflight=2)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)               # ~100 ms: the stream busy
    retired = [sched.submit(frame, i) for i in range(2)]
    assert retired == [None, None]
    started = torch.cuda.Event()
    started.record()
    assert not started.query()          # submits returned before the work
    for i in range(2, 6):
        retired.append(sched.submit(frame, i))
    retired = retired[2:] + list(sched.drain())
    assert [idx for idx, _ in retired] == list(range(6))
    for idx, (fb, rays) in retired:
        assert isinstance(fb, np.ndarray) and (fb == idx).all()
        assert int(rays) == 2 * idx


def test_cli_flythrough_on_card(renderer, tmp_path):
    """The CLI's pipelined 64x48 config-1 fly-through on the card: its
    last frame equals the synchronous render of the same camera."""
    from PIL import Image

    out = tmp_path / "fly.png"
    assert cli.main(["--config", "1", "--width", "64", "--height", "48",
                     "--frames", "3", "--output", str(out)],
                    scene=renderer.model) == 0
    cfg = dataclasses.replace(C.config1_primary(), width=64, height=48)
    cam = list(camera_path(64, 48))[2]
    want, _ = Renderer(renderer.model, cfg, renderer.device,
                       quantize=True).render(cam)
    with Image.open(out) as im:
        np.testing.assert_array_equal(np.asarray(im), want)


def test_reference_backend_on_card(renderer, card):
    """The LBVH built on the card equals the CPU build; the reference
    backend's 64x48 config-4 frame on the card is within RMSE 1e-3 of
    the dense frame, with equal ray counts."""
    tris = [x.cpu() for x in renderer.rebuild_inputs()[0]]
    want = build_lbvh(*tris)
    got = build_lbvh(*(x.to(card) for x in tris))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    cfg = small_config()
    cam = start_camera()
    fb, rays = Renderer(renderer.model, cfg, card,
                        backend="reference").render(cam)
    dense, dense_rays = Renderer(renderer.model, cfg, card).render(cam)
    assert np.isfinite(fb).all() and rmse(fb, dense) <= 1e-3
    assert rays == dense_rays


def test_sharded_frame_on_card_equals_unsharded(renderer, card):
    """Config 4 at 64x48 on ["cuda:0"] * 3 (logical shards of the one
    card): the f32 frame and the ray grid equal the unsharded ones bit for
    bit, with 3x the launches of A-F; so does the MSAA-8 raster frame."""
    cam = start_camera()
    r = Renderer(renderer.model, small_config(), card)
    mats = [upload_matrix(m, card) for m in (cam.proj_inverse,
                                             cam.view_inverse)]
    mesh = make_mesh(["cuda:0"] * 3)
    want = render_frame(r.backend, r.tex, *mats, r.lights, r.cfg)
    a, b = trace_dense.launches, pack.consolidate.launches
    fb, rays = render_frame_sharded(r.backend, r.tex, *mats, r.lights, r.cfg,
                                    mesh)
    assert (trace_dense.launches - a, pack.consolidate.launches - b) == (6, 3)
    assert torch.equal(fb, want[0]) and torch.equal(rays, want[1])
    view, proj = (upload_matrix(m, card) for m in (cam.view_matrix,
                                                   cam.projection_matrix))
    want = render_raster_frame_edge(r.backend.tree, r.tex, view, proj, r.cfg)
    got = render_raster_frame_sharded(r.backend.tree, r.tex, view, proj,
                                      r.cfg, mesh, msaa=8)
    assert torch.equal(got, want)
