"""Kernels A-L and A' on the card vs their plain PyTorch versions (A, A'
and B in each of their modes also vs their default mode; A's and A''s
stats within the plain version's bounds), the
per-frame accel update (refit, device SAH in every mode, and Morton
rebuilds) on the card vs the CPU, the app surface on the card
(FrameScheduler on CUDA events, the CLI's fly-through, the reference
backend (LBVH) vs dense), and a frame split over logical shards of the
card vs the unsharded one.

Marked `cuda`: these need an NVIDIA GPU with nvcc and skip elsewhere (the
CUDA kernels have no CPU or interpret mode; their plain versions are
covered on the CPU by test_torch_trace.py, test_torch_pack.py,
test_torch_lanesort.py, test_torch_raster_edge.py,
test_torch_device_build.py, test_torch_raster_frames.py and
test_torch_shade.py). C-F move f32 values without arithmetic, so they
must equal their plain versions exactly; so must H, I, J, K and L, which
round each operation as theirs do.
Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (CUT_KINDS, CUT_SIZES, adversarial_keys, cut_case,
                        crossing_slots, crossing_soup, duplicate_triangle,
                        tie_slots, tie_tree)
from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import graphs, tracing
from vkrt_tpu_torch.accel import clusters
from vkrt_tpu_torch.accel.lbvh import build_lbvh
from vkrt_tpu_torch.app import cli
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.app.flythrough import camera_path
from vkrt_tpu_torch.app.framebuffer import rmse
from vkrt_tpu_torch.parallel.mesh import (make_mesh, render_frame_sharded,
                                          render_raster_frame_sharded,
                                          replicate)
from vkrt_tpu_torch.raster import edge
from vkrt_tpu_torch.raster.clip import clip_boxes, clip_boxes_plain
from vkrt_tpu_torch.raster import pipeline as rp
from vkrt_tpu_torch.raster import sample as rs
from vkrt_tpu_torch.raster.pipeline import (MSAA8, Rasterizer,
                                            render_raster_frame_edge,
                                            sample_pixel_lanes)
from vkrt_tpu_torch.accel.device_sah import (_cut_round, cut_round,
                                             device_sah_order)
from vkrt_tpu_torch.accel.refit import refit_clusters
from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.rt import dense
from vkrt_tpu_torch.rt.dense import (ABLATES, CUTS, broadcast_points,
                                     closest_worklists, stats_lane0_of,
                                     sweep_bounds, trace_dense,
                                     trace_dense_plain, trace_occluded,
                                     trace_occluded_plain)
from vkrt_tpu_torch.rt.occl_multi import (MAX_SETS, multi_worklists,
                                          occluded_multi,
                                          occluded_multi_plain)
from vkrt_tpu_torch.runtime import FrameScheduler
from vkrt_tpu_torch.scene import Image
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.scene.textures import build_material_heap
from vkrt_tpu_torch.shade import shading
from vkrt_tpu_torch.shade.sampling import (sample_hits, sample_hits_plain,
                                           sample_material)
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.wavefront import engine, lanesort, pack
from vkrt_tpu_torch.wavefront.engine import (REBUILD_MODES, Renderer,
                                             camera_ray_blocks, render_frame,
                                             texture_arrays_from_numpy,
                                             upload_matrix)
import torch_support  # noqa: F401

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


WRAPPERS = {"trace_closest": dense.trace_dense,
            "trace_occluded": dense.trace_occluded,
            "occl_multi": occluded_multi, "consolidate": pack.consolidate,
            "scatter_back": pack.scatter_back,
            "lane_sort": lanesort.lane_sort,
            "lane_unsort": lanesort.lane_unsort,
            "raster_edge": edge.raster_edge, "sah_cut": cut_round,
            "raster_sample": rs.raster_sample_round,
            "raster_clip": clip_boxes, "sample_hits": sample_hits,
            "shade_interp": shading.shade_interp,
            "shade_lights": shading.shade_lights,
            "shade_combine": shading.shade_combine}
SHADE_STEPS = ("shade_interp", "shade_lights", "shade_combine")


def counted(fn):
    """(fn(), what ran on the card: {kernel: launches} from the profiler's
    device events, what the wrappers counted on the host: {kernel:
    launches}), the kernels that launched nothing left out of both."""
    from torch.profiler import ProfilerActivity, profile

    before = {k: f.launches for k, f in WRAPPERS.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    card = {k: n for k, n in graphs.kernel_launches(prof.key_averages())
            .items() if n}
    host = {k: f.launches - before[k] for k, f in WRAPPERS.items()
            if f.launches != before[k]}
    return out, card, host


def counted_again(fn, want: dict, tries: int = 3):
    """counted(fn), read again while what ran on the card is not `want`,
    up to `tries` readings. On the H100 the profiler now and then loses
    the record of a lone kernel of a few microseconds: of 1,040 sessions
    that ran kernel K alone, 12 read no launch. A wrapper launches as
    many kernels at every call, so one that launches too few or too many
    fails every reading."""
    for _ in range(tries):
        out, card, host = counted(fn)
        if card == want:
            break
    return out, card, host


def twice(counts: dict) -> dict:
    return {k: 2 * n for k, n in counts.items()}


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
    the flags-off frame bit for bit, with the same ray count; a frame
    (a replay, after the capture) runs C, D, E and F once each on the
    card."""
    cam = start_camera()
    want, want_rays = renderer.render(cam)
    on = Renderer(renderer.model, small_config(), renderer.device)
    on.render(cam)                                   # the capture
    (fb, rays), card, host = counted(lambda: on.render(cam))
    assert [card.get(k) for k in ("consolidate", "scatter_back", "lane_sort",
                                  "lane_unsort")] == [1, 1, 1, 1]
    assert host == {}
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


@pytest.mark.parametrize("chunk", [0, edge.SC_CHUNK + 1])
def test_kernel_g_refuses_a_chunk_it_does_not_take(card, chunk):
    """A work-list chunk outside 1 to SC_CHUNK superclusters: the wrapper
    raises, and no launch is counted."""
    setup = torch.zeros((64, 128, edge.SETUP_W), device=card)
    scb = torch.zeros((8, 128), device=card)
    clb = torch.zeros((1, 8, 64), device=card)
    px = torch.zeros((2, 128), device=card)
    before = edge.raster_edge.launches
    with pytest.raises(ValueError, match="chunk"):
        edge.raster_edge(setup, scb, clb, px, px, px, chunk=chunk)
    assert edge.raster_edge.launches == before


@pytest.fixture(scope="module")
def soup(card):
    """A tree of 5 superclusters (40,960 random triangles, 0.2-0.6 across,
    scattered 3-20 units in front of the start camera, so surfaces of
    every supercluster overlap in depth), Morton-ordered on the card, and
    the 160x120 sample lanes at the pixel centres."""
    rng = np.random.default_rng(7)
    n = 5 * 64 * 128
    cam = Camera(160, 120)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    p = np.stack([rng.uniform(-8, 8, n), rng.uniform(-6, 6, n),
                  rng.uniform(-20, -3, n), np.ones(n)], axis=1)
    v0 = (p @ np.asarray(cam.view_inverse, np.float64).T)[:, :3]
    e1, e2 = (rng.uniform(-0.6, 0.6, (n, 3)) for _ in range(2))
    tree = clusters.build_clusters(
        *(torch.as_tensor(x, dtype=torch.float32, device=card)
          for x in (v0, e1, e2)), method="morton")
    assert tree.num_superclusters == 5
    setup = edge.build_raster_setup(
        tree, torch.as_tensor(cam.view_matrix, device=card),
        torch.as_tensor(cam.projection_matrix, device=card), 160, 120)
    cfg = dataclasses.replace(C.reference_config(), width=160, height=120)
    px, py, inside = sample_pixel_lanes(cfg, (0.5, 0.5), card)
    return setup, px, py, torch.where(inside, 0.0, edge.ZFAR_PARK)


@pytest.mark.parametrize("chunk", [2, 3, 4])
def test_kernel_g_chunks_equal_plain_and_one_list(soup, chunk):
    """Kernel G on a tree beyond one chunk: 5 superclusters walked 2, 3 or
    4 at a time, carrying each pixel's depth and slot, equal the plain
    version and the kernel in one chunk on every output, in the first
    round and behind every hit."""
    setup, px, py, zf = soup
    for _ in range(2):
        before = edge.raster_edge.launches
        got = edge.raster_edge(*setup, px, py, zf, chunk=chunk)
        assert edge.raster_edge.launches == before + 1
        one = edge.raster_edge(*setup, px, py, zf)
        want = edge.raster_edge_plain(*setup, px, py, zf)
        for g, o, w in zip(got, one, want):
            assert torch.equal(g, o) and torch.equal(g, w)
        assert (got[1] >= 0).float().mean().item() > 0.3
        zf = torch.where(got[1] >= 0, got[0], edge.ZFAR_PARK)


def fallback_heap(card):
    """The material heap of five slots over a 64x64 random map, a solid
    4x4 fallback (alone in slot 1, and co-sized with the random map in
    slot 3, as Sponza's), a 2x2 and a 3x5 random map, on the card."""
    rng = np.random.default_rng(5)

    def image(w, h, solid=False):
        data = (np.broadcast_to(rng.integers(0, 256, 4, np.uint8), (h, w, 4))
                if solid else rng.integers(0, 256, (h, w, 4), np.uint8))
        return Image(width=w, height=h, data=np.ascontiguousarray(data))

    images = [image(64, 64), image(4, 4, solid=True), image(2, 2),
              image(3, 5)]
    triples = np.array([[0, 0, 0], [1, 1, 1], [2, 2, 2], [0, 1, 0],
                        [3, 3, 3]], np.int32)
    h = build_material_heap(images, triples)
    return texture_arrays_from_numpy(h.texels_tri, h.level_offset,
                                     h.level_width, h.level_height, card)


def alpha_edge_heap(card):
    """One slot, a 2x1 map whose two texels have alpha 25 and 26 (0.098
    and 0.102): bilinear alpha is 0.1 half-way between their centres."""
    rgba = np.array([[[200, 40, 10, 25], [30, 180, 90, 26]]], np.uint8)
    h = build_material_heap([Image(width=2, height=1, data=rgba)],
                            np.zeros((1, 3), np.int32))
    return texture_arrays_from_numpy(h.texels_tri, h.level_offset,
                                     h.level_width, h.level_height, card)


def kernel_i_case(renderer, card, case):
    """One discard round's inputs (tex, z, slot, u, v, mat, color) for
    kernel I: G's round 0 of the small scene from the start pose (dense),
    that round with 1% of its hits kept (sparse) or none (parked), the
    2x1 alpha map's lanes swept across alpha 0.1 (alpha_edge), the dense
    round's hits at uvs in [-3, 4) (wrap), and every slot of the fallback
    heap at random uvs (every_slot). The colour so far is random, so a
    lane left alone shows."""
    rng = np.random.default_rng(11)
    z, slot, u, v, mat = edge.raster_edge(*raster_inputs(renderer, card))
    tex = renderer.tex
    shape = slot.shape

    def rand(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=card)

    def missed(keep):
        return (torch.where(keep, z, torch.inf), torch.where(keep, slot, -1),
                torch.where(keep, u, 0.0), torch.where(keep, v, 0.0),
                torch.where(keep, mat, 0))

    if case == "sparse":
        keep = torch.as_tensor(rng.random(shape) < 0.01, device=card)
        z, slot, u, v, mat = missed(keep & (slot >= 0))
    elif case == "parked":
        z, slot, u, v, mat = missed(torch.zeros_like(slot, dtype=torch.bool))
    elif case == "alpha_edge":
        tex = alpha_edge_heap(card)
        n = slot.numel()
        half = np.float32(0.5)
        steps = np.arange(n, dtype=np.int64) - n // 2
        sweep = (np.nextafter(half, np.float32(1)) - half) * steps
        u = torch.as_tensor((half + sweep.astype(np.float32))
                            .reshape(shape), device=card)
        v = torch.full(shape, 0.5, device=card)
        slot = torch.zeros_like(slot)
        mat = torch.zeros_like(mat)
        z = rand(0.0, 1.0)
    elif case == "wrap":
        u, v = rand(-3.0, 4.0), rand(-3.0, 4.0)
    elif case == "every_slot":
        tex = fallback_heap(card)
        m = tex.level_offset.shape[0]
        mat = torch.arange(slot.numel(), device=card,
                           dtype=torch.int32).reshape(shape) % m
        slot = torch.where(rand(0.0, 1.0) < 0.9, 5, -1).to(torch.int32)
        u, v, z = rand(0.0, 1.0), rand(0.0, 1.0), rand(0.0, 1.0)
    color = torch.stack([rand(0.0, 1.0) for _ in range(3)])
    return tex, z, slot, u, v, mat, color


@pytest.mark.parametrize("case", ["dense", "sparse", "parked", "alpha_edge",
                                  "wrap", "every_slot"])
def test_kernel_i_matches_plain(renderer, card, case):
    """Kernel I (raster_sample_round on CUDA tensors) vs
    raster_sample_round_plain on the same tensors: colour and the next
    depth floor bit-equal, one launch counted, on every case of
    `kernel_i_case`; each case holds what it is there for (opaque hits
    and discards, every slot, alphas at 0.1 and one ulp either side)."""
    tex, z, slot, u, v, mat, color = kernel_i_case(renderer, card, case)
    want = rs.raster_sample_round_plain(tex, z, slot, u, v, mat, color)
    before = rs.raster_sample_round.launches
    got = rs.raster_sample_round(tex, z, slot, u, v, mat, color.clone())
    torch.cuda.synchronize()
    assert rs.raster_sample_round.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hit = slot >= 0
    kept = torch.equal(got[0][:, ~hit], color[:, ~hit])
    assert kept and (got[1][~hit] == edge.ZFAR_PARK).all()
    opaque = hit & (got[1] == edge.ZFAR_PARK)
    if case == "parked":
        assert not hit.any()
    elif case == "sparse":
        assert 0 < int(hit.sum()) < 0.02 * hit.numel()
    else:
        assert opaque.any() and (hit & ~opaque).any()
    if case == "alpha_edge":
        alpha = sample_material(tex.texels_tri, tex.level_offset,
                                tex.level_width, tex.level_height, mat,
                                torch.stack([u, v]))[0][3]
        cut = np.float32(rp.ALPHA_DISCARD)
        near = {float(np.nextafter(cut, np.float32(0))), float(cut),
                float(np.nextafter(cut, np.float32(1)))}
        assert near <= set(alpha.cpu().numpy().reshape(-1).tolist())
    if case == "every_slot":
        assert set(mat[hit].unique().tolist()) == set(range(5))
        assert tex.level_width[1, 0] == 4                  # the fallback


K_CASES = ("dense", "sparse", "none", "wrap", "every_slot", "texel_edge")


def kernel_k_case(renderer, card, case):
    """Kernel K's inputs (tex, slot_ids, uv, hit) on 64 x 128 lanes of the
    small scene's heap: every lane hit at uvs in [0, 1) (dense), under 2%
    hit (sparse), none hit (none), 90% hit at uvs in [-3, 4) (wrap), every
    slot of the fallback heap (every_slot), and uvs on texel centres and
    edges and one ulp either side of them, where floor(u * w - 0.5) steps
    (texel_edge)."""
    rng = np.random.default_rng(13)
    tex = fallback_heap(card) if case == "every_slot" else renderer.tex
    shape = (64, 128)
    m = tex.level_offset.shape[0]

    def rand(lo, hi, size=shape):
        return torch.as_tensor(rng.uniform(lo, hi, size).astype(np.float32),
                               device=card)

    slot = torch.as_tensor(rng.integers(0, m, shape, dtype=np.int32),
                           device=card)
    uv = rand(-3.0, 4.0, (2, *shape)) if case == "wrap" else rand(
        0.0, 1.0, (2, *shape))
    frac = {"dense": 1.0, "sparse": 0.015, "none": 0.0}.get(case, 0.9)
    hit = torch.as_tensor(rng.random(shape) < frac, device=card)
    if case == "every_slot":
        slot = torch.arange(slot.numel(), device=card,
                            dtype=torch.int32).reshape(shape) % m
    elif case == "texel_edge":
        sizes = torch.stack([tex.level_width[:, 0],
                             tex.level_height[:, 0]]).cpu().numpy()
        s = slot.cpu().numpy()
        k = rng.integers(-2, 3, (2, *shape)) * sizes[:, s] + rng.integers(
            0, 1 << 20, (2, *shape)) % sizes[:, s]
        half = rng.integers(0, 2, (2, *shape)) * 0.5       # edge or centre
        x = ((k + half) / sizes[:, s]).astype(np.float32)
        ulps = rng.integers(-1, 2, (2, *shape))
        x = np.where(ulps < 0, np.nextafter(x, np.float32(-np.inf)),
                     np.where(ulps > 0, np.nextafter(x, np.float32(np.inf)),
                              x))
        uv = torch.as_tensor(x.astype(np.float32), device=card)
    return tex, slot, uv, hit


@pytest.mark.parametrize("case", K_CASES)
def test_kernel_k_matches_plain(renderer, card, case):
    """Kernel K (sample_hits on CUDA tensors) vs sample_hits_plain on the
    same tensors: base, metallic and normal bit-equal on every lane, one
    launch on the card and one counted, on every case of
    `kernel_k_case`; on the hit lanes they are sample_material's channels,
    elsewhere 0; each case holds what it is there for."""
    tex, slot, uv, hit = kernel_k_case(renderer, card, case)
    want = sample_hits_plain(tex, slot, uv, hit)
    got, on_card, host = counted_again(
        lambda: sample_hits(tex, slot, uv, hit), {"sample_hits": 1})
    assert on_card == host == {"sample_hits": 1}
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    base, mr, nmap = sample_material(tex.texels_tri, tex.level_offset,
                                     tex.level_width, tex.level_height,
                                     slot, uv)
    for g, full in zip(got, (base[:3], mr[2], nmap[:3])):
        assert torch.equal(g[..., hit], full[..., hit])
        assert not g[..., ~hit].any()
    n = hit.numel()
    if case == "none":
        assert not hit.any()
    elif case == "sparse":
        assert 0 < int(hit.sum()) < 0.02 * n
    elif case == "dense":
        assert hit.all()
    elif case == "wrap":
        assert (uv[:, hit] < 0).any() and (uv[:, hit] > 1).any()
    elif case == "every_slot":
        assert set(slot[hit].unique().tolist()) == set(range(5))
        assert tex.level_width[1, 0] == 4                  # the fallback
    elif case == "texel_edge":
        w = tex.level_width[slot.long(), 0].float()
        x = uv[0] * w - 0.5
        assert (x[hit] == torch.floor(x[hit])).any()       # on a centre
        assert (x[hit] - torch.floor(x[hit]) == 0.5).any()  # on an edge


@pytest.mark.parametrize("case", ["config4", "config5_full"])
def test_graph_frames_equal_plain_sample_frames(renderer, card, case,
                                                monkeypatch):
    """A config-4 frame (depth 2) and a config-5 full-rebuild frame
    (depth 4) at 64x48 through the graph path: kernel K once a depth,
    and the frame and ray count bit-equal to the same frame's with
    sample_hits_plain forced in the engine (which launches no K)."""
    make, mode = CASES[case]
    cfg = dataclasses.replace(make(), width=64, height=48)
    r = Renderer(renderer.model, cfg, card, quantize=True, rebuild=mode)
    _, k_graph = graph_twin(r)
    _, p_graph = graph_twin(r)
    cam = start_camera()
    tf = rot_y(0.05) if cfg.rebuild_per_frame else None
    k_graph.render_async(cam, tf)                     # warm-up and capture
    got, on_card, host = counted(lambda: k_graph.render_async(cam, tf))
    assert on_card["sample_hits"] == cfg.max_depth and host == {}
    monkeypatch.setattr(engine, "sample_hits", sample_hits_plain)
    p_graph.render_async(cam, tf)
    want, on_card, _ = counted(lambda: p_graph.render_async(cam, tf))
    assert "sample_hits" not in on_card
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    k_graph.free_graphs()
    p_graph.free_graphs()


def same_bits(got, want) -> bool:
    """Equal shapes and dtypes and equal bits (a float32 NaN equals a NaN
    of the same bits), or both None."""
    if got is None or want is None:
        return got is None and want is None
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


L_CASES = ("lights4", "lights1", "lights0", "no_shadows", "no_reflections",
           "segments_off", "partitioned", "flat", "all_dead", "all_miss",
           "all_hit", "edges")


def kernel_l_case(card, case):
    """Kernel L's inputs on 64 x 128 lanes of the card: a random depth's
    trace outputs (80% live, 70% hit, the material rows integers), sample,
    carry, lights and blocked masks (dict), and the step options (lights
    at 4, 1 or 0, without shadows, reflections or shadow segments, the
    lane-sorted iteration's written colour, flat albedo; all-dead,
    all-miss and all-hit wavefronts; and `edges`: zero-length normals,
    tangents and map normals, hits on a light's own position, NaN
    attributes)."""
    rng = np.random.default_rng(23)
    shape = (64, 128)
    nl = {"lights1": 1, "lights0": 0, "flat": 0}.get(case, 4)
    live = {"all_dead": 0.0, "all_miss": 1.0, "all_hit": 1.0}.get(case, 0.8)
    hits = {"all_miss": 0.0, "all_hit": 1.0}.get(case, 0.7)
    attrs = rng.normal(size=(36, *shape)).astype(np.float32)
    attrs[0:9] *= 6.0
    attrs[33:36] = rng.integers(0, 5, (3, *shape))
    d = rng.normal(size=(3, *shape)).astype(np.float32)
    w = dict(
        active=rng.random(shape) < live, hitm=rng.random(shape) < hits,
        u=rng.uniform(0, 0.5, shape).astype(np.float32),
        v=rng.uniform(0, 0.5, shape).astype(np.float32), attrs=attrs,
        base=rng.uniform(0, 1, (3, *shape)).astype(np.float32),
        metallic=rng.uniform(0, 0.3, shape).astype(np.float32),
        map_n=rng.uniform(0, 1, (3, *shape)).astype(np.float32),
        origins=rng.normal(size=(3, *shape)).astype(np.float32),
        dirs=(d / np.linalg.norm(d, axis=0)).astype(np.float32),
        attenuation=rng.uniform(0.05, 1, shape).astype(np.float32),
        accum=rng.uniform(0, 2, (3, *shape)).astype(np.float32),
        ray_count=rng.integers(0, 5, shape).astype(np.int32),
        lights=C.LIGHT_POSITIONS[:nl].astype(np.float32),
        occ=rng.random((nl, *shape)) < 0.4)
    if case == "edges":
        attrs[9:18, 0] = 0.0                      # zero-length normals
        attrs[24:33, 1] = 0.0                     # zero-length tangents
        w["map_n"][:, 2] = 0.5                    # map normal 0
        attrs[0:3, 3] = C.LIGHT_POSITIONS[1][:, None]   # on light 1
        attrs[3:9, 3] = 0.0
        attrs[:, 4, :32] = np.nan                 # NaN attributes
        attrs[33, 4, 32:64] = np.nan              # a NaN slot alone
        w["metallic"][5] = C.METALLIC_THRESHOLD   # the threshold itself
    opts = dict(shadows=case not in ("no_shadows", "flat") and nl > 0,
                reflections=case != "no_reflections",
                segments=case != "segments_off",
                partitioned=case == "partitioned", flat=case == "flat")
    return {k: torch.as_tensor(x, device=card) for k, x in w.items()}, opts


def shade_steps(w, opts, steps):
    """One depth's three steps through `steps` (the wrappers, or the plain
    versions), each on its own copy of the carry: every output of each
    step, by name. The later steps take the earlier steps' outputs of the
    same `steps`."""
    interp, lights_fn, combine = steps
    carry = {k: w[k].clone() for k in ("active", "origins", "dirs",
                                       "attenuation", "accum", "ray_count")}
    pos, uv, slot, hit = interp(w["active"], w["hitm"], w["u"], w["v"],
                                w["attrs"])
    out = dict(pos=pos, uv=uv, slot=slot, hit=hit)
    if opts["flat"]:
        combine(carry["active"], w["hitm"], w["base"], None, None, None,
                None, None, None, None, None, carry["accum"],
                carry["ray_count"], flat=True)
        return {**out, **carry}
    pn, castmask, sd, st = lights_fn(
        hit, w["u"], w["v"], w["attrs"], w["map_n"], pos,
        w["lights"] if opts["shadows"] else None, opts["segments"])
    out.update(pn=pn, castmask=castmask, sd=sd, st=st)
    acc = ((None, None) if opts["partitioned"]
           else (carry["accum"], carry["ray_count"]))
    res = combine(carry["active"], w["hitm"], w["base"], w["metallic"], pn,
                  pos, w["lights"], w["occ"] if opts["shadows"] else None,
                  carry["origins"], carry["dirs"], carry["attenuation"],
                  *acc, opts["reflections"])
    if res is not None:
        out.update(dacc=res[0], dcount=res[1])
    return {**out, **carry}


PLAIN_STEPS = (shading.shade_interp_plain, shading.shade_lights_plain,
               shading.shade_combine_plain)
KERNEL_STEPS = (shading.shade_interp, shading.shade_lights,
                shading.shade_combine)


@pytest.mark.parametrize("case", L_CASES)
def test_kernel_l_matches_plain(card, case):
    """Kernel L's three steps (shade_interp, shade_lights, shade_combine
    on CUDA tensors) vs their plain versions on the same tensors, the
    later steps on the earlier steps' outputs of each: every output and
    every in-place update bit-equal on every lane, on each case of
    `kernel_l_case`; one launch of each step on the card and one counted
    (no shade_lights with flat albedo); each case holds what it is there
    for."""
    w, opts = kernel_l_case(card, case)
    want = shade_steps(w, opts, PLAIN_STEPS)
    launches = {k: 1 for k in SHADE_STEPS
                if not (opts["flat"] and k == "shade_lights")}
    got, on_card, host = counted_again(
        lambda: shade_steps(w, opts, KERNEL_STEPS), launches)
    assert on_card == host == launches
    assert got.keys() == want.keys()
    bad = [k for k in want if not same_bits(got[k], want[k])]
    assert not bad, bad
    hit = want["hit"]
    if case == "all_dead":
        assert not w["active"].any() and torch.equal(got["accum"],
                                                     w["accum"])
    elif case == "all_miss":
        assert w["active"].all() and not hit.any()
    elif case == "all_hit":
        assert hit.all()
    elif case == "edges":
        assert hit[0].any() and hit[1].any() and hit[2].any()
        assert (got["pos"][:, 3][:, hit[3]] == w["lights"][1][:, None]).all()
        assert torch.isnan(got["pn"][:, 4, :32][:, hit[4, :32]]).all()
        assert (got["slot"][4, 32:64][hit[4, 32:64]] == 0).all()
    if opts["shadows"] and hit.any():
        assert got["castmask"].max() > 0
    if opts["partitioned"]:
        assert torch.equal(got["accum"], w["accum"])


SHADE_FRAME_CASES = {
    **{f"config4_{o}": ("config4", o) for o in (
        "defaults", "partition_closest", "resort_secondary", "no_shadows",
        "no_reflections")},
    **{f"config5_{o}": ("config5", o) for o in (
        "defaults", "partition_closest", "resort_secondary", "no_shadows",
        "no_reflections")},
    "config1_flat": ("config1", "defaults"),
    "config3_one_light": ("config3", "defaults"),
    "config4_mip_lod": ("config4", "mip_lod"),
    "config4_per_light": ("config4", "per_light"),
    "config4_reference": ("config4", "reference"),
}
SHADE_OPTIONS = {"defaults": {}, "partition_closest":
                 dict(partition_closest=True),
                 "resort_secondary": dict(resort_secondary=True),
                 "no_shadows": dict(enable_shadows=False),
                 "no_reflections": dict(enable_reflections=False),
                 "mip_lod": dict(mip_lod=True)}


@pytest.mark.parametrize("case", sorted(SHADE_FRAME_CASES))
def test_shade_frames_equal_plain_shade_frames(renderer, card, case,
                                               monkeypatch):
    """Eager 64x48 frames (config 4; config 5 with its refit, under a
    rotation) at the defaults and with partition_closest,
    resort_secondary, shadows off and reflections off; config 1 (flat
    albedo), config 3 (one light), and config 4 with mip_lod, with the
    per-light shadow dispatch and on the reference backend: the frame and
    ray count with kernel L equal those with its plain versions forced in
    the engine, bit for bit; kernel L launches each step once a depth
    (no shade_lights with flat albedo), the plain versions none."""
    conf, option = SHADE_FRAME_CASES[case]
    make = {"config1": C.config1_primary, "config3": C.config3_reflections,
            "config4": C.config4_flythrough,
            "config5": C.config5_stress}[conf]
    cfg = dataclasses.replace(make(), width=64, height=48,
                              **SHADE_OPTIONS.get(option, {}))
    r = Renderer(renderer.model, cfg, card, quantize=True, rebuild="refit",
                 backend="reference" if option == "reference" else "dense",
                 graph=False)
    if option == "per_light":
        r.backend = r.backend._replace(per_light=True)
    cam = start_camera()
    tf = rot_y(0.05) if cfg.rebuild_per_frame else None
    depth = 1 if cfg.flat_albedo else cfg.max_depth
    want_l = {k: 0 if cfg.flat_albedo and k == "shade_lights" else depth
              for k in SHADE_STEPS}
    for _ in range(3):     # the profiler may drop a record (counted_again)
        got, on_card, host = counted(lambda: r.render_async(cam, tf))
        if {k: on_card.get(k, 0) for k in SHADE_STEPS} == want_l:
            break
    assert {k: on_card.get(k, 0) for k in SHADE_STEPS} == want_l
    assert {k: host.get(k, 0) for k in SHADE_STEPS} == want_l
    for k, plain in zip(SHADE_STEPS, PLAIN_STEPS):
        monkeypatch.setattr(engine, k, plain)
    want, on_card, _ = counted(lambda: r.render_async(cam, tf))
    assert not any(on_card.get(k) for k in SHADE_STEPS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0


@pytest.fixture(scope="module")
def full_raster_tree(card):
    """The full scene's cluster tree on the card (the raster cell's)."""
    from vkrt_tpu_torch.scene import flatten_model
    from vkrt_tpu_torch.wavefront.engine import make_backend
    return make_backend(flatten_model(procedural_model("full", seed=0)),
                        "dense", card).tree


def clip_case(tree, card, case):
    """The 1600x1200 raster setup at `case`'s pose (the start pose, the
    wall pose, fly path frames 110 and 160; "soup": chip_smoke.py's
    crossing soup from the start pose instead of `tree`; "-all": every
    live slot marked, not only those crossing w = 0) and the slots kernel
    J clips: a corner at w <= 1e-9, another in front, setup rows kept."""
    w, h = 1600, 1200
    pose = case.split("-")[0]
    if pose.startswith("fly"):
        cam = list(camera_path(w, h))[int(pose[3:])]
    elif pose == "wall":
        cam = Camera(w, h)
        cam.set_position((2.0, 3.0, -10.2))
        cam.set_rotation((0.0, 3.0, 0.0))
    else:
        cam = Camera(w, h)
        cam.set_position(C.CAMERA_START_POSITION)
        cam.set_rotation(C.CAMERA_START_ROTATION)
    if pose == "soup":
        tree = crossing_soup(cam, card)
    view = torch.as_tensor(cam.view_matrix, device=card)
    proj = torch.as_tensor(cam.projection_matrix, device=card)
    setup, _, clb = edge.build_raster_setup(tree, view, proj, w, h)
    if case.endswith("-all"):
        return setup, (setup[..., :9] != 0).any(-1), clb, w, h
    return setup, crossing_slots(tree, setup, view, proj), clb, w, h


@pytest.mark.parametrize("case", ["start", "wall", "fly110", "fly160",
                                  "start-all", "soup"])
def test_clip_matches_plain(full_raster_tree, card, case):
    """Kernel J (clip_boxes on CUDA tensors) vs clip_boxes_plain on the
    same setup copied to the CPU: every slot's lo x, lo y, hi x, hi y and
    zmin bit-equal, one launch counted; unmarked slots get the empty box;
    a marked slot's box lies in the screen; the setup's cluster boxes
    hold each crossing slot's (its cluster: slot // 128). The cases hold
    what they are there for: slots crossing w = 0 at every pose, and
    sheets that reach the screen in the soup and, over every live slot,
    at the start pose (along the fly path none does)."""
    setup, crossing, clb, w, h = clip_case(full_raster_tree, card, case)
    before = clip_boxes.launches
    got = clip_boxes(setup, crossing, w, h)
    torch.cuda.synchronize()
    assert clip_boxes.launches == before + 1
    want = clip_boxes_plain(setup.cpu(), crossing.cpu(), w, h)
    assert torch.equal(got.cpu(), want)
    assert int(crossing.sum()) > 100
    empty = torch.tensor([1e8, 1e8, -1e8, -1e8, 1e8], device=card)
    assert (got[:, ~crossing] == empty[:, None]).all()
    kept = crossing & (got[0] <= got[2])
    lo_x, lo_y, hi_x, hi_y, zmin = got[:, kept]
    assert ((lo_x >= 0) & (hi_x <= w) & (lo_y >= 0) & (hi_y <= h)).all()
    assert ((zmin >= 0) & (zmin <= 1)).all()
    assert kept.any() == (case in ("soup", "start-all"))
    if case.endswith("-all"):
        return
    box = clb.permute(1, 0, 2).reshape(8, -1)
    c = torch.nonzero(kept.reshape(-1), as_tuple=True)[0] // 128
    assert ((box[0][c] <= lo_x) & (box[1][c] <= lo_y) & (box[3][c] >= hi_x)
            & (box[4][c] >= hi_y) & (box[2][c] <= zmin)).all()


def test_kernel_g_on_clipped_boxes_equals_full_screen_rule(card):
    """Kernel G's zmin walk on the boxes kernel J gives the clusters of
    chip_smoke.py's crossing soup (sheets across w = 0 that win most of
    the frame, zmin above 0) equals G on the same clusters with
    full-screen boxes and zmin 0 (the rule before J) and the plain
    version, every output, at 320x240 in the first round and behind
    every hit."""
    w, h = 320, 240
    cam = Camera(w, h)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    tree = crossing_soup(cam, card)
    view = torch.as_tensor(cam.view_matrix, device=card)
    proj = torch.as_tensor(cam.projection_matrix, device=card)
    setup, scb, clb = edge.build_raster_setup(tree, view, proj, w, h)
    cross = crossing_slots(tree, setup, view, proj).any(1)
    box = clb.permute(1, 0, 2).reshape(8, -1).clone()
    assert int(cross.sum()) > 10 and (box[2][cross] > 0).any()
    for row, value in ((0, -1e8), (1, -1e8), (2, 0.0), (3, 1e8), (4, 1e8),
                       (5, 1e8)):
        box[row] = torch.where(cross, value, box[row])
    n_sc = clb.shape[0]
    oclb = box.reshape(8, n_sc, -1).permute(1, 0, 2).contiguous()
    oscb = scb.clone()
    oscb[0:3, :n_sc] = oclb[:, 0:3].amin(dim=2).T
    oscb[3:6, :n_sc] = oclb[:, 3:6].amax(dim=2).T
    cfg = dataclasses.replace(C.reference_config(), width=w, height=h)
    px, py, inside = sample_pixel_lanes(cfg, tuple(MSAA8[2]), card)
    zf = torch.where(inside, 0.0, edge.ZFAR_PARK)
    for _ in range(2):
        got = edge.raster_edge(setup, scb, clb, px, py, zf)
        want = edge.raster_edge(setup, oscb, oclb, px, py, zf)
        plain = edge.raster_edge_plain(setup, scb, clb, px, py, zf)
        for g, o, p in zip(got, want, plain):
            assert torch.equal(g, o) and torch.equal(g, p)
        assert (got[1] >= 0).any()
        zf = torch.where(got[1] >= 0, got[0], edge.ZFAR_PARK)


@pytest.mark.parametrize("graph", [False, None])
def test_quantized_raster_frame_equals_plain_round_frame(renderer, card,
                                                         graph, monkeypatch):
    """Rasterizer(quantize=True) at 64x48, eagerly and as a CUDA graph
    (captured, then replayed), on three cameras of the fly path: the u8
    frames and visibility queries are bit-equal to the same frames made
    with raster_sample_round_plain as the round body."""
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    cams = [list(camera_path(64, 48))[k] for k in (0, 60, 130)]
    r = Rasterizer(renderer.model, cfg, card, quantize=True, graph=graph)
    with monkeypatch.context() as m:
        m.setattr(rp, "raster_sample_round", rs.raster_sample_round_plain)
        plain = Rasterizer(renderer.model, cfg, card, quantize=True,
                           graph=False)
        wants = [plain.render_async(cam) for cam in cams]
    before = rs.raster_sample_round.launches
    for _ in range(2):
        for cam, want in zip(cams, wants):
            got = r.render_async(cam)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
    torch.cuda.synchronize()
    assert rs.raster_sample_round.launches - before == (
        2 * 32 if r.captured() else 6 * 32)
    assert r.captured() == (graph is None)
    r.free_graphs()


def test_raster_frame_on_card_matches_cpu(renderer):
    """The msaa-8 edge frame on the card (32 launches of G and of I a
    replayed frame, after the capture) against the same frame on the CPU (plain
    version)."""
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    cam = start_camera()
    rast = Rasterizer(renderer.model, cfg, renderer.device)
    rast.render(cam, show_fps=False)                 # the capture
    fb, card, host = counted(lambda: rast.render(cam, show_fps=False))
    assert card == {"raster_edge": 32, "raster_sample": 32,
                    "raster_clip": 1} and host == {}
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
    none of B a frame (a replay, after the capture); the frame and its
    ray count equal the kernel-B frame."""
    cam = start_camera()
    want, want_rays = renderer.render(cam)
    pl = Renderer(renderer.model, small_config(), renderer.device)
    pl.backend = pl.backend._replace(per_light=True)
    pl.render(cam)                                   # the capture
    (fb, rays), card, host = counted(lambda: pl.render(cam))
    assert card.get("trace_occluded") == 8 and "occl_multi" not in card
    assert host == {}
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
    before = cut_round.launches
    got = device_sah_order(*(x.to(card) for x in tris))
    assert cut_round.launches == before + 14       # a round a level
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", CUT_KINDS)
@pytest.mark.parametrize("nc", CUT_SIZES)
def test_kernel_h_matches_plain(card, nc, kind):
    """Kernel H (one launch) vs the plain `_cut_round` on the same CUDA
    tensors and on the CPU, rounded either way: the same new boundaries,
    bit for bit (one segment; single-chunk segments; segments past K2
    chunks, K2-aligned; padding-only chunks; exact ties, the lowest chunk
    winning; segments without a valid cut)."""
    host = cut_case(nc, kind)
    args = [x.to(card) for x in host]
    for fused in (False, True):
        before = cut_round.launches
        got = cut_round(*args, fused)
        assert cut_round.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, _cut_round(*args, fused)), fused
        assert torch.equal(got.cpu(), _cut_round(*host, fused)), fused


@pytest.fixture(scope="module")
def full_triangles():
    """(v0, e1, e2) of the full procedural scene (262,267 triangles, the
    per-frame rebuild's 2,049 chunks), CPU tensors."""
    from vkrt_tpu_torch.scene import flatten_model
    flat = flatten_model(procedural_model("full", seed=0))
    idx = np.asarray(flat.indices, dtype=np.int64)
    p = np.asarray(flat.positions, np.float32)
    v0 = p[idx[:, 0]]
    return [torch.as_tensor(x) for x in (v0, p[idx[:, 1]] - v0,
                                         p[idx[:, 2]] - v0)]


@pytest.mark.parametrize("opts", [
    {}, dict(axis_mode="extent"), dict(axis_mode="variance"),
    dict(axis_mode="slab"), dict(axis_mode="hybrid:4"),
    dict(axis_mode="sampled:8"), dict(cuts=2), dict(stable=False)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "shipped")
def test_device_sah_order_modes_on_card_match_cpu(card, full_triangles,
                                                  opts):
    """device_sah_order on the full scene, each mode: the card's order
    (kernel H a cut round: 14, or 10 + 4 x 2 with cuts=2) equals the
    CPU's."""
    want = device_sah_order(*full_triangles, **opts)
    before = cut_round.launches
    got = device_sah_order(*(x.to(card) for x in full_triangles), **opts)
    assert cut_round.launches - before == (18 if opts.get("cuts") else 14)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k", [None, 60], ids=["unmoved", "sway60"])
def test_morton_orders_on_card_match_cpu(card, full_triangles, k):
    """The Morton orders of the full scene (262,267 triangles) on the
    card equal the CPU's slot for slot: build_clusters(method="morton")
    in the engine's Morton range (Renderer.update_inputs: the scene's
    centroid box, its corners moved on the host) and build_lbvh, on the
    unmoved scene and under the benchmark's sway at path frame k = 60
    (0.1 sin(2 pi k / 240) rad about y), the triangles moved on each
    device as the engine moves them; so are the trees' cluster areas."""
    m = np.eye(4, dtype=np.float32)
    if k is not None:
        a = 0.1 * np.sin(2.0 * np.pi * k / 240)
        m[[0, 0, 2, 2], [0, 2, 0, 2]] = (np.cos(a), np.sin(a), -np.sin(a),
                                         np.cos(a))
    v0, e1, e2 = (x.numpy() for x in full_triangles)
    c = v0 + (e1 + e2) / 3.0
    corners = np.array([[x, y, z] for x in (c.min(0)[0], c.max(0)[0])
                        for y in (c.min(0)[1], c.max(0)[1])
                        for z in (c.min(0)[2], c.max(0)[2])], np.float32)
    corners = L.mat_rows3(corners, m[:3, :3]) + m[:3, 3]
    aabb = corners.min(axis=0), corners.max(axis=0)

    def orders(dev):
        mt = torch.as_tensor(m, device=dev)
        tris = [x.to(dev) for x in full_triangles]
        tris = [L.mat_rows3(tris[0], mt[:3, :3]) + mt[:3, 3],
                L.mat_rows3(tris[1], mt[:3, :3]),
                L.mat_rows3(tris[2], mt[:3, :3])]
        tree = clusters.build_clusters(*tris, method="morton", aabb=aabb)
        return (tree.leaf_tri.cpu(), build_lbvh(*tris).leaf_tri.cpu(),
                int(clusters.cluster_area_fixed(tree.cl_boxes)))

    want, got = orders("cpu"), orders(card)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2] == want[2] > 0


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


KERNEL_MODES = {"sub_gate": dict(sub_gate=True),
                "recheck": dict(pregate="recheck"),
                "both": dict(sub_gate=True, pregate="recheck")}


@pytest.mark.parametrize("mode", sorted(KERNEL_MODES))
def test_kernel_a_modes_equal_default_kernel(renderer, card, mode):
    """Kernel A in each mode: every output torch.equal to the default
    kernel's and to the plain version's, on scattered and camera rays;
    the mode's launches are counted."""
    tree = renderer.backend.tree
    kw = KERNEL_MODES[mode]
    for rays in ("scattered", "camera"):
        o, d, tmax = (random_rays(card, seed=5) if rays == "scattered"
                      else camera_rays(renderer, card))
        before = dict(trace_dense.mode_launches)
        got = trace_dense(tree, o, d, tmax, **kw)
        want = trace_dense(tree, o, d, tmax)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if rays == "scattered":        # as test_kernel_a_matches_plain
            for g, p in zip(got, trace_dense_plain(tree, o, d, tmax)):
                assert torch.equal(g, p)
        after = trace_dense.mode_launches
        assert after["sub_gate"] == before["sub_gate"] + ("sub_gate" in kw)
        assert after["recheck"] == before["recheck"] + ("pregate" in kw)


@pytest.mark.parametrize("mode", sorted(KERNEL_MODES))
@pytest.mark.parametrize("ns", [1, 4])
def test_kernel_b_modes_equal_default_kernel(renderer, card, mode, ns):
    """Kernel B in each mode, 1 and 4 segment sets: masks torch.equal to
    the default kernel's and the plain version's."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, seed=6)
    lights = renderer.lights[:ns].contiguous()
    st = torch.stack([tmax * (0.01 + 0.1 * s) for s in range(ns)])
    st[:, 0, :8] = 0.0009
    sd = torch.stack([d] * ns).contiguous()
    got = occluded_multi(tree, lights, sd, st, **KERNEL_MODES[mode])
    want = occluded_multi(tree, lights, sd, st)
    plain = occluded_multi_plain(tree, lights, sd, st)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, plain)
    assert got.any()


@pytest.mark.parametrize("flag", ["resort_secondary", "recheck_secondary",
                                  "partition_closest", "sub_gate_closest",
                                  "sub_gate_shadows"])
def test_secondary_option_frame_on_card_equals_default(renderer, flag):
    """A 64x48 config-4 frame on the card with each option: the default
    frame and ray grid, bit for bit."""
    cam = start_camera()
    pi = upload_matrix(cam.proj_inverse, renderer.device)
    vi = upload_matrix(cam.view_inverse, renderer.device)
    want = render_frame(renderer.backend, renderer.tex, pi, vi,
                        renderer.lights, small_config())
    got = render_frame(renderer.backend, renderer.tex, pi, vi,
                       renderer.lights, small_config(**{flag: True}))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- the JAX kernels' remaining modes: stats, ablate, the interval
# pregate, group_gate / sort, visit, and kernel A''s modes ---------------
ABLATE_MODES = {f"ablate_{a}": dict(ablate=a) for a in ABLATES[1:]}
A_NEW_MODES = {"interval": dict(pregate="interval"),
               "interval_sub_gate": dict(pregate=True, sub_gate=True),
               "group_gate_unsorted": dict(group_gate=True, sort=False),
               **ABLATE_MODES,
               "recheck_nosweep": dict(pregate="recheck", ablate="nosweep"),
               "recheck_nosort": dict(pregate="recheck", ablate="nosort"),
               "interval_nodma": dict(pregate="interval", ablate="nodma"),
               "interval_onlysc": dict(pregate="interval", ablate="onlysc"),
               "interval_nosort": dict(pregate="interval", ablate="nosort")}
A1_MODES = {"sub_gate": dict(sub_gate=True),
            "recheck": dict(pregate="recheck"),
            "interval": dict(pregate="interval"),
            "interval_nosort": dict(pregate="interval", ablate="nosort"),
            **ABLATE_MODES}
B_NEW_MODES = {"visit_mid": dict(visit="mid"), "visit_far": dict(visit="far"),
               "visit_mid_nosort": dict(visit="mid", ablate="nosort"),
               "interval": dict(pregate="interval"),
               "interval_sub_gate": dict(pregate=True, sub_gate=True),
               "group_gate_unsorted": dict(group_gate=True, sort=False),
               "interval_nosort": dict(pregate="interval", ablate="nosort"),
               "interval_visit_mid": dict(pregate="interval", visit="mid"),
               "recheck_visit_far": dict(pregate="recheck", sort=False,
                                         visit="far"),
               **ABLATE_MODES}
STATS_MODES = {"default": {}, "sub_gate": dict(sub_gate=True),
               "recheck": dict(pregate="recheck"),
               "interval": dict(pregate="interval"),
               "nosweep": dict(ablate="nosweep"),
               "nosort": dict(ablate="nosort"),
               "onlysc": dict(ablate="onlysc"),
               "nodma": dict(ablate="nodma")}


def mode_of(kw):
    """(pregate, ablate) as the wrappers normalise them."""
    pregate = dense._pregate(kw.get("pregate", False))
    return pregate, dense._ablate(kw.get("ablate", ""), pregate)


def plain_lists_kw(tree, o, d, tmax, kw, block=512, point_origin=False):
    """The plain versions' list keywords for kernel A's / A''s mode."""
    pregate, _ = mode_of(kw)
    lists = (closest_worklists(tree, o, d, tmax, block=block,
                               point_origin=point_origin)
             if pregate else None)
    return dense._plain_lists(tree, lists, pregate), lists


def missed(out) -> list:
    """Kernel A's outputs of a walk that commits nothing."""
    t, slot = out[0], out[1]
    return [torch.full_like(t, torch.inf), torch.full_like(slot, -1)] + [
        torch.zeros_like(x) for x in out[2:]]


@pytest.mark.parametrize("mode", sorted(A_NEW_MODES))
def test_kernel_a_new_modes_match_default_and_plain(renderer, card, mode):
    """Kernel A in each mode: every output torch.equal to the default
    kernel's (a cut: every ray a miss) and to the plain version's in the
    same mode, on scattered and camera rays; the mode's launches are
    counted."""
    tree = renderer.backend.tree
    kw = A_NEW_MODES[mode]
    pregate, ablate = mode_of(kw)
    for rays in ("scattered", "camera"):
        o, d, tmax = (random_rays(card, seed=15) if rays == "scattered"
                      else camera_rays(renderer, card))
        before = dict(trace_dense.mode_launches)
        got = trace_dense(tree, o, d, tmax, **kw)
        want = trace_dense(tree, o, d, tmax)
        lkw, _ = plain_lists_kw(tree, o, d, tmax, kw)
        plain = trace_dense_plain(tree, o, d, tmax, ablate=ablate,
                                  sub_gate=kw.get("sub_gate", False), **lkw)
        torch.cuda.synchronize()
        assert (want[1] >= 0).any()
        if ablate in CUTS:
            want = missed(want)
        for g, w, p in zip(got, want, plain):
            assert torch.equal(g, w) and torch.equal(g, p)
        after = trace_dense.mode_launches
        if ablate:
            key = f"ablate_{ablate}"
            assert after[key] == before[key] + 1
        assert after["interval"] == before["interval"] + (
            pregate == "interval")
        assert after["group_gate"] == before["group_gate"] + (
            "group_gate" in kw)


def check_stats(tree, o, d, tmax, far, st, kw, block, point_origin=False,
                lists=None):
    """A kernel's stats i32[N/block, 2] against the plain version: lane 0
    equal, lane 1 within `sweep_bounds` (exact where no sweep commits)."""
    pregate, ablate = mode_of(kw)
    want0 = stats_lane0_of(tree, o, d, tmax, block=block,
                           point_origin=point_origin, pregate=pregate,
                           ablate=ablate)
    assert torch.equal(st[:, 0], want0)
    full = broadcast_points(o, d, block) if point_origin else o
    n = tmax.numel()
    lo, hi = sweep_bounds(tree, full.reshape(3, n), d.reshape(3, n),
                          tmax.reshape(n), far.reshape(n), block,
                          **dense._plain_lists(tree, lists, pregate))
    lane1 = st[:, 1]
    if ablate in CUTS and ablate != "nosweep":
        assert not lane1.any()
    else:
        assert (lo <= lane1).all() and (lane1 <= hi).all(), (lo, lane1, hi)
        if ablate == "nosweep" and not pregate:
            assert torch.equal(lane1, hi) and torch.equal(lo, hi)
    return lo, lane1, hi


@pytest.mark.parametrize("mode", sorted(STATS_MODES))
@pytest.mark.parametrize("block", [256, 512])
def test_kernel_a_stats_match_plain(renderer, card, mode, block):
    """Kernel A with stats=True: the usual outputs equal the same call's
    without stats; lane 0 equals the plain work-list length (the JAX
    kernel's); lane 1 lies within the plain version's bounds."""
    tree = renderer.backend.tree
    kw = STATS_MODES[mode]
    for rays in ("scattered", "camera"):
        o, d, tmax = (random_rays(card, seed=16) if rays == "scattered"
                      else camera_rays(renderer, card))
        got = trace_dense(tree, o, d, tmax, block=block, stats=True, **kw)
        want = trace_dense(tree, o, d, tmax, **kw)
        assert len(got) == 6 and got[5].shape == (tmax.numel() // block, 2)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        far = torch.where(got[1] >= 0, got[0], tmax)
        _, lists = plain_lists_kw(tree, o, d, tmax, kw)
        lo, lane1, hi = check_stats(tree, o, d, tmax, far, got[5], kw, block,
                                    lists=lists)
        if not mode_of(kw)[1]:
            assert (got[5][:, 0] > 0).all() and (lane1 > 0).any()


@pytest.mark.parametrize("mode", sorted(A1_MODES) + ["stats"])
@pytest.mark.parametrize("block", [0, 512])
def test_kernel_a_prime_modes_match_default_and_plain(renderer, card, mode,
                                                      block):
    """Kernel A' in each mode, per-ray origins (block 0) and one origin
    per 512 rays: masks equal the default kernel's (a cut: none blocked)
    and the plain version's in the mode; outputs coded; stats as A's."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, seed=17)
    tmax = torch.where(tmax > 0, 12.0, 0.0)
    kw = dict(stats=True) if mode == "stats" else A1_MODES[mode]
    pk = dict(block=512, point_origin=True) if block else {}
    if block:
        pts = o.reshape(3, -1)[:, ::block].T.contiguous()
        full = broadcast_points(pts, d, block)
    else:
        pts = full = o
    before = trace_occluded.launches
    got = trace_occluded(tree, pts, d, tmax, **pk, **kw)
    want = trace_occluded(tree, pts, d, tmax, **pk)
    assert trace_occluded.launches == before + 2
    pregate, ablate = mode_of(kw)
    lkw, lists = plain_lists_kw(tree, pts, d, tmax, kw, block=block or 512,
                                point_origin=bool(block))
    plain = trace_occluded_plain(tree, full, d, tmax, ablate=ablate,
                                 sub_gate=kw.get("sub_gate", False), **lkw)
    torch.cuda.synchronize()
    blocked = want[1] >= 0
    assert 0.05 < blocked.float().mean().item() < 0.95
    if ablate in CUTS:
        blocked = torch.zeros_like(blocked)
    assert torch.equal(got[1] >= 0, blocked) and torch.equal(plain, blocked)
    assert occluded_coded(got[:4], blocked)
    if mode == "stats":
        far = torch.where(blocked, 0.0, tmax)
        check_stats(tree, pts, d, tmax, far, got[4], kw, 512,
                    point_origin=bool(block))
    # trace_dense(occlusion=True) is the same kernel in the same mode
    via = trace_dense(tree, pts, d, tmax, occlusion=True,
                      with_attributes=False, **pk, **kw)
    assert torch.equal(via[1], got[1])


@pytest.mark.parametrize("mode", sorted(B_NEW_MODES))
@pytest.mark.parametrize("ns", [1, 4])
def test_kernel_b_new_modes_match_default_and_plain(renderer, card, mode,
                                                    ns):
    """Kernel B in each mode, 1 and 4 segment sets: masks torch.equal to
    the default kernel's (a cut: none blocked) and the plain version's in
    the mode; the mode's launches are counted."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, seed=18)
    lights = renderer.lights[:ns].contiguous()
    st = torch.stack([tmax * (0.01 + 0.1 * s) for s in range(ns)])
    st[:, 0, :8] = 0.0009
    sd = torch.stack([d] * ns).contiguous()
    kw = B_NEW_MODES[mode]
    pregate, ablate = mode_of(kw)
    before = dict(occluded_multi.mode_launches)
    got = occluded_multi(tree, lights, sd, st, **kw)
    want = occluded_multi(tree, lights, sd, st)
    lists = multi_worklists(tree, lights, sd, st) if pregate else None
    plain = occluded_multi_plain(tree, lights, sd, st, lists=lists,
                                 pregate=pregate, ablate=ablate,
                                 sub_gate=kw.get("sub_gate", False))
    torch.cuda.synchronize()
    assert want.any()
    if ablate in CUTS:
        want = torch.zeros_like(want)
    assert torch.equal(got, want) and torch.equal(got, plain)
    after = occluded_multi.mode_launches
    for key in ("visit_mid", "visit_far"):
        assert after[key] == before[key] + (kw.get("visit") == key[6:])


def test_kernels_build_under_the_cache_variable(renderer, card, tmp_path,
                                                monkeypatch):
    """VKRT_TORCH_CACHE moves the kernels' build root: a fresh build there,
    loaded in place of the default one, gives kernel A's outputs."""
    tree = renderer.backend.tree
    o, d, tmax = random_rays(card, seed=19)
    want = trace_dense(tree, o, d, tmax)
    monkeypatch.setenv("VKRT_TORCH_CACHE", str(tmp_path))
    kernels.library.cache_clear()
    try:
        info = kernels.build()
        assert not info.cached and info.path.is_relative_to(tmp_path)
        got = trace_dense(tree, o, d, tmax)
        torch.cuda.synchronize()
    finally:
        monkeypatch.delenv("VKRT_TORCH_CACHE")
        kernels.library.cache_clear()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --- frames as CUDA graphs (graphs.py) ------------------------------------
def graph_twin(r):
    """Copies of renderer `r`: eager (graph=False) and on the default
    path (a CUDA graph per static key), the latter with graphs of its
    own."""
    e, g = copy.copy(r), copy.copy(r)
    e.graph = False
    g.graph, g.graphs = None, graphs.FrameGraph()
    return e, g


def two_cameras():
    return [start_camera(), list(camera_path(64, 48))[3]]


CASES = {"config1": (C.config1_primary, "refit"),
         "config2": (C.config2_shadows, "refit"),
         "config3": (C.config3_reflections, "refit"),
         "config4": (C.config4_flythrough, "refit"),
         **{f"config5_{m}": (C.config5_stress, m) for m in REBUILD_MODES}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_frames_equal_eager_frames(renderer, case):
    """Configs 1-5 (config 5 in each rebuild mode, under two transforms)
    at 64x48: the replayed frames and ray counts equal the eager ones of
    the same camera bit for bit, two cameras give two frames. Launches:
    an eager frame's run on the card as its wrappers count them (kernel
    H 14 times in config 5's full rebuild, else never); the
    first graph frame runs them twice on the card (warm-up and replay)
    and counts them twice on the host (warm-up and capture); a replay
    runs them once on the card and counts nothing."""
    make, mode = CASES[case]
    cfg = dataclasses.replace(make(), width=64, height=48)
    r = Renderer(renderer.model, cfg, renderer.device, quantize=True,
                 rebuild=mode)
    eager, graph = graph_twin(r)
    assert graph.captured() and not eager.captured()
    tfs = [None, None]
    if cfg.rebuild_per_frame:
        tfs = [rot_y(0.05), rot_y(0.15)]
    frames = []
    for k, (cam, tf) in enumerate(zip(two_cameras(), tfs)):
        want, card, host = counted(lambda: eager.render_async(cam, tf))
        assert card == host and card["trace_closest"] > 0
        assert card.get("sah_cut", 0) == (14 if mode == "full" else 0)
        got, g_card, g_host = counted(lambda: graph.render_async(cam, tf))
        assert g_card == (twice(card) if k == 0 else card)
        assert g_host == (twice(card) if k == 0 else {})
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        frames.append(got[0])
    assert len(graph.graphs) == 1 and graph.graphs.capture_ms()
    assert not torch.equal(frames[0], frames[1])


@pytest.mark.parametrize("msaa", [1, 8])
def test_graph_raster_frames_equal_eager_frames(renderer, msaa):
    """The edge raster frame at msaa 1 and 8 (4 x msaa launches of G and
    of I):
    replayed frames equal the eager ones on two cameras."""
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    eager, graph = graph_twin(Rasterizer(renderer.model, cfg,
                                         renderer.device, msaa=msaa))
    frames = []
    for k, cam in enumerate(two_cameras()):
        want, card, host = counted(lambda: eager.render_async(cam))
        assert card == host == {"raster_edge": 4 * msaa,
                                "raster_sample": 4 * msaa, "raster_clip": 1}
        got, g_card, g_host = counted(lambda: graph.render_async(cam))
        assert g_card == (twice(card) if k == 0 else card)
        assert g_host == (twice(card) if k == 0 else {})
        assert torch.equal(got, want)
        frames.append(got)
    assert not torch.equal(frames[0], frames[1])


def test_graph_sharded_frames_equal_eager_frames(renderer, card):
    """render_frame_sharded and render_raster_frame_sharded on
    ["cuda:0"] * 2 with their replicas: one graph per shard (and the
    raster setup's), frames equal the eager sharded and unsharded ones
    on two cameras; a replayed frame runs twice the unsharded frame's
    launches on the card and counts none on the host. Without replicas
    the default is eager."""
    r = Renderer(renderer.model, small_config(), card)
    mesh = make_mesh(["cuda:0"] * 2)
    reps = replicate((r.backend, r.tex, r.lights), mesh)
    rreps = replicate(r.tex, mesh)
    for k, cam in enumerate(two_cameras()):
        mats = [upload_matrix(m, card) for m in (cam.proj_inverse,
                                                 cam.view_inverse)]
        want, n_one, _ = counted(lambda: render_frame(
            r.backend, r.tex, *mats, r.lights, r.cfg))
        got, n_two, host = counted(lambda: render_frame_sharded(
            r.backend, r.tex, *mats, r.lights, r.cfg, mesh, replicas=reps))
        eager = render_frame_sharded(r.backend, r.tex, *mats, r.lights,
                                     r.cfg, mesh, replicas=reps, graph=False)
        assert n_two == twice(twice(n_one) if k == 0 else n_one)
        assert host == (twice(twice(n_one)) if k == 0 else {})
        _, card_once, host_once = counted(lambda: render_frame_sharded(
            r.backend, r.tex, *mats, r.lights, r.cfg, mesh))
        assert card_once == host_once == twice(n_one)   # no replicas: eager
        for x in (want, eager):
            assert torch.equal(got[0], x[0]) and torch.equal(got[1], x[1])
        view, proj = (upload_matrix(m, card) for m in (cam.view_matrix,
                                                       cam.projection_matrix))
        want = render_raster_frame_edge(r.backend.tree, r.tex, view, proj,
                                        r.cfg)
        got = render_raster_frame_sharded(r.backend.tree, r.tex, view, proj,
                                          r.cfg, mesh, msaa=8,
                                          replicas=rreps)
        assert torch.equal(got, want)
    assert len(reps.graphs) == 2 and len(rreps.graphs) == 3


def test_graph_calls_return_their_own_tensors(renderer):
    """Three render_async calls in a row: three distinct frames, each
    equal to its eager frame (callers hold several frames at once)."""
    eager, graph = graph_twin(renderer)
    cams = list(camera_path(64, 48))[:3]
    outs = [graph.render_async(cam) for cam in cams]
    assert len({o[0].data_ptr() for o in outs}) == 3
    for cam, (fb, rays) in zip(cams, outs):
        want = eager.render_async(cam)
        assert torch.equal(fb, want[0]) and torch.equal(rays, want[1])


def test_graph_memory_stays_flat_over_replays(renderer):
    """20 replays allocate nothing that outlives them."""
    _, graph = graph_twin(renderer)
    cam = start_camera()
    graph.render_async(cam)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(20):
        graph.render_async(cam)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    graph.free_graphs()
    assert len(graph.graphs) == 0


def test_graph_true_raises_where_frames_wait_on_the_host(renderer, card):
    """The reference backend and recheck_secondary stay eager under
    graph=None and raise under graph=True."""
    with pytest.raises(ValueError, match="reference backend"):
        Renderer(renderer.model, small_config(), card, backend="reference",
                 graph=True)
    r = Renderer(renderer.model, small_config(recheck_secondary=True), card)
    assert not r.captured()
    r.graph = True
    with pytest.raises(ValueError, match="recheck_secondary"):
        r.render_async(start_camera())


@pytest.mark.parametrize("case", ["config4", "config5_full",
                                  "config5_refit"])
def test_traced_replays_put_every_kernel_in_a_leaf_span(renderer, card,
                                                        case):
    """A frame captured with tracing on (tracing.py), replayed 3 times
    under torch.profiler: the marks split the device ops into whole
    frames of the graph's span table (tracing.device_spans), each the
    ops of one of the 3 graph launches, every kernel of a replay falls
    inside a span below `frame` (none in `frame` itself; a full
    rebuild's `accel_update` holds `accel_order` and runs the transform
    and the packing itself; a refit's holds one `accel_refit`, which
    runs all of the refit; the area counter runs in `accel_area`, after
    `accel_update`), each runs some; the
    counters of the 3 replays are 3 times those of the same frame traced
    eagerly, whose ray counters add up to its ray count; the frames are
    the untraced graph's bits. The profiler can drop a replay's records
    (on an H100, 1 of 3 replays in both cases in one process of seven),
    and device_spans then leaves that replay out: at least one of the
    3 is whole."""
    from torch.profiler import ProfilerActivity, profile

    make, mode = CASES[case]
    cfg = dataclasses.replace(make(), width=64, height=48)
    r = Renderer(renderer.model, cfg, card, quantize=True, rebuild=mode)
    eager, graph = graph_twin(r)
    cam, tf = start_camera(), (rot_y(0.05) if cfg.rebuild_per_frame
                               else None)
    plain = graph.render_async(cam, tf)
    tracing.reset()
    with tracing.on():
        want_fb, want_rays = eager.render_async(cam, tf)
        want = {k: v for k, v in tracing.counters(card).items() if v}
        graph.render_async(cam, tf)                   # captured, marked
        torch.cuda.synchronize()
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outs = [graph.render_async(cam, tf) for _ in range(3)]
            torch.cuda.synchronize()
        got = tracing.counters(card)
    assert len(graph.graphs) == 2                     # traced: its own key
    (table,) = graph.graphs.tables().values()
    assert sum(v for k, v in want.items()
               if k != "accel_cl_area"
               and not k.startswith("sample_fetch_d")) == int(want_rays)
    assert ("accel_cl_area" in want) == cfg.rebuild_per_frame
    assert {k: v for k, v in got.items() if v} == {k: 3 * v
                                                  for k, v in want.items()}
    ops, host = tracing.profile_ops(prof)
    frames = tracing.device_spans(ops, table)
    launches = [h[3] for h in host if "GraphLaunch" in h[0]]
    assert len(launches) == 3 and 1 <= len(frames) <= 3
    assert len({f[0].group for f in frames}) == len(frames)
    assert {f[0].group for f in frames} <= set(launches)
    for spans in frames:
        parents = {s.parent for s in spans}
        assert [s.name for s in spans if s.name in parents] == (
            ["frame", "accel_update"] if cfg.rebuild_per_frame
            else ["frame"])
        assert spans[0].ops == 0 and spans[0].self_ms == 0.0
        refit = cfg.rebuild_per_frame and mode == "refit"
        assert [s.parent for s in spans if s.name == "accel_refit"] == (
            ["accel_update"] if refit else [])
        leaf = {}
        for s in spans[1:]:
            leaf[s.name] = leaf.get(s.name, 0) + s.ops
        if refit:
            assert leaf.pop("accel_update") == 0
            assert "accel_refit" in leaf
        assert all(n > 0 for n in leaf.values()), leaf
        assert ("accel_area" in leaf) == cfg.rebuild_per_frame
        assert ("accel_update" in leaf) == ("accel_order" in leaf) == (
            cfg.rebuild_per_frame and mode != "refit")
        assert {s.parent for s in spans if s.name == "accel_area"} <= {
            "frame"}
    for fb, rays in outs + [(want_fb, want_rays)]:
        assert torch.equal(fb, plain[0]) and torch.equal(rays, plain[1])
    graph.free_graphs()


def test_graph_quantized_raster_frames_equal_eager_frames(renderer):
    """Rasterizer(quantize=True) at 64x48, msaa 8: the replayed (u8
    frame, visibility queries) equal the eager ones on two cameras, the
    u8 frame the truncating cast of the f32 frame, the queries every
    pixel of every sample at least; the f32 graph and the quantized one
    are two keys."""
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    r = Rasterizer(renderer.model, cfg, renderer.device, quantize=True)
    eager, graph = graph_twin(r)
    f32 = Rasterizer(renderer.model, cfg, renderer.device)
    for cam in two_cameras():
        want = eager.render_async(cam)
        got = graph.render_async(cam)
        assert got[0].dtype == torch.uint8 and got[1].ndim == 0
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        cast = torch.clamp(f32.render_async(cam) * 255.0 + 0.5, 0.0,
                           255.0).to(torch.uint8)
        assert torch.equal(got[0], cast)
        assert int(got[1]) >= 64 * 48 * 8
    assert len(graph.graphs) == 1
    graph.free_graphs()


def test_traced_raster_replays_count_n_times_one_frame(renderer, card):
    """A quantized raster frame captured with tracing on, replayed 3
    times: the counters raster_live_r0..3 and raster_fetch_r0..3 read 3
    times those of the same frame traced eagerly, the live ones adding up
    to its visibility queries and each fetch count at most its live
    count; the table holds G's and I's 32 launches' lanes; the frames are
    the untraced graph's bits."""
    cfg = dataclasses.replace(C.reference_config(), width=64, height=48)
    r = Rasterizer(renderer.model, cfg, card, quantize=True)
    eager, graph = graph_twin(r)
    cam = list(camera_path(64, 48))[130]
    plain = graph.render_async(cam)
    tracing.reset()
    with tracing.on():
        want_fb, want_n = eager.render_async(cam)
        want = {k: v for k, v in tracing.counters(card).items() if v}
        graph.render_async(cam)                       # captured, marked
        torch.cuda.synchronize()
        tracing.reset()
        outs = [graph.render_async(cam) for _ in range(3)]
        torch.cuda.synchronize()
        got = tracing.counters(card)
    assert len(graph.graphs) == 2
    (table,) = graph.graphs.tables().values()
    assert set(want) >= {"raster_live_r0", "raster_live_r1",
                         "raster_fetch_r0"}
    assert all(k.startswith(("raster_live_r", "raster_fetch_r",
                             "raster_clip_")) for k in want)
    assert want.get("raster_clip_kept", 0) <= want.get("raster_clip_cross", 0)
    assert sum(v for k, v in want.items()
               if k.startswith("raster_live_r")) == int(want_n)
    for r in range(rp.MAX_DISCARD_ROUNDS):
        assert want.get(f"raster_fetch_r{r}", 0) <= want.get(
            f"raster_live_r{r}", 0)
    assert {k: v for k, v in got.items() if v} == {k: 3 * v
                                                  for k, v in want.items()}
    assert [k for k, _, _ in table.lanes] == ["raster_edge",
                                              "raster_sample"] * 32
    for fb, n in outs + [(want_fb, want_n)]:
        assert torch.equal(fb, plain[0]) and torch.equal(n, plain[1])
    graph.free_graphs()
