"""vkrt_tpu_torch trace kernels' plain versions vs the JAX Pallas kernels.

Kernel A (closest hit + attributes) and kernel B (multi-light occlusion)
run here as their plain PyTorch versions — the CPU path of each wrapper —
on the small procedural scene, against `vkrt_tpu.rt.dense.trace_dense`
and `vkrt_tpu.rt.occl_multi.occluded_multi` in interpret mode on the
same tree, carried across with `tree_from_numpy`, and against the
brute-force numpy oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as C
from vkrt_tpu.accel.clusters import build_clusters as jax_build_clusters
from vkrt_tpu.accel.clusters import scene_attrs as jax_scene_attrs
from vkrt_tpu.app.camera import Camera
from vkrt_tpu.golden.cpu_tracer import closest_hit as brute_closest
from vkrt_tpu.golden.cpu_tracer import generate_camera_rays
from vkrt_tpu.golden.cpu_tracer import occluded as brute_occluded
from vkrt_tpu.rt.dense import trace_dense as jax_trace_dense
from vkrt_tpu.rt.occl_multi import occluded_multi as jax_occluded_multi
from vkrt_tpu.scene import flatten_model
from vkrt_tpu_torch.accel.clusters import tree_from_numpy
from vkrt_tpu_torch.rt.dense import trace_dense, trace_dense_plain
from vkrt_tpu_torch.rt.occl_multi import occluded_multi
from vkrt_tpu_torch.scene.procedural import procedural_model
import torch_support  # noqa: F401

N_RAYS = 2048


@pytest.fixture(scope="module")
def scene():
    flat = flatten_model(procedural_model("small", seed=0))
    idx = np.asarray(flat.indices, dtype=np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0
    jtree = jax_build_clusters(jnp.asarray(v0), jnp.asarray(e1),
                               jnp.asarray(e2), attrs=jax_scene_attrs(flat),
                               with_attributes=True, device=False)
    ttree = tree_from_numpy(*(np.asarray(a) for a in jtree), device="cpu")
    return v0, e1, e2, jtree, ttree


def make_rays(n=N_RAYS, seed=7):
    """Camera rays from the start pose (first half) plus scattered rays
    from inside the hall (second half), ~20% parked (tmax = 0)."""
    rng = np.random.default_rng(seed)
    cam = Camera(64, 16)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    co, cd = generate_camera_rays(64, 16, cam.proj_inverse, cam.view_inverse)
    co, cd = co[: n // 2], cd[: n // 2]
    so = rng.uniform([-15, 0, -9], [15, 12, 10], (n - n // 2, 3))
    sd = rng.normal(size=(n - n // 2, 3))
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    o = np.concatenate([co, so]).astype(np.float32)
    d = np.concatenate([cd, sd]).astype(np.float32)
    tmax = np.where(rng.random(n) < 0.2, 0.0, C.RAY_TMAX).astype(np.float32)
    return o, d, tmax


def lanes(o, d, tmax):
    """Row-major rays → lane-major ([3,Nb,128] / [Nb,128]) numpy."""
    cv = lambda x: np.moveaxis(x.reshape(-1, 128, 3), -1, 0).copy()
    return cv(o), cv(d), tmax.reshape(-1, 128).copy()


@pytest.mark.parametrize("block", [512, 1024])
def test_closest_plain_matches_jax_kernel(scene, block):
    _, _, _, jtree, ttree = scene
    o, d, tmax = lanes(*make_rays())
    jt, js, ju, jv, ja = (np.asarray(x) for x in jax_trace_dense(
        jtree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        block=block, with_attributes=True, interpret=True))
    tt, ts, tu, tv, ta = (x.numpy() for x in trace_dense(
        ttree, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tmax)))
    np.testing.assert_array_equal(ts >= 0, js >= 0)
    both = (ts >= 0) & (js >= 0)
    assert both.sum() > 0.4 * both.size
    np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)
    same = both & (ts == js)
    assert same.sum() >= 0.99 * both.sum()
    # the attribute select is a load: bit-equal where the slots agree
    np.testing.assert_array_equal(ta[:, same], ja[:, same])
    np.testing.assert_allclose(tu[same], ju[same], atol=1e-5)
    np.testing.assert_allclose(tv[same], jv[same], atol=1e-5)
    # misses: t = inf, slot = -1, u = v = 0, attrs = 0 (parked rays too)
    miss = ts < 0
    assert np.isinf(tt[miss]).all()
    assert (tu[miss] == 0).all() and (ta[:, miss] == 0).all()
    assert miss[tmax == 0].all()


def test_closest_plain_matches_brute_oracle(scene):
    v0, e1, e2, _, ttree = scene
    o, d, tmax = make_rays(seed=8)
    live = tmax > 0
    t, slot, u, v, _ = trace_dense_plain(
        ttree, *(torch.from_numpy(x) for x in lanes(o, d, tmax)))
    slot = slot.numpy().reshape(-1)
    tri = np.where(slot >= 0, ttree.leaf_tri.numpy()[np.maximum(slot, 0)], -1)
    bt, btri, bu, bv = brute_closest(o[live], d[live], C.RAY_TMIN,
                                     C.RAY_TMAX, v0, e1, e2)
    np.testing.assert_array_equal(tri[live] >= 0, btri >= 0)
    both = (tri[live] >= 0) & (btri >= 0)
    np.testing.assert_allclose(t.numpy().reshape(-1)[live][both], bt[both],
                               rtol=1e-5)
    assert (tri[live][both] == btri[both]).mean() > 0.99


def shadow_segments(seed, ns=4, n=N_RAYS, near=True):
    """Segments from the config lights toward points in and around the
    hall (points outside it are shadowed by its walls), ~30% parked, and
    (near=True) 8 live segments per set with an empty interval
    0 < tmax <= TMIN."""
    rng = np.random.default_rng(seed)
    lights = C.LIGHT_POSITIONS[:ns]
    pts = rng.uniform([-24, -4, -15], [23, 18, 16], (n, 3)).astype(np.float32)
    dirs = np.zeros((ns, 3, n // 128, 128), np.float32)
    tm = np.zeros((ns, n // 128, 128), np.float32)
    for s in range(ns):
        dv = pts - lights[s]
        dist = np.linalg.norm(dv, axis=1)
        dirs[s] = np.moveaxis((dv / dist[:, None]).reshape(-1, 128, 3), -1, 0)
        tmv = (dist - C.RAY_TMIN).astype(np.float32)
        tmv[rng.random(n) < 0.3] = 0.0
        if near:
            tmv[:8] = 0.0009
        tm[s] = tmv.reshape(-1, 128)
    return lights, pts, dirs, tm


def test_occl_plain_matches_jax_kernel(scene):
    _, _, _, jtree, ttree = scene
    lights, _, dirs, tm = shadow_segments(seed=11)
    want = np.asarray(jax_occluded_multi(
        jtree, jnp.asarray(lights), jnp.asarray(dirs), jnp.asarray(tm),
        block=512, interpret=True))
    got = occluded_multi(ttree, torch.from_numpy(lights),
                         torch.from_numpy(dirs), torch.from_numpy(tm)).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.95
    # empty-interval and parked segments are never blocked
    assert not got.reshape(len(lights), -1)[:, :8].any()
    assert not got[tm == 0].any()


def test_occl_plain_matches_brute_oracle(scene):
    v0, e1, e2, _, ttree = scene
    lights, pts, dirs, tm = shadow_segments(seed=12, ns=2, near=False)
    got = occluded_multi(ttree, torch.from_numpy(lights),
                         torch.from_numpy(dirs), torch.from_numpy(tm)).numpy()
    for s in range(len(lights)):
        d = np.moveaxis(dirs[s], 0, -1).reshape(-1, 3)
        t = tm[s].reshape(-1)
        o = np.broadcast_to(lights[s], d.shape).astype(np.float32)
        want = brute_occluded(o, d, C.RAY_TMIN, t, v0, e1, e2)
        assert (got[s].reshape(-1) == want).mean() > 0.999


def test_cpu_path_counts_no_launch(scene):
    """The launch counters count kernel launches only: the CPU path runs
    the plain versions and leaves them unchanged."""
    _, _, _, _, ttree = scene
    o, d, tmax = (torch.from_numpy(x) for x in lanes(*make_rays(256)))
    a0, b0 = trace_dense.launches, occluded_multi.launches
    trace_dense(ttree, o, d, tmax)
    occluded_multi(ttree, o[:, 0, :1].T.contiguous(), d[None], tmax[None])
    assert (trace_dense.launches, occluded_multi.launches) == (a0, b0)


@pytest.mark.parametrize("fn", ["closest", "occl"])
def test_unsupported_device_raises(scene, fn):
    """Neither wrapper falls back: a tensor that is neither on the CPU
    nor on a CUDA card raises."""
    _, _, _, _, ttree = scene
    meta = torch.empty(3, 2, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if fn == "closest":
            trace_dense(ttree, meta, meta, meta[0])
        else:
            occluded_multi(ttree, meta[:1, 0, :3], meta[None], meta[:1, 0])


def test_tie_goes_to_lower_slot(scene):
    """One triangle in two clusters: the copy in a padding cluster of a
    higher id under the scene's box, which a walk by entry t meets first
    (chip_smoke.tie_tree). The plain version returns the lower slot with
    the same t, u, v and attributes as without the copy. The JAX kernel
    keeps the first cluster it visits, the copy, at the same t, u, v:
    the same triangle through leaf_tri (inside tests/test_dense.py's
    near-tie contract; the port's rule is the lower slot)."""
    from chip_smoke import tie_slots, tie_tree
    from vkrt_tpu.accel.clusters import ClusterTree as JaxTree

    _, _, _, jtree, ttree = scene
    o, d, tmax = (torch.from_numpy(x) for x in lanes(*make_rays()))
    want = trace_dense_plain(ttree, o, d, tmax)
    slot, spare = tie_slots(ttree, want[1])
    assert spare > slot // 128
    tt = tie_tree(ttree, slot, spare)
    seen = want[1] == slot
    assert int(seen.sum()) >= 8
    for g, w in zip(trace_dense_plain(tt, o, d, tmax), want):
        assert torch.equal(g, w)
    jt = JaxTree(*(jnp.asarray(x.numpy()) for x in tt))
    args = (jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(tmax.numpy()))
    kw = dict(block=512, with_attributes=True, interpret=True)
    jt_out = [np.asarray(x) for x in jax_trace_dense(jt, *args, **kw)]
    j0_out = [np.asarray(x) for x in jax_trace_dense(jtree, *args, **kw)]
    s = seen.numpy()
    leaf = tt.leaf_tri.numpy()
    assert (leaf[jt_out[1][s]] == leaf[slot]).all()
    for k in (0, 2, 3):                  # t, u, v: unchanged by the copy
        np.testing.assert_array_equal(jt_out[k][s], j0_out[k][s])
    np.testing.assert_array_equal(jt_out[4][:, s], j0_out[4][:, s])
    np.testing.assert_allclose(jt_out[0][s], want[0].numpy()[s], rtol=1e-6)


def test_work_split_walks_end_at_plain_hits(scene):
    """tools/trace_work_split.py's walks (ascending id, nearest-first and
    the two group orders) end at trace_dense_plain's (t, slot) for every
    ray, and its shadow walks at occluded_multi_plain's masks."""
    from tools.trace_work_split import occl_split, walks
    from vkrt_tpu_torch.rt.occl_multi import occluded_multi_plain

    _, _, _, _, ttree = scene
    o, d, tmax = (torch.from_numpy(x) for x in lanes(*make_rays(seed=9)))
    want = trace_dense_plain(ttree, o, d, tmax)
    counts, ends = walks(ttree, o.reshape(3, -1), d.reshape(3, -1),
                         tmax.reshape(-1))
    assert set(ends) == {"ascending", "nearest", "group_two_level",
                         "group_whole_tree"}
    for t, slot in ends.values():
        assert torch.equal(t, want[0].reshape(-1))
        assert torch.equal(slot.int(), want[1].reshape(-1))
    assert counts["nearest"] == counts["bound"] <= counts["ascending"]
    assert counts["ascending"] <= counts["ascending_warp"]

    lights, _, dirs, tm = (torch.from_numpy(x) for x in shadow_segments(13))
    ns, n = lights.shape[0], tm[0].numel()
    blocked = occluded_multi_plain(ttree, lights, dirs, tm)
    o2 = lights.T[:, :, None].expand(3, ns, n).reshape(3, -1)
    d2 = dirs.reshape(ns, 3, -1).permute(1, 0, 2).reshape(3, -1)
    counts, ends = walks(ttree, o2.contiguous(), d2.contiguous(),
                         tm.reshape(-1), occlusion=True, lanes_per_ray=n)
    for mask in ends.values():
        assert torch.equal(mask, blocked.reshape(-1))
    assert 0 < counts["group_two_level"] <= counts["group_two_level_warp"]
    assert occl_split(ttree, lights, dirs, tm, 2)["rays"] == ns * n // 2
