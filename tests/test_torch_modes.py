"""The JAX kernels' remaining modes and host functions in the port, on
the CPU, against the JAX package (Pallas in interpret mode).

Kernels A, A' and B in each mode (rt/dense.py, rt/occl_multi.py: stats,
ablate, the interval pregate, group_gate, sort, visit and A''s sub_gate
and pregates), the port's plain version held against the JAX kernel on
the same numpy-seeded inputs, a 9,000-triangle scene of two
superclusters, 512 rays at block 128 (4 groups) a call (kernel B: 2
sets of 256 segments):

- slots, attributes, any-hit masks and the outputs of a cut (every ray a
  miss) bit-equal; stats lane 0 (the work-list length) equal; stats lane
  1 is the port's own count ((group, cluster) sweeps, where the JAX
  kernel counts a block's clusters) and lies within `sweep_bounds`;
- t, u, v within test_torch_trace.py's parity bars (t rtol 1e-5, u, v
  atol 1e-5): XLA on the CPU contracts the Möller–Trumbore products and
  sums into fused multiply-adds, which the port's kernels (built with
  -fmad=false) and plain versions round one by one; in each package a
  mode's outputs equal that package's default outputs bit for bit.

Also: the calls of tests/test_dense.py:314-537 with their keywords (less
`interpret`) in the port, `trace_dense_rays`, `trace_closest_stats`, the
argument checks, the build root of utils/cache.py and the engine's scene
cache.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu.accel import lbvh as jlbvh
from vkrt_tpu.accel.clusters import build_clusters as jax_build_clusters
from vkrt_tpu.rt import traverse as jtrav
from vkrt_tpu.rt.dense import trace_dense as jax_trace_lanes
from vkrt_tpu.rt.dense import trace_dense_rays as jax_trace
from vkrt_tpu.rt.occl_multi import occluded_multi as jax_occluded_multi
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import kernels, native
from vkrt_tpu_torch.accel import lbvh as tlbvh
from vkrt_tpu_torch.accel.clusters import tree_from_numpy
from vkrt_tpu_torch.rt import dense
from vkrt_tpu_torch.rt import traverse as ttrav
from vkrt_tpu_torch.rt.dense import (ABLATES, CUTS, sweep_bounds,
                                     trace_dense, trace_dense_rays)
from vkrt_tpu_torch.rt.occl_multi import occluded_multi
from vkrt_tpu_torch.utils import layout as L
from vkrt_tpu_torch.utils.cache import DEFAULT_ROOT, ENV, build_root
from vkrt_tpu_torch.wavefront import engine as te
from test_scene import _write_bin_gltf

N = 512          # rays a call: 4 groups of 128
BLOCK = 128      # the JAX dispatch block
ABLATE_MODES = {f"ablate_{a}": dict(ablate=a) for a in ABLATES[1:]}
# group_gate's case also takes sort=False (the JAX engine's depth >= 1
# call, engine.py:414-418)
A_MODES = {"stats": dict(stats=True), "interval": dict(pregate=True),
           "group_gate": dict(group_gate=True, sort=False), **ABLATE_MODES,
           "stats_nosweep": dict(stats=True, ablate="nosweep"),
           "stats_recheck": dict(stats=True, pregate="recheck"),
           "interval_nosort": dict(pregate=True, ablate="nosort")}
A1_MODES = {"sub_gate": dict(sub_gate=True),
            "recheck": dict(pregate="recheck"),
            "interval": dict(pregate="interval"), "stats": dict(stats=True),
            "interval_nosort": dict(pregate="interval", ablate="nosort"),
            **ABLATE_MODES}
# a pregate with a visit order: the JAX kernel keeps its lists' order
# (recheck with visit != "near" needs sort=False)
B_MODES = {"visit_mid": dict(visit="mid"), "visit_far": dict(visit="far"),
           "interval": dict(pregate=True),
           "interval_nosort": dict(pregate=True, ablate="nosort"),
           "interval_visit_mid": dict(pregate="interval", visit="mid"),
           "recheck_visit_far": dict(pregate="recheck", sort=False,
                                     visit="far"),
           "group_gate": dict(group_gate=True, sort=False), **ABLATE_MODES}


def random_tris(seed, n, spread, edge):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-s, s, (n, 3)).astype(np.float32)
                 for s in (spread, edge, edge))


def trees(tris):
    """The JAX host build of `tris` and the port's copy of its arrays."""
    jtree = jax_build_clusters(*map(jnp.asarray, tris), device=False)
    return jtree, tree_from_numpy(*(np.asarray(a) for a in jtree),
                                  device="cpu")


@pytest.fixture(scope="module")
def scene():
    """9,000 triangles: 71 clusters in two superclusters."""
    jtree, ttree = trees(random_tris(42, 9000, 8.0, 1.0))
    assert ttree.num_superclusters == 2
    return jtree, ttree


def rays(seed=5, n=N):
    """Row-major rays from inside and around the scene, 30% parked."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.3, 0.0, 1e3).astype(np.float32)
    return o, d, tmax


def segments(seed, ns=2, n=N):
    """Lane-major shadow segments of ns sets from light points to points
    in the scene (30% parked): lights f32[ns,3], dirs, tmax."""
    rng = np.random.default_rng(seed)
    lights = rng.uniform(-9, 9, (ns, 3)).astype(np.float32)
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    dirs = np.zeros((ns, 3, n // 128, 128), np.float32)
    tm = np.zeros((ns, n // 128, 128), np.float32)
    for s in range(ns):
        dv = pts - lights[s]
        dist = np.linalg.norm(dv, axis=1)
        dirs[s] = np.moveaxis((dv / dist[:, None]).reshape(-1, 128, 3), -1, 0)
        tmv = (dist - 0.001).astype(np.float32)
        tmv[rng.random(n) < 0.3] = 0.0
        tm[s] = tmv.reshape(-1, 128)
    return lights, dirs, tm


def t32(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def j32(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def assert_hits_match(port, jax_out):
    """(t, slot, u, v[, attrs]) of the two packages: slots and attrs
    equal, t equal on misses and within rtol 1e-5 on hits, u, v within
    1e-5 (the contraction of the module docstring)."""
    t, slot, u, v = port[:4]
    jt, js, ju, jv = jax_out[:4]
    np.testing.assert_array_equal(slot, js)
    hit = slot >= 0
    np.testing.assert_array_equal(t[~hit], jt[~hit])
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)
    np.testing.assert_allclose(u, ju, atol=1e-5)
    np.testing.assert_allclose(v, jv, atol=1e-5)
    if len(port) > 4:
        np.testing.assert_array_equal(port[4], jax_out[4])


def lane1_within_bounds(ttree, o, d, tmax, far, lane1, kw):
    """Stats lane 1 within `sweep_bounds` on the same rays (row-major)."""
    pregate = dense._pregate(kw.get("pregate", False))
    lists = (dense.closest_worklists(ttree, *t32(L_cvec(o), L_cvec(d),
                                                  tmax.reshape(-1, 128)))
             if pregate else None)
    lo, hi = sweep_bounds(ttree, *t32(o.T, d.T, tmax, far), BLOCK,
                          **dense._plain_lists(ttree, lists, pregate))
    assert ((lo <= lane1) & (lane1 <= hi)).all(), (lo, lane1, hi)
    return lo, hi


def L_cvec(x):
    """[N,3] numpy → [3,Nb,128] numpy."""
    return np.moveaxis(x.reshape(-1, 128, 3), -1, 0).copy()


@pytest.mark.parametrize("mode", sorted(A_MODES))
def test_closest_mode_matches_jax(scene, mode):
    jtree, ttree = scene
    kw = A_MODES[mode]
    o, d, tmax = rays()
    want = [np.asarray(x) for x in jax_trace(
        jtree, *j32(o, d, tmax), block=BLOCK, with_attributes=True,
        interpret=True, **kw)]
    got = [x.numpy() for x in trace_dense_rays(
        ttree, *t32(o, d, tmax), block=BLOCK, with_attributes=True, **kw)]
    assert len(got) == len(want)
    assert_hits_match(got, want)
    base = [x.numpy() for x in trace_dense_rays(
        ttree, *t32(o, d, tmax), block=BLOCK, with_attributes=True)]
    cut = kw.get("ablate") in CUTS
    assert (base[1] >= 0).sum() > 50
    assert (got[1] >= 0).any() != cut
    if not cut:
        for g, b in zip(got, base):
            np.testing.assert_array_equal(g, b)
    if kw.get("stats"):
        np.testing.assert_array_equal(got[5][:, 0], want[5][:, 0])
        assert (got[5][:, 0] > 0).all()
        far = np.where(got[1] >= 0, got[0], tmax)
        lo, hi = lane1_within_bounds(ttree, o, d, tmax, far,
                                     torch.from_numpy(got[5][:, 1]), kw)
        if kw.get("ablate") == "nosweep":
            assert torch.equal(lo, hi)


@pytest.mark.parametrize("mode", sorted(A1_MODES))
def test_occluded_mode_matches_jax(scene, mode):
    """Kernel A' (trace_dense(occlusion=True)): masks, t and slot bit-equal
    (blocked: slot 1, t = TMIN; free: -1, inf), u = v = 0."""
    jtree, ttree = scene
    kw = A1_MODES[mode]
    o, d, tmax = rays(seed=6)
    tmax = np.where(tmax > 0, 6.0, 0.0).astype(np.float32)
    want = [np.asarray(x) for x in jax_trace(
        jtree, *j32(o, d, tmax), block=BLOCK, occlusion=True,
        interpret=True, **kw)]
    got = [x.numpy() for x in trace_dense_rays(
        ttree, *t32(o, d, tmax), block=BLOCK, occlusion=True, **kw)]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    blocked = got[1] >= 0
    assert blocked.any() != (kw.get("ablate") in CUTS)
    if kw.get("stats"):
        np.testing.assert_array_equal(got[4][:, 0], want[4][:, 0])
        far = np.where(blocked, 0.0, tmax).astype(np.float32)
        lane1_within_bounds(ttree, o, d, tmax, far,
                            torch.from_numpy(got[4][:, 1]), kw)


@pytest.mark.parametrize("mode", sorted(B_MODES))
def test_occl_multi_mode_matches_jax(scene, mode):
    jtree, ttree = scene
    kw = B_MODES[mode]
    lights, dirs, tm = segments(seed=8, n=N // 2)
    want = np.asarray(jax_occluded_multi(jtree, *j32(lights, dirs, tm),
                                         block=BLOCK, interpret=True, **kw))
    got = occluded_multi(ttree, *t32(lights, dirs, tm), block=BLOCK, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() != (kw.get("ablate") in CUTS)


@pytest.mark.parametrize("mode", ["interval", "stats", "occlusion_stats"])
def test_point_origin_modes_match_jax(scene, mode):
    """One origin per block of 256 rays (two blocks), lane-major."""
    jtree, ttree = scene
    o, d, tmax = rays(seed=9)
    pts = np.array([[-9.0, 1.0, 2.0], [8.0, -2.0, 1.0]], np.float32)
    kw = dict(block=256, point_origin=True)
    kw.update(dict(pregate="interval") if mode == "interval"
              else dict(stats=True))
    if mode == "occlusion_stats":
        kw["occlusion"] = True
        tmax = np.where(tmax > 0, 6.0, 0.0).astype(np.float32)
    args = (pts, L_cvec(d), tmax.reshape(-1, 128))
    want = [np.asarray(x) for x in jax_trace_lanes(
        jtree, *j32(*args), interpret=True, **kw)]
    got = [x.numpy() for x in trace_dense(ttree, *t32(*args),
                                          with_attributes=False, **kw)]
    assert_hits_match(got[:4], want[:4])
    if "stats" in mode:
        np.testing.assert_array_equal(got[4][:, 0], want[4][:, 0])


def test_dense_kernel_test_calls_run_in_the_port():
    """The calls of tests/test_dense.py:314-537, keywords as written less
    `interpret`, on the port's copy of that file's scene: each mode's
    outputs equal its base call's, bit for bit, as the JAX tests assert."""
    rng = np.random.default_rng(42)
    n = 900
    tris = tuple(rng.uniform(lo, hi, (n, 3)).astype(np.float32)
                 for lo, hi in ((-5, 5), (-2, 2), (-2, 2)))
    _, tree = trees(tris)

    def make_rays(n_rays, seed):
        r = np.random.default_rng(seed)
        o = r.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
        d = r.normal(size=(n_rays, 3)).astype(np.float32)
        return o, d / np.linalg.norm(d, axis=1, keepdims=True)

    def same(a, b):
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    def shadow(seed, ns, n_pts):
        r = np.random.default_rng(seed)
        lights = r.uniform(-6, 6, (ns, 3)).astype(np.float32)
        pts = r.uniform(-4, 4, (n_pts, 3)).astype(np.float32)
        dirs = np.zeros((ns, 3, n_pts // 128, 128), np.float32)
        tm = np.zeros((ns, n_pts // 128, 128), np.float32)
        for s in range(ns):
            dv = pts - lights[s]
            dist = np.linalg.norm(dv, axis=1)
            dirs[s] = L_cvec(dv / dist[:, None])
            tmv = (dist - 0.001).astype(np.float32)
            tmv[r.random(n_pts) < 0.3] = 0.0
            tm[s] = tmv.reshape(-1, 128)
        return t32(lights, dirs, tm)

    # test_group_gate_closest_bit_exact (:314)
    o, d = make_rays(1024, 33)
    tmax = np.where(np.random.default_rng(33).uniform(size=1024) < 0.4, 0.0,
                    1e3).astype(np.float32)
    for block in (256, 512):
        base = trace_dense_rays(tree, *t32(o, d, tmax), block=block,
                                with_attributes=True, sort=False)
        same(base, trace_dense_rays(tree, *t32(o, d, tmax), block=block,
                                    with_attributes=True, sort=False,
                                    group_gate=True))
    # test_group_gate_occl_multi_bit_exact (:333), test_visit_order (:362)
    seg = shadow(34, 4, 512)
    base = occluded_multi(tree, *seg, block=256, sort=False)
    assert torch.equal(base, occluded_multi(tree, *seg, block=256, sort=False,
                                            group_gate=True))
    seg = shadow(35, 4, 512)
    base = occluded_multi(tree, *seg, block=256, sort=True)
    for visit in ("mid", "far"):
        assert torch.equal(base, occluded_multi(tree, *seg, block=256,
                                                sort=True, visit=visit))
    # test_pregate_closest_bit_exact (:393)
    rng = np.random.default_rng(44)
    o0 = np.tile(np.array([[0, 0, -12]], np.float32), (1024, 1))
    ang = rng.uniform(-0.25, 0.25, (1024, 2)).astype(np.float32)
    d0 = np.stack([np.sin(ang[:, 0]), np.sin(ang[:, 1]),
                   np.cos(ang[:, 0]) * np.cos(ang[:, 1])], 1)
    d0 = (d0 / np.linalg.norm(d0, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.uniform(size=1024) < 0.2, 0.0, 1e3).astype(np.float32)
    for o_set, d_set in ((o0, d0), make_rays(1024, 45)):
        args = t32(o_set, d_set, tmax)
        same(trace_dense_rays(tree, *args, block=256, with_attributes=True),
             trace_dense_rays(tree, *args, block=256, with_attributes=True,
                              pregate=True))
    # test_pregate_occl_multi_bit_exact (:419)
    seg = shadow(46, 4, 512)
    assert torch.equal(occluded_multi(tree, *seg, block=256),
                       occluded_multi(tree, *seg, block=256, pregate=True))
    # test_recheck_closest_bit_exact (:448)
    o, d = make_rays(1024, 47)
    tmax = np.where(np.random.default_rng(47).uniform(size=1024) < 0.4, 0.0,
                    1e3).astype(np.float32)
    args = t32(o, d, tmax)
    for gg in (False, True):
        same(trace_dense_rays(tree, *args, block=256, with_attributes=True,
                              sort=False, group_gate=gg),
             trace_dense_rays(tree, *args, block=256, with_attributes=True,
                              sort=False, group_gate=gg, pregate="recheck"))
    b = trace_dense_rays(tree, *args, block=256, occlusion=True, sort=False)
    r = trace_dense_rays(tree, *args, block=256, occlusion=True, sort=False,
                         pregate="recheck")
    assert torch.equal(b[1] >= 0, r[1] >= 0)
    args0 = t32(o0, d0, tmax)
    same(trace_dense_rays(tree, *args0, block=256, with_attributes=True,
                          sort=True),
         trace_dense_rays(tree, *args0, block=256, with_attributes=True,
                          sort=True, pregate="recheck"))
    # test_recheck_occl_multi_bit_exact (:494)
    seg = shadow(48, 4, 1024)
    base = occluded_multi(tree, *seg, block=256, sort=False)
    for gg in (False, True):
        assert torch.equal(base, occluded_multi(
            tree, *seg, block=256, sort=False, group_gate=gg,
            pregate="recheck"))
    assert torch.equal(base, occluded_multi(tree, *seg, block=256, sort=True,
                                            pregate="recheck"))
    assert torch.equal(
        occluded_multi(tree, *seg, block=1024, sort=False),
        occluded_multi(tree, *seg, block=1024, sort=False, group_gate=True,
                       pregate="recheck"))


def test_trace_dense_rays_is_the_lane_major_trace(scene):
    """Row-major in and out: t, slot, u, v [N], attrs [N,36], stats
    [N/block,2], the lane-major call's values; 4 outputs by default."""
    _, ttree = scene
    o, d, tmax = rays(seed=10)
    got = trace_dense_rays(ttree, *t32(o, d, tmax), block=BLOCK,
                           with_attributes=True, stats=True)
    lanes = trace_dense(ttree, *t32(L_cvec(o), L_cvec(d),
                                    tmax.reshape(-1, 128)),
                        block=BLOCK, stats=True)
    assert [tuple(x.shape) for x in got] == [(N,)] * 4 + [(N, 36),
                                                          (N // BLOCK, 2)]
    for g, w in zip(got[:4], lanes[:4]):
        assert torch.equal(g, w.reshape(-1))
    assert torch.equal(got[4], L.from_cvec(lanes[4]))
    assert torch.equal(got[5], lanes[5])
    assert len(trace_dense_rays(ttree, *t32(o, d, tmax))) == 4


def test_trace_closest_stats_matches_jax():
    """The reference walk with its lock-step iteration count: hits as
    trace_closest's (test_torch_reference.py's bars), iterations equal."""
    tris = random_tris(11, 300, 5.0, 2.0)
    o, d, _ = rays(seed=12, n=256)
    o = (o * 0.8).astype(np.float32)
    bvh = tlbvh.build_lbvh(*t32(*tris))
    jbvh = jlbvh.build_lbvh(*j32(*tris))
    got = ttrav.trace_closest_stats(bvh, *t32(o, d), 1e-3, 1e3)
    want = [np.asarray(x) for x in jtrav.trace_closest_stats(
        jbvh, *j32(o, d), 1e-3, 1e3)]
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for g, w in zip(got[:4:2] + got[3:4], want[:4:2] + want[3:4]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    assert got[4].dtype == torch.int32 and got[4].ndim == 0
    assert int(got[4]) == int(want[4]) > 1
    for g, w in zip(got[:4], ttrav.trace_closest(bvh, *t32(o, d), 1e-3,
                                                 1e3)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["interval_group_gate", "recheck_visit",
                                  "block", "ablate", "visit", "pregate"])
def test_mode_arguments_are_checked(scene, case):
    """The JAX asserts (interval pregate with group_gate, dense.py:944;
    recheck + sort with visit other than "near", occl_multi.py:597) and
    unknown values raise ValueError."""
    _, ttree = scene
    o, d, tmax = t32(L_cvec(rays()[0]), L_cvec(rays()[1]),
                     rays()[2].reshape(-1, 128))
    seg = t32(*segments(seed=3))
    with pytest.raises(ValueError):
        if case == "interval_group_gate":
            try:
                trace_dense(ttree, o, d, tmax, pregate=True, group_gate=True)
            except ValueError:
                occluded_multi(ttree, *seg, pregate="interval",
                               group_gate=True)
                raise AssertionError("kernel B took interval + group_gate")
        elif case == "recheck_visit":
            occluded_multi(ttree, *seg, pregate="recheck", sort=True,
                           visit="far")
        elif case == "block":
            trace_dense(ttree, o, d, tmax, block=200)
        elif case == "ablate":
            trace_dense(ttree, o, d, tmax, ablate="nodmas")
        elif case == "visit":
            occluded_multi(ttree, *seg, visit="near_first")
        else:
            trace_dense(ttree, o, d, tmax, pregate="intervals")


def test_build_roots_follow_the_cache_variable(tmp_path, monkeypatch):
    """VKRT_TORCH_CACHE moves both build roots (the kernels' and the native
    oracle's, read at each build); unset, the package's _build/."""
    monkeypatch.delenv(ENV, raising=False)
    assert build_root() == DEFAULT_ROOT
    assert DEFAULT_ROOT.parent.name == "vkrt_tpu_torch"
    monkeypatch.setenv(ENV, str(tmp_path / "cache"))
    assert build_root() == tmp_path / "cache"
    assert build_root(tmp_path / "x") == tmp_path / "x"
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int vkrt_tiny() { return 7; }\n')
    lib = native.build(src)
    assert lib.is_file() and lib.is_relative_to(tmp_path / "cache" / "native")
    assert native.build(src) == lib
    # the kernels' root: what build() would make, without nvcc here
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("no nvcc")))
    with pytest.raises(RuntimeError, match="no nvcc"):
        kernels.build()
    made = [p for p in (tmp_path / "cache").iterdir() if p.name != "native"]
    assert [p.name for p in made] == [kernels._source_hash()]


def test_scene_cache_loads_once_per_process(tmp_path, monkeypatch):
    """load_scene_assets, cached_model, cached_backend: one load and one
    flatten per (path, texture size), one upload per device, one backend
    per kind; the flattened scene equals the JAX engine's."""
    path, _ = _write_bin_gltf(tmp_path)
    path = str(path)
    loads = []
    real = te.load_model
    monkeypatch.setattr(te, "load_model",
                        lambda *a, **k: loads.append(a) or real(*a, **k))
    monkeypatch.setattr(te, "_MODEL_CACHE", {})
    monkeypatch.setattr(te, "_SCENE_CACHE", {})
    flat, tex, backends = te.load_scene_assets(path, 0, "cpu")
    assert te.load_scene_assets(path, 0, "cpu")[1] is tex
    model = te.cached_model(path, 0)
    assert te.cached_model(path) is model and len(loads) == 1
    f2, t2, be = te.cached_backend(path, 0, "dense", "cpu")
    assert f2 is flat and t2 is tex and isinstance(be, te.DenseBackend)
    assert te.cached_backend(path, 0, "dense", "cpu")[2] is be
    ref = te.cached_backend(path, 0, "reference", "cpu")[2]
    assert isinstance(ref, te.ReferenceBackend) and len(backends) == 2
    assert tex.texels_tri.device.type == "cpu" and len(loads) == 1
    # the renderers load a path through the same cache
    scene = te.SceneOnDevice(path, C.RenderConfig(width=64, height=48),
                             "cpu")
    assert scene.flat is flat and scene.tex is tex and scene.backend is be
    assert scene.model is model and len(loads) == 1
    jflat, _, _ = je.load_scene_assets(path, 0)
    for f in ("positions", "indices"):
        np.testing.assert_array_equal(np.asarray(getattr(flat, f)),
                                      np.asarray(getattr(jflat, f)))
    json.dumps(sorted(te._SCENE_CACHE))          # keys are plain values
