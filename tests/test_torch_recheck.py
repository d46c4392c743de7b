"""Kernel A's and B's modes (`sub_gate`, `pregate="recheck"`) on the CPU:
the re-check's prologue against the JAX package's XLA functions, and the
plain versions in each mode against the default plain versions.

The prologue (rt/dense.py, rt/occl_multi.py): `interval_gate` vs
`vkrt_tpu.rt.dense._interval_gate` (gate bits equal; entry bounds equal
where gated, 0 tolerance), `partition_worklists` vs
`_partition_worklists` (equal), `cluster_bounds` vs
`_cluster_bounds_smem` (equal), and the per-set form vs
vkrt_tpu/rt/occl_multi.py:611-630 (equal). The interval gate is
conservative: every (group, cluster) pair a ray's own gate passes is
gated. Plain A and B in either mode, and in both, equal the default
plain versions bit for bit; so do the CUDA kernels
(tests/test_torch_cuda.py). The interval pregate and kernel A''s modes
(tests/test_torch_modes.py against the JAX kernel) give the defaults'
outputs too. A sub-run box is widened before its test and
an empty (inverted) one fails it: its zeroed rows commit nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu.accel.clusters import build_clusters as jax_build_clusters
from vkrt_tpu.accel.clusters import scene_attrs as jax_scene_attrs
from vkrt_tpu.rt import dense as jd
from vkrt_tpu.rt.occl_multi import occluded_multi as jax_occluded_multi
from vkrt_tpu.scene import flatten_model
from vkrt_tpu_torch.accel.clusters import SUB_COL, SUBRUNS, tree_from_numpy
from vkrt_tpu_torch.rt import dense
from vkrt_tpu_torch.rt.dense import (cluster_bounds, closest_worklists,
                                     gated_pairs, interval_gate,
                                     listed_matrix, partition_worklists,
                                     sub_run_pass, trace_dense,
                                     trace_dense_plain)
from vkrt_tpu_torch.rt.occl_multi import (multi_interval_gate,
                                          multi_worklists, occluded_multi)
from vkrt_tpu_torch.scene.procedural import procedural_model
from test_torch_trace import lanes, make_rays, shadow_segments
import torch_support  # noqa: F401

MODES = {"sub_gate": dict(sub_gate=True), "recheck": dict(pregate="recheck"),
         "both": dict(sub_gate=True, pregate="recheck")}


@pytest.fixture(scope="module")
def trees():
    flat = flatten_model(procedural_model("small", seed=0))
    idx = np.asarray(flat.indices, dtype=np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0
    jtree = jax_build_clusters(jnp.asarray(v0), jnp.asarray(e1),
                               jnp.asarray(e2), attrs=jax_scene_attrs(flat),
                               with_attributes=True, device=False)
    return jtree, tree_from_numpy(*(np.asarray(a) for a in jtree),
                                  device="cpu")


def rays(seed=7):
    """make_rays' camera and scattered rays, lane-major, numpy."""
    return lanes(*make_rays(seed=seed))


def point_rays(seed, block):
    """Rays from one origin per block of `block` rays (the lights')."""
    lights, _, dirs, tm = shadow_segments(seed)
    nb = dirs.shape[2]
    pts = np.repeat(lights[:1], nb * 128 // block, axis=0).astype(np.float32)
    return pts, dirs[0], tm[0]


@pytest.mark.parametrize("block", [128, 512])
@pytest.mark.parametrize("point_origin", [False, True])
def test_interval_gate_matches_jax(trees, block, point_origin):
    jtree, ttree = trees
    if point_origin:
        o, d, tm = point_rays(3, block)
    else:
        o, d, tm = rays()
    jg, jt, jn = jd._interval_gate(jtree, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tm), block=block,
                                   point_origin=point_origin)
    tg, tt, tn = interval_gate(ttree, torch.from_numpy(o),
                               torch.from_numpy(d), torch.from_numpy(tm),
                               block=block, point_origin=point_origin)
    jg, jt = np.asarray(jg), np.asarray(jt)
    assert tn == jn and tg.shape == jg.shape
    np.testing.assert_array_equal(tg.numpy(), jg)
    assert jg.any() and not jg.all()
    # the bound where the list uses it (gated), bit for bit
    np.testing.assert_array_equal(tt.numpy()[jg], jt[jg])


@pytest.mark.parametrize("extra", [False, True])
def test_partition_worklists_matches_jax(extra):
    rng = np.random.default_rng(5)
    gate = rng.random((12, 150)) < 0.3
    gate[3] = False
    gate[4] = True
    tlb = rng.uniform(0, 30, gate.shape).astype(np.float32)
    ex = rng.integers(0, 16, gate.shape).astype(np.int32) if extra else None
    want = jd._partition_worklists(
        jnp.asarray(gate), jnp.asarray(tlb),
        None if ex is None else jnp.asarray(ex))
    got = partition_worklists(torch.from_numpy(gate), torch.from_numpy(tlb),
                              None if ex is None else torch.from_numpy(ex))
    order, t, count = (np.asarray(w) for w in want[:3])
    np.testing.assert_array_equal(got[0].numpy(), order[:, 0])
    np.testing.assert_array_equal(got[1].numpy(), t[:, 0])
    np.testing.assert_array_equal(got[2].numpy(), count[:, 0, 0])
    if extra:
        np.testing.assert_array_equal(got[3].numpy(),
                                      np.asarray(want[3])[:, 0])
    assert got[0].shape[1] % 64 == 0


def test_cluster_bounds_matches_jax(trees):
    jtree, ttree = trees
    np.testing.assert_array_equal(cluster_bounds(ttree).numpy(),
                                  np.asarray(jd._cluster_bounds_smem(jtree)))


@pytest.mark.parametrize("block", [128, 512])
def test_per_set_prologue_matches_jax(trees, block):
    """occl_multi.py:611-630: per set an interval gate from its light,
    the gates OR-ed, the least bound of the gating sets, the set bits,
    then the cumsum partition with the bits as `extra`."""
    jtree, ttree = trees
    lights, _, dirs, tm = shadow_segments(seed=11)
    ns, nb = dirs.shape[0], dirs.shape[2]
    nblocks = nb * 128 // block
    gate_any = tlb_min = sbits = None
    for s in range(ns):
        pts = jnp.broadcast_to(jnp.asarray(lights[s])[None, :], (nblocks, 3))
        g, t, _ = jd._interval_gate(jtree, pts, jnp.asarray(dirs[s]),
                                    jnp.asarray(tm[s]), block=block,
                                    point_origin=True)
        b = jnp.where(g, jnp.int32(1 << s), 0)
        gate_any = g if gate_any is None else gate_any | g
        tlb_min = (jnp.where(g, t, jd._INF) if tlb_min is None
                   else jnp.minimum(tlb_min, jnp.where(g, t, jd._INF)))
        sbits = b if sbits is None else sbits | b
    want = jd._partition_worklists(gate_any, jnp.where(gate_any, tlb_min, 0.0),
                                   extra=sbits)
    tg, tt, tb = multi_interval_gate(
        ttree, torch.from_numpy(lights), torch.from_numpy(dirs),
        torch.from_numpy(tm), block=block)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(gate_any))
    got = partition_worklists(tg, tt, tb)
    for g, w in zip(got[:2] + got[3:], (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, 0])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2])[:, 0, 0])


def rows_gated(tree, o, d, tm):
    """bool[rows of 128 rays, maxc]: the pairs a ray's own gate passes at
    its tmax (cluster and supercluster boxes)."""
    n = tm.size
    o, d, tm = (torch.from_numpy(x) for x in (o, d, tm))
    out = torch.zeros(n // 128, tree.tri_data.shape[0], dtype=torch.bool)
    for ray, cl in gated_pairs(tree, o.reshape(3, n), d.reshape(3, n),
                               tm.reshape(n)):
        out[ray // 128, cl] = True
    return out


@pytest.mark.parametrize("seed", [7, 8])
def test_interval_gate_is_conservative(trees, seed):
    """Every (group, cluster) pair some ray of the group gates is in
    kernel A's candidate list; the list's used prefix ascends by bound."""
    _, ttree = trees
    o, d, tm = rays(seed)
    need = rows_gated(ttree, o, d, tm)
    lists = closest_worklists(ttree, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(tm))
    listed = listed_matrix(lists, ttree.tri_data.shape[0])
    assert need.any()
    assert not (need & ~listed).any()
    for g in range(lists.cid.shape[0]):
        t = lists.tlb[g, :int(lists.count[g])]
        assert (t[1:] >= t[:-1]).all()


def test_per_set_gate_is_conservative(trees):
    """Kernel B's lists: every (set, group, cluster) a segment of the set
    gates carries the set's bit."""
    _, ttree = trees
    lights, _, dirs, tm = shadow_segments(seed=12)
    lists = multi_worklists(ttree, torch.from_numpy(lights),
                            torch.from_numpy(dirs), torch.from_numpy(tm))
    ns, nb = dirs.shape[0], dirs.shape[2]
    listed = listed_matrix(lists, ttree.tri_data.shape[0], ns)
    for s in range(ns):
        o = np.broadcast_to(lights[s][:, None, None], dirs[s].shape).copy()
        need = rows_gated(ttree, o, dirs[s], tm[s])
        assert need.any()
        assert not (need & ~listed[s * nb:(s + 1) * nb]).any()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", [7, 9])
def test_closest_plain_modes_equal_default(trees, mode, seed):
    _, ttree = trees
    o, d, tm = (torch.from_numpy(x) for x in rays(seed))
    want = trace_dense(ttree, o, d, tm)
    got = trace_dense(ttree, o, d, tm, **MODES[mode])
    assert (want[1] >= 0).float().mean() > 0.3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_closest_point_origin_recheck_equals_default(trees):
    _, ttree = trees
    pts, d, tm = (torch.from_numpy(x) for x in point_rays(4, 512))
    kw = dict(block=512, point_origin=True)
    want = trace_dense(ttree, pts, d, tm, **kw)
    for mode in MODES.values():
        for g, w in zip(trace_dense(ttree, pts, d, tm, **kw, **mode), want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_occluded_plain_modes_equal_default(trees, mode):
    _, ttree = trees
    lights, _, dirs, tm = (torch.from_numpy(x)
                           for x in shadow_segments(seed=13))
    want = occluded_multi(ttree, lights, dirs, tm)
    got = occluded_multi(ttree, lights, dirs, tm, **MODES[mode])
    assert want.any() and not want.all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["sub_gate", "recheck"])
def test_occluded_modes_match_jax_kernel(trees, mode):
    """The port's B in a mode against the JAX kernel in the same mode
    (interpret): masks equal (any-hit; the JAX contract, test_dense.py)."""
    jtree, ttree = trees
    lights, _, dirs, tm = shadow_segments(seed=14)
    want = np.asarray(jax_occluded_multi(
        jtree, jnp.asarray(lights), jnp.asarray(dirs), jnp.asarray(tm),
        interpret=True, **MODES[mode]))
    got = occluded_multi(ttree, torch.from_numpy(lights),
                         torch.from_numpy(dirs), torch.from_numpy(tm),
                         **MODES[mode])
    np.testing.assert_array_equal(got.numpy(), want)


def test_sub_run_pass_empty_and_face_boxes():
    """An inverted box fails (with finite, huge and infinite corners, so
    no NaN can decide); a box that is flat on the face a ray hits passes
    at the hit's own t (the widening keeps it)."""
    boxes = torch.zeros(1, 128, 128)
    big = 3.0e38
    boxes[0, 0, SUB_COL:SUB_COL + 6] = torch.tensor([big] * 3 + [-big] * 3)
    boxes[0, 1, SUB_COL:SUB_COL + 6] = torch.tensor(
        [float("inf")] * 3 + [float("-inf")] * 3)
    boxes[0, 2, SUB_COL:SUB_COL + 6] = torch.tensor([1.0, 2.0, 1.0,
                                                     0.0, 3.0, 2.0])
    # sub-run 3: the unit square at y = 2 (flat), hit from above
    boxes[0, 3, SUB_COL:SUB_COL + 6] = torch.tensor([0.0, 2.0, 0.0,
                                                     1.0, 2.0, 1.0])
    tree = type("T", (), {"tri_data": boxes})()
    o = torch.tensor([[0.25], [5.0], [0.75]])
    d = torch.tensor([[0.0], [-1.0], [0.0]])
    inv = dense._safe_inv(d)
    ok = sub_run_pass(tree, torch.tensor([0]), o, inv, torch.tensor([3.0]))
    assert ok.shape == (1, SUBRUNS)
    assert ok[0].tolist()[:4] == [False, False, False, True]
    # at the far bound of the hit itself, and one ulp below it
    t_hit = torch.tensor([3.0])
    assert bool(sub_run_pass(tree, torch.tensor([0]), o, inv, t_hit)[0, 3])
    below = torch.nextafter(t_hit, torch.tensor([0.0]))
    assert bool(sub_run_pass(tree, torch.tensor([0]), o, inv, below)[0, 3])


def test_empty_sub_run_commits_nothing(trees):
    """Sub-run 0 of every cluster emptied (its 16 rows zeroed, its box
    inverted): with sub_gate the traces equal the default on that tree,
    and no slot of the emptied runs is ever hit."""
    _, ttree = trees
    td = ttree.tri_data.clone()
    td[:, :16, :36] = 0.0
    td[:, 0, SUB_COL:SUB_COL + 6] = torch.tensor([3.0e38] * 3 + [-3.0e38] * 3)
    tree = ttree._replace(tri_data=td)
    o, d, tm = (torch.from_numpy(x) for x in rays(10))
    want = trace_dense(tree, o, d, tm)
    got = trace_dense(tree, o, d, tm, sub_gate=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hit = got[1][got[1] >= 0]
    assert hit.numel() > 0 and not ((hit % 128) < 16).any()
    lights, _, dirs, tmo = (torch.from_numpy(x)
                            for x in shadow_segments(seed=15))
    assert torch.equal(occluded_multi(tree, lights, dirs, tmo, sub_gate=True),
                       occluded_multi(tree, lights, dirs, tmo))


def test_unported_pregate_and_occlusion_modes_raise(trees):
    """The interval pregate and kernel A''s modes, now ported (the name is
    kept from when they raised): each gives the default's outputs; the
    default plain version takes no lists."""
    _, ttree = trees
    o, d, tm = (torch.from_numpy(x) for x in rays())
    want = trace_dense(ttree, o, d, tm)
    for pregate in (True, "interval"):
        for g, w in zip(trace_dense(ttree, o, d, tm, pregate=pregate), want):
            assert torch.equal(g, w)
    blocked = trace_dense(ttree, o, d, tm, occlusion=True)
    for kw in (dict(sub_gate=True), dict(pregate="recheck"),
               dict(pregate=True, sub_gate=True)):
        for g, w in zip(trace_dense(ttree, o, d, tm, occlusion=True, **kw),
                        blocked):
            assert torch.equal(g, w)
    assert (blocked[1] >= 0).any()
    out = trace_dense_plain(ttree, o, d, tm)
    for g, w in zip(out, trace_dense(ttree, o, d, tm, pregate=False)):
        assert torch.equal(g, w)
