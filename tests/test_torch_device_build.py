"""The port's device build of the cluster tree vs the JAX package's (CPU).

`morton30`, `_assemble` and `device_sah_order` are plain torch; the same
numpy inputs go through them and through the JAX functions. Bars: Morton
codes equal; `_assemble`'s tree byte-equal to the JAX `_assemble` tree
and to the port's host assembly for the same order; `device_sah_order` a
true permutation EQUAL to the JAX order in every mode (min, max,
whole-number sums, one sort per level and elementwise float32 on both
sides; XLA's CPU code contracts the SAH costs' product sums into fused
multiply-adds, and the port rounds those once too, so ties fall alike);
total cluster area at most 1.30x the host build's and
below 0.8x the Morton order's (tests/test_device_sah.py's bars). The cut
round's plain version (`_cut_round`, the specification kernel H is held
to on the card) equal to a direct loop over each segment's cuts; its
wrapper `cut_round` on the CPU runs it and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu.accel.clusters import _assemble as jax_assemble
from vkrt_tpu.accel.clusters import scene_attrs as jax_scene_attrs
from vkrt_tpu.accel.device_sah import device_sah_order as jax_sah_order
from vkrt_tpu.accel.lbvh import morton30 as jax_morton30
from vkrt_tpu.scene import flatten_model
from chip_smoke import CUT_KINDS, CUT_SIZES, cut_case
from vkrt_tpu_torch.accel import clusters as tc
from vkrt_tpu_torch.accel.device_sah import (_cut_round, cut_round,
                                             device_sah_order)
from vkrt_tpu_torch.accel.lbvh import morton30
from vkrt_tpu_torch.scene.procedural import procedural_model
import torch_support  # noqa: F401


def triangles(kind: str):
    """(v0, e1, e2) f32[T,3]: the small procedural scene (2,000
    triangles), or 20,011 random ones in a flat slab — more than one
    supercluster, so the K1*K2-aligned cuts run, and a ragged tail."""
    if kind == "scene":
        flat = flatten_model(procedural_model("small", seed=0))
        idx = np.asarray(flat.indices, dtype=np.int64)
        v0 = flat.positions[idx[:, 0]]
        return (v0, flat.positions[idx[:, 1]] - v0,
                flat.positions[idx[:, 2]] - v0)
    rng = np.random.default_rng(3)
    n = 20011
    v0 = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    v0[:, 1] *= 0.2
    e1 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return v0, e1, e2


def to_torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def cluster_area(order, v0, e1, e2, k1=tc.K1):
    """Total cluster-AABB area of a triangle order (float64)."""
    v0, e1, e2 = (x.astype(np.float64) for x in (v0, e1, e2))
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)[order]
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)[order]
    pad = -len(order) % k1
    tmin = np.concatenate([tmin, np.full((pad, 3), 3e38)])
    tmax = np.concatenate([tmax, np.full((pad, 3), -3e38)])
    ext = np.maximum(tmax.reshape(-1, k1, 3).max(axis=1)
                     - tmin.reshape(-1, k1, 3).min(axis=1), 0)
    return (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0]).sum()


def centroid_codes(v0, e1, e2):
    c = v0 + (e1 + e2) / 3.0
    lo, hi = c.min(axis=0), c.max(axis=0)
    return c, lo, hi


@pytest.mark.parametrize("kind", ["scene", "random"])
def test_morton30_equals_jax(kind):
    c, lo, hi = centroid_codes(*triangles(kind))
    # points outside [lo, hi] clip to the range's ends
    c = np.concatenate([c, lo[None] - 1.0, hi[None] + 1.0]).astype(np.float32)
    want = np.asarray(jax_morton30(jnp.asarray(c), jnp.asarray(lo),
                                   jnp.asarray(hi)))
    got = morton30(*to_torch(c, lo, hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0 and got.max() == (1 << 30) - 1


@pytest.mark.parametrize("with_attributes", [False, True])
def test_assemble_is_byte_equal(with_attributes):
    flat = flatten_model(procedural_model("small", seed=0))
    v0, e1, e2 = triangles("scene")
    attrs = jax_scene_attrs(flat) if with_attributes else None
    order = np.random.default_rng(4).permutation(len(v0)).astype(np.int32)
    want = jax_assemble(
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), jnp.asarray(order),
        attrs and {k: jnp.asarray(x) for k, x in attrs.items()},
        with_attributes)
    host = tc._assemble_host(v0, e1, e2, order, attrs, with_attributes)
    got = tc._assemble(*to_torch(v0, e1, e2, order),
                       attrs and dict(zip(attrs, to_torch(*attrs.values()))),
                       with_attributes)
    for field, g, w, h in zip(got._fields, got, want, host):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == h.dtype, field
        assert g.tobytes() == w.tobytes(), field
        assert g.tobytes() == h.tobytes(), field
    assert got.sc_boxes.shape[1] == 128 and got.tri_data.shape[0] % tc.K2 == 0


@pytest.mark.parametrize("kind", ["scene", "random"])
def test_device_sah_order_equals_jax(kind):
    v0, e1, e2 = triangles(kind)
    want = np.asarray(jax_sah_order(jnp.asarray(v0), jnp.asarray(e1),
                                    jnp.asarray(e2)))
    got = device_sah_order(*to_torch(v0, e1, e2))
    assert got.dtype == torch.int32 and got.shape == (len(v0),)
    got = got.numpy()
    np.testing.assert_array_equal(np.sort(got), np.arange(len(v0)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["scene", "random"])
def test_device_sah_order_quality(kind):
    v0, e1, e2 = triangles(kind)
    order = device_sah_order(*to_torch(v0, e1, e2)).numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(len(v0)))
    host = tc.split_permutation(v0, e1, e2)
    c, lo, hi = centroid_codes(v0, e1, e2)
    codes = morton30(*to_torch(c.astype(np.float32), lo, hi)).numpy()
    sa = cluster_area(order, v0, e1, e2)
    sa_host = cluster_area(host, v0, e1, e2)
    sa_morton = cluster_area(np.argsort(codes, kind="stable"), v0, e1, e2)
    assert sa <= 1.30 * sa_host, (sa, sa_host)
    assert sa < 0.8 * sa_morton, (sa, sa_morton)


def test_device_sah_levels_and_bins_are_arguments():
    """max_levels and nbins stay arguments: fewer levels leave coarser
    (larger-area) clusters; each result is a permutation."""
    v0, e1, e2 = triangles("scene")
    areas = []
    for levels in (1, 3, 14):
        order = device_sah_order(*to_torch(v0, e1, e2), max_levels=levels,
                                 nbins=8).numpy()
        np.testing.assert_array_equal(np.sort(order), np.arange(len(v0)))
        areas.append(cluster_area(order, v0, e1, e2))
    assert areas[0] > areas[1] > areas[2]


def line_triangles():
    """(v0, e1, e2) of 1,024 triangles whose centroids lie evenly spaced
    on the line x = y = z, each jittered in shape: every segment of every
    level holds a run of the line, so no two of its triangles share a
    quantised centroid on any axis and the sort keys are distinct (the
    order of equal keys, which `stable=False` leaves open, is defined by
    neither package)."""
    rng = np.random.default_rng(4)
    n = 1024
    c = np.repeat(np.linspace(-10, 10, n, dtype=np.float32)[:, None], 3, 1)
    e1 = (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    v0 = (c - (e1 + e2) / 3.0).astype(np.float32)
    return v0, e1, e2


@pytest.mark.parametrize("opts", [dict(axis_mode="extent"),
                                  dict(axis_mode="variance"),
                                  dict(axis_mode="slab"),
                                  dict(axis_mode="hybrid:4"),
                                  dict(axis_mode="sampled:8"),
                                  dict(cuts=2), dict(stable=False)],
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_unported_sah_modes_raise(opts):
    """The ablation modes of the JAX device_sah_order, now ported (the
    name is kept from when they raised): each order equal to the JAX
    order on the small scene (stable=False: on `line_triangles`, whose
    keys are distinct), a permutation, and build_clusters(method="sah",
    sah_opts=...) the tree `_assemble` makes of it."""
    tris = line_triangles() if opts == dict(stable=False) \
        else triangles("scene")
    want = np.asarray(jax_sah_order(*map(jnp.asarray, tris), **opts))
    v0, e1, e2 = to_torch(*tris)
    got = device_sah_order(v0, e1, e2, **opts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.sort(want), np.arange(len(want)))
    tree = tc.build_clusters(v0, e1, e2, method="sah", sah_opts=opts)
    for g, w in zip(tree, tc._assemble(v0, e1, e2, got)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("method", ["sah", "split", "morton"])
def test_device_build_dispatch(method):
    """build_clusters on torch tensors orders on the device: "sah" and
    "split" by device_sah_order, "morton" by the Morton argsort inside
    the given AABB; the tree is `_assemble` of that order."""
    v0, e1, e2 = to_torch(*triangles("scene"))
    c, lo, hi = centroid_codes(*triangles("scene"))
    tree = tc.build_clusters(v0, e1, e2, method=method, aabb=(lo, hi))
    if method == "morton":
        order = torch.argsort(morton30(*to_torch(c, lo, hi)), stable=True)
    else:
        order = device_sah_order(v0, e1, e2)
    want = tc._assemble(v0, e1, e2, order)
    for g, w in zip(tree, want):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(
        np.sort(tree.leaf_tri.numpy()[tree.leaf_tri.numpy() >= 0]),
        np.arange(len(v0)))


def test_host_build_keeps_working_and_rejects_unknown_method():
    v0, e1, e2 = triangles("scene")
    tree = tc.build_clusters(v0, e1, e2, device="cpu")
    want = tc._assemble_host(v0, e1, e2, tc.split_permutation(v0, e1, e2))
    for g, w in zip(tree, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # numpy inputs with a device method go to `device` first
    morton = tc.build_clusters(v0, e1, e2, device="cpu", method="morton")
    assert isinstance(morton.tri_data, torch.Tensor)
    with pytest.raises(ValueError, match="unknown method"):
        tc.build_clusters(v0, e1, e2, method="lbvh")


def _area_np(ext, fused: bool):
    """device_sah._area's rounding in numpy (float32; `fused`: each
    product sum in float64, rounded to float32 once)."""
    e0, e1, e2 = ext[:, 0], ext[:, 1], ext[:, 2]
    if not fused:
        return e2 * e0 + (e0 * e1 + e1 * e2)

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c.astype(np.float64)).astype(
            np.float32)
    return fma(e2, e0, fma(e0, e1, e1 * e2))


def cut_round_loop(cb, nmin, nmax, ncnt, fused: bool):
    """A cut round written out segment by segment: the box and count of
    each side of every K1-aligned cut (K2-aligned in a segment of more
    than K2 chunks) that leaves triangles on both sides, its SAH cost
    (the left side's area times its count, plus the right side's), and
    the first cut of the least cost, if that is below _INF."""
    cb, nmin, nmax, ncnt = (x.numpy() for x in (cb, nmin, nmax, ncnt))
    out = cb.copy()
    starts = np.flatnonzero(cb)
    for s, e in zip(starts, list(starts[1:]) + [len(cb)]):
        align = tc.K2 if e - s > tc.K2 else 1
        ks = np.arange(align, e - s, align)         # cut before chunk s + k
        if not len(ks):
            continue
        mn, mx, ct = nmin[s:e], nmax[s:e], ncnt[s:e].astype(np.float64)
        with np.errstate(over="ignore"):
            cost_l = _area_np(np.maximum(np.maximum.accumulate(mx)
                                         - np.minimum.accumulate(mn), 0),
                              fused) * np.cumsum(ct).astype(np.float32)
            cost_r = _area_np(np.maximum(
                np.maximum.accumulate(mx[::-1])[::-1]
                - np.minimum.accumulate(mn[::-1])[::-1], 0),
                fused) * np.cumsum(ct[::-1])[::-1].astype(np.float32)
        left = np.cumsum(ct)
        right = np.cumsum(ct[::-1])[::-1]
        cost = np.where((left[ks - 1] > 0) & (right[ks] > 0),
                        cost_l[ks - 1] + cost_r[ks], np.float32(tc._INF))
        if cost.min() < np.float32(tc._INF):
            out[s + ks[np.argmin(cost)]] = True      # the first minimum
    return torch.from_numpy(out)


@pytest.mark.parametrize("kind", CUT_KINDS)
@pytest.mark.parametrize("nc", CUT_SIZES)
def test_plain_cut_round_matches_segment_loop(nc, kind):
    """`_cut_round`'s segmented scans (int64 cummin / cummax keys) give
    the same new boundaries as the loop over segments, rounded either
    way; exact ties (kind "ties") go to the lowest chunk, padding-only
    chunks (+-_INF boxes) cost nothing, and a segment without a valid cut
    gets no bit."""
    args = cut_case(nc, kind)
    for fused in (False, True):
        got = _cut_round(*args, fused)
        want = cut_round_loop(*args, fused)
        assert torch.equal(got, want), fused
        assert torch.equal(got & args[0], args[0])
    if kind == "singles":
        assert torch.equal(got, args[0])


@pytest.mark.parametrize("fused", [False, True])
def test_cut_round_on_cpu_runs_the_plain_version(fused):
    """cut_round on CPU tensors is `_cut_round` and launches nothing; so
    does a whole CPU build."""
    before = cut_round.launches
    for kind in CUT_KINDS:
        args = cut_case(2049, kind)
        assert torch.equal(cut_round(*args, fused), _cut_round(*args, fused))
    device_sah_order(*to_torch(*triangles("scene")))
    assert cut_round.launches == before == 0


def _bad_cut_inputs():
    cb, nmin, nmax, ncnt = cut_case(65, "mixed")
    wide = torch.zeros(65, 4)
    return {
        "cb_dtype": (cb.to(torch.uint8), nmin, nmax, ncnt),
        "cb_shape": (cb[:, None], nmin, nmax, ncnt),
        "nmin_dtype": (cb, nmin.double(), nmax, ncnt),
        "nmax_shape": (cb, nmin, wide, ncnt),
        "ncnt_shape": (cb, nmin, nmax, ncnt[:, None]),
        "ncnt_length": (cb, nmin, nmax, ncnt[:64]),
        "strided": (cb, nmin, wide[:, :3], ncnt),
        "devices": (cb, nmin, nmax, ncnt.to("meta")),
        "unsupported": tuple(x.to("meta") for x in (cb, nmin, nmax, ncnt)),
    }


@pytest.mark.parametrize("case", list(_bad_cut_inputs()))
def test_cut_round_checks_its_arguments(case):
    """What kernel H does not take raises ValueError on every device, as
    wavefront/pack.py's checks do: dtypes, shapes, contiguity, one
    device, and a device that is neither the CPU nor CUDA."""
    match = {"strided": "contiguous", "devices": "contiguous",
             "unsupported": "unsupported device"}.get(case, "want bool")
    with pytest.raises(ValueError, match=match):
        cut_round(*_bad_cut_inputs()[case], False)
