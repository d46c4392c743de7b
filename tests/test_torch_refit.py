"""vkrt_tpu_torch.accel.refit vs the JAX package's refit_clusters (CPU).

The same tree (built by the JAX package, carried across with
`tree_from_numpy`) and the same 4x4 matrix go through both functions.
The arithmetic is the same elementwise float32 on both sides, but XLA's
CPU code contracts the product-sums of `mat_rows3` into fused
multiply-adds and torch rounds every product, so results differ by an
ulp of the coordinate: the bar is 1e-6 relative to max(1, |value|)
(rtol = atol = 1e-6; the scene spans ~50 units, where one float32 ulp is
3.8e-6). Against the same products rounded one by one in numpy the port
is bit-equal, which is the stronger check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu.accel.clusters import build_clusters as jax_build_clusters
from vkrt_tpu.accel.clusters import scene_attrs as jax_scene_attrs
from vkrt_tpu.accel.refit import refit_clusters as jax_refit_clusters
from vkrt_tpu.scene import flatten_model
from vkrt_tpu_torch.accel.clusters import (K1, SUB_COL, SUBRUNS,
                                           tree_from_numpy)
from vkrt_tpu_torch.accel.refit import refit_clusters
from vkrt_tpu_torch.rt.dense import trace_dense
from vkrt_tpu_torch.scene.procedural import procedural_model
import torch_support  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def affine(angle=0.0, translate=(0.0, 0.0, 0.0), scale=1.0):
    """Rotation about y by `angle`, uniform `scale`, then `translate`."""
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * scale
    m[:3, 3] = translate
    return m


MATRICES = {
    "identity": affine(),
    "translation": affine(translate=(1.5, -2.0, 0.25)),
    "uniform_scale": affine(scale=1.5),
    "rotation": affine(0.7, (0.3, -0.2, 0.1)),
}


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
    ttree = tree_from_numpy(*(np.asarray(a) for a in jtree), device="cpu")
    return jtree, ttree


def rows3(x, a):
    """numpy float32 twin of layout.mat_rows3: each product rounded."""
    return (x[..., 0:1] * a[:, 0] + x[..., 1:2] * a[:, 1]
            + x[..., 2:3] * a[:, 2])


@pytest.mark.parametrize("name", list(MATRICES))
def test_refit_matches_jax(trees, name):
    jtree, ttree = trees
    m = MATRICES[name]
    want = jax_refit_clusters(jtree, jnp.asarray(m))
    got = refit_clusters(ttree, torch.from_numpy(m))
    for field, g, w in zip(ttree._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, field
        if field == "leaf_tri" or name in ("identity", "translation"):
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, err_msg=field, **TOL)
    if name == "identity":
        # the tree itself, up to the sub-run boxes of the padding
        # clusters (inverted after a refit, zero after a build: no
        # triangle lives there, and the JAX refit does the same)
        assert torch.equal(got.sc_boxes, ttree.sc_boxes)
        assert torch.equal(got.cl_boxes, ttree.cl_boxes)
        assert torch.equal(got.tri_data[..., :36], ttree.tri_data[..., :36])


@pytest.mark.parametrize("name", ["uniform_scale", "rotation"])
def test_refit_geometry_is_bit_equal_to_rounded_products(trees, name):
    """v0, e1, e2, normals and tangents equal the numpy float32 products
    rounded one at a time — no contraction, no reduced precision."""
    _, ttree = trees
    m = MATRICES[name]
    td = ttree.tri_data.numpy()
    got = refit_clusters(ttree, torch.from_numpy(m)).tri_data.numpy()
    a, b = m[:3, :3], m[:3, 3]
    np.testing.assert_array_equal(got[..., 0:3], rows3(td[..., 0:3], a) + b)
    for c in (3, 6, 9, 12, 15, 24, 27, 30):
        np.testing.assert_array_equal(got[..., c:c + 3],
                                      rows3(td[..., c:c + 3], a))


def test_refit_rotates_directions_only(trees):
    """Normals (cols 9-17) and tangents (24-32) rotate with the 3x3 part
    and ignore the translation; uvs (18-23) and material ids (33-35) do
    not change."""
    _, ttree = trees
    m = MATRICES["rotation"]
    td = ttree.tri_data.numpy()
    got = refit_clusters(ttree, torch.from_numpy(m)).tri_data.numpy()
    live = ttree.leaf_tri.numpy().reshape(-1, K1) >= 0
    c1 = live.shape[0]
    n0 = td[:c1, :, 9:12][live].astype(np.float64)
    np.testing.assert_allclose(got[:c1, :, 9:12][live],
                               n0 @ m[:3, :3].astype(np.float64).T, atol=1e-6)
    assert np.abs(got[:c1, :, 9:12][live] - n0).max() > 0.1     # it moved
    np.testing.assert_allclose(
        np.linalg.norm(got[:c1, :, 24:27][live], axis=1),
        np.linalg.norm(td[:c1, :, 24:27][live], axis=1), atol=1e-5)
    np.testing.assert_array_equal(got[..., 18:24], td[..., 18:24])
    np.testing.assert_array_equal(got[..., 33:36], td[..., 33:36])
    np.testing.assert_array_equal(got[..., 46:], td[..., 46:])


def test_refit_boxes_bound_the_moved_triangles(trees):
    """Cluster, supercluster and sub-run boxes are those of the
    transformed triangles; padding clusters and lanes stay inverted."""
    _, ttree = trees
    out = refit_clusters(ttree, torch.from_numpy(MATRICES["rotation"]))
    td = out.tri_data.numpy()
    live = ttree.leaf_tri.numpy().reshape(-1, K1) >= 0
    c1 = live.shape[0]
    v0 = td[:c1, :, 0:3]
    pts = np.stack([v0, v0 + td[:c1, :, 3:6], v0 + td[:c1, :, 6:9]])
    lo = np.where(live[..., None], pts.min(axis=0), 3e38)
    hi = np.where(live[..., None], pts.max(axis=0), -3e38)
    clb = out.cl_boxes.numpy()
    cl_lo = clb[:, 0:3, :].transpose(0, 2, 1).reshape(-1, 3)
    cl_hi = clb[:, 3:6, :].transpose(0, 2, 1).reshape(-1, 3)
    np.testing.assert_array_equal(cl_lo[:c1], lo.min(axis=1))
    np.testing.assert_array_equal(cl_hi[:c1], hi.max(axis=1))
    assert (cl_lo[c1:] > cl_hi[c1:]).all()                # padding clusters
    scb = out.sc_boxes.numpy()
    n_sc = out.num_superclusters
    np.testing.assert_array_equal(scb[0:3, :n_sc].T,
                                  cl_lo.reshape(n_sc, -1, 3).min(axis=1))
    assert (scb[0:3, n_sc:] > scb[3:6, n_sc:]).all()      # padding lanes
    run = K1 // SUBRUNS
    np.testing.assert_array_equal(
        td[:c1, :SUBRUNS, SUB_COL:SUB_COL + 3],
        lo.reshape(c1, SUBRUNS, run, 3).min(axis=2))
    np.testing.assert_array_equal(
        td[:c1, :SUBRUNS, SUB_COL + 3:SUB_COL + 6],
        hi.reshape(c1, SUBRUNS, run, 3).max(axis=2))
    # and they moved with the transform
    assert not np.array_equal(td[:c1, :SUBRUNS, SUB_COL:SUB_COL + 6],
                              ttree.tri_data.numpy()[:c1, :SUBRUNS,
                                                     SUB_COL:SUB_COL + 6])


def test_refit_tree_traces_as_shifted_rays(trees):
    """Rays against the tree moved by +t hit what rays moved by -t hit on
    the original tree (tests/test_refit.py's contract): same slots, t to
    1e-4."""
    _, ttree = trees
    shift = np.array([1.5, -2.0, 0.25], np.float32)
    moved = refit_clusters(ttree, torch.from_numpy(affine(translate=shift)))
    rng = np.random.default_rng(5)
    n = 1024
    o = rng.uniform([-12, 1, -7], [12, 10, 8], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cv = lambda x: torch.from_numpy(
        np.moveaxis(x.reshape(-1, 128, 3), -1, 0).copy())
    tmax = torch.full((n // 128, 128), 1e3)
    t0, s0 = trace_dense(ttree, cv(o), cv(d), tmax)[:2]
    t1, s1 = trace_dense(moved, cv(o + shift), cv(d), tmax)[:2]
    assert torch.equal(s0 >= 0, s1 >= 0)
    same = (s0 == s1) & (s0 >= 0)
    assert same.sum() >= 0.99 * (s0 >= 0).sum() > 0.5 * n
    np.testing.assert_allclose(t1[same].numpy(), t0[same].numpy(), rtol=1e-4)
