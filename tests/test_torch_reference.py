"""The reference backend of vkrt_tpu_torch (accel/lbvh.py, rt/intersect.py,
rt/traverse.py, wavefront/engine.py::ReferenceBackend) vs the JAX
package's XLA reference backend.

build_lbvh runs the same integer and min/max arithmetic on the same
float32 centroids, so every node array is equal. The traversal is held
to tests/test_traverse.py's contracts against the port's brute-force
oracle (hit masks equal, t within rtol 1e-4, >= 99% of triangle ids,
>= 99.5% of occlusion answers) and against the JAX traversal (the same
hits; t, u, v within 1e-5: the same formulas, summed in another order).
Frames: 64x48 config 4, RMSE <= 1e-3 (BASELINE.json) against the JAX
reference backend's frame and the port's dense frame, equal ray counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as JC
from vkrt_tpu.accel import lbvh as jlbvh
from vkrt_tpu.app.framebuffer import rmse
from vkrt_tpu.rt import intersect as jint
from vkrt_tpu.rt import traverse as jtrav
from vkrt_tpu.scene import flatten_model
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.accel import lbvh as tlbvh
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.golden.cpu_tracer import closest_hit as brute_closest
from vkrt_tpu_torch.golden.cpu_tracer import occluded as brute_occluded
from vkrt_tpu_torch.raster.pipeline import Rasterizer
from vkrt_tpu_torch.rt import intersect as tint
from vkrt_tpu_torch.rt import traverse as ttrav
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

W, H = 64, 48
RMSE_BAR = 1e-3
ATOL = 1e-5
FIELDS = ("boxes", "kids", "tri_v0", "tri_e1", "tri_e2", "leaf_tri")


def t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def random_tris(rng, n, spread=10.0, edge=1.0):
    return tuple(rng.uniform(-s, s, (n, 3)).astype(np.float32)
                 for s in (spread, edge, edge))


def make_rays(rng, n=256):
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def walk_leaves(kids):
    """Leaf slots and internal nodes reached from the root."""
    kids = np.asarray(kids)
    leaves, seen, stack = [], set(), [0]
    while stack:
        n = stack.pop()
        assert n not in seen, "cycle in BVH"
        seen.add(n)
        for c in kids[n]:
            if c < 0:
                leaves.append(-c - 1)
            else:
                stack.append(int(c))
    return leaves, seen


def assert_bvh_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("n", [2, 3, 7, 64, 1000])
def test_lbvh_equals_jax(rng, n):
    v0, e1, e2 = random_tris(rng, n)
    got = tlbvh.build_lbvh(t32(v0), t32(e1), t32(e2))
    assert_bvh_equal(got, jlbvh.build_lbvh(*map(jnp.asarray, (v0, e1, e2))))
    assert got.kids.dtype == torch.int32 and got.leaf_tri.dtype == torch.int32
    leaves, internals = walk_leaves(got.kids)
    assert sorted(leaves) == list(range(n)) and len(internals) == n - 1


def test_lbvh_duplicate_morton_codes():
    """All triangles at one point: identical codes, the index tie-break
    still gives a valid tree, the JAX package's."""
    v0 = np.zeros((33, 3), np.float32)
    e1 = np.tile(np.float32([[1, 0, 0]]), (33, 1))
    e2 = np.tile(np.float32([[0, 1, 0]]), (33, 1))
    got = tlbvh.build_lbvh(t32(v0), t32(e1), t32(e2))
    assert_bvh_equal(got, jlbvh.build_lbvh(*map(jnp.asarray, (v0, e1, e2))))
    assert sorted(walk_leaves(got.kids)[0]) == list(range(33))
    with pytest.raises(ValueError, match="at least 2"):
        tlbvh.build_lbvh(t32(v0[:1]), t32(e1[:1]), t32(e2[:1]))


def test_node_boxes_contain_descendants(rng):
    n = 500
    bvh = tlbvh.build_lbvh(*map(t32, random_tris(rng, n)))
    kids, boxes = bvh.kids.numpy(), bvh.boxes.numpy()
    tv0, te1, te2 = (x.numpy() for x in (bvh.tri_v0, bvh.tri_e1,
                                         bvh.tri_e2))
    leaf_min = np.minimum(np.minimum(tv0, tv0 + te1), tv0 + te2)
    leaf_max = np.maximum(np.maximum(tv0, tv0 + te1), tv0 + te2)

    def node_box(node):
        leaves, stack = [], [node]
        while stack:
            for k in kids[stack.pop()]:
                if k < 0:
                    leaves.append(-k - 1)
                else:
                    stack.append(int(k))
        return leaf_min[leaves].min(0), leaf_max[leaves].max(0)

    for node in [0, 1, n // 2, n - 2]:
        for side in (0, 1):
            k = kids[node, side]
            lo, hi = ((leaf_min[-k - 1], leaf_max[-k - 1]) if k < 0
                      else node_box(int(k)))
            np.testing.assert_array_equal(boxes[node, 6 * side:6 * side + 3],
                                          lo)
            np.testing.assert_array_equal(
                boxes[node, 6 * side + 3:6 * side + 6], hi)


def test_intersect_helpers_match_jax(rng):
    n = 512
    o, d = make_rays(rng, n)
    v0, e1, e2 = random_tris(rng, n, spread=2.0)
    d[:8, 0] = 0.0                                 # axis-parallel rays
    tmax = rng.uniform(0.5, 20, n).astype(np.float32)
    want = jint.moller_trumbore(*map(jnp.asarray, (o, d, v0, e1, e2)),
                                1e-3, jnp.asarray(tmax))
    got = tint.moller_trumbore(*map(t32, (o, d, v0, e1, e2)), 1e-3,
                               t32(tmax))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=ATOL)
    inv = tint.safe_inv_dir(t32(d))
    np.testing.assert_array_equal(inv.numpy(),
                                  np.asarray(jint.safe_inv_dir(d)))
    lo = rng.uniform(-3, 0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 3, (n, 3)).astype(np.float32)
    entry, hit = jint.slab_test(*map(jnp.asarray, (lo, hi, o)),
                                jint.safe_inv_dir(d), 1e-3,
                                jnp.asarray(tmax))
    _, tentry, thit = tint.slab_test(*map(t32, (lo, hi, o)), inv, 1e-3,
                                     t32(tmax))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(hit))
    np.testing.assert_array_equal(tentry.numpy(), np.asarray(entry))


@pytest.fixture
def scene(rng):
    v0, e1, e2 = random_tris(rng, 300, spread=5.0, edge=2.0)
    o, d = make_rays(rng)
    return (v0, e1, e2), (o, d), tlbvh.build_lbvh(t32(v0), t32(e1), t32(e2))


def test_closest_matches_jax_and_brute(scene):
    (v0, e1, e2), (o, d), bvh = scene
    t, tri, u, v = (x.numpy() for x in ttrav.trace_closest(
        bvh, t32(o), t32(d), 1e-3, 1e3))
    jbvh = jlbvh.build_lbvh(*map(jnp.asarray, (v0, e1, e2)))
    jt, jtri, ju, jv = (np.asarray(x) for x in jtrav.trace_closest(
        jbvh, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e3))
    np.testing.assert_array_equal(tri, jtri)
    for g, w in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL)
    # tests/test_traverse.py:26 on the port
    bt, btri, bu, bv = brute_closest(o, d, 1e-3, 1e3, v0, e1, e2)
    hit = tri >= 0
    np.testing.assert_array_equal(hit, btri >= 0)
    np.testing.assert_allclose(t[hit], bt[hit], rtol=1e-4, atol=1e-5)
    agree = tri[hit] == btri[hit]
    assert agree.mean() > 0.99
    np.testing.assert_allclose(u[hit][agree], bu[hit][agree], atol=1e-4)
    np.testing.assert_allclose(v[hit][agree], bv[hit][agree], atol=1e-4)
    np.testing.assert_array_equal(t[~hit], 1e3)


def test_occluded_matches_jax_and_brute(scene, rng):
    (v0, e1, e2), (o, d), bvh = scene
    tmax = rng.uniform(0.5, 20.0, o.shape[0]).astype(np.float32)
    occ = ttrav.trace_occluded(bvh, t32(o), t32(d), 1e-3, t32(tmax)).numpy()
    jbvh = jlbvh.build_lbvh(*map(jnp.asarray, (v0, e1, e2)))
    jocc = jtrav.trace_occluded(jbvh, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                jnp.asarray(tmax))
    np.testing.assert_array_equal(occ, np.asarray(jocc))
    bocc = brute_occluded(o, d, 1e-3, tmax, v0, e1, e2)
    assert (occ == bocc).mean() > 0.995
    assert 0 < occ.sum() < occ.size


def test_axis_parallel_degenerate_and_miss():
    """tests/test_traverse.py:55-83 on the port."""
    v0 = np.float32([[0, 0, 5], [0, 0, -5]])
    e1 = np.float32([[1, 0, 0], [1, 0, 0]])
    e2 = np.float32([[0, 1, 0], [0, 1, 0]])
    bvh = tlbvh.build_lbvh(t32(v0), t32(e1), t32(e2))
    o = np.float32([[0.25, 0.25, 0], [0.25, 0.25, 0], [100, 100, 100]])
    d = np.float32([[0, 0, 1], [0, 0, -1], [1, 0, 0]])
    t, tri, _, _ = ttrav.trace_closest(bvh, t32(o), t32(d), 1e-3, 1e3)
    assert tri.tolist() == [0, 1, -1]
    np.testing.assert_allclose(t[:2].numpy(), [5.0, 5.0], rtol=1e-5)
    v0 = np.zeros((4, 3), np.float32)
    e1 = np.zeros((4, 3), np.float32)
    e2 = np.zeros((4, 3), np.float32)
    v0[0], e1[0], e2[0] = [0, 0, 3], [1, 0, 0], [0, 1, 0]   # one real tri
    bvh = tlbvh.build_lbvh(t32(v0), t32(e1), t32(e2))
    t, tri, _, _ = ttrav.trace_closest(bvh, t32([[0.2, 0.2, 0.0]]),
                                       t32([[0, 0, 1.0]]), 1e-3, 1e3)
    assert int(tri[0]) == 0
    np.testing.assert_allclose(float(t[0]), 3.0, rtol=1e-5)


@pytest.fixture(scope="module")
def frame_scene():
    model = procedural_model("small", seed=0)
    cam = Camera(W, H)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    return model, cam


def test_reference_frame_matches_jax_and_dense(frame_scene):
    model, cam = frame_scene
    tcfg = dataclasses.replace(TC.config4_flythrough(), width=W, height=H)
    jcfg = dataclasses.replace(JC.config4_flythrough(), width=W, height=H)
    ref = te.Renderer(model, tcfg, "cpu", backend="reference")
    assert isinstance(ref.backend, te.ReferenceBackend)
    fb, rays = ref.render(cam)
    flat = flatten_model(model)
    want, want_rays = je.render_frame(
        je.make_backend(flat, "reference"),
        je.texture_arrays(model.images, flat), jnp.asarray(cam.proj_inverse),
        jnp.asarray(cam.view_inverse), jnp.asarray(JC.LIGHT_POSITIONS), jcfg)
    dense, dense_rays = te.Renderer(model, tcfg, "cpu").render(cam)
    assert fb.shape == (H, W, 3) and np.isfinite(fb).all()
    assert rmse(fb, np.asarray(want)) <= RMSE_BAR
    assert rmse(fb, dense) <= RMSE_BAR
    assert rays == int(np.asarray(want_rays).sum()) == dense_rays
    assert rays > 2 * W * H                     # shadows and reflections


def test_reference_backend_has_no_accel_update(frame_scene):
    """An identity update (config 5's rebuild_per_frame) is skipped; a
    moving transform raises instead of rendering the unmoved scene."""
    model, cam = frame_scene
    cfg = dataclasses.replace(TC.config5_stress(), width=W, height=H,
                              max_depth=1)
    r = te.Renderer(model, cfg, "cpu", backend="reference")
    fb, _ = r.render(cam)
    fb_id, _ = r.render(cam, transform=np.eye(4))
    np.testing.assert_array_equal(fb_id, fb)
    moved = np.eye(4, dtype=np.float32)
    moved[0, 3] = 0.5
    with pytest.raises(ValueError, match="reference backend"):
        r.render_async(cam, transform=moved)


def test_reference_rasterizer(frame_scene):
    """Rasterizer on the reference backend: "auto" picks the ray-cast
    method, which gives the dense backend's ray-cast frame; the edge
    method needs the cluster tree."""
    model, cam = frame_scene
    cfg = dataclasses.replace(TC.reference_config(), width=W, height=H)
    ref = Rasterizer(model, cfg, "cpu", msaa=1, backend="reference")
    assert ref.method == "wavefront"
    dense = Rasterizer(model, cfg, "cpu", msaa=1, method="wavefront")
    got = ref.render(cam, show_fps=False)
    assert rmse(got, dense.render(cam, show_fps=False)) <= RMSE_BAR
    with pytest.raises(ValueError, match="dense"):
        Rasterizer(model, cfg, "cpu", method="edge", backend="reference")

