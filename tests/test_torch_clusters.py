"""vkrt_tpu_torch host cluster build vs vkrt_tpu.accel.clusters.

The port carries a numpy copy of the host build (the JAX module imports
jax at its top); the trees must be byte-equal, attributes included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu.accel import clusters as jc
from vkrt_tpu.scene import flatten_model
from vkrt_tpu_torch.accel import clusters as tc
from vkrt_tpu_torch.scene.procedural import procedural_model
import torch_support  # noqa: F401


@pytest.fixture(scope="module")
def geometry():
    flat = flatten_model(procedural_model("small", seed=0))
    idx = np.asarray(flat.indices, dtype=np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0
    return flat, v0, e1, e2


def test_split_permutation_equal(geometry):
    _, v0, e1, e2 = geometry
    np.testing.assert_array_equal(tc.split_permutation(v0, e1, e2),
                                  jc.split_permutation(v0, e1, e2))


def test_scene_attrs_equal(geometry):
    flat = geometry[0]
    want = jc.scene_attrs(flat)
    got = tc.scene_attrs(flat)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("with_attributes", [True, False])
def test_tree_byte_equal(geometry, with_attributes):
    flat, v0, e1, e2 = geometry
    jtree = jc.build_clusters(jnp.asarray(v0), jnp.asarray(e1),
                              jnp.asarray(e2), attrs=jc.scene_attrs(flat),
                              with_attributes=with_attributes, device=False)
    ttree = tc.build_clusters(v0, e1, e2, attrs=tc.scene_attrs(flat),
                              with_attributes=with_attributes, device="cpu")
    for name, j, t in zip(tc.ClusterTree._fields, jtree, ttree):
        j = np.asarray(j)
        assert t.dtype == {np.float32: torch.float32,
                           np.int32: torch.int32}[j.dtype.type], name
        assert t.numpy().tobytes() == j.tobytes(), name
    assert ttree.num_clusters == jtree.num_clusters
    assert ttree.num_superclusters == jtree.num_superclusters


def test_tree_from_numpy_round_trip(geometry):
    flat, v0, e1, e2 = geometry
    jtree = jc.build_clusters(jnp.asarray(v0), jnp.asarray(e1),
                              jnp.asarray(e2), attrs=jc.scene_attrs(flat),
                              with_attributes=True, device=False)
    carried = tc.tree_from_numpy(*(np.asarray(a) for a in jtree),
                                 device="cpu")
    again = tc.tree_from_numpy(*(a.numpy() for a in carried), device="cpu")
    for j, t, a in zip(jtree, carried, again):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
        assert torch.equal(t, a)
    # the carried tensors own their memory (not views of the jax buffers)
    assert all(t.numpy().flags.writeable for t in carried)


def test_tree_from_numpy_rejects_other_k1():
    with pytest.raises(ValueError, match="tri_data"):
        tc.tree_from_numpy(np.zeros((8, 128), np.float32),
                           np.zeros((1, 8, 64), np.float32),
                           np.zeros((64, 64, 128), np.float32),
                           np.zeros(64 * 64, np.int32), device="cpu")


def test_boxes_bound_their_triangles(geometry):
    """Every leaf triangle lies inside its cluster's box, and every
    cluster box inside its supercluster's box."""
    v0, e1, e2 = (np.asarray(a, np.float32) for a in geometry[1:])
    tree = tc.build_clusters(v0, e1, e2, device="cpu")
    leaf = tree.leaf_tri.numpy()
    live = leaf >= 0
    cl = np.arange(leaf.shape[0]) // tc.K1
    cl_lo = tree.cl_boxes[:, 0:3].permute(1, 0, 2).reshape(3, -1).numpy().T
    cl_hi = tree.cl_boxes[:, 3:6].permute(1, 0, 2).reshape(3, -1).numpy().T
    for vert in (v0, v0 + e1, v0 + e2):
        p = vert[leaf[live]]
        assert (p >= cl_lo[cl[live]]).all() and (p <= cl_hi[cl[live]]).all()
    n_cl = int(cl[live].max()) + 1
    sc = np.arange(n_cl) // tc.K2
    sc_lo = tree.sc_boxes[0:3].numpy().T[sc]
    sc_hi = tree.sc_boxes[3:6].numpy().T[sc]
    assert (cl_lo[:n_cl] >= sc_lo).all() and (cl_hi[:n_cl] <= sc_hi).all()


def test_build_clusters_defaults_to_the_card(geometry):
    """Like every entry point of the port, the build puts its tree on the
    card unless the caller asks for the CPU: without a card the default
    raises, and device="cpu" builds there."""
    import inspect
    assert inspect.signature(tc.build_clusters).parameters[
        "device"].default == "cuda"
    _, v0, e1, e2 = geometry
    tree = tc.build_clusters(v0, e1, e2, device="cpu")
    assert all(x.device.type == "cpu" for x in tree)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tc.build_clusters(v0, e1, e2)
