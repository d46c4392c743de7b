"""vkrt_tpu_torch/wavefront/resort.py vs vkrt_tpu/wavefront/resort.py (CPU).

The stable permutation, its inverse, the group and ray permutations, the
ray keys (octant, cell), the group keys (cell, direction) and the lane
sort's fine keys (`cell_key_fine` at any bits, `dir_cell_key_fine`), on
the same inputs made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu.wavefront import resort as jrs
from vkrt_tpu_torch.wavefront import resort

GROUP_KEY_AGREE = 0.99


@pytest.mark.parametrize("nbits", [1, 4, resort.GROUP_CELL_KEY_BITS])
def test_radix_partition_perm_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    key = rng.integers(0, 1 << nbits, 4096).astype(np.int32)
    want = np.asarray(jrs.radix_partition_perm(jnp.asarray(key), nbits))
    got = resort.radix_partition_perm(torch.from_numpy(key))
    np.testing.assert_array_equal(got.numpy(), want)


def test_inverse_permutation_and_permute_groups_roundtrip():
    rng = np.random.default_rng(9)
    perm = rng.permutation(96)
    inv = resort.inverse_permutation(torch.from_numpy(perm))
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jrs.inverse_permutation(jnp.asarray(perm))))
    arr = rng.normal(size=(4, 3, 96, 128)).astype(np.float32)
    fwd = resort.permute_groups(torch.from_numpy(arr), torch.from_numpy(perm))
    np.testing.assert_array_equal(
        fwd.numpy(), np.asarray(jrs.permute_groups(jnp.asarray(arr),
                                                   jnp.asarray(perm))))
    np.testing.assert_array_equal(resort.permute_groups(fwd, inv).numpy(), arr)


def test_group_cell_key_matches_jax():
    """Group keys agree with JAX's on >= 99% of groups. The bar is not
    100%: a group's mean sums 128 lanes, torch and XLA may add them in
    another order, and a mean on a cell boundary then quantizes to the
    neighbouring cell. Such a group only moves elsewhere; the masks do not
    depend on the order (see test_torch_reorder.py)."""
    rng = np.random.default_rng(17)
    nb = 512
    aabb = np.array([[-17.5, -1.25, -10.0], [17.5, 13.0, 11.0]], np.float32)
    # groups are spatially tight, as a frame's subtiles are
    centre = rng.uniform(aabb[0], aabb[1], (nb, 3)).astype(np.float32)
    p = (centre[:, None, :] + rng.normal(scale=0.3, size=(nb, 128, 3))
         ).astype(np.float32)
    p = np.moveaxis(p, -1, 0).copy()
    live = rng.random((nb, 128)) < rng.uniform(0, 1, (nb, 1))
    live[:16] = False                                     # all-dead groups
    want = np.asarray(jrs.group_cell_key(jnp.asarray(p), jnp.asarray(live),
                                         jnp.asarray(aabb)))
    got = resort.group_cell_key(torch.from_numpy(p), torch.from_numpy(live),
                                torch.from_numpy(aabb))
    assert got.dtype == torch.int32 and got.shape == (nb,)
    assert (got.numpy() == want).mean() >= GROUP_KEY_AGREE
    assert (got.numpy()[:16] == 1 << 12).all()
    assert got.numpy().max() < 1 << resort.GROUP_CELL_KEY_BITS
    mean, anyl = resort.group_live_mean3(torch.from_numpy(p),
                                         torch.from_numpy(live))
    jmean, janyl = jrs.group_live_mean3(jnp.asarray(p), jnp.asarray(live))
    np.testing.assert_array_equal(anyl.numpy(), np.asarray(janyl))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-5)


# --- the ray-granular keys and partition_closest's keys ------------------

AABB = np.array([[-17.5, -1.25, -10.0], [17.5, 13.0, 11.0]], np.float32)


def wavefront(seed, nb=64):
    """Points inside (and a few outside) the scene box, unit directions
    with some exact zeros and negative zeros, liveness ~70%."""
    rng = np.random.default_rng(seed)
    p = np.moveaxis(rng.uniform(AABB[0] - 2, AABB[1] + 2, (nb, 128, 3)),
                    -1, 0).astype(np.float32)
    d = rng.normal(size=(3, nb, 128)).astype(np.float32)
    d[0, :2] = 0.0
    d[1, 2:4] = -0.0
    d /= np.maximum(np.linalg.norm(d, axis=0, keepdims=True), 1e-6)
    live = rng.random((nb, 128)) < 0.7
    return p, d, live


def test_permute_rays_matches_jax():
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(4, 3, 24, 128)).astype(np.float32)
    perm = rng.permutation(24 * 128).astype(np.int64)
    want = np.asarray(jrs.permute_rays(jnp.asarray(arr), jnp.asarray(perm)))
    got = resort.permute_rays(torch.from_numpy(arr), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), want)
    inv = resort.inverse_permutation(torch.from_numpy(perm))
    np.testing.assert_array_equal(resort.permute_rays(got, inv).numpy(), arr)


@pytest.mark.parametrize("seed", [0, 1])
def test_octant_key_matches_jax(seed):
    _, d, live = wavefront(seed)
    want = np.asarray(jrs.octant_key(jnp.asarray(d), jnp.asarray(live)))
    got = resort.octant_key(torch.from_numpy(d), torch.from_numpy(live))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() < 1 << resort.OCTANT_BITS


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_key_matches_jax(seed):
    p, _, live = wavefront(seed)
    want = np.asarray(jrs.cell_key(jnp.asarray(p), jnp.asarray(live),
                                   jnp.asarray(AABB)))
    got = resort.cell_key(torch.from_numpy(p), torch.from_numpy(live),
                          torch.from_numpy(AABB))
    assert got.dtype == torch.int32 and got.shape == (p[0].size,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() < 1 << resort.CELL_KEY_BITS
    assert resort.CELL_KEY_BITS == jrs.CELL_KEY_BITS
    assert resort.OCTANT_BITS == jrs.OCTANT_BITS


def test_group_dir_key_matches_jax():
    """Group keys agree on >= GROUP_KEY_AGREE of the groups, for the
    reason test_group_cell_key_matches_jax gives (a group mean summed in
    another order); all-dead groups take the tail bucket."""
    rng = np.random.default_rng(23)
    nb = 512
    centre = rng.uniform(AABB[0], AABB[1], (nb, 3)).astype(np.float32)
    o = (centre[:, None, :] + rng.normal(scale=0.3, size=(nb, 128, 3)))
    o = np.moveaxis(o.astype(np.float32), -1, 0).copy()
    axis = rng.normal(size=(nb, 1, 3))
    d = axis + rng.normal(scale=0.4, size=(nb, 128, 3))
    d = np.moveaxis((d / np.linalg.norm(d, axis=-1, keepdims=True))
                    .astype(np.float32), -1, 0).copy()
    live = rng.random((nb, 128)) < rng.uniform(0, 1, (nb, 1))
    live[:16] = False
    want = np.asarray(jrs.group_dir_key(jnp.asarray(d), jnp.asarray(o),
                                        jnp.asarray(live), jnp.asarray(AABB)))
    got = resort.group_dir_key(torch.from_numpy(d), torch.from_numpy(o),
                               torch.from_numpy(live), torch.from_numpy(AABB))
    assert got.dtype == torch.int32 and got.shape == (nb,)
    assert (got.numpy() == want).mean() >= GROUP_KEY_AGREE
    assert (got.numpy()[:16] == 1 << 15).all()
    assert got.numpy().max() < 1 << resort.GROUP_DIR_KEY_BITS
    assert resort.GROUP_DIR_KEY_BITS == jrs.GROUP_DIR_KEY_BITS


@pytest.mark.parametrize("bits", [5, 6, 7])
def test_dir_cell_key_fine_matches_jax(bits):
    from vkrt_tpu.wavefront import lanesort as jls
    from vkrt_tpu_torch.wavefront import lanesort
    p, d, live = wavefront(bits)
    want = np.asarray(jls.dir_cell_key_fine(
        jnp.asarray(d), jnp.asarray(p), jnp.asarray(live), jnp.asarray(AABB),
        bits=bits))
    got = lanesort.dir_cell_key_fine(torch.from_numpy(d), torch.from_numpy(p),
                                     torch.from_numpy(live),
                                     torch.from_numpy(AABB), bits=bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [3, 5, 6])
def test_cell_key_fine_bits_matches_jax(bits):
    from vkrt_tpu.wavefront import lanesort as jls
    from vkrt_tpu_torch.wavefront import lanesort
    p, _, live = wavefront(10 + bits)
    want = np.asarray(jls.cell_key_fine(jnp.asarray(p), jnp.asarray(live),
                                        jnp.asarray(AABB), bits=bits))
    got = lanesort.cell_key_fine(torch.from_numpy(p), torch.from_numpy(live),
                                 torch.from_numpy(AABB), bits=bits)
    np.testing.assert_array_equal(got.numpy(), want)
