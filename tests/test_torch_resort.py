"""vkrt_tpu_torch/wavefront/resort.py vs vkrt_tpu/wavefront/resort.py (CPU).

The group half of the depth>=1 re-tiling: the stable permutation, its
inverse, the group permutation and the group cell key, on the same
inputs made with numpy from a seed.
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
