"""vkrt_tpu_torch/wavefront/lanesort.py vs vkrt_tpu/wavefront/lanesort.py
(CPU).

lane_sort (kernel E's plain version) and lane_unsort (kernel F's) against
the JAX functions with their Pallas kernels in interpret mode, at blocks
128 to 1024 with many tied keys and with the adversarial key sets that
chip_smoke.py holds kernel E to on the card (all equal, strictly
descending, 2**24 - 1, all zero, dead tails of 2**18, both signs): this
pins the stable tie rule that the kernel's radix sort reproduces;
cell_key_fine against the JAX keys.
Both sides move f32 values without arithmetic and rank by the same stable
rule, so channels, ranks and keys are compared bit for bit (the JAX rank
is f32, exact below 2**24).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import adversarial_keys
from vkrt_tpu.wavefront import lanesort as jls
from vkrt_tpu_torch.wavefront import lanesort

ADVERSARIAL = ["equal", "descending", "max_key", "zero", "dead_tail",
               "signed"]


@pytest.mark.parametrize("block", [128, 256, 512, 1024])
@pytest.mark.parametrize("nkeys", [40, 600, 1 << 18 | 1] + ADVERSARIAL)
def test_lane_sort_and_unsort_match_jax(block, nkeys):
    """Random keys below `nkeys`, or one of chip_smoke's adversarial
    key sets by name."""
    nb = 16
    if isinstance(nkeys, str):
        rng = np.random.default_rng(block + ADVERSARIAL.index(nkeys))
        key = adversarial_keys(rng, nb, block)[nkeys]
    else:
        rng = np.random.default_rng(block + nkeys)
        key = rng.integers(0, nkeys, (nb, 128)).astype(np.int32)
    ch = rng.normal(size=(4, nb, 128)).astype(np.float32)
    want, want_rank = jls.lane_sort([jnp.asarray(c) for c in ch],
                                    jnp.asarray(key), block=block,
                                    interpret=True)
    got, rank = lanesort.lane_sort(torch.from_numpy(ch),
                                   torch.from_numpy(key), block=block)
    assert rank.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    np.testing.assert_array_equal(rank.numpy(),
                                  np.asarray(want_rank).astype(np.int32))

    res = rng.normal(size=(4, nb, 128)).astype(np.float32)
    want = jls.lane_unsort(jnp.asarray(res), want_rank, block=block,
                           interpret=True)
    back = lanesort.lane_unsort(torch.from_numpy(res), rank, block=block)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    # unsort inverts sort
    again = lanesort.lane_unsort(got, rank, block=block)
    np.testing.assert_array_equal(again.numpy(), ch)


@pytest.mark.parametrize("block", [512, 1024])
@pytest.mark.parametrize("channels", [1, 4, 5])
def test_lane_unsort_matches_jax(block, channels):
    """lane_unsort (kernel F's plain version) against the JAX function
    (interpret) for 1, 4 and 5 channels: ranks that are a random
    permutation inside every block, values bit-equal."""
    rng = np.random.default_rng(10 * block + channels)
    nb = 16
    rank = np.stack([rng.permutation(block) for _ in range(nb * 128 // block)])
    rank = rank.reshape(nb, 128).astype(np.int32)
    res = rng.normal(size=(channels, nb, 128)).astype(np.float32)
    want = jls.lane_unsort(jnp.asarray(res), jnp.asarray(rank, jnp.float32),
                           block=block, interpret=True)
    got = lanesort.lane_unsort(torch.from_numpy(res), torch.from_numpy(rank),
                               block=block)
    assert got.shape == res.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # out[s, j] = res[s, base + rank[j]], block by block
    r3 = res.reshape(channels, -1, block)
    idx = np.broadcast_to(rank.reshape(1, -1, block), r3.shape)
    np.testing.assert_array_equal(
        got.numpy(), np.take_along_axis(r3, idx, 2).reshape(res.shape))


def test_cell_key_fine_matches_jax():
    rng = np.random.default_rng(5)
    nb = 24
    aabb = np.array([[-17.5, -1.25, -10.0], [17.5, 13.0, 11.0]], np.float32)
    p = rng.uniform(aabb[0] - 1, aabb[1] + 1,
                    (nb, 128, 3)).astype(np.float32)
    p = np.moveaxis(p, -1, 0).copy()
    p[:, 0, 0], p[:, 0, 1] = aabb[0], aabb[1]      # on the box's corners
    live = rng.random((nb, 128)) < 0.7
    want = np.asarray(jls.cell_key_fine(jnp.asarray(p), jnp.asarray(live),
                                        jnp.asarray(aabb), bits=6))
    got = lanesort.cell_key_fine(torch.from_numpy(p),
                                 torch.from_numpy(live),
                                 torch.from_numpy(aabb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~live] == 1 << 18).all()
    assert got.numpy()[live].max() < 1 << 18


def test_wrappers_reject_bad_blocks():
    x = torch.zeros(4, 8, 128)
    idx = torch.zeros(8, 128, dtype=torch.int32)
    cpu = torch.device("cpu")
    for block in (0, 100, 2048, 768):           # 768 does not divide 1024
        with pytest.raises(ValueError, match="block"):
            lanesort._check("lane_sort", x, idx, block, cpu)
    lanesort._check("lane_sort", x, idx, 512, cpu)
    with pytest.raises(ValueError, match="unsupported device"):
        lanesort.lane_unsort(x.to("meta"), idx.to("meta"), block=512)
