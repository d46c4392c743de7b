"""vkrt_tpu_torch/wavefront/pack.py vs vkrt_tpu/wavefront/pack.py (CPU).

The port's consolidate_plan, consolidate (kernel C's plain version) and
scatter_back (kernel D's) against the JAX functions with their Pallas
kernels in interpret mode, on the same live masks and channels made
with numpy from a seed. Both sides move f32 values without arithmetic
(the JAX one-hot matmuls run at HIGHEST precision, exact for 0/1), so
every comparison is bit for bit. The port's kernels need no block; the
JAX side runs at the block each case names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu.wavefront import pack as jpack
from vkrt_tpu_torch.wavefront import pack
import torch_support  # noqa: F401


def roundtrip(live, block, n_ch=4, seed=0):
    rng = np.random.default_rng(seed)
    nb = live.shape[0]
    ch = rng.normal(size=(n_ch, nb, 128)).astype(np.float32)
    plan = jpack.consolidate_plan(jnp.asarray(live), block)
    grank = pack.consolidate_plan(torch.from_numpy(live))
    assert grank.dtype == torch.int32
    np.testing.assert_array_equal(grank.numpy(),
                                  np.asarray(plan["grank"]).astype(np.int32))

    want = jpack.consolidate([jnp.asarray(c) for c in ch], plan["grank"],
                             plan["src_lo"], plan["src_hi"], block=block,
                             interpret=True)
    got = pack.consolidate(torch.from_numpy(ch), grank)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    nlive = int(live.sum())
    assert (got.reshape(n_ch, -1)[:, nlive:] == 0).all()

    res = rng.normal(size=(3, nb * 128)).astype(np.float32)
    res[:, nlive:] = 777.0           # beyond-live garbage must not leak
    res = res.reshape(3, nb, 128)
    want = jpack.scatter_back(jnp.asarray(res), plan["grank"], block=block,
                              interpret=True)
    back = pack.scatter_back(torch.from_numpy(res), grank)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    assert not (back.numpy() == 777.0).any()


@pytest.mark.parametrize("frac", [0.1, 0.27, 0.9])
def test_roundtrip_random_matches_jax(frac):
    rng = np.random.default_rng(42)
    roundtrip(rng.random((64, 128)) < frac, 512)


def test_roundtrip_block_1024_matches_jax():
    rng = np.random.default_rng(7)
    roundtrip(rng.random((64, 128)) < 0.2, 1024)


@pytest.mark.parametrize("live", [False, True], ids=["all_dead", "all_live"])
def test_all_dead_and_all_live_match_jax(live):
    roundtrip(np.full((32, 128), live), 512)


def test_single_block_matches_jax():
    rng = np.random.default_rng(3)
    roundtrip(rng.random((4, 128)) < 0.5, 512)


def test_clustered_liveness_matches_jax():
    """Liveness in a few source blocks, with long dead gaps between."""
    live = np.zeros((64, 128), bool)
    live[5:9] = True
    live[50:54] = True
    roundtrip(live, 512)


def test_wrappers_reject_bad_inputs():
    """The shape and dtype checks a CUDA tensor meets before its launch
    (run here on the meta device: neither CPU nor CUDA)."""
    x = torch.zeros(4, 8, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pack.consolidate(x, torch.zeros(8, 128, dtype=torch.int32,
                                        device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pack.scatter_back(x, torch.zeros(8, 128, dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(ValueError, match="i32"):
        pack._check("consolidate", torch.zeros(4, 8, 128),
                    torch.zeros(8, 128, dtype=torch.int64),
                    torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        pack._check("consolidate", torch.zeros(4, 16, 128)[:, ::2],
                    torch.zeros(8, 128, dtype=torch.int32),
                    torch.device("cpu"))
