"""The depth>=1 shadow repartition as a whole: the port's engine steps vs
the JAX engine's calls in their order (vkrt_tpu/wavefront/engine.py
:588-653 forward, :684-697 back), CPU.

The same depth-1 surface points and cast bitmask go through both. The
moved points and bitmask (the kernel-B inputs) must be equal, and the
blocked masks, traced once on the moved segments and returned through
each side's inverse, must be bit-equal to each other and to the masks of
the unmoved segments. Both the uncapped case (3 blocks of 1024) and the
capped one (12 blocks: only the first quarter of the packed rows is lane
sorted) run, with and without the pack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as C
from vkrt_tpu.scene import flatten_model
from vkrt_tpu.wavefront import lanesort as jls
from vkrt_tpu.wavefront import pack as jpack
from vkrt_tpu.wavefront import resort as jrs
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade import shading
from vkrt_tpu_torch.wavefront import engine as te

OBLK = 1024


@pytest.fixture(scope="module")
def backend():
    return te.make_backend(flatten_model(procedural_model("small", seed=0)),
                           "dense", "cpu")


def jax_partition(pos, castmask, aabb, pt_cons, oblk):
    """engine.py:594-639, the JAX calls in their order (Pallas interpret)."""
    if pt_cons:
        plan_p = jpack.consolidate_plan(castmask > 0, oblk)
        pk = jpack.consolidate([pos[0], pos[1], pos[2], castmask],
                               plan_p["grank"], plan_p["src_lo"],
                               plan_p["src_hi"], block=oblk, interpret=True)
        pos_k, cm_k = jnp.stack(pk[:3]), pk[3]
    else:
        plan_p, pos_k, cm_k = None, pos, castmask
    nb2 = cm_k.shape[0]
    rpb = oblk // 128
    capr = nb2
    if pt_cons and nb2 // rpb >= 8:
        capr = -(-(nb2 // rpb) // 4) * rpb
    lkey = jls.cell_key_fine(pos_k[:, :capr], cm_k[:capr] > 0, aabb, bits=6)
    (p0, p1, p2, cmv), rank_s = jls.lane_sort(
        [pos_k[0][:capr], pos_k[1][:capr], pos_k[2][:capr], cm_k[:capr]],
        lkey, block=oblk, interpret=True)
    if capr < nb2:
        p0, p1, p2 = (jnp.concatenate([a, pos_k[i][capr:]])
                      for i, a in enumerate((p0, p1, p2)))
        cmv = jnp.concatenate([cmv, cm_k[capr:]])
    pos_p = jnp.stack([p0, p1, p2])
    gperm_s = jrs.radix_partition_perm(
        jrs.group_cell_key(pos_p, cmv > 0, aabb), jrs.GROUP_CELL_KEY_BITS)
    ginv_ps = jrs.inverse_permutation(gperm_s)
    pos_p = jrs.permute_groups(pos_p, gperm_s)
    cmi = jrs.permute_groups(cmv, gperm_s).astype(jnp.int32)
    return pos_p, cmi, (plan_p, rank_s, ginv_ps, capr)


def jax_unpartition(occ_all, undo, oblk):
    """engine.py:684-697."""
    plan_p, rank_s, ginv_ps, capr = undo
    nb2 = occ_all.shape[1]
    occ_f = jrs.permute_groups(occ_all.astype(jnp.float32), ginv_ps)
    occ_inv = jls.lane_unsort(occ_f[:, :capr], rank_s, block=oblk,
                              interpret=True)
    occ_f = (occ_inv if capr == nb2 else
             jnp.concatenate([occ_inv, occ_f[:, capr:]], axis=1))
    if plan_p is not None:
        occ_f = jpack.scatter_back(occ_f, plan_p["grank"], block=oblk,
                                   interpret=True)
    return occ_f > 0.5


def segments(pos, cmi, lights):
    """Kernel B's inputs from surface points and the cast bitmask, as the
    port's engine builds them."""
    sd, st = [], []
    for li in range(lights.shape[0]):
        ldir, ldist, _ = shading.light_geometry(pos, lights[li])
        sd.append(-ldir)
        st.append(torch.where(((cmi >> li) & 1) > 0, ldist - C.RAY_TMIN,
                              0.0))
    return torch.stack(sd), torch.stack(st)


@pytest.mark.parametrize("nb", [24, 96], ids=["3_blocks", "12_blocks"])
@pytest.mark.parametrize("pack_first", [False, True],
                         ids=["no_pack", "pack"])
def test_partition_matches_jax_and_masks_are_exact(backend, nb, pack_first):
    rng = np.random.default_rng(nb + pack_first)
    aabb = backend.scene_aabb.numpy()
    # a depth-1 shadow wavefront: ~30% of rays cast toward some lights,
    # in runs, as reflections of a few metallic surfaces are
    pos = rng.uniform(aabb[0], aabb[1], (nb, 128, 3)).astype(np.float32)
    pos = np.moveaxis(pos, -1, 0).copy()
    bits = rng.integers(1, 16, (nb, 128))
    live = np.repeat(rng.random((nb, 8)) < 0.3, 16, axis=1)
    castmask = np.where(live, bits, 0).astype(np.float32)
    lights = torch.as_tensor(np.asarray(C.LIGHT_POSITIONS, np.float32))

    pos_p, cmi, undo = te.partition_points(
        torch.from_numpy(pos), torch.from_numpy(castmask), backend.scene_aabb,
        pack_first, OBLK)
    jpos_p, jcmi, jundo = jax_partition(
        jnp.asarray(pos), jnp.asarray(castmask), jnp.asarray(aabb),
        pack_first, OBLK)
    np.testing.assert_array_equal(pos_p.numpy(), np.asarray(jpos_p))
    np.testing.assert_array_equal(cmi.numpy(), np.asarray(jcmi))
    assert undo.rank.shape[0] == (24 if nb == 96 and pack_first else nb)
    assert not np.array_equal(pos_p.numpy(), pos)          # rays moved

    occ = backend.occluded_multi(lights, *segments(pos_p, cmi, lights))
    got = te.unpartition(occ, undo)
    want = jax_unpartition(jnp.asarray(occ.numpy()), jundo, OBLK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = backend.occluded_multi(
        lights, *segments(torch.from_numpy(pos),
                          torch.from_numpy(castmask).to(torch.int32), lights))
    assert direct.any()
    np.testing.assert_array_equal(got.numpy(), direct.numpy())
