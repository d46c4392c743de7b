"""vkrt_tpu_torch shading, sampling and layout vs the JAX package.

Element by element on the same numpy inputs. The port performs the same
float32 operations in the same order, so the tolerance is atol 1e-6 —
room for a rounding difference between XLA:CPU and PyTorch's CPU
kernels (e.g. in sqrt or a fused multiply-add), not for a different
formula.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as C
from vkrt_tpu.scene.textures import build_material_heap
from vkrt_tpu.shade import sampling as js
from vkrt_tpu.shade import shading as jsh
from vkrt_tpu.utils import layout as jl
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade import sampling as ts
from vkrt_tpu_torch.shade import shading as tsh
from vkrt_tpu_torch.utils import layout as tl
import torch_support  # noqa: F401

ATOL = 1e-6
NB = 4


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def test_interpolate(rng):
    attrs = rng.normal(size=(36, NB, 128)).astype(np.float32)
    attrs[33:36] = rng.integers(0, 5, (3, NB, 128))
    u = rng.uniform(0, 0.5, (NB, 128)).astype(np.float32)
    v = rng.uniform(0, 0.5, (NB, 128)).astype(np.float32)
    want = jsh.interpolate(*(jnp.asarray(x) for x in (attrs, u, v)))
    got = tsh.interpolate(*(torch.from_numpy(x) for x in (attrs, u, v)))
    for g, w in zip(got, want):
        close(g, w)
    assert got[4].dtype == torch.int32


def test_perturbed_normal_and_reflect(rng):
    n, t, m, d = (rng.normal(size=(3, NB, 128)).astype(np.float32)
                  for _ in range(4))
    m = np.abs(m) % 1.0
    t[:, 0, :4] = 0.0                       # zero tangents safe-normalize
    jn = jsh.perturbed_normal(*(jnp.asarray(x) for x in (n, t, m)))
    tn = tsh.perturbed_normal(*(torch.from_numpy(x) for x in (n, t, m)))
    close(tn, jn)
    close(tsh.reflect(torch.from_numpy(d), tn),
          jsh.reflect(jnp.asarray(d), jn))


def test_light_geometry(rng):
    pos = rng.uniform(-10, 10, (3, NB, 128)).astype(np.float32)
    pos[:, 0, 0] = C.LIGHT_POSITIONS[1]     # a point on the light
    for li in range(4):
        lp = C.LIGHT_POSITIONS[li]
        want = jsh.light_geometry(jnp.asarray(pos), jnp.asarray(lp))
        got = tsh.light_geometry(torch.from_numpy(pos), torch.from_numpy(lp))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6, atol=ATOL)


def test_layout_helpers(rng):
    x = rng.normal(size=(NB * 128, 3)).astype(np.float32)
    a, b = (rng.normal(size=(3, NB, 128)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((NB, 128)) < 0.5
    m = rng.normal(size=(3, 3)).astype(np.float32)
    jx, tx = both(x)
    close(tl.to_cvec(tx), jl.to_cvec(jx))
    close(tl.from_cvec(tl.to_cvec(tx)), x)
    close(tl.from_lanes(tl.to_lanes(tx[:, 0])), x[:, 0])
    ja, ta = both(a)
    jb, tb = both(b)
    close(tl.dot3(ta, tb), jl.dot3(ja, jb))
    close(tl.cross3(ta, tb), jl.cross3(ja, jb))
    close(tl.normalize3(ta), jl.normalize3(ja))
    close(tl.scale3(ta, tb[0]), jl.scale3(ja, jb[0]))
    close(tl.where3(torch.from_numpy(mask), ta, tb),
          jl.where3(jnp.asarray(mask), ja, jb))
    close(tl.mat_rows3(tx, torch.from_numpy(m)),
          jl.mat_rows3(jx, jnp.asarray(m)), atol=1e-5)


@pytest.fixture(scope="module")
def heap():
    model = procedural_model("small", seed=0)
    triples = np.array([[3 * k, 3 * k + 1, 3 * k + 2]
                        for k in range(len(model.materials))], np.int32)
    return build_material_heap(model.images, triples)


def heap_args(heap, lib):
    arrs = (heap.texels_tri, heap.level_offset, heap.level_width,
            heap.level_height)
    if lib == "jax":
        return [jnp.asarray(a) for a in arrs]
    return [torch.from_numpy(np.array(a)) for a in arrs]


def sample_inputs(rng, heap):
    m = heap.level_offset.shape[0]
    slots = rng.integers(0, m, (NB, 128)).astype(np.int32)
    uv = rng.uniform(-3.0, 4.0, (2, NB, 128)).astype(np.float32)  # wraps
    return slots, uv


def test_sample_material(rng, heap):
    slots, uv = sample_inputs(rng, heap)
    want = js.sample_material(*heap_args(heap, "jax"), jnp.asarray(slots),
                              jnp.asarray(uv))
    got = ts.sample_material(*heap_args(heap, "torch"),
                             torch.from_numpy(slots), torch.from_numpy(uv))
    for g, w in zip(got, want):
        close(g, w)


def test_sample_material_negative_texel_wraps(heap):
    """uv just below 0 floors to texel -1, which wraps to the last texel
    (floor modulo, as jnp.mod)."""
    slots = np.zeros((1, 128), np.int32)
    uv = np.full((2, 1, 128), -1e-3, np.float32)
    want = js.sample_material(*heap_args(heap, "jax"), jnp.asarray(slots),
                              jnp.asarray(uv))
    got = ts.sample_material(*heap_args(heap, "torch"),
                             torch.from_numpy(slots), torch.from_numpy(uv))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("live_frac", [0.0, 0.1, 1.0])
def test_sample_material_compact(rng, heap, live_frac):
    slots, uv = sample_inputs(rng, heap)
    live = rng.random((NB, 128)) < live_frac
    live[2] = False                          # one all-dead row
    want = js.sample_material_compact(
        *heap_args(heap, "jax"), jnp.asarray(slots), jnp.asarray(uv),
        jnp.asarray(live), cap_rows=2)
    got = ts.sample_material_compact(
        *heap_args(heap, "torch"), torch.from_numpy(slots),
        torch.from_numpy(uv), torch.from_numpy(live))
    # rows with a live lane match exactly (dead lanes there sample slot 0
    # at uv 0 in both); an all-dead row is 0 here, while the JAX version
    # leaves 0 or that slot-0 sample there depending on its row chunking
    rows = live.any(axis=1)
    for g, w in zip(got, want):
        close(np.asarray(g)[:, rows], np.asarray(w)[:, rows])
        assert not np.asarray(g)[:, ~rows].any()
