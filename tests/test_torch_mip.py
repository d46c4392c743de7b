"""Mip-LOD sampling (config.mip_lod) in vkrt_tpu_torch vs the JAX package.

sample_material at level 0, a scalar level and per-ray levels;
sample_material_trilinear and ray_diff_lod element by element on the
same numpy inputs, within rtol = atol = 1e-6 (the same float32
operations in the same order: room for a rounding difference of an ulp
or two in log2 or sqrt between XLA:CPU, PyTorch's CPU kernels and the
card, where an ulp of a level in [8, 16) is 9.5e-7, not for another
formula; chip_smoke.py phase 22 holds the card to the CPU at the same
tolerance), with the contracts of tests/test_sampling.py:154 and :188
held on the port; and
one 64x48 config-4 frame with mip_lod on against the JAX engine's at the
frame bar, RMSE <= 1e-3 (BASELINE.json).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as JC
from vkrt_tpu.app.camera import Camera
from vkrt_tpu.app.framebuffer import rmse
from vkrt_tpu.scene import flatten_model
from vkrt_tpu.scene.textures import build_material_heap
from vkrt_tpu.shade import sampling as js
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade import sampling as ts
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

ATOL = 1e-6
RTOL = 1e-6
RMSE_BAR = 1e-3
NB = 4
W, H = 64, 48


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def model():
    return procedural_model("small", seed=0)


@pytest.fixture(scope="module")
def heap(model):
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
    uv = rng.uniform(-3.0, 4.0, (2, NB, 128)).astype(np.float32)
    return slots, uv


@pytest.mark.parametrize("lod", ["0", "2", "per_ray"])
def test_sample_material_lod(rng, heap, lod):
    slots, uv = sample_inputs(rng, heap)
    levels = heap.level_offset.shape[1]
    if lod == "per_ray":
        lv = rng.integers(0, levels, (NB, 128)).astype(np.int32)
        jl, tl = jnp.asarray(lv), torch.from_numpy(lv)
    else:
        jl = tl = int(lod)
    want = js.sample_material(*heap_args(heap, "jax"), jnp.asarray(slots),
                              jnp.asarray(uv), lod=jl)
    got = ts.sample_material(*heap_args(heap, "torch"),
                             torch.from_numpy(slots), torch.from_numpy(uv),
                             lod=tl)
    for g, w in zip(got, want):
        close(g, w)


def test_trilinear_matches_jax(rng, heap):
    slots, uv = sample_inputs(rng, heap)
    levels = heap.level_offset.shape[1]
    lod_f = rng.uniform(-0.5, levels + 0.5, (NB, 128)).astype(np.float32)
    lod_f[0, :8] = [0, 1, 2, 0.5, levels - 1, levels, -1, 3.999]
    want = js.sample_material_trilinear(*heap_args(heap, "jax"),
                                        jnp.asarray(slots), jnp.asarray(uv),
                                        jnp.asarray(lod_f))
    got = ts.sample_material_trilinear(*heap_args(heap, "torch"),
                                       torch.from_numpy(slots),
                                       torch.from_numpy(uv),
                                       torch.from_numpy(lod_f))
    for g, w in zip(got, want):
        close(g, w)


def test_trilinear_blends_mip_levels(rng, heap):
    """tests/test_sampling.py:154 on the port: lod 0 is the base
    sampler, lod 1 the level-1 sampler, lod 0.5 their mean."""
    args = heap_args(heap, "torch")
    slots, uv = (torch.from_numpy(x) for x in sample_inputs(rng, heap))
    base0 = ts.sample_material(*args, slots, uv, lod=0)
    base1 = ts.sample_material(*args, slots, uv, lod=1)
    tri0 = ts.sample_material_trilinear(*args, slots, uv,
                                        torch.zeros_like(uv[0]))
    tri1 = ts.sample_material_trilinear(*args, slots, uv,
                                        torch.ones_like(uv[0]))
    half = ts.sample_material_trilinear(*args, slots, uv,
                                        torch.full_like(uv[0], 0.5))
    for a, b in zip(base0, tri0):
        close(b, a)
    for a, b in zip(base1, tri1):
        close(b, a)
    for lo, hi, m in zip(base0, base1, half):
        close(m, 0.5 * (lo + hi))


def test_ray_diff_lod_matches_jax(rng):
    lw = rng.integers(4, 512, (5, 6)).astype(np.int32)
    lh = rng.integers(4, 512, (5, 6)).astype(np.int32)
    uv = np.cumsum(rng.uniform(0, 0.02, (2, NB, 128)), axis=-1)
    uv = uv.astype(np.float32)
    hit = rng.random((NB, 128)) < 0.9
    mat = rng.integers(0, 5, (NB, 128)).astype(np.int32)
    mat[:2] = 1                                    # long same-surface runs
    want = js.ray_diff_lod(jnp.asarray(uv), jnp.asarray(hit),
                           jnp.asarray(mat), jnp.asarray(lw),
                           jnp.asarray(lh), jnp.asarray(mat))
    got = ts.ray_diff_lod(torch.from_numpy(uv), torch.from_numpy(hit),
                          torch.from_numpy(mat), torch.from_numpy(lw),
                          torch.from_numpy(lh), torch.from_numpy(mat))
    assert got.dtype == torch.float32 and got.shape == (NB, 128)
    close(got, want)
    assert np.asarray(want)[:2].max() > 1.0        # levels above 0 occur


def test_ray_diff_lod_scales_with_footprint():
    """tests/test_sampling.py:188 on the port: 1 texel a pixel gives lod
    0, 4 texels a pixel lod 2, and alternating materials clamp to 0."""
    lw = torch.full((1, 6), 16, dtype=torch.int32)
    lh = torch.full((1, 6), 8, dtype=torch.int32)
    sid = torch.zeros((2, 128), dtype=torch.int32)
    hit = torch.ones((2, 128), dtype=torch.bool)
    lane = np.arange(128, dtype=np.float32)
    u = (np.stack([lane / 16.0, lane * 4.0 / 16.0]) % 1.0).astype(np.float32)
    uv = torch.stack([torch.from_numpy(u), torch.zeros((2, 128))])
    lod = ts.ray_diff_lod(uv, hit, sid, lw, lh, sid).numpy()
    interior = np.ones(128, bool)
    interior[::16] = False
    interior &= np.abs(np.diff(u[0], prepend=u[0][0])) < 0.5
    interior &= np.abs(np.diff(u[1], prepend=u[1][0])) < 0.5
    assert np.allclose(lod[0][interior], 0.0, atol=0.1)
    assert np.allclose(lod[1][interior], 2.0, atol=0.1)
    sid2 = torch.from_numpy((np.arange(128) % 2).astype(np.int32))
    sid2 = sid2[None].repeat(2, 1)
    lod2 = ts.ray_diff_lod(uv, hit, sid2, lw, lh, sid2 * 0).numpy()
    assert np.allclose(lod2, 0.0)


def test_mip_lod_frame_matches_jax(model):
    """A 64x48 config-4 frame with mip_lod on: the port's dense engine
    against the JAX engine (its reference backend: the same depth-0
    trilinear sampling, no kernels to interpret)."""
    jcfg = dataclasses.replace(JC.config4_flythrough(), width=W, height=H,
                               mip_lod=True)
    tcfg = dataclasses.replace(TC.config4_flythrough(), width=W, height=H,
                               mip_lod=True)
    cam = Camera(W, H)
    cam.set_position(JC.CAMERA_START_POSITION)
    cam.set_rotation(JC.CAMERA_START_ROTATION)
    flat = flatten_model(model)
    want, want_rays = je.render_frame(
        je.make_backend(flat, "reference"),
        je.texture_arrays(model.images, flat), jnp.asarray(cam.proj_inverse),
        jnp.asarray(cam.view_inverse), jnp.asarray(JC.LIGHT_POSITIONS), jcfg)
    r = te.Renderer(model, tcfg, "cpu")
    fb, rays = r.render(cam)
    off, _ = te.Renderer(model, dataclasses.replace(tcfg, mip_lod=False),
                         "cpu").render(cam)
    assert fb.shape == (H, W, 3) and np.isfinite(fb).all()
    assert rmse(fb, np.asarray(want)) <= RMSE_BAR
    assert rays == int(np.asarray(want_rays).sum())
    assert rmse(fb, off) > 10 * RMSE_BAR          # the flag changed the frame
