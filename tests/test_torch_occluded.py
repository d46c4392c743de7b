"""Kernel A' (any-hit trace) and the point-origin modes, plain versions
vs the JAX Pallas kernel.

On the CPU `trace_dense(occlusion=True)` / `trace_occluded` run the plain
PyTorch version and `point_origin=True` broadcasts the block origins into
it; the JAX side runs `vkrt_tpu.rt.dense.trace_dense(..., interpret=True)`
on the same tree (carried across with `tree_from_numpy`) and the same
rays. Tolerances: slots and masks equal; t, u, v of the occlusion mode
equal (they are constants); closest-mode t and attrs to rtol 1e-6 and
u, v to 1e-5 absolute on agreeing slots; agreement with the brute-force
oracle > 0.995 (tests/test_dense.py's bar). The per-light shadow dispatch
(`DenseBackend.per_light`) must render config 4 bit for bit as the
kernel-B dispatch at every reorder-flag combination.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as C
from vkrt_tpu.accel.clusters import build_clusters as jax_build_clusters
from vkrt_tpu.accel.clusters import scene_attrs as jax_scene_attrs
from vkrt_tpu.golden.cpu_tracer import occluded as brute_occluded
from vkrt_tpu.rt.dense import trace_dense as jax_trace_dense
from vkrt_tpu.scene import flatten_model
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.accel.clusters import tree_from_numpy
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.rt.dense import (TMIN, broadcast_points, trace_dense,
                                     trace_occluded)
from vkrt_tpu_torch.rt.occl_multi import occluded_multi
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

N_RAYS = 2048
REORDER_FLAGS = ("consolidate_secondary", "group_sort_shadows",
                 "partition_shadows")


@pytest.fixture(scope="module")
def scene():
    model = procedural_model("small", seed=0)
    flat = flatten_model(model)
    idx = np.asarray(flat.indices, dtype=np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0
    jtree = jax_build_clusters(jnp.asarray(v0), jnp.asarray(e1),
                               jnp.asarray(e2), attrs=jax_scene_attrs(flat),
                               with_attributes=True, device=False)
    ttree = tree_from_numpy(*(np.asarray(a) for a in jtree), device="cpu")
    return model, (v0, e1, e2), jtree, ttree


def scattered_rays(seed, n=N_RAYS):
    """Rays from inside the hall with segment ends of 0.5-20 units, ~20%
    parked (tmax = 0) and 8 live ones with an empty interval
    0 < tmax <= TMIN. Lane-major numpy plus the row-major originals."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-15, 0, -9], [15, 12, 10], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.5, 20.0, n).astype(np.float32)
    tmax[rng.random(n) < 0.2] = 0.0
    tmax[:8] = 0.0009
    cv = lambda x: np.moveaxis(x.reshape(-1, 128, 3), -1, 0).copy()
    return (o, d, tmax), (cv(o), cv(d), tmax.reshape(-1, 128).copy())


def point_rays(seed, block, n=N_RAYS):
    """One origin per block of `block` rays, random directions, ~15%
    parked. Returns (pts [n/block,3], dirs [3,Nb,128], tmax [Nb,128])."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-14, 1, -8], [14, 11, 9],
                      (n // block, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 30.0, np.float32)
    tmax[::7] = 0.0
    return (pts, np.moveaxis(d.reshape(-1, 128, 3), -1, 0).copy(),
            tmax.reshape(-1, 128).copy())


def to_torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("block", [128, 512])
def test_occlusion_matches_jax_kernel(scene, block):
    _, _, jtree, ttree = scene
    _, (o, d, tmax) = scattered_rays(seed=21)
    want = [np.asarray(x) for x in jax_trace_dense(
        jtree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        block=block, occlusion=True, interpret=True)]
    got = [x.numpy() for x in trace_dense(
        ttree, *to_torch(o, d, tmax), block=block, occlusion=True,
        with_attributes=False)]
    assert len(got) == len(want) == 4
    # all four outputs, not only the mask: slot 1 / t TMIN on a blocked
    # ray, slot -1 / t inf on a free one, u = v = 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    blocked = got[1] >= 0
    assert 0.05 < blocked.mean() < 0.95
    assert (got[0][blocked] == np.float32(TMIN)).all()
    assert not blocked[tmax == 0].any()                  # parked
    assert not blocked.reshape(-1)[:8].any()             # empty interval
    # with_attributes in occlusion mode: zeros, as the JAX kernel leaves them
    attrs = trace_dense(ttree, *to_torch(o, d, tmax), occlusion=True)[4]
    assert attrs.shape == (36,) + tmax.shape and not attrs.any()


def test_occlusion_matches_brute_oracle(scene):
    _, (v0, e1, e2), _, ttree = scene
    (o, d, tmax), lane = scattered_rays(seed=22)
    slot = trace_occluded(ttree, *to_torch(*lane))[1].numpy().reshape(-1)
    want = brute_occluded(o, d, C.RAY_TMIN, tmax, v0, e1, e2)
    live = tmax > 0
    assert ((slot >= 0) == want)[live].mean() > 0.995
    assert not (slot >= 0)[~live].any()


@pytest.mark.parametrize("block", [128, 512])
def test_point_origin_closest_matches_jax_kernel(scene, block):
    _, _, jtree, ttree = scene
    pts, d, tmax = point_rays(seed=23, block=block)
    jt, js, ju, jv, ja = (np.asarray(x) for x in jax_trace_dense(
        jtree, jnp.asarray(pts), jnp.asarray(d), jnp.asarray(tmax),
        block=block, with_attributes=True, point_origin=True,
        interpret=True))
    tt, ts, tu, tv, ta = (x.numpy() for x in trace_dense(
        ttree, *to_torch(pts, d, tmax), block=block, point_origin=True))
    np.testing.assert_array_equal(ts >= 0, js >= 0)
    same = (ts == js) & (ts >= 0)
    assert same.sum() >= 0.99 * (ts >= 0).sum() > 0.4 * ts.size
    np.testing.assert_allclose(tt[same], jt[same], rtol=1e-6)
    # u, v are quotients of cancelling sums (XLA's CPU code contracts
    # their product-sums, torch rounds each product): 1e-5 absolute, the
    # bar test_torch_trace.py holds kernel A's plain version to
    np.testing.assert_allclose(tu[same], ju[same], atol=1e-5)
    np.testing.assert_allclose(tv[same], jv[same], atol=1e-5)
    np.testing.assert_allclose(ta[:, same], ja[:, same], rtol=1e-6)
    assert (ts[tmax == 0] == -1).all()


@pytest.mark.parametrize("block", [128, 512])
def test_point_origin_occlusion_matches_jax_kernel(scene, block):
    _, _, jtree, ttree = scene
    pts, d, tmax = point_rays(seed=24, block=block)
    want = [np.asarray(x) for x in jax_trace_dense(
        jtree, jnp.asarray(pts), jnp.asarray(d), jnp.asarray(tmax),
        block=block, occlusion=True, point_origin=True, interpret=True)]
    got = [x.numpy() for x in trace_occluded(
        ttree, *to_torch(pts, d, tmax), block=block, point_origin=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0.05 < (got[1] >= 0).mean() < 0.95


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
def test_point_origin_equals_broadcast(scene, occlusion):
    """One origin per block == the same origins broadcast per ray, every
    output, parked rays included (tests/test_dense.py:165)."""
    _, _, _, ttree = scene
    pts, d, tmax = to_torch(*point_rays(seed=25, block=512))
    got = trace_dense(ttree, pts, d, tmax, block=512, occlusion=occlusion,
                      point_origin=True)
    ref = trace_dense(ttree, broadcast_points(pts, d, 512), d, tmax,
                      occlusion=occlusion)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (got[1][tmax == 0] == -1).all()


def test_point_origin_checks_block(scene):
    _, _, _, ttree = scene
    pts, d, tmax = to_torch(*point_rays(seed=26, block=512))
    with pytest.raises(ValueError, match="multiple of block"):
        trace_dense(ttree, pts, d[:, :3], tmax[:3], block=512,
                    point_origin=True)                   # 384 rays
    with pytest.raises(ValueError, match="shapes"):
        trace_dense(ttree, pts[:2], d, tmax, block=512, point_origin=True)
    with pytest.raises(ValueError, match="unsupported device"):
        meta = torch.empty(3, 4, 128, device="meta")
        trace_occluded(ttree, meta, meta, meta[0])


def light_segments(seed, ns=4, n=N_RAYS):
    """Segments from the config lights toward points in and around the
    hall, ~30% parked and 8 per light with an empty interval."""
    rng = np.random.default_rng(seed)
    lights = C.LIGHT_POSITIONS[:ns]
    pts = rng.uniform([-24, -4, -15], [23, 18, 16], (n, 3)).astype(np.float32)
    dirs = np.zeros((ns, 3, n // 128, 128), np.float32)
    tm = np.zeros((ns, n // 128, 128), np.float32)
    for s in range(ns):
        dv = pts - lights[s]
        dist = np.linalg.norm(dv, axis=1)
        dirs[s] = np.moveaxis((dv / dist[:, None]).reshape(-1, 128, 3), -1, 0)
        tmv = (dist - C.RAY_TMIN).astype(np.float32)
        tmv[rng.random(n) < 0.3] = 0.0
        tmv[:8] = 0.0009
        tm[s] = tmv.reshape(-1, 128)
    return lights, dirs, tm


@pytest.mark.parametrize("block", [512, 1024])
def test_occluded_multi_equals_per_light_occluded_point(scene, block):
    """Kernel B's plain version == one point-origin A' dispatch per light
    (tests/test_dense.py:200), near-light rows included (:271), and so is
    the backend's `per_light` path."""
    _, _, _, ttree = scene
    lights, dirs, tm = to_torch(*light_segments(seed=27))
    want = occluded_multi(ttree, lights, dirs, tm)
    be = te.DenseBackend(tree=ttree, scene_aabb=torch.zeros(2, 3))
    nob = N_RAYS // block
    for s in range(lights.shape[0]):
        got = be.occluded_point(lights[s][None].expand(nob, 3).contiguous(),
                                dirs[s], tm[s], block=block)
        assert got.dtype == torch.bool and torch.equal(got, want[s])
    assert not want[:, 0, :8].any() and not want[tm == 0].any()
    assert 0.05 < want.float().mean() < 0.95
    per_light = be._replace(per_light=True)
    assert torch.equal(per_light.occluded_multi(lights, dirs, tm, block=block),
                       want)
    assert torch.equal(be.occluded_multi(lights, dirs, tm, block=block), want)
    # per-ray origins: the same segments through `occluded`
    o = lights[1][:, None, None].expand(3, N_RAYS // 128, 128).contiguous()
    assert torch.equal(be.occluded(o, dirs[1], tm[1]), want[1])


def config4(on) -> TC.RenderConfig:
    return dataclasses.replace(TC.config4_flythrough(), width=64, height=48,
                               **dict(zip(REORDER_FLAGS, on)))


@pytest.fixture(scope="module")
def cam():
    cam = Camera(64, 48)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    return cam


@pytest.mark.parametrize("on", list(itertools.product([False, True],
                                                      repeat=3)),
                         ids=lambda on: "".join("01"[b] for b in on))
def test_per_light_frames_bit_equal(scene, cam, on):
    """64x48 config 4: the per-light A' shadow dispatch renders the
    kernel-B frame bit for bit, with equal ray counts, at every
    combination of the three reorder flags."""
    model = scene[0]
    r = te.Renderer(model, config4(on), "cpu")
    want, want_rays = r.render(cam)
    r.backend = r.backend._replace(per_light=True)
    fb, rays = r.render(cam)
    np.testing.assert_array_equal(fb, want)
    assert rays == want_rays > 2 * 64 * 48
