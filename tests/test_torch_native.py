"""The port's native C++ oracle (vkrt_tpu_torch.native and
golden/cpu_tracer.py's accel="native", with_stable) vs the JAX package's.

tracer.cpp is the same file built with the same flags, so every result
is array-equal: closest and occluded hits, both stable variants, and
render_golden's image and stability mask. The port's tracer is also held
to tests/test_native.py's contracts against the port's brute-force
oracle (hit masks equal, >= 99.5% of triangle ids and occlusion answers
equal, t within rtol 2e-4). A failed build raises with the compiler's
output; concurrent builds leave one library.
"""

import dataclasses
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from vkrt_tpu import config as JC
from vkrt_tpu import native as jnative
from vkrt_tpu.golden import cpu_tracer as jgold
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch import native as tnative
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.golden import cpu_tracer as tgold
from vkrt_tpu_torch.scene import build_texture_heap, flatten_model
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.utils.cache import build_root


def jax_native():
    """vkrt_tpu.native with its library in place. The JAX package's loader
    rebuilds a missing or stale library in place with make, and a test
    process loading it while another writes it gets a torn file; so it
    is built here first from the JAX copy's own source with the same
    flags (test_source_and_flags_are_the_jax_packages) and moved into
    place whole. Returns the module."""
    so = Path(jnative._SO)
    src = so.with_name("tracer.cpp")
    if not so.is_file() or src.stat().st_mtime > so.stat().st_mtime:
        built = tnative.build(src, build_root() / "native" / "jax")
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        shutil.copyfile(built, tmp)
        os.replace(tmp, so)
    return jnative


@pytest.fixture(scope="module")
def nat_scene():
    rng = np.random.default_rng(17)
    n = 3000
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return v0, e1, e2, tnative.NativeBVH(v0, e1, e2)


def rays(n=512, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_source_and_flags_are_the_jax_packages():
    jdir = tnative.SRC_DIR.parent.parent / "vkrt_tpu" / "native"
    assert tnative.SOURCE.read_bytes() == (jdir / "tracer.cpp").read_bytes()
    jflags = [ln.split("?=", 1)[1].split() for ln in
              (jdir / "Makefile").read_text().splitlines()
              if ln.startswith("CXXFLAGS")][0]
    assert tnative.cxxflags() == jflags


@pytest.mark.parametrize("mode", ["closest", "occluded", "closest_stable",
                                  "occluded_stable"])
def test_native_equals_jax_native(nat_scene, mode):
    v0, e1, e2, bvh = nat_scene
    jbvh = jax_native().NativeBVH(v0, e1, e2)
    o, d = rays()
    tmax = np.random.default_rng(6).uniform(0.5, 20, o.shape[0]).astype(
        np.float32)
    kw = {"oeps": 1e-4, "deps": 3e-4} if mode.endswith("stable") else {}
    got = getattr(bvh, mode)(o, d, 0.001, tmax, **kw)
    want = getattr(jbvh, mode)(o, d, 0.001, tmax, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if mode.endswith("stable"):
        assert 0 < got[-1].sum() < got[-1].size    # some rays uncertified


def test_native_closest_matches_brute(nat_scene):
    v0, e1, e2, bvh = nat_scene
    o, d = rays()
    tmax = np.full(o.shape[0], 1e3, np.float32)
    t, tri, u, v = bvh.closest(o, d, 0.001, tmax)
    bt, btri, bu, bv = tgold.closest_hit(o, d, 0.001, 1e3, v0, e1, e2)
    hit = tri >= 0
    np.testing.assert_array_equal(hit, btri >= 0)
    assert (tri[hit] == btri[hit]).mean() > 0.995
    same = hit & (tri == btri)
    np.testing.assert_allclose(t[same], bt[same], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(u[same], bu[same], atol=2e-4)


def test_native_occluded_matches_brute(nat_scene):
    v0, e1, e2, bvh = nat_scene
    o, d = rays(seed=5)
    rng = np.random.default_rng(6)
    tmax = rng.uniform(0.5, 20, o.shape[0]).astype(np.float32)
    occ = bvh.occluded(o, d, 0.001, tmax)
    bocc = tgold.occluded(o, d, 0.001, tmax, v0, e1, e2)
    assert (occ == bocc).mean() > 0.995


@pytest.mark.parametrize("with_stable", [False, True])
def test_render_golden_native_equals_jax(with_stable):
    """The small procedural scene at 64x48, the reference workload (depth
    2, 4 lights): image (and stability mask) array-equal."""
    model = procedural_model("small", seed=0)
    flat = flatten_model(model)
    heap = build_texture_heap(model.images)
    cam = Camera(64, 48)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    tcfg = dataclasses.replace(TC.reference_config(), width=64, height=48)
    jcfg = dataclasses.replace(JC.reference_config(), width=64, height=48)
    args = (flat, heap, cam.proj_inverse, cam.view_inverse)
    got = tgold.render_golden(*args, tcfg, accel="native",
                              with_stable=with_stable)
    jax_native()
    want = jgold.render_golden(*args, jcfg, accel="native",
                               with_stable=with_stable)
    got = got if with_stable else (got,)
    want = want if with_stable else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isfinite(got[0]).all() and got[0].std() > 0.01
    if with_stable:
        assert 0.5 < got[1].mean() < 1.0


def test_with_stable_needs_native():
    model = procedural_model("small", seed=0)
    flat = flatten_model(model)
    cam = Camera(16, 16)
    cfg = dataclasses.replace(TC.reference_config(), width=16, height=16)
    with pytest.raises(ValueError, match="native"):
        tgold.render_golden(flat, build_texture_heap(model.images),
                            cam.proj_inverse, cam.view_inverse, cfg,
                            accel="brute", with_stable=True)


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="build failed") as e:
        tnative.build(bad, tmp_path / "build")
    assert "bad.cpp" in str(e.value)             # the compiler's output
    assert not list((tmp_path / "build").rglob("*.so"))


def test_concurrent_builds_leave_one_library(tmp_path):
    src = tmp_path / "tracer.cpp"
    src.write_bytes(tnative.SOURCE.read_bytes())
    out, errs = [], []

    def run():
        try:
            out.append(tnative.build(src, tmp_path / "build"))
        except RuntimeError as e:          # reported below, not swallowed
            errs.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs, errs
    assert len(out) == 3 and len(set(out)) == 1
    libs = list((tmp_path / "build").rglob("*.so"))
    assert libs == [out[0]]
