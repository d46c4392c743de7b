"""The benchmark's copies of the traffic and the scene equal the port's
own today, bit for bit (a later change to the port cannot move them)."""

import json

import numpy as np
import pytest

import scene_gen
import spec
from conftest import BENCH

fly = spec.module("generators", "fly")


@pytest.mark.parametrize("size", ["full", "small"])
def test_scene_equals_procedural_model(size):
    from vkrt_tpu_torch.scene.procedural import procedural_model
    ours = scene_gen.make_scene(size, seed=0)
    theirs = procedural_model(size, seed=0)
    assert len(ours.submeshes) == len(theirs.submeshes)
    for a, b in zip(ours.submeshes, theirs.submeshes):
        for k in ("positions", "normals", "uvs", "tangents", "indices"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        assert a.material == b.material
    assert ours.materials == [(m.base_color, m.metallic_roughness,
                               m.normal) for m in theirs.materials]
    assert len(ours.images) == len(theirs.images)
    for a, b in zip(ours.images, theirs.images):
        assert np.array_equal(a, b.data)
    if size == "full":
        assert sum(len(s.indices) // 3 for s in ours.submeshes) == 262_267
        assert len(ours.submeshes) == 103 and len(ours.images) == 69


@pytest.mark.parametrize("mix", ["fly", "fly_sway"])
def test_camera_path_equals_flythrough(mix):
    from vkrt_tpu_torch.app.flythrough import camera_path
    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    ours = fly.camera_poses(m, 1920, 1080)
    theirs = list(camera_path(1920, 1080))
    assert len(ours) == len(theirs) == 240
    for a, b in zip(ours, theirs):
        assert a.proj_inverse.dtype == np.float32
        assert np.array_equal(a.proj_inverse, b.proj_inverse)
        assert np.array_equal(a.view_inverse, b.view_inverse)


def test_sway_is_a_y_rotation_of_the_paths_period():
    m = json.loads((BENCH / "traffic" / "fly_sway.json").read_text())
    assert fly.sway(json.loads((BENCH / "traffic" / "fly.json")
                                   .read_text()), 5) is None
    for k in (0, 60, 100, 180, 239):
        a = 0.1 * np.sin(2 * np.pi * k / 240)
        r = fly.sway(m, k)
        assert r.dtype == np.float32
        np.testing.assert_allclose(r[:3, :3] @ r[:3, :3].T, np.eye(3),
                                   atol=1e-6)
        np.testing.assert_allclose(r @ np.array([1.0, 0, 0, 1]),
                                   [np.cos(a), 0, -np.sin(a), 1], atol=1e-6)
        assert np.array_equal(r[1], [0, 1, 0, 0]) and np.array_equal(
            r[:, 3], [0, 0, 0, 1])


def test_frames_loop_from_path_frame_0_on_every_seed():
    m = json.loads((BENCH / "traffic" / "fly_sway.json").read_text())
    f = fly.Frames(m, 64, 32, seed=2**31 + 5)
    g = fly.Frames(m, 64, 32, seed=7)
    assert len(f) == len(g) == 240
    for i in (0, 17, 239, 240, 500):
        (k, p, t), (k2, p2, t2) = f(i), g(i)
        assert k == k2 == i % 240
        assert np.array_equal(p.view_inverse, p2.view_inverse)
        assert np.array_equal(t, t2)
        pa, ta = f.at(k)
        assert np.array_equal(pa.view_inverse, p.view_inverse)
        assert np.array_equal(ta, t)
