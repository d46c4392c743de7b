"""The procedural stand-in scene: sizes, placement and determinism."""

import numpy as np
import pytest

from vkrt_tpu import config as C
from vkrt_tpu.scene import flatten_model
from vkrt_tpu_torch.scene.procedural import SIZES, procedural_model
import torch_support  # noqa: F401


def scene_bounds(model):
    """World-space (lo, hi) of the model's vertices."""
    flat = flatten_model(model)
    return flat.positions.min(axis=0), flat.positions.max(axis=0)


@pytest.fixture(scope="module")
def full():
    return procedural_model("full", seed=0)


def test_full_size_matches_sponza_counts(full):
    assert len(full.submeshes) == 103
    assert full.num_triangles == 262_267
    assert len(full.images) == 69
    assert all(im.data.shape == (512, 512, 4) and im.data.dtype == np.uint8
               for im in full.images)
    # base / metallic-roughness / normal triples
    assert [(m.base_color, m.metallic_roughness, m.normal)
            for m in full.materials] == [(3 * k, 3 * k + 1, 3 * k + 2)
                                         for k in range(23)]


@pytest.mark.parametrize("size", sorted(SIZES))
def test_camera_and_lights_inside_and_reflective(size, full):
    model = full if size == "full" else procedural_model(size, seed=0)
    lo, hi = scene_bounds(model)
    pts = np.vstack([C.LIGHT_POSITIONS, [C.CAMERA_START_POSITION]])
    assert ((pts > lo) & (pts < hi)).all()
    metallic = np.array([model.images[m.metallic_roughness].data[..., 2]
                         for m in model.materials]) / 255.0
    used = {s.material for s in model.submeshes}
    assert any(metallic[m].min() > C.METALLIC_THRESHOLD for m in used)
    # every material sits far from the reflection threshold
    assert (np.abs(metallic - C.METALLIC_THRESHOLD) > 0.05).all()


def test_small_size_and_determinism():
    a = procedural_model("small", seed=3)
    b = procedural_model("small", seed=3)
    c = procedural_model("small", seed=4)
    assert len(a.submeshes) == 6 and 1500 <= a.num_triangles <= 3000
    assert a.images[0].data.shape == (64, 64, 4)
    fa, fb, fc = (flatten_model(m) for m in (a, b, c))
    np.testing.assert_array_equal(fa.positions, fb.positions)
    np.testing.assert_array_equal(a.images[4].data, b.images[4].data)
    assert not np.array_equal(fa.positions, fc.positions)


def test_unknown_size_raises():
    with pytest.raises(ValueError, match="unknown size"):
        procedural_model("huge")
