"""The port's raster pipeline on the CPU: the ray-cast method vs the
raster oracle, the Rasterizer entry point, the FPS overlay vs the JAX
package's, and the procedural scene's alpha cut-outs."""

import copy
import dataclasses
import hashlib

import numpy as np
import pytest

from vkrt_tpu import config as JC
from vkrt_tpu.app.overlay import draw_text as jax_draw_text
from vkrt_tpu_torch import config as C
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.app.framebuffer import rmse
from vkrt_tpu_torch.app.overlay import draw_text
from vkrt_tpu_torch.golden.raster_oracle import render_golden_raster
from vkrt_tpu_torch.raster import pipeline as rp
from vkrt_tpu_torch.scene import build_texture_heap
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront.engine import Renderer
import torch_support  # noqa: F401

W, H = 64, 48
# sha256 of the small scene's geometry, materials and RGB texels as they
# were before the cut-outs (see scene_digest)
SMALL_DIGEST = ("13a4f2fd4d9888beaebee91c3ad47a3df078cffe263edb5b61b6df04"
                "c1afad4c")


def start_camera():
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return cam


def raster_cfg():
    return dataclasses.replace(C.reference_config(), width=W, height=H)


def opaque_copy(model):
    """The model with every base map's alpha forced to 255."""
    out = copy.deepcopy(model)
    for m in out.materials:
        out.images[m.base_color].data[..., 3] = 255
    return out


@pytest.fixture(scope="module")
def small():
    return procedural_model("small", seed=0)


def test_wavefront_method_matches_oracle(small):
    r = rp.Rasterizer(small, raster_cfg(), "cpu", msaa=1,
                      method="wavefront")
    cam = start_camera()
    fb = r.render(cam, show_fps=False)
    want = render_golden_raster(r.flat, build_texture_heap(small.images),
                                cam.proj_inverse, cam.view_inverse,
                                raster_cfg(), msaa=1)
    assert fb.shape == (H, W, 3) and np.isfinite(fb).all()
    assert rmse(fb, want) <= 1e-3


def test_rasterizer_on_cpu(small):
    """method "auto" is the edge rasterizer; render() burns in the FPS
    text; msaa 8 averages 8 samples, so it smooths the msaa-1 frame."""
    cam = start_camera()
    r8 = rp.Rasterizer(small, raster_cfg(), "cpu")
    assert r8.method == "edge" and r8.msaa == 8
    plain = r8.render(cam, show_fps=False)
    shown = r8.render(cam)
    assert plain.shape == (H, W, 3) and plain.dtype == np.float32
    assert np.isfinite(plain).all() and plain.std() > 0.05
    # the overlay changes only its corner
    diff = (shown != plain).any(-1)
    assert diff.any() and not diff[30:].any()
    r1 = rp.Rasterizer(small, raster_cfg(), "cpu", msaa=1)
    sharp = r1.render(cam, show_fps=False)
    step = lambda f: np.abs(np.diff(f, axis=1)).mean()
    assert step(plain) < step(sharp)


def test_rasterizer_rejects_bad_arguments(small):
    with pytest.raises(ValueError, match="msaa"):
        rp.Rasterizer(small, raster_cfg(), "cpu", msaa=4)
    with pytest.raises(ValueError, match="method"):
        rp.Rasterizer(small, raster_cfg(), "cpu", method="scanline")
    jcfg = dataclasses.replace(JC.reference_config(), width=W, height=H)
    with pytest.raises(TypeError, match="RenderConfig"):
        rp.Rasterizer(small, jcfg, "cpu")
    with pytest.raises(TypeError, match="RenderConfig"):
        Renderer(small, jcfg, "cpu")


@pytest.mark.parametrize("text,x,y,scale", [
    ("FPS 59.9", 8, 8, 2), ("FPS 123.4: ms", 3, 40, 1), ("0123456789", 50, 0, 3)])
def test_draw_text_matches_jax(rng, text, x, y, scale):
    fb = rng.random((48, 64, 3)).astype(np.float32)
    got = draw_text(fb, text, x, y, color=(1.0, 0.5, 0.0), scale=scale)
    want = jax_draw_text(fb, text, x, y, color=(1.0, 0.5, 0.0), scale=scale)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert (got != fb).any()


def scene_digest(model) -> str:
    h = hashlib.sha256()
    for sm in model.submeshes:
        for a in (sm.positions, sm.normals, sm.uvs, sm.tangents, sm.indices):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(str(sm.material).encode())
    for im in model.images:
        h.update(np.ascontiguousarray(im.data[..., :3]).tobytes())
    return h.hexdigest()


def test_cutouts_change_alpha_only(small):
    """Geometry, materials and RGB texels are byte-equal to the scene
    before the cut-outs; material 3 (non-metallic, 3 mod 4) has alpha-0
    holes in its base map and every other base map is opaque."""
    assert scene_digest(small) == SMALL_DIGEST
    cut = [k for k, m in enumerate(small.materials)
           if (small.images[m.base_color].data[..., 3] == 0).any()]
    assert cut == [3]
    base = small.images[small.materials[3].base_color].data[..., 3]
    assert set(np.unique(base)) == {0, 255}
    assert 0.2 < (base == 0).mean() < 0.35          # pi * 0.3^2
    metallic = small.images[small.materials[3].metallic_roughness].data
    assert (metallic[..., 2] == 0).all()


def test_cutouts_leave_the_ray_traced_frame_unchanged(small):
    """The ray tracing path reads no alpha: a 64x48 config-4 frame is
    bit-equal with the cut-outs and with every alpha forced to 255."""
    cfg = dataclasses.replace(C.config4_flythrough(), width=W, height=H)
    cam = start_camera()
    fb, rays = Renderer(small, cfg, "cpu").render(cam)
    want, want_rays = Renderer(opaque_copy(small), cfg, "cpu").render(cam)
    np.testing.assert_array_equal(fb, want)
    assert rays == want_rays


def test_cutouts_show_in_the_raster_frame(small):
    """The raster path discards the holes' fragments: the edge frame sees
    through them, so it differs from the opaque scene's frame."""
    cam = start_camera()
    fb = rp.Rasterizer(small, raster_cfg(), "cpu", msaa=1).render(
        cam, show_fps=False)
    opaque = rp.Rasterizer(opaque_copy(small), raster_cfg(), "cpu",
                           msaa=1).render(cam, show_fps=False)
    seen_through = (np.abs(fb - opaque).max(-1) > 0.05).mean()
    assert seen_through > 0.02
