"""Seeded procedural scene at Sponza's scale — test and smoke scaffolding.

It stands in for the Sponza glTF buffer, which is not in the repository:
neither the CLI's default scene nor the `sponza_model` test fixture can
load without it. This module is NOT a renderer feature. It builds a
`vkrt_tpu_torch.scene.Model` that the shared loader path (flatten, material
heap) and both renderers take as they take Sponza.

Layout: an atrium hall in model units (flatten_model scales by
SCENE_SCALE = 0.01 into world units), about Sponza's world bounds —
x in [-19, 18], y in [-1.3, 14.3], z in [-11, 12]. Each submesh is one
undulating grid sheet (`vkrt_tpu_torch.scene.synth._grid_patch`) hugging a face
of its box: floor, ceiling, walls, a gallery floor on each side, pillar
faces along z = ±4.5 and smaller panels in the aisles. The camera start
and all four lights lie inside the hall, clear of every sheet.

Sizes:
  full   103 submeshes, exactly 262,267 triangles (Sponza's counts),
         23 materials = 69 RGBA8 images of 512x512 (base /
         metallic-roughness / normal triples)
  small  6 submeshes, ~2k triangles, 64x64 images — for tests

Metallic (blue channel of the metallic-roughness map) is constant per
material, either 0 or in [0.4, 0.9], far from the 0.1 reflection
threshold so reflection decisions never sit on the threshold.

Cut-outs: the non-metallic materials whose index is 3 mod 4 (small: 3,
the wall z+ and the far end wall; full: 3, 7, 11 and 19, the ceiling
among them) have alpha 0 in a round hole of each texture repeat of
their base map, like Sponza's foliage, so the raster path's alpha
discard has work to do. The choice draws nothing from the generator, so
geometry, RGB texels and metallic values do not depend on it; the ray
tracing path reads no alpha.
"""

from __future__ import annotations

import numpy as np

from vkrt_tpu_torch.scene.model import Image, Material, Model
from vkrt_tpu_torch.scene.synth import _grid_patch

SIZES = {
    # submeshes, triangles, image side, materials
    "full": (103, 262_267, 512, 23),
    "small": (6, 2_000, 64, 4),
}

# Fixed structure (model units): (min xyz, max xyz). The thin axis of
# each box is the sheet's normal.
_HALL = [
    ((-1900.0, -130.0, -1100.0), (1800.0, -100.0, 1200.0)),   # floor
    ((-1900.0, 1400.0, -1100.0), (1800.0, 1430.0, 1200.0)),   # ceiling
    ((-1900.0, -130.0, -1100.0), (1800.0, 1430.0, -1070.0)),  # wall z-
    ((-1900.0, -130.0, 1170.0), (1800.0, 1430.0, 1200.0)),    # wall z+
    ((-1900.0, -130.0, -1100.0), (-1870.0, 1430.0, 1200.0)),  # end wall x-
    ((1770.0, -130.0, -1100.0), (1800.0, 1430.0, 1200.0)),    # end wall x+
    ((-1900.0, 600.0, -1100.0), (1800.0, 630.0, -650.0)),     # gallery z-
    ((-1900.0, 600.0, 700.0), (1800.0, 630.0, 1200.0)),       # gallery z+
]
# the small scene: floor, ceiling, both long walls, the far end wall and
# one pillar face (whose material is the metallic one)
_SMALL_PARTS = [0, 1, 2, 3, 4]
_SMALL_PILLAR = ((-800.0, -100.0, -470.0), (-600.0, 600.0, -450.0))


def _pillar_boxes(n: int) -> list:
    """n/2 pillar faces along each of z = -460 and z = +460."""
    xs = np.linspace(-1600.0, 1500.0, n // 2)
    return [((x - 60.0, -100.0, z - 10.0), (x + 60.0, 600.0, z + 10.0))
            for z in (-460.0, 460.0) for x in xs]


def _aisle_boxes(rng: np.random.Generator, n: int) -> list:
    """Small panels in the side aisles (|z| > 550) and on the gallery
    fronts — decoration at Sponza's submesh count, off the lights' and
    camera's positions (all at |z| < 100)."""
    boxes = []
    for _ in range(n):
        side = 1.0 if rng.random() < 0.5 else -1.0
        x = float(rng.uniform(-1750.0, 1650.0))
        y = float(rng.uniform(-100.0, 1250.0))
        z = side * float(rng.uniform(560.0, 1000.0))
        w = float(rng.uniform(40.0, 220.0))
        h = float(rng.uniform(40.0, 260.0))
        thin = float(rng.uniform(8.0, 20.0))
        if rng.random() < 0.5:      # thin in z: faces the hall
            lo, hi = (x - w, y, z - thin), (x + w, y + h, z + thin)
        else:                       # thin in x: faces along the aisle
            lo, hi = (x - thin, y, z - w), (x + thin, y + h, z + w)
        boxes.append((lo, hi))
    return boxes


def _split_triangles(rng: np.random.Generator, boxes: list,
                     total: int) -> np.ndarray:
    """Triangle count per box: weighted by area^0.75 with lognormal
    jitter, at least 2 each, summing to exactly `total`."""
    area = np.array([sorted(np.subtract(hi, lo))[1]
                     * sorted(np.subtract(hi, lo))[2] for lo, hi in boxes])
    w = area ** 0.75 * rng.lognormal(0.0, 0.3, len(boxes))
    counts = np.maximum(2, np.floor(w / w.sum() * total)).astype(np.int64)
    counts[int(np.argmax(counts))] += total - int(counts.sum())
    assert counts.min() >= 2 and counts.sum() == total
    return counts


CUTOUT_RADIUS = 0.3   # hole radius in texture units, centred in each repeat


def _texture_set(rng: np.random.Generator, side: int, metallic: float,
                 cutout: bool):
    """One material's (base, metallic-roughness, normal) RGBA8 images;
    `cutout` punches an alpha-0 hole into the base map."""
    yy, xx = np.meshgrid(np.arange(side, dtype=np.float32) / side,
                         np.arange(side, dtype=np.float32) / side,
                         indexing="ij")
    hue = rng.uniform(0.25, 0.95, 3).astype(np.float32)
    f = rng.integers(2, 9, 2).astype(np.float32)
    ph = rng.uniform(0.0, 2.0 * np.pi, 2).astype(np.float32)
    checker = ((np.floor(xx * f[0]) + np.floor(yy * f[1])) % 2).astype(
        np.float32)
    wave = 0.5 + 0.5 * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) + ph[0])
    shade = 0.55 + 0.25 * checker + 0.2 * wave
    base = np.empty((side, side, 4), np.uint8)
    base[..., :3] = np.clip(shade[..., None] * hue * 255.0 + 0.5, 0, 255)
    base[..., 3] = 255
    if cutout:
        hole = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 < CUTOUT_RADIUS ** 2
        base[..., 3] = np.where(hole, 0, 255)

    mr = np.empty((side, side, 4), np.uint8)
    mr[..., 0] = 0
    mr[..., 1] = np.clip((0.3 + 0.4 * wave) * 255.0 + 0.5, 0, 255)
    mr[..., 2] = int(round(metallic * 255.0))
    mr[..., 3] = 255

    # gentle bumps: tangent-space normal (sx, sy, 1) normalized
    sx = 0.25 * np.sin(2 * np.pi * f[0] * xx + ph[1])
    sy = 0.25 * np.cos(2 * np.pi * f[1] * yy + ph[0])
    n = np.stack([sx, sy, np.ones_like(sx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nm = np.empty((side, side, 4), np.uint8)
    nm[..., :3] = np.clip((n * 0.5 + 0.5) * 255.0 + 0.5, 0, 255)
    nm[..., 3] = 255
    return [Image(width=side, height=side, data=base),
            Image(width=side, height=side, data=mr),
            Image(width=side, height=side, data=nm)]


def procedural_model(size: str = "full", seed: int = 0) -> Model:
    """The procedural scene at `size` ("full" or "small"), a pure function
    of (size, seed)."""
    if size not in SIZES:
        raise ValueError(f"unknown size {size!r}; expected one of {list(SIZES)}")
    n_sub, n_tris, side, n_mat = SIZES[size]
    rng = np.random.default_rng(seed)

    if size == "full":
        n_pillars = 40
        boxes = (list(_HALL) + _pillar_boxes(n_pillars)
                 + _aisle_boxes(rng, n_sub - len(_HALL) - n_pillars))
    else:
        boxes = [_HALL[i] for i in _SMALL_PARTS] + [_SMALL_PILLAR]
    assert len(boxes) == n_sub
    counts = _split_triangles(rng, boxes, n_tris)

    # metallic materials: about a third, always including material 0
    # (the floor's) so every view has reflection rays
    metallic = np.where(rng.random(n_mat) < 0.35,
                        rng.uniform(0.4, 0.9, n_mat), 0.0)
    metallic[0] = max(metallic[0], 0.5)
    cutout = (metallic == 0) & (np.arange(n_mat) % 4 == 3)
    images, materials = [], []
    for m in range(n_mat):
        images += _texture_set(rng, side, float(metallic[m]),
                               bool(cutout[m]))
        materials.append(Material(base_color=3 * m,
                                  metallic_roughness=3 * m + 1,
                                  normal=3 * m + 2))

    submeshes = []
    for i, ((lo, hi), nt) in enumerate(zip(boxes, counts)):
        nt = int(nt)
        n_verts = nt // 2 + 4 * int(np.sqrt(nt)) + 8
        sm = _grid_patch(rng, n_verts=n_verts, n_tris=nt,
                         aabb_min=np.asarray(lo, np.float32),
                         aabb_max=np.asarray(hi, np.float32))
        sm.material = 0 if i == 0 else int(rng.integers(0, n_mat))
        submeshes.append(sm)
    if size == "small":
        submeshes[-1].material = 0       # the pillar face reflects too
    return Model(submeshes=submeshes, materials=materials, images=images)
