"""The benchmark's own copy of the port's seeded procedural scene.

It stands in for Crytek Sponza (not in the repository) at Sponza's
counts: the "full" size has 103 submeshes, 262,267 triangles and 23
materials, each three RGBA8 images of 512x512 (base colour,
metallic-roughness, normal). "small" (6 submeshes, about 2k triangles,
64x64 images) is for the CPU tests.

The copy is here so that a change to the program cannot move the
yardstick: tests/test_copies.py holds it bit for bit against the port's
`scene/procedural.py::procedural_model` as it stands today. `make_scene`
returns plain numpy data (`Scene`); `run.py` hands it to the program as
the program's own Model type, and `reference.py` flattens it itself.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

SIZES = {
    # submeshes, triangles, image side, materials
    "full": (103, 262_267, 512, 23),
    "small": (6, 2_000, 64, 4),
}

# (min xyz, max xyz) in model units; the thin axis is the sheet's normal
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
_SMALL_PARTS = [0, 1, 2, 3, 4]
_SMALL_PILLAR = ((-800.0, -100.0, -470.0), (-600.0, 600.0, -450.0))
CUTOUT_RADIUS = 0.3


class Submesh(NamedTuple):
    positions: np.ndarray   # f32[N,3], model units
    normals: np.ndarray     # f32[N,3]
    uvs: np.ndarray         # f32[N,2]
    tangents: np.ndarray    # f32[N,4]
    indices: np.ndarray     # u32[3K], local to the submesh
    material: int


class Scene(NamedTuple):
    submeshes: List[Submesh]
    materials: List[tuple]      # (base, metallic-roughness, normal) ids
    images: List[np.ndarray]    # u8[H,W,4]


def _grid_patch(rng, n_verts, n_tris, aabb_min, aabb_max, material=-1):
    """One undulating grid sheet hugging a face of its box."""
    extent = aabb_max - aabb_min
    order = np.argsort(extent)
    s_ax, v_ax, u_ax = int(order[0]), int(order[1]), int(order[2])
    eu = max(float(extent[u_ax]), 1e-5)
    ev = max(float(extent[v_ax]), 1e-5)
    cols = int(np.clip(round(np.sqrt(n_verts * eu / ev)), 2,
                       max(2, n_verts // 2)))
    rows = max(2, n_verts // cols)
    cols = min(cols, n_verts // rows)
    rows, cols = max(2, rows), max(2, cols)
    used = rows * cols

    u = np.linspace(0.0, 1.0, cols, dtype=np.float32)
    v = np.linspace(0.0, 1.0, rows, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    freq = rng.integers(1, 4, size=2)
    face = float(rng.integers(0, 2))
    s_amp = 0.06
    inset = s_amp + float(rng.uniform(0.0, 0.08))
    base = face + (1.0 - 2.0 * face) * inset
    ss = base + s_amp * (np.sin(2 * np.pi * freq[0] * uu + phase[0])
                         * np.cos(2 * np.pi * freq[1] * vv + phase[1])
                         ).astype(np.float32)

    pos = np.zeros((rows, cols, 3), dtype=np.float32)
    pos[..., u_ax] = aabb_min[u_ax] + uu * extent[u_ax]
    pos[..., v_ax] = aabb_min[v_ax] + vv * extent[v_ax]
    pos[..., s_ax] = aabb_min[s_ax] + ss * extent[s_ax]
    pos[0, 0, s_ax] = aabb_min[s_ax]
    pos[-1, -1, s_ax] = aabb_max[s_ax]

    du = np.gradient(pos, axis=1)
    dv = np.gradient(pos, axis=0)
    nrm = np.cross(du, dv)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    tan = du / np.maximum(np.linalg.norm(du, axis=-1, keepdims=True), 1e-12)

    positions = pos.reshape(-1, 3)
    normals = nrm.reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu * 4.0, vv * 4.0], axis=-1).reshape(-1, 2).astype(
        np.float32)
    tangents = np.concatenate([tan.reshape(-1, 3).astype(np.float32),
                               np.ones((used, 1), dtype=np.float32)], axis=1)
    pad = n_verts - used
    if pad > 0:
        positions, normals, uvs, tangents = (
            np.concatenate([a, np.repeat(a[-1:], pad, 0)])
            for a in (positions, normals, uvs, tangents))

    r = np.arange(rows - 1)[:, None]
    c = np.arange(cols - 1)[None, :]
    a = (r * cols + c).reshape(-1)
    tris = np.concatenate([np.stack([a, a + 1, a + cols], axis=1),
                           np.stack([a + 1, a + cols + 1, a + cols], axis=1)])
    if tris.shape[0] >= n_tris:
        tris = tris[:n_tris]
    else:   # degenerate (0, 0, 0) padding: zero area, never hit
        tris = np.concatenate(
            [tris, np.zeros((n_tris - tris.shape[0], 3), dtype=np.int64)])
    return Submesh(positions, normals, uvs, tangents,
                   tris.reshape(-1).astype(np.uint32), material)


def _pillar_boxes(n):
    xs = np.linspace(-1600.0, 1500.0, n // 2)
    return [((x - 60.0, -100.0, z - 10.0), (x + 60.0, 600.0, z + 10.0))
            for z in (-460.0, 460.0) for x in xs]


def _aisle_boxes(rng, n):
    boxes = []
    for _ in range(n):
        side = 1.0 if rng.random() < 0.5 else -1.0
        x = float(rng.uniform(-1750.0, 1650.0))
        y = float(rng.uniform(-100.0, 1250.0))
        z = side * float(rng.uniform(560.0, 1000.0))
        w = float(rng.uniform(40.0, 220.0))
        h = float(rng.uniform(40.0, 260.0))
        thin = float(rng.uniform(8.0, 20.0))
        if rng.random() < 0.5:
            lo, hi = (x - w, y, z - thin), (x + w, y + h, z + thin)
        else:
            lo, hi = (x - thin, y, z - w), (x + thin, y + h, z + w)
        boxes.append((lo, hi))
    return boxes


def _split_triangles(rng, boxes, total):
    area = np.array([sorted(np.subtract(hi, lo))[1]
                     * sorted(np.subtract(hi, lo))[2] for lo, hi in boxes])
    w = area ** 0.75 * rng.lognormal(0.0, 0.3, len(boxes))
    counts = np.maximum(2, np.floor(w / w.sum() * total)).astype(np.int64)
    counts[int(np.argmax(counts))] += total - int(counts.sum())
    return counts


def _texture_set(rng, side, metallic, cutout):
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
    sx = 0.25 * np.sin(2 * np.pi * f[0] * xx + ph[1])
    sy = 0.25 * np.cos(2 * np.pi * f[1] * yy + ph[0])
    n = np.stack([sx, sy, np.ones_like(sx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nm = np.empty((side, side, 4), np.uint8)
    nm[..., :3] = np.clip((n * 0.5 + 0.5) * 255.0 + 0.5, 0, 255)
    nm[..., 3] = 255
    return [base, mr, nm]


def make_scene(size: str = "full", seed: int = 0) -> Scene:
    """The procedural scene at `size`, a pure function of (size, seed)."""
    n_sub, n_tris, side, n_mat = SIZES[size]
    rng = np.random.default_rng(seed)
    if size == "full":
        boxes = (list(_HALL) + _pillar_boxes(40)
                 + _aisle_boxes(rng, n_sub - len(_HALL) - 40))
    else:
        boxes = [_HALL[i] for i in _SMALL_PARTS] + [_SMALL_PILLAR]
    counts = _split_triangles(rng, boxes, n_tris)

    metallic = np.where(rng.random(n_mat) < 0.35,
                        rng.uniform(0.4, 0.9, n_mat), 0.0)
    metallic[0] = max(metallic[0], 0.5)
    cutout = (metallic == 0) & (np.arange(n_mat) % 4 == 3)
    images, materials = [], []
    for m in range(n_mat):
        images += _texture_set(rng, side, float(metallic[m]),
                               bool(cutout[m]))
        materials.append((3 * m, 3 * m + 1, 3 * m + 2))

    submeshes = []
    for i, ((lo, hi), nt) in enumerate(zip(boxes, counts)):
        nt = int(nt)
        n_verts = nt // 2 + 4 * int(np.sqrt(nt)) + 8
        sm = _grid_patch(rng, n_verts, nt, np.asarray(lo, np.float32),
                         np.asarray(hi, np.float32))
        material = 0 if i == 0 else int(rng.integers(0, n_mat))
        submeshes.append(sm._replace(material=material))
    if size == "small":
        submeshes[-1] = submeshes[-1]._replace(material=0)
    return Scene(submeshes, materials, images)
