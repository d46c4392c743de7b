"""Deterministic synthetic geometry for missing glTF buffers.

The environment ships Sponza.gltf (full JSON: accessors, materials, textures)
and all 69 texture JPEGs, but not the 9.5MB Sponza.bin geometry buffer. To
keep the full pipeline exercisable with the *exact* reference workload shape
(103 submeshes, 262,267 triangles, 192,496 vertices — SURVEY.md §2 item 12),
this module synthesizes, per primitive, a smooth curtain-like grid patch that

  * has exactly the accessor-declared vertex and index counts,
  * fills exactly the accessor-declared POSITION min/max AABB,
  * carries analytic normals/uvs/tangents,
  * is a pure function of the primitive index (seeded RNG — bit-stable
    across runs, so golden images remain valid).

If a real Sponza.bin is placed next to the glTF, the normal loader path is
used instead and this module is never invoked.
"""

from __future__ import annotations

from typing import List

import numpy as np

from vkrt_tpu_torch.scene.model import Submesh


def _grid_patch(rng: np.random.Generator, n_verts: int, n_tris: int,
                aabb_min: np.ndarray, aabb_max: np.ndarray) -> Submesh:
    extent = aabb_max - aabb_min
    # Axes: patch spans the two largest extents; undulates along the smallest.
    order = np.argsort(extent)           # ascending
    s_ax, v_ax, u_ax = int(order[0]), int(order[1]), int(order[2])

    eu = max(float(extent[u_ax]), 1e-5)
    ev = max(float(extent[v_ax]), 1e-5)
    cols = int(np.clip(round(np.sqrt(n_verts * eu / ev)), 2, max(2, n_verts // 2)))
    rows = max(2, n_verts // cols)
    cols = min(cols, n_verts // rows)
    rows, cols = max(2, rows), max(2, cols)
    used = rows * cols

    u = np.linspace(0.0, 1.0, cols, dtype=np.float32)
    v = np.linspace(0.0, 1.0, rows, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)          # [rows, cols]

    # Architectural placement: the sheet hugs one FACE of the AABB along
    # the smallest axis (like Sponza's walls/floors/columns — submeshes
    # are split by material, so their AABBs overlap heavily; centering
    # every sheet would stack ~30 surfaces through every point of space,
    # an unrealistically high depth complexity), with mild undulation.
    phase = rng.uniform(0, 2 * np.pi, size=3)
    freq = rng.integers(1, 4, size=2)
    face = float(rng.integers(0, 2))           # which face of the AABB
    s_amp = 0.06
    # per-submesh inward offset: submeshes whose AABBs share a face must
    # NOT produce coincident sheets (z-fighting makes winner selection —
    # and therefore any golden comparison — ill-defined; real Sponza has
    # no coincident walls)
    inset = s_amp + float(rng.uniform(0.0, 0.08))
    base = face + (1.0 - 2.0 * face) * inset   # just inside the chosen face
    ss = base + s_amp * (np.sin(2 * np.pi * freq[0] * uu + phase[0])
                         * np.cos(2 * np.pi * freq[1] * vv + phase[1])).astype(np.float32)

    pos = np.zeros((rows, cols, 3), dtype=np.float32)
    pos[..., u_ax] = aabb_min[u_ax] + uu * extent[u_ax]
    pos[..., v_ax] = aabb_min[v_ax] + vv * extent[v_ax]
    pos[..., s_ax] = aabb_min[s_ax] + ss * extent[s_ax]

    # Pin boundary samples so the accessor min/max is met exactly on all axes.
    pos[0, 0, s_ax] = aabb_min[s_ax]
    pos[-1, -1, s_ax] = aabb_max[s_ax]

    # Analytic partials → normals/tangents.
    du = np.gradient(pos, axis=1)
    dv = np.gradient(pos, axis=0)
    nrm = np.cross(du, dv)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    tan = du / np.maximum(np.linalg.norm(du, axis=-1, keepdims=True), 1e-12)

    positions = pos.reshape(-1, 3)
    normals = nrm.reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu * 4.0, vv * 4.0], axis=-1).reshape(-1, 2).astype(np.float32)
    tangents = np.concatenate(
        [tan.reshape(-1, 3).astype(np.float32),
         np.ones((used, 1), dtype=np.float32)], axis=1)

    # Pad duplicated last vertex up to the exact accessor count.
    pad = n_verts - used
    if pad > 0:
        positions = np.concatenate([positions, np.repeat(positions[-1:], pad, 0)])
        normals = np.concatenate([normals, np.repeat(normals[-1:], pad, 0)])
        uvs = np.concatenate([uvs, np.repeat(uvs[-1:], pad, 0)])
        tangents = np.concatenate([tangents, np.repeat(tangents[-1:], pad, 0)])

    # Grid triangulation; excess triangles padded degenerate (0,0,0) — the
    # intersector rejects zero-area triangles, mirroring how a driver BVH
    # treats degenerates.
    r = np.arange(rows - 1)[:, None]
    c = np.arange(cols - 1)[None, :]
    a = (r * cols + c).reshape(-1)
    tris = np.concatenate([
        np.stack([a, a + 1, a + cols], axis=1),
        np.stack([a + 1, a + cols + 1, a + cols], axis=1),
    ])
    if tris.shape[0] >= n_tris:
        tris = tris[:n_tris]
    else:
        pad_tris = np.zeros((n_tris - tris.shape[0], 3), dtype=np.int64)
        tris = np.concatenate([tris, pad_tris])

    return Submesh(positions=positions, normals=normals, uvs=uvs,
                   tangents=tangents,
                   indices=tris.reshape(-1).astype(np.uint32))


def synthesize_primitives(gltf: dict) -> List[Submesh]:
    accessors = gltf["accessors"]
    prims = gltf["meshes"][0]["primitives"]
    submeshes = []
    for i, prim in enumerate(prims):
        pos_acc = accessors[prim["attributes"]["POSITION"]]
        idx_acc = accessors[prim["indices"]]
        rng = np.random.default_rng(0xC0FFEE + i)
        sm = _grid_patch(
            rng,
            n_verts=pos_acc["count"],
            n_tris=idx_acc["count"] // 3,
            aabb_min=np.asarray(pos_acc["min"], dtype=np.float32),
            aabb_max=np.asarray(pos_acc["max"], dtype=np.float32),
        )
        sm.material = prim.get("material", -1)
        # Reference leaves absent attributes zero-initialized
        # (src/Model.hpp:11-18 default Vertex) — mirror for TANGENT.
        if "TANGENT" not in prim["attributes"]:
            sm.tangents[:] = 0.0
        submeshes.append(sm)
    return submeshes
