"""glTF 2.0 ingest — behavioral port of the reference loader.

Replaces tinygltf + Model.cpp (ref: src/Model.cpp:48-191): flattens
`meshes[0].primitives` into submeshes, widens u16 indices to u32
(ref: src/Model.cpp:68-77), reads POSITION/NORMAL/TEXCOORD_0/TANGENT
attributes (missing attributes stay zero, like the reference's
default-initialized Vertex), resolves material→image source indices with -1
fallback (ref: src/Model.cpp:122-136), and decodes images to RGBA8
(stb_image in the reference; PIL here).

When the binary geometry buffer is absent (this environment ships
Sponza.gltf + textures but not Sponza.bin), deterministic synthetic geometry
with *exactly* the accessor-declared vertex/index counts and POSITION AABBs
is generated instead (see synth.py) so the full pipeline stays exercisable.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from vkrt_tpu_torch.scene.model import Image, Material, Model, Submesh
from vkrt_tpu_torch.utils.log import get_logger

log = get_logger("vkrt_tpu_torch.scene")

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _read_accessor(gltf: dict, buffers: Dict[int, Optional[bytes]], accessor_index: int) -> np.ndarray:
    """Decode one accessor into an [count, components] numpy array."""
    acc = gltf["accessors"][accessor_index]
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    assert buf is not None

    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    elem_size = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride") or elem_size
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)

    if stride == elem_size:
        out = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=base)
        return out.reshape(count, ncomp).copy()
    raw = np.frombuffer(buf, dtype=np.uint8)
    idx = base + stride * np.arange(count)[:, None] + np.arange(elem_size)[None, :]
    return raw[idx].view(dtype).reshape(count, ncomp).copy()


def _load_primitive(gltf: dict, buffers: dict, prim: dict) -> Submesh:
    n_verts = gltf["accessors"][prim["attributes"]["POSITION"]]["count"]
    positions = np.zeros((n_verts, 3), dtype=np.float32)
    normals = np.zeros((n_verts, 3), dtype=np.float32)
    uvs = np.zeros((n_verts, 2), dtype=np.float32)
    tangents = np.zeros((n_verts, 4), dtype=np.float32)

    attr_targets = {"POSITION": positions, "NORMAL": normals,
                    "TEXCOORD_0": uvs, "TANGENT": tangents}
    for name, target in attr_targets.items():
        if name in prim["attributes"]:
            data = _read_accessor(gltf, buffers, prim["attributes"][name]).astype(np.float32)
            n = min(data.shape[1], target.shape[1])
            target[:, :n] = data[:data.shape[0], :n]

    # u16 (or native width) indices widened to u32 (ref: src/Model.cpp:68-77)
    indices = _read_accessor(gltf, buffers, prim["indices"]).reshape(-1).astype(np.uint32)

    return Submesh(positions=positions, normals=normals, uvs=uvs,
                   tangents=tangents, indices=indices,
                   material=prim.get("material", -1))


def _source_or_minus_one(gltf: dict, texture_index: int) -> int:
    # ref: src/Model.cpp:38-46 — texture index → image source, -1 passthrough
    if texture_index < 0:
        return -1
    return gltf["textures"][texture_index].get("source", -1)


def _load_materials(gltf: dict) -> List[Material]:
    # ref: src/Model.cpp:124-136
    materials = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        materials.append(Material(
            base_color=_source_or_minus_one(gltf, pbr.get("baseColorTexture", {}).get("index", -1)),
            metallic_roughness=_source_or_minus_one(gltf, pbr.get("metallicRoughnessTexture", {}).get("index", -1)),
            normal=_source_or_minus_one(gltf, m.get("normalTexture", {}).get("index", -1)),
        ))
    return materials


def _load_images(gltf: dict, base_dir: str, max_texture_dim: int = 0) -> List[Image]:
    """Decode referenced images to RGBA8 (ref: src/Model.cpp:138-151).

    max_texture_dim > 0 downsamples large textures at load (test/CI knob;
    the reference always loads full resolution).
    """
    from PIL import Image as PILImage

    images = []
    for entry in gltf.get("images", []):
        path = os.path.join(base_dir, entry["uri"])
        with PILImage.open(path) as img:
            img = img.convert("RGBA")
            if max_texture_dim and max(img.size) > max_texture_dim:
                scale = max_texture_dim / max(img.size)
                new_size = (max(1, round(img.size[0] * scale)),
                            max(1, round(img.size[1] * scale)))
                img = img.resize(new_size, PILImage.BILINEAR)
            data = np.asarray(img, dtype=np.uint8)
        images.append(Image(width=data.shape[1], height=data.shape[0], data=data))
    return images


def load_model(path: str, load_images: bool = True,
               max_texture_dim: int = 0) -> Model:
    """Load a glTF scene into a Model (ref: Model::Model, src/Model.cpp:154-191).

    Falls back to deterministic synthetic geometry per primitive when the
    .bin geometry buffer is missing from disk.
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r") as f:
        gltf = json.load(f)

    buffers: Dict[int, Optional[bytes]] = {}
    missing_geometry = False
    for i, buf in enumerate(gltf.get("buffers", [])):
        uri = buf.get("uri")
        buf_path = os.path.join(base_dir, uri) if uri else None
        if buf_path and os.path.exists(buf_path):
            with open(buf_path, "rb") as f:
                buffers[i] = f.read()
        else:
            buffers[i] = None
            missing_geometry = True

    prims = gltf["meshes"][0]["primitives"]  # ref flattens meshes[0] only (src/Model.cpp:50)
    if missing_geometry:
        from vkrt_tpu_torch.scene.synth import synthesize_primitives
        log.warning("geometry buffer missing — synthesizing %d primitives "
                    "from accessor metadata", len(prims))
        submeshes = synthesize_primitives(gltf)
    else:
        submeshes = [_load_primitive(gltf, buffers, p) for p in prims]

    materials = _load_materials(gltf)
    images = _load_images(gltf, base_dir, max_texture_dim) if load_images else []

    model = Model(submeshes=submeshes, materials=materials, images=images)
    log.info("loaded %s: %d submeshes, %d materials, %d images, %d tris, %d verts",
             os.path.basename(path), len(submeshes), len(materials), len(images),
             model.num_triangles, model.num_vertices)
    return model
