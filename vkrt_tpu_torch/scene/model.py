"""CPU-side scene model — the preserved Model API.

Behavioral port of the reference's Model (ref: src/Model.hpp:8-54): a list of
submeshes (vertices + u32 indices + material id), a material table of three
image indices, and decoded RGBA8 images. Per BASELINE.json the "tinygltf
Model/Camera scene API is preserved"; storage here is SoA numpy instead of
vec4-padded AoS (the reference pads every attribute to vec4 purely for GPU
alignment, ref: src/Model.hpp:11-18 "todo: better alignment").
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Submesh:
    """ref: src/Model.hpp:37-42 (SoA instead of vector<Vertex>)."""

    positions: np.ndarray   # f32[N,3]
    normals: np.ndarray     # f32[N,3]
    uvs: np.ndarray         # f32[N,2]
    tangents: np.ndarray    # f32[N,4]
    indices: np.ndarray     # u32[K] — local, per-submesh (rebased at flatten)
    material: int = -1

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0]) // 3


@dataclasses.dataclass
class Material:
    """Three image indices, -1 when absent (ref: src/Model.hpp:20-25)."""

    base_color: int = -1
    metallic_roughness: int = -1
    normal: int = -1


@dataclasses.dataclass
class Image:
    """Decoded RGBA8 image (ref: src/Model.hpp:27-33)."""

    width: int
    height: int
    data: np.ndarray  # u8[H,W,4]


@dataclasses.dataclass
class Model:
    """ref: src/Model.hpp:8-54 public surface."""

    submeshes: List[Submesh]
    materials: List[Material]
    images: List[Image]

    @property
    def num_triangles(self) -> int:
        return sum(s.num_triangles for s in self.submeshes)

    @property
    def num_vertices(self) -> int:
        return sum(s.num_vertices for s in self.submeshes)

    # Byte-size parity accessors (ref: src/Model.cpp:184-188; the reference
    # counts vec4-padded 64-byte vertices and u32 indices).
    @property
    def vertex_buffer_size_in_bytes(self) -> int:
        return self.num_vertices * 64

    @property
    def index_buffer_size_in_bytes(self) -> int:
        return sum(int(s.indices.shape[0]) for s in self.submeshes) * 4
