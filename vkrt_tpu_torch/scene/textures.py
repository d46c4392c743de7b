"""Texture heap: mip-chain generation + flat gather-friendly storage.

Replaces the reference's 69 sampled Vulkan images with full blit-generated
mip chains (ref: src/Raytracer.cpp:460-640) and the bindless
`sampler2D textures[]` array (ref: shaders/shader.rchit:76).

TPU-first design: all images and all mip levels live in ONE flat u8[N,4]
texel heap in HBM, addressed through small (image, level) → offset/width/
height tables. Sampling is then a pure gather: texel(i, l, x, y) =
heap[offset[i,l] + y*width[i,l] + x]. Arbitrary per-image sizes, no padding
waste, single gather source for XLA.

Mip generation matches the reference's successive linear blit:
dims halve (floor, min 1) per level until 1x1
(ref: src/Raytracer.cpp:572-640, vkCmdBlitImage VK_FILTER_LINEAR); for the
even dimensions used here that is an exact 2x2 box average.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from vkrt_tpu_torch.scene.model import Image


def mip_levels_for(width: int, height: int) -> int:
    # ref: src/Raytracer.cpp:481 — floor(log2(max(w,h))) + 1
    return int(np.floor(np.log2(max(width, height)))) + 1


def downsample_box(img: np.ndarray) -> np.ndarray:
    """One mip step: halve both dims (floor, min 1) with a box filter."""
    h, w = img.shape[:2]
    nh, nw = max(1, h // 2), max(1, w // 2)
    x = img[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1].astype(np.float32)
    if h > 1:
        x = (x[0::2] + x[1::2]) * 0.5
    if w > 1:
        x = (x[:, 0::2] + x[:, 1::2]) * 0.5
    return np.clip(x + 0.5, 0, 255).astype(np.uint8)  # round-half-up like GPU blit


def build_mip_chain(img: np.ndarray) -> List[np.ndarray]:
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        levels.append(downsample_box(levels[-1]))
    return levels


@dataclasses.dataclass
class TextureHeap:
    texels: np.ndarray        # u8[N,4] — all images, all mips, row-major
    level_offset: np.ndarray  # i32[I,L] — start index into texels
    level_width: np.ndarray   # i32[I,L]
    level_height: np.ndarray  # i32[I,L]
    num_levels: np.ndarray    # i32[I]

    @property
    def num_images(self) -> int:
        return int(self.level_offset.shape[0])


def material_slots(flat):
    """Deterministic (base, metallic-roughness, normal) image-triple slots.

    The engine samples all three maps of a hit's material in ONE gather
    from the packed material heap; the slot id is the per-triangle
    material key. Derived only from FlatScene arrays so the heap build
    and the attribute build (accel/clusters.scene_attrs) agree without
    plumbing. Returns (triples i32[M,3], tri_slot i32[T])."""
    tri_triples = np.stack([
        np.maximum(np.asarray(flat.tri_base_color), 0),
        np.maximum(np.asarray(flat.tri_metallic_roughness), 0),
        np.maximum(np.asarray(flat.tri_normal), 0)], axis=1)
    triples, tri_slot = np.unique(tri_triples, axis=0, return_inverse=True)
    return triples.astype(np.int32), tri_slot.astype(np.int32)


def bilinear_resize(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """Exact bilinear resize with repeat wrap and texel-center alignment —
    the same reconstruction the sampler evaluates, so sampling the
    resized image reproduces the original's continuous bilinear surface
    up to u8 rounding (used to co-size a material's three maps)."""
    h, w = img.shape[:2]
    if (w, h) == (W, H):
        return img
    x = (np.arange(W, dtype=np.float64) + 0.5) / W * w - 0.5
    y = (np.arange(H, dtype=np.float64) + 0.5) / H * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[None, :, None]
    fy = (y - y0)[:, None, None]
    xi, xj = np.mod(x0, w), np.mod(x0 + 1, w)
    yi, yj = np.mod(y0, h), np.mod(y0 + 1, h)
    f = img.astype(np.float64)
    out = (f[yi][:, xi] * (1 - fx) * (1 - fy) + f[yi][:, xj] * fx * (1 - fy)
           + f[yj][:, xi] * (1 - fx) * fy + f[yj][:, xj] * fx * fy)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class MaterialHeap:
    """Per-material-slot packed triple heap: one 48-byte row per texel =
    the bilinear 2x2 quads of base color, metallic-roughness and normal
    map (wrap pre-applied). One gather fetches the full footprint of all
    three maps — the three per-map gathers were ~2/3 of frame sampling
    cost (measured round 2). Maps of one slot are co-sized to the max of
    the three level-0 dims via `bilinear_resize`; resampling a resized
    map deviates from the original's bilinear reconstruction near the
    original texel grid (kink misalignment) EXCEPT for constant content,
    where it is exact — the only mismatched-size map in Sponza is a
    solid-color 4x4 fallback (material 2), so Sponza parity is exact."""
    texels_tri: np.ndarray    # u8[N,48]
    level_offset: np.ndarray  # i32[M,L]
    level_width: np.ndarray   # i32[M,L]
    level_height: np.ndarray  # i32[M,L]
    num_levels: np.ndarray    # i32[M]


def build_material_heap(images: List[Image], triples: np.ndarray) -> MaterialHeap:
    # Heap rows are keyed by SLOT, not by image: a slot's 48-byte rows
    # interleave all three maps' quads, and `material_slots` already
    # dedups slots via np.unique over (base, mr, normal) id triples — so
    # two slots never carry identical row content and row-level dedup is
    # structurally a no-op. What CAN repeat across slots is one IMAGE
    # resized to the same co-size (e.g. the fallback map appearing in
    # many triples): the chain cache below computes each
    # (image, W, H) resize+mip chain once.
    if not images:
        images = [Image(width=1, height=1,
                        data=np.full((1, 1, 4), 255, dtype=np.uint8))]
    M = triples.shape[0]
    chain_cache: dict = {}

    def chain_for(idx: int, W: int, H: int):
        key = (idx, W, H)
        if key not in chain_cache:
            im = images[idx].data
            per_channel_const = bool(
                (im.reshape(-1, im.shape[-1]) == im.reshape(-1, im.shape[-1])[0]).all())
            if (im.shape[1], im.shape[0]) != (W, H) and not per_channel_const:
                # resampling a resized non-constant map deviates from the
                # original's continuous bilinear surface near the source
                # texel grid; exact only for constant content (Sponza's
                # one mismatched map is a solid fallback). Surface the
                # approximation for other assets instead of shading
                # silently differently (advisor finding, round 2).
                import warnings
                warnings.warn(
                    f"material heap: co-sizing non-constant map (image "
                    f"{idx}, {im.shape[1]}x{im.shape[0]} -> {W}x{H}); "
                    f"bilinear reconstruction is approximate for this map")
            chain_cache[key] = build_mip_chain(bilinear_resize(im, W, H))
        return chain_cache[key]

    slot_chains = []
    for m in range(M):
        ids = [min(max(int(t), 0), len(images) - 1) for t in triples[m]]
        W = max(images[i].data.shape[1] for i in ids)
        H = max(images[i].data.shape[0] for i in ids)
        slot_chains.append([chain_for(i, W, H) for i in ids])

    max_levels = max(len(c[0]) for c in slot_chains)
    level_offset = np.zeros((M, max_levels), dtype=np.int32)
    level_width = np.ones((M, max_levels), dtype=np.int32)
    level_height = np.ones((M, max_levels), dtype=np.int32)
    num_levels = np.zeros(M, dtype=np.int32)

    pattern_cache = {}

    def quad_pattern(w, h):
        if (w, h) not in pattern_cache:
            yy, xx = np.divmod(np.arange(w * h, dtype=np.int64), w)
            x1 = np.where(xx + 1 == w, 0, xx + 1)
            y1 = np.where(yy + 1 == h, 0, yy + 1)
            pattern_cache[(w, h)] = np.stack(
                [yy * w + xx, yy * w + x1, y1 * w + xx, y1 * w + x1], axis=1)
        return pattern_cache[(w, h)]

    parts = []
    offset = 0
    for m, chains in enumerate(slot_chains):
        L = len(chains[0])
        num_levels[m] = L
        for l in range(L):
            h, w = chains[0][l].shape[:2]
            level_offset[m, l] = offset
            level_width[m, l] = w
            level_height[m, l] = h
            pat = quad_pattern(w, h)
            row = np.concatenate(
                [c[l].reshape(-1, 4)[pat].reshape(-1, 16) for c in chains],
                axis=1)                                    # [w*h, 48]
            parts.append(row)
            offset += h * w
        for l in range(L, max_levels):
            level_offset[m, l] = level_offset[m, L - 1]
            level_width[m, l] = level_width[m, L - 1]
            level_height[m, l] = level_height[m, L - 1]

    return MaterialHeap(
        texels_tri=np.concatenate(parts, axis=0),
        level_offset=level_offset,
        level_width=level_width,
        level_height=level_height,
        num_levels=num_levels,
    )


def build_texture_heap(images: List[Image]) -> TextureHeap:
    if not images:
        # 1-texel white fallback so gathers are always valid
        images = [Image(width=1, height=1,
                        data=np.full((1, 1, 4), 255, dtype=np.uint8))]

    chains = [build_mip_chain(im.data) for im in images]
    max_levels = max(len(c) for c in chains)
    n_img = len(chains)

    level_offset = np.zeros((n_img, max_levels), dtype=np.int32)
    level_width = np.ones((n_img, max_levels), dtype=np.int32)
    level_height = np.ones((n_img, max_levels), dtype=np.int32)
    num_levels = np.zeros(n_img, dtype=np.int32)

    parts = []
    offset = 0
    for i, chain in enumerate(chains):
        num_levels[i] = len(chain)
        for l, lvl in enumerate(chain):
            h, w = lvl.shape[:2]
            level_offset[i, l] = offset
            level_width[i, l] = w
            level_height[i, l] = h
            parts.append(lvl.reshape(-1, 4))
            offset += h * w
        # clamp absent trailing levels to the last real one (sampler
        # maxLod=VK_LOD_CLAMP_NONE clamps to the image's top mip)
        for l in range(len(chain), max_levels):
            level_offset[i, l] = level_offset[i, len(chain) - 1]
            level_width[i, l] = level_width[i, len(chain) - 1]
            level_height[i, l] = level_height[i, len(chain) - 1]

    return TextureHeap(
        texels=np.concatenate(parts, axis=0),
        level_offset=level_offset,
        level_width=level_width,
        level_height=level_height,
        num_levels=num_levels,
    )
