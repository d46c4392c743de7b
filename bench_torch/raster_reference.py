"""The plain reference of the raster cell: vkrt's Rasterizer frame.

Plain PyTorch in float32 with TF32 off, independent of the program: it
imports nothing of it and takes nothing it made. It reuses reference.py's
scene data (`geometry`, `textures`), its tree (`build_tree`), its ray walk
(`trace`) and its texture sampler (`sample`), and renders the frame of
vkrt's second renderer (src/Rasterizer.{hpp,cpp}, shaders/shader.frag):

  samples           8x MSAA at the standard positions (MSAA8 below, a
                    copy; Rasterizer.cpp:17, VK_SAMPLE_COUNT_8_BIT)
  fragment shader   unlit level-0 baseColor, fragments with alpha below
                    0.1 discarded (shader.frag:13-22)
  clear colour      (0, 0, 0.2) where no fragment is kept (:119)
  resolve           the 8 samples averaged in order, then UNORM8:
                    clamp(c * 255 + 0.5) truncated (:266-338)

Per sample, a ray through the sample point finds the nearest fragment;
a discarded fragment lets the sample go on to the nearest fragment
behind it, for at most ROUNDS visibility queries in all.

`render(...)` returns (u8[H,W,3], visibility queries: the rays cast over
every sample and round, and per pixel the largest number of queries one
of its samples made, u8[H,W]). The matrix products (ray generation, uv
interpolation) go through reference._mm, so `tf32=True` rounds their
inputs to TF32: the control.

Departures from vkrt (the port's raster contract has each as well):

  * coverage and depth test: the ray cast through the sample point
    stands for the edge-function test and the depth test; both keep the
    nearest surface that covers the sample, on either winding (vkrt
    culls nothing);
  * depth range: fragments are kept where 0 <= z_ndc <= 1, as Vulkan
    clips, for the projection the pose gives; with glm's GL-style
    perspective that is view depths from 2 f n / (f + n) (0.1998 at
    near 0.1, far 100) to f;
  * a discarded fragment: the next query starts at it and keeps only
    fragments more than reference.TMIN (0.001) farther along the ray,
    where the hardware keeps any fragment strictly deeper;
  * textures: bilinear at level 0 with repeat wrap (vkrt's sampler picks
    a mip level from screen-space derivatives);
  * no FPS overlay (vkrt draws it with ImGui after the resolve).
"""

from __future__ import annotations

import numpy as np
import torch

import reference as R

MSAA8 = np.array([
    [0.5625, 0.3125], [0.4375, 0.6875], [0.8125, 0.5625], [0.3125, 0.1875],
    [0.1875, 0.8125], [0.0625, 0.4375], [0.6875, 0.9375], [0.9375, 0.0625],
], dtype=np.float32)
CLEAR = (0.0, 0.0, 0.2)
ALPHA_DISCARD = 0.1
ROUNDS = 4


def depth_range(proj_inverse):
    """(near, far) view depths that the projection maps to z_ndc 0 and 1:
    a view point (0, 0, -s) has clip z = -p22 s + p23 and w = -p32 s +
    p33 (p = the projection, from its inverse in float64)."""
    p = np.linalg.inv(np.asarray(proj_inverse, np.float64))
    near = p[2, 3] / p[2, 2]
    far = (p[3, 3] - p[2, 3]) / (p[3, 2] - p[2, 2])
    return float(near), float(far)


def sample_rays(width, height, proj_inverse, view_inverse, off, device,
                tf32=False):
    """Rays through the sample point (x + off[0], y + off[1]) of every
    pixel, row-major: o, d f32[H*W,3] and each direction's cosine to the
    view axis f32[H*W]."""
    pi = torch.as_tensor(np.asarray(proj_inverse, np.float32), device=device)
    vi = torch.as_tensor(np.asarray(view_inverse, np.float32), device=device)
    xs = (torch.arange(width, device=device, dtype=torch.float32)
          + float(off[0])) / width * 2.0 - 1.0
    ys = (torch.arange(height, device=device, dtype=torch.float32)
          + float(off[1])) / height * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    one = torch.ones_like(gx)
    ndc = torch.stack([gx, gy, one, one], dim=-1).reshape(-1, 4)
    dv = R._normalize(R._mm(ndc, pi.T.contiguous(), tf32)[:, :3])
    d = R._mm(torch.cat([dv, torch.zeros_like(dv[:, :1])], dim=1),
              vi.T.contiguous(), tf32)[:, :3]
    o = vi[:3, 3].expand(d.shape).contiguous()
    return o, d, -dv[:, 2]


def render(geo: R.Geometry, tex: R.Textures, tree: R.Tree, cfg: dict, pose,
           msaa: int = 8, tf32=False):
    """One frame of `cfg` (the configuration's "render" fields) at `msaa`
    (8, vkrt's) samples a pixel, seen from `pose` (proj_inverse,
    view_inverse): (u8[H,W,3], visibility queries, most queries of a
    sample per pixel u8[H,W])."""
    if msaa != 8:
        raise ValueError(f"vkrt's Rasterizer takes 8 samples, not {msaa}")
    torch.backends.cuda.matmul.allow_tf32 = False
    H, W, dev = cfg["height"], cfg["width"], geo.p.device
    near, far = depth_range(pose.proj_inverse)
    clear = torch.tensor(CLEAR, device=dev)
    n = H * W
    acc = None
    queries = 0
    layers = torch.zeros(n, dtype=torch.uint8, device=dev)
    for off in MSAA8:
        o, d, cos = sample_rays(W, H, pose.proj_inverse, pose.view_inverse,
                                off, dev, tf32)
        t_far = far / cos
        color = clear.expand(n, 3).clone()
        made = torch.zeros(n, dtype=torch.uint8, device=dev)
        idx = torch.arange(n, device=dev)
        # each live ray starts at its last discarded fragment (at first,
        # just before the near plane): trace keeps hits beyond R.TMIN
        start = near / cos - R.TMIN
        for _ in range(ROUNDS):
            if idx.numel() == 0:
                break
            queries += idx.numel()
            made[idx] += 1
            t, tri, u, v = R.trace(tree, o[idx] + d[idx] * start[:, None],
                                   d[idx], t_far[idx] - start)
            hit = tri >= 0
            th = tri[hit]
            bary = torch.stack([1.0 - u[hit] - v[hit], u[hit], v[hit]],
                               dim=1)[:, None, :]
            uv = R._mm(bary, geo.uv[th], tf32)[:, 0]
            base = R.sample(tex, geo.img[th, 0], uv)
            opaque = base[:, 3] >= ALPHA_DISCARD
            hid = idx[hit]
            color[hid[opaque]] = base[opaque, :3]
            start = (start[hit] + t[hit])[~opaque]
            idx = hid[~opaque]
        layers = torch.maximum(layers, made)
        img = color.reshape(H, W, 3)
        acc = img if acc is None else acc + img
    fb = acc / float(len(MSAA8))
    return (torch.clamp(fb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8),
            queries, layers.reshape(H, W))
