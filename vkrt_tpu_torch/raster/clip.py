"""The raster setup's clip of triangles that cross w = 0: kernel J's
wrapper and its plain version.

  * `clip_boxes`: on a CUDA tensor it launches the hand-written kernel in
    csrc/raster_clip.cu; on a CPU tensor it runs `clip_boxes_plain`, the
    plain PyTorch version of the same function. The kernel replaces no
    Pallas kernel: the JAX package gives such a triangle's cluster a
    full-screen box.

What it computes, per triangle slot of the setup (csrc/raster_clip.cu
says why it is conservative): the box and least depth of the samples of
the screen [0, width] x [0, height] that kernel G can keep from the
triangle, as the screen rectangle clipped by its three edge rows and its
depth range [0, 1], each half-plane widened by a bound on G's float32
error; Sutherland-Hodgman in float64, every operation rounded on its own
in the kernel's order, so the two versions agree bit for bit.
raster/edge.py's build_raster_setup calls it for the triangles with a
corner at w <= 1e-9 and another in front.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels

ERR_ULPS = 2.0 ** -20   # G's float32 error bound per unit of |row| terms
ZPAD = 2.0 ** -22       # zmin's relative pad, as the setup's other triangles
EMPTY = 1.0e8           # the empty box: lo EMPTY, hi -EMPTY, zmin EMPTY
MAX_VERTS = 16          # the clipped polygon's vertices (4 + 1 a plane)


def _round(x: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 x to float32, rounded down (or up) instead of to nearest:
    the kernel's __double2float_rd / _ru."""
    f = x.to(torch.float32)
    fd = f.double()
    if down:
        return torch.where(fd > x, torch.nextafter(
            f, torch.full_like(f, -torch.inf)), f)
    return torch.where(fd < x, torch.nextafter(
        f, torch.full_like(f, torch.inf)), f)


def _lin(a, b, c, x, y):
    return (a * x + b * y) + c


def _clip_rows(rows: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The clip of M triangles' setup rows f32[M, 20] → f32[5, M]."""
    m = rows.shape[0]
    dev = rows.device
    r = rows[:, :12].double()
    a, b, c = r[:, 0:9:3].T, r[:, 1:9:3].T, r[:, 2:9:3].T     # [3, M] each
    zc = r[:, 9:12].T
    w, h = float(width), float(height)
    t = (a.abs() * w + b.abs() * h) + c.abs()
    az = (a[0] * zc[0] + a[1] * zc[1]) + a[2] * zc[2]
    bz = (b[0] * zc[0] + b[1] * zc[1]) + b[2] * zc[2]
    cz = (c[0] * zc[0] + c[1] * zc[1]) + c[2] * zc[2]
    ez = ((zc[0].abs() * t[0] + zc[1].abs() * t[1])
          + zc[2].abs() * t[2]) * ERR_ULPS
    planes = [(a[k], b[k], c[k] + t[k] * ERR_ULPS) for k in range(3)]
    planes += [(az, bz, cz + ez), (-az, -bz, (1.0 + ez) - cz)]

    x = torch.zeros((m, MAX_VERTS), dtype=torch.float64, device=dev)
    y = torch.zeros_like(x)
    x[:, 1:3] = w
    y[:, 2:4] = h
    n = torch.full((m,), 4, dtype=torch.int64, device=dev)
    slot = torch.arange(MAX_VERTS, device=dev)
    rows_i = torch.arange(m, device=dev)[:, None]
    for pa, pb, pc in planes:
        d = _lin(pa[:, None], pb[:, None], pc[:, None], x, y)
        j = torch.where(slot[None] + 1 < n[:, None], slot[None] + 1, 0)
        xj, yj, dj = x.gather(1, j), y.gather(1, j), d.gather(1, j)
        live = slot[None] < n[:, None]
        inside = d >= 0.0
        keep = live & inside
        cut = live & (inside != (dj >= 0.0))
        s = d / (d - dj)
        ix = x + s * (xj - x)
        iy = y + s * (yj - y)
        # emissions in the kernel's order: vertex k, then the crossing
        # of edge (k, k + 1)
        flags = torch.stack([keep, cut], dim=2).reshape(m, 2 * MAX_VERTS)
        vx = torch.stack([x, ix], dim=2).reshape(m, 2 * MAX_VERTS)
        vy = torch.stack([y, iy], dim=2).reshape(m, 2 * MAX_VERTS)
        q = flags.sum(dim=1)
        go = (n > 0) & (q <= MAX_VERTS)   # else keep the polygon as it is
        pos = torch.where(flags, flags.cumsum(dim=1) - 1, 2 * MAX_VERTS)
        nx = torch.zeros((m, 2 * MAX_VERTS + 1), dtype=torch.float64,
                         device=dev)
        ny = torch.zeros_like(nx)
        nx[rows_i, pos] = vx
        ny[rows_i, pos] = vy
        x = torch.where(go[:, None], nx[:, :MAX_VERTS], x)
        y = torch.where(go[:, None], ny[:, :MAX_VERTS], y)
        # a polygon that passed MAX_VERTS is done: no later plane clips it
        n = torch.where(go, q, torch.where(n > 0, -n, n))
    n = n.abs()
    live = slot[None] < n[:, None]
    z = _lin(az[:, None], bz[:, None], cz[:, None], x, y)
    inf = torch.tensor(torch.inf, dtype=torch.float64, device=dev)
    xl = torch.where(live, x, inf).amin(dim=1)
    yl = torch.where(live, y, inf).amin(dim=1)
    xh = torch.where(live, x, -inf).amax(dim=1)
    yh = torch.where(live, y, -inf).amax(dim=1)
    zm = torch.where(live, z, inf).amin(dim=1)
    zp = (zm - zm.abs() * ZPAD) - ez
    zp = torch.where(zp > 0.0, zp, 0.0)
    out = torch.stack([_round(xl, True), _round(yl, True),
                       _round(xh, False), _round(yh, False),
                       _round(zp, True)])
    empty = torch.tensor([EMPTY, EMPTY, -EMPTY, -EMPTY, EMPTY],
                         dtype=torch.float32, device=dev)[:, None]
    return torch.where((n > 0)[None], out, empty)


def clip_boxes_plain(setup, crossing, width: int, height: int):
    """Plain PyTorch version of kernel J (same inputs and outputs as
    `clip_boxes`): the clip of the `crossing` slots alone, gathered (a
    host wait), the empty box elsewhere."""
    n = crossing.numel()
    out = torch.empty((5, n), dtype=torch.float32, device=setup.device)
    out[:2] = EMPTY
    out[2:4] = -EMPTY
    out[4] = EMPTY
    idx = torch.nonzero(crossing.reshape(-1), as_tuple=True)[0]
    if idx.numel():
        out[:, idx] = _clip_rows(setup.reshape(n, -1)[idx], width, height)
    return out.reshape(5, *crossing.shape)


def clip_boxes(setup, crossing, width: int, height: int):
    """Clip the triangle slots that `crossing` marks (bool [C1p, 128]) of
    the raster setup f32[C1p, 128, 20] to the screen and to the depth
    range kernel G keeps (module docstring). Returns f32[5, C1p, 128]:
    per slot the lo x, lo y, hi x, hi y and zmin of the fragments G can
    keep from it, in pixels and NDC depth; the empty box (lo 1e8, hi -1e8,
    zmin 1e8) where `crossing` is False or nothing is left. A CUDA tensor
    launches kernel J (no host wait) and counts it in
    `clip_boxes.launches`; a CPU tensor runs `clip_boxes_plain`."""
    dev = setup.device
    if dev.type == "cpu":
        return clip_boxes_plain(setup, crossing, width, height)
    if dev.type != "cuda":
        raise ValueError(f"clip_boxes: unsupported device {dev}")
    if (setup.dtype != torch.float32 or setup.ndim != 3
            or setup.shape[2] != 20 or crossing.shape != setup.shape[:2]
            or crossing.dtype != torch.bool or crossing.device != dev):
        raise ValueError(f"clip_boxes: setup {tuple(setup.shape)} "
                         f"{setup.dtype}, crossing {tuple(crossing.shape)} "
                         f"{crossing.dtype}: want f32[C1p, 128, 20] and "
                         f"bool[C1p, 128] on one device")
    setup = setup.contiguous()
    crossing = crossing.contiguous()
    n = crossing.numel()
    out = torch.empty((5, *crossing.shape), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_raster_clip(setup.data_ptr(), crossing.data_ptr(), n,
                                   float(width), float(height),
                                   out.data_ptr(), stream)
    kernels.check(err, "raster_clip")
    clip_boxes.launches += 1
    return out


clip_boxes.launches = 0
