"""Edge-function rasterizer — counterpart of vkrt_tpu/raster/edge.py.

Two stages, as in the JAX package:

  * `build_raster_setup`: the vertex + triangle-setup stage, plain
    PyTorch on the cluster tree's `tri_data`, once per camera pose. Each
    triangle's corners go to clip space; the adjugate of the clip-space
    matrix M = [[X0,X1,X2],[Y0,Y1,Y2],[w0,w1,w2]] (X = (0.5 x_c +
    0.5 w) * width, Y likewise) divided by det(M) gives per-corner rows
    beta_i = a_i px + b_i py + c_i with sum_i beta_i w_i = 1: coverage is
    beta_i >= 0 (both windings), depth z = sum_i beta_i Z_i needs no
    per-pixel division, and uv = sum(beta_i uv_i) / sum(beta_i) is
    perspective-correct. Triangles crossing w = 0 rasterize their visible
    sheet without a clipper; their clusters get full-screen boxes.
  * `raster_edge`: kernel G's wrapper. On a CUDA tensor it launches the
    hand-written kernel in csrc/raster_edge.cu (which replaces the Pallas
    kernel `_raster_kernel`, vkrt_tpu/raster/edge.py:204) or raises; on a
    CPU tensor it runs `raster_edge_plain`, the plain PyTorch version of
    the same function.

Setup layout (the port's own, compact): f32[C1p, 128, 20], triangle k of
cluster id at [id, k], columns as the JAX package's setup slab, whose
other 108 columns are zero:
  0-8   a0,b0,c0, a1,b1,c1, a2,b2,c2  (already divided by det)
  9-11  Z0,Z1,Z2 (clip z; sum beta_i Z_i is NDC depth)
  12-17 u0,v0,u1,v1,u2,v2
  18    material slot id
  19    0 (pad: 80-byte rows, so the kernel reads a row as 5 float4)
Degenerate, culled and padding triangles have all-zero rows: beta =
(0,0,0) fails the strict sum(beta) > 0 clause.

Which fragment wins: a fragment counts where beta_0,1,2 >= 0,
sum(beta) > 0, 0 <= z <= 1 and z > zfloor (strict); the nearest z wins
and ties go to the lowest slot (cluster id * 128 + triangle).
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import kernels
from vkrt_tpu_torch.accel.clusters import K1, K2, ClusterTree
from vkrt_tpu_torch.utils import layout as L

N_SETUP = 19          # setup columns the rasterizer reads
SETUP_W = 20          # stored columns per triangle (19 + 1 pad)
ZFAR_PARK = 1.0e9     # zfloor >= this parks a pixel
BOX_PAD = 1.0 / 64.0  # pixels: screen-box slack of the per-pixel gate
_W_EPS = 1e-9
_BIG = 1.0e8          # full-screen and empty box bounds
LANES = L.LANES
DEPTH_ULPS = 2.0 ** -20  # 16 float32 ulps: zmin's pad per unit of error
PIX_CHUNK = 8192      # plain version: pixels gated at a time
PAIR_CHUNK = 16384    # plain version: (pixel, cluster) pairs at a time
                      # (~15 KB each: the cluster's rows and temporaries)


def _wvp(view, proj):
    """proj @ view as elementwise products and a left-to-right sum (no
    matmul: a reduced-precision product flipped 75% of the JAX package's
    raster pixels on the TPU)."""
    p = proj[:, :, None] * view[None, :, :]                  # [4,4,4]
    return ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]


def build_raster_setup(tree: ClusterTree, view, proj, width: int,
                       height: int):
    """Vertex + triangle-setup stage (edge.py:67-201 of the JAX package),
    computed in float64 and stored in float32.

    The JAX package computes it in float32. Its cofactors and det cancel
    by about (screen position / triangle size)^2, so for the small far
    triangles of a full scene at 1600x1200 the folded 1/det, and
    sum(beta_i * Z_i) with it, can be off by percents, enough to put a
    farther surface in front (PERF.md, section 6). Rounded from float64, the
    rows leave only the kernel's own float32 evaluation error. Same
    columns, same rule for the boxes, no matmul.

    view, proj: the camera's forward [4,4] matrices on the tree's
    device. Returns (setup f32[C1p,128,20], scb f32[8,C2p], clb
    f32[n_sc,8,64]): the setup rows (module docstring) and the screen
    boxes of superclusters and clusters in the trace kernels' box layout,
    rows 0-2 lo (x, y, zmin), 3-5 hi, 6-7 zero. zmin sits below the
    corners' least z/w by a bound on the float32 depth error of kernel G
    (so no fragment it computes lies below it); the JAX package's is the
    least z/w. Empty clusters get inverted boxes (lo +1e8, hi -1e8); a
    cluster holding any triangle with a corner at w <= 1e-9 gets a
    full-screen box with zmin 0."""
    td = tree.tri_data                                       # [C1p,K1,128]
    geo = td[..., 0:9].double()
    wvp = _wvp(view.double(), proj.double())
    v0 = geo[..., 0:3]
    corners = [v0, v0 + geo[..., 3:6], v0 + geo[..., 6:9]]
    valid = (v0.abs().sum(-1) + geo[..., 3:6].abs().sum(-1)) > 0

    X, Y, W, Z = [], [], [], []
    for pt in corners:
        clip = L.mat_rows3(pt, wvp[:, :3]) + wvp[:, 3]
        X.append((0.5 * clip[..., 0] + 0.5 * clip[..., 3]) * width)
        Y.append((0.5 * clip[..., 1] + 0.5 * clip[..., 3]) * height)
        Z.append(clip[..., 2])
        W.append(clip[..., 3])

    a0 = Y[1] * W[2] - Y[2] * W[1]
    b0 = X[2] * W[1] - X[1] * W[2]
    c0 = X[1] * Y[2] - X[2] * Y[1]
    a1 = Y[2] * W[0] - Y[0] * W[2]
    b1 = X[0] * W[2] - X[2] * W[0]
    c1 = X[2] * Y[0] - X[0] * Y[2]
    a2 = Y[0] * W[1] - Y[1] * W[0]
    b2 = X[1] * W[0] - X[0] * W[1]
    c2 = X[0] * Y[1] - X[1] * Y[0]
    det = X[0] * a0 + X[1] * a1 + X[2] * a2
    # relative degeneracy cull, scaled by the cofactors' term magnitudes
    # (not by the cancelled cofactors, which a collapsed triangle leaves
    # as rounding residue): 2e-6 culls only sub-sub-pixel slivers
    det_scale = (
        X[0].abs() * ((Y[1] * W[2]).abs() + (Y[2] * W[1]).abs())
        + X[1].abs() * ((Y[2] * W[0]).abs() + (Y[0] * W[2]).abs())
        + X[2].abs() * ((Y[0] * W[1]).abs() + (Y[1] * W[0]).abs()))
    keep = (det.abs() > 2e-6 * det_scale) & (det_scale > 0) & valid
    inv = torch.where(keep, 1.0 / det, 0.0)

    cols = [a0 * inv, b0 * inv, c0 * inv,
            a1 * inv, b1 * inv, c1 * inv,
            a2 * inv, b2 * inv, c2 * inv,
            Z[0], Z[1], Z[2]]
    setup = torch.cat([torch.stack(cols, dim=-1).to(torch.float32),
                       td[..., 18:24], td[..., 33:34],
                       torch.zeros_like(td[..., :1])], dim=-1)
    setup = torch.where((valid & (inv != 0))[..., None], setup, 0.0)

    # screen boxes: a triangle is boundable iff all three corners have
    # w > 1e-9; otherwise its cluster gets a full-screen box
    bounded = valid
    for w in W:
        bounded = bounded & (w > _W_EPS)
    unbounded = valid & ~bounded

    def extent(vals, lo: bool):
        m = None
        for v in vals:
            v = torch.where(bounded, v, _BIG if lo else -_BIG)
            m = v if m is None else (torch.minimum(m, v) if lo
                                     else torch.maximum(m, v))
        return m.amin(dim=1) if lo else m.amax(dim=1)        # [C1p]

    ws = [torch.clamp(w, min=_W_EPS) for w in W]
    sx = [X[i] / ws[i] for i in range(3)]
    sy = [Y[i] / ws[i] for i in range(3)]
    sz = [Z[i] / ws[i] for i in range(3)]
    any_unb = unbounded.any(dim=1)
    empty = ~valid.any(dim=1)
    lo_x = torch.where(any_unb, -_BIG, extent(sx, True))
    lo_y = torch.where(any_unb, -_BIG, extent(sy, True))
    hi_x = torch.where(any_unb, _BIG, extent(sx, False))
    hi_y = torch.where(any_unb, _BIG, extent(sy, False))
    hi_z = torch.where(any_unb, _BIG, extent(sz, False))

    # zmin must bound every depth kernel G computes in the cluster, or its
    # zmin >= committed-depth skip could drop a nearer fragment. At a
    # pixel of the padded box the float32 rows and products put beta_i off
    # by a few ulps of T_i = |a_i x| + |b_i y| + |c_i|, so z is off by
    # ulps of sum_i |Z_i| T_i, and a sample the rounded edge functions
    # admit may lie as far outside the triangle (the |W_i| term).
    xm = (torch.maximum(lo_x.abs(), hi_x.abs()) + BOX_PAD)[:, None]
    ym = (torch.maximum(lo_y.abs(), hi_y.abs()) + BOX_PAD)[:, None]
    err = 0.0
    for i in range(3):
        t = ((cols[3 * i].abs() * xm + cols[3 * i + 1].abs() * ym)
             + cols[3 * i + 2].abs())
        err = err + (Z[i].abs() + W[i].abs()) * t
    err = torch.where(bounded & keep, err, 0.0).amax(dim=1) * DEPTH_ULPS
    zmin = extent(sz, True)
    lo_z = torch.where(any_unb, 0.0, torch.clamp(
        zmin - zmin.abs() * 2.0 ** -22 - err, min=0.0))
    lo = [torch.where(empty, _BIG, v) for v in (lo_x, lo_y, lo_z)]
    hi = [torch.where(empty, -_BIG, v) for v in (hi_x, hi_y, hi_z)]

    n_sc = tree.num_superclusters
    c2p = tree.sc_boxes.shape[1]
    lo = [v.reshape(n_sc, K2) for v in lo]
    hi = [v.reshape(n_sc, K2) for v in hi]
    zero = torch.zeros((n_sc, K2), dtype=td.dtype, device=td.device)
    clb = torch.stack(lo + hi + [zero, zero], dim=1).to(torch.float32)

    def pad(v, value):
        return torch.nn.functional.pad(v, (0, c2p - n_sc), value=value)

    zrow = torch.zeros(c2p, dtype=td.dtype, device=td.device)
    scb = torch.stack([pad(v.amin(dim=1), _BIG) for v in lo]
                      + [pad(v.amax(dim=1), -_BIG) for v in hi]
                      + [zrow, zrow]).to(torch.float32)      # [8,C2p]
    return setup.contiguous(), scb.contiguous(), clb.contiguous()


def _check(setup, scb, clb, px, py, zfloor) -> None:
    dev = px.device
    nb = px.shape[0]
    n_sc = clb.shape[0]
    if (setup.ndim != 3 or setup.shape[1:] != (K1, SETUP_W)
            or setup.shape[0] != n_sc * K2 or clb.shape[1:] != (8, K2)
            or scb.ndim != 2 or scb.shape[0] != 8 or scb.shape[1] < n_sc):
        raise ValueError(f"raster_edge: setup {tuple(setup.shape)}, scb "
                         f"{tuple(scb.shape)}, clb {tuple(clb.shape)} do not "
                         f"form one scene")
    for name, x in (("px", px), ("py", py), ("zfloor", zfloor)):
        if x.shape != (nb, LANES):
            raise ValueError(f"raster_edge: {name} {tuple(x.shape)}, want "
                             f"({nb}, {LANES})")
    for name, x in (("setup", setup), ("scb", scb), ("clb", clb),
                    ("px", px), ("py", py), ("zfloor", zfloor)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"raster_edge: {name} must be f32 on {dev}")


def box_gate(lo_x, lo_y, hi_x, hi_y, x, y):
    """Pixels (x, y [R]) inside boxes ([B]) widened by BOX_PAD → [R,B]:
    the kernel's `in_box`. Coverage is evaluated in homogeneous
    coordinates but the boxes come from a division, so a covered pixel on
    a box edge could fall outside by an ulp without the pad."""
    x, y = x[:, None], y[:, None]
    return (((lo_x - BOX_PAD)[None] <= x) & (x <= (hi_x + BOX_PAD)[None])
            & ((lo_y - BOX_PAD)[None] <= y) & (y <= (hi_y + BOX_PAD)[None]))


def _barycentrics(col, x, y):
    """beta_0, beta_1, beta_2 at pixels x, y, where col(j) is setup column
    j (broadcast against x, y), in the kernel's operation order."""
    return [(col(3 * i) * x + col(3 * i + 1) * y) + col(3 * i + 2)
            for i in range(3)]


def _commit_attrs(rows, x, y):
    """(u, v, mat) of the winning setup rows [W, 20] at pixels x, y [W],
    the kernel's final step."""
    b = _barycentrics(lambda j: rows[:, j], x, y)
    sumb = (b[0] + b[1]) + b[2]
    uw = (b[0] * rows[:, 12] + b[1] * rows[:, 14]) + b[2] * rows[:, 16]
    vw = (b[0] * rows[:, 13] + b[1] * rows[:, 15]) + b[2] * rows[:, 17]
    return uw / sumb, vw / sumb, rows[:, 18].to(torch.int32)


def _cluster_fragments(cols, c, x, y, zf):
    """The nearest covered fragment of each (pixel, cluster) pair: cols
    [C1p, 20, K1] (the setup with columns outermost), cluster ids c [P],
    pixels x, y, zfloor [P]. Returns (z [P], inf where nothing covers;
    triangle index [P], K1 there), lowest index among equal z."""
    rows = cols[c]                                       # [P, 20, K1]
    b = _barycentrics(lambda j: rows[:, j], x[:, None], y[:, None])
    sumb = (b[0] + b[1]) + b[2]
    zz = (b[0] * rows[:, 9] + b[1] * rows[:, 10]) + b[2] * rows[:, 11]
    cover = ((b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0) & (sumb > 0)
             & (zz >= 0.0) & (zz <= 1.0) & (zz > zf[:, None]))
    zz = torch.where(cover, zz, torch.inf)
    zmin = zz.min(dim=1).values
    kidx = torch.arange(K1, device=c.device)
    ksel = torch.where(cover & (zz == zmin[:, None]), kidx,
                       K1).min(dim=1).values
    return zmin, ksel


def raster_edge_plain(setup, scb, clb, px, py, zfloor):
    """Plain PyTorch version of kernel G (same inputs and outputs as
    `raster_edge`): the nearest covered fragment of the clusters whose
    padded screen box holds the pixel, ties to the lowest slot.

    Gates (pixel, cluster) pairs by the padded screen box, PIX_CHUNK
    pixels at a time, and finds each pair's nearest covered fragment, in
    chunks of PAIR_CHUNK pairs, so memory stays bounded at any pixel
    count; then takes each pixel's minimum over its pairs. The kernel's
    zmin skip needs no counterpart: zmin bounds every fragment's depth
    from below (build_raster_setup), so a skipped cluster holds no
    nearer fragment, nor an equal one with a lower slot."""
    _check(setup, scb, clb, px, py, zfloor)
    nb = px.shape[0]
    n = nb * LANES
    dev = px.device
    x, y, zf = px.reshape(n), py.reshape(n), zfloor.reshape(n)
    n_cl = clb.shape[0] * K2
    box = clb.permute(1, 0, 2).reshape(8, n_cl)    # [8, n_cl], id order
    lo_x, lo_y, lo_z, hi_x, hi_y = box[0], box[1], box[2], box[3], box[4]
    cols = setup.transpose(1, 2).contiguous()      # [C1p, 20, K1]
    pix, slots, zs = [], [], []
    for r0 in range(0, n, PIX_CHUNK):
        r1 = min(r0 + PIX_CHUNK, n)
        live = zf[r0:r1] < ZFAR_PARK
        if not bool(live.any()):
            continue
        gate = (box_gate(lo_x, lo_y, hi_x, hi_y, x[r0:r1], y[r0:r1])
                & (lo_z < ZFAR_PARK)[None] & live[:, None])
        p_all, c_all = torch.nonzero(gate, as_tuple=True)
        for q0 in range(0, p_all.shape[0], PAIR_CHUNK):
            p = p_all[q0:q0 + PAIR_CHUNK] + r0
            c = c_all[q0:q0 + PAIR_CHUNK]
            zmin, ksel = _cluster_fragments(cols, c, x[p], y[p], zf[p])
            hit = ksel < K1
            pix.append(p[hit])
            slots.append(c[hit] * K1 + ksel[hit])
            zs.append(zmin[hit])

    z = torch.full((n,), torch.inf, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    mat = torch.zeros(n, dtype=torch.int32, device=dev)
    if pix:
        p, s, zp = (torch.cat(t) for t in (pix, slots, zs))
        z.scatter_reduce_(0, p, zp, "amin")
        near = zp == z[p]
        best = torch.full((n,), n_cl * K1, dtype=s.dtype, device=dev)
        best.scatter_reduce_(0, p[near], s[near], "amin")
        wp = torch.nonzero(best < n_cl * K1, as_tuple=True)[0]
        slot[wp] = best[wp].to(torch.int32)
        u[wp], v[wp], mat[wp] = _commit_attrs(
            setup.reshape(-1, SETUP_W)[best[wp]], x[wp], y[wp])
    shape = (nb, LANES)
    return (z.reshape(shape), slot.reshape(shape), u.reshape(shape),
            v.reshape(shape), mat.reshape(shape))


def raster_edge(setup, scb, clb, px, py, zfloor):
    """Rasterize the setup rows over lane-major pixels.

    px, py: f32[Nb,128] sample positions in pixels (the engine's tiled
    order); zfloor: f32[Nb,128] NDC depth floor — fragments must lie
    strictly beyond it (0 in the first round, the discarded fragment's z
    in the alpha-discard rounds, >= 1e9 parks the pixel). Returns (z,
    slot, u, v, mat), all [Nb,128]: z inf, slot -1, u = v = 0, mat 0 where
    nothing is covered; else the nearest fragment's NDC depth, its slot
    (cluster id * 128 + triangle; tree.leaf_tri maps it to the original
    triangle), its perspective-correct uv and its material slot. A CUDA
    tensor launches kernel G and counts it in `raster_edge.launches`; a
    CPU tensor runs `raster_edge_plain`."""
    dev = px.device
    if dev.type == "cpu":
        return raster_edge_plain(setup, scb, clb, px, py, zfloor)
    if dev.type != "cuda":
        raise ValueError(f"raster_edge: unsupported device {dev}")
    _check(setup, scb, clb, px, py, zfloor)
    setup, scb, clb, px, py, zfloor = (
        t.contiguous() for t in (setup, scb, clb, px, py, zfloor))
    nb = px.shape[0]
    shape = (nb, LANES)
    z = torch.empty(shape, device=dev)
    slot = torch.empty(shape, dtype=torch.int32, device=dev)
    u = torch.empty(shape, device=dev)
    v = torch.empty(shape, device=dev)
    mat = torch.empty(shape, dtype=torch.int32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkrt_raster_edge(
            setup.data_ptr(), scb.data_ptr(), scb.shape[1], clb.shape[0],
            clb.data_ptr(), px.data_ptr(), py.data_ptr(), zfloor.data_ptr(),
            nb * LANES, z.data_ptr(), slot.data_ptr(), u.data_ptr(),
            v.data_ptr(), mat.data_ptr(), stream)
    kernels.check(err, "raster_edge")
    raster_edge.launches += 1
    return z, slot, u, v, mat


raster_edge.launches = 0
