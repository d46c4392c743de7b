"""The plain reference renderer that decides `correct`.

Plain PyTorch, independent of the program: it imports nothing of it and
takes nothing it made. From the benchmark's own scene data it flattens
the geometry, builds its own bounding-volume hierarchy (a complete
binary tree over Morton-ordered leaves of a few triangles each) and
renders a whole frame of the reference renderer's contract, the
constants of which are copied from vkrt's shaders below:

  ray gen           shader.rgen:30-38 (through each pixel's centre)
  closest hit       Moller-Trumbore, both faces, tmin 0.001, tmax 1000
  shading           shader.rchit:86-172: barycentric attributes, TBN
                    normal mapping, 4 point lights of intensity 10 with
                    shadow rays (x0.3 when blocked), ambient 0.1,
                    metallic > 0.1 reflects with attenuation
                    0.5 * metallic, updated before the (1 - att) scale
  miss              shader.rmiss:17, sky (0.8, 0.8, 1), unattenuated
  textures          bilinear, repeat wrap, level 0 (a ray-tracing
                    stage has no derivatives)
  framebuffer       UNORM8: clamp(c * 255 + 0.5) truncated
  ray count         per depth the rays traced: live rays and the
                    shadow rays cast (N.L > 0 at a hit)

`render(...)` returns (u8[H,W,3], rays traced, and per pixel the
closest-hit rays its path traced, u8[H,W]). Matrix products (ray
generation, the instance transform, attribute interpolation) are written
as matmuls; with `tf32=True` their inputs are rounded to TF32's 10-bit
mantissa, which is what the tensor cores do when TF32 is allowed: that
is the control, the nearest precision below the float32 that the
configuration states (the program keeps TF32 off).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LIGHTS = ((6.0, 6.0, 0.0), (2.0, 5.0, 0.0), (-2.0, 4.0, 0.0),
          (-6.0, 3.0, 0.0))
LIGHT_INTENSITY = 10.0
SHADOW_MULTIPLIER = 0.3
AMBIENT = 0.1
SKY = (0.8, 0.8, 1.0)
METALLIC_THRESHOLD = 0.1
REFLECT_SCALE = 0.5
TMIN, TMAX = 0.001, 1000.0
SCENE_SCALE = 0.01
DET_EPS = 1e-12
RAY_CHUNK = 1 << 20
STACK = 48


def tf32_round(x):
    """x (f32) rounded to nearest TF32 (10 explicit mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def _mm(a, b, tf32):
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


class Geometry(NamedTuple):
    """Per-triangle corners in world units: p, n, t f32[T,3,3],
    uv f32[T,3,2]; image ids (base, mr, normal) i64[T,3]."""
    p: torch.Tensor
    n: torch.Tensor
    t: torch.Tensor
    uv: torch.Tensor
    img: torch.Tensor


class Textures(NamedTuple):
    texels: torch.Tensor   # u8[N,4], every image's level 0, row-major
    offset: torch.Tensor   # i64[I]
    width: torch.Tensor    # i64[I]
    height: torch.Tensor   # i64[I]


class Tree(NamedTuple):
    """Complete binary tree in heap order: node 1 is the root, node n has
    children 2n and 2n+1, leaves are nodes NL..2NL-1. lo, hi f32[2NL,3]
    (an empty leaf has lo > hi); tris f32[NL*L,9] (v0, e1, e2) in leaf
    order, L per leaf, ids i64[NL*L] (-1 on padding)."""
    lo: torch.Tensor
    hi: torch.Tensor
    tris: torch.Tensor
    ids: torch.Tensor
    leaves: int
    per_leaf: int


def geometry(scene, device) -> Geometry:
    """Flatten the benchmark's Scene: positions scaled into world units,
    image ids with absent maps at image 0."""
    p, n, t, uv, img = [], [], [], [], []
    for sm in scene.submeshes:
        idx = sm.indices.astype(np.int64).reshape(-1, 3)
        p.append((sm.positions * np.float32(SCENE_SCALE))[idx])
        n.append(sm.normals[idx])
        t.append(sm.tangents[idx, :3])
        uv.append(sm.uvs[idx])
        ids = (scene.materials[sm.material] if sm.material >= 0
               else (-1, -1, -1))
        img.append(np.tile(np.maximum(np.asarray(ids, np.int64), 0),
                           (idx.shape[0], 1)))

    def put(parts, dtype=torch.float32):
        return torch.as_tensor(np.concatenate(parts), dtype=dtype,
                               device=device)
    return Geometry(put(p), put(n), put(t), put(uv), put(img, torch.int64))


def textures(scene, device) -> Textures:
    sizes = [im.shape[0] * im.shape[1] for im in scene.images]
    offset = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    texels = np.concatenate([im.reshape(-1, 4) for im in scene.images])
    return Textures(torch.as_tensor(texels, device=device),
                    torch.as_tensor(offset, dtype=torch.int64,
                                    device=device),
                    torch.as_tensor([im.shape[1] for im in scene.images],
                                    device=device),
                    torch.as_tensor([im.shape[0] for im in scene.images],
                                    device=device))


def transformed(g: Geometry, m, tf32=False) -> Geometry:
    """The instance transform m (f32[4,4]) applied to points and, by its
    3x3 part, to normals and tangents."""
    m = torch.as_tensor(np.asarray(m, np.float32), device=g.p.device)
    a = m[:3, :3].T.contiguous()
    return g._replace(p=_mm(g.p, a, tf32) + m[:3, 3],
                      n=_mm(g.n, a, tf32), t=_mm(g.t, a, tf32))


def _spread(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def build_tree(g: Geometry) -> Tree:
    v0 = g.p[:, 0]
    e1, e2 = g.p[:, 1] - v0, g.p[:, 2] - v0
    T = v0.shape[0]
    c = g.p.mean(dim=1)
    lo, hi = c.min(dim=0).values, c.max(dim=0).values
    q = ((c - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).long()
    code = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) | _spread(
        q[:, 2])
    order = torch.argsort(code, stable=True)
    nl = 1 << max(0, int(math.floor(math.log2(max(T / 4, 1)))))
    per = -(-T // nl)
    ids = torch.full((nl * per,), -1, dtype=torch.int64, device=v0.device)
    ids[:T] = order
    tris = torch.cat([v0, e1, e2], dim=1)[ids.clamp(min=0)]
    tris[ids < 0] = 0.0
    corners = g.p[ids.clamp(min=0)]                      # [S,3,3]
    big = torch.tensor(float("inf"), device=v0.device)
    clo = torch.where((ids >= 0)[:, None, None], corners, big)
    chi = torch.where((ids >= 0)[:, None, None], corners, -big)
    lo_l = clo.amin(dim=1).reshape(nl, per, 3).amin(dim=1)
    hi_l = chi.amax(dim=1).reshape(nl, per, 3).amax(dim=1)
    los, his = [lo_l], [hi_l]
    while los[-1].shape[0] > 1:
        los.append(torch.minimum(los[-1][0::2], los[-1][1::2]))
        his.append(torch.maximum(his[-1][0::2], his[-1][1::2]))
    pad = torch.zeros((1, 3), device=v0.device)
    lo_n, hi_n = torch.cat([pad] + los[::-1]), torch.cat([pad] + his[::-1])
    # a node with no triangle: a point far beyond TMAX, which no ray hits
    empty = (lo_n > hi_n).any(dim=1)
    lo_n[empty], hi_n[empty] = 1e30, 1e30
    return Tree(lo_n, hi_n, tris.contiguous(), ids, nl, per)


def _slab(lo, hi, o, inv, tmax):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return tn, (tn <= tf) & (tf >= TMIN) & (tn <= tmax)


def _moller(o, d, tri, tmax):
    v0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    h = torch.linalg.cross(d, e2)
    det = (e1 * h).sum(-1)
    ok_det = det.abs() > DET_EPS
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    s = o - v0
    u = (s * h).sum(-1) * inv
    q = torch.linalg.cross(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = ok_det & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > TMIN) & (
        t < tmax)
    return t, u, v, ok


def _trace_chunk(tree: Tree, o, d, tmax, any_hit):
    """Stack walk, front to back, of rays o, d f32[B,3]: one node popped
    per ray and step; rays whose stacks are empty are compacted away
    every few steps."""
    B, dev = o.shape[0], o.device
    tiny = 1e-20
    inv = 1.0 / torch.where(d.abs() < tiny,
                            torch.where(d < 0, -tiny, tiny), d)
    best_t = tmax.clone()
    best_id = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(B, device=dev)
    best_v = torch.zeros(B, device=dev)
    live = torch.arange(B, device=dev)
    stack = torch.zeros((B, STACK), dtype=torch.int32, device=dev)
    stack[:, 0] = 1
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    nl, per = tree.leaves, tree.per_leaf
    leaf_tris = tree.tris.reshape(nl, per, 9)
    leaf_ids = tree.ids.reshape(nl, per)
    while True:
        o_, d_, inv_ = o[live], d[live], inv[live]
        bt, bid = best_t[live], best_id[live]
        bu, bv = best_u[live], best_v[live]
        r = torch.arange(live.numel(), device=dev)
        for _ in range(8):
            alive = sp > 0
            sp = torch.where(alive, sp - 1, sp)
            node = stack[r, sp].long()
            inner = alive & (node < nl)
            leaf = alive & (node >= nl)
            # an inner node: both children's boxes, the far one pushed
            # first so that the near one is walked first
            kid = torch.where(inner, 2 * node, 2)
            tl, hl = _slab(tree.lo[kid], tree.hi[kid], o_, inv_, bt)
            tr, hr = _slab(tree.lo[kid + 1], tree.hi[kid + 1], o_, inv_,
                           bt)
            near_l = tl <= tr
            for h, k in ((torch.where(near_l, hr, hl) & inner,
                          torch.where(near_l, kid + 1, kid)),
                         (torch.where(near_l, hl, hr) & inner,
                          torch.where(near_l, kid, kid + 1))):
                top = sp.clamp(max=STACK - 1)
                stack[r, top] = torch.where(h, k, stack[r, top].long()).to(
                    torch.int32)
                sp = sp + h.long()
            # a leaf: its triangles, the nearest hit kept
            lf = torch.where(leaf, node - nl, 0)
            t, u, v, ok = _moller(o_[:, None], d_[:, None], leaf_tris[lf],
                                  bt[:, None])
            ids = leaf_ids[lf]
            ok = ok & leaf[:, None] & (ids >= 0)
            t = torch.where(ok, t, float("inf"))
            k = t.argmin(dim=1, keepdim=True)
            take = ok.gather(1, k)[:, 0]
            bt = torch.where(take, t.gather(1, k)[:, 0], bt)
            bu = torch.where(take, u.gather(1, k)[:, 0], bu)
            bv = torch.where(take, v.gather(1, k)[:, 0], bv)
            bid = torch.where(take, ids.gather(1, k)[:, 0], bid)
            if any_hit:
                sp = torch.where(bid >= 0, 0, sp)
        best_t[live], best_id[live] = bt, bid
        best_u[live], best_v[live] = bu, bv
        keep = sp > 0
        n_keep = int(keep.sum())
        if n_keep == 0:
            break
        if n_keep < keep.numel():
            live, stack, sp = live[keep], stack[keep], sp[keep]
    return best_t, best_id, best_u, best_v


def trace(tree: Tree, o, d, tmax, any_hit=False):
    """(t, tri id or -1, u, v) of rays o, d f32[N,3] within (TMIN, tmax)."""
    if o.shape[0] == 0:
        z = torch.zeros(0, device=o.device)
        return z, z.long(), z, z
    out = [_trace_chunk(tree, o[i:i + RAY_CHUNK], d[i:i + RAY_CHUNK],
                        tmax[i:i + RAY_CHUNK], any_hit)
           for i in range(0, o.shape[0], RAY_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*out))


def _normalize(v):
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-20)


def sample(tex: Textures, img, uv):
    """Bilinear, repeat-wrapped level-0 samples rgba f32[N,4]."""
    off, w, h = tex.offset[img], tex.width[img], tex.height[img]
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = x0.long(), y0.long()

    def texel(xi, yi):
        i = off + torch.remainder(yi, h) * w + torch.remainder(xi, w)
        return tex.texels[i].to(torch.float32) / 255.0
    return (texel(x0, y0) * ((1 - fx) * (1 - fy))
            + texel(x0 + 1, y0) * (fx * (1 - fy))
            + texel(x0, y0 + 1) * ((1 - fx) * fy)
            + texel(x0 + 1, y0 + 1) * (fx * fy))


def camera_rays(width, height, proj_inverse, view_inverse, device,
                tf32=False):
    """Rays through the pixel centres, row-major: o, d f32[H*W,3]."""
    pi = torch.as_tensor(np.asarray(proj_inverse, np.float32), device=device)
    vi = torch.as_tensor(np.asarray(view_inverse, np.float32), device=device)
    xs = (torch.arange(width, device=device, dtype=torch.float32) + 0.5) \
        / width * 2.0 - 1.0
    ys = (torch.arange(height, device=device, dtype=torch.float32) + 0.5) \
        / height * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    one = torch.ones_like(gx)
    ndc = torch.stack([gx, gy, one, one], dim=-1).reshape(-1, 4)
    dv = _normalize(_mm(ndc, pi.T.contiguous(), tf32)[:, :3])
    d = _mm(torch.cat([dv, torch.zeros_like(dv[:, :1])], dim=1),
            vi.T.contiguous(), tf32)[:, :3]
    o = vi[:3, 3].expand(d.shape).contiguous()
    return o, d


def render(geo: Geometry, tex: Textures, tree: Tree, cfg: dict, pose,
           tf32=False):
    """One frame of `cfg` (the configuration file's "render" fields) seen
    from `pose` (proj_inverse, view_inverse): (u8[H,W,3], rays traced,
    closest-hit rays per pixel u8[H,W])."""
    if cfg.get("flat_albedo") or cfg.get("mip_lod"):
        raise ValueError("flat_albedo and mip_lod are not in this reference")
    H, W, dev = cfg["height"], cfg["width"], geo.p.device
    o, d = camera_rays(W, H, pose.proj_inverse, pose.view_inverse, dev,
                       tf32)
    n = H * W
    accum = torch.zeros((n, 3), device=dev)
    att = torch.ones(n, device=dev)
    idx = torch.arange(n, device=dev)
    lights = torch.tensor(LIGHTS[:cfg["num_lights"]], device=dev)
    sky = torch.tensor(SKY, device=dev)
    rays = 0
    segments = torch.zeros(n, dtype=torch.uint8, device=dev)
    for _ in range(cfg["max_depth"]):
        if idx.numel() == 0:
            break
        rays += idx.numel()
        segments[idx] += 1
        _, tri, u, v = trace(tree, o, d, torch.full_like(o[:, 0], TMAX))
        hit = tri >= 0
        contrib = torch.where(hit[:, None], 0.0, sky)
        th, dh = tri[hit], d[hit]
        bary = torch.stack([1.0 - u[hit] - v[hit], u[hit], v[hit]],
                           dim=1)[:, None, :]

        def interp(corners):
            return _mm(bary, corners, tf32)[:, 0]
        pos, nrm = interp(geo.p[th]), interp(geo.n[th])
        uv, tan = interp(geo.uv[th]), interp(geo.t[th])
        img = geo.img[th]
        base = sample(tex, img[:, 0], uv)[:, :3]
        metallic = sample(tex, img[:, 1], uv)[:, 2]
        nmap = sample(tex, img[:, 2], uv)[:, :3]
        wn, tn = _normalize(nrm), _normalize(tan)
        bn = torch.linalg.cross(tn, wn)
        mn = _normalize(nmap * 2.0 - 1.0)
        pn = _normalize(tn * mn[:, 0:1] + bn * mn[:, 1:2] + wn * mn[:, 2:3])

        total = torch.zeros(pos.shape[0], device=dev)
        geo_l = []
        for li in range(lights.shape[0]):
            lvec = lights[li] - pos
            ldist = lvec.norm(dim=1)
            ldir = lvec / torch.clamp(ldist, min=1e-20)[:, None]
            geo_l.append((ldir, ldist, (pn * ldir).sum(dim=1)))
        mults = [torch.ones_like(total) for _ in geo_l]
        if cfg["enable_shadows"] and geo_l:
            casts = [nd > 0 for _, _, nd in geo_l]
            rays += int(sum(int(c.sum()) for c in casts))
            so = torch.cat([pos[c] for c in casts])
            sd = torch.cat([g[0][c] for g, c in zip(geo_l, casts)])
            st = torch.cat([g[1][c] for g, c in zip(geo_l, casts)])
            blocked = trace(tree, so, sd, st, any_hit=True)[1] >= 0
            at = 0
            for m, c in zip(mults, casts):
                k = int(c.sum())
                m[c] = torch.where(blocked[at:at + k], SHADOW_MULTIPLIER,
                                   1.0)
                at += k
        for (ldir, ldist, nd), m in zip(geo_l, mults):
            power = LIGHT_INTENSITY / torch.clamp(ldist * ldist, min=1e-20)
            total = total + torch.clamp(nd, 0.0, 1.0) * power * m

        a = att[idx][hit]
        value = base * (total * a)[:, None] + base * AMBIENT
        refl = (metallic > METALLIC_THRESHOLD) if cfg["enable_reflections"] \
            else torch.zeros_like(hit[hit])
        a_out = torch.where(refl, a * (REFLECT_SCALE * metallic), a)
        value = torch.where(refl[:, None], value * (1.0 - a_out)[:, None],
                            value)
        contrib[hit] = value
        accum[idx] += contrib
        hidx = idx[hit]
        att[hidx] = a_out
        dr = dh - 2.0 * (dh * pn).sum(dim=1, keepdim=True) * pn
        idx, o, d = hidx[refl], pos[refl], dr[refl]
    fb = accum.reshape(H, W, 3)
    return (torch.clamp(fb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8), rays,
            segments.reshape(H, W))
