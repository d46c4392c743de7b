"""Hit shading — counterpart of vkrt_tpu/shade/shading.py.

The closest-hit shader contract (shaders/shader.rchit:86-172) over
lane-major ray batches: barycentric attribute interpolation, TBN normal
mapping, per-light geometry and the reflection direction. The same
float32 operations in the same order as the JAX package.

The wavefront engine shades each depth in three steps around the
material sample and the shadow trace; on a CUDA tensor each step is one
launch of kernel L (csrc/shade_hits.cu, one thread a lane), on a CPU
tensor its plain version, with the same inputs and outputs:

  shade_interp   before the sample: the hit mask, and the position, uv
                 and material slot of the lanes that hit (0 elsewhere);
  shade_lights   before the shadow trace: the perturbed normal, which
                 lights each hit casts a shadow ray to, and those rays;
  shade_combine  after it: the miss shader, the light sum, the colour
                 and ray count added up, and the reflection carry.

The plain versions are the engine's operation sequence, with zeros in
place of what a lane that did not hit would interpolate: no frame reads
those values. Each wrapper counts its launches (`launches`) and records
the lanes it is launched over (tracing.lanes, as "shade_hits").
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import kernels, tracing
from vkrt_tpu_torch.utils import layout as L

MAX_LIGHTS = 4                   # lights kernel L takes (C.LIGHT_POSITIONS)


def _blend(attrs, row: int, k: int, w, u, v):
    """Rows row..row+k of corner 0 at weight w, corner 1 at u and corner 2
    at v, summed in that order."""
    return (attrs[row:row + k] * w[None]
            + attrs[row + k:row + 2 * k] * u[None]
            + attrs[row + 2 * k:row + 3 * k] * v[None])


def interpolate(attrs, u, v):
    """Split the per-corner attr block [36,Nb,128] and interpolate.
    Returns (position, normal, uv, tangent, mat_ids); see the JAX
    function for the row layout."""
    w = 1.0 - u - v
    position = attrs[0:3] + u[None] * attrs[3:6] + v[None] * attrs[6:9]
    mat_ids = attrs[33:36].to(torch.int32)
    return (position, _blend(attrs, 9, 3, w, u, v),
            _blend(attrs, 18, 2, w, u, v), _blend(attrs, 24, 3, w, u, v),
            mat_ids)


def perturbed_normal(world_normal, tangent, map_normal):
    """TBN normal mapping (ref: shader.rchit:78-84,105-108)."""
    n = L.normalize3(world_normal)
    t = L.normalize3(tangent)
    b = L.cross3(t, n)
    m = L.normalize3(map_normal * 2.0 - 1.0)
    return L.normalize3(t * m[0][None] + b * m[1][None] + n * m[2][None])


def light_geometry(position, light_pos):
    """Per-light direction/distance/power (ref: shader.rchit:121-126).
    position cvec [3,Nb,128]; light_pos [3]. Returns (ldir cvec, ldist,
    power)."""
    lvec = light_pos[:, None, None] - position
    ldist = L.norm3(lvec)
    ldir = lvec / torch.clamp(ldist, min=1e-20)[None]
    power = C.LIGHT_INTENSITY / torch.clamp(ldist * ldist, min=1e-20)
    return ldir, ldist, power


def reflect(d, n):
    """GLSL reflect (ref: shader.rchit:170). cvec in, cvec out."""
    return d - 2.0 * L.dot3(d, n)[None] * n


def cast_bits(castmask, nl: int):
    """bool[nl,Nb,128] from `shade_lights`' castmask: light s's bit."""
    bits = castmask.to(torch.int32)
    return torch.stack([((bits >> s) & 1) > 0 for s in range(nl)])


# --- plain versions (the CPU path and the kernels' reference) ------------

def shade_interp_plain(active, hitm, u, v, attrs):
    """Plain version of `shade_interp`: (pos f32[3,Nb,128], uv
    f32[2,Nb,128], slot i32[Nb,128], hit bool[Nb,128]), `interpolate`'s
    position, uv and base-map slot where hit = hitm & active, 0
    elsewhere."""
    hit = hitm & active
    pos, _, uv, _, mat_ids = interpolate(attrs, u, v)
    return (torch.where(hit[None], pos, 0.0), torch.where(hit[None], uv, 0.0),
            torch.where(hit, mat_ids[0], 0), hit)


def shade_lights_plain(hit, u, v, attrs, map_n, pos, lights, segments=True):
    """Plain version of `shade_lights`: (pn, castmask, sd, st). pn
    f32[3,Nb,128] is `perturbed_normal` where `hit`, 0 elsewhere. With
    `lights` (f32[L,3], 1 <= L <= 4) castmask f32[Nb,128] holds bit s
    where a hit faces light s (n.l > 0: it casts a shadow ray), and with
    `segments` sd f32[L,3,Nb,128] and st f32[L,Nb,128] are those rays as
    the shadow trace takes them: direction from the light, -ldir (from
    the point 0 where not hit), length ldist - RAY_TMIN where cast, else
    0. What `lights` or `segments` leave out is None."""
    w = 1.0 - u - v
    pn = torch.where(hit[None], perturbed_normal(
        _blend(attrs, 9, 3, w, u, v), _blend(attrs, 24, 3, w, u, v), map_n),
        0.0)
    if lights is None:
        return pn, None, None, None
    pos0 = torch.where(hit[None], pos, 0.0)
    geo = [light_geometry(pos0, lights[s]) for s in range(lights.shape[0])]
    casts = [hit & (L.dot3(pn, g[0]) > 0) for g in geo]
    castmask = casts[0].to(torch.float32)
    for s in range(1, len(casts)):
        castmask = castmask + casts[s].to(torch.float32) * float(1 << s)
    if not segments:
        return pn, castmask, None, None
    sd = torch.stack([-g[0] for g in geo])                  # [L,3,Nb,128]
    st = torch.stack([torch.where(c, g[1] - C.RAY_TMIN, 0.0)
                      for c, g in zip(casts, geo)])         # [L,Nb,128]
    return pn, castmask, sd, st


def shade_combine_plain(active, hitm, base, metallic, pn, pos, lights, occ,
                        origins, dirs, attenuation, accum, ray_count,
                        reflections=True, flat=False):
    """Plain version of `shade_combine`: see there."""
    hit = hitm & active
    miss = active & ~hitm
    # miss shader: sky, unattenuated (ref: shader.rmiss:17); Python
    # scalars, so no host-to-device copy waits for the card
    dacc = torch.stack([torch.where(miss, float(c), 0.0)
                        for c in C.SKY_COLOR])
    dcount = active.to(torch.float32)
    if flat:
        accum.copy_(torch.where(active[None], accum + dacc
                                + torch.where(hit[None], base, 0.0), accum))
        ray_count += dcount.to(torch.int32)
        return None
    geo = [light_geometry(pos, lights[s]) for s in range(lights.shape[0])]
    ndotls = [L.dot3(pn, g[0]) for g in geo]
    if occ is not None:
        for nd in ndotls:
            dcount = dcount + (hit & (nd > 0)).to(torch.float32)
    if reflections:
        reflective = hit & (metallic > C.METALLIC_THRESHOLD)
        # attenuation updates BEFORE the (1 - attenuation) scale — order
        # quirk preserved (ref: shader.rchit:165-167)
        new_att = attenuation * (C.REFLECT_SCALE * metallic)
        att_updated = torch.where(reflective, new_att, attenuation)
    else:
        reflective = torch.zeros_like(hit)
        att_updated = attenuation
    total_light = torch.zeros_like(attenuation)
    for s, nd in enumerate(ndotls):
        diffuse = torch.clamp(nd, 0.0, 1.0)
        mult = torch.ones_like(attenuation)
        if occ is not None:
            mult = torch.where(hit & (nd > 0) & occ[s], C.SHADOW_MULTIPLIER,
                               1.0)
        total_light = total_light + diffuse * geo[s][2] * mult
    hit_value = (base * (total_light * attenuation)[None]
                 + base * C.AMBIENT)
    if reflections:
        hit_value = torch.where(reflective[None],
                                hit_value * (1.0 - att_updated)[None],
                                hit_value)
    dacc = dacc + torch.where(hit[None], hit_value, 0.0)
    if accum is not None:
        accum.copy_(torch.where(active[None], accum + dacc, accum))
        ray_count += dcount.to(torch.int32)
    attenuation.copy_(att_updated)
    origins.copy_(L.where3(reflective, pos, origins))
    dirs.copy_(L.where3(reflective, reflect(dirs, pn), dirs))
    active.copy_(reflective)
    return None if accum is not None else (dacc, dcount)


# --- the wrappers ---------------------------------------------------------

def _check(name: str, dev, **tensors) -> None:
    """ValueError unless each tensor (name → (tensor, dtype, shape)) has
    its dtype and shape and lies on `dev`; None passes where the shape is
    None."""
    for what, (t, dtype, shape) in tensors.items():
        if t is None and shape is None:
            continue
        if (t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or t.device != dev):
            got = (None if t is None
                   else f"{t.dtype}{list(t.shape)} on {t.device}")
            raise ValueError(f"{name}: {what} must be {dtype}{list(shape)} "
                             f"on {dev}, got {got}")


def _lanes(name: str, active) -> tuple:
    """(device, [Nb,128]) of a wavefront's mask, refused unless it is a
    bool[Nb,128] on the CPU or a card with 36 * Nb * 128 < 2^31."""
    dev = active.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    shape = tuple(active.shape)
    if (active.dtype != torch.bool or len(shape) != 2
            or shape[-1] != L.LANES or 36 * active.numel() >= 2 ** 31):
        raise ValueError(f"{name}: the mask must be bool[Nb,128] "
                         f"(36 * Nb * 128 < 2^31)")
    return dev, shape


def _lights(name: str, lights, dev, lo: int) -> int:
    if (lights.dtype != torch.float32 or lights.dim() != 2
            or lights.shape[1] != 3 or lights.device != dev
            or not lo <= lights.shape[0] <= MAX_LIGHTS):
        raise ValueError(f"{name}: lights must be f32[L,3] on {dev}, "
                         f"{lo} <= L <= {MAX_LIGHTS}")
    return lights.shape[0]


def _launch(name: str, dev, fn, *args) -> None:
    """fn(*args, stream) on `dev`'s current stream (a graph capture's)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    kernels.check(err, name)


def _ptr(t):
    return None if t is None else t.data_ptr()


def shade_interp(active, hitm, u, v, attrs):
    """The interpolation before the material sample: active and hitm
    bool[Nb,128] (the rays traced live, and those that hit), the trace's
    u, v f32[Nb,128] and attribute block attrs f32[36,Nb,128]. Returns
    (pos f32[3,Nb,128], uv f32[2,Nb,128], slot i32[Nb,128], hit
    bool[Nb,128]): hit = hitm & active, and where it holds the
    position, uv and base-map material slot of `interpolate` (the slot a
    truncating cast), 0 elsewhere. A CUDA tensor launches kernel L's
    first step, which reads rows 0-8, 18-23 and 33 of a lane that hit
    alone; a CPU tensor runs `shade_interp_plain`."""
    dev, shape = _lanes("shade_interp", active)
    _check("shade_interp", dev, hitm=(hitm, torch.bool, shape),
           u=(u, torch.float32, shape), v=(v, torch.float32, shape),
           attrs=(attrs, torch.float32, (36, *shape)))
    tracing.lanes("shade_hits", active.numel())
    if dev.type == "cpu":
        return shade_interp_plain(active, hitm, u, v, attrs)
    active, hitm, u, v, attrs = (t.contiguous()
                                 for t in (active, hitm, u, v, attrs))
    out = torch.empty((6, *shape), device=dev)
    hit = torch.empty(shape, dtype=torch.bool, device=dev)
    _launch("shade_interp", dev, kernels.library().vkrt_shade_interp,
            active.data_ptr(), hitm.data_ptr(), u.data_ptr(), v.data_ptr(),
            attrs.data_ptr(), active.numel(), out.data_ptr(), hit.data_ptr())
    shade_interp.launches += 1
    return out[0:3], out[3:5], out[5].view(torch.int32), hit


def shade_lights(hit, u, v, attrs, map_n, pos, lights, segments=True):
    """The step between the material sample and the shadow trace: hit
    bool[Nb,128] and pos f32[3,Nb,128] from `shade_interp`, the trace's
    u, v and attrs, the sampled normal map map_n f32[3,Nb,128], and the
    lights the shadow rays go to, f32[L,3] with 1 <= L <= 4, or None where
    no shadow ray is cast. Returns (pn, castmask, sd, st) as
    `shade_lights_plain` defines them: sd and st only with `segments` (the
    shadow trace's own layout, [L,3,Nb,128] and [L,Nb,128]), castmask only
    with `lights`. A CUDA tensor launches kernel L's second step, which
    reads the normal and tangent rows 9-17 and 24-32 of a lane that hit
    alone; a CPU tensor runs the plain version."""
    dev, shape = _lanes("shade_lights", hit)
    _check("shade_lights", dev, u=(u, torch.float32, shape),
           v=(v, torch.float32, shape),
           attrs=(attrs, torch.float32, (36, *shape)),
           map_n=(map_n, torch.float32, (3, *shape)),
           pos=(pos, torch.float32, (3, *shape)))
    nl = 0 if lights is None else _lights("shade_lights", lights, dev, 1)
    tracing.lanes("shade_hits", hit.numel())
    if dev.type == "cpu":
        return shade_lights_plain(hit, u, v, attrs, map_n, pos, lights,
                                  segments)
    hit, u, v, attrs, map_n, pos = (t.contiguous() for t in (
        hit, u, v, attrs, map_n, pos))
    segs = bool(segments) and nl > 0
    rows = 3 + (nl > 0) + 4 * nl * segs
    out = torch.empty((rows, *shape), device=dev)
    lp = lights.contiguous() if nl else None
    _launch("shade_lights", dev, kernels.library().vkrt_shade_lights,
            hit.data_ptr(), u.data_ptr(), v.data_ptr(), attrs.data_ptr(),
            map_n.data_ptr(), pos.data_ptr(), _ptr(lp), nl, int(segs),
            hit.numel(), out.data_ptr())
    shade_lights.launches += 1
    pn = out[0:3]
    if not nl:
        return pn, None, None, None
    if not segs:
        return pn, out[3], None, None
    return (pn, out[3], out[4:4 + 3 * nl].view(nl, 3, *shape),
            out[4 + 3 * nl:])


def shade_combine(active, hitm, base, metallic, pn, pos, lights, occ,
                  origins, dirs, attenuation, accum, ray_count,
                  reflections=True, flat=False):
    """The step after the shadow trace, on lanes `active` (bool[Nb,128])
    whose rays hit where `hitm`: a miss adds the sky; a hit adds
    base * (sum over lights of clamp(n.l, 0, 1) * power * (0.3 where its
    shadow ray is blocked, else 1)) * attenuation + base * AMBIENT, scaled
    by 1 - the new attenuation where it reflects (metallic > 0.1, with
    `reflections`; its attenuation is first scaled by 0.5 * metallic);
    each traced ray, and each shadow ray cast, counts one.

    Inputs: base f32[3,Nb,128], metallic f32[Nb,128] (the sample), pn and
    pos f32[3,Nb,128] (`shade_lights`, `shade_interp`), lights f32[L,3]
    (0 <= L <= 4), occ bool[L,Nb,128] (the shadow trace's blocked masks)
    or None without shadows. Updated in place, where the lane is active:
    accum f32[3,Nb,128] and ray_count i32[Nb,128]; and the reflection
    carry, origins and dirs f32[3,Nb,128] (the point and the reflected
    direction where the lane reflects), attenuation f32[Nb,128] and
    active (True where it reflects). With accum and ray_count None the
    colour and count are returned instead, as (dacc f32[3,Nb,128], dcount
    f32[Nb,128]), 0 on lanes not active. With `flat`, accum gains the sky
    or the base colour alone and ray_count the traced rays, and nothing
    else is read or written (pn, pos, lights, occ and the carry may be
    None). A CUDA tensor launches kernel L's third step; a CPU tensor runs
    `shade_combine_plain`. Every tensor written must be contiguous."""
    name = "shade_combine"
    dev, shape = _lanes(name, active)
    v3, v1 = (3, *shape), shape
    partitioned = accum is None
    if flat and partitioned:
        raise ValueError(f"{name}: flat takes accum and ray_count")
    _check(name, dev, hitm=(hitm, torch.bool, v1),
           base=(base, torch.float32, v3),
           accum=(accum, torch.float32, None if partitioned else v3),
           ray_count=(ray_count, torch.int32, None if partitioned else v1))
    nl = 0
    if not flat:
        nl = _lights(name, lights, dev, 0)
        _check(name, dev, metallic=(metallic, torch.float32, v1),
               pn=(pn, torch.float32, v3), pos=(pos, torch.float32, v3),
               occ=(occ, torch.bool, None if occ is None else (nl, *v1)),
               origins=(origins, torch.float32, v3),
               dirs=(dirs, torch.float32, v3),
               attenuation=(attenuation, torch.float32, v1))
        if occ is not None and nl == 0:
            raise ValueError(f"{name}: occ needs a light")
    written = (active, accum, ray_count) + ((origins, dirs, attenuation)
                                            if not flat else ())
    if any(t is not None and not t.is_contiguous() for t in written):
        raise ValueError(f"{name}: the tensors it writes must be "
                         f"contiguous")
    tracing.lanes("shade_hits", active.numel())
    if dev.type == "cpu":
        return shade_combine_plain(active, hitm, base, metallic, pn, pos,
                                   lights, occ, origins, dirs, attenuation,
                                   accum, ray_count, reflections, flat)
    hitm, base = hitm.contiguous(), base.contiguous()
    if not flat:
        metallic, pn, pos, lights = (t.contiguous()
                                     for t in (metallic, pn, pos, lights))
        occ = None if occ is None else occ.contiguous()
    out = (torch.empty((4, *shape), device=dev) if partitioned else None)
    _launch(name, dev, kernels.library().vkrt_shade_combine,
            active.data_ptr(), hitm.data_ptr(), base.data_ptr(),
            _ptr(metallic), _ptr(pn), _ptr(pos), _ptr(lights), nl, _ptr(occ),
            _ptr(origins), _ptr(dirs), _ptr(attenuation), _ptr(accum),
            _ptr(ray_count), _ptr(out), int(bool(reflections)),
            int(bool(flat)), active.numel())
    shade_combine.launches += 1
    return None if out is None else (out[0:3], out[3])


shade_interp.launches = 0
shade_lights.launches = 0
shade_combine.launches = 0
