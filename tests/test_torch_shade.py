"""vkrt_tpu_torch shading, sampling and layout vs the JAX package.

Element by element on the same numpy inputs. The port performs the same
float32 operations in the same order, so the tolerance is atol 1e-6 —
room for a rounding difference between XLA:CPU and PyTorch's CPU
kernels (e.g. in sqrt or a fused multiply-add), not for a different
formula. Also the engine's sampler `sample_hits` on the CPU (kernel K's
plain version; the kernel itself is checked on the card by
test_torch_cuda.py): its input checks, and its fetch counter and
bench_torch's sample_fetch_share on small traced frames.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu import config as C
from vkrt_tpu.scene.textures import build_material_heap
from vkrt_tpu.shade import sampling as js
from vkrt_tpu.shade import shading as jsh
from vkrt_tpu.utils import layout as jl
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.shade import sampling as ts
from vkrt_tpu_torch.shade import shading as tsh
from vkrt_tpu_torch.utils import layout as tl
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

BENCH = Path(__file__).resolve().parent.parent / "bench_torch"

ATOL = 1e-6
NB = 4


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def test_interpolate(rng):
    attrs = rng.normal(size=(36, NB, 128)).astype(np.float32)
    attrs[33:36] = rng.integers(0, 5, (3, NB, 128))
    u = rng.uniform(0, 0.5, (NB, 128)).astype(np.float32)
    v = rng.uniform(0, 0.5, (NB, 128)).astype(np.float32)
    want = jsh.interpolate(*(jnp.asarray(x) for x in (attrs, u, v)))
    got = tsh.interpolate(*(torch.from_numpy(x) for x in (attrs, u, v)))
    for g, w in zip(got, want):
        close(g, w)
    assert got[4].dtype == torch.int32


def test_perturbed_normal_and_reflect(rng):
    n, t, m, d = (rng.normal(size=(3, NB, 128)).astype(np.float32)
                  for _ in range(4))
    m = np.abs(m) % 1.0
    t[:, 0, :4] = 0.0                       # zero tangents safe-normalize
    jn = jsh.perturbed_normal(*(jnp.asarray(x) for x in (n, t, m)))
    tn = tsh.perturbed_normal(*(torch.from_numpy(x) for x in (n, t, m)))
    close(tn, jn)
    close(tsh.reflect(torch.from_numpy(d), tn),
          jsh.reflect(jnp.asarray(d), jn))


def test_light_geometry(rng):
    pos = rng.uniform(-10, 10, (3, NB, 128)).astype(np.float32)
    pos[:, 0, 0] = C.LIGHT_POSITIONS[1]     # a point on the light
    for li in range(4):
        lp = C.LIGHT_POSITIONS[li]
        want = jsh.light_geometry(jnp.asarray(pos), jnp.asarray(lp))
        got = tsh.light_geometry(torch.from_numpy(pos), torch.from_numpy(lp))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6, atol=ATOL)


def test_layout_helpers(rng):
    x = rng.normal(size=(NB * 128, 3)).astype(np.float32)
    a, b = (rng.normal(size=(3, NB, 128)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((NB, 128)) < 0.5
    m = rng.normal(size=(3, 3)).astype(np.float32)
    jx, tx = both(x)
    close(tl.to_cvec(tx), jl.to_cvec(jx))
    close(tl.from_cvec(tl.to_cvec(tx)), x)
    close(tl.from_lanes(tl.to_lanes(tx[:, 0])), x[:, 0])
    ja, ta = both(a)
    jb, tb = both(b)
    close(tl.dot3(ta, tb), jl.dot3(ja, jb))
    close(tl.cross3(ta, tb), jl.cross3(ja, jb))
    close(tl.normalize3(ta), jl.normalize3(ja))
    close(tl.scale3(ta, tb[0]), jl.scale3(ja, jb[0]))
    close(tl.where3(torch.from_numpy(mask), ta, tb),
          jl.where3(jnp.asarray(mask), ja, jb))
    close(tl.mat_rows3(tx, torch.from_numpy(m)),
          jl.mat_rows3(jx, jnp.asarray(m)), atol=1e-5)


@pytest.fixture(scope="module")
def heap():
    model = procedural_model("small", seed=0)
    triples = np.array([[3 * k, 3 * k + 1, 3 * k + 2]
                        for k in range(len(model.materials))], np.int32)
    return build_material_heap(model.images, triples)


def heap_args(heap, lib):
    arrs = (heap.texels_tri, heap.level_offset, heap.level_width,
            heap.level_height)
    if lib == "jax":
        return [jnp.asarray(a) for a in arrs]
    return [torch.from_numpy(np.array(a)) for a in arrs]


def sample_inputs(rng, heap):
    m = heap.level_offset.shape[0]
    slots = rng.integers(0, m, (NB, 128)).astype(np.int32)
    uv = rng.uniform(-3.0, 4.0, (2, NB, 128)).astype(np.float32)  # wraps
    return slots, uv


def test_sample_material(rng, heap):
    slots, uv = sample_inputs(rng, heap)
    want = js.sample_material(*heap_args(heap, "jax"), jnp.asarray(slots),
                              jnp.asarray(uv))
    got = ts.sample_material(*heap_args(heap, "torch"),
                             torch.from_numpy(slots), torch.from_numpy(uv))
    for g, w in zip(got, want):
        close(g, w)


def test_sample_material_negative_texel_wraps(heap):
    """uv just below 0 floors to texel -1, which wraps to the last texel
    (floor modulo, as jnp.mod)."""
    slots = np.zeros((1, 128), np.int32)
    uv = np.full((2, 1, 128), -1e-3, np.float32)
    want = js.sample_material(*heap_args(heap, "jax"), jnp.asarray(slots),
                              jnp.asarray(uv))
    got = ts.sample_material(*heap_args(heap, "torch"),
                             torch.from_numpy(slots), torch.from_numpy(uv))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("live_frac", [0.0, 0.1, 1.0])
def test_sample_material_compact(rng, heap, live_frac):
    slots, uv = sample_inputs(rng, heap)
    live = rng.random((NB, 128)) < live_frac
    live[2] = False                          # one all-dead row
    want = js.sample_material_compact(
        *heap_args(heap, "jax"), jnp.asarray(slots), jnp.asarray(uv),
        jnp.asarray(live), cap_rows=2)
    got = ts.sample_material_compact(
        *heap_args(heap, "torch"), torch.from_numpy(slots),
        torch.from_numpy(uv), torch.from_numpy(live))
    # rows with a live lane match exactly (dead lanes there sample slot 0
    # at uv 0 in both); an all-dead row is 0 here, while the JAX version
    # leaves 0 or that slot-0 sample there depending on its row chunking
    rows = live.any(axis=1)
    for g, w in zip(got, want):
        close(np.asarray(g)[:, rows], np.asarray(w)[:, rows])
        assert not np.asarray(g)[:, ~rows].any()


def heap_tex(heap):
    """The heap as the engine holds it (TextureArrays on the CPU)."""
    return te.texture_arrays_from_numpy(heap.texels_tri, heap.level_offset,
                                        heap.level_width, heap.level_height,
                                        "cpu")


@pytest.mark.parametrize("wrap", [False, True], ids=["unit", "wrapped"])
@pytest.mark.parametrize("hit_frac", [0.0, 0.02, 0.5, 1.0])
def test_sample_hits_plain_matches_jax_on_hit_lanes(rng, heap, hit_frac,
                                                    wrap):
    """sample_hits_plain (kernel K's plain version) and the wrapper on CPU
    tensors: on the hit lanes the JAX sample_material's base rgb,
    metallic (mr blue) and normal rgb, at uvs in [0, 1) or wrapped in
    [-3, 4); 0 on every other lane; the wrapper returns the same bits and
    counts no launch."""
    slots, uv = sample_inputs(rng, heap)
    if not wrap:
        uv = rng.uniform(0.0, 1.0, uv.shape).astype(np.float32)
    hit = rng.random(slots.shape) < hit_frac
    want = js.sample_material(*heap_args(heap, "jax"), jnp.asarray(slots),
                              jnp.asarray(uv))
    want = [np.asarray(want[0])[:3], np.asarray(want[1])[2],
            np.asarray(want[2])[:3]]
    tex = heap_tex(heap)
    args = (tex, torch.from_numpy(slots), torch.from_numpy(uv),
            torch.from_numpy(hit))
    got = ts.sample_hits_plain(*args)
    before = ts.sample_hits.launches
    wrapped = ts.sample_hits(*args)
    assert ts.sample_hits.launches == before
    for g, gw, w in zip(got, wrapped, want):
        assert torch.equal(g, gw)
        g = g.numpy()
        close(g[..., hit], w[..., hit])
        assert not g[..., ~hit].any()
    assert got[0].shape == (3, NB, 128) and got[1].shape == (NB, 128)
    assert hit.any() == (hit_frac > 0) and hit.all() == (hit_frac == 1)


def _misaligned(tex):
    """The heap moved one byte into a fresh buffer: u8[N,48], contiguous,
    not 16-byte aligned."""
    t = tex.texels_tri
    buf = torch.zeros(t.numel() + 16, dtype=torch.uint8)
    start = (16 - buf.data_ptr() % 16) % 16 + 1
    moved = buf[start:start + t.numel()].view(t.shape)
    moved.copy_(t)
    return tex._replace(texels_tri=moved)


BAD_INPUTS = {
    "slot_dtype": lambda tex, s, uv, h: (tex, s.long(), uv, h),
    "slot_shape": lambda tex, s, uv, h: (tex, s.reshape(-1, 64), uv, h),
    "uv_dtype": lambda tex, s, uv, h: (tex, s, uv.double(), h),
    "uv_shape": lambda tex, s, uv, h: (tex, s, uv[:1], h),
    "hit_dtype": lambda tex, s, uv, h: (tex, s, uv, h.to(torch.uint8)),
    "hit_shape": lambda tex, s, uv, h: (tex, s, uv, h[:1]),
    "heap_dtype": lambda tex, s, uv, h: (
        tex._replace(texels_tri=tex.texels_tri.float()), s, uv, h),
    "heap_misaligned": lambda tex, s, uv, h: (_misaligned(tex), s, uv, h),
    "level_dtype": lambda tex, s, uv, h: (
        tex._replace(level_width=tex.level_width.long()), s, uv, h),
    "device": lambda tex, s, uv, h: (tex, s.to("meta"), uv.to("meta"),
                                     h.to("meta")),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_sample_hits_refuses_inputs_it_does_not_take(rng, heap, bad):
    """A wrong dtype or shape of the slots, uvs, mask, heap or level
    tables, a heap not 16-byte aligned, or tensors on neither the CPU
    nor a card: ValueError before any sample, no launch counted, no
    lanes recorded."""
    slots, uv = sample_inputs(rng, heap)
    hit = rng.random(slots.shape) < 0.5
    args = BAD_INPUTS[bad](heap_tex(heap), torch.from_numpy(slots),
                           torch.from_numpy(uv), torch.from_numpy(hit))
    if bad == "heap_misaligned":
        assert args[0].texels_tri.is_contiguous()
        assert args[0].texels_tri.data_ptr() % 16
    before = ts.sample_hits.launches
    with tracing.on(), tracing.record() as table:
        with pytest.raises(ValueError, match="sample_hits"):
            ts.sample_hits(*args)
    assert ts.sample_hits.launches == before and table.lanes == []


@pytest.fixture(scope="module")
def small_renderers():
    model = procedural_model("small", seed=0)
    cfgs = {"config4": TC.config4_flythrough(),
            "config5_refit": TC.config5_stress()}
    return {name: te.Renderer(model, dataclasses.replace(cfg, width=32,
                                                         height=24),
                              "cpu", quantize=True, rebuild="refit")
            for name, cfg in cfgs.items()}


def traced_sample_frame(r):
    """One frame of `r` from the start pose through frame_body with
    tracing on and the engine's sample_hits recorded: (hit lanes per
    call, lanes per call, the counters, the span table)."""
    cam = Camera(r.cfg.width, r.cfg.height)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    m = np.eye(4, dtype=np.float32) if r.cfg.rebuild_per_frame else None
    x = torch.from_numpy(r.frame_inputs(cam, m))
    hits, lanes = [], []
    inner = te.sample_hits

    def recorded(tex, slot_ids, uv, hit):
        hits.append(int(hit.sum()))
        lanes.append(hit.numel())
        return inner(tex, slot_ids, uv, hit)

    tracing.reset()
    te.sample_hits = recorded
    try:
        with tracing.on(), tracing.record() as table:
            r.frame_body(x, m is not None)
            counts = tracing.counters("cpu")
    finally:
        te.sample_hits = inner
    return hits, lanes, counts, table


@pytest.mark.parametrize("name", ["config4", "config5_refit"])
def test_sample_fetch_counters_are_the_hit_lanes(small_renderers, name):
    """Traced, sample_fetch_d{d} is the lanes that hit at depth d (whose
    heap row kernel K reads), by a recount of the mask the engine hands
    sample_hits, once a depth; at depth 0 most lanes hit; sample_hits
    records the whole wavefront's lanes in each sample_d{d}."""
    r = small_renderers[name]
    hits, lanes, counts, table = traced_sample_frame(r)
    depth = r.cfg.max_depth
    assert len(hits) == depth
    assert [counts[f"sample_fetch_d{d}"] for d in range(depth)] == hits
    assert hits[0] > 0.5 * r.cfg.width * r.cfg.height
    assert all(h <= counts[f"live_closest_d{d}"] for d, h in enumerate(hits))
    assert [x for x in table.lanes if x[0] == "sample_hits"] == [
        ("sample_hits", f"sample_d{d}", n) for d, n in enumerate(lanes)]


def test_sample_fetch_share_reads_a_traced_frame(small_renderers,
                                                 monkeypatch):
    """bench_torch's sample_fetch_share over two replays of a traced CPU
    frame's counters and span table: the hit lanes over sample_hits'
    lanes in %; None for a program without the counters (as the parent
    of kernel K) and without a traced window."""
    monkeypatch.syspath_prepend(str(BENCH))
    monkeypatch.syspath_prepend(str(BENCH / "metrics"))
    import sample_fetch_share
    import spans_window
    hits, lanes, counts, table = traced_sample_frame(
        small_renderers["config5_refit"])
    win = SimpleNamespace(counters={k: 2 * v for k, v in counts.items()},
                          lanes=table.lanes, n=2)
    monkeypatch.setattr(spans_window, "window", lambda run: win)
    assert sample_fetch_share.read(None) == pytest.approx(
        100.0 * sum(hits) / sum(lanes))
    win.counters = {k: v for k, v in win.counters.items()
                    if not k.startswith("sample_fetch_d")}
    win.lanes = [x for x in table.lanes if x[0] != "sample_hits"]
    assert sample_fetch_share.read(None) is None
    monkeypatch.setattr(spans_window, "window", lambda run: None)
    assert sample_fetch_share.read(None) is None


# --- kernel L's plain versions: the engine's shading steps ----------------

def shade_wavefront(rng, nl, live=0.8, hits=0.7):
    """A random depth's shading inputs on NB x 128 lanes (numpy): the
    trace's outputs (active, hitm, u, v, attrs with integer material
    rows), the sample (base, metallic with a third of the lanes over the
    reflection threshold, map_n), the carry (origins, dirs, attenuation,
    accum, ray_count), `nl` lights and random blocked masks."""
    shape = (NB, 128)
    attrs = rng.normal(size=(36, *shape)).astype(np.float32)
    attrs[0:9] *= 6.0
    attrs[33:36] = rng.integers(0, 5, (3, *shape))
    u = rng.uniform(0, 0.5, shape).astype(np.float32)
    v = rng.uniform(0, 0.5, shape).astype(np.float32)
    active = rng.random(shape) < live
    if 0 < live < 1:
        active[1] = False                           # an all-dead row
    d = rng.normal(size=(3, *shape)).astype(np.float32)
    return dict(
        active=active, hitm=rng.random(shape) < hits, u=u, v=v, attrs=attrs,
        base=rng.uniform(0, 1, (3, *shape)).astype(np.float32),
        metallic=rng.uniform(0, 0.3, shape).astype(np.float32),
        map_n=rng.uniform(0, 1, (3, *shape)).astype(np.float32),
        origins=rng.normal(size=(3, *shape)).astype(np.float32),
        dirs=(d / np.linalg.norm(d, axis=0)).astype(np.float32),
        attenuation=rng.uniform(0.05, 1, shape).astype(np.float32),
        accum=rng.uniform(0, 2, (3, *shape)).astype(np.float32),
        ray_count=rng.integers(0, 5, shape).astype(np.int32),
        lights=C.LIGHT_POSITIONS[:nl].astype(np.float32),
        occ=rng.random((nl, *shape)) < 0.4)


def torch_inputs(w):
    return {k: torch.from_numpy(np.array(x)) for k, x in w.items()}


def present_shade(w, shadows, reflections, flat=False):
    """The engine's shading of one depth as it ran before kernel L (the
    operations of wavefront_rounds between the trace and the next depth,
    with the shadow trace's masks given): (pos, uv, slot, hit, pn, casts,
    sd, st, accum, ray_count, origins, dirs, attenuation, active)."""
    active, hitm, lights, occ = w["active"], w["hitm"], w["lights"], w["occ"]
    attenuation, dirs = w["attenuation"], w["dirs"]
    shape = active.shape
    dcount = active.to(torch.float32)
    hit = hitm & active
    miss = active & ~hitm
    dacc = torch.stack([torch.where(miss, float(c), 0.0)
                        for c in TC.SKY_COLOR])
    pos, normal, uv, tangent, mat_ids = tsh.interpolate(w["attrs"], w["u"],
                                                        w["v"])
    base, metallic = w["base"], w["metallic"]
    if flat:
        accum = w["accum"] + dacc + torch.where(hit[None], base, 0.0)
        return dict(pos=pos, uv=uv, slot=mat_ids[0], hit=hit, accum=accum,
                    ray_count=w["ray_count"] + dcount.to(torch.int32))
    pn = tsh.perturbed_normal(normal, tangent, w["map_n"])
    nl = lights.shape[0]
    geo = [tsh.light_geometry(pos, lights[li]) for li in range(nl)]
    ndotls = [tl.dot3(pn, g[0]) for g in geo]
    casts = [hit & (nd > 0) for nd in ndotls]
    sd = torch.stack([-g[0] for g in geo]) if nl else None
    st = torch.stack([torch.where(c, g[1] - TC.RAY_TMIN, 0.0)
                      for c, g in zip(casts, geo)]) if nl else None
    total_light = torch.zeros(shape)
    if shadows:
        for c in casts:
            dcount = dcount + c.to(torch.float32)
    if reflections:
        reflective = hit & (metallic > TC.METALLIC_THRESHOLD)
        new_att = attenuation * (TC.REFLECT_SCALE * metallic)
        att_updated = torch.where(reflective, new_att, attenuation)
    else:
        reflective = torch.zeros_like(hit)
        att_updated = attenuation
    for li in range(nl):
        diffuse = torch.clamp(ndotls[li], 0.0, 1.0)
        mult = torch.ones(shape)
        if shadows:
            cast = hit & (ndotls[li] > 0)
            mult = torch.where(cast & occ[li], TC.SHADOW_MULTIPLIER, 1.0)
        total_light = total_light + diffuse * geo[li][2] * mult
    hit_value = base * (total_light * attenuation)[None] + base * TC.AMBIENT
    if reflections:
        hit_value = torch.where(reflective[None],
                                hit_value * (1.0 - att_updated)[None],
                                hit_value)
    dacc = dacc + torch.where(hit[None], hit_value, 0.0)
    return dict(pos=pos, uv=uv, slot=mat_ids[0], hit=hit, pn=pn, casts=casts,
                sd=sd, st=st, accum=w["accum"] + dacc, dacc=dacc,
                dcount=dcount,
                ray_count=w["ray_count"] + dcount.to(torch.int32),
                origins=tl.where3(reflective, pos, w["origins"]),
                dirs=tl.where3(reflective, tsh.reflect(dirs, pn), dirs),
                attenuation=att_updated, active=reflective)


def plain_shade(w, shadows, reflections, partitioned=False, flat=False):
    """The same depth through kernel L's three plain versions (on copies
    of the carry, which shade_combine updates in place)."""
    carry = {k: w[k].clone() for k in ("active", "origins", "dirs",
                                       "attenuation", "accum", "ray_count")}
    pos, uv, slot, hit = tsh.shade_interp_plain(w["active"], w["hitm"],
                                                w["u"], w["v"], w["attrs"])
    out = dict(pos=pos, uv=uv, slot=slot, hit=hit)
    if flat:
        tsh.shade_combine_plain(carry["active"], w["hitm"], w["base"], None,
                                None, None, None, None, None, None, None,
                                carry["accum"], carry["ray_count"],
                                flat=True)
        return {**out, **carry}
    lights = w["lights"] if shadows else None
    pn, castmask, sd, st = tsh.shade_lights_plain(
        hit, w["u"], w["v"], w["attrs"], w["map_n"], pos, lights)
    out.update(pn=pn, castmask=castmask, sd=sd, st=st)
    acc = (None, None) if partitioned else (carry["accum"],
                                            carry["ray_count"])
    res = tsh.shade_combine_plain(
        carry["active"], w["hitm"], w["base"], w["metallic"], pn, pos,
        w["lights"], w["occ"] if shadows else None, carry["origins"],
        carry["dirs"], carry["attenuation"], *acc, reflections)
    if partitioned:
        out.update(dacc=res[0], dcount=res[1])
    return {**out, **carry}


SHADE_CASES = {
    "lights4": dict(nl=4), "lights1": dict(nl=1), "lights0": dict(nl=0),
    "no_shadows": dict(nl=4, shadows=False),
    "no_reflections": dict(nl=4, reflections=False),
    "partitioned": dict(nl=4, partitioned=True),
    "all_dead": dict(nl=4, live=0.0), "all_miss": dict(nl=4, hits=0.0),
    "all_hit": dict(nl=4, live=1.0, hits=1.0),
    "flat": dict(nl=0, flat=True)}


@pytest.mark.parametrize("case", sorted(SHADE_CASES))
def test_shade_plain_equals_the_engines_former_sequence(rng, case):
    """Kernel L's plain versions chained as the engine chains them give
    what the engine's former operation sequence gave, bit for bit: the
    carry, colour and ray count on every lane (or the returned colour and
    count, 0 on lanes not live, in the lane-sorted iteration), the casts
    (castmask's bits) on every lane, and the position, uv, slot, normal
    and shadow segments on the lanes that hit (0 there elsewhere; st and
    the casts are 0 off the hits either way); at 0, 1 and 4 lights,
    without shadows or reflections, flat albedo, and all-dead, all-miss
    and all-hit wavefronts."""
    kw = dict(SHADE_CASES[case])
    nl = kw.pop("nl")
    shadows = kw.pop("shadows", True) and nl > 0
    reflections = kw.pop("reflections", True)
    partitioned = kw.pop("partitioned", False)
    flat = kw.pop("flat", False)
    w = torch_inputs(shade_wavefront(rng, nl, **kw))
    want = present_shade(w, shadows, reflections, flat)
    got = plain_shade(w, shadows, reflections, partitioned, flat)
    hit = want["hit"]
    assert torch.equal(got["hit"], hit)
    for k in ("pos", "uv", "slot") + (() if flat else ("pn",)):
        g, wv = got[k], want[k]
        assert torch.equal(g[..., hit], wv[..., hit]), k
        assert not g[..., ~hit].any(), k
    live = w["active"]
    carry = ("accum", "ray_count") + (() if flat else (
        "origins", "dirs", "attenuation", "active"))
    for k in carry:
        if partitioned and k in ("accum", "ray_count"):
            assert torch.equal(got[k], w[k]), k       # left as they were
        else:
            assert torch.equal(got[k], want[k]), k
    if partitioned:
        assert torch.equal(got["dacc"][:, live], want["dacc"][:, live])
        assert torch.equal(got["dcount"][live], want["dcount"][live])
        assert not got["dacc"][:, ~live].any()
        assert not got["dcount"][~live].any()
    if shadows:
        assert torch.equal(tsh.cast_bits(got["castmask"], nl),
                           torch.stack(want["casts"]))
        assert torch.equal(got["st"], want["st"])
        assert torch.equal(got["sd"][..., hit], want["sd"][..., hit])
    elif not flat:
        assert got["castmask"] is None and got["sd"] is None
    if case == "all_dead":
        assert not live.any()
    elif case == "all_miss":
        assert live.any() and not hit.any()
    elif case == "all_hit":
        assert hit.all()


def test_shade_plain_matches_jax_on_a_random_wavefront(rng):
    """The three plain versions against the JAX package's shading of the
    same depth (vkrt_tpu/shade/shading.py and the combine of
    vkrt_tpu/wavefront/engine.py:700-736, written out here in jnp), 4
    lights with shadows and reflections: within atol 1e-6 (rtol 1e-6)."""
    wn = shade_wavefront(rng, 4)
    got = plain_shade(torch_inputs(wn), True, True)
    j = {k: jnp.asarray(x) for k, x in wn.items()}
    hit = j["hitm"] & j["active"]
    miss = j["active"] & ~j["hitm"]
    pos, normal, uv, tangent, mat = jsh.interpolate(j["attrs"], j["u"],
                                                    j["v"])
    pn = jsh.perturbed_normal(normal, tangent, j["map_n"])
    geo = [jsh.light_geometry(pos, j["lights"][li]) for li in range(4)]
    nds = [jl.dot3(pn, g[0]) for g in geo]
    dcount = j["active"].astype(jnp.float32)
    for nd in nds:
        dcount = dcount + (hit & (nd > 0)).astype(jnp.float32)
    refl = hit & (j["metallic"] > C.METALLIC_THRESHOLD)
    att = jnp.where(refl, j["attenuation"] * (C.REFLECT_SCALE
                                              * j["metallic"]),
                    j["attenuation"])
    total = jnp.zeros(hit.shape, jnp.float32)
    for li, nd in enumerate(nds):
        mult = jnp.where(hit & (nd > 0) & j["occ"][li], C.SHADOW_MULTIPLIER,
                         1.0)
        total = total + jnp.clip(nd, 0.0, 1.0) * geo[li][2] * mult
    hv = j["base"] * (total * j["attenuation"])[None] + j["base"] * C.AMBIENT
    hv = jnp.where(refl[None], hv * (1.0 - att)[None], hv)
    dacc = jnp.stack([jnp.where(miss, c, 0.0) for c in C.SKY_COLOR])
    dacc = dacc + jnp.where(hit[None], hv, 0.0)
    want = dict(accum=j["accum"] + dacc,
                ray_count=j["ray_count"] + dcount.astype(jnp.int32),
                origins=jl.where3(refl, pos, j["origins"]),
                dirs=jl.where3(refl, jsh.reflect(j["dirs"], pn), j["dirs"]),
                attenuation=att, active=refl)
    for k, wv in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(wv),
                                   rtol=1e-6, atol=ATOL, err_msg=k)
    h = np.asarray(hit)
    for k, wv in (("pos", pos), ("uv", uv), ("slot", mat[0]), ("pn", pn)):
        np.testing.assert_allclose(np.asarray(got[k])[..., h],
                                   np.asarray(wv)[..., h], rtol=1e-6,
                                   atol=ATOL, err_msg=k)


def _shade_call(which, w):
    """(wrapper, its arguments) for one step on a wavefront's tensors."""
    if which == "interp":
        return tsh.shade_interp, [w["active"], w["hitm"], w["u"], w["v"],
                                  w["attrs"]]
    if which == "lights":
        return tsh.shade_lights, [w["hitm"] & w["active"], w["u"], w["v"],
                                  w["attrs"], w["map_n"], w["origins"],
                                  w["lights"]]
    return tsh.shade_combine, [w["active"], w["hitm"], w["base"],
                               w["metallic"], w["map_n"], w["dirs"] * 2.0,
                               w["lights"], w["occ"], w["origins"],
                               w["dirs"], w["attenuation"], w["accum"],
                               w["ray_count"]]


SHADE_BAD = {
    "interp-mask_dtype": ("interp", 0, lambda t: t.to(torch.uint8)),
    "interp-mask_shape": ("interp", 0, lambda t: t.reshape(-1, 64)),
    "interp-u_dtype": ("interp", 2, lambda t: t.double()),
    "interp-attrs_rows": ("interp", 4, lambda t: t[:33]),
    "interp-device": ("interp", 1, lambda t: t.to("meta")),
    "lights-no_light": ("lights", 6, lambda t: t[:0]),
    "lights-five_lights": ("lights", 6, lambda t: torch.cat([t, t[:1]])),
    "lights-map_shape": ("lights", 4, lambda t: t[:2]),
    "combine-occ_lights": ("combine", 7, lambda t: t[:2]),
    "combine-ray_count_dtype": ("combine", 12, lambda t: t.long()),
    "combine-carry_strided": ("combine", 9,
                              lambda t: t.transpose(1, 2).contiguous()
                              .transpose(1, 2)),
    "combine-metallic_shape": ("combine", 3, lambda t: t[None]),
}


@pytest.mark.parametrize("bad", sorted(SHADE_BAD))
def test_shade_wrappers_refuse_inputs_they_do_not_take(rng, bad):
    """A wrong dtype or shape of a mask, the trace's outputs, the
    sample's, the lights (none where shadows are asked, or five), the
    blocked masks or the carry, a carry not contiguous (it is written in
    place), or tensors on neither the CPU nor a card: ValueError before
    any work, no launch counted, no lanes recorded."""
    which, k, spoil = SHADE_BAD[bad]
    fn, args = _shade_call(which, torch_inputs(shade_wavefront(rng, 4)))
    args[k] = spoil(args[k])
    before = fn.launches
    with tracing.on(), tracing.record() as table:
        with pytest.raises(ValueError, match=f"shade_{which}"):
            fn(*args)
    assert fn.launches == before and table.lanes == []


def test_shade_wrappers_on_the_cpu_are_the_plain_versions(rng):
    """On CPU tensors each wrapper returns its plain version's bits,
    counts no launch and records its lanes as shade_hits."""
    w = torch_inputs(shade_wavefront(rng, 4))
    calls = []
    for which in ("interp", "lights", "combine"):
        fn, args = _shade_call(which, w)
        plain = getattr(tsh, f"shade_{which}_plain")
        a2 = [x.clone() if torch.is_tensor(x) else x for x in args]
        before = fn.launches
        with tracing.on(), tracing.record() as table:
            got = fn(*args)
        want = plain(*a2)
        assert fn.launches == before
        assert [(x[0], x[2]) for x in table.lanes] == [("shade_hits",
                                                        NB * 128)]
        for g, wv in zip(got or (), want or ()):
            assert (g is None and wv is None) or torch.equal(g, wv)
        for x, y in zip(args, a2):                    # what it updated
            assert not torch.is_tensor(x) or torch.equal(x, y)
        calls.append(which)
    assert calls == ["interp", "lights", "combine"]
