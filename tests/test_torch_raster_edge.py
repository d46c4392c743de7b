"""The port's edge-function rasterizer vs the JAX package's (CPU).

Setup stage: vkrt_tpu_torch.raster.edge.build_raster_setup against
vkrt_tpu.raster.edge.build_raster_setup on the same cluster tree and
camera. Kernel G: its plain version, fed the JAX setup, against the JAX
Pallas kernel in interpret mode. Frames: the port's 64x48 edge frames
against the JAX edge frame and the raster oracle, under the flip gate of
tests/test_raster_edge.py (at most 1% of pixels differ by more than
0.02 — samples on a shared triangle edge may take either triangle —
and every other pixel within 2e-2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import duplicate_triangle
from vkrt_tpu import config as JC
from vkrt_tpu.raster import edge as jedge
from vkrt_tpu.raster import pipeline as jpipe
from vkrt_tpu.wavefront import engine as je
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.golden.raster_oracle import render_golden_raster
from vkrt_tpu_torch.raster import edge as tedge
from vkrt_tpu_torch.raster import pipeline as tpipe
from vkrt_tpu_torch.scene import build_texture_heap, flatten_model
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront import engine as te
import torch_support  # noqa: F401

W, H = 64, 48
FLIP = 0.02            # a pixel "flips" if a channel differs by more
FLIP_SHARE = 0.01      # at most this share of pixels may flip
SLOT_AGREE = 0.995     # plain version vs the JAX kernel, same setup


def cameras(w=W, h=H):
    """The start pose (floor and wall sheets pass behind it, so their
    clusters get full-screen boxes) and a pose close to the z- wall."""
    start = Camera(w, h)
    start.set_position(TC.CAMERA_START_POSITION)
    start.set_rotation(TC.CAMERA_START_ROTATION)
    wall = Camera(w, h)
    wall.set_position((2.0, 3.0, -10.2))
    wall.set_rotation((0.0, 3.0, 0.0))
    return {"start": start, "wall": wall}


def raster_cfg():
    return (dataclasses.replace(TC.reference_config(), width=W, height=H),
            dataclasses.replace(JC.reference_config(), width=W, height=H))


@pytest.fixture(scope="module")
def scene():
    model = procedural_model("small", seed=0)
    flat = flatten_model(model)
    jback = je.make_backend(flat, "dense")
    tback = te.make_backend(flat, "dense", "cpu")
    jtex = je.texture_arrays(model.images, flat)
    ttex = te.texture_arrays(model.images, flat, "cpu")
    return model, flat, jback, tback, jtex, ttex


def both_setups(scene, cam):
    _, _, jback, tback, _, _ = scene
    j = [np.asarray(x) for x in jedge.build_raster_setup(
        jback.tree, jnp.asarray(cam.view_matrix),
        jnp.asarray(cam.projection_matrix), W, H)]
    t = [x.numpy() for x in tedge.build_raster_setup(
        tback.tree, torch.from_numpy(cam.view_matrix),
        torch.from_numpy(cam.projection_matrix), W, H)]
    return j, t


def exact_setup(tree, cam):
    """Columns 0-11 (coefficients and clip z) in float64 with numpy, and
    each triangle's conditioning |det| / (the det's term magnitudes)."""
    td = tree.tri_data.numpy().astype(np.float64)
    wvp = (cam.projection_matrix.astype(np.float64)
           @ cam.view_matrix.astype(np.float64))
    v0 = td[..., 0:3]
    X, Y, Wc, Z = [], [], [], []
    for p in (v0, v0 + td[..., 3:6], v0 + td[..., 6:9]):
        clip = p @ wvp[:, :3].T + wvp[:, 3]
        X.append((0.5 * clip[..., 0] + 0.5 * clip[..., 3]) * W)
        Y.append((0.5 * clip[..., 1] + 0.5 * clip[..., 3]) * H)
        Z.append(clip[..., 2])
        Wc.append(clip[..., 3])
    cols, terms = [], 0.0
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        cols += [Y[j] * Wc[k] - Y[k] * Wc[j], X[k] * Wc[j] - X[j] * Wc[k],
                 X[j] * Y[k] - X[k] * Y[j]]
        terms = terms + np.abs(X[i]) * (np.abs(Y[j] * Wc[k])
                                        + np.abs(Y[k] * Wc[j]))
    det = X[0] * cols[0] + X[1] * cols[3] + X[2] * cols[6]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.stack([c / det for c in cols] + Z, axis=-1)
        return out, np.abs(det) / terms


@pytest.mark.parametrize("pose", ["start", "wall"])
def test_setup_columns_match_jax(scene, pose):
    """Columns 0-18 of the port's setup against float64 and against the
    JAX package's. The cofactors and det cancel by 1/c, c = |det| / its
    terms' magnitudes, so a float32 setup (the JAX package's) carries a
    relative error of about eps/c; the port computes in float64 and
    rounds. So: coefficients and clip z (0-11) equal the float64 values
    rounded to float32 (to 2 ulps); JAX's agree to 4e-6 + 4e-7/c of
    their triangle's largest coefficient (measured: 2e-6 at c >= 0.1,
    1.1e-3 at c < 1e-4); uvs and material (12-18) equal JAX's; the same
    triangles are culled; column 19 is the port's zero pad."""
    (jsetup, _, _), (tsetup, _, _) = both_setups(scene, cameras()[pose])
    assert tsetup.shape == jsetup.shape[:2] + (tedge.SETUP_W,)
    live = tsetup[..., :9].any(-1)
    np.testing.assert_array_equal(live, jsetup[..., :9].any(-1))
    assert live.sum() > 1000                    # of the 2,000 triangles
    np.testing.assert_array_equal(tsetup[..., 12:19], jsetup[..., 12:19])
    assert not tsetup[..., tedge.N_SETUP:].any()
    exact, cond = exact_setup(scene[3].tree, cameras()[pose])
    t, e = tsetup[live][:, :12], exact[live]
    scale = np.abs(e[:, :9]).max(-1, keepdims=True)
    np.testing.assert_allclose(t, e, rtol=2.5e-7, atol=0)
    j = jsetup[live][:, :9]
    err = np.abs(j - t[:, :9]).max(-1) / scale[:, 0]
    assert (err <= 4e-6 + 4e-7 / cond[live]).all()
    np.testing.assert_allclose(jsetup[live][:, 9:12], t[:, 9:12],
                               rtol=1e-5, atol=1e-6)


def w_classes(tree, cam):
    """Per triangle of the tree ([C1p, 128] bool each), from the corners'
    clip w in float64: valid; crossing (a corner at w <= 1e-9, but not
    all three at w <= 0); behind (all three corners at w <= 0)."""
    td = tree.tri_data.numpy().astype(np.float64)
    wrow = (cam.projection_matrix.astype(np.float64)
            @ cam.view_matrix.astype(np.float64))[3]
    v0 = td[..., 0:3]
    ws = [p @ wrow[:3] + wrow[3]
          for p in (v0, v0 + td[..., 3:6], v0 + td[..., 6:9])]
    valid = td[..., 0:9].any(-1)
    near = valid & ((ws[0] <= 1e-9) | (ws[1] <= 1e-9) | (ws[2] <= 1e-9))
    behind = valid & (ws[0] <= 0) & (ws[1] <= 0) & (ws[2] <= 0)
    return valid, near & ~behind, behind


def box_classes(clb):
    """(full-screen, empty) per cluster id, from clb [n_sc, 8, 64]."""
    big = np.float32(1e8)
    box = np.moveaxis(clb, 1, 0).reshape(8, -1)
    return (box[0] == -big) & (box[3] == big), box[0] == big


@pytest.mark.parametrize("pose", ["start", "wall"])
def test_screen_boxes_match_jax(scene, pose):
    """scb and clb, full-screen and empty boxes included. The port's
    full-screen clusters are the JAX package's less those with no
    triangle crossing w = 0 (a triangle wholly behind the camera bounds
    nothing in the port); a cluster of nothing but such triangles is
    empty in the port. Where both give a cluster the same kind of box:
    the boxes are the corners divided by w, in float64 in the port and
    float32 (with FMAs) in the JAX package: x, y to 1e-6 relative plus
    1e-4 pixel, zmax to 1e-6 relative; the port's zmin lies below the JAX
    package's (its pad for kernel G's depth error, measured here: at most
    0.03); the padding rows 6-7 are 0. A supercluster's box is compared
    where all of its clusters are of the same kind in both, and lies
    inside the JAX package's otherwise."""
    cam = cameras()[pose]
    (_, jscb, jclb), (_, tscb, tclb) = both_setups(scene, cam)
    assert tscb.shape == jscb.shape and tclb.shape == jclb.shape
    valid, crossing, behind = w_classes(scene[3].tree, cam)
    jfull, jempty = box_classes(jclb)
    full, empty = box_classes(tclb)
    assert full.any(), "the pose should put some sheet across w = 0"
    np.testing.assert_array_equal(full, jfull & crossing.any(1))
    np.testing.assert_array_equal(full, crossing.any(1))
    only_behind = valid.any(1) & ~(valid & ~behind).any(1)
    np.testing.assert_array_equal(empty, jempty | only_behind)
    assert (jfull[only_behind]).all()
    if pose == "start":
        assert only_behind.sum() >= 2      # the case is not vacuous
    same = (full == jfull) & (empty == jempty)         # per cluster
    n_sc = tclb.shape[0]
    same_sc = np.zeros(tscb.shape[1], bool)
    same_sc[:n_sc] = same.reshape(n_sc, -1).all(1)
    same_sc[n_sc:] = True                              # padding columns
    tcl = np.moveaxis(tclb, 1, 0).reshape(8, -1)
    jcl = np.moveaxis(jclb, 1, 0).reshape(8, -1)
    for t, j, ok in ((tscb, jscb, same_sc), (tcl, jcl, same)):
        assert ok.any()
        for row in (0, 1, 3, 4):
            np.testing.assert_allclose(t[row][ok], j[row][ok], rtol=1e-6,
                                       atol=1e-4)
        np.testing.assert_allclose(t[5][ok], j[5][ok], rtol=1e-6)
        pad = j[2].astype(np.float64) - t[2]
        assert (pad[ok] >= -1e-6 * np.abs(j[2][ok])).all()
        assert (pad[ok] <= 0.05).all()
        assert not t[6:].any()
        # elsewhere the port's box is the smaller one
        assert (t[:2] >= j[:2] - 1e-4).all() and (t[3:5] <= j[3:5] + 1e-4).all()
    assert (tcl[2][full] == 0).all()


@pytest.mark.parametrize("pose", ["start", "wall"])
def test_clusters_behind_camera_get_empty_boxes(full_tree, pose):
    """On the full scene both poses leave many clusters wholly behind the
    camera (every triangle with all three corners at w <= 0): they get
    the empty, inverted box; a cluster is full-screen exactly when one of
    its triangles crosses w = 0; a cluster that mixes triangles behind
    with triangles in front (none crossing) keeps a bounded box."""
    w, h = 160, 120
    cam = cameras(w, h)[pose]
    _, scb, clb = tedge.build_raster_setup(
        full_tree, torch.from_numpy(cam.view_matrix),
        torch.from_numpy(cam.projection_matrix), w, h)
    valid, crossing, behind = w_classes(full_tree, cam)
    full, empty = box_classes(clb.numpy())
    only_behind = valid.any(1) & ~(valid & ~behind).any(1)
    assert only_behind.sum() > 100
    assert empty[only_behind].all()
    np.testing.assert_array_equal(empty, only_behind | ~valid.any(1))
    np.testing.assert_array_equal(full, crossing.any(1))
    mixed = behind.any(1) & ~only_behind & ~crossing.any(1)
    assert mixed.any()
    box = np.moveaxis(clb.numpy(), 1, 0).reshape(8, -1)
    assert (np.abs(box[:6, mixed]) < 1e7).all()
    assert (box[0, mixed] <= box[3, mixed]).all()
    # the superclusters' boxes hold their clusters' (empty ones aside)
    n_sc = clb.shape[0]
    lo = np.where(empty, np.inf, box[0]).reshape(n_sc, -1).min(1)
    np.testing.assert_array_equal(
        np.where(np.isinf(lo), np.float32(1e8), lo), scb.numpy()[0, :n_sc])


def jax_rule_boxes(tree, cam, scb, clb):
    """(scb, clb) under the JAX package's rule: every cluster holding a
    triangle with any corner at w <= 1e-9, those wholly behind the camera
    included, gets the full-screen box with zmin 0; the superclusters'
    boxes follow."""
    valid, crossing, behind = w_classes(tree, cam)
    unb = torch.from_numpy((crossing | behind).any(1))
    n_sc = clb.shape[0]
    box = clb.permute(1, 0, 2).reshape(8, -1).clone()
    big = 1e8
    for row, value in ((0, -big), (1, -big), (2, 0.0), (3, big), (4, big),
                       (5, big)):
        box[row] = torch.where(unb, torch.tensor(value), box[row])
    clb = box.reshape(8, n_sc, -1).permute(1, 0, 2).contiguous()
    scb = scb.clone()
    scb[0:3, :n_sc] = clb[:, 0:3].amin(dim=2).T
    scb[3:6, :n_sc] = clb[:, 3:6].amax(dim=2).T
    return scb, clb


@pytest.mark.parametrize("which, pose", [("small", "start"),
                                         ("small", "wall"),
                                         ("full", "wall")])
def test_plain_frame_equals_jax_box_rule(scene, full_tree, which, pose):
    """Leaving the triangles wholly behind the camera out of the boxes
    changes no pixel: raster_edge_plain on the port's boxes equals it on
    the boxes of the JAX package's rule (rebuilt here: full-screen for
    any corner at w <= 1e-9) bit for bit, in all five outputs."""
    tree = scene[3].tree if which == "small" else full_tree
    w, h = (W, H) if which == "small" else (80, 60)
    cam = cameras(w, h)[pose]
    setup, scb, clb = tedge.build_raster_setup(
        tree, torch.from_numpy(cam.view_matrix),
        torch.from_numpy(cam.projection_matrix), w, h)
    oscb, oclb = jax_rule_boxes(tree, cam, scb, clb)
    ofull, _ = box_classes(oclb.numpy())
    full, _ = box_classes(clb.numpy())
    assert (ofull | ~full).all()
    if (which, pose) != ("small", "wall"):
        assert ofull.sum() > full.sum()        # the rule did drop clusters
    cfg = dataclasses.replace(TC.reference_config(), width=w, height=h)
    px, py, inside = tpipe.sample_pixel_lanes(cfg, tuple(tpipe.MSAA8[2]),
                                              "cpu")
    zf = torch.where(inside, 0.0, tedge.ZFAR_PARK)
    got = tedge.raster_edge_plain(setup, scb, clb, px, py, zf)
    want = tedge.raster_edge_plain(setup, oscb, oclb, px, py, zf)
    assert (got[1] >= 0).float().mean() > 0.3
    for g, o in zip(got, want):
        assert torch.equal(g, o)


def lane_inputs(cam_cfg, seed=3):
    """Pixel-centre sample positions at 64x48 and a zfloor with 60% of
    the pixels at 0, 25% at a random depth, 15% parked."""
    px, py, _ = tpipe.sample_pixel_lanes(cam_cfg, (0.5, 0.5), "cpu")
    rng = np.random.default_rng(seed)
    r = rng.random(px.shape)
    zf = np.where(r < 0.6, 0.0,
                  np.where(r < 0.85, rng.uniform(0.9, 1.0, px.shape), 1e9))
    return px, py, torch.from_numpy(zf.astype(np.float32))


def plain_vs_jax_kernel(scene, pose):
    """raster_edge_plain fed the JAX setup vs the JAX Pallas kernel
    (interpret) on the same pixels and random depth floors."""
    tcfg, _ = raster_cfg()
    (jsetup, jscb, jclb), _ = both_setups(scene, cameras()[pose])
    px, py, zf = lane_inputs(tcfg)
    want = [np.asarray(x) for x in jedge.raster_edge(
        jnp.asarray(jsetup), jnp.asarray(jscb), jnp.asarray(jclb),
        jnp.asarray(px.numpy()), jnp.asarray(py.numpy()),
        jnp.asarray(zf.numpy()), interpret=True)]
    setup = torch.from_numpy(
        np.pad(jsetup[..., :tedge.N_SETUP], ((0, 0), (0, 0), (0, 1))))
    got = [x.numpy() for x in tedge.raster_edge_plain(
        setup, torch.from_numpy(jscb.copy()), torch.from_numpy(jclb.copy()),
        px, py, zf)]
    z, slot, u, v, mat = got
    jz, jslot, ju, jv, jmat = want
    same = slot == jslot
    hit = slot >= 0
    assert same.mean() >= SLOT_AGREE, same.mean()
    assert 0.2 < hit.mean() < 0.9                   # hits, misses, parked
    assert (slot[zf.numpy() >= 1e9] == -1).all()
    # XLA's FMA contraction of beta and z (see the setup test) moves z
    # and uv by a few ulps of the cancelled terms (measured: z 8e-6
    # relative, uv 1.4e-5 texture units)
    both = same & hit
    np.testing.assert_allclose(z[both], jz[both], rtol=2e-5)
    np.testing.assert_allclose(u[both], ju[both], rtol=2e-5, atol=5e-5)
    np.testing.assert_allclose(v[both], jv[both], rtol=2e-5, atol=5e-5)
    np.testing.assert_array_equal(mat[same], jmat[same])
    assert (z[hit] > zf.numpy()[hit]).all() and (z[hit] <= 1).all()
    assert np.isinf(z[~hit]).all() and (mat[~hit] == 0).all()


def test_plain_matches_jax_kernel(scene):
    plain_vs_jax_kernel(scene, "start")


def test_plain_matches_jax_kernel_wall_pose(scene):
    """The same close to a wall, where sheets cross w = 0."""
    plain_vs_jax_kernel(scene, "wall")


def test_plain_tie_goes_to_lower_slot(scene):
    """The same triangle in two clusters, the copy in the cluster of the
    higher id and the lower zmin (chip_smoke.py's duplicate_triangle):
    every sample that the original wins goes on to return the original's
    slot, and no output changes at all."""
    tcfg, _ = raster_cfg()
    _, (tsetup, tscb, tclb) = both_setups(scene, cameras()["start"])
    setup, scb, clb = (torch.from_numpy(x) for x in (tsetup, tscb, tclb))
    px, py, inside = tpipe.sample_pixel_lanes(tcfg, (0.5, 0.5), "cpu")
    zf = torch.where(inside, 0.0, tedge.ZFAR_PARK)
    want = tedge.raster_edge_plain(setup, scb, clb, px, py, zf)
    full, empty = box_classes(tclb)
    zmin = np.moveaxis(tclb, 1, 0).reshape(8, -1)[2]
    slots, counts = torch.unique(want[1][want[1] >= 0], return_counts=True)
    ok = torch.from_numpy((~full & (zmin > 0))[(slots // 128).numpy()])
    slot = int(slots[ok][counts[ok].argmax()])     # a much-seen triangle
    spare = int(np.nonzero(empty)[0][-1])          # an empty cluster above
    assert spare > slot // 128 and counts[ok].max() >= 8
    dup = duplicate_triangle(setup, scb, clb, slot, spare)
    assert dup[2][spare // 64, 2, spare % 64] < zmin[slot // 128]
    got = tedge.raster_edge_plain(*dup, px, py, zf)
    assert (got[1] == slot).sum() == counts[ok].max()
    assert not (got[1] == spare * 128).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the copy alone does cover those samples: with the original's row
    # zeroed it takes them over, at the same depth
    alone = dup[0].clone()
    alone[slot // 128, slot % 128] = 0.0
    took = tedge.raster_edge_plain(alone, dup[1], dup[2], px, py, zf)
    seen = want[1] == slot
    assert (took[1][seen] == spare * 128).all()
    assert torch.equal(took[0][seen], want[0][seen])


def test_wrapper_on_cpu_runs_plain(scene):
    """A CPU tensor takes the plain version (no launch counted); any
    device other than CPU and CUDA raises, and so do mismatched shapes."""
    tcfg, _ = raster_cfg()
    _, (tsetup, tscb, tclb) = both_setups(scene, cameras()["start"])
    setup, scb, clb = (torch.from_numpy(x) for x in (tsetup, tscb, tclb))
    px, py, zf = lane_inputs(tcfg, seed=4)
    before = tedge.raster_edge.launches
    got = tedge.raster_edge(setup, scb, clb, px, py, zf)
    want = tedge.raster_edge_plain(setup, scb, clb, px, py, zf)
    assert tedge.raster_edge.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="device"):
        tedge.raster_edge(*(x.to("meta") for x in (setup, scb, clb, px,
                                                   py, zf)))
    with pytest.raises(ValueError, match="zfloor"):
        tedge.raster_edge_plain(setup, scb, clb, px, py, zf[:-1])
    with pytest.raises(ValueError, match="one scene"):
        tedge.raster_edge_plain(setup[:-1], scb, clb, px, py, zf)


def flips(fb, want):
    d = np.abs(fb - want).max(axis=-1)
    flipped = d > FLIP
    return flipped.mean(), float(d[~flipped].max())


def port_edge_frame(scene, cam, msaa):
    _, _, _, tback, _, ttex = scene
    tcfg, _ = raster_cfg()
    return tpipe.render_raster_frame_edge(
        tback.tree, ttex, torch.from_numpy(cam.view_matrix),
        torch.from_numpy(cam.projection_matrix), tcfg, msaa=msaa).numpy()


def test_edge_frame_matches_jax_msaa1(scene):
    _, _, jback, _, jtex, _ = scene
    cam = cameras()["start"]
    _, jcfg = raster_cfg()
    want = np.asarray(jpipe.render_raster_frame_edge(
        jback.tree, jtex, jnp.asarray(cam.view_matrix),
        jnp.asarray(cam.projection_matrix), jcfg, msaa=1, interpret=True))
    fb = port_edge_frame(scene, cam, 1)
    assert fb.shape == (H, W, 3) and np.isfinite(fb).all()
    share, rest = flips(fb, want)
    assert share <= FLIP_SHARE and rest <= FLIP, (share, rest)


@pytest.mark.parametrize("msaa", [1, 8])
def test_edge_frame_matches_oracle(scene, msaa):
    model, flat, _, _, _, _ = scene
    cam = cameras()["start"]
    tcfg, _ = raster_cfg()
    fb = port_edge_frame(scene, cam, msaa)
    want = render_golden_raster(flat, build_texture_heap(model.images),
                                cam.proj_inverse, cam.view_inverse, tcfg,
                                msaa=msaa)
    assert fb.shape == (H, W, 3) and np.isfinite(fb).all()
    share, rest = flips(fb, want)
    assert share <= FLIP_SHARE and rest <= FLIP, (share, rest)


@pytest.fixture(scope="module")
def full_tree():
    return te.make_backend(flatten_model(procedural_model("full", seed=0)),
                           "dense", "cpu").tree


def corner_zmin(tree, cam, w, h):
    """Each cluster's least corner z/w in float64 (the JAX package's zmin,
    without rounding) over its live triangles: [C1p]."""
    td = tree.tri_data.numpy().astype(np.float64)
    wvp = (cam.projection_matrix.astype(np.float64)
           @ cam.view_matrix.astype(np.float64))
    v0 = td[..., 0:3]
    z = np.full(td.shape[:2], np.inf)
    for p in (v0, v0 + td[..., 3:6], v0 + td[..., 6:9]):
        clip = p @ wvp[:, :3].T + wvp[:, 3]
        z = np.minimum(z, clip[..., 2] / clip[..., 3])
    return np.where(td[..., 0:9].any(-1), z, np.inf).min(axis=1)


@pytest.mark.parametrize("pose", ["start", "wall"])
def test_cluster_zmin_bounds_its_fragments(full_tree, pose):
    """Kernel G skips a cluster whose zmin is >= the pixel's committed
    depth, so zmin must lie below every depth G computes for the
    cluster's fragments (the plain version's arithmetic, the kernel's bit
    for bit). On the full scene at 160x120, two sample offsets: the
    corners' least z/w (the JAX package's zmin) lies above many fragments
    of small far triangles; the port's padded zmin above none."""
    w, h = 160, 120
    cam = cameras(w, h)[pose]
    setup, _, clb = tedge.build_raster_setup(
        full_tree, torch.from_numpy(cam.view_matrix),
        torch.from_numpy(cam.projection_matrix), w, h)
    box = clb.permute(1, 0, 2).reshape(8, -1)
    bounded = (box[0] > -1e8) & (box[0] < 1e8)
    cols = setup.transpose(1, 2).contiguous()
    exact = torch.from_numpy(corner_zmin(full_tree, cam, w, h))
    cfg = dataclasses.replace(TC.reference_config(), width=w, height=h)
    frags = below_pad = below_corner = 0
    for off in ((0.5, 0.5), tuple(tpipe.MSAA8[3])):
        px, py, inside = tpipe.sample_pixel_lanes(cfg, off, "cpu")
        x = px.reshape(-1)[inside.reshape(-1)]
        y = py.reshape(-1)[inside.reshape(-1)]
        p, c = torch.nonzero(tedge.box_gate(box[0], box[1], box[3], box[4],
                                            x, y) & bounded[None],
                             as_tuple=True)
        for q in range(0, p.numel(), tedge.PAIR_CHUNK):
            pp, cc = p[q:q + tedge.PAIR_CHUNK], c[q:q + tedge.PAIR_CHUNK]
            z, k = tedge._cluster_fragments(cols, cc, x[pp], y[pp],
                                            torch.full(pp.shape, -1.0))
            hit = k < 128
            z, cc = z[hit], cc[hit]
            frags += int(hit.sum())
            below_pad += int((z < box[2][cc]).sum())
            below_corner += int((z.double() < exact[cc]).sum())
    assert frags > 50_000
    assert below_corner > 100
    assert below_pad == 0
