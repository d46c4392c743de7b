"""The benchmark's `c5-refit-fly` cell on the CPU, and what it reads of
the port: config 5's per-frame refit (`Renderer(rebuild="refit")`, the
CLI's default `--rebuild refit`), its span `accel_refit`, and the refit's
roofline count (bench_torch/rooflines.py) with its metric
`accel_refit_roofline_share`.

The cell runs at 64x32 on the small scene with its own limits and
settings, cut as tests/test_torch_morton_cells.py cuts its cells: a
sound window is correct, a broken timed path and the TF32 control are
not (the window and the comparison are run.py's and calibrate.py's, on
one program built for the file). Refit frames under the `fly_sway`
transforms are held to the plain reference (bench_torch/reference.py),
which builds a fresh tree of each moved scene, within the cell's limits.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.tracing import Span
from vkrt_tpu_torch.wavefront import engine

from test_torch_morton_cells import (BENCH, ROOT, SEED,  # noqa: F401
                                     bench_tiny_cell, tiny_cell)

import check  # noqa: E402
import rooflines  # noqa: E402
import run  # noqa: E402
import scene_gen  # noqa: E402
import spec  # noqa: E402
from faults import flipped, half, stale  # noqa: E402
import torch_support  # noqa: E402,F401

CELL = "c5-refit-fly"
WINDOW_S = 1.5


def test_tiny_cell_is_the_benchmarks_cut(bench_tiny_cell):  # noqa: F811
    """This file's cut-down cell is the benchmark tests' own, and the
    cell runs config5-full's settings but for the update."""
    assert tiny_cell(CELL) == bench_tiny_cell(CELL)
    cell = spec.load(CELL, ROOT)
    full = json.loads((BENCH / "configs" / "config5-full.json").read_text())
    assert cell.config["rebuild"] == "refit"
    for key in ("render", "precision", "scene", "assumed", "reduced"):
        assert cell.config[key] == full[key], key
    assert cell.traffic == spec.load("c5-full-fly", ROOT).traffic
    assert cell.check == spec.load("c5-morton-fly", ROOT).check


@pytest.fixture(scope="module")
def refit_cell():
    """c5-refit-fly at 64x32: the cell, the small scene, and the program
    as run.py sets it up (the port's Renderer(rebuild="refit") through
    the cell's entry, warm frames run)."""
    cell = tiny_cell(CELL)
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = run.setup(cell, scene, "cpu", SEED)
    return cell, scene, state


def _window_verdict(refit_cell, fault):
    """run.py's timed window (calibrate.py's way, on the module's program)
    with `fault` planted, and whether check.py finds it correct."""
    cell, scene, state = refit_cell
    fn = fault(state.entry.frame) if fault else None
    win = run.window(state, WINDOW_S, SEED, fn)
    numbers, frames = run.compare(state, scene, win, SEED)
    assert win.submitted == win.frames and frames
    return check.verdict(numbers, cell.check["limits"]), frames


def test_sound_run_is_correct(refit_cell):
    ok, _ = _window_verdict(refit_cell, None)
    assert ok


@pytest.mark.parametrize("fault", [stale, half, flipped],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_broken_timed_path_is_not_correct(refit_cell, fault):
    ok, frames = _window_verdict(refit_cell, fault)
    assert not ok, frames


def test_control_is_not_correct():
    """The reference at TF32 in the program's place fails the limits
    (run.reference_frames reads only the cell and its frames of the
    state, so no program is built)."""
    cell = tiny_cell(CELL)
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = SimpleNamespace(cell=cell, frames=run.frames_of(cell, 7),
                            base=0, device="cpu")
    idx = [0, 17]
    ref = {i: r for i, *r in run.reference_frames(state, scene, idx)}
    ctl = [check.compare(fb, n, *ref[i]) for i, fb, n, _ in
           run.reference_frames(state, scene, idx, tf32=True)]
    assert not check.verdict(check.worst(ctl), cell.check["limits"])


@pytest.mark.parametrize("k", [0, 60, 120, 180])
def test_refit_frames_match_the_reference(refit_cell, k):
    """The refitted frame under the fly_sway transform of path frame k
    against the plain reference, which builds its own tree of the moved
    scene: within c5-refit-fly's limits, ray counts within
    rays_rel_gap."""
    cell, scene, state = refit_cell
    assert state.entry.program.rebuild == "refit"
    pose, m = run.frames_of(cell, SEED).at(k)
    fb, rays = state.entry.frame(pose, m)
    (ref,) = spec.entry(cell).reference_frames(scene, cell.config,
                                               [(pose, m)], "cpu")
    numbers = check.compare(fb.numpy(), int(rays), *ref)
    assert check.verdict(numbers, cell.check["limits"]), numbers
    assert numbers["rays_rel_gap"] <= cell.check["limits"]["rays_rel_gap"]


@pytest.mark.parametrize("mode", engine.REBUILD_MODES)
def test_only_a_refit_frame_holds_accel_refit(refit_cell, mode):
    """A traced frame with an accel update: a refit's `accel_update`
    holds exactly one `accel_refit`, which holds nothing; a full or
    Morton rebuild's holds none. The traced frame is the untraced
    frame's bits."""
    cell, _, state = refit_cell
    cfg = dataclasses.replace(C.config5_stress(), width=16, height=8,
                              max_depth=1)
    r = engine.Renderer(state.entry.program.model, cfg, "cpu",
                        quantize=True, rebuild=mode)
    pose, m = run.frames_of(cell, SEED).at(60)
    x = torch.from_numpy(r.frame_inputs(pose, m))
    plain = r.frame_body(x, True)
    tracing.reset()
    with tracing.on(), tracing.record() as table:
        traced = r.frame_body(x, True)
    tracing.reset()
    opened = [(s, p) for s, p, o in table.spans if o]
    refits = [p for s, p in opened if s == "accel_refit"]
    assert refits == (["accel_update"] if mode == "refit" else [])
    assert "accel_refit" not in {p for _, p in opened}
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def hand_count(clusters, superclusters):
    """The refit's bytes and operations, counted column by column."""
    moved = list(range(0, 18)) + list(range(24, 33))  # v0 e1 e2 n0-2 t0-2
    slot_bytes = len(moved) * 4 + len(moved) * 4 + 4  # read, write, leaf
    cluster_bytes = 8 * 6 * 4 + 6 * 4                 # sub-runs, its box
    slots = clusters * 128
    nbytes = slots * slot_bytes + clusters * cluster_bytes \
        + superclusters * 6 * 4
    slot_ops = 9 * (9 + 6) + 3 + 2 * 3 + 2 * 2 * 3 + 6
    return nbytes, slots * slot_ops + clusters * 9 * 6


def test_roofline_counts_equal_a_hand_count(refit_cell):
    """rooflines.py's refit count on the small scene's set-up tree, and at
    the full scene's layout (2,112 clusters, 33 superclusters): 220 bytes
    a slot, 216 a cluster, 24 a supercluster; the bound is the bytes'."""
    tree = refit_cell[2].entry.program.backend.tree
    c1p, k1 = tree.tri_data.shape[:2]
    c2 = tree.cl_boxes.shape[0]
    assert k1 == 128 and c1p == 64 * c2
    assert rooflines.refit_counts(c1p, k1, c2) == hand_count(c1p, c2)
    nbytes, ops = rooflines.refit_counts(2112, 128, 33)
    assert (nbytes, ops) == hand_count(2112, 33)
    assert nbytes == 270336 * 220 + 2112 * 216 + 33 * 24 == 59930904
    assert rooflines.refit_bound_ms(tree) == pytest.approx(
        1e3 * hand_count(c1p, c2)[0] / 3.35e12)
    assert rooflines.bound_ms(nbytes, ops) == pytest.approx(0.0178898, 1e-5)


def _traced_run(tree, refit_ms):
    """A run whose traced window (spans_window.py) holds 4 frames, each
    with an `accel_refit` of `refit_ms` device ms (or none if None)."""
    frames = []
    for k in range(4):
        t = 0.1 + 0.05 * k
        f = [Span("frame", None, t, t + 0.04, 0.0, 0),
             Span("accel_update", "frame", t, t + 0.002, 0.0, 0)]
        if refit_ms is not None:
            f.append(Span("accel_refit", "accel_update", t, t + 0.002,
                          refit_ms, 30))
        frames.append(f + [Span("accel_area", "frame", t + 0.002,
                                t + 0.003, 0.01, 4)])
    program = SimpleNamespace(backend=SimpleNamespace(tree=tree))
    win = SimpleNamespace(frames=frames, n=4)
    return SimpleNamespace(_spans_window=win, trace=object(), cuda=True,
                           state=SimpleNamespace(entry=SimpleNamespace(
                               program=program)))


def test_share_reads_the_span_and_nothing_without_it(refit_cell):
    """accel_refit_roofline_share: the bound over the `accel_refit` span's
    device ms a frame, in %; None where the program leaves no such span
    (a parent without it, a rebuild) or there is no traced window."""
    tree = refit_cell[2].entry.program.backend.tree
    read = spec.reader("accel_refit_roofline_share", BENCH)
    assert read(_traced_run(tree, 0.5)) == pytest.approx(
        100.0 * rooflines.refit_bound_ms(tree) / 0.5)
    assert read(_traced_run(tree, None)) is None
    none = _traced_run(tree, None)
    none._spans_window = None
    assert read(none) is None
