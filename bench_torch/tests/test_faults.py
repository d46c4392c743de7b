"""`correct` comes out false when the timed path is broken underneath,
and for the control, at each cell's own settings and limits cut to a
size the CPU holds (the harness's look for a card is skipped: device
"cpu")."""

import time

import pytest

import check
import run
import scene_gen
from faults import flipped, half, stale

CELLS = ["c4-fly", "c5-full-fly"]


def _run(cell, fault):
    return run.run_cell(cell, 2**31 + 101, 1.5, 0, device="cpu",
                        t_start=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_cell, workload):
    assert _run(tiny_cell(workload), None)["correct"] is True


@pytest.mark.parametrize("fault", [stale, half, flipped],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(tiny_cell, workload, fault):
    out = _run(tiny_cell(workload), fault)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_cell, workload):
    """The reference at TF32 in the program's place fails the limits."""
    cell = tiny_cell(workload, 128, 64)
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = run.setup(cell, scene, "cpu", 7)
    idx = [0, 17]
    ref = {i: r for i, *r in run.reference_frames(state, scene, idx)}
    ctl = [check.compare(fb, n, *ref[i]) for i, fb, n, _ in
           run.reference_frames(state, scene, idx, tf32=True)]
    assert not check.verdict(check.worst(ctl), cell.check["limits"])
