"""The benchmark's `c5-morton-fly` and `c4-mirror` cells on the CPU, and
what they read of the port: config 5's per-frame Morton (LBVH) rebuild
(`Renderer(rebuild="full_morton")`, the CLI's `--rebuild full_morton`),
the update's cluster-area counter `accel_cl_area`, and the benchmark's
`lookat` generator (bench_torch/generators/lookat.py).

The cells run at 64x32 on the small scene with their own limits and
settings, as bench_torch/tests/test_new_cells.py runs the earlier ones:
a sound run is correct, a broken timed path and the TF32 control are
not. Morton frames under the `fly_sway` transforms are held to the plain
reference (bench_torch/reference.py) within c5-morton-fly's limits.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import config as C
from vkrt_tpu_torch import tracing
from vkrt_tpu_torch.app import cli
from vkrt_tpu_torch.wavefront import engine

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import check  # noqa: E402
import importlib.util  # noqa: E402
import run  # noqa: E402
import scene_gen  # noqa: E402
import spec  # noqa: E402
from faults import flipped, half, stale  # noqa: E402
import torch_support  # noqa: E402,F401

CELLS = ["c5-morton-fly", "c4-mirror"]
SEED = 2**31 + 101


def tiny_cell(workload, width=64, height=32):
    """A cell of BENCHMARK.json with its limits, traffic and settings as
    they are, cut to width x height pixels and the small scene: the cut of
    bench_torch/tests/conftest.py's `tiny_cell` fixture, as a function a
    module-scoped fixture can call (test_tiny_cell_is_the_benchmarks_cut
    holds the two equal)."""
    cell = spec.load(workload, ROOT)
    config = json.loads(json.dumps(cell.config))
    config["render"].update(width=width, height=height)
    config["scene"] = {"size": "small", "seed": 0}
    return cell._replace(config=config)


def _bench_conftest():
    where = BENCH / "tests" / "conftest.py"
    spec_ = importlib.util.spec_from_file_location("bench_tests_conftest",
                                                   where)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


bench_tiny_cell = _bench_conftest().tiny_cell     # the fixture, by this name


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_is_the_benchmarks_cut(bench_tiny_cell, workload):
    """This file's cut-down cell is the benchmark tests' own."""
    assert tiny_cell(workload) == bench_tiny_cell(workload)
    assert tiny_cell(workload, 16, 8) == bench_tiny_cell(workload, 16, 8)


def _run(cell, fault):
    return run.run_cell(cell, SEED, 1.5, 0, device="cpu",
                        t_start=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(tiny_cell(workload), None)
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("fault", [stale, half, flipped],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(workload, fault):
    out = _run(tiny_cell(workload), fault)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference at TF32 in the program's place fails the limits
    (run.reference_frames reads only the cell and its frames of the
    state, so no program is built)."""
    cell = tiny_cell(workload)
    scene = scene_gen.make_scene(**cell.config["scene"])
    state = SimpleNamespace(cell=cell, frames=run.frames_of(cell, 7),
                            base=0, device="cpu")
    idx = [0, 17]
    ref = {i: r for i, *r in run.reference_frames(state, scene, idx)}
    ctl = [check.compare(fb, n, *ref[i]) for i, fb, n, _ in
           run.reference_frames(state, scene, idx, tf32=True)]
    assert not check.verdict(check.worst(ctl), cell.check["limits"])


@pytest.fixture(scope="module")
def morton_cell():
    """c5-morton-fly at 64x32: the cell, the small scene, the port's
    Renderer(rebuild="full_morton") as the cell's entry builds it."""
    cell = tiny_cell("c5-morton-fly")
    scene = scene_gen.make_scene(**cell.config["scene"])
    entry = spec.entry(cell).build(run.to_model(scene), cell.config, "cpu")
    return cell, scene, entry


@pytest.mark.parametrize("k", [0, 60, 120, 180])
def test_morton_frames_match_the_reference(morton_cell, k):
    """The Morton-rebuilt frame under the fly_sway transform of path
    frame k against the plain reference, which builds its own tree of
    the moved scene: within c5-morton-fly's limits, ray counts within
    rays_rel_gap."""
    cell, scene, entry = morton_cell
    assert entry.program.rebuild == "full_morton"
    pose, m = run.frames_of(cell, SEED).at(k)
    fb, rays = entry.frame(pose, m)
    (ref,) = spec.entry(cell).reference_frames(scene, cell.config,
                                               [(pose, m)], "cpu")
    numbers = check.compare(fb.numpy(), int(rays), *ref)
    assert check.verdict(numbers, cell.check["limits"]), numbers
    assert numbers["rays_rel_gap"] <= cell.check["limits"]["rays_rel_gap"]


def host_area(cl_boxes) -> int:
    """cluster_area_fixed's sum, in numpy float64 on the host."""
    b = cl_boxes.cpu().numpy().astype(np.float64)
    ext = b[:, 3:6, :] - b[:, 0:3, :]
    ext = np.where((ext >= 0).all(axis=1, keepdims=True), ext, 0.0)
    x, y, z = ext[:, 0], ext[:, 1], ext[:, 2]
    return int(np.round((x * y + y * z + z * x) * (2.0 * 2**16))
               .astype(np.int64).sum())


@pytest.mark.parametrize("mode", engine.REBUILD_MODES)
def test_accel_cl_area_counts_the_updated_tree(morton_cell, mode):
    """A traced frame with an accel update counts `accel_cl_area`: the
    summed surface area of the cluster boxes of the tree update_tree
    returns for its transform, exactly, in every rebuild mode; the
    update alone (what a caller captures apart from the frame) counts
    nothing."""
    _, scene, entry = morton_cell
    cfg = dataclasses.replace(C.config5_stress(), width=16, height=8,
                              max_depth=1)
    r = engine.Renderer(entry.program.model, cfg, "cpu", quantize=True,
                        rebuild=mode)
    m = np.array([[0.98, 0.0, 0.2, 0.3], [0.0, 1.0, 0.0, -0.2],
                  [-0.2, 0.0, 0.98, 0.5], [0.0, 0.0, 0.0, 1.0]],
                 np.float32)
    pose, _ = run.frames_of(tiny_cell("c5-morton-fly"), SEED).at(30)
    x = torch.from_numpy(r.frame_inputs(pose, m))
    tracing.reset()
    with tracing.on():
        r.frame_body(x, True)
        got = tracing.counters()["accel_cl_area"]
        r.update_tree(m)
        assert tracing.counters()["accel_cl_area"] == got
    want = host_area(r.update_tree(m).cl_boxes)
    assert got == want > 0
    tracing.reset()


def test_cli_rebuild_full_morton_reaches_the_renderer(morton_cell,
                                                      monkeypatch,
                                                      tmp_path):
    """`--rebuild full_morton` parses and is the rebuild mode of the
    Renderer the CLI builds, which renders config 5's frames."""
    _, _, entry = morton_cell
    made = []

    class Recorded(engine.Renderer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    args = cli.build_parser().parse_args(["--rebuild", "full_morton"])
    assert args.rebuild == "full_morton"
    monkeypatch.setattr(engine, "Renderer", Recorded)
    assert cli.main(["--config", "5", "--rebuild", "full_morton", "--width",
                     "16", "--height", "8", "--max-depth", "1", "--frames",
                     "2", "--device", "cpu", "--output",
                     str(tmp_path / "m.png")],
                    scene=entry.program.model) == 0
    assert [r.rebuild for r in made] == ["full_morton"]
    assert (tmp_path / "m.png").is_file()


def test_lookat_gives_fly_poses_and_loops_from_frame_zero():
    """A lookat keyframe at the eye and target of the fly mix's first
    path frame gives that frame's Pose bit for bit; the mirror mix loops
    from path frame 0 whatever the seed."""
    fly = spec.module("generators", "fly", BENCH)
    lookat = spec.module("generators", "lookat", BENCH)
    mix = json.loads((BENCH / "traffic" / "fly.json").read_text())
    assert mix["path"][0][0] == "w"
    rot = np.asarray(mix["start_rotation"], np.float32)
    tr = mix["translation_speed"] * float(mix["dt"])
    eye = np.asarray(mix["start_position"], np.float32) \
        + fly._axis(rot, fly.WORLD_FORWARD) * tr
    target = eye + fly._axis(rot, fly.WORLD_FORWARD)
    keyed = {k: mix[k] for k in ("fov", "near", "far", "inflight", "sway")}
    keyed["keyframes"] = [[eye.tolist(), target.tolist(), 3],
                          [(eye + 1.0).tolist(), target.tolist(), 2]]
    want = fly.Frames(mix, 64, 32, 0).at(0)[0]
    got = lookat.Frames(keyed, 64, 32, 0)
    assert len(got) == 5
    for a, b in zip(got.at(0)[0], want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got.at(1)[0].view_inverse,
                              want.view_inverse)
    mirror = json.loads((BENCH / "traffic" / "mirror.json").read_text())
    one, two = (lookat.Frames(mirror, 64, 32, s) for s in (1, SEED))
    assert len(one) == 240 and one(0)[0] == 0 and one(240)[0] == 0
    for i in (0, 7, 239, 240):
        (k1, p1, m1), (k2, p2, m2) = one(i), two(i)
        assert k1 == k2 == i % 240 and m1 is None and m2 is None
        np.testing.assert_array_equal(p1.view_inverse, p2.view_inverse)
