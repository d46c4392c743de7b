"""run.py: no result without a card, nothing from the CPU under a device
metric's name, the result line's keys, and pieces found by name."""

import json
import shutil
import subprocess
import sys
import time

import pytest

import run
import spec
from conftest import BENCH, ROOT


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this test is of its absence")


def test_run_fails_without_a_card():
    _no_card()
    p = subprocess.run([sys.executable, "bench_torch/run.py", "--workload",
                        "c4-fly", "--seed", str(2**31 + 3), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, "bench_torch/run.py", "--workload",
                        "c5-full-fly", "--seed", "9", "--seconds", "1",
                        "--trace", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_cpu_run_reports_no_device_metric(tiny_cell):
    cell = tiny_cell("c4-fly")
    out = run.run_cell(cell, 2**31 + 11, 0.5, 0, device="cpu",
                       t_start=time.perf_counter())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "frames_compared", "check"]
    assert out["metrics"] == {}
    assert out["device"]["platform"] == "cpu"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["check"]) == {"px_off_share", "px_off_shallow",
                                 "px_mean_abs", "rays_rel_gap"}
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)


def test_benchmark_json_names_every_piece():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load(w["name"], ROOT)
        assert cell.chips == 1
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
    names = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "frame_ms", "frame_p95_ms", "mrays_per_s",
            "peak_mem_gb"} == names
    for m in bench["per_layer"]:
        assert m["moves"] == "frame_ms"


def test_an_extra_cell_is_found_from_new_files(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new
    files and entries, none edited."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "cells", "metrics"):
        (tmp_path / d).mkdir()
    cfg = json.loads((BENCH / "configs" / "config4.json").read_text())
    cfg["render"]["max_depth"] = 1
    (tmp_path / "configs" / "config4-d1.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "fly.json").read_text())
    mix["inflight"] = 0
    (tmp_path / "traffic" / "fly-sync.json").write_text(json.dumps(mix))
    (tmp_path / "cells" / "c4d1-sync.json").write_text(json.dumps(
        {"check_frames": 1, "limits": {"px_off_share": 0.01,
                                       "px_off_shallow": 0.01,
                                       "px_mean_abs": 1.0,
                                       "rays_rel_gap": 0.002}}))
    (tmp_path / "metrics" / "frames_per_window.py").write_text(
        "def read(run):\n    return float(run.window.frames)\n")
    bench["configs"].append({"name": "config4-d1", "source": "x",
                             "file": str(tmp_path / "configs" /
                                         "config4-d1.json"),
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "c4d1-sync", "config": "config4-d1",
                               "traffic": "fly-sync", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_per_window", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "frame_ms",
                               "workloads": ["c4d1-sync"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("c4d1-sync", tmp_path, tmp_path)
    assert cell.config["render"]["max_depth"] == 1
    assert cell.traffic["inflight"] == 0
    assert [m["name"] for m in cell.per_layer] == ["frames_per_window"]
    from types import SimpleNamespace
    read = spec.reader("frames_per_window", tmp_path)
    assert read(SimpleNamespace(window=SimpleNamespace(frames=7))) == 7.0


def test_a_new_generator_and_entry_are_found_from_new_files(tmp_path):
    """A mix that needs code of its own names a new generator module, a
    configuration that runs another program names a new entry module:
    both are new files, found by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "cells", "generators", "entries"):
        (tmp_path / d).mkdir()
    cfg = json.loads((BENCH / "configs" / "config4.json").read_text())
    cfg["entry"] = "still"
    (tmp_path / "configs" / "c-still.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "orbit.json").write_text(json.dumps(
        {"generator": "orbit", "inflight": 1, "frames": 5}))
    (tmp_path / "generators" / "orbit.py").write_text(
        "class Frames:\n"
        "    def __init__(self, mix, width, height, seed):\n"
        "        self.n = mix['frames']\n"
        "    def __len__(self):\n"
        "        return self.n\n"
        "    def at(self, k):\n"
        "        return ('pose', k), None\n"
        "    def __call__(self, i):\n"
        "        return (i % self.n, *self.at(i % self.n))\n")
    (tmp_path / "entries" / "still.py").write_text(
        "def build(model, config, device):\n"
        "    return 'built'\n"
        "def reference_frames(scene, config, items, device, tf32=False):\n"
        "    return iter(())\n")
    (tmp_path / "cells" / "still-orbit.json").write_text(json.dumps(
        {"check_frames": 1, "trace_every": 1, "limits": {}}))
    bench["configs"].append({"name": "c-still", "source": "x",
                             "file": str(tmp_path / "configs" /
                                         "c-still.json"),
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "still-orbit", "config": "c-still",
                               "traffic": "orbit", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("still-orbit", tmp_path, tmp_path)
    assert spec.entry(cell).build(None, cell.config, "cpu") == "built"
    frames = run.frames_of(cell, 2**33 + 1)
    assert len(frames) == 5 and frames(7) == (2, ("pose", 2), None)
    from types import SimpleNamespace
    state = SimpleNamespace(frames=frames, cell=cell)
    assert run.trace_path_frames(state) == [0, 1, 2, 3, 4]


def test_traced_frames_are_the_same_on_every_seed(tiny_cell):
    from types import SimpleNamespace
    cell = tiny_cell("c4-fly")
    got = {tuple(run.trace_path_frames(SimpleNamespace(
        frames=run.frames_of(cell, s), cell=cell)))
        for s in (1, 2**31 + 7, 2**40 + 3)}
    assert len(got) == 1
    ks = got.pop()
    assert ks[0] == 0 and len(ks) == 240 // cell.check["trace_every"]


def test_breakdown_names_ops_and_idle_gaps():
    from types import SimpleNamespace
    tr = SimpleNamespace(
        ops=[("k1", 0.0, 1.0), ("k2", 1.5, 2.0), ("k1", 2.0, 4.0)],
        host=[("bench.traced_window", 0.0, 5.0),
              ("cudaGraphLaunch", 1.1, 1.4), ("bench.drain", 4.0, 5.0)],
        lo=0.0, hi=5.0)
    b = run.breakdown(tr)
    assert b["device_ops"] == [["k1", 3.0], ["k2", 0.5]]
    assert b["idle_gaps"] == [["bench.drain", 1.0],
                              ["cudaGraphLaunch", 0.5]]


def test_cpu_traced_run_reports_no_device_metric(tiny_cell):
    out = run.run_cell(tiny_cell("c5-full-fly"), 5, 0.5, 1, device="cpu",
                       t_start=time.perf_counter())
    assert out["metrics"] == {} and "breakdown" not in out
    assert "busy_s" not in out["device"]
    assert out["correct"] is True


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vkrt_tpu'] = None\n"
        "sys.path.insert(0, 'bench_torch')\n"
        "sys.path.insert(0, 'bench_torch/tests')\n"
        "import run, calibrate, spec, json\n"
        "cell = spec.load('c5-full-fly', run.ROOT)\n"
        "cfg = json.loads(json.dumps(cell.config))\n"
        "cfg['render'].update(width=64, height=32)\n"
        "cfg['scene'] = {'size': 'small', 'seed': 0}\n"
        "out = run.run_cell(cell._replace(config=cfg), 3, 0.3, 1,\n"
        "                   device='cpu', t_start=time.perf_counter())\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'vkrt_tpu.'))\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "assert out['correct'] is True\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
