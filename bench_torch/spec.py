"""Finds a cell's pieces by name (module docstring of run.py).

BENCHMARK.json at the checkout's root names the cells, configurations
and metrics; beside this file

  configs/<config>.json     a configuration (BENCHMARK.json's `file`);
                            its "entry" names the program it runs
  entries/<entry>.py        how to build that program and its reference
                            (entries/renderer.py's docstring)
  traffic/<traffic>.json    a traffic mix; its "generator" names the
                            code that reads it
  generators/<generator>.py the frames of a mix (generators/fly.py)
  cells/<workload>.json     a cell's check: frames compared, limits, the
                            path frames its traced window covers
  metrics/<metric>.py       a metric's reader: read(run) -> float | None

so a later change adds a piece as a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix
    check: dict           # cells/<name>.json
    end_to_end: list      # BENCHMARK.json metric entries of this cell
    per_layer: list
    here: Path            # where its files are


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path, here: Path = HERE) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, its files under
    `here`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    check = json.loads((here / "cells" / f"{workload}.json").read_text())
    return Cell(workload, int(w["chips"]), config, traffic, check,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                here)


_MODULES: dict = {}


def module(kind: str, name: str, here: Path = HERE):
    """The module <here>/<kind>/<name>.py, loaded once."""
    path = (here / kind / f"{name}.py").resolve()
    if path not in _MODULES:
        tag = f"bench_{kind}_{name}".replace("-", "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name: str, here: Path = HERE):
    """The `read` function of metrics/<name>.py."""
    return module("metrics", name, here).read


def entry(cell: Cell):
    """The entry module that the cell's configuration names."""
    return module("entries", cell.config["entry"], cell.here)


def generator(cell: Cell):
    """The generator module that the cell's traffic mix names."""
    return module("generators", cell.traffic["generator"], cell.here)
