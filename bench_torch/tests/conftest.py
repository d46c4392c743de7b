"""The benchmark's CPU tests: `python -m pytest bench_torch/tests` from
the root of the checkout. They put bench_torch/ on sys.path, as run.py
runs from there, and make a cell at a size the CPU holds."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json with its limits, traffic and settings as
    they are, cut to 64x32 pixels and the small scene."""
    import spec

    def make(workload, width=64, height=32):
        cell = spec.load(workload, ROOT)
        config = json.loads(json.dumps(cell.config))
        config["render"].update(width=width, height=height)
        config["scene"] = {"size": "small", "seed": 0}
        return cell._replace(config=config)
    return make
