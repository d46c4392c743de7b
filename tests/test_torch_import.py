"""vkrt_tpu_torch imports neither JAX nor the JAX package, and
chip_smoke.py refuses to run without a CUDA card.

Each check runs in a fresh interpreter: the import check with
sys.modules['jax'] and sys.modules['vkrt_tpu'] = None, so any import of
jax or of a vkrt_tpu module (even one that needs no JAX) raises.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import torch

import torch_support  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clean_env() -> dict:
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def run_python(code: str):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=clean_env(), capture_output=True,
                          text=True, timeout=120)


def test_port_imports_without_jax():
    proc = run_python("""
        import sys
        sys.modules["jax"] = None
        sys.modules["vkrt_tpu"] = None
        import importlib, pkgutil
        import vkrt_tpu_torch
        names = ["vkrt_tpu_torch"] + [
            m.name for m in pkgutil.walk_packages(vkrt_tpu_torch.__path__,
                                                  "vkrt_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert sys.modules["jax"] is None and sys.modules["vkrt_tpu"] is None
        leaked = [m for m in sys.modules
                  if m.startswith(("jax.", "jaxlib", "vkrt_tpu."))]
        assert not leaked, leaked
        print(len(names), "modules", " ".join(names))
    """)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 15      # package, subpackages and modules
    for name in ("accel.refit", "accel.lbvh", "accel.device_sah",
                 "accel.clusters", "rt.dense", "wavefront.engine",
                 "app.cli", "app.state", "app.metrics", "golden.harness",
                 "native", "rt.traverse", "rt.intersect", "parallel.mesh",
                 "parallel.dryrun", "version"):
        assert f"vkrt_tpu_torch.{name}" in proc.stdout.split(), name


def test_chip_smoke_fails_without_cuda():
    proc = run_python("""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: False
        sys.argv = ["chip_smoke.py"]
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_port_tests_run_torch_on_one_thread():
    """tests/torch_support.py sets the port tests' CPU thread policy, and
    every port test file imports it, so the file runs on one thread alone
    as well as under pytest-xdist."""
    assert torch.get_num_threads() == 1
    tests = os.path.join(REPO, "tests")
    missing = []
    for name in sorted(os.listdir(tests)):
        if name.startswith("test_torch_") and name.endswith(".py"):
            with open(os.path.join(tests, name)) as f:
                if "\nimport torch_support" not in f.read():
                    missing.append(name)
    assert not missing, missing
