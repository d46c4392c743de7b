"""vkrt_tpu_torch/kernels.py: the nvcc build and its failure modes.

There is no nvcc here, so a stand-in script plays it: the build must
raise when nvcc is missing or fails, compile every source with the flags
the kernels' numerics rely on, link them into one library, and reuse a
finished library.
"""

import os
import stat

import pytest

from vkrt_tpu_torch import kernels

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{args}"
{body}
"""


@pytest.fixture()
def build_root(tmp_path, monkeypatch):
    monkeypatch.setenv("VKRT_TORCH_CACHE", str(tmp_path / "build"))
    return tmp_path


def fake_nvcc(tmp_path, monkeypatch, body: str):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(args=tmp_path / "args", body=body))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return tmp_path / "args"


def test_build_without_nvcc_raises(build_root, monkeypatch):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(build_root / "no-cuda"))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_failed_nvcc_raises_with_its_output(build_root, monkeypatch):
    fake_nvcc(build_root, monkeypatch, 'echo "error: bad kernel" >&2; exit 2')
    with pytest.raises(RuntimeError, match="bad kernel"):
        kernels.build()
    assert not list((build_root / "build").rglob("*.so"))


def test_build_flags_and_reuse(build_root, monkeypatch):
    # the stand-in writes the file named after -o
    args = fake_nvcc(build_root, monkeypatch, '''
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "ptxas info    : Used 40 registers" >&2
: > "$out"''')
    first = kernels.build()
    assert not first.cached and first.path.is_file()
    assert "registers" in first.log
    calls = [line.split() for line in args.read_text().splitlines()]
    compiles = [a for a in calls if "-c" in a]
    links = [a for a in calls if "-shared" in a]
    assert len(compiles) == len(kernels.SOURCES) and len(links) == 1
    for argv in compiles:
        assert "arch=compute_90a,code=sm_90a" in argv
        assert "-fmad=false" in argv and "-use_fast_math" not in argv
    assert sorted(a for argv in compiles for a in argv if a.endswith(".cu")
                  ) == sorted(str(kernels.CSRC / s) for s in kernels.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in links[0]
    assert sum(a.endswith(".o") for a in links[0]) == len(kernels.SOURCES)
    assert not list(first.path.parent.glob("*.o"))
    again = kernels.build()
    assert again.cached and again.path == first.path


def test_check_raises_on_launch_error():
    kernels.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 9"):
        kernels.check(9, "trace_closest")
