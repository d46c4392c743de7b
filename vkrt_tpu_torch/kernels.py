"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

At first use each source is compiled by its own nvcc process, all started
together, for sm_90a; the objects are linked into one shared library with
a plain C interface, under `<build root>/<hash of the sources>/`, and
loaded with ctypes. The build root is `vkrt_tpu_torch/_build/` (listed in
.gitignore) or the directory that the environment variable
VKRT_TORCH_CACHE names (utils/cache.py). A later call in the same
process, or a later process with the same build root, reuses the
library. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.

Sources: trace_closest.cu (kernel A), trace_occluded.cu (A'),
occl_multi.cu (B), pack.cu (C, D), lanesort.cu (E, F), raster_edge.cu (G),
sah_cut.cu (H, the device SAH build's cut round), raster_sample.cu (I,
the raster discard round's material sample), raster_clip.cu (J, the
raster setup's clip of triangles that cross w = 0), sample_hits.cu (K,
the ray tracer's material sample on the lanes that hit), shade_hits.cu
(L, the ray tracer's hit shading in three steps a depth), span_mark.cu
(tracing.py's empty mark kernel); headers common.cuh
(shared by A, A', B, G, I, K and L) and walk.cuh (the front-to-back group
walk of A, A' and B).

Flags: -O3 -std=c++17 for sm_90a, -fmad=false so that no a*b+c is
contracted into an FMA (the plain PyTorch versions round each product
and sum separately, and edge hits would otherwise flip between the two),
and no -use_fast_math (IEEE division and reciprocal).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

from vkrt_tpu_torch.utils.cache import build_root

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("trace_closest.cu", "trace_occluded.cu", "occl_multi.cu",
           "pack.cu", "lanesort.cu", "raster_edge.cu", "sah_cut.cu",
           "raster_sample.cu", "raster_clip.cu", "sample_hits.cu",
           "shade_hits.cu", "span_mark.cu")
HEADERS = ("common.cuh", "walk.cuh")
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class BuildInfo(NamedTuple):
    """What a build did: library path, seconds, nvcc's output (registers,
    shared memory and spills per kernel from -Xptxas -v), and whether an
    existing library was reused."""
    path: Path
    seconds: float
    log: str
    cached: bool


def build() -> BuildInfo:
    """Compile csrc/ into <build root>/<hash>/libvkrt_kernels.so unless
    that library exists (the root: `build_root()`, read now). Raises
    RuntimeError if nvcc fails."""
    out_dir = build_root() / _source_hash()
    lib = out_dir / "libvkrt_kernels.so"
    if lib.is_file():
        return BuildInfo(lib, 0.0, "", cached=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o",
                          str(o)] for s, o in zip(SOURCES, objs))]
    runs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    tmp = out_dir / f"libvkrt_kernels.{tag}.so"
    if all(rc == 0 for _, _, rc in runs):
        cmd = [nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        runs.append((cmd, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(out for _, out, _ in runs)
    for cmd, out, rc in runs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)           # atomic: concurrent builds never tear
    return BuildInfo(lib, seconds, log, cached=False)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; `cache_clear()`
    makes the next call build or find it under the build root then
    current)."""
    lib = ctypes.CDLL(str(build().path))
    modes = [_I, _I, _P, _P, _I, _I, _P]     # ablate .. stat_btmax
    lib.vkrt_trace_closest.argtypes = [_P, _I, _I, _P, _P, _P, _I, _P, _P,
                                       _I, _I, _P, _P, _P, _P, _I, *modes,
                                       _P, _P, _P, _P, _P, _P]
    lib.vkrt_trace_closest.restype = _I
    lib.vkrt_trace_occluded.argtypes = [_P, _I, _I, _P, _P, _P, _I, _P, _P,
                                        _I, _I, _P, _P, _P, _I, *modes,
                                        _P, _P, _P, _P, _P]
    lib.vkrt_trace_occluded.restype = _I
    lib.vkrt_occl_multi.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                                    _P]
    lib.vkrt_occl_multi.restype = _I
    lib.vkrt_consolidate.argtypes = [_P, _P, _I, _I, _P, _P]
    lib.vkrt_scatter_back.argtypes = [_P, _P, _I, _I, _P, _P]
    lib.vkrt_lane_sort.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P]
    lib.vkrt_lane_unsort.argtypes = [_P, _P, _I, _I, _I, _P, _P]
    lib.vkrt_raster_edge.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P,
                                     _I, _P, _P, _P, _P, _P, _P]
    lib.vkrt_sah_cut.argtypes = [_P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P]
    lib.vkrt_raster_sample.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _F, _F, _P, _P, _P]
    lib.vkrt_raster_clip.argtypes = [_P, _P, _I, _D, _D, _P, _P]
    lib.vkrt_sample_hits.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                                     _P]
    lib.vkrt_shade_interp.argtypes = [_P, _P, _P, _P, _P, _I, _P, _P, _P]
    lib.vkrt_shade_lights.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _P, _P]
    lib.vkrt_shade_combine.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P,
                                       _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _P]
    lib.vkrt_span_mark.argtypes = [_P]
    for fn in (lib.vkrt_consolidate, lib.vkrt_scatter_back,
               lib.vkrt_lane_sort, lib.vkrt_lane_unsort,
               lib.vkrt_raster_edge, lib.vkrt_sah_cut, lib.vkrt_raster_sample,
               lib.vkrt_raster_clip, lib.vkrt_sample_hits,
               lib.vkrt_shade_interp, lib.vkrt_shade_lights,
               lib.vkrt_shade_combine, lib.vkrt_span_mark):
        fn.restype = _I
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
