"""ctypes bindings of the native CPU tracer — counterpart of
vkrt_tpu/native (the golden oracle's BVH and its stability mask).

tracer.cpp is a byte-for-byte copy of vkrt_tpu/native/tracer.cpp, built
with the same g++ flags (read from this directory's Makefile), so the two
packages' oracles give the same bits on one machine. Nothing builds at
import. The first `library()` call compiles it with g++ into
vkrt_tpu_torch/_build/native/<hash of source and flags>/ (a temporary name
first, then an atomic rename, so concurrent builds never tear), and a
failed build raises with the compiler's output: the oracle never goes
missing quietly.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
SOURCE = SRC_DIR / "tracer.cpp"
BUILD_ROOT = SRC_DIR.parent / "_build" / "native"
CXX = "g++"


def cxxflags() -> list:
    """The Makefile's CXXFLAGS."""
    m = re.search(r"^CXXFLAGS \?= (.+)$", (SRC_DIR / "Makefile").read_text(),
                  re.M)
    return m.group(1).split()


def build(src: Path = SOURCE, build_root: Path = BUILD_ROOT) -> Path:
    """Compile `src` into build_root/<hash>/libvkrt_native.so unless that
    library exists; returns its path. Raises RuntimeError with g++'s
    output if the build fails."""
    flags = cxxflags()
    h = hashlib.sha256(" ".join([CXX] + flags).encode())
    h.update(Path(src).read_bytes())
    out_dir = Path(build_root) / h.hexdigest()[:16]
    lib = out_dir / "libvkrt_native.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="libvkrt_native.", suffix=".tmp.so",
                               dir=out_dir)   # unique per process and thread
    os.close(fd)
    tmp = Path(tmp)
    cmd = [CXX, *flags, "-shared", "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native tracer build: cannot run {CXX}: {e}") \
            from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native tracer build failed ({proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded tracer library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f, i = ctypes.c_float, ctypes.c_int32
    lib.vkrt_bvh_create.restype = ctypes.c_void_p
    lib.vkrt_bvh_create.argtypes = [f32p, f32p, f32p, i]
    lib.vkrt_bvh_destroy.restype = None
    lib.vkrt_bvh_destroy.argtypes = [ctypes.c_void_p]
    lib.vkrt_trace_closest.restype = None
    lib.vkrt_trace_closest.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, i, f, f32p, i32p, f32p, f32p]
    lib.vkrt_trace_occluded.restype = None
    lib.vkrt_trace_occluded.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, i, f, u8p]
    lib.vkrt_trace_closest_stable.restype = None
    lib.vkrt_trace_closest_stable.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, i, f, f, f, f, f,
        f32p, i32p, f32p, f32p, u8p]
    lib.vkrt_trace_occluded_stable.restype = None
    lib.vkrt_trace_occluded_stable.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, i, f, f, f, f, f, u8p, u8p]
    return lib


def _rays(origins, dirs, tmax):
    n = origins.shape[0]
    return (n, np.ascontiguousarray(origins, np.float32),
            np.ascontiguousarray(dirs, np.float32),
            np.ascontiguousarray(np.broadcast_to(
                np.asarray(tmax, np.float32), (n,))))


class NativeBVH:
    """Native median-split BVH with closest and occlusion traversal."""

    def __init__(self, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
        self._lib = library()
        self._n = int(v0.shape[0])
        self._handle = self._lib.vkrt_bvh_create(
            np.ascontiguousarray(v0, np.float32),
            np.ascontiguousarray(e1, np.float32),
            np.ascontiguousarray(e2, np.float32), self._n)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vkrt_bvh_destroy(self._handle)
            self._handle = None

    def closest(self, origins, dirs, tmin, tmax):
        n, o, d, tm = _rays(origins, dirs, tmax)
        t = np.empty(n, np.float32)
        tri = np.empty(n, np.int32)
        u = np.empty(n, np.float32)
        v = np.empty(n, np.float32)
        self._lib.vkrt_trace_closest(self._handle, o, d, tm, n,
                                     np.float32(tmin), t, tri, u, v)
        return t, tri, u, v

    def occluded(self, origins, dirs, tmin, tmax):
        n, o, d, tm = _rays(origins, dirs, tmax)
        out = np.empty(n, np.uint8)
        self._lib.vkrt_trace_occluded(self._handle, o, d, tm, n,
                                      np.float32(tmin), out)
        return out.astype(bool)

    # Stability-certified variants (the golden gate's): the same results
    # plus a per-ray `stable` flag, True iff any correct f32 tracer must
    # reproduce the answer (no acceptance boundary within the mu/mt
    # margins; tracer.cpp "Stability classification").
    def closest_stable(self, origins, dirs, tmin, tmax,
                       mu: float = 2e-5, mt: float = 1e-5,
                       deps: float = 5e-7, oeps: float = 0.0):
        n, o, d, tm = _rays(origins, dirs, tmax)
        t = np.empty(n, np.float32)
        tri = np.empty(n, np.int32)
        u = np.empty(n, np.float32)
        v = np.empty(n, np.float32)
        stable = np.empty(n, np.uint8)
        self._lib.vkrt_trace_closest_stable(
            self._handle, o, d, tm, n, np.float32(tmin), np.float32(mu),
            np.float32(mt), np.float32(deps), np.float32(oeps), t, tri, u,
            v, stable)
        return t, tri, u, v, stable.astype(bool)

    def occluded_stable(self, origins, dirs, tmin, tmax,
                        mu: float = 2e-5, mt: float = 1e-5,
                        deps: float = 5e-7, oeps: float = 0.0):
        n, o, d, tm = _rays(origins, dirs, tmax)
        out = np.empty(n, np.uint8)
        stable = np.empty(n, np.uint8)
        self._lib.vkrt_trace_occluded_stable(
            self._handle, o, d, tm, n, np.float32(tmin), np.float32(mu),
            np.float32(mt), np.float32(deps), np.float32(oeps), out, stable)
        return out.astype(bool), stable.astype(bool)
