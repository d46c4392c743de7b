"""Where the port keeps what it compiles — counterpart of
vkrt_tpu/utils/cache.py.

The JAX package keeps its XLA compilation cache in a directory the
caller may choose (`enable_compilation_cache(path)`, else the
environment variable VKRT_JAX_CACHE, else `.jax_cache/` in the
checkout). The port compiles at first use: its CUDA kernels
(kernels.py, under `<root>/<hash>/`) and the native oracle (native/,
under `<root>/native/<hash>/`). Both go under one build root: the
directory that the environment variable VKRT_TORCH_CACHE names, else
`vkrt_tpu_torch/_build/` in the package. The variable is read at each
build, so a read-only install builds elsewhere and a process may switch
roots between builds.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "VKRT_TORCH_CACHE"
DEFAULT_ROOT = Path(__file__).resolve().parent.parent / "_build"


def build_root(path: str | os.PathLike | None = None) -> Path:
    """The build root: `path` if given, else $VKRT_TORCH_CACHE, else
    DEFAULT_ROOT. Nothing is created here."""
    return Path(path or os.environ.get(ENV) or DEFAULT_ROOT)
