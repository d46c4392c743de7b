"""Logging + assertion helpers.

The reference enforces invariants with abort-on-failure CHECK/LOGE macros
(ref: src/Utils.hpp:8-29). Here the same role is played by `check` (raises)
plus structured logging; Vulkan's validation layer has no analogue — torch's
shape/dtype checking and the test suite take its place.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def check(cond: bool, msg: str = "check failed") -> None:
    """Host-side invariant check (ref: CHECK macro, src/Utils.hpp:8-16)."""
    if not cond:
        raise AssertionError(msg)
