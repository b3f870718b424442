"""Logging setup (the port's copy of `nanodecoder_tpu.utils.logging`)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(asctime)s %(levelname)s %(name)s] %(message)s"
_ROOT = "nanodecoder_tpu_torch"


def get_logger(name: str = _ROOT, level: int = logging.INFO) -> logging.Logger:
    """A logger under the package's hierarchy, whose one stderr handler is
    installed on first use."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
    # Parent every logger under the package so the one handler applies (a
    # bare name would propagate to the python root, which drops INFO).
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
