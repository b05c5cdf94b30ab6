"""Minimal structured logging (port of ``repro.utils.logging``).

Loggers live under the ``repro_torch`` root logger, whose level comes
from the ``REPRO_LOG_LEVEL`` environment variable (default ``INFO``), as
the JAX package's ``repro`` root does.
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_ROOT = "repro_torch"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("REPRO_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """Logger ``name`` under the ``repro_torch`` root (prefixed if needed)."""
    _configure_root()
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
