"""Structured logging setup (own copy of the JAX package's ``utils/logging``)."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname)s %(name)s :: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("RDB_LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT))
        root = logging.getLogger("rdb")
        root.setLevel(level)
        if not root.handlers:
            root.addHandler(handler)
        root.propagate = False
        _configured = True
    return logging.getLogger(f"rdb.{name}")
