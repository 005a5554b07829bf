"""Persistent kernel build cache: the port's analogue of JAX's persistent
compilation cache (reference ``utils/compile_cache.py:28-47``).

The JAX package points XLA at a cache directory so repeat compiles become
disk hits. The port compiles its hand-written CUDA kernels with ``nvcc``
at first use (``ops/_build.py``, ~60 s for the four libraries), into
``build/torch_kernels/`` of the checkout, so every fresh checkout pays
the build again. :func:`maybe_enable` points ``ops/_build.py``'s
``BUILD_DIR`` at the configured ``compilation_cache_dir`` instead, so a
library built once is reused across processes and checkouts. The
libraries stay keyed by a hash of their sources and flags: a stale one is
never loaded.

Enable with ``RDB_COMPILATION_CACHE_DIR=/path`` (or a config override);
"" keeps each checkout's own directory. Called where the reference calls
it: the decode engine, ``ModelHost`` and both profilers.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional

from ray_dynamic_batching_tpu_torch.utils.config import get_config
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("compile_cache")

_lock = threading.Lock()
_applied: Optional[str] = None


def maybe_enable() -> bool:
    """Idempotently point the kernel builds at the configured cache dir.
    Returns True when a cache is active. Nothing is built here."""
    global _applied
    cache_dir = get_config().compilation_cache_dir
    with _lock:
        if not cache_dir or _applied == cache_dir:
            return _applied is not None
        from ray_dynamic_batching_tpu_torch.ops import _build

        _build.BUILD_DIR = Path(cache_dir)
        _applied = cache_dir
        logger.info("kernel build cache at %s", cache_dir)
        return True
