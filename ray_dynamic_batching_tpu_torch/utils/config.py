"""Typed, env-overridable framework configuration.

Own copy of ``ray_dynamic_batching_tpu/utils/config.py``: every field of
:class:`RDBConfig` is overridable via an ``RDB_<NAME>`` environment
variable, with type coercion derived from the dataclass annotation. The
variable names are the JAX package's, so one environment drives both
packages. Trimmed to the fields the port reads (the chaos seed); the
reference's scheduling, batching, HBM and compile knobs come with the
modules that read them.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import typing
from typing import Any, Optional


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return value
    # Optional[X] / unions: try int, float, fall back to str.
    for t in (int, float):
        try:
            return t(value)
        except ValueError:
            continue
    return value


@dataclasses.dataclass
class RDBConfig:
    """The port's knobs. Override any field with ``RDB_<NAME>``."""

    # --- testing / chaos ---
    # Deterministic seed for chaos injection (utils/chaos.py).
    chaos_seed: int = 0

    @classmethod
    def from_env(cls, **overrides: Any) -> "RDBConfig":
        hints = typing.get_type_hints(cls)  # resolves PEP 563 string annotations
        kwargs: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            env_key = "RDB_" + f.name.upper()
            if env_key in os.environ:
                try:
                    kwargs[f.name] = _coerce(os.environ[env_key], hints[f.name])
                except ValueError as e:
                    raise ValueError(f"bad value for {env_key}: {e}") from e
        kwargs.update(overrides)
        return cls(**kwargs)


_global_config: Optional[RDBConfig] = None
_lock = threading.Lock()


def get_config() -> RDBConfig:
    """Process-wide config singleton (env-initialized on first use)."""
    global _global_config
    if _global_config is None:
        with _lock:
            if _global_config is None:
                _global_config = RDBConfig.from_env()
    return _global_config


def set_config(cfg: RDBConfig) -> None:
    global _global_config
    with _lock:
        _global_config = cfg


def reset_config() -> None:
    global _global_config
    with _lock:
        _global_config = None
