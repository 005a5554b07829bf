"""Typed, env-overridable framework configuration.

Own copy of ``ray_dynamic_batching_tpu/utils/config.py``: every field of
:class:`RDBConfig` is overridable via an ``RDB_<NAME>`` environment
variable, with type coercion derived from the dataclass annotation. The
variable names are the JAX package's, so one environment drives both
packages. Kept: the scheduling, batching, memory and queue fields of
the reference's ``:44-79`` and ``max_queue_len``, the SLO status
thresholds and the chaos seed. The planner (``scheduler/nexus.py``),
deployment sizing (``serve/llm.py``), the live schedulers
(``scheduler/llm_control.py``, ``scheduler/control.py``, which also reads
``rate_min_span_s``) and the status table (``state.py``) read the
scheduling, memory, queue and threshold fields; ``utils/compile_cache.py``
reads ``compilation_cache_dir``, where the kernel libraries are built. The batching block
(``max_batch_size``, ``default_batch_wait_timeout_s``,
``default_max_batch_size``, ``min_seq_bucket``, ``max_seq_len``) is read
by no ported module yet. Trimmed: the rest of the
reference's XLA compile-management block (no counterpart in eager torch), the staleness
flag ``discard_stale_requests`` (which the reference reads nowhere), and
its control-plane timing, transport, metrics interval and RPC-failure
knobs, which no ported module reads.

``hbm_budget_bytes`` keeps the reference's default (14 GiB, a TPU
chip's budget) so both packages plan alike on the CPU. Nothing in the
port reads a card's memory by itself: on a card the caller sets the
budget, e.g. ``RDB_HBM_BUDGET_BYTES`` or
``set_config(RDBConfig.from_env(hbm_budget_bytes=...))`` from
``torch.cuda.get_device_properties(0).total_memory``.
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

    # --- scheduling (ref: 293-project/src/scheduler.py:28, nexus.py:154) ---
    # SLO safety divisor applied at schedule time (ref SLO_hack=2.2, scheduler.py:28).
    slo_safety_factor: float = 2.2
    # Fraction of the (safety-adjusted) SLO a saturated batch may spend computing
    # (Nexus "SLO/2" rule, nexus.py:154).
    slo_compute_fraction: float = 0.5
    # Rate-change fraction that triggers a reschedule (ref scheduler.py:794).
    rate_change_threshold: float = 0.05
    # Multiplier on the threshold for rate *decreases* (ref scheduler.py:798-801).
    rate_decrease_multiplier: float = 2.0
    # Seconds between control-loop monitoring passes (ref monitoring_interval=5).
    monitoring_interval_s: float = 5.0
    # Sliding window for request-rate estimation (ref RequestTracker window).
    rate_window_s: float = 10.0
    # Cold-window replan guard: suppress rate-change replans for models whose
    # sliding window covers fewer than this many seconds (a half-filled window
    # under-reads by up to 1/span and the monitor scales DOWN during rampup).
    # 0.0 = react immediately (the reference's behavior).
    rate_min_span_s: float = 0.0

    # --- batching / bucketing (TPU-first: XLA compiles per shape bucket) ---
    # Batch buckets are rounded up to the nearest of these (powers of two by
    # default keep the jit cache small; profile rows exist per bucket).
    max_batch_size: int = 1024
    # Opportunistic batching defaults (ref serve/batching.py:530).
    default_batch_wait_timeout_s: float = 0.01
    default_max_batch_size: int = 32
    # Sequence buckets for LLM prefill (powers of two from min upward).
    min_seq_bucket: int = 32
    max_seq_len: int = 8192

    # --- memory (HBM replaces the reference's gpu_mem budget, nexus.py:156) ---
    # Per-device memory budget in bytes. The default is the reference's,
    # sized for a TPU chip; on a card the caller sets it from the card.
    hbm_budget_bytes: int = 14 * 1024**3
    # Fraction of HBM the scheduler may plan against (scratch/fragmentation slack).
    hbm_plan_fraction: float = 0.9

    # --- build cache ---
    # Directory where the CUDA kernel libraries are built and reused across
    # processes and checkouts (utils/compile_cache.py; "" keeps each
    # checkout's build/torch_kernels/). The reference's persistent
    # compilation cache knob, same variable.
    compilation_cache_dir: str = ""

    # --- queues (ref 293-project/src/scheduler.py:190) ---
    max_queue_len: int = 4096

    # --- observability ---
    slo_good_threshold: float = 0.98   # ref metrics_display.py:65
    slo_warn_threshold: float = 0.95

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
