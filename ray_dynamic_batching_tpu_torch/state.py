"""Terminal SLO status rendering.

Own copy of the part of ``ray_dynamic_batching_tpu/state.py`` the live LLM
scheduler imports: :func:`render_queue_table` (the reference's terminal
viewer table, ``293-project/src/metrics_display.py:42-66``) and the
thresholds it reads, :func:`slo_thresholds`.

Trimmed: ``StateAPI``, the audit and snapshot renderers and the watch /
URL command line, which come with the state API client (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

from typing import Dict, Optional


def slo_thresholds() -> tuple:
    """(good, warn) compliance thresholds from config (single source —
    scheduler status, state viewers, and the dashboard all honor these)."""
    from ray_dynamic_batching_tpu_torch.utils.config import get_config

    cfg = get_config()
    return cfg.slo_good_threshold, cfg.slo_warn_threshold


def render_queue_table(queues: Dict[str, Dict[str, float]],
                       rates: Optional[Dict[str, float]] = None) -> str:
    """SLO compliance table: ok/warning/CRITICAL per the configured
    thresholds (reference defaults 98%/95%, metrics_display.py:65)."""
    rates = rates or {}
    good, warn = slo_thresholds()
    lines = [f"{'model':<20} {'rate':>8} {'p95ms':>8} {'p99ms':>8} "
             f"{'depth':>6} {'SLO%':>7} status"]
    for name, stats in sorted(queues.items()):
        c = stats.get("slo_compliance", 1.0)
        status = "ok" if c >= good else "warning" if c >= warn else "CRITICAL"
        lines.append(
            f"{name:<20} {rates.get(name, 0.0):>8.1f} "
            f"{stats.get('latency_p95_ms', 0.0):>8.1f} "
            f"{stats.get('latency_p99_ms', 0.0):>8.1f} "
            f"{stats.get('depth', 0):>6.0f} {c * 100:>6.1f}% {status}"
        )
    return "\n".join(lines)
