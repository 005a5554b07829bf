"""sim/ — the simulator's reports.

Only ``sim/report.py`` is ported so far: its drift report grades the
live hop sketches in ``serve/observatory.py``. The discrete-event
simulator itself (clock, queues, engines, scenarios, workloads) is
ROADMAP queue 1 item 7.
"""

from ray_dynamic_batching_tpu_torch.sim.report import (
    compare_reports,
    format_compare,
    format_gray_timeline,
    gray_timeline,
    hop_drift_report,
    merged_hop_sketches,
    render_json,
    slo_attainment,
)

__all__ = [
    "compare_reports",
    "format_compare",
    "format_gray_timeline",
    "gray_timeline",
    "hop_drift_report",
    "merged_hop_sketches",
    "render_json",
    "slo_attainment",
]
