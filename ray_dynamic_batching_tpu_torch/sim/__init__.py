"""sim/ — deterministic discrete-event what-if simulator for the SLO
scheduler.

Replays a workload (synthetic ``RatePattern``s, a recorded arrivals
JSONL, or arrivals reconstructed from a flight-recorder span dump)
against the REAL planners (``scheduler/nexus.py`` +
``scheduler/replan.decide_replan``) at a virtual clock, with the
committed profile tables as the execution cost model. Answers "would
this plan hold at 2x traffic?" / "can we drop a chip?" in milliseconds
of wall time, byte-deterministically. CLI: ``python -m
ray_dynamic_batching_tpu_torch.sim`` (``sim/__main__.py``, the port's
copy of the reference's ``tools/run_sim.py``).

Own copy of ``ray_dynamic_batching_tpu/sim/``, whole. Its scheduler plans
by the port's rule (``sim/control.py``); inside
``scheduler/control.reference_headroom()`` every report is byte-identical
to the reference's.
"""

from ray_dynamic_batching_tpu_torch.sim.clock import EventLoop, VirtualClock
from ray_dynamic_batching_tpu_torch.sim.control import SimScheduler
from ray_dynamic_batching_tpu_torch.sim.engine import SimEngine
from ray_dynamic_batching_tpu_torch.sim.queue import (
    SimQueueManager,
    SimRequest,
    SimRequestQueue,
)
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
from ray_dynamic_batching_tpu_torch.sim.simulator import (
    AcceptanceCollapse,
    EngineDegradation,
    EngineFailure,
    Scenario,
    SimModelSpec,
    Simulation,
)
from ray_dynamic_batching_tpu_torch.sim.workload import (
    arrivals_from_spans,
    load_recorded_arrivals,
    merge_arrivals,
    scale_arrivals,
    synthetic_arrivals,
)

__all__ = [
    "EventLoop",
    "VirtualClock",
    "SimScheduler",
    "SimEngine",
    "SimQueueManager",
    "SimRequest",
    "SimRequestQueue",
    "compare_reports",
    "format_compare",
    "format_gray_timeline",
    "gray_timeline",
    "hop_drift_report",
    "merged_hop_sketches",
    "render_json",
    "slo_attainment",
    "AcceptanceCollapse",
    "EngineDegradation",
    "EngineFailure",
    "Scenario",
    "SimModelSpec",
    "Simulation",
    "arrivals_from_spans",
    "load_recorded_arrivals",
    "merge_arrivals",
    "scale_arrivals",
    "synthetic_arrivals",
]
