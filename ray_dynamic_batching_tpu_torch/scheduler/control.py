"""Live scheduler — rate monitoring, rebalance, minimal-movement migration.

Re-creates the reference's ``NexusScheduler`` control plane
(``293-project/src/scheduler.py:602-929``): a monitoring loop samples per-model
request rates every interval (:763), re-runs squishy bin packing when a rate
moves past the threshold (5%, doubled for decreases — :794-801), then matches
old→new node plans to minimize model movement (:857-891) and pushes the new
(sessions, duty-cycle) to each worker's update channel (:906-929).

The matcher's objective is weighted by profile-measured ``compile_ms`` (on
a card, a bucket's first dispatch) + weight bytes instead of a flat
transfer count (SURVEY.md §7 stage 5).

Own copy of ``ray_dynamic_batching_tpu/scheduler/control.py``, whole, with
its import paths rewritten: ``LiveScheduler`` drives the port's
``ReplicaEngine``s (``engine/worker.py``), and gray monitoring runs the
port's ``serve/grayhealth.py``. One difference: it plans each model at
``1 + RATE_HEADROOM`` times the rate it reads.
The packer provisions the session that sets a node's duty cycle at exactly
the rate it is given (duty = batch / rate), and the reference's window
reads a steady rate up to a tenth low, so at the reference's 0.0 a rate
step, or the window's own under-read, left a backlog that never drained
(on an H100 and in the reference's own simulator alike). The audit, the
schedule log and the change detector keep the rates as read.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
from ray_dynamic_batching_tpu_torch.engine.rates import RateRegistry
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.engine.worker import ReplicaEngine
from ray_dynamic_batching_tpu_torch.scheduler.audit import AuditLog
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    NodePlan,
    Session,
    SquishyBinPacker,
)

# The decide step is extracted to scheduler/replan.py (pure, clock-free,
# framework-free) so the what-if simulator (sim/) consumes the SAME logic this
# threaded path applies — re-exported here for existing importers.
from ray_dynamic_batching_tpu_torch.scheduler.replan import (  # noqa: F401
    BRUTE_FORCE_LIMIT,
    ModelEntry,
    decide_replan,
    match_plans_to_engines,
    sessions_for,
    transfer_cost,
)
from ray_dynamic_batching_tpu_torch.utils.config import get_config
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("control")

# The packer gives the session that sets a node's duty cycle exactly the
# rate it is handed (duty = batch / rate), so at the reference's 0.0 any rise,
# or the window's own under-read, becomes a backlog that does not drain. At
# 0.5 a plan serves 1.5x what it reads: a backlog built before the monitor
# sees a rise drains at a third of the plan once the read catches up, and a
# doubled rate that the next pass half-sees (1.5x read, 2.25x planned) is
# already planned past.
RATE_HEADROOM = 0.5


def planned_sessions(models: Dict[str, ModelEntry],
                     rates: Dict[str, float]) -> List[Session]:
    """The sessions the packer is handed: each model at ``1 +
    RATE_HEADROOM`` times the rate read. The live scheduler and the
    simulator's (``sim/control.py``) both plan through this; the constant
    is read at call time, so ``reference_headroom()`` reaches both."""
    scale = 1.0 + RATE_HEADROOM
    return sessions_for(models, {m: r * scale for m, r in rates.items()})


@contextlib.contextmanager
def reference_headroom() -> Iterator[None]:
    """Plan at the reference's rule (headroom 0.0: the rates as read)
    inside the block, and restore the constant after. For comparisons
    with the JAX package (the sim smoke's reference arm, the tests);
    nothing on the serving path enters it."""
    global RATE_HEADROOM
    saved = RATE_HEADROOM
    RATE_HEADROOM = 0.0
    try:
        yield
    finally:
        RATE_HEADROOM = saved


class LiveScheduler:
    """The running control plane for one scheduling domain."""

    def __init__(
        self,
        packer: SquishyBinPacker,
        engines: Sequence[ReplicaEngine],
        queues: Optional[QueueManager] = None,
        rates: Optional[RateRegistry] = None,
        metrics_path: Optional[str] = None,
        clock=time.monotonic,
    ):
        cfg = get_config()
        self.packer = packer
        self.engines = list(engines)
        self.queues = queues or QueueManager(max_len=cfg.max_queue_len)
        self.rates = rates or RateRegistry(window_s=cfg.rate_window_s)
        self.metrics_path = metrics_path
        self.monitoring_interval_s = cfg.monitoring_interval_s
        self.rate_threshold = cfg.rate_change_threshold
        self.rate_decrease_multiplier = cfg.rate_decrease_multiplier
        # Cold-window guard (rates.changed_models min_span_s): suppress
        # replans while the sliding window covers fewer than this many
        # seconds — a half-filled window under-reads rates by up to
        # 1/span and a monitor acting on it scales DOWN during rampup
        # (the inversion the LLM control loop already guards against).
        # Default 0.0 preserves the historical always-react behavior.
        self.rate_min_span_s = cfg.rate_min_span_s
        self._clock = clock
        self._models: Dict[str, ModelEntry] = {}
        self._current_plan: List[NodePlan] = []
        # Engines the monitor has already seen dead: the heal replan fires
        # once per death (a dead engine stays out of every later plan).
        self._dead_engines: set = set()
        self._lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.schedule_changes = 0
        self.schedule_log: List[Dict] = []
        # Structured replan ring: trigger, observed rates, profile rows
        # consulted, old->new diff, migration cost (scheduler/audit.py).
        self.audit = AuditLog("nexus")
        # Optional gray-health pricing hook: a callable
        # returning engine_id -> capacity factor (1.0 = full chip,
        # probation < 1, ejected 0 — but ejected engines should simply
        # report unhealthy). None = every alive engine is a full chip.
        # ``enable_gray_monitoring()`` wires it to a live detector fed
        # by per-batch step ratios; callers may install their own.
        self.capacity_factors = None
        self.gray = None
        self._gray_ejected: set = set()
        self._gray_window_ticks = 3
        self._gray_windows: Dict[str, List[List[float]]] = {}

    # --- registration (ref models_config) ---------------------------------
    def register_model(self, name: str, slo_ms: float, seq_len: int = 0,
                       mesh_shape: str = "1x1", spec: str = "off",
                       spec_acceptance: float = 0.0,
                       spec_tokens: int = 4,
                       prefill_chunk_ms: float = 0.0) -> None:
        """``mesh_shape`` is the model's preferred serving slice
        ("1x4" = a 4-chip TP replica priced from its mesh profile
        rows); replans degrade it to surviving geometry when the wide
        slices are gone (scheduler/replan.degrade_sessions).
        ``spec="on"`` prices the model from its spec profile rows at
        the PROFILED ``spec_acceptance`` (same ModelEntry
        surface as the sim scheduler — defaults byte-identical)."""
        if name not in self.packer.profiles:
            raise KeyError(f"no batch profile for model {name!r}")
        self._models[name] = ModelEntry(
            name, slo_ms, seq_len, mesh_shape, spec=spec,
            spec_acceptance=spec_acceptance, spec_tokens=spec_tokens,
            prefill_chunk_ms=prefill_chunk_ms,
        )

    # --- ingress path (ref submit_request, scheduler.py:734-751) ----------
    def submit_request(self, request: Request) -> bool:
        entry = self._models.get(request.model)
        if entry is None:
            request.reject(KeyError(f"model {request.model!r} not registered"))
            return False
        # Record DEMAND before the enqueue outcome: if drops suppressed the
        # signal, an overloaded queue would read as a rate collapse and the
        # monitor would scale DOWN during overload (inverted feedback).
        self.rates.record(request.model)
        return self.queues.queue(request.model).add_request(request)

    # --- scheduling -------------------------------------------------------
    @staticmethod
    def _engine_alive(engine) -> bool:
        """Duck-typed liveness: engines exposing ``healthy()`` (ReplicaEngine,
        sim/test fakes) are consulted; anything else counts alive."""
        probe = getattr(engine, "healthy", None)
        return bool(probe()) if callable(probe) else True

    def alive_engines(self) -> List[ReplicaEngine]:
        return [e for e in self.engines if self._engine_alive(e)]

    def rebalance(
        self,
        rates: Optional[Dict[str, float]] = None,
        trigger: str = "manual",
    ) -> List[NodePlan]:
        """Re-run bin packing and migrate with minimal movement
        (ref _update_schedule, scheduler.py:834-929). The DECISION —
        bin-pack, minimal-movement match, audit payload — is the shared
        pure function (``replan.decide_replan``); this method only reads
        rates and APPLIES the result to the live engines. Dead engines
        are excluded from packing and assignment — their queued work is
        in the shared per-model queues, so the surviving engines' new
        plans pick it up without an explicit drain."""
        with self._lock:
            rates = rates if rates is not None else self.rates.rates()
            alive = self.alive_engines()
            factors = None
            if self.capacity_factors is not None:
                by_id = self.capacity_factors()
                factors = [by_id.get(e.engine_id, 1.0) for e in alive]
            # Mesh-sliced engines advertise their chip-set width (an
            # engine without the attribute is one chip — the classic
            # domain, where these lists are all-1/"1x1" and the decision
            # is byte-identical to the pre-mesh planner). A slice death
            # removes its width here, so the heal replan runs over the
            # SURVIVING geometry and degrade_sessions re-shapes TP
            # models to the slices still standing.
            widths = [int(getattr(e, "width", 1) or 1) for e in alive]
            meshes = [
                str(getattr(e, "mesh_shape", "") or f"1x{w}")
                for e, w in zip(alive, widths)
            ]
            decision = decide_replan(
                self.packer,
                [frozenset(e.models) for e in alive],
                planned_sessions(self._models, rates),
                rates,
                capacity_factors=factors,
                engine_widths=widths,
                engine_meshes=meshes,
            )
            for engine, node_plan in zip(alive, decision.assignment):
                if node_plan is not None:
                    engine.assign(node_plan)
                elif engine.models:
                    engine.assign(NodePlan())  # idle this engine
            self._current_plan = decision.plan
            self.rates.mark_scheduled(rates)
            self.schedule_changes += 1
            self.schedule_log.append(
                {
                    "ts": self._clock(),
                    "rates": dict(rates),
                    "nodes": [n.describe() for n in decision.plan],
                }
            )
            self.audit.record(trigger, **decision.audit_fields())
            logger.info(
                "rebalance #%d: %d nodes for rates %s",
                self.schedule_changes, len(decision.plan),
                {k: round(v, 1) for k, v in rates.items()},
            )
            return decision.plan

    # --- engine heal (the controller's unhealthy-replacement discipline,
    # applied to the scheduling domain: a dead engine's models migrate to
    # survivors instead of silently starving their queues) ----------------
    def check_engine_health(self) -> bool:
        """Detect newly dead engines; replan over survivors when found.
        Returns True when a heal replan fired. Heal bypasses the rate
        cold-window guard — it is failure-driven, not rate-driven."""
        newly_dead = [
            e for e in self.engines
            if e.engine_id not in self._dead_engines
            and not self._engine_alive(e)
        ]
        if not newly_dead:
            return False
        for e in newly_dead:
            self._dead_engines.add(e.engine_id)
            logger.warning(
                "engine %s dead; migrating its models to survivors",
                e.engine_id,
            )
        observed: Dict = {"dead_engines": sorted(self._dead_engines)}
        # Slice semantics (serve/failover.SliceDeadError): a multi-chip
        # engine dying means one chip in its gang took the whole slice
        # down — the audit names the lost width so the heal replan's
        # degraded shapes are explainable.
        slices = {
            e.engine_id: {"width": int(getattr(e, "width", 1) or 1)}
            for e in newly_dead
            if int(getattr(e, "width", 1) or 1) > 1
        }
        if slices:
            observed["dead_slices"] = slices
        self.audit.record(
            "engine_dead",
            observed=observed,
            diff={"removed": [e.engine_id for e in newly_dead]},
            note="engine death detected by monitor; replan over survivors",
        )
        self.rebalance(trigger="heal")
        return True

    # --- gray-failure detection (the LIVE producer for the
    # capacity_factors hook — the sim twin is SimScheduler.check_gray_health,
    # same detector, same grading rule, no drift) --------------------------
    def enable_gray_monitoring(self, policy=None,
                               window_ticks: int = 3) -> None:
        """Arm engine-level gray detection: per-batch observed/expected
        step ratios (ReplicaEngine.track_ratios) feed a GrayHealthMonitor
        each monitor tick, and ``capacity_factors`` auto-wires to its
        pricing unless the caller installed their own hook. Probation
        relies on the fractional plan keeping SOME load on the engine so
        ratios keep flowing (a folded-empty probationed engine holds its
        state until the packer hands it load again)."""
        from ray_dynamic_batching_tpu_torch.serve.grayhealth import (
            GrayHealthMonitor,
        )

        self.gray = GrayHealthMonitor("scheduler", policy=policy)
        self.gray.audit = self.audit
        self._gray_window_ticks = int(window_ticks)
        self._gray_windows = {}
        for e in self.engines:
            e.track_ratios = True
        if self.capacity_factors is None:
            self.capacity_factors = lambda: {
                e.engine_id: self.gray.capacity_factor(e.engine_id)
                for e in self.engines
            }

    def check_gray_health(self) -> bool:
        """Grade one monitor tick's step ratios and replan when a
        verdict changed the planner's pricing (probation = fractional
        chip, ejection = reclaim). Returns True when a gray replan
        fired. Mirrors SimScheduler.check_gray_health."""
        if self.gray is None:
            return False
        # The SAME window/grade rule the sim twin runs — no drift. No
        # probes map: live has no ground truth to synthesize for an
        # idled probationed engine (see enable_gray_monitoring).
        from ray_dynamic_batching_tpu_torch.serve.grayhealth import (
            ratio_observations,
        )

        drained_by_id = {
            e.engine_id: e.drain_ratios()
            for e in self.engines
            if e.engine_id not in self._dead_engines
            and e.engine_id not in self._gray_ejected
        }
        obs = ratio_observations(
            drained_by_id, self._gray_windows, self._gray_window_ticks
        )
        transitions = self.gray.tick(obs)
        repricing = [t for t in transitions
                     if "probation" in (t["from"], t["to"])
                     or t["to"] == "ejected"]
        if not repricing:
            return False
        for t in repricing:
            if t["to"] == "ejected":
                self._gray_ejected.add(t["replica"])
                for e in self.engines:
                    if e.engine_id == t["replica"]:
                        e.assign(NodePlan())  # idle the reclaimed chip
        self.rebalance(trigger="gray")
        return True

    # --- monitor loop (ref _monitor_request_rates, scheduler.py:763-801) --
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.monitoring_interval_s):
            try:
                healed = self.check_engine_health()
                if not healed:
                    healed = self.check_gray_health()
                changed = self.rates.changed_models(
                    self.rate_threshold, self.rate_decrease_multiplier,
                    min_span_s=self.rate_min_span_s,
                )
                if changed and not healed:  # heal already replanned
                    logger.info("rate change detected: %s", changed)
                    self.rebalance(trigger="rate_change")
                if self.metrics_path:
                    self.write_metrics()
            except Exception:  # noqa: BLE001
                logger.exception("monitor iteration failed")

    def start_monitoring(self) -> None:
        if self._monitor is not None:
            return
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="rdb-monitor", daemon=True
        )
        self._monitor.start()

    def stop_monitoring(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None

    # --- observability (ref metrics.json writer, scheduler.py:969-983) ----
    def snapshot(self) -> Dict:
        # Snapshot the plan reference under the lock: rebalance rebinds
        # it from the monitor thread while metrics writers read here.
        with self._lock:
            plan = list(self._current_plan)
        return {
            "time": self._clock(),
            "rates_rps": self.rates.rates(),
            "scheduled_rates_rps": self.rates.scheduled_rates(),
            "queues": self.queues.stats(),
            "plan": [n.describe() for n in plan],
            "engines": [e.describe() for e in self.engines],
            "schedule_changes": self.schedule_changes,
            "audit": self.audit.to_dicts(last=20),
        }

    def write_metrics(self) -> None:
        with open(self.metrics_path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)

    def render_status(self) -> str:
        """Terminal SLO status (ref metrics_display.py:42-66) — one table
        renderer for scheduler, state CLI, and dashboard alike."""
        from ray_dynamic_batching_tpu_torch.state import render_queue_table

        return render_queue_table(self.queues.stats(), self.rates.rates())
