"""Simulated control plane — the REAL scheduler logic at virtual time.

This is deliberately thin: the pieces that decide anything are the live
modules themselves, reused through their clock seams —

- rate estimation: ``engine/rates.py`` ``RateRegistry`` with
  ``clock=VirtualClock.now_s`` (same sliding window, same asymmetric
  change thresholds, same cold-start semantics);
- the replan decision: ``scheduler/replan.decide_replan`` — the SAME
  pure function ``LiveScheduler.rebalance`` applies (no-drift pin in
  ``tests/test_torch_sim.py``);
- the audit trail: ``scheduler/audit.AuditLog`` with ``now=`` injected,
  so a simulated run's decision records are shaped (and dashboard-
  renderable) exactly like a live run's, just with virtual timestamps.

Only the monitor thread is re-expressed: a recurring event at
``monitoring_interval_s`` of VIRTUAL time instead of ``Event.wait``.

Own copy of ``ray_dynamic_batching_tpu/sim/control.py``, whole, with its
import paths rewritten. One departure, the port's rule: the replan hands
the packer ``scheduler/control.planned_sessions`` (each model at ``1 +
RATE_HEADROOM`` times its rate), the function the port's
``LiveScheduler`` plans through, where the reference's ``SimScheduler``
hands it the rates as read. Inside ``scheduler/control.
reference_headroom()`` the two agree byte for byte.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.engine.rates import RateRegistry
from ray_dynamic_batching_tpu_torch.engine.request import (
    DEFAULT_QOS_CLASS,
    DEFAULT_TENANT,
)
from ray_dynamic_batching_tpu_torch.scheduler.audit import AuditLog
from ray_dynamic_batching_tpu_torch.scheduler.control import planned_sessions
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    NodePlan,
    SquishyBinPacker,
)
from ray_dynamic_batching_tpu_torch.scheduler.replan import (
    ModelEntry,
    decide_replan,
    weighted_attainment,
)
from ray_dynamic_batching_tpu_torch.serve.retrybudget import (
    RetryBudget,
    RetryBudgetPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.grayhealth import (
    GrayHealthMonitor,
    GrayHealthPolicy,
    ratio_observations,
)
from ray_dynamic_batching_tpu_torch.serve.observatory import (
    ObservatoryPolicy,
    SLOObservatory,
)
from ray_dynamic_batching_tpu_torch.sim.clock import EventLoop, VirtualClock
from ray_dynamic_batching_tpu_torch.sim.engine import SimEngine
from ray_dynamic_batching_tpu_torch.sim.queue import (
    SimQueueManager,
    SimRequest,
)


class SimScheduler:
    """The simulated scheduling domain (live ``LiveScheduler`` shape)."""

    def __init__(
        self,
        packer: SquishyBinPacker,
        engines: List[SimEngine],
        queues: SimQueueManager,
        loop: EventLoop,
        clock: VirtualClock,
        monitoring_interval_s: float = 5.0,
        rate_threshold: float = 0.05,
        rate_decrease_multiplier: float = 2.0,
        rate_window_s: float = 10.0,
        rate_min_span_s: float = 0.0,
        gray_policy: Optional[GrayHealthPolicy] = None,
        observatory_policy: Optional[ObservatoryPolicy] = None,
    ) -> None:
        self.packer = packer
        self.engines = list(engines)
        self.queues = queues
        self.loop = loop
        self.clock = clock
        self.monitoring_interval_s = monitoring_interval_s
        self.rate_threshold = rate_threshold
        self.rate_decrease_multiplier = rate_decrease_multiplier
        self.rate_min_span_s = rate_min_span_s  # live cold-window guard
        self.rates = RateRegistry(window_s=rate_window_s, clock=clock.now_s)
        self.audit = AuditLog("sim", now=clock.now_s)
        self._models: Dict[str, ModelEntry] = {}
        self._current_plan: List[NodePlan] = []
        self._monitor_until_ms = 0.0
        self._dead_engines: set = set()
        # Gray-failure monitoring (the SAME detector the serve tier
        # runs — serve/grayhealth.py — on the virtual clock, fed with
        # observed/expected step-latency ratios instead of ms so a
        # multi-model engine grades model-agnostically). None = disabled:
        # canon scenarios stay byte-identical.
        self.gray: Optional[GrayHealthMonitor] = None
        if gray_policy is not None:
            self.gray = GrayHealthMonitor(
                "sim", policy=gray_policy, clock=clock.now_s
            )
            self.gray.audit = self.audit
            for e in self.engines:
                e.track_ratios = True
        self._gray_ejected: set = set()
        # Per-engine ratio window over the last N monitor TICKS: a
        # 10x-slowed engine finishes ~10x FEWER batches per tick, so
        # grading only each tick's drain would starve detection of the
        # very samples that prove the slowdown — while a sample-count
        # window would go stale the moment a probation replan idles the
        # engine. Tick-bounding gives both: slow evidence stays visible
        # across ticks, and a heal flushes within window_ticks.
        self._gray_window_ticks = 3
        self._gray_windows: Dict[str, List[List[float]]] = {}
        self.schedule_changes = 0
        self.schedule_log: List[Dict] = []
        # Optional serve.admission.AdmissionController built on the
        # VIRTUAL clock (the live module, reused — not re-expressed):
        # submit() consults it pre-queue exactly like the live proxies,
        # and the monitor tick feeds its governor the same depth/
        # compliance signals ServeController._control_step does.
        self.admission = None
        # (model, qos_class) -> rejected-at-admission count (the third
        # accounting category: offered = rejected + enqueued outcomes).
        self.admission_rejected: Dict[Tuple[str, str], int] = {}
        # SLO observatory (serve/observatory.py — the SAME classes the
        # live controller ticks, on the virtual clock). None = disabled:
        # canon scenarios stay byte-identical. The fidelity price fn
        # reads the CURRENT plan's profile rows — the planner's belief,
        # jitter- and degradation-free — so a seeded mispricing drifts
        # engine.step and only engine.step.
        self.observatory: Optional[SLOObservatory] = None
        if observatory_policy is not None:
            self.observatory = SLOObservatory(
                "sim", policy=observatory_policy, clock=clock.now_s,
                price=self._fidelity_price,
            )
            self.observatory.audit = self.audit
        # --- client-retry model --------------------------------
        # None = disabled: no stale-shed hook is installed, canon
        # scenarios stay byte-identical. enable_retries() turns stale
        # sheds into budgeted resubmissions — the amplification loop
        # that makes overload metastable when unbounded.
        self._retry_policy: Optional[RetryBudgetPolicy] = None
        self.retry_max_attempts = 0
        self.retry_backoff_ms = 0.0
        self.retry_budgets: Dict[str, RetryBudget] = {}
        self.retry_submitted: Dict[str, int] = {}
        # Per-class resubmission counts so the conservation identity
        # extends under retries: offered + resubmitted_classes ==
        # admission_rejected + enqueued, per (model, class).
        self.retry_submitted_classes: Dict[str, Dict[str, int]] = {}
        self.retry_denied: Dict[str, int] = {}
        self.retry_exhausted: Dict[str, int] = {}
        # Windowed weighted attainment sampled at monitor ticks — the
        # recovery timeline the metastability pin grades.
        self.attainment_timeline: List[Dict] = []
        self._attainment_prev: Dict[str, Dict[str, Dict[str, float]]] = {}
        # --- query-of-death tracking ---------------------------
        # Engines report isolations here (the sim twin of the replica ->
        # router quarantine gossip); repeats of a quarantined poison_id
        # are fenced at submit, never reaching a queue.
        self._poison_quarantined: set = set()
        self.poison_injected: Dict[str, int] = {}
        self.poison_fenced: Dict[str, int] = {}
        self.poison_isolations: List[Dict] = []
        for e in self.engines:
            e.on_poison = self._note_poison

    # --- registration (live register_model contract) ----------------------
    def register_model(self, name: str, slo_ms: float,
                       seq_len: int = 0, mesh_shape: str = "1x1",
                       spec: str = "off", spec_acceptance: float = 0.0,
                       spec_tokens: int = 4,
                       prefill_chunk_ms: float = 0.0) -> None:
        if name not in self.packer.profiles:
            raise KeyError(f"no batch profile for model {name!r}")
        self._models[name] = ModelEntry(
            name, slo_ms, seq_len, mesh_shape,
            spec=spec, spec_acceptance=spec_acceptance,
            spec_tokens=spec_tokens, prefill_chunk_ms=prefill_chunk_ms,
        )

    # --- ingress (live submit_request: demand recorded before enqueue) ----
    def submit(self, model: str, qos_class: str = DEFAULT_QOS_CLASS,
               tenant: str = DEFAULT_TENANT,
               prefill_ms: float = 0.0,
               poison_id: Optional[str] = None,
               retry_attempt: int = 0) -> bool:
        entry = self._models.get(model)
        if entry is None:
            return False
        if poison_id is not None:
            self.poison_injected[model] = (
                self.poison_injected.get(model, 0) + 1
            )
            if poison_id in self._poison_quarantined:
                # Front-door fence (live QuarantineRegistry.check): a
                # quarantined query of death is rejected at admission —
                # it never reaches a queue, never poisons a batch twice.
                self.poison_fenced[model] = (
                    self.poison_fenced.get(model, 0) + 1
                )
                # The fence IS a front-door rejection (live: 4xx from the
                # proxy) — count it so per-class conservation holds.
                key = (model, qos_class)
                self.admission_rejected[key] = (
                    self.admission_rejected.get(key, 0) + 1
                )
                return False
        if self.admission is not None:
            ok, _retry_after_s = self.admission.admit(
                model, tenant, qos_class
            )
            if not ok:
                # Turned away pre-queue: no demand signal either — the
                # planner plans for admitted load, mirroring the live
                # proxy-before-scheduler order.
                key = (model, qos_class)
                self.admission_rejected[key] = (
                    self.admission_rejected.get(key, 0) + 1
                )
                return False
        self.rates.record(model)
        if self.observatory is not None:
            self.observatory.note_arrivals(model)
        if self._retry_policy is not None and retry_attempt == 0:
            # First attempts FUND the budget (work-conserving fraction
            # of real demand); retries only spend it.
            self._retry_budget(model).record_first_attempt()
        return self.queues.queue(model).add_request(
            SimRequest(
                model=model,
                arrival_ms=self.clock.now_ms(),
                slo_ms=entry.slo_ms,
                seq_len=entry.seq_len,
                qos_class=qos_class,
                tenant=tenant,
                prefill_ms=prefill_ms,
                retry_attempt=retry_attempt,
                poison_id=poison_id,
            )
        )

    # --- client-retry model ------------------------------------
    def enable_retries(self, max_attempts: int = 3,
                       backoff_ms: float = 50.0,
                       budget_fraction: Optional[float] = None,
                       budget_window: int = 512,
                       min_first_attempts: int = 16) -> None:
        """Turn stale sheds into client resubmissions with fresh
        deadlines — the retry amplification loop. Each shed consults a
        per-model :class:`RetryBudget` (the live serve-tier class, not a
        re-expression): ``budget_fraction=None`` models naive clients
        (unbounded retries — the metastable control arm), a fraction
        bounds retry volume to that share of first-attempt demand, and
        the admission governor's congested state zeroes it entirely."""
        if max_attempts < 1:
            raise ValueError("retry max_attempts must be >= 1")
        if backoff_ms < 0:
            raise ValueError("retry backoff_ms must be >= 0")
        self._retry_policy = RetryBudgetPolicy(
            fraction=budget_fraction, window=budget_window,
            min_first_attempts=min_first_attempts,
        )
        self.retry_max_attempts = int(max_attempts)
        self.retry_backoff_ms = float(backoff_ms)
        self.queues.on_stale = self._on_stale_shed
        for q in self.queues.queues().values():
            q.on_stale = self._on_stale_shed

    def _retry_budget(self, model: str) -> RetryBudget:
        budget = self.retry_budgets.get(model)
        if budget is None:
            budget = RetryBudget(f"sim:{model}", self._retry_policy)
            self.retry_budgets[model] = budget
        return budget

    def _on_stale_shed(self, queue, req: SimRequest) -> None:
        """Stale-shed hook: the client saw a deadline miss and retries —
        unless it has exhausted its attempts or the budget denies the
        resubmission (the defense that keeps recovery monotone)."""
        attempt = req.retry_attempt
        if attempt + 1 >= self.retry_max_attempts:
            self.retry_exhausted[req.model] = (
                self.retry_exhausted.get(req.model, 0) + 1
            )
            return
        if not self._retry_budget(req.model).try_spend("retry"):
            self.retry_denied[req.model] = (
                self.retry_denied.get(req.model, 0) + 1
            )
            return
        self.retry_submitted[req.model] = (
            self.retry_submitted.get(req.model, 0) + 1
        )
        per_cls = self.retry_submitted_classes.setdefault(req.model, {})
        per_cls[req.qos_class] = per_cls.get(req.qos_class, 0) + 1
        delay_ms = max(self.retry_backoff_ms * (2 ** attempt), 0.001)
        self.loop.schedule_in(
            delay_ms,
            lambda m=req.model, q=req.qos_class, t=req.tenant,
            pm=req.prefill_ms, p=req.poison_id, a=attempt + 1:
            self.submit(m, qos_class=q, tenant=t, prefill_ms=pm,
                        poison_id=p, retry_attempt=a),
        )

    def _note_poison(self, poison_id: str, model: str) -> None:
        """Engine-side bisection condemned a query of death: quarantine
        its id cluster-wide (the sim twin of the registry gossip) so a
        repeat submission is fenced at the front door."""
        new = poison_id not in self._poison_quarantined
        self._poison_quarantined.add(poison_id)
        self.poison_isolations.append({
            "t_s": round(self.clock.now_s(), 6),
            "model": model,
            "poison_id": poison_id,
            "new": new,
        })
        if new:
            self.audit.record(
                "poison_quarantine",
                key=model,
                observed={"poison_id": poison_id},
                diff={"quarantined": poison_id},
                note="query of death isolated by batch bisection; "
                     "repeats fence at the front door",
            )

    # --- scheduling: decide via the shared pure step, apply to sim engines
    def rebalance(
        self,
        rates: Optional[Dict[str, float]] = None,
        trigger: str = "manual",
    ) -> List[NodePlan]:
        rates = rates if rates is not None else self.rates.rates()
        # A gray-EJECTED engine leaves planning exactly like a dead one
        # (the chip is reclaimed); probation prices as fractional
        # capacity via decide_replan's derate pass.
        alive = [
            e for e in self.engines
            if e.healthy() and e.engine_id not in self._gray_ejected
        ]
        factors = None
        if self.gray is not None:
            factors = [self.gray.capacity_factor(e.engine_id)
                       for e in alive]
        # Slice geometry (same surface LiveScheduler reads): widths/
        # shapes of the surviving schedulable units, so the shared
        # decide step degrades TP sessions and matches by width.
        widths = [e.width for e in alive]
        meshes = [e.mesh_shape for e in alive]
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
                "ts": self.clock.now_s(),
                "rates": dict(rates),
                "nodes": [n.describe() for n in decision.plan],
            }
        )
        self.audit.record(trigger, **decision.audit_fields())
        return decision.plan

    # --- monitor loop as a recurring event --------------------------------
    def start_monitoring(self, until_ms: float) -> None:
        """Arm the recurring monitor. The first tick fires 1 ms BEFORE
        the interval boundary: the rate window buckets by integer
        second, so a monitor aligned exactly on second boundaries would
        always read an empty partial bucket — a systematic ~1/window
        under-read no live deployment (whose phase is arbitrary) is
        pinned to. The -1 ms phase reads full buckets instead.

        interval <= 0 means monitoring is DISABLED (only warm-start /
        manual rebalances happen) — re-arming at zero delay would spin
        the event loop at one virtual instant forever."""
        if self.monitoring_interval_s <= 0:
            return
        self._monitor_until_ms = until_ms
        self.loop.schedule_in(
            max(self.monitoring_interval_s * 1000.0 - 1.0, 1.0),
            self._on_monitor,
        )

    def check_engine_health(self) -> bool:
        """Mirror of ``LiveScheduler.check_engine_health``: detect newly
        dead engines at the monitor tick (same detection lag the live
        control loop pays) and replan over survivors — failure-driven,
        so it bypasses the rate cold-window guard.

        Slice deaths additionally RE-FORM: a dead chip takes its whole
        slice (SliceDeadError semantics), but the other chips in the
        gang are good silicon — they come back as the widest
        power-of-two sub-slices that fit (a broken 1x4 re-forms as a
        1x2 + a 1x1), so the heal replan runs over the TRUE surviving
        geometry and ``degrade_sessions`` can re-shape a TP=4 model to
        its TP=2 profile row on the re-formed half-slice."""
        newly_dead = [
            e for e in self.engines
            if e.engine_id not in self._dead_engines and not e.healthy()
        ]
        if not newly_dead:
            return False
        observed: Dict = {}
        slices: Dict = {}
        for e in newly_dead:
            self._dead_engines.add(e.engine_id)
            if e.width <= 1:
                continue
            reformed = self._reform_slices(e)
            slices[e.engine_id] = {
                "width": e.width,
                "dead_chip": e.failed_chip,
                "reformed": [
                    {"engine": n.engine_id, "width": n.width}
                    for n in reformed
                ],
            }
        observed["dead_engines"] = sorted(self._dead_engines)
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

    def _reform_slices(self, dead: SimEngine) -> List[SimEngine]:
        """Regroup a dead slice's surviving chips into the widest
        power-of-two sub-slices and enroll them as fresh schedulable
        units (started, gray-tracked when monitoring is armed). The
        next rebalance — fired by the caller — places over them."""
        survivors = dead.surviving_chips()
        reformed: List[SimEngine] = []
        serial = 0
        while survivors:
            w = 1
            while w * 2 <= len(survivors):
                w *= 2
            chips, survivors = survivors[:w], survivors[w:]
            engine = SimEngine(
                f"{dead.engine_id}r{serial}",
                self.queues,
                self.packer.profiles,
                self.loop,
                self.clock,
                idle_wait_ms=dead.idle_wait_ms,
                jitter_rng=dead.jitter_rng,
                occupancy_model=dead.occupancy_model,
                occupancy_floor=dead.occupancy_floor,
                width=w,
                chip_ids=chips,
            )
            serial += 1
            if self.gray is not None:
                engine.track_ratios = True
            engine.on_poison = self._note_poison
            self.engines.append(engine)
            engine.start()
            reformed.append(engine)
        return reformed

    def check_gray_health(self) -> bool:
        """The gray analogue of :meth:`check_engine_health`: tick the
        detector with each engine's fresh observed/expected step ratios
        and replan when any verdict changed (probation reprices the
        engine as fractional capacity; ejection reclaims it like a
        death). Returns True when a gray replan fired."""
        if self.gray is None:
            return False
        live = [e for e in self.engines
                if e.healthy() and e.engine_id not in self._gray_ejected]
        # Synthetic probation probes: the probation replan may have
        # emptied an engine's plan; the LIVE router still probes a
        # probationed replica (one request per probe window). The sim
        # twin: one probe per tick reading the engine's current cost
        # ratio (stall included — a stall-only straggler must not grade
        # healthy), so a heal stays observable.
        probes = {
            e.engine_id: e.probe_ratio() for e in live
            if self.gray.state(e.engine_id) == "probation"
        }
        obs = ratio_observations(
            {e.engine_id: e.drain_ratios() for e in live},
            self._gray_windows, self._gray_window_ticks, probes=probes,
        )
        transitions = self.gray.tick(obs)
        # Replan only on transitions that change the planner's PRICING
        # (into/out of probation, or ejection): healthy<->suspect leaves
        # every capacity factor at 1.0, so a replan would re-pack the
        # identical inputs and emit audit noise.
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

    def _fidelity_price(self, model: str) -> Optional[Dict[str, float]]:
        """The cost model's BELIEF about one request's engine.step cost:
        the profile row for the model's placement in the CURRENT plan —
        jitter-free, degradation-blind (that blindness is the signal the
        fidelity monitor exists to measure). Prices ONLY engine.step:
        queue.wait is emergent from load, not priced by the profile
        tables, so it must land in ``ungraded`` — a mispriced engine
        can never defame the queue, and vice versa. None when the model
        is not placed (unpriced, counted — never silently graded)."""
        for node_plan in self._current_plan:
            for p in node_plan.placements:
                if p.session.model != model:
                    continue
                prof = self.packer.profiles.get(model)
                row = None
                if prof is not None:
                    row = (prof.row_for(p.batch_size, p.session.seq_len,
                                        p.session.mesh_shape,
                                        p.session.spec)
                           or prof.bucket_for(p.batch_size,
                                              p.session.seq_len,
                                              p.session.mesh_shape,
                                              p.session.spec))
                ms = p.latency_ms if row is None else row.latency_ms
                return {"engine.step": float(ms)}
        return None

    def _on_monitor(self) -> None:
        # Horizon check at FIRE time, not re-arm time: a tick armed just
        # before duration_s would otherwise land in the drain phase and
        # replan on decaying rates — live runs stop their monitor at the
        # workload's end, and with a dead engine such a drain replan can
        # truncate a model off the shrunken cluster and strand its queue.
        if self.clock.now_ms() >= self._monitor_until_ms:
            return
        if self.admission is not None:
            # Same congestion signals the live controller feeds the
            # governor: queue-fill fraction + recent SLO compliance.
            for name, q in self.queues.queues().items():
                self.admission.observe(
                    name, len(q) / max(1, q.max_len), q.slo_compliance()
                )
        if self._retry_policy is not None:
            self._sample_attainment()
        healed = self.check_engine_health()
        grayed = self.check_gray_health()
        changed = self.rates.changed_models(
            self.rate_threshold, self.rate_decrease_multiplier,
            min_span_s=self.rate_min_span_s,
        )
        if changed and not healed and not grayed:  # those already replanned
            self.rebalance(trigger="rate_change")
        if self.observatory is not None:
            # One observatory tick per monitor tick — cumulative class
            # counters + the live hop sketches, same signals the serve
            # controller feeds it (shared classes, shared diet).
            self.observatory.tick(
                {name: q.class_stats()
                 for name, q in self.queues.queues().items()},
                self.rates,
                {name: dict(q.hop_sketches)
                 for name, q in self.queues.queues().items()},
            )
        self.loop.schedule_in(
            max(self.monitoring_interval_s * 1000.0, 1.0),
            self._on_monitor,
        )

    def _sample_attainment(self) -> None:
        """One monitor-tick sample of WINDOWED weighted attainment per
        model (counter deltas since the previous tick, priced by the
        shared :func:`weighted_attainment`) — the recovery timeline the
        metastability pin reads: did attainment return to its pre-fault
        level within the horizon, or did retries keep it pinned down?
        Also mirrors the live controller's congested push: the
        governor's verdict zeroes the model's retry budget."""
        counted = ("completed", "violations", "stale", "dropped",
                   "enqueued")
        sample: Dict[str, Dict[str, float]] = {}
        for name in sorted(self.queues.queues()):
            q = self.queues.queues()[name]
            if self.admission is not None:
                self._retry_budget(name).set_congested(
                    self.admission.congested(name)
                )
            cur = q.class_stats()
            prev = self._attainment_prev.get(name, {})
            delta = {
                cls: {k: c.get(k, 0.0) - prev.get(cls, {}).get(k, 0.0)
                      for k in counted}
                for cls, c in cur.items()
            }
            self._attainment_prev[name] = {
                cls: {k: c.get(k, 0.0) for k in counted}
                for cls, c in cur.items()
            }
            sample[name] = {
                "weighted_attainment": weighted_attainment(delta),
                "completed": sum(d["completed"] for d in delta.values()),
                "congested": (
                    1.0 if self._retry_budget(name).congested else 0.0
                ),
            }
        self.attainment_timeline.append({
            "t_s": round(self.clock.now_s(), 6),
            "models": sample,
        })

    def retry_report(self) -> Dict:
        """Report block for the retry model (rendered only when the
        scenario enables it — canon stays byte-identical)."""
        return {
            "max_attempts": self.retry_max_attempts,
            "backoff_ms": self.retry_backoff_ms,
            "budgets": {m: b.stats()
                        for m, b in sorted(self.retry_budgets.items())},
            "resubmitted": dict(sorted(self.retry_submitted.items())),
            "resubmitted_classes": {
                m: dict(sorted(c.items()))
                for m, c in sorted(self.retry_submitted_classes.items())
            },
            "denied": dict(sorted(self.retry_denied.items())),
            "exhausted": dict(sorted(self.retry_exhausted.items())),
            "attainment_timeline": list(self.attainment_timeline),
        }

    def poison_report(self) -> Dict:
        """Report block for query-of-death injections (rendered only
        when the scenario injects poison)."""
        return {
            "injected": dict(sorted(self.poison_injected.items())),
            "fenced": dict(sorted(self.poison_fenced.items())),
            "quarantined": sorted(self._poison_quarantined),
            "isolations": list(self.poison_isolations),
            "engines": {
                e.engine_id: {
                    "probes": e.poison_probes,
                    "isolated": e.poison_isolated,
                    "rescues": e.poison_rescues,
                }
                for e in sorted(self.engines, key=lambda e: e.engine_id)
                if e.poison_isolated
            },
        }

    # --- observability (live snapshot shape) ------------------------------
    # snapshot()/schedule_log mirror LiveScheduler's surface on purpose:
    # they are the embedding API for dashboards/tools that render a
    # simulated domain exactly like a live one, not internal plumbing
    # (the report reads the audit ring directly).
    def snapshot(self) -> Dict:
        return {
            "time": self.clock.now_s(),
            "rates_rps": self.rates.rates(),
            "scheduled_rates_rps": self.rates.scheduled_rates(),
            "queues": self.queues.stats(),
            "plan": [n.describe() for n in self._current_plan],
            "engines": [e.describe() for e in self.engines],
            "schedule_changes": self.schedule_changes,
            "audit": self.audit.to_dicts(last=20),
        }
