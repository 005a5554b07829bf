"""Live LLM scheduler — token-rate monitoring, colocation replan, migration.

Own copy of ``ray_dynamic_batching_tpu/scheduler/llm_control.py``, whole,
with its import paths rewritten and one change: a replan keeps each
hosted engine's shape while that shape still serves its model's new rate
(:meth:`LLMLiveScheduler._keep_hosted_shapes`), where the reference
applies the packer's plan as it comes and so moves an engine between
tied rows on rate noise. Engines are the port's
:class:`~ray_dynamic_batching_tpu_torch.engine.decode.DecodeEngine`; the
factory receives the chip's ``device`` (a ``torch.device`` on a card,
``None`` for an unpinned executor). One executor per card; plans over
several chips run on the CPU over several executors, as the reference's
tests run them. A "weight upload + compile" below is, in the port, an
engine build and warmup on the card.

The decode-side control plane: the LLM analogue of
the JAX package's ``scheduler/control.py::LiveScheduler`` (not ported
yet; itself modeled on the reference's ``NexusScheduler`` monitor/rebalance
loop, ``293-project/src/scheduler.py:602-929``). Per-model **token**
rates (decode demand, tokens/s) feed the colocation planner
(``scheduler.nexus.pack_llm_engines``); when a rate drifts past the
threshold the plan is recomputed and applied with minimal movement:
models keep their chip when their placement is unchanged, and a moved
model's old engine *drains* (in-flight sequences finish where they
started) while its successor admits from the model's shared queue on the
new chip — the decode version of the reference's live rebalance
(``293-project/src/scheduler.py:773-929``), with the drain discipline
replacing its transfer of queued work.

Execution rides :class:`~ray_dynamic_batching_tpu_torch.engine.colocate.
ColocatedLLMEngines` (one per chip). Engines are built by a caller-
supplied factory so tests and deployments choose weights/sharding;
:func:`deployment_engine_factory` adapts a dict of
:class:`~ray_dynamic_batching_tpu_torch.serve.llm.LLMDeployment` objects.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ray_dynamic_batching_tpu_torch.engine.colocate import ColocatedLLMEngines
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager, RequestQueue
from ray_dynamic_batching_tpu_torch.engine.rates import RateRegistry
from ray_dynamic_batching_tpu_torch.utils.concurrency import assert_owner
from ray_dynamic_batching_tpu_torch.engine.request import Request, RequestDropped
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
from ray_dynamic_batching_tpu_torch.scheduler.audit import AuditLog, plan_diff
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    LLMPlacement,
    LLMSession,
    pack_llm_engines,
)
from ray_dynamic_batching_tpu_torch.utils.config import get_config
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("llm_control")

EngineFactory = Callable[[str, LLMPlacement, RequestQueue, object],
                         DecodeEngine]


@dataclass
class LLMModelEntry:
    """Registered decode serving contract (ref models_config,
    ``293-project/src/scheduler.py:30-35`` — here per-token, not
    per-request)."""

    name: str
    token_slo_ms: float
    min_context: int = 0
    # Demand estimate for requests that don't carry max_new_tokens: the
    # rate registry counts TOKENS, so each submission records its decode
    # demand up front (the monitor sees offered load, not completions —
    # same inversion-avoidance as LiveScheduler.submit_request).
    tokens_per_request: int = 64


def deployment_engine_factory(
    deployments: Dict[str, "object"],
) -> EngineFactory:
    """Adapt ``{model_name: LLMDeployment}`` to the factory protocol:
    the planner's placement dictates (num_slots, capacity); the
    deployment supplies weights, buckets, and horizons."""

    def factory(model: str, placement: LLMPlacement,
                queue: RequestQueue, device: object) -> DecodeEngine:
        return deployments[model].build_engine(
            queue, device=device, max_len=placement.capacity,
            num_slots=placement.num_slots,
        )

    return factory


class LLMLiveScheduler:
    """The running decode control plane for a set of chips."""

    def __init__(
        self,
        decode_profiles: Dict[str, BatchProfile],
        chips: Sequence[ColocatedLLMEngines],
        engine_factory: EngineFactory,
        queues: Optional[QueueManager] = None,
        rates: Optional[RateRegistry] = None,
        compute_headroom: float = 0.85,
        hbm_budget_bytes: Optional[int] = None,
        metrics_path: Optional[str] = None,
        clock=time.monotonic,
    ) -> None:
        cfg = get_config()
        self.profiles = dict(decode_profiles)
        self.chips = list(chips)
        self.engine_factory = engine_factory
        self.queues = queues or QueueManager(max_len=cfg.max_queue_len)
        self.rates = rates or RateRegistry(window_s=cfg.rate_window_s,
                                           clock=clock)
        self.compute_headroom = compute_headroom
        self.hbm_budget_bytes = hbm_budget_bytes
        self.metrics_path = metrics_path
        self.monitoring_interval_s = cfg.monitoring_interval_s
        self.rate_threshold = cfg.rate_change_threshold
        self.rate_decrease_multiplier = cfg.rate_decrease_multiplier
        self._clock = clock
        self._models: Dict[str, LLMModelEntry] = {}
        self._current_plan: List[List[LLMPlacement]] = []
        self._closed = False
        # RLock: chip quarantine replans while already holding the lock.
        self._lock = threading.RLock()
        self.quarantined: List[ColocatedLLMEngines] = []
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.schedule_changes = 0
        self.migrations = 0
        self.engine_replacements = 0
        self.chip_quarantines = 0
        # Stalled-engine detection (the decode analogue of replica
        # health replacement): an engine WITH WORK whose heartbeat
        # hasn't moved in this long, on a chip whose executor is
        # demonstrably passing, is failing its turns — rebuild it.
        self.engine_stall_timeout_s = 60.0
        # Chip-level: an executor thread that stopped completing passes
        # is wedged inside a device call — its HBM cannot be freed
        # safely; the chip is quarantined and its models replanned onto
        # the survivors.
        self.chip_stall_timeout_s = 120.0
        self.schedule_log: List[Dict] = []
        # Structured replan ring (scheduler/audit.py): every decode-plane
        # decision — rate-triggered replans, quarantines, health rebuilds.
        self.audit = AuditLog("llm")

    # --- registration ------------------------------------------------------
    def register_model(
        self,
        name: str,
        token_slo_ms: float,
        min_context: int = 0,
        tokens_per_request: int = 64,
    ) -> None:
        if name not in self.profiles:
            raise KeyError(f"no decode profile for model {name!r} — run "
                           "the decode profiler (tools/run_profiles.py)")
        self._models[name] = LLMModelEntry(
            name, token_slo_ms, min_context, tokens_per_request
        )

    # --- ingress -----------------------------------------------------------
    def submit_request(self, request: Request) -> bool:
        entry = self._models.get(request.model)
        if entry is None:
            request.reject(
                KeyError(f"model {request.model!r} not registered")
            )
            return False
        if not self.chips:
            # Every chip quarantined: accepting would enqueue into
            # queues nothing can ever drain — fail fast instead.
            request.reject(RequestDropped(
                "no serving chips remain (all quarantined)"
            ))
            return False
        tokens = entry.tokens_per_request
        if isinstance(request.payload, dict):
            tokens = int(
                request.payload.get("max_new_tokens", tokens)
            )
        # Offered decode demand, recorded before the enqueue outcome
        # (drops must not suppress the scale-up signal).
        self.rates.record(request.model, n=max(1, tokens))
        return self.queues.queue(request.model).add_request(request)

    # --- planning ----------------------------------------------------------
    def _sessions_for(
        self, rates: Dict[str, float]
    ) -> List[LLMSession]:
        return [
            LLMSession(
                model=e.name,
                rate_tok_s=rates.get(e.name, 0.0),
                token_slo_ms=e.token_slo_ms,
                min_context=e.min_context,
            )
            for e in self._models.values()
            if rates.get(e.name, 0.0) > 0.0
        ]

    def _match_chips(
        self, plan: List[List[LLMPlacement]]
    ) -> List[Optional[List[LLMPlacement]]]:
        """Assign planned chips to executors maximizing kept models
        (minimal movement — the decode version of
        ``control.match_plans_to_engines``'s objective; overlap count
        stands in for transfer cost because every move costs a weight
        upload + compile here too)."""
        hosted = [set(c.models()) for c in self.chips]
        assignment: List[Optional[List[LLMPlacement]]] = (
            [None] * len(self.chips)
        )
        free = set(range(len(self.chips)))
        # Largest chips pick first so a big overlap isn't stolen by a
        # singleton plan.
        for planned in sorted(plan, key=len, reverse=True):
            names = {p.model for p in planned}
            best = max(
                free,
                key=lambda i: (len(names & hosted[i]), -len(hosted[i])),
            )
            assignment[best] = planned
            free.remove(best)
        return assignment

    def rebalance(
        self,
        rates: Optional[Dict[str, float]] = None,
        trigger: str = "manual",
    ) -> List[List[LLMPlacement]]:
        """Re-run colocation packing and migrate with minimal movement."""
        with self._lock:
            if self._closed:
                return self._current_plan
            if rates is None:
                rates = dict(self.rates.rates())
                # Cold-window readings are extrapolations (up to ~2x
                # inflated); for models already under contract, plan from
                # the last scheduled rate until the window has evidence —
                # otherwise the packer resizes fractions on noise even
                # though changed_models filtered the *trigger*. Models
                # with no baseline keep the raw reading (first placement
                # beats waiting half a window), and so does an EMPTY
                # window (span 0 = traffic stopped: resurrecting the old
                # contract would keep planning a dead model forever).
                min_span = self.rates.window_s / 2.0
                scheduled = self.rates.scheduled_rates()
                for m in list(rates):
                    span = self.rates.tracker(m).span_s()
                    if scheduled.get(m) and 0 < span < min_span:
                        rates[m] = scheduled[m]
            sessions = self._sessions_for(rates)
            try:
                plan = pack_llm_engines(
                    sessions,
                    self.profiles,
                    hbm_budget_bytes=self.hbm_budget_bytes,
                    compute_headroom=self.compute_headroom,
                ) if sessions else []
            except ValueError as e:
                # Infeasible demand: keep serving under the previous plan
                # rather than tearing engines down (the SLO viewer shows
                # red; the operator re-profiles or relaxes).
                logger.warning("rebalance infeasible, keeping plan: %s", e)
                self.audit.record(
                    trigger,
                    observed={"rates_tok_s": {k: round(v, 1)
                                              for k, v in rates.items()}},
                    note=f"infeasible, kept previous plan: {e}",
                )
                return self._current_plan
            plan = self._keep_hosted_shapes(sessions, plan)
            if len(plan) > len(self.chips):
                if self._current_plan:
                    # Over capacity: applying a truncated plan would DRAIN
                    # the dropped models while submit_request keeps
                    # accepting their traffic — keep the previous
                    # (serving) assignment instead, exactly like the
                    # infeasible branch above.
                    logger.warning(
                        "plan needs %d chips but only %d executors — "
                        "keeping previous plan (capacity!)",
                        len(plan), len(self.chips),
                    )
                    self.audit.record(
                        trigger,
                        observed={"rates_tok_s": {
                            k: round(v, 1) for k, v in rates.items()}},
                        note=(f"over capacity ({len(plan)} chips needed, "
                              f"{len(self.chips)} available), kept "
                              "previous plan"),
                    )
                    return self._current_plan
                # Nothing is serving yet (first plan): a truncated plan
                # that serves len(chips) chips' worth of models beats an
                # empty one that serves nobody.
                logger.warning(
                    "plan needs %d chips but only %d executors — serving "
                    "the first %d planned chips (capacity!)",
                    len(plan), len(self.chips), len(self.chips),
                )
                plan = plan[: len(self.chips)]
            assignment = self._match_chips(plan)
            hosted_before = [sorted(c.models()) for c in self.chips]
            moved = self._apply(assignment)
            hosted_after = [
                sorted(p.model for p in (chip or [])) for chip in assignment
            ]
            self._current_plan = plan
            self.rates.mark_scheduled(rates)
            self.schedule_changes += 1
            self.migrations += moved
            self.audit.record(
                trigger,
                observed={"rates_tok_s": {k: round(v, 1)
                                          for k, v in rates.items()}},
                inputs={
                    # The committed decode-table rows the packer sized from.
                    "placements": [
                        {"model": p.model, "slots": p.num_slots,
                         "capacity": p.capacity,
                         "compute_fraction": round(p.compute_fraction, 3)}
                        for chip in plan for p in chip
                    ],
                },
                before=[", ".join(m) for m in hosted_before],
                after=[", ".join(m) for m in hosted_after],
                diff=plan_diff(hosted_before, hosted_after),
                # Every engine move costs a weight upload + compiles; the
                # moved count is the decode plane's migration cost unit.
                migration_cost=float(moved),
            )
            self.schedule_log.append({
                "ts": self._clock(),
                "rates_tok_s": {k: round(v, 1) for k, v in rates.items()},
                "chips": [
                    [
                        f"{p.model}(slots={p.num_slots}, cap={p.capacity}, "
                        f"f={p.compute_fraction:.2f})"
                        for p in (chip or [])
                    ]
                    for chip in assignment
                ],
                "moved_engines": moved,
            })
            logger.info(
                "rebalance #%d: %d chips, %d engine moves for rates %s",
                self.schedule_changes, len(plan), moved,
                {k: round(v, 1) for k, v in rates.items()},
            )
            return plan

    def _keep_hosted_shapes(
        self, sessions: List[LLMSession], plan: List[List[LLMPlacement]]
    ) -> List[List[LLMPlacement]]:
        """The plan again, with each hosted engine keeping its (slots,
        capacity) wherever that measured row still serves the model's new
        rate, unless keeping them costs a chip.

        Host-bound decode steps are flat in the slot count, so several
        rows tie on the SLO term and the packer's HBM tie-break follows
        the rate reading across the tie: a reading within its window's
        noise would move an engine to another shape, and every move is a
        drain, a build and a warmup in which the model admits nothing.
        With one row per model this returns the packer's plan."""
        hosted = {m: p for chip in self.chips
                  for m, p in chip.placements().items()}
        kept: Dict[str, BatchProfile] = {}
        for s in sessions:
            cur, profile = hosted.get(s.model), self.profiles.get(s.model)
            if cur is None or profile is None:
                continue
            rows = [r for r in profile.rows if r.spec == "off"
                    and (r.batch_size, r.seq_len)
                    == (cur.num_slots, cur.capacity)]
            if not rows:
                continue
            own = BatchProfile(profile.model_name, rows)
            try:        # the hosted row alone must serve the session
                pack_llm_engines([s], {s.model: own},
                                 hbm_budget_bytes=self.hbm_budget_bytes,
                                 compute_headroom=self.compute_headroom)
            except ValueError:
                continue
            kept[s.model] = own
        if not kept:
            return plan
        sticky = pack_llm_engines(sessions, {**self.profiles, **kept},
                                  hbm_budget_bytes=self.hbm_budget_bytes,
                                  compute_headroom=self.compute_headroom)
        return sticky if len(sticky) <= len(plan) else plan

    def _apply(
        self, assignment: List[Optional[List[LLMPlacement]]]
    ) -> int:
        """Diff each chip's desired placement set against what it hosts;
        drain leavers, build/attach joiners. Returns engines moved."""
        moved = 0
        apply_deadline = time.monotonic() + 60.0  # whole-pass drain budget
        desired_by_chip: List[Dict[str, LLMPlacement]] = [
            {p.model: p for p in (chip or [])} for chip in assignment
        ]
        # Detach pass first: a model moving chips must stop admitting on
        # its old chip before the new engine attaches, so the shared
        # queue never feeds two admitting engines.
        drain_events: Dict[tuple, threading.Event] = {}
        for ci, (chip, desired) in enumerate(
            zip(self.chips, desired_by_chip)
        ):
            current = chip.placements()
            for model in chip.models():
                cur = current.get(model)
                want = desired.get(model)
                if want is None or not self._same_shape(cur, want):
                    drain_events[(ci, model)] = chip.detach(
                        model, drain=True
                    )
                    moved += 1
        for ci, (chip, desired) in enumerate(
            zip(self.chips, desired_by_chip)
        ):
            hosted = set(chip.models())
            for model, placement in desired.items():
                if model in hosted:
                    continue
                # Same-chip shape change: wait for the predecessor's HBM
                # to come back (drain completes, buffers released) before
                # building the successor — a chip packed near the budget
                # line cannot hold both copies of the weights + KV at
                # once. Only meaningful when the executor loop is running
                # to actually drive the drain. Bounded by ONE deadline
                # across the whole apply pass (not per model — _apply
                # runs under _lock, and shutdown/monitor block on that
                # lock), and aborted early when shutdown signals _stop;
                # on expiry it degrades to the transient double
                # residency instead of freezing the control plane.
                ev = drain_events.get((ci, model))
                if ev is not None and chip.running:
                    while (not ev.is_set()
                           and not self._stop.is_set()
                           and time.monotonic() < apply_deadline):
                        ev.wait(timeout=0.25)
                    if not ev.is_set():
                        logger.warning(
                            "%s: %s drain slow — attaching successor "
                            "with predecessor still resident",
                            chip.name, model,
                        )
                engine = self.engine_factory(
                    model, placement, self.queues.queue(model), chip.device
                )
                chip.attach(model, engine, placement)
        return moved

    @staticmethod
    def _same_shape(cur: Optional[LLMPlacement],
                    want: LLMPlacement) -> bool:
        """An engine survives a replan iff its compiled shapes match the
        new placement; fraction changes alone don't force a rebuild."""
        return (
            cur is not None
            and cur.num_slots == want.num_slots
            and cur.capacity == want.capacity
        )

    # --- health: stalled-engine replacement --------------------------------
    def check_engine_health(
        self, stall_timeout_s: Optional[float] = None
    ) -> int:
        """Replace engines that have work but whose turns stopped
        succeeding (heartbeat refreshes only on completed turns — a
        repeatedly-raising engine reads stale while its queue rots).
        Only chips whose executor loop is PROVABLY passing are
        considered: a stale heartbeat on a non-passing chip means the
        executor itself is stuck (possibly inside this engine's device
        call) and releasing buffers under it would be a use-after-free —
        that failure needs chip-level quarantine, not an engine swap.
        The swap itself happens on the executor thread at a pass
        boundary (``ColocatedLLMEngines.replace``), for the same reason.
        Ref: the replica heal path's stall contract
        (``serve/replica.py::healthy`` / controller replacement)."""
        timeout = (stall_timeout_s if stall_timeout_s is not None
                   else self.engine_stall_timeout_s)
        now = time.monotonic()
        replaced = 0
        with self._lock:
            if self._closed:
                return 0
            self._quarantine_wedged_chips(now)
            for chip in self.chips:
                if chip._thread is not None and not chip.running:
                    # The executor thread DIED (exited/crashed) rather
                    # than wedging: engine state is intact and no device
                    # call is in flight, so a restart is safe — without
                    # it the chip would be invisible to both health
                    # paths (they key on running executors).
                    logger.error(
                        "%s: executor thread died — restarting",
                        chip.name,
                    )
                    chip.start()
                    continue
                if not chip.running:
                    continue
                if now - chip.last_pass_monotonic > min(5.0, timeout):
                    continue  # executor not passing: not safe to swap
                placements = chip.placements()
                for model in chip.models():
                    engine = chip.engine_for(model)
                    if engine is None:
                        continue
                    has_work = (
                        engine.active_slots > 0
                        or len(engine.queue) > 0
                    )
                    if not has_work:
                        continue
                    if now - engine.last_heartbeat < timeout:
                        continue
                    placement = placements.get(model)
                    logger.warning(
                        "%s on %s: stalled %.0fs with work — rebuilding",
                        model, chip.name, now - engine.last_heartbeat,
                    )
                    successor = self.engine_factory(
                        model, placement, self.queues.queue(model),
                        chip.device,
                    )
                    chip.replace(model, successor, placement)
                    replaced += 1
                    self.engine_replacements += 1
                    self.audit.record(
                        "health",
                        key=model,
                        observed={
                            "stalled_s": round(
                                now - engine.last_heartbeat, 1),
                            "chip": chip.name,
                        },
                        diff={"engine_rebuilt": model},
                        migration_cost=1.0,
                        note="stalled engine with work rebuilt in place",
                    )
        return replaced

    def _quarantine_wedged_chips(self, now: float) -> None:
        """A RUNNING executor that stopped completing passes is wedged
        inside a device call: its engines' buffers can never be freed
        safely (the call may still be touching them), so the chip is
        written off — leaked deliberately, loudly — and its models
        replan onto the surviving chips. In-flight slot futures are
        rejected host-side (Request.reject/fulfill tolerate the wedged
        call completing later); queued work lives in the SHARED queues
        and flows to the replacements. Caller holds the lock."""
        assert_owner(self._lock)
        wedged = [
            chip for chip in self.chips
            if chip.running
            and (now - chip.last_progress_monotonic()
                 > self.chip_stall_timeout_s)
        ]
        for chip in wedged:
            logger.error(
                "%s: executor wedged (%.0fs since last pass) — "
                "quarantining the chip; its HBM is written off",
                chip.name, now - chip.last_pass_monotonic,
            )
            # Stop admissions if/when the wedged call ever returns: the
            # loop checks _run before the next pass and exits, so the
            # dead chip can never race its replacements for queue work.
            chip.stop(timeout_s=0.1)
            self.chips.remove(chip)
            self.quarantined.append(chip)
            self.chip_quarantines += 1
            self.audit.record(
                "quarantine",
                observed={
                    "chip": chip.name,
                    "stalled_s": round(
                        now - chip.last_pass_monotonic, 1),
                },
                diff={"chip_quarantined": chip.name,
                      "models_displaced": sorted(
                          m for m, _ in chip.hosted_engines())},
                note="wedged executor — HBM written off, models replanned "
                     "onto survivors",
            )
            # EVERY resident engine, draining predecessors included —
            # their drains can never finish on a wedged chip, and their
            # slots hold real futures too.
            for model, engine in chip.hosted_engines():
                exc = RequestDropped(
                    f"{model}: chip {chip.name} quarantined mid-flight"
                )
                for slot in getattr(engine, "_slots", []):
                    req = getattr(slot, "request", None)
                    if req is not None and not getattr(slot, "free", True):
                        req.reject(exc)
                # Requests the wedged _admit popped but never slotted —
                # in neither the queue nor a slot; without this they
                # hang forever (and the replacements can't serve them:
                # they're gone from the shared queue).
                for req in list(getattr(engine, "_admitting_batch", [])):
                    req.reject(exc)
        if wedged and not self._closed:
            # The previous plan references dead chips — keeping it (the
            # over-capacity / infeasible degradation branches) would
            # blackhole their models while submit_request keeps
            # accepting traffic. Invalidate UNCONDITIONALLY (even with
            # zero survivors, a stale truthy plan would poison every
            # later degradation branch), then replan onto whatever
            # survives (truncated if need be).
            self._current_plan = []
            if self.chips:
                self.rebalance(trigger="quarantine")

    # --- monitor loop ------------------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.monitoring_interval_s):
            try:
                self.check_engine_health()
                changed = self.rates.changed_models(
                    self.rate_threshold, self.rate_decrease_multiplier,
                    # Half a window of evidence before a replan: engine
                    # migration is expensive (weight upload + compiles),
                    # so cold-start extrapolation must not trigger it.
                    min_span_s=self.rates.window_s / 2.0,
                )
                if changed:
                    logger.info("token-rate change detected: %s",
                                {k: round(v, 1) for k, v in changed.items()})
                    self.rebalance(trigger="rate_change")
                if self.metrics_path:
                    self.write_metrics()
            except Exception:  # noqa: BLE001
                logger.exception("llm monitor iteration failed")

    def start_monitoring(self) -> None:
        if self._monitor is not None:
            return
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="rdb-llm-monitor", daemon=True
        )
        self._monitor.start()

    def stop_monitoring(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None

    def shutdown(self, timeout_s: float = 5.0) -> None:
        self.stop_monitoring()
        # Serialize with any in-flight rebalance (the monitor join above
        # can time out mid-_apply): taking the lock waits it out, and the
        # closed flag makes any later stragglers no-ops — otherwise a
        # straggling _apply would attach fresh engines to chips whose
        # loops are already stopped, leaking their HBM.
        with self._lock:
            self._closed = True
        for chip in self.chips:
            chip.shutdown(timeout_s)
        for chip in self.quarantined:
            # Best-effort: a still-wedged loop keeps its buffers (the
            # executor's own shutdown guard); an unwedged one cleans up.
            chip.shutdown(timeout_s=0.5)

    # --- observability -----------------------------------------------------
    def snapshot(self) -> Dict:
        return {
            "time": self._clock(),
            "rates_tok_s": self.rates.rates(),
            "scheduled_rates_tok_s": self.rates.scheduled_rates(),
            "queues": self.queues.stats(),
            "chips": [c.describe() for c in self.chips],
            "busy_fractions": [c.busy_fractions() for c in self.chips],
            "schedule_changes": self.schedule_changes,
            "migrations": self.migrations,
            "engine_replacements": self.engine_replacements,
            "chip_quarantines": self.chip_quarantines,
            "quarantined": [c.name for c in self.quarantined],
            "audit": self.audit.to_dicts(last=20),
        }

    def write_metrics(self) -> None:
        with open(self.metrics_path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)

    def render_status(self) -> str:
        """Terminal SLO status — the same table renderer the vision
        loop, state CLI, and dashboard share (rates shown in tok/s)."""
        from ray_dynamic_batching_tpu_torch.state import render_queue_table

        return render_queue_table(self.queues.stats(), self.rates.rates())
