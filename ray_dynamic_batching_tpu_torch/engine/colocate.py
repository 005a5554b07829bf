"""Colocated decode execution — N continuous-batching engines on ONE chip.

Own copy of ``ray_dynamic_batching_tpu/engine/colocate.py``, whole, with
its import paths rewritten. Where the reference scopes the executor's
thread with ``jax.default_device``, the port makes the card current
(``torch.cuda.device``; nothing on the CPU), and every turn runs under the
engine's own ``_device_ctx()``. A "compiled scan" below is, in the port,
one dispatch of the engine's decode program (a CUDA graph replay on the
card, ``ops/graphs.py``); a hosted engine's "HBM" is its card memory (the
cache and its scale planes, the penalty counts, its graphs' pool), which
``release_buffers`` drops.

``scheduler.nexus.pack_llm_engines`` plans which decode engines share a
chip by profiled compute fraction + resident HBM; this module is the
execution side of that plan — the decode analogue of the duty-cycle
executor (``engine/worker.py``), mirroring how the reference *executes*
its packed schedules rather than only computing them
(``293-project/src/scheduler.py:525-584``).

One driver thread interleaves the co-resident engines at **horizon
granularity**: each engine's turn is one admission pass plus one compiled
scan (``DecodeEngine._step`` — ``decode_horizon`` substeps per dispatch).
A compiled scan cannot be preempted mid-flight, so the scan IS the
scheduling quantum, exactly like the duty-cycle packer's no-preemption
occupancy discipline (``scheduler/nexus.py:86-88``).

Turns are **deficit-weighted by the planner's fractions**: each engine
banks credit in proportion to its placement's ``compute_fraction`` as
chip time elapses and pays its measured turn cost when it runs, so under
sustained backlog engine *i*'s share of chip time converges to the
fraction the plan ADMITTED it at (``scheduler/nexus.py:326-376``) — not
to the accidental ``step_i / sum(step_j)`` ratio plain round-robin
yields. Idle engines don't bank (their credit resets), so the executor
stays work-conserving: an engine with the chip's only backlog takes the
whole chip. :meth:`busy_fractions` exposes the measured shares so tests
can hold the plan to the execution.

Engines attach/detach live (the LLM control loop migrates models between
chips as token rates shift). Detach drains by default: the engine stops
admitting immediately — its request queue is the *model's* shared queue,
so new arrivals flow to wherever the model runs next — while in-flight
sequences finish here; the engine's HBM (params + KV cache) is released
only once its last slot completes.
"""

from __future__ import annotations

import collections
import statistics
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.request import RequestDropped
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("colocate")

BUSY_FRACTION = m.Gauge(
    "rdb_colocate_busy_fraction",
    "Measured share of executor wall time per co-resident engine "
    "(the ground truth the planner's compute_fraction predicts)",
    tag_keys=("chip", "model"),
)


@dataclass
class HostedEngine:
    """One co-resident engine plus its execution accounting."""

    model: str
    engine: DecodeEngine
    placement: Any = None          # LLMPlacement the planner assigned (if any)
    draining: bool = False
    busy_ms: float = 0.0           # wall time spent inside this engine's turns
    credit_ms: float = 0.0         # deficit round-robin balance
    released: threading.Event = field(default_factory=threading.Event)

    @property
    def weight(self) -> float:
        """Planned share of the chip: the placement's compute fraction,
        or 1.0 (equal split after normalization) when unplanned."""
        f = getattr(self.placement, "compute_fraction", None)
        return float(f) if f else 1.0

    def has_work(self) -> bool:
        if self.engine.active_slots > 0:
            return True
        return not self.draining and len(self.engine.queue) > 0


class ColocatedLLMEngines:
    """Round-robin interleaved execution of decode engines on one chip.

    Engines must arrive *un-started* (their own loop thread replaced by
    this executor's); all co-residents share the executor's device, which
    the executor's thread makes current for every dispatch.
    """

    def __init__(
        self,
        device: Optional[Any] = None,
        name: str = "chip0",
        idle_wait_s: float = 0.002,
    ) -> None:
        self.device = device
        self.name = name
        self.idle_wait_s = idle_wait_s
        self._hosted: Dict[str, HostedEngine] = {}
        self._lock = threading.RLock()
        self._run = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wall_ms = 0.0
        # Recent turn costs (median), for the credit clamp: a first-turn
        # XLA compile can cost seconds — charged raw, the debtor would
        # starve for hundreds of turns repaying chip time no tenant will
        # miss. Bounding credits to a few TYPICAL turns keeps transients
        # short while leaving long-run shares exactly weight-proportional.
        self._recent_costs: collections.deque = collections.deque(maxlen=32)
        # Between-chunk yields (long-prompt admissions): depth-1 guard +
        # nested-cost ledger so the yielding engine isn't billed for the
        # co-tenant scans that ran inside its turn.
        self._yielding = False
        self._nested_ms = 0.0
        # Deferred engine swaps (health-path replacement): applied at
        # the next PASS BOUNDARY by the executor thread itself, so a
        # wedged/failing engine is never released while a turn might be
        # inside it. Timestamp of the last completed pass is the
        # executor-liveness signal health checks key on.
        self._pending_replacements: Dict[str, Tuple[DecodeEngine, Any]] = {}
        self.last_pass_monotonic = time.monotonic()

    # --- membership (called by the control loop, any thread) ---------------
    def attach(self, model: str, engine: DecodeEngine,
               placement: Any = None) -> None:
        if engine._thread is not None:
            raise ValueError(
                f"{model}: engine already runs its own loop — colocated "
                "engines are stepped by the executor"
            )
        with self._lock:
            if model in self._hosted and not self._hosted[model].draining:
                raise ValueError(f"{model}: already hosted on {self.name}")
            # A draining predecessor keeps finishing under a temporary key
            # so its in-flight sequences aren't orphaned by the successor.
            if model in self._hosted:
                old = self._hosted.pop(model)
                self._hosted[f"{model}@draining{id(old)}"] = old
            hosted = HostedEngine(model, engine, placement)
            self._hosted[model] = hosted
            # Long-prompt admissions yield to co-tenants between chunks.
            engine.interleave_hook = (
                lambda h=hosted: self._yield_turn(h)
            )
        logger.info("%s: attached %s (slots=%d, cap=%d)", self.name, model,
                    engine.num_slots, engine.max_len)

    def replace(self, model: str, engine: DecodeEngine,
                placement: Any = None) -> None:
        """Health-path swap: the READY successor (built + warmed by the
        control loop) takes over at the next pass boundary — executed on
        the executor thread, so the failing predecessor is released
        outside any possible turn into it. Its in-flight requests are
        rejected (heal semantics: a wedged engine's slots are lost, the
        shared queue's backlog moves to the successor)."""
        if engine._thread is not None:
            raise ValueError(
                f"{model}: replacement engine already runs its own loop"
            )
        with self._lock:
            prior = self._pending_replacements.pop(model, None)
            self._pending_replacements[model] = (engine, placement)
        if prior is not None:
            # A second pend before the pass boundary: the dropped
            # successor's warm buffers must not leak.
            prior[0].release_buffers()

    def _apply_replacements(self) -> None:
        with self._lock:
            pending = self._pending_replacements
            self._pending_replacements = {}
        for model, (engine, placement) in pending.items():
            with self._lock:
                old = self._hosted.get(model)
                if old is None or old.draining:
                    # The model left this chip between pend and pass
                    # boundary (rebalance migrated or drained it):
                    # installing the successor would resurrect an
                    # off-plan SECOND admitter against the shared queue.
                    stale = engine
                else:
                    stale = None
                    self._hosted.pop(model, None)
                    self._release(old)
                    hosted = HostedEngine(model, engine, placement)
                    engine.interleave_hook = (
                        lambda h=hosted: self._yield_turn(h)
                    )
                    self._hosted[model] = hosted
            if stale is not None:
                stale.release_buffers()
                logger.warning(
                    "%s: dropped stale replacement for %s (model no "
                    "longer hosted here)", self.name, model,
                )
            else:
                logger.warning(
                    "%s: replaced %s (health path; slots=%d, cap=%d)",
                    self.name, model, engine.num_slots, engine.max_len,
                )

    def detach(self, model: str, drain: bool = True) -> threading.Event:
        """Stop admitting for ``model`` on this chip. With ``drain`` the
        in-flight sequences finish first; the returned event is set once
        the engine's buffers are released."""
        with self._lock:
            pending = self._pending_replacements.pop(model, None)
            hosted = self._hosted.get(model)
            if hosted is None:
                ev = threading.Event()
                ev.set()
                if pending is not None:
                    pending[0].release_buffers()
                return ev
            hosted.draining = True
            if not drain:
                self._release(hosted)
                self._hosted.pop(model, None)
        if pending is not None:
            # A detach cancels any queued health swap for the model —
            # its successor must neither resurrect the model here nor
            # leak its warm buffers.
            pending[0].release_buffers()
        return hosted.released

    def _release(self, hosted: HostedEngine) -> None:
        hosted.engine.interleave_hook = None
        hosted.engine.abort_active(
            RequestDropped(f"{hosted.model} detached from {self.name}")  # rdb-lint: disable=shed-accounting (detach is a replan decision already recorded in the scheduler audit ring; abort_active resolves each slot future, and the decode engine's slot stats count the aborts)
        )
        hosted.engine.release_buffers()
        hosted.released.set()
        # A departed model must not keep reporting its last share.
        BUSY_FRACTION.set(
            0.0, tags={"chip": self.name, "model": hosted.model}
        )
        logger.info("%s: released %s", self.name, hosted.model)

    def models(self) -> List[str]:
        with self._lock:
            return [m for m, h in self._hosted.items() if not h.draining]

    def placements(self) -> Dict[str, Any]:
        with self._lock:
            return {
                m: h.placement
                for m, h in self._hosted.items() if not h.draining
            }

    def engine_for(self, model: str) -> Optional[DecodeEngine]:
        with self._lock:
            h = self._hosted.get(model)
            return h.engine if h is not None and not h.draining else None

    def hosted_engines(self) -> List[Tuple[str, DecodeEngine]]:
        """EVERY resident engine — including draining predecessors,
        whose in-flight slots a chip quarantine must still reject."""
        with self._lock:
            return [
                (h.model, h.engine) for h in self._hosted.values()
                if not h.released.is_set()
            ]

    def last_progress_monotonic(self) -> float:
        """Most recent sign of life: pass starts OR completed engine
        turns OR fresh attaches (engines stamp their heartbeat at
        construction). Wedge detection keys on this rather than pass
        starts alone, so a legitimately long first-turn compile on a
        freshly built engine gets its full grace window instead of
        reading as a wedge."""
        with self._lock:
            beats = [
                h.engine.last_heartbeat for h in self._hosted.values()
            ]
        return max([self.last_pass_monotonic] + beats)

    # --- execution ---------------------------------------------------------
    def _turn(self, hosted: HostedEngine) -> Tuple[bool, float]:
        """One scheduling quantum for one engine: admit (unless draining),
        then at most one compiled scan. Returns (compute ran, cost ms) —
        cost EXCLUDES co-tenant scans that ran via between-chunk yields
        inside this turn (they bill their own engines)."""
        t0 = time.perf_counter()
        nested0 = self._nested_ms
        engine = hosted.engine
        stepped = False
        with engine._device_ctx():
            if not hosted.draining:
                engine._admit()
            if engine._active_mask.any():
                engine._step()
                stepped = True
        engine.last_heartbeat = time.monotonic()
        cost = (time.perf_counter() - t0) * 1000.0
        cost = max(0.0, cost - (self._nested_ms - nested0))
        hosted.busy_ms += cost
        return stepped, cost

    def _yield_turn(self, yielding: HostedEngine) -> None:
        """Between-chunk yield from a long admission: ONE step-only scan
        for the most-owed co-tenant with active work. Admission is not
        run here (a co-tenant's own long fill inside the yield would
        re-monopolize the chip); depth-1 guard stops recursion."""
        if self._yielding:
            return
        self._yielding = True
        try:
            with self._lock:
                others = [
                    h for h in self._hosted.values()
                    if h is not yielding and not h.released.is_set()
                ]
            workable = [h for h in others if h.engine.active_slots > 0]
            if not workable:
                return
            chosen = max(workable, key=lambda h: h.credit_ms)
            t0 = time.perf_counter()
            with chosen.engine._device_ctx():
                chosen.engine._step()
            chosen.engine.last_heartbeat = time.monotonic()
            cost = (time.perf_counter() - t0) * 1000.0
            chosen.busy_ms += cost
            self._nested_ms += cost
            pool = workable + [yielding]
            total_w = sum(h.weight for h in pool)
            for h in pool:
                h.credit_ms += cost * (h.weight / total_w)
            chosen.credit_ms -= cost
        except Exception:  # noqa: BLE001 — a co-tenant must not kill the fill
            logger.exception("%s: yield turn failed", self.name)
        finally:
            self._yielding = False

    def _finalize_drains(self, hosted) -> None:
        for key, h in hosted:
            if h.draining and h.engine.active_slots == 0:
                with self._lock:
                    self._release(h)
                    # Pop by identity: a concurrent attach may have put a
                    # REPLACEMENT engine under this snapshot's key (the
                    # drained predecessor was renamed) — popping by key
                    # alone would silently unhost the successor.
                    if self._hosted.get(key) is h:
                        self._hosted.pop(key, None)
                    else:
                        for k, v in list(self._hosted.items()):
                            if v is h:
                                self._hosted.pop(k, None)

    def _pass(self) -> bool:
        """One deficit-weighted quantum: run the most-owed engine that
        has work, then distribute its measured cost as credit in
        proportion to the backlogged engines' planned fractions."""
        self._apply_replacements()
        self.last_pass_monotonic = time.monotonic()
        with self._lock:
            hosted = list(self._hosted.items())
        self._finalize_drains(hosted)
        workable = []
        for key, h in hosted:
            if h.released.is_set():
                continue
            if h.has_work():
                workable.append(h)
            else:
                # Idle engines don't bank credit: a tenant returning
                # after a lull must not monopolize the chip repaying a
                # debt nobody accrued against real work.
                h.credit_ms = 0.0
        if not workable:
            return False
        chosen = max(workable, key=lambda h: h.credit_ms)
        try:
            stepped, cost = self._turn(chosen)
        except Exception:  # noqa: BLE001 — one engine must not kill the chip
            logger.exception("%s: turn failed for %s", self.name,
                             chosen.model)
            # Charge the failed turn a typical cost: with credits
            # untouched the max-credit pick would select the SAME broken
            # engine forever and starve every co-tenant (round-robin's
            # one virtue this scheduler must keep).
            penalty = max(
                statistics.median(self._recent_costs)
                if self._recent_costs else 1.0,
                1.0,
            )
            chosen.credit_ms -= penalty
            time.sleep(0.01)  # rdb-lint: disable=event-loop-blocking (failed-turn backoff on the colocation executor's own thread)
            return False
        total_w = sum(h.weight for h in workable)
        for h in workable:
            h.credit_ms += cost * (h.weight / total_w)
        chosen.credit_ms -= cost
        self._recent_costs.append(cost)
        cap = 8.0 * max(statistics.median(self._recent_costs), 0.1)
        for h in workable:
            h.credit_ms = max(-cap, min(cap, h.credit_ms))
        return stepped

    def step_once(self) -> bool:
        """Test/driver hook: one pass without the thread."""
        t0 = time.perf_counter()
        progressed = self._pass()
        with self._lock:
            self._wall_ms += (time.perf_counter() - t0) * 1000.0
        return progressed

    def run_until_idle(self, timeout_s: float = 60.0) -> None:
        """Drive passes until every engine's queue and slots are empty."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            progressed = self.step_once()
            with self._lock:
                idle = all(
                    h.engine.active_slots == 0 and len(h.engine.queue) == 0
                    for h in self._hosted.values()
                )
            if idle and not progressed:
                return
        raise TimeoutError(f"{self.name}: colocated engines did not drain")

    def _loop(self) -> None:
        ctx = (
            torch.cuda.device(self.device)
            if self.device is not None
            and torch.device(self.device).type == "cuda"
            else nullcontext()
        )
        with ctx:
            while self._run.is_set():
                t0 = time.perf_counter()
                try:
                    progressed = self._pass()
                except Exception:  # noqa: BLE001 — loop must not die silently
                    logger.exception("%s: pass failed", self.name)
                    progressed = False
                    time.sleep(0.05)  # rdb-lint: disable=event-loop-blocking (pass error backoff on the colocation executor's own thread)
                with self._lock:
                    self._wall_ms += (time.perf_counter() - t0) * 1000.0
                if not progressed:
                    time.sleep(self.idle_wait_s)  # rdb-lint: disable=event-loop-blocking (idle wait on the colocation executor's own thread)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self._thread is not None:
            if self._thread.is_alive():
                return
            # A previously wedged loop has since exited (stop() left the
            # handle so callers could see it lived): safe to respawn.
            self._thread = None
        self._run.set()
        self._thread = threading.Thread(
            target=self._loop, name=f"colocate-{self.name}", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._run.clear()
        if self._thread is not None:
            self._thread.join(timeout_s)
            if self._thread.is_alive():
                # Wedged in a device call: leave the handle so callers can
                # see the thread still lives (buffer release must not
                # happen under it).
                logger.warning("%s: loop did not exit in %.1fs", self.name,
                               timeout_s)
            else:
                self._thread = None

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Stop the loop and abort/release every hosted engine. If the
        loop is wedged in a device call the buffers are NOT released —
        a still-running scan may be touching them, and dropping the
        references mid-flight trades a leak for a use-after-free-style
        crash (same discipline as LLMReplica.stop)."""
        self.stop(timeout_s)
        if self.running:
            logger.warning(
                "%s: loop still alive after stop — leaking hosted "
                "engines' buffers rather than releasing under a live "
                "scan", self.name,
            )
            return
        with self._lock:
            for h in list(self._hosted.values()):
                self._release(h)
            self._hosted.clear()
            pending = list(self._pending_replacements.values())
            self._pending_replacements.clear()
        for engine, _ in pending:
            # Never-installed successors hold warm weights + KV.
            engine.release_buffers()

    # --- accounting ---------------------------------------------------------
    def busy_fractions(self) -> Dict[str, float]:
        """Measured share of executor wall time each engine consumed —
        the ground truth the planner's ``compute_fraction`` predicts.
        Only REAL model names export to the gauge: the synthetic
        ``model@draining<id>`` keys minted per migration would grow the
        metric's tag cardinality without bound on a long-running
        deployment (and the gauge registry never evicts)."""
        with self._lock:
            wall = max(self._wall_ms, 1e-9)
            out = {mk: h.busy_ms / wall for mk, h in self._hosted.items()}
            hosted = {
                mk: h.model for mk, h in self._hosted.items()
                if not h.draining
            }
        for mk, model in hosted.items():
            BUSY_FRACTION.set(out[mk],
                              tags={"chip": self.name, "model": model})
        return out

    def reset_accounting(self) -> None:
        with self._lock:
            self._wall_ms = 0.0
            for h in self._hosted.values():
                h.busy_ms = 0.0
                h.credit_ms = 0.0

    @property
    def active(self) -> bool:
        with self._lock:
            return any(
                getattr(h.engine, "busy", h.engine.active_slots > 0)
                for h in self._hosted.values()
            )

    def describe(self) -> str:
        with self._lock:
            parts = ", ".join(
                f"{m}(slots={h.engine.num_slots}, cap={h.engine.max_len}"
                f"{', draining' if h.draining else ''})"
                for m, h in self._hosted.items()
            )
        return f"{self.name}[{parts}]"
