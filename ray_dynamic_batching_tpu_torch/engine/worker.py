"""Replica engine — one card's duty-cycle executor, in torch.

Port of ``ray_dynamic_batching_tpu/engine/worker.py`` (the reference's
``GPUWorker``, ``293-project/src/scheduler.py:374-584``): an infinite
duty-cycle round-robin over (session, occupancy) placements — take a
batch from the session's queue, run the forward, sleep out the rest of
the time slice, then sleep out the cycle's leftover — with schedule
updates prepared off the serving thread and swapped in at a cycle
boundary.

What the reference's XLA compile becomes here:
- a bucket's "compile" (``jax.jit(...).lower().compile()``) is one
  warm-up forward of the (model, batch bucket, seq bucket) under
  ``torch.inference_mode()`` in the preparer thread, finished by a host
  fetch, before the schedule goes live;
- the LRU of compiled executables becomes an LRU record of the warmed
  buckets (cuDNN/cuBLAS state is per process and per shape, so it
  survives a model's unload as the reference's executables do);
- a step's completion signal, and what it is timed by, is the host fetch
  of the results (``.float().cpu()``), as ``np.asarray(out)`` is in the
  reference; the results fulfil the requests as numpy rows.

The ``engine.step`` span (linked to every member request) and the
per-request ``engine.request`` spans (linked back), the
``rdb_engine_*`` metrics and the observed/expected step ratios for the
gray monitor are the reference's. Added: ``busy_ms``, the wall time
spent in steps, which a caller holds against the planned occupancy (as
``engine/colocate.py``'s engines keep theirs).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from queue import Empty, SimpleQueue
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ray_dynamic_batching_tpu_torch.engine.batching import (
    BatchPolicy,
    NexusFixedBatch,
)
from ray_dynamic_batching_tpu_torch.engine.collate import collate
from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
from ray_dynamic_batching_tpu_torch.models.base import ServableModel
from ray_dynamic_batching_tpu_torch.scheduler.nexus import NodePlan, Placement
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils.tracing import link_to, tracer

logger = get_logger("engine")

# Module-level metrics (single registration; tagged per model/engine).
BATCHES_TOTAL = m.Counter(
    "rdb_engine_batches_total", "Batches executed", tag_keys=("engine", "model")
)
REQUESTS_TOTAL = m.Counter(
    "rdb_engine_requests_total", "Requests served", tag_keys=("engine", "model")
)
STEP_LATENCY_MS = m.Histogram(
    "rdb_engine_step_latency_ms", "Step latency", tag_keys=("engine", "model")
)
ENGINE_OCCUPANCY = m.Gauge(
    "rdb_engine_occupancy", "Scheduled occupancy", tag_keys=("engine",)
)
SWAP_TOTAL = m.Counter(
    "rdb_engine_schedule_swaps_total", "Schedule hot-swaps applied", tag_keys=("engine",)
)


@dataclass
class CompiledStep:
    """One warmed (model, batch_bucket, seq_bucket) step; the weights live
    in ``model`` and ``fn`` is its forward."""

    model_name: str
    batch_bucket: int
    seq_bucket: int
    fn: Callable[..., torch.Tensor]
    model: ServableModel


@dataclass
class ActiveSchedule:
    """The engine's live schedule (placements share one duty cycle)."""

    placements: List[Placement] = field(default_factory=list)
    duty_cycle_ms: float = 0.0
    steps: Dict[str, CompiledStep] = field(default_factory=dict)  # by model
    policies: Dict[str, BatchPolicy] = field(default_factory=dict)


def warm_step(model: ServableModel, batch: int, seq: int = 0) -> None:
    """One forward of the bucket's example inputs, finished by a host
    fetch: the bucket's first dispatch (the reference's compile)."""
    with torch.inference_mode():
        model(*model.example_inputs(batch, seq or None)).float().cpu()


class ReplicaEngine:
    """One executor thread serving a duty cycle on one card."""

    def __init__(
        self,
        engine_id: str,
        queues: QueueManager,
        host: ModelHost,
        seq_bucket_default: int = 0,
        idle_wait_s: float = 0.01,
    ):
        self.engine_id = engine_id
        self.queues = queues
        self.host = host
        self.seq_bucket_default = seq_bucket_default
        self.idle_wait_s = idle_wait_s
        self._ready: SimpleQueue = SimpleQueue()  # prepared schedules
        self._schedule = ActiveSchedule()
        self._active = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cycle_count = 0
        self._last_error: Optional[Exception] = None
        self._pending_plan: Optional[NodePlan] = None
        self._assign_lock = threading.Lock()
        self._preparer: Optional[threading.Thread] = None
        # Warmed buckets keyed (model, batch_bucket, seq_bucket), least
        # recently used first: rebalancing between schedules that share
        # buckets does not warm them again.
        self._warmed: "OrderedDict[Tuple[str, int, int], None]" = OrderedDict()
        self._warmed_cap = 64
        self._closed = False
        # Observed/expected step-latency ratios for the gray-failure
        # detector (LiveScheduler.enable_gray_monitoring): a healthy
        # engine reads ~1.0 whatever it hosts. Armed only when gray
        # monitoring is on; drained per monitor tick.
        self.track_ratios = False
        self._fresh_ratios: list = []
        # Wall ms inside steps (written by the engine thread only).
        self.busy_ms = 0.0

    # --- schedule handoff (ref update_queues.put, scheduler.py:906-929) ---
    def assign(self, plan: NodePlan) -> None:
        """Queue a new node plan. Model loads and bucket warm-ups run on a
        background preparer thread while the old schedule keeps serving;
        the hot loop only swaps the schedule at a cycle boundary."""
        with self._assign_lock:
            self._pending_plan = plan
            if self._preparer is None or not self._preparer.is_alive():
                self._preparer = threading.Thread(
                    target=self._prepare_loop,
                    name=f"engine-{self.engine_id}-prepare",
                    daemon=True,
                )
                self._preparer.start()

    def _prepare_loop(self) -> None:
        while True:
            with self._assign_lock:
                plan = self._pending_plan
                self._pending_plan = None
                if plan is None:
                    self._preparer = None
                    return
            try:
                prepared = self._prepare(plan)
                with self._assign_lock:  # atomic vs stop()'s drain
                    if self._closed:
                        # stop() raced us past its _ready drain: nobody will
                        # apply this schedule, release its refs here.
                        for name in prepared.steps:
                            self.host.release(name)
                    else:
                        self._ready.put((plan, prepared))
            except Exception as e:  # noqa: BLE001
                self._last_error = e
                logger.exception(
                    "%s: schedule preparation failed; keeping old schedule",
                    self.engine_id,
                )

    def _prepare(self, plan: NodePlan) -> ActiveSchedule:
        """Load every placement's model and warm its bucket BEFORE going
        live (the reference loads inside the swap window, :507-515)."""
        steps: Dict[str, CompiledStep] = {}
        policies: Dict[str, BatchPolicy] = {}
        acquired: List[str] = []
        try:
            for p in plan.placements:
                name = p.session.model
                model = self.host.acquire(name)
                acquired.append(name)
                seq = p.session.seq_len or self.seq_bucket_default
                if seq == 0 and model.family in ("text_classifier", "causal_lm"):
                    # Collate must pad to the shape the bucket was warmed
                    # with; recover the model's default seq bucket.
                    seq = int(model.input_shapes(p.batch_size)[0].shape[1])
                key = (name, p.batch_size, seq)
                if key in self._warmed:
                    self._warmed.move_to_end(key)  # refresh recency
                else:
                    warm_step(model, p.batch_size, seq)
                    if len(self._warmed) >= self._warmed_cap:
                        self._warmed.popitem(last=False)
                    self._warmed[key] = None
                steps[name] = CompiledStep(
                    model_name=name,
                    batch_bucket=p.batch_size,
                    seq_bucket=seq,
                    fn=model,
                    model=model,
                )
                policies[name] = NexusFixedBatch(
                    p.batch_size, expected_latency_ms=p.latency_ms
                )
        except Exception:
            for name in acquired:  # roll back refs or weights leak
                self.host.release(name)
            raise
        return ActiveSchedule(
            placements=list(plan.placements),
            duty_cycle_ms=plan.duty_cycle_ms,
            steps=steps,
            policies=policies,
        )

    def _apply_updates(self) -> None:
        """Swap in the newest prepared schedule, if any (ref
        _check_for_updates, :483-523: unload removed -> load added -> swap
        atomically — here loads and warm-ups already happened off-thread)."""
        latest = None
        while True:
            try:
                candidate = self._ready.get_nowait()
            except Empty:
                break
            if latest is not None:
                # Superseded schedule: release the refs its _prepare acquired.
                for name in latest[1].steps:
                    self.host.release(name)
            latest = candidate
        if latest is None:
            return
        plan, new_schedule = latest
        old_models = set(self._schedule.steps)
        self._schedule = new_schedule  # atomic swap at cycle boundary
        # Each ActiveSchedule owns exactly one host reference per model
        # (_prepare acquired for the new one), so release ALL old refs —
        # retained models keep a balanced count, removed ones unload.
        for name in old_models:
            self.host.release(name)
        ENGINE_OCCUPANCY.set(
            sum(p.occupancy for p in plan.placements),
            tags={"engine": self.engine_id},
        )
        SWAP_TOTAL.inc(tags={"engine": self.engine_id})
        logger.info("%s: swapped to %s", self.engine_id, plan.describe())

    # --- hot loop (ref execute_schedule, scheduler.py:525-584) ------------
    def _run_placement(self, p: Placement, step: CompiledStep,
                       policy: BatchPolicy) -> float:
        """Execute one session's slice; returns elapsed ms."""
        name = p.session.model
        queue = self.queues.queue(name)
        batch = policy.next_batch(queue)
        if not batch:
            return 0.0
        t0 = time.perf_counter()
        # One step span per batch execution, tagged with the bucket it
        # was warmed for and LINKED to every member request's span; each
        # member then gets a completion span linking BACK.
        traced = tracer().enabled
        member_links = [link_to(r.trace_ctx) for r in batch] if traced else None
        step_start_ms = m.now_ms() if traced else 0.0
        try:
            with tracer().span(
                "engine.step",
                links=member_links,
                model=name,
                engine=self.engine_id,
                lane=self.engine_id,
                batch_bucket=step.batch_bucket,
                seq_bucket=step.seq_bucket,
                n=len(batch),
            ) as step_span:
                inputs, n_real = collate(
                    step.model, batch, step.batch_bucket, step.seq_bucket
                )
                with torch.inference_mode():
                    out = step.fn(*inputs)
                # The host fetch is the completion signal the step is
                # timed by; the engine needs the results host-side anyway
                # to fulfil futures.
                results = out.float().cpu().numpy()[:n_real]
        except Exception as e:  # noqa: BLE001
            for req in batch:
                req.reject(e)
            self._last_error = e
            logger.error("%s/%s: step failed: %s", self.engine_id, name, e)
            elapsed_ms = (time.perf_counter() - t0) * 1000.0
            self.busy_ms += elapsed_ms
            return elapsed_ms
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        self.busy_ms += elapsed_ms
        if self.track_ratios and p.latency_ms > 0:
            # Engine-thread append, monitor-thread drain (GIL-atomic
            # list swap in drain_ratios).
            self._fresh_ratios.append(elapsed_ms / p.latency_ms)
        for req, res in zip(batch, results):
            req.fulfill(res)
        if step_span is not None:
            end_ms = m.now_ms()
            for req in batch:
                # Per-request execution span in the REQUEST's trace, linked
                # to the batch step it rode.
                tracer().record_span(
                    "engine.request",
                    ctx=req.trace_ctx,
                    start_ms=step_start_ms,
                    end_ms=end_ms,
                    links=[link_to(step_span)],
                    model=name,
                    engine=self.engine_id,
                    lane=self.engine_id,
                )
        queue.record_batch_completion(batch)
        BATCHES_TOTAL.inc(tags={"engine": self.engine_id, "model": name})
        REQUESTS_TOTAL.inc(n_real, tags={"engine": self.engine_id, "model": name})
        STEP_LATENCY_MS.observe(
            elapsed_ms, tags={"engine": self.engine_id, "model": name},
            trace_id=step_span.trace_id if step_span is not None else None,
        )
        return elapsed_ms

    def _run_cycle(self) -> None:
        sched = self._schedule
        if not sched.placements:
            time.sleep(self.idle_wait_s)
            return
        cycle_start = time.perf_counter()
        for p in sched.placements:
            step = sched.steps[p.session.model]
            policy = sched.policies[p.session.model]
            elapsed_ms = self._run_placement(p, step, policy)
            # Sleep out the remainder of this session's slice so co-tenants
            # get their scheduled share (ref :564-570).
            slice_ms = p.occupancy * sched.duty_cycle_ms
            remaining_ms = slice_ms - elapsed_ms
            if remaining_ms > 0.05:
                time.sleep(remaining_ms / 1000.0)
        # Absorb any leftover duty-cycle time (unallocated occupancy).
        total_ms = (time.perf_counter() - cycle_start) * 1000.0
        leftover_ms = sched.duty_cycle_ms - total_ms
        if leftover_ms > 0.05:
            time.sleep(leftover_ms / 1000.0)
        self._cycle_count += 1

    def _loop(self) -> None:
        while self._active.is_set():
            try:
                self._apply_updates()
                self._run_cycle()
            except Exception as e:  # noqa: BLE001 — engine must not die silently
                self._last_error = e
                logger.exception("%s: cycle failed", self.engine_id)
                time.sleep(0.05)

    # --- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._active.set()
        self._thread = threading.Thread(
            target=self._loop, name=f"engine-{self.engine_id}", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._closed = True
        self._active.clear()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
        # Wait for any in-flight preparation: a schedule landing in _ready
        # AFTER the drain below would leak its host refs.
        with self._assign_lock:
            self._pending_plan = None  # cancel queued-but-unstarted plans
            preparer = self._preparer
        if preparer is not None:
            preparer.join(timeout_s)
        # Release refs of the live schedule AND any prepared-but-unapplied
        # schedules still sitting in the ready queue. Under the assign lock:
        # a preparer that outlived the bounded join above will see _closed
        # inside the same lock and release its own refs instead of putting.
        with self._assign_lock:
            while True:
                try:
                    _, sched = self._ready.get_nowait()
                except Empty:
                    break
                for name in sched.steps:
                    self.host.release(name)
        for name in list(self._schedule.steps):
            self.host.release(name)
        self._schedule = ActiveSchedule()

    @property
    def cycle_count(self) -> int:
        return self._cycle_count

    def drain_ratios(self) -> list:
        """Observed/expected step ratios since the last drain (the gray
        monitor's per-tick observation window; GIL-atomic list swap —
        engine thread appends, monitor thread drains)."""
        out, self._fresh_ratios = self._fresh_ratios, []
        return out

    def healthy(self) -> bool:
        """Liveness for the scheduler's heal path: started, not stopped,
        and the duty-cycle thread alive — a crashed hot loop must drop
        this engine out of the planner's candidate set."""
        if self._closed:
            return False
        if self._thread is None:
            return True  # not started yet — serves once started
        return self._active.is_set() and self._thread.is_alive()

    @property
    def models(self) -> List[str]:
        return list(self._schedule.steps)

    def describe(self) -> str:
        s = self._schedule
        return (
            f"ReplicaEngine({self.engine_id}, duty={s.duty_cycle_ms:.1f}ms, "
            f"models={sorted(s.steps)})"
        )
