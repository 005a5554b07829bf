"""Request failover — one failure taxonomy, deadline-budgeted re-dispatch.

Own copy of ``ray_dynamic_batching_tpu/serve/failover.py``, whole, with
its import paths rewritten.

The reference substrate makes actor death survivable: tasks are retried
from ownership metadata (Ray, OSDI '18 lineage) and the Nexus-style SLO
planner assumes an admitted request either completes within deadline or
is counted SHED — never a spurious client-visible 500. This module is
the recovery half of that contract for the serve tier, shared by every
consumer of the taxonomy (replica, router, controller drain path, proxy
error mapping, sim re-enactment, chaos soak):

- **Taxonomy**: :func:`is_retryable` classifies a rejection into
  retryable *system* failures (chaos injection, replica death, drain
  evictions) vs. non-retryable *user* errors (``BadRequest``, callable
  bugs) and terminal *shed* outcomes (``RequestStale``,
  ``RequestDropped`` — deadline economics, not faults).
- **Deadline-budgeted retries**: :class:`FailoverManager` re-dispatches
  a retryable failure to a DIFFERENT replica with capped exponential
  backoff + seeded jitter, but only while the attempt budget holds and
  ``remaining_deadline >= profiled batch latency`` — otherwise the
  request is counted shed, exactly like the queue's stale discard.
- **At-most-once after first token**: a streaming request that already
  emitted a chunk is never retried (the client saw partial output);
  the failure surfaces as-is.

The circuit breaker lives in ``serve/router.py`` (it is a routing
concern); the manager feeds it per-replica failure/success signals so
the breaker, the retry decision, and the audit trail agree on one
taxonomy.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.engine.request import (
    Request,
    RequestDropped,
    RequestStale,
    now_ms,
)
from ray_dynamic_batching_tpu_torch.serve.fabric import FabricUnreachable
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.serve.grayhealth import median_or_zero
from ray_dynamic_batching_tpu_torch.utils.chaos import ChaosInjected
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

logger = get_logger("failover")

FAILOVER_RETRIES = m.Counter(
    "rdb_failover_retries_total", "Requests re-dispatched after a "
    "retryable system failure", tag_keys=("deployment",),
)
FAILOVER_SHED = m.Counter(
    "rdb_failover_shed_total", "Requests shed by the failover layer",
    tag_keys=("deployment", "reason"),
)
HEDGE_TOTAL = m.Counter(
    "rdb_hedge_total",
    "Hedge timer outcomes (won: the hedge dispatch delivered the result; "
    "lost: the primary beat a dispatched hedge or the hedge arm failed; "
    "late: the timer fired but no hedge was dispatched — request already "
    "done, first token emitted, deadline too tight, or no second replica)",
    tag_keys=("deployment", "outcome"),
)


class RetryableSystemError(RuntimeError):
    """Base for failures the framework caused and may transparently
    retry on another replica — never the client's fault."""


class ReplicaDeadError(RetryableSystemError):
    """The serving replica died (loop crash, wedged callable) with this
    request in flight or queued."""


class SliceDeadError(ReplicaDeadError):
    """A chip in the replica's MESH SLICE died, taking the whole slice:
    a TP replica's programs gang-schedule every chip in the gang, so
    losing one loses the collective — there is no partial survival at
    the replica level. Retryable like any replica
    death (the request re-dispatches elsewhere); the RECOVERY half is
    the scheduler's: the heal replan runs over the surviving geometry,
    re-forms the good chips into narrower slices, and degrades the
    model to the mesh-shape profile row that still fits
    (``scheduler/replan.degrade_sessions``). ``chip_index`` names the
    chip that took the slice down, for the audit trail."""

    def __init__(self, message: str, chip_index: Optional[int] = None):
        super().__init__(message)
        self.chip_index = chip_index


class DrainEvicted(RetryableSystemError):
    """The request was evicted from a draining replica's queue (heal /
    rolling update / plan migration) and must be re-routed."""


class RetriesExhausted(Exception):
    """Terminal: a retryable system failure burned its attempt budget.
    Maps to 503 + Retry-After (gRPC UNAVAILABLE) — the client may retry;
    the payload was never the problem."""

    def __init__(self, message: str, cause: Optional[Exception] = None):
        super().__init__(message)
        self.cause = cause


class RetryBudgetExhausted(Exception):
    """Terminal: the deployment's amplification budget
    (serve/retrybudget.py) refused this re-dispatch — retries+hedges
    already consumed their configured fraction of recent first-attempt
    volume, or the overload governor declared the deployment congested.
    Maps to 429 + Retry-After (RESOURCE_EXHAUSTED): the system is
    shedding load deliberately, exactly like an admission reject — the
    client backs off; the payload was never the problem."""

    def __init__(self, message: str, cause: Optional[Exception] = None,
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.cause = cause
        self.retry_after_s = retry_after_s


class PoisonRequest(Exception):
    """Terminal: batch bisection (serve/replica.py) isolated this
    request as a query of death — its CONTENT crashes execution, so a
    retry replicates the fault instead of recovering from it. Maps to
    400 (gRPC INVALID_ARGUMENT), is never retried or hedged, and its
    fingerprint lands in the QuarantineRegistry so front doors refuse
    the identical query at admission."""

    def __init__(self, message: str, cause: Optional[Exception] = None,
                 fingerprint: str = ""):
        super().__init__(message)
        self.cause = cause
        self.fingerprint = fingerprint


def is_retryable(exc: BaseException) -> bool:
    """True for system failures the failover layer may re-dispatch.

    ``ChaosInjected`` is the test-harness stand-in for every injected
    fault (dropped RPC, killed batch) and classifies retryable;
    ``FabricUnreachable`` (a control-plane message eaten by a partition
    or the fabric chaos policy) likewise — the payload was never the
    problem, a healed edge or a different replica may serve it;
    ``RequestStale``/``RequestDropped`` are shed outcomes (terminal by
    design); everything else — ``BadRequest``, user-callable exceptions,
    contract violations — is a non-retryable user/server error whose
    retry would just fail again."""
    return isinstance(exc, (RetryableSystemError, ChaosInjected,
                            FabricUnreachable))


def is_shed(exc: BaseException) -> bool:
    """True for deadline-economics outcomes the SLO accounting counts as
    shed rather than errors (the planner's admitted-or-shed contract)."""
    return isinstance(exc, (RequestStale, RequestDropped))


@dataclass(frozen=True)
class RejectDisposition:
    """How one rejection surfaces to a client — ONE table shared by the
    HTTP proxy and ``grpc_proxy._error_status`` so the two front doors
    can never disagree on what a shed is."""

    kind: str                      # "user" | "capacity" | "system" | "internal"
    http_status: int
    grpc_code: str                 # grpc.StatusCode attribute name
    retry_after_s: Optional[float] = None


def reject_disposition(exc: BaseException) -> RejectDisposition:
    """Classify a request failure for the client surface.

    - **capacity** (429 / RESOURCE_EXHAUSTED + computed ``Retry-After``):
      admission rejects and queue sheds (full-queue drops, displacement,
      stale discards) — the system is healthy and saying "not now"; the
      retry hint comes from the rejecting layer (bucket refill time /
      queue drain estimate) with a 1 s floor-less fallback.
    - **system** (503 / UNAVAILABLE + ``Retry-After``): retryable system
      failures and exhausted failover budgets — the payload was never the
      problem; a different moment (heal, breaker close) may serve it.
    - **user** (400 / INVALID_ARGUMENT): the payload itself.
    - **internal** (500 / INTERNAL): genuine bugs — must alarm, never
      invite a retry."""
    from ray_dynamic_batching_tpu_torch.engine.request import BadRequest
    from ray_dynamic_batching_tpu_torch.serve.admission import AdmissionRejected

    if isinstance(exc, (BadRequest, PoisonRequest)):
        # A bisection-isolated poison is the payload's fault by proof of
        # execution: same user-class surface as a validation failure.
        return RejectDisposition("user", 400, "INVALID_ARGUMENT")
    if isinstance(exc, RetryBudgetExhausted):
        return RejectDisposition(
            "capacity", 429, "RESOURCE_EXHAUSTED",
            retry_after_s=float(getattr(exc, "retry_after_s", 1.0) or 1.0),
        )
    if getattr(exc, "reason", "") == "breaker_open":
        # Router terminal reject because EVERY live replica's breaker was
        # open: the system is failing, not merely full — 503, not 429.
        return RejectDisposition("system", 503, "UNAVAILABLE",
                                 retry_after_s=1.0)
    if isinstance(exc, AdmissionRejected) or is_shed(exc):
        return RejectDisposition(
            "capacity", 429, "RESOURCE_EXHAUSTED",
            retry_after_s=float(getattr(exc, "retry_after_s", 0.0) or 1.0),
        )
    if isinstance(exc, RetriesExhausted) or is_retryable(exc):
        return RejectDisposition("system", 503, "UNAVAILABLE",
                                 retry_after_s=1.0)
    return RejectDisposition("internal", 500, "INTERNAL")


def retry_after_header(disposition: RejectDisposition) -> Optional[str]:
    """HTTP ``Retry-After`` value (integer seconds, ceil'd — the header
    grammar takes no fractions; sub-second hints round up to 1)."""
    if disposition.retry_after_s is None:
        return None
    import math

    return str(max(1, math.ceil(disposition.retry_after_s)))


@dataclass
class FailoverPolicy:
    """Retry knobs — deadline is the real bound, attempts the backstop."""

    # Total dispatches (first send included). Sized above any plausible
    # consecutive-failure streak a bounded chaos budget can aim at one
    # request; the deadline budget is what actually stops hopeless work.
    max_attempts: int = 5
    backoff_initial_s: float = 0.002
    backoff_max_s: float = 0.05
    jitter: float = 0.5            # fraction of the backoff randomized
    seed: int = 0                  # jitter RNG seed (deterministic tests)


class FailoverManager:
    """Deadline-budgeted re-dispatch for one deployment's router.

    Replicas hand failed batches here (``on_batch_failure``); drained
    queues arrive via ``requeue``; both paths re-route each request to a
    different replica through ``router.assign_request(exclude=...)`` on
    a dedicated worker thread (a replica's hot loop must never block in
    another replica's backoff). Shed decisions reject with
    :class:`RequestStale` so every accounting surface — queue stats,
    soak, sim — reads them identically to a stale discard.
    """

    def __init__(self, router: Any,
                 policy: Optional[FailoverPolicy] = None) -> None:
        self.router = router
        self.policy = policy or FailoverPolicy()
        self._rng = random.Random(self.policy.seed)
        self._seq = itertools.count()
        # (due_monotonic_ms, seq, request, excluded_replica_id,
        #  submitted_ms — the failover hop span's start)
        self._heap: List[Tuple[float, int, Request, str, float]] = []
        self._cond = threading.Condition(OrderedLock("failover"))
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # --- accounting (surfaced via stats() -> router -> status()) ---
        self.retries = 0
        self.shed_deadline = 0
        self.shed_attempts = 0
        self.shed_budget = 0
        self.stream_aborted = 0

    # --- replica-facing sink ---------------------------------------------
    def on_batch_failure(self, replica: Any, batch: List[Request],
                         exc: Exception) -> None:
        """A replica's batch died on a retryable system failure: feed the
        breaker, then re-dispatch every request that may still be retried."""
        self.router.record_replica_failure(replica.replica_id)
        for req in batch:
            if req.stream is not None and req.stream.emitted > 0:
                # At-most-once after first token: the client consumed
                # partial output; a transparent replay would duplicate it.
                self.stream_aborted += 1
                req.reject(exc)
                continue
            self.submit(req, exc, exclude_replica=replica.replica_id)  # rdb-lint: disable=retry-amplification (submit() prices the budget itself — consulting here too would double-charge each re-dispatch)

    def on_batch_success(self, replica: Any) -> None:
        self.router.record_replica_success(replica.replica_id)

    # --- retry scheduling --------------------------------------------------
    def submit(self, request: Request, exc: Exception,
               exclude_replica: str = "", immediate: bool = False) -> bool:
        """Queue one re-dispatch (True) or reject terminally (False).

        ``immediate`` skips the backoff delay — drain evictions are not
        replica faults, so they re-route without penalty (still deadline-
        and attempt-budgeted)."""
        deployment = self.router.deployment
        if request.attempts >= self.policy.max_attempts:
            self.shed_attempts += 1
            FAILOVER_SHED.inc(
                tags={"deployment": deployment, "reason": "attempts"}
            )
            request.reject(RetriesExhausted(
                f"{request.request_id}: {request.attempts} attempts "
                f"exhausted (last failure: {exc})", cause=exc,
            ))
            return False
        delay_ms = 0.0 if immediate else self._backoff_ms(request.attempts)
        # Retry only if the request can still plausibly complete: the
        # queue's stale-discard rule (deadline < now + expected latency)
        # applied BEFORE burning a backoff + batch on a lost cause.
        if request.remaining_ms() < self._expected_latency_ms() + delay_ms:
            self.shed_deadline += 1
            FAILOVER_SHED.inc(
                tags={"deployment": deployment, "reason": "deadline"}
            )
            request.reject(RequestStale(
                f"{request.request_id}: deadline unreachable after system "
                f"failure ({exc})"
            ))
            return False
        # Amplification budget (serve/retrybudget.py): a backoff retry is
        # a re-dispatch drawing from the deployment's retry/hedge pool.
        # Drain requeues (``immediate=True``) are exempt by design — a
        # planned drain MOVES admitted work instead of amplifying it, and
        # charging it would turn every rolling update into a shed storm.
        budget = getattr(self.router, "retry_budget", None)
        if not immediate and budget is not None \
                and not budget.try_spend("retry"):
            self.shed_budget += 1
            FAILOVER_SHED.inc(
                tags={"deployment": deployment, "reason": "retry_budget"}
            )
            request.reject(RetryBudgetExhausted(
                f"{request.request_id}: retry budget exhausted "
                f"(last failure: {exc})", cause=exc,
            ))
            return False
        with self._cond:
            # _stopped is authoritative only under the lock: a submit
            # racing close() past an unlocked check would push AFTER the
            # heap drain and leave a client future that never resolves.
            if not self._stopped:
                submitted_ms = m.now_ms()
                heapq.heappush(
                    self._heap,
                    (submitted_ms + delay_ms, next(self._seq), request,
                     exclude_replica, submitted_ms),
                )
                self._ensure_worker()
                self._cond.notify()
                scheduled = True
            else:
                scheduled = False
        if not scheduled:
            # Teardown: no worker to run the retry and no replica set to
            # land it on — terminal, not a silently resurrected thread.
            request.reject(RequestDropped(
                f"{deployment}: shutting down ({exc})"
            ))
            return False
        self.retries += 1
        FAILOVER_RETRIES.inc(tags={"deployment": deployment})
        return True

    def requeue(self, requests: List[Request], victim_id: str,
                dead: bool = False) -> None:
        """Drain-and-requeue: a retired/unhealthy replica's queued work
        re-enters routing through the failover path (no backoff — the
        victim failed, not the request). ``dead=True`` marks the heal
        path (the replica crashed/wedged: :class:`ReplicaDeadError`);
        planned retirements (rolling update, scale-down salvage) stay
        :class:`DrainEvicted`."""
        for req in requests:
            exc: RetryableSystemError = (
                ReplicaDeadError(f"{victim_id} died with request queued")
                if dead else DrainEvicted(f"drained from {victim_id}")
            )
            self.submit(req, exc, exclude_replica=victim_id, immediate=True)  # rdb-lint: disable=retry-amplification (drain requeues MOVE admitted work off a retiring replica; immediate=True is the budget-exempt path submit() documents)

    # --- internals ----------------------------------------------------------
    def _backoff_ms(self, attempts: int) -> float:
        base = min(
            self.policy.backoff_initial_s * (2 ** max(attempts - 1, 0)),
            self.policy.backoff_max_s,
        )
        return base * (1.0 + self.policy.jitter * self._rng.random()) * 1000.0

    def _expected_latency_ms(self) -> float:
        """Profiled cost of one more attempt: the worst recent p50 across
        the replica set (total request latency, so queue wait is priced
        in). 0.0 before any completion — never block the first retries."""
        worst = 0.0
        for r in self.router.replicas():
            queue = getattr(r, "queue", None)
            if queue is None:
                continue
            try:
                worst = max(worst, queue.latency_window.percentile(0.5))
            except Exception:  # noqa: BLE001 — stats must not break retries
                continue
        return worst

    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker,
                name=f"failover-{self.router.deployment}", daemon=True,
            )
            self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and (
                    not self._heap or self._heap[0][0] > m.now_ms()
                ):
                    timeout = None
                    if self._heap:
                        timeout = max(
                            (self._heap[0][0] - m.now_ms()) / 1000.0, 0.0
                        )
                    self._cond.wait(timeout)
                if self._stopped:
                    return
                (_due, _seq, request, excluded,
                 submitted_ms) = heapq.heappop(self._heap)
            # Deadline recheck at POP time: submit() priced the backoff
            # into its pre-sleep check, but the cond wait is not exact
            # (scheduler wakeup slop, notify storms) and the profiled
            # attempt cost may have moved while we slept — a retry must
            # never dispatch past the deadline it was admitted under.
            if request.remaining_ms() < self._expected_latency_ms():
                self.shed_deadline += 1
                FAILOVER_SHED.inc(tags={
                    "deployment": self.router.deployment,
                    "reason": "deadline",
                })
                request.reject(RequestStale(
                    f"{request.request_id}: backoff outlived the "
                    f"admission deadline"
                ))
                continue
            try:
                # assign_request owns terminal rejection (RequestDropped
                # after its capped backoff window) — capped further by the
                # request's remaining deadline so a retry can never sleep
                # past the budget it was admitted under.
                self.router.assign_request(
                    request,
                    exclude={excluded} if excluded else None,
                    timeout_s=max(request.remaining_ms() / 1000.0, 0.001),
                )
                if tracer().enabled:
                    # The ledger's `failover` hop: submit -> re-dispatch,
                    # backoff included, joined to the request's trace. It
                    # OUTRANKS router.assign in the hop taxonomy, so the
                    # retry's inner assign attributes here — a regression
                    # in failover latency names failover, not the router.
                    tracer().record_span(
                        "failover.redispatch",
                        ctx=request.trace_ctx,
                        start_ms=submitted_ms,
                        end_ms=m.now_ms(),
                        deployment=self.router.deployment,
                        lane=self.router.deployment,
                        attempts=request.attempts,
                        excluded=excluded,
                    )
            except Exception:  # noqa: BLE001 — one bad dispatch must not
                # kill the worker; the request's future still resolves
                # through assign_request's own rejection path.
                logger.exception(
                    "%s: failover dispatch failed", self.router.deployment
                )

    def close(self) -> None:
        """Stop the worker and terminally reject every retry still
        waiting out its backoff — an abandoned heap entry would be a
        client future that never resolves."""
        with self._cond:
            self._stopped = True
            pending, self._heap = list(self._heap), []
            self._cond.notify_all()
        for _due, _seq, request, _excluded, _submitted in pending:
            FAILOVER_SHED.inc(tags={"deployment": self.router.deployment,
                                    "reason": "shutdown"})
            request.reject(RequestDropped(
                f"{self.router.deployment}: shutting down with retry pending"
            ))

    def stats(self) -> dict:
        with self._cond:
            pending = float(len(self._heap))
        return {
            "retries": float(self.retries),
            "shed_deadline": float(self.shed_deadline),
            "shed_attempts": float(self.shed_attempts),
            "shed_budget": float(self.shed_budget),
            "stream_aborted": float(self.stream_aborted),
            "pending": pending,
        }


# --- hedged dispatch (gray-failure mitigation) ------------------------------
#
# Detection (serve/grayhealth.py) converges over monitor ticks; the requests
# dispatched onto a straggler in the meantime still miss their deadlines.
# Hedging mitigates per-request ("The Tail at Scale": defer the hedge until
# the p95, cap it at one extra dispatch — 5% added load for most of the tail
# win): when a hedge-eligible request has produced NOTHING by the
# deployment's profiled p95, re-dispatch it to a DIFFERENT replica and let
# the first winner cancel the loser. The at-most-once-after-first-token
# rule is the hard boundary: a request whose stream emitted a chunk is never
# hedged, and the race claim fires on the first-token edge itself
# (TokenStream.on_first_emit), so the client can never observe two sources.


@dataclass
class HedgePolicy:
    """Hedge knobs. Hedging is per-deployment OPT-IN (a Router built
    without a policy never hedges): the extra dispatches are the wrong
    trade under overload, where the queue — not a straggler — is the
    bottleneck."""

    # Service tiers eligible for hedging (interactive is the contract
    # whose tail the hedge exists to protect).
    qos_classes: tuple = ("interactive",)
    # Hedge delay = factor x the deployment's profiled p95 (peer-median
    # across replicas so a straggler cannot inflate its own hedge bar).
    threshold_factor: float = 1.0
    # Floor under the computed delay: below this, the hedge would race
    # healthy jitter instead of stragglers.
    min_threshold_ms: float = 10.0
    # How long a computed threshold stays cached. The peer-median p95
    # moves on monitor-tick timescales; recomputing it (a locked sketch
    # walk per replica) on EVERY interactive dispatch is hot-path waste.
    threshold_refresh_ms: float = 100.0




class _HedgeRace:
    """First-winner resolution between a primary dispatch and its hedge.

    Exactly one of ``primary`` / ``hedge`` claims; the loser is
    cancelled. The outcome settles exactly once (``won``/``lost``) no
    matter how many callbacks observe the finish."""

    __slots__ = ("primary", "shadow", "primary_replica", "_lock",
                 "winner", "settled", "dispatched")

    def __init__(self, primary: Request, shadow: Request,
                 primary_replica: str) -> None:
        self.primary = primary
        self.shadow = shadow
        self.primary_replica = primary_replica
        self._lock = threading.Lock()
        self.winner: Optional[str] = None
        self.settled = False
        self.dispatched = False

    def claim(self, who: str) -> bool:
        with self._lock:
            if self.winner is None:
                self.winner = who
                # The loser's cancellation is visible BEFORE claim
                # returns: its next stream_put / fulfill / reject — on
                # any thread — already sees it, closing the window where
                # a loser's in-flight chunk lands after the claim.
                loser = self.shadow if who == "primary" else self.primary
                loser.cancelled = True
                return True
            return False

    def try_dispatch(self) -> bool:
        """Atomically decide the shadow may go out: False when either
        arm already claimed (the fire-time checks raced a finish). The
        shared lock with :meth:`claim` closes the window where a
        primary finish lands between the check and the dispatch —
        whichever acquires first, exactly one side owns the outcome."""
        with self._lock:
            if self.winner is not None:
                return False
            self.dispatched = True
            return True

    def was_dispatched(self) -> bool:
        with self._lock:
            return self.dispatched

    def settle(self) -> bool:
        """True exactly once — the caller owns recording the outcome."""
        with self._lock:
            if self.settled:
                return False
            self.settled = True
            return True


class HedgeManager:
    """Deadline-budgeted hedged dispatch for one deployment's router.

    ``arm()`` is called by the router after every successful PRIMARY
    assign of an eligible request; a worker thread fires each timer at
    ``now + profiled p95`` and — if the request has produced nothing —
    dispatches a shadow copy to a different replica through the same
    ``assign_request`` machinery failover uses. Outcome accounting
    conserves: ``fired == dispatched + late`` and, once races settle,
    ``dispatched == won + lost`` (asserted by the straggler soak)."""

    def __init__(self, router: Any, policy: HedgePolicy) -> None:
        self.router = router
        self.policy = policy
        self._seq = itertools.count()
        # (due_monotonic_ms, seq, request, primary_replica_id)
        self._heap: List[Tuple[float, int, Request, str]] = []
        self._cond = threading.Condition(OrderedLock("failover"))
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._threshold_cache: Tuple[float, float] = (0.0, float("-inf"))
        self._stats_lock = threading.Lock()
        self.armed = 0
        self.fired = 0
        self.dispatched = 0
        self.won = 0
        self.lost = 0
        self.late = 0
        self.budget_denied = 0

    # --- arming (router hot path: one eligibility check + heap push) ------
    def eligible(self, request: Request) -> bool:
        return (
            not request.is_hedge
            and not getattr(request, "_hedge_armed", False)
            and request.qos_class in self.policy.qos_classes
        )

    def threshold_ms(self) -> float:
        """The deployment's profiled p95: peer-MEDIAN across replicas
        (a straggler's own inflated tail must not raise its hedge bar),
        floored so healthy jitter never races itself. Cached for
        ``threshold_refresh_ms`` — the sweep walks a locked sketch per
        replica, too heavy for the per-dispatch arm path."""
        now = m.now_ms()
        cached_val, cached_at = self._threshold_cache
        if now - cached_at < self.policy.threshold_refresh_ms:
            return cached_val
        p95s = []
        for r in self.router.replicas():
            try:
                v = r.latency_observation()[1]
            except Exception:  # noqa: BLE001 — stats must not break routing
                continue
            if v > 0:
                p95s.append(v)
        value = max(
            self.policy.min_threshold_ms,
            self.policy.threshold_factor * median_or_zero(p95s),
        )
        self._threshold_cache = (value, now)  # atomic tuple swap
        return value

    def arm(self, request: Request, replica_id: str) -> bool:
        if not self.eligible(request):
            return False
        if len(self.router.replicas()) < 2:
            return False  # nobody to hedge onto
        request._hedge_armed = True  # one hedge per request, ever
        due = m.now_ms() + self.threshold_ms()
        with self._cond:
            if self._stopped:
                return False
            heapq.heappush(
                self._heap, (due, next(self._seq), request, replica_id)
            )
            self._ensure_worker()
            self._cond.notify()
        with self._stats_lock:
            self.armed += 1
        return True

    # --- firing -----------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker,
                name=f"hedge-{self.router.deployment}", daemon=True,
            )
            self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and (
                    not self._heap or self._heap[0][0] > m.now_ms()
                ):
                    timeout = None
                    if self._heap:
                        timeout = max(
                            (self._heap[0][0] - m.now_ms()) / 1000.0, 0.0
                        )
                    self._cond.wait(timeout)
                if self._stopped:
                    return
                _due, _seq, request, primary_replica = heapq.heappop(
                    self._heap
                )
            try:
                self._fire(request, primary_replica)  # rdb-lint: disable=retry-amplification (_fire consults the hedge budget at fire time, after the delay — charging at pop would price hedges the race already settled)
            except Exception:  # noqa: BLE001 — one bad hedge must not kill
                # the worker; the primary dispatch is unaffected either way.
                logger.exception(
                    "%s: hedge dispatch failed", self.router.deployment
                )

    def _outcome(self, outcome: str) -> None:
        with self._stats_lock:
            setattr(self, outcome, getattr(self, outcome) + 1)
        HEDGE_TOTAL.inc(tags={"deployment": self.router.deployment,
                              "outcome": outcome})

    def _fire(self, request: Request, primary_replica: str) -> None:
        with self._stats_lock:
            self.fired += 1
        # A failover re-dispatch may have moved the request since arm
        # time: strike and exclude the replica CURRENTLY holding it, not
        # the one captured at arm — else the shadow can land on the very
        # replica the primary is stuck on (racing itself) while a dead
        # peer's breaker takes the slow strike.
        primary_replica = getattr(
            request, "_assigned_replica", primary_replica
        )
        # The at-most-once-after-first-token pin, checked at the source:
        # a request that completed, failed, was cancelled, or emitted a
        # chunk is never hedged.
        if (
            request.cancelled
            or request.future.done()
            or (request.stream is not None and request.stream.emitted > 0)
        ):
            self._outcome("late")
            return
        others = [r for r in self.router.replicas()
                  if r.replica_id != primary_replica]
        remaining = request.remaining_ms()
        if not others or remaining < self.router.failover._expected_latency_ms():
            # No second replica / no deadline budget for a second
            # dispatch: the hedge would only add load, never save the
            # request.
            self._outcome("late")
            return
        # Amplification budget (serve/retrybudget.py): a hedge is a
        # second dispatch of already-admitted work — it draws from the
        # same pool as a failover retry. A denied hedge is "late" in the
        # conservation identity (timer fired, nothing dispatched) plus
        # its own counter so operators can tell budget pressure from
        # ordinary late fires.
        budget = getattr(self.router, "retry_budget", None)
        if budget is not None and not budget.try_spend("hedge"):
            with self._stats_lock:
                self.budget_denied += 1
            self._outcome("late")
            return
        # The primary exceeded the deployment's profiled p95 with nothing
        # to show — a deadline-exceeded dispatch. Strike its breaker
        # (capped + audited there) so a persistent straggler cannot hold
        # a breaker closed with slow successes.
        self.router.record_replica_slow(primary_replica)
        shadow = Request(
            model=request.model,
            payload=request.payload,
            slo_ms=request.slo_ms,
            request_id=f"{request.request_id}#hedge",
            seq_len=request.seq_len,
            trace_ctx=dict(request.trace_ctx),
            multiplexed_model_id=request.multiplexed_model_id,
            tenant=request.tenant,
            qos_class=request.qos_class,
            is_hedge=True,
        )
        # The shadow races the PRIMARY's admission deadline — a hedge
        # never buys a fresh SLO clock.
        shadow.admission_deadline_ms = request.admission_deadline_ms
        race = _HedgeRace(request, shadow, primary_replica)
        if request.stream is not None:
            from ray_dynamic_batching_tpu_torch.engine.request import TokenStream

            shadow.stream = TokenStream()
            shadow.stream.on_first_emit = (
                lambda: self._shadow_first_token(race)
            )
            request.stream.on_first_emit = (
                lambda: self._primary_first_token(race)
            )
            if request.stream.emitted > 0:
                # Token raced the hook installation: the pin wins.
                self._primary_finished(race)
        request.future.add_done_callback(
            lambda _f: self._primary_finished(race)
        )
        shadow.future.add_done_callback(
            lambda f: self._shadow_done(race, f)
        )
        if not race.try_dispatch():
            # The primary finished between the eligibility checks and
            # here — no shadow went out, the timer just fired late.
            self._outcome("late")
            return
        with self._stats_lock:
            self.dispatched += 1
        # assign_request owns terminal rejection: even a refused hedge
        # resolves the shadow future, so won + lost always reconciles
        # against dispatched.
        self.router.assign_request(
            shadow,
            exclude={primary_replica},
            timeout_s=max(remaining / 1000.0, 0.001),
        )
        if tracer().enabled:
            tracer().record_span(
                "hedge.dispatch",
                ctx=request.trace_ctx,
                start_ms=m.now_ms(),
                end_ms=m.now_ms(),
                deployment=self.router.deployment,
                lane=self.router.deployment,
                primary_replica=primary_replica,
            )

    # --- race callbacks ---------------------------------------------------
    def _primary_finished(self, race: _HedgeRace) -> None:
        """The primary produced something (first token, result, or a
        terminal rejection): cancel the hedge arm. A primary future
        resolved BY the hedge arrives here too — the claim check keeps
        that from cancelling the winner."""
        if race.claim("primary"):
            race.shadow.cancel()
            # Only a DISPATCHED shadow settles here ("lost"): if the
            # claim beat try_dispatch, _fire records "late" instead. A
            # cancelled-in-queue shadow is discarded without resolving
            # its future, so this is the loser's one accounting site.
            if race.was_dispatched() and race.settle():
                self._outcome("lost")

    def _primary_first_token(self, race: _HedgeRace) -> Optional[bool]:
        """First-emit hook on the PRIMARY's stream: resolve the race,
        then tell the stream whether the triggering chunk may deliver —
        ``False`` (veto) when the shadow claimed while this chunk was in
        flight; the grafted winner owns the client stream."""
        self._primary_finished(race)
        return race.winner != "hedge"

    def _shadow_first_token(self, race: _HedgeRace) -> None:
        """The hedge produced the FIRST token of the whole request:
        claim, cancel the primary, and graft the shadow's stream onto
        the client's (buffered chunks replay in order, then inline)."""
        if not race.claim("hedge"):
            return  # primary won: shadow chunks drop into the void
        race.primary.cancel()
        primary_stream = race.primary.stream
        # The race is resolved: detach the primary's first-emit hook so
        # the WINNER's grafted chunks (which also ride this stream) are
        # not vetoed by it.
        primary_stream.on_first_emit = None
        race.shadow.stream.subscribe(
            primary_stream.put,
            lambda err: (primary_stream.abort(err) if err is not None
                         else primary_stream.close()),
        )

    def _shadow_done(self, race: _HedgeRace, fut) -> None:
        exc = fut.exception()
        if exc is not None:
            # The hedge arm failed (shed, retries exhausted, refused):
            # the primary keeps racing its own deadline untouched —
            # UNLESS the shadow already claimed on its first token and
            # cancelled the primary. A cancelled primary is discarded at
            # queue pop without resolving its future, so the claimed-
            # then-failed shadow is the client's last chance at an
            # answer: reject (aborts the grafted stream too, idempotent
            # if the straggler's own late completion raced us).
            if race.winner == "hedge":
                race.primary.reject(exc, force=True)
            if race.settle():
                self._outcome("lost")
            return
        won = race.claim("hedge") or race.winner == "hedge"
        if won:
            race.primary.cancel()
            race.primary.fulfill(fut.result(), force=True)
            if race.settle():
                self._outcome("won")
        else:
            if race.settle():
                self._outcome("lost")

    # --- lifecycle / stats ------------------------------------------------
    def close(self) -> None:
        with self._cond:
            self._stopped = True
            self._heap = []
            self._cond.notify_all()

    def stats(self) -> dict:
        # _heap is the cond's domain, the counters are _stats_lock's;
        # take them sequentially (never nested) so neither orders
        # against the other.
        with self._cond:
            pending = float(len(self._heap))
        with self._stats_lock:
            return {
                "armed": float(self.armed),
                "fired": float(self.fired),
                "dispatched": float(self.dispatched),
                "won": float(self.won),
                "lost": float(self.lost),
                "late": float(self.late),
                "budget_denied": float(self.budget_denied),
                "pending": pending,
            }
