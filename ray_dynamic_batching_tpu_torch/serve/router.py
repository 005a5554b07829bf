"""Request router — power-of-two-choices replica scheduling.

Own copy of ``ray_dynamic_batching_tpu/serve/router.py`` with its import
paths rewritten; :meth:`PrefixDigestDirectory.chain_for` hashes with the
port's own ``engine/paging.digest_chain``.

Re-creates Ray Serve's ``PowerOfTwoChoicesReplicaScheduler``
(``python/ray/serve/_private/replica_scheduler/pow_2_scheduler.py:52``; the
fulfillment loop with backoff is ``:673``): sample two replicas, route to the
one with the shorter queue, retry with exponential backoff while every
candidate is saturated. Queue lengths come from a short-TTL cache refreshed
on use (ref queue-len cache in the same file), and routing prefers
``locality_hint`` replicas when available (locality/multiplex awareness).

Fault tolerance rides on two layers here:

- a per-replica **circuit breaker**: N consecutive system failures trip
  the breaker and the replica leaves the pow-2 candidate pool; after a
  cooldown one half-open probe request tests it, success closes the
  breaker (ref: Serve routers deprioritizing replicas with failed health
  probes). Trip/recover events land in the controller's audit ring.
- a per-deployment :class:`~ray_dynamic_batching_tpu_torch.serve.failover.
  FailoverManager` re-dispatching retryable batch failures and drained
  queues to a different replica under the request's admission deadline.

The router also aggregates per-deployment demand metrics for the autoscaler
(ref ``RouterMetricsManager``, ``serve/_private/router.py:43``).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ray_dynamic_batching_tpu_torch.engine.request import Request, RequestDropped
from ray_dynamic_batching_tpu_torch.serve.failover import (
    FailoverManager,
    FailoverPolicy,
    HedgeManager,
    HedgePolicy,
    PoisonRequest,
)
from ray_dynamic_batching_tpu_torch.serve.quarantine import QuarantineRegistry
from ray_dynamic_batching_tpu_torch.serve.retrybudget import (
    RetryBudget,
    RetryBudgetPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.grayhealth import (
    GrayHealthMonitor,
    GrayHealthPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.replica import Replica
from ray_dynamic_batching_tpu_torch.utils.chaos import chaos
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock, assert_owner
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

logger = get_logger("router")

ROUTED_TOTAL = m.Counter(
    "rdb_router_routed_total", "Requests routed",
    tag_keys=("deployment", "shard"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)
ROUTER_REJECTED = m.Counter(
    "rdb_router_rejected_total",
    "Requests rejected (reason: backoff_exhausted | breaker_open | "
    "quarantined)",
    tag_keys=("deployment", "reason", "shard"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)

QUEUE_LEN_CACHE_TTL_S = 0.1          # ref pow_2_scheduler queue-len cache
BACKOFF_INITIAL_S = 0.002
BACKOFF_MAX_S = 0.1

BREAKER_FAILURE_THRESHOLD = 3        # consecutive system failures to trip
BREAKER_COOLDOWN_S = 1.0             # open -> half-open probe delay
# Slow strikes (deadline-exceeded / hedge-lost dispatches) needed to trip a
# breaker on a replica that is slow-but-SUCCEEDING. Deliberately above the
# failure threshold (slowness is softer evidence than an error), and NOT
# reset by ordinary successes — that reset is exactly how a persistent
# straggler used to hold its breaker closed forever.
BREAKER_SLOW_THRESHOLD = 5


class CircuitBreaker:
    """Per-replica trip state: closed -> open -> half-open -> closed.

    Counts CONSECUTIVE system failures (the failover taxonomy's
    retryables — user errors never feed it); at ``threshold`` the
    replica leaves the candidate pool. After ``cooldown_s`` exactly one
    probe request is admitted (half-open); its outcome closes or
    re-opens the breaker. Thread-safe; reads are one lock acquire.
    """

    def __init__(self, threshold: int = BREAKER_FAILURE_THRESHOLD,
                 cooldown_s: float = BREAKER_COOLDOWN_S,
                 clock=time.monotonic,
                 slow_threshold: int = BREAKER_SLOW_THRESHOLD) -> None:
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.slow_threshold = slow_threshold
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._slow_strikes = 0
        self._opened_at = 0.0
        self._half_open_at = 0.0
        self.trip_count = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _probe_expired_locked(self) -> bool:
        """A probe whose verdict never arrived (the probed request was
        stale-discarded in the queue, or the replica stopped before the
        batch ran) must not wedge the breaker half-open forever: after a
        cooldown's worth of silence the slot is forfeit and the next
        request may probe."""
        assert_owner(self._lock)  # _locked suffix: callers hold it
        return (
            self._state == "half_open"
            and self._clock() - self._half_open_at >= self.cooldown_s
        )

    def eligible(self) -> bool:
        """Read-only: may this replica be a routing CANDIDATE right now?
        (closed, or open with the cooldown elapsed — probe-eligible).
        Candidacy must not consume the probe slot: pow-2 may still route
        the request elsewhere."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                return self._clock() - self._opened_at >= self.cooldown_s
            return self._probe_expired_locked()

    def acquire(self) -> bool:
        """Claim the right to dispatch to this replica. In the open
        state past cooldown this admits exactly ONE half-open probe;
        further dispatches wait for the probe's verdict (or its expiry)."""
        with self._lock:
            if self._state == "closed":
                return True
            if (
                self._state == "open"
                and self._clock() - self._opened_at >= self.cooldown_s
            ) or self._probe_expired_locked():
                self._state = "half_open"
                self._half_open_at = self._clock()
                return True
            return False

    def release(self) -> None:
        """The acquired probe was never dispatched (the replica declined
        the assign): hand the slot back so the next request can probe."""
        with self._lock:
            if self._state == "half_open":
                self._state = "open"  # _opened_at unchanged: still eligible

    def record_failure(self) -> Optional[int]:
        """Count one system failure. On the trip edge (this failure
        OPENED the breaker) returns the actual consecutive-failure count
        — a failed half-open probe re-trips at 1, not at ``threshold`` —
        else None."""
        with self._lock:
            self._consecutive_failures += 1
            if self._state == "half_open" or (
                self._state == "closed"
                and self._consecutive_failures >= self.threshold
            ):
                self._state = "open"
                self._opened_at = self._clock()
                self.trip_count += 1
                return self._consecutive_failures
            return None

    def record_slow(self) -> Optional[int]:
        """Count one slow strike (a deadline-exceeded or hedge-lost
        dispatch — the request SUCCEEDED, too late). Strikes accumulate
        across ordinary successes (a straggler's slow successes must not
        keep resetting the evidence) and are CAPPED two ways: only a
        closed breaker accrues them (no stacking while open/half-open),
        and a half-open probe's success clears them (genuine recovery
        starts clean). Returns the strike count on the trip edge, else
        None."""
        with self._lock:
            if self._state != "closed":
                return None
            self._slow_strikes += 1
            if self._slow_strikes < self.slow_threshold:
                return None
            self._state = "open"
            self._opened_at = self._clock()
            self.trip_count += 1
            tripped_at = self._slow_strikes
            self._slow_strikes = 0
            return tripped_at

    def record_success(self) -> bool:
        """Count one success; True when it CLOSED an open/half-open
        breaker (recovery edge — which also clears slow strikes: the
        probe proved the replica healthy again)."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state != "closed":
                self._state = "closed"
                self._slow_strikes = 0
                return True
            return False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "slow_strikes": self._slow_strikes,
                "trips": self.trip_count,
            }


class _CachedLen:
    __slots__ = ("value", "at")

    def __init__(self, value: int, at: float) -> None:
        self.value = value
        self.at = at


class PrefixDigestDirectory:
    """Cluster-wide prefix index: replica_id -> published digest chains.

    Each replica publishes the digest keys of the prompt-page prefixes
    its paged pool (HBM prefix cache + host spill tier) can serve —
    16-byte hashes, never token bytes, bounded per replica. The router
    scores candidates by the LONGEST chain matching an incoming prompt
    and prefers the holders before the pow-2 pick, turning the
    per-replica CoW prefix cache into a cluster-wide tier: prompts
    sharing a system prefix converge on the replicas whose pools
    already hold it.

    Expiry is by replacement: every publish supersedes the replica's
    previous set wholesale (an entry the replica no longer advertises —
    evicted and not spilled — stops matching immediately), and
    :meth:`prune` drops departed replicas with the replica set. Thread-
    safe; reads are lock + dict probes.

    Partition semantics: the controller feeds this directory
    over the fabric's ``controller.digest_push`` edge, so publishes can
    be dropped, duplicated, or arrive late. Replacement makes all three
    harmless: a duplicated publish of the same set is detected unchanged
    (returns False, no long-poll notify), a dropped one leaves the LAST
    advertised set steering (stale hints degrade hit-rate, never
    correctness — the replica-level cache still validates), and the
    next reachable control tick republishes the truth.
    """

    def __init__(self, max_digests_per_replica: int = 256) -> None:
        self.max_digests_per_replica = int(max_digests_per_replica)
        self._lock = threading.Lock()
        self._page_size: Optional[int] = None
        # replica_id -> {digest_hex: chain_len}
        self._by_replica: Dict[str, Dict[str, int]] = {}
        self.publishes = 0

    def publish(self, replica_id: str, page_size: int,
                digests: Dict[str, int]) -> bool:
        """Replace ``replica_id``'s advertised set; returns True when the
        directory changed (the controller forwards changes — and only
        changes — over the long-poll channel)."""
        bounded = dict(list(digests.items())
                       [: self.max_digests_per_replica])
        with self._lock:
            if (self._by_replica
                    and self._page_size is not None
                    and page_size != self._page_size):
                # Mixed page sizes cannot share one digest space: chains
                # would never match across them. The CURRENT publishers'
                # size wins; a disagreeing publisher is dropped (it
                # still serves, just un-steered). Once every publisher
                # at the old size has left (rolling update to a new
                # page size), the first new publisher re-anchors it.
                self._by_replica.pop(replica_id, None)
                return False
            self._page_size = int(page_size)
            if self._by_replica.get(replica_id) == bounded:
                return False
            self._by_replica[replica_id] = bounded
            self.publishes += 1
            return True

    def prune(self, live: set) -> None:
        with self._lock:
            for rid in [r for r in self._by_replica if r not in live]:
                del self._by_replica[rid]

    def chain_for(self, payload: Any) -> List[str]:
        """The request's digest chain (hex level keys, deepest last) —
        empty when the directory is idle or the payload has no tokens
        spanning a full page. Hashing costs one O(L) pass; skipped
        entirely while nothing is published."""
        with self._lock:
            ps = self._page_size
            empty = not self._by_replica
        if empty or ps is None or not isinstance(payload, dict):
            return []
        tokens = payload.get("tokens")
        if not isinstance(tokens, (list, tuple)) or len(tokens) <= ps:
            return []
        from ray_dynamic_batching_tpu_torch.engine.paging import digest_chain

        try:
            arr = np.asarray(tokens, np.int32)
        except (TypeError, ValueError, OverflowError):
            # Malformed client tokens must not crash the routing layer:
            # un-steered routing proceeds and the replica rejects them.
            return []
        if arr.ndim != 1:
            return []  # nested lists convert, but are not a token row
        max_n = (arr.size - 1) // ps  # >=1 tail token stays prefillable
        return [k.hex() for k in digest_chain(arr, ps, max_n)]

    def best(self, chain: List[str],
             candidate_ids: List[str]) -> Tuple[int, Set[str]]:
        """(depth, holders): the longest chain level any candidate
        advertises, and every candidate advertising it. (0, {}) when
        nothing matches — the caller falls straight through to pow-2."""
        with self._lock:
            for depth in range(len(chain), 0, -1):
                key = chain[depth - 1]
                holders = {
                    rid for rid in candidate_ids
                    if key in self._by_replica.get(rid, ())
                }
                if holders:
                    return depth, holders
        return 0, set()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "page_size": self._page_size,
                "replicas": {rid: dict(d)
                             for rid, d in self._by_replica.items()},
                "publishes": self.publishes,
            }


class Router:
    """Routes requests for one deployment over its live replica set."""

    def __init__(
        self,
        deployment: str,
        replicas: Optional[Sequence[Replica]] = None,
        max_assign_timeout_s: float = 1.0,
        failover_policy: Optional[FailoverPolicy] = None,
        breaker_threshold: int = BREAKER_FAILURE_THRESHOLD,
        breaker_cooldown_s: float = BREAKER_COOLDOWN_S,
        breaker_slow_threshold: int = BREAKER_SLOW_THRESHOLD,
        gray_policy: Optional[GrayHealthPolicy] = None,
        hedge_policy: Optional[HedgePolicy] = None,
        retry_budget_policy: Optional[RetryBudgetPolicy] = None,
    ) -> None:
        self.deployment = deployment
        self.max_assign_timeout_s = max_assign_timeout_s
        # Front-door shard identity for metric families. "0" is the
        # unsharded default; an embedder running a per-shard router tier
        # (N routers behind N front-door shards) stamps each router with
        # its shard id so the routed/rejected series split per shard.
        # The single-router-per-deployment topology this controller
        # builds keeps the default.
        self.shard = "0"
        # Cluster-wide prefix routing: per-replica digest
        # publications, matched against request prompts — longest
        # matching chain narrows the pow-2 pool to the replicas whose
        # page pools already hold the prefix.
        self.digests = PrefixDigestDirectory()
        self._replicas: List[Replica] = list(replicas or [])
        self._lock = OrderedLock("router_pool")
        self._len_cache: Dict[str, _CachedLen] = {}
        self.total_routed = 0
        # Per-replica breakers persist across replica-set updates: a
        # half-open replica keeps its probe state through an unrelated
        # scale event (entries for retired replicas are pruned).
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._breaker_slow_threshold = breaker_slow_threshold
        self.failover = FailoverManager(self, policy=failover_policy)
        # Gray-failure detection (serve/grayhealth.py): the controller
        # ticks it with per-replica latency sketches; routing consults it
        # — probationed replicas leave the pow-2 pool except for probes.
        self.gray = GrayHealthMonitor(deployment, policy=gray_policy)
        # Hedged dispatch (serve/failover.HedgeManager), per-deployment
        # opt-in: None = never hedge.
        self.hedge = (HedgeManager(self, hedge_policy)
                      if hedge_policy is not None else None)
        # Anti-amplification ledger: failover retries and hedge
        # fires draw from one per-deployment budget funded by first-attempt
        # volume. Permissive (track-only) unless a policy sets a fraction;
        # the governor's `congested` verdict zeroes it in either mode.
        self.retry_budget = RetryBudget(deployment, retry_budget_policy)
        # Query-of-death fence: fingerprints isolated by replica-side batch
        # bisection; checked at assign so a quarantined payload never
        # reaches a replica again. Gossiped cluster-wide by the controller
        # alongside the prefix digests.
        self.quarantine = QuarantineRegistry()
        # Optional decision ring (the controller shares its own): breaker
        # trip/recover events are control-plane decisions and belong next
        # to heals and scale moves.
        self._audit = None
        for r in self._replicas:
            self._wire(r)

    @property
    def audit(self):
        return self._audit

    @audit.setter
    def audit(self, ring) -> None:
        # One ring for every routing-layer decision family: breaker
        # trips, gray transitions, and (via _wire) queue displacement
        # sheds all land in the controller's shared timeline.
        self._audit = ring
        self.gray.audit = ring
        self.quarantine.audit = ring

    def _wire(self, replica: Replica) -> None:
        if hasattr(replica, "failure_sink"):
            replica.failure_sink = self.failover
        # Arms query-of-death bisection: a wired replica isolates poison
        # requests instead of rejecting every co-batched innocent, and its
        # verdicts land in the shared (gossiped) registry.
        if hasattr(replica, "quarantine"):
            replica.quarantine = self.quarantine
        # Class-aware displacement sheds are control-plane decisions: the
        # replica's queue records them into the same ring as heals,
        # breaker trips and governor transitions.
        queue = getattr(replica, "queue", None)
        if queue is not None and self.audit is not None:
            queue.audit = self.audit

    # --- replica-set updates (pushed via long poll) -----------------------
    def update_replicas(self, replicas: Sequence[Replica]) -> None:
        with self._lock:
            self._replicas = list(replicas)
            self._len_cache.clear()
            live = {r.replica_id for r in replicas}
            for rid in [b for b in self._breakers if b not in live]:
                del self._breakers[rid]
        self.gray.prune(live)
        self.digests.prune(live)
        for r in replicas:
            self._wire(r)
        logger.info(
            "%s: replica set -> %s",
            self.deployment, [r.replica_id for r in replicas],
        )

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    # --- circuit breaker (fed by the failover taxonomy) -------------------
    def _breaker(self, replica_id: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(replica_id)
            if br is None:
                br = self._breakers[replica_id] = CircuitBreaker(
                    self._breaker_threshold, self._breaker_cooldown_s,
                    slow_threshold=self._breaker_slow_threshold,
                )
            return br

    def record_replica_failure(self, replica_id: str) -> None:
        br = self._breaker(replica_id)
        tripped_at = br.record_failure()
        if tripped_at is not None:
            logger.warning(
                "%s: circuit breaker OPEN for %s after %d consecutive "
                "system failures", self.deployment, replica_id, tripped_at,
            )
            if self.audit is not None:
                self.audit.record(
                    "breaker_trip",
                    key=self.deployment,
                    observed={"replica": replica_id,
                              "consecutive_failures": tripped_at},
                    after={"state": "open"},
                    diff={"excluded": replica_id},
                )

    def record_replica_slow(self, replica_id: str) -> None:
        """One slow strike (deadline-exceeded / hedge-lost dispatch)
        against this replica's breaker. Soft evidence with its own
        higher threshold — but it accumulates across successes, so a
        slow-but-succeeding straggler eventually trips."""
        br = self._breaker(replica_id)
        tripped_at = br.record_slow()
        if tripped_at is not None:
            logger.warning(
                "%s: circuit breaker OPEN for %s after %d slow strikes "
                "(deadline-exceeded/hedge-lost dispatches)",
                self.deployment, replica_id, tripped_at,
            )
            if self.audit is not None:
                self.audit.record(
                    "breaker_trip",
                    key=self.deployment,
                    observed={"replica": replica_id,
                              "slow_strikes": tripped_at},
                    after={"state": "open"},
                    diff={"excluded": replica_id},
                    note="slow-but-succeeding straggler (hedge/deadline "
                         "strikes)",
                )

    def record_replica_success(self, replica_id: str) -> None:
        br = self._breaker(replica_id)
        if br.record_success():
            logger.info(
                "%s: circuit breaker closed for %s (probe succeeded)",
                self.deployment, replica_id,
            )
            if self.audit is not None:
                self.audit.record(
                    "breaker_recover",
                    key=self.deployment,
                    observed={"replica": replica_id},
                    after={"state": "closed"},
                    diff={"readmitted": replica_id},
                )

    def breaker_states(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {rid: br.snapshot() for rid, br in self._breakers.items()}

    def requeue_drained(self, requests: List[Request], victim_id: str,
                        dead: bool = False) -> None:
        """Re-route a retired/unhealthy replica's drained queue through
        the failover path (deadline-budgeted, different replica) instead
        of erroring it back to callers. ``dead`` distinguishes a crashed
        replica (heal) from a planned retirement (rollout)."""
        self.failover.requeue(requests, victim_id, dead=dead)  # rdb-lint: disable=retry-amplification (drain salvage relocates admitted work; FailoverManager.requeue routes it budget-exempt by design)

    # --- pow-2 choice -----------------------------------------------------
    def _queue_len(self, replica: Replica, now: float) -> int:
        cached = self._len_cache.get(replica.replica_id)
        if cached is not None and now - cached.at < QUEUE_LEN_CACHE_TTL_S:
            return cached.value
        val = replica.queue_len()
        self._len_cache[replica.replica_id] = _CachedLen(val, now)
        return val

    def _choose(
        self,
        candidates: List[Replica],
        locality_hint: Optional[str],
        multiplexed_model_id: Optional[str] = None,
        digest_chain: Optional[List[str]] = None,
    ) -> Optional[Replica]:
        if not candidates:
            return None
        # Multiplexing first (ref pow_2_scheduler.py:52 candidate ranking):
        # replicas already holding the model avoid a load/compile stall.
        if multiplexed_model_id:
            warm = [
                r for r in candidates
                if multiplexed_model_id in getattr(r, "loaded_models", ())
            ]
            if warm:
                candidates = warm
        # Locality next: same-hint replicas tried as their own pool.
        if locality_hint:
            local = [
                r for r in candidates
                if getattr(r, "locality", None) == locality_hint
            ]
            if local:
                candidates = local
        # Cluster-wide prefix routing: narrow to the replicas advertising
        # the LONGEST digest chain matching this prompt — their page
        # pools already hold the prefix, so admission borrows pages
        # instead of recomputing them. Ties (several replicas at the
        # same depth) and no-match both fall through to the pow-2 pick
        # below; a preference must sharpen routing, never starve it.
        if digest_chain:
            depth, holders = self.digests.best(
                digest_chain, [r.replica_id for r in candidates]
            )
            if depth > 0:
                held = [r for r in candidates if r.replica_id in holders]
                if held:
                    candidates = held
        now = time.monotonic()
        if len(candidates) == 1:
            chosen = candidates[0]
        else:
            a, b = random.sample(candidates, 2)
            chosen = a if self._queue_len(a, now) <= self._queue_len(b, now) else b
        return chosen

    def assign_request(
        self,
        request: Request,
        locality_hint: Optional[str] = None,
        exclude: Optional[Set[str]] = None,
        timeout_s: Optional[float] = None,
    ) -> bool:
        """Route with pow-2 + backoff; reject after the assign timeout
        (ref fulfillment loop, pow_2_scheduler.py:673).

        ``exclude`` removes replicas by id from the candidate pool (the
        failover path re-dispatching away from the replica that just
        failed); ``timeout_s`` caps this call's backoff window below the
        router default (retries budget against the request's remaining
        admission deadline)."""
        # Quarantine fence FIRST — a known query of death must never
        # reach a replica again (a repeat would re-pay the bisection it
        # already lost). Free while the registry is empty; re-dispatches
        # hit it too, so an isolation elsewhere mid-flight still fences.
        fp = self.quarantine.check(self.deployment, request.payload)
        if fp is not None:
            ROUTER_REJECTED.inc(
                tags={"deployment": self.deployment,
                      "reason": "quarantined", "shard": self.shard}
            )
            request.reject(PoisonRequest(
                f"{self.deployment}: payload quarantined as query of "
                f"death (fingerprint {fp})",
                fingerprint=fp,
            ))
            return False
        # Assignment is its own traced hop: attempts > 1 means the request
        # burned wall-clock in backoff against saturated replicas — the
        # flight record shows that as router.assign duration, distinct
        # from queue wait on the chosen replica.
        with tracer().span(
            "router.assign", deployment=self.deployment, lane=self.deployment
        ) as sp:
            # Computed ONCE per assignment (one O(L) hash pass), empty
            # while no replica has published digests — the non-LLM hot
            # path pays two dict probes.
            digest_chain = self.digests.chain_for(request.payload)
            attempts = 0
            window_s = min(
                timeout_s if timeout_s is not None else
                self.max_assign_timeout_s,
                self.max_assign_timeout_s,
            )
            deadline = time.monotonic() + window_s
            backoff = BACKOFF_INITIAL_S
            breaker_excluded_last = False
            while True:
                attempts += 1
                accepting = [r for r in self.replicas() if r.accepting()]
                if exclude:
                    preferred = [
                        r for r in accepting if r.replica_id not in exclude
                    ]
                    # Soft exclusion: on a sole-replica deployment, a
                    # failover retry back to the same (possibly transiently
                    # failed) replica beats dropping the request.
                    if preferred:
                        accepting = preferred
                # Breaker gate: open-breaker replicas leave the pow-2 pool
                # (read-only eligibility — the probe slot is claimed only
                # at dispatch, below, so an unchosen candidate never
                # wedges the breaker in half-open).
                graded = [
                    r for r in accepting
                    if self._breaker(r.replica_id).eligible()
                ]
                breaker_excluded_last = bool(accepting) and not graded
                # Gray gate: probationed replicas are DRAINED from the
                # pow-2 pool except when their probe window is due (the
                # half-open arm, generalized to slowness); ejected ones
                # never serve. A verdict that would empty the pool falls
                # back to the non-ejected set — a wrong gray call must
                # degrade latency, never blackhole the deployment.
                candidates = [
                    r for r in graded
                    if self.gray.is_candidate(r.replica_id)
                ]
                if not candidates:
                    candidates = [
                        r for r in graded
                        if self.gray.state(r.replica_id) != "ejected"
                    ] or graded
                chosen = self._choose(
                    candidates, locality_hint, request.multiplexed_model_id,
                    digest_chain=digest_chain,
                )
                # chaos: a dropped assignment RPC — falls into the normal
                # backoff/retry path, like a lost PushActorTask in the
                # reference (only burns budget when there was a real
                # assignment to drop)
                if chosen is not None and chaos().should_fail("router.assign"):
                    chosen = None
                if chosen is not None:
                    breaker = self._breaker(chosen.replica_id)
                    if not breaker.acquire():
                        chosen = None  # lost the half-open probe race
                if chosen is not None:
                    if chosen.assign(request):
                        # Invalidate the cache entry so bursts spread out.
                        self._len_cache.pop(chosen.replica_id, None)
                        request.attempts += 1
                        if request.attempts == 1:
                            # First dispatch funds the retry budget;
                            # re-dispatches drew from it before reaching
                            # this path (failover.submit / hedge._fire).
                            self.retry_budget.record_first_attempt()
                        # The hedge fire path reads this: a failover
                        # re-dispatch moves the request, and the timer
                        # armed at first assign must follow it.
                        request._assigned_replica = chosen.replica_id
                        self.total_routed += 1
                        ROUTED_TOTAL.inc(tags={"deployment": self.deployment,
                                               "shard": self.shard})
                        # A dispatch onto a probationed replica IS its
                        # probe: start the next probe window.
                        self.gray.mark_probe(chosen.replica_id)
                        if self.hedge is not None:
                            self.hedge.arm(request, chosen.replica_id)
                        if sp is not None:
                            sp.attributes.update(
                                attempts=attempts, replica=chosen.replica_id
                            )
                        return True
                    breaker.release()  # declined assign frees the probe slot
                if time.monotonic() >= deadline:
                    # The metric distinguishes "every live replica was
                    # breaker-excluded" from plain saturation backoff.
                    reason = (
                        "breaker_open" if breaker_excluded_last
                        else "backoff_exhausted"
                    )
                    ROUTER_REJECTED.inc(
                        tags={"deployment": self.deployment,
                              "reason": reason, "shard": self.shard}
                    )
                    exc = RequestDropped(
                        f"{self.deployment}: no replica accepted within "
                        f"{window_s:.3f}s ({reason})"
                    )
                    # The client surface keys on this: saturation backoff
                    # is a capacity shed (429), but every-replica-breaker-
                    # open is a SYSTEM condition (503/UNAVAILABLE) — see
                    # failover.reject_disposition.
                    exc.reason = reason
                    request.reject(exc)
                    if sp is not None:
                        sp.attributes.update(
                            attempts=attempts, rejected=True, reason=reason
                        )
                    return False
                time.sleep(backoff)  # rdb-lint: disable=event-loop-blocking (caller-thread backoff by contract: the asyncio proxy offloads handle.remote to its routing pool, so this never runs on the event loop)
                backoff = min(backoff * 2, BACKOFF_MAX_S)

    def close(self) -> None:
        """Stop the failover and hedge workers (terminal rejection of
        anything still pending belongs to the failover layer)."""
        self.failover.close()
        if self.hedge is not None:
            self.hedge.close()

    # --- autoscaler metrics (ref RouterMetricsManager) --------------------
    def demand_metrics(self) -> Dict[str, float]:
        reps = self.replicas()
        total = sum(r.queue_len() for r in reps)
        return {
            "total_ongoing": float(total),
            "num_replicas": float(len(reps)),
        }
