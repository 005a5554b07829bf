"""Per-model request queues with staleness discard and SLO accounting.

Own copy of ``ray_dynamic_batching_tpu/engine/queue.py`` with its import
paths rewritten, ``QueueManager`` included (the live LLM scheduler's
per-model queues) and the page fabric's migration counters.

Re-creates the reference's ``RequestQueue``
(``293-project/src/scheduler.py:190-372``): bounded add with drop-when-full
(:238-254), batch pop that discards requests which can no longer meet their
deadline given the profiled batch latency (:281-283), per-request SLO-violation
accounting on completion (:324-341), rolling latency percentiles (:343-372).

TPU-native differences:
- batch pop is a single locked operation (the reference pops item-by-item over
  an actor RPC per element — its own noted inefficiency, scheduler.py:277);
- the queue is in-process and thread-safe (engine hot loops are threads; the
  asyncio ingress talks to it through request futures), with an optional
  native C++ ring planned behind the same interface.

Multi-tenant QoS (Shepherd-style): ordering is **class then
deadline** — ``interactive`` dequeues before ``standard`` before
``best_effort``, and within a class the earliest deadline wins. Overflow
sheds **best-effort first**: a full queue evicts the latest-deadline request
of the lowest-priority class present rather than dropping a higher-class
arrival. A pinned anti-starvation stride bounds priority inversion the other
way: after :data:`ANTI_STARVATION_STRIDE` consecutive pops that bypassed
queued lower-priority work, one pop serves the longest-waiting lower class —
so best-effort always eventually drains when capacity exists. The ordering
core (:class:`ClassBuckets`) is pure and shared verbatim by the simulator's
queue (``sim/queue.py``) so the two sides cannot drift.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Optional

from ray_dynamic_batching_tpu_torch.engine.request import (
    QOS_RANK,
    Request,
    RequestDropped,
    RequestStale,
    now_ms,
)
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.utils.sketch import RollingSketch
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

SLO_WINDOW = 200  # completions tracked for compliance stats (ref :324)

# After this many consecutive pops that served a class while lower-priority
# work waited, ONE pop goes to the longest-waiting lower class. Pinned: it
# is the anti-starvation contract (best-effort gets >= 1/(STRIDE+1) of pops
# whenever it is backlogged), asserted by tests/test_qos.py.
ANTI_STARVATION_STRIDE = 8

SHED_TOTAL = m.Counter(
    "rdb_shed_total",
    "Requests shed by a queue (reason: full | displaced | stale | closed "
    "| requeue_refused | cancelled)",
    tag_keys=("model", "qos", "reason"),
)


class ClassBuckets:
    """Pure class-then-deadline ordering over items exposing ``qos_class``,
    ``deadline_ms`` and ``arrival_ms`` (live :class:`Request` and the sim's
    ``SimRequest`` both do). NOT thread-safe — the owning queue locks.

    Every structure is a heap with LAZY deletion (per-heap tombstone
    sets): pops take the min-deadline entry, sheds take the MAX-deadline
    entry of the lowest class via a reversed side-heap, and the batching
    timeout reads the min arrival via a third — all amortized O(log n).
    An eager removal would pay an O(n) scan + heapify under the queue
    lock per full-queue arrival, exactly in the sustained-overload regime
    this layer exists for."""

    def __init__(self) -> None:
        # qos -> [(deadline_ms, seq, item)]; seq breaks ties so items are
        # never compared and equal deadlines stay FIFO.
        self._heaps: Dict[str, list] = {}
        # qos -> [(-deadline_ms, -seq, item)]: the shed side (latest
        # deadline first; -seq so equal deadlines shed the NEWEST).
        self._rev_heaps: Dict[str, list] = {}
        self._live: Dict[str, int] = {}   # per-class live entry count
        self._arrival_heap: list = []     # [(arrival_ms, seq)]
        self._seq = itertools.count()
        self._size = 0
        self._skips = 0  # consecutive pops that bypassed lower-priority work
        # seq -> removed, one tombstone set per heap family (an entry
        # appears once in each, so discard-on-purge is safe per set).
        self._gone_fwd: set = set()
        self._gone_rev: set = set()
        self._gone_arr: set = set()

    def __len__(self) -> int:
        return self._size

    def push(self, item) -> None:
        self._maybe_compact()
        cls = item.qos_class
        seq = next(self._seq)
        heapq.heappush(self._heaps.setdefault(cls, []),
                       (item.deadline_ms, seq, item))
        heapq.heappush(self._rev_heaps.setdefault(cls, []),
                       (-item.deadline_ms, -seq, item))
        heapq.heappush(self._arrival_heap, (item.arrival_ms, seq))
        self._live[cls] = self._live.get(cls, 0) + 1
        self._size += 1

    def _maybe_compact(self) -> None:
        """Rebuild every heap from live entries once tombstones outnumber
        them. Lazy deletion only drains tombstoned HEADS as they surface;
        a healthy never-full queue pops from the fwd side forever while
        its rev/arrival entries (and their tombstones) accrete — without
        this, one dead tuple + seq per served request is retained for the
        process lifetime. O(n) rebuild amortized over >= n removals."""
        tombs = (len(self._gone_fwd) + len(self._gone_rev)
                 + len(self._gone_arr))
        if tombs <= max(64, 2 * self._size):
            return
        live = [
            entry
            for heap in self._heaps.values()
            for entry in heap
            if entry[1] not in self._gone_fwd
        ]
        self._heaps = {}
        self._rev_heaps = {}
        arrival = []
        for deadline, seq, item in live:
            self._heaps.setdefault(item.qos_class, []).append(
                (deadline, seq, item)
            )
            self._rev_heaps.setdefault(item.qos_class, []).append(
                (-deadline, -seq, item)
            )
            arrival.append((item.arrival_ms, seq))
        for heap in self._heaps.values():
            heapq.heapify(heap)
        for heap in self._rev_heaps.values():
            heapq.heapify(heap)
        heapq.heapify(arrival)
        self._arrival_heap = arrival
        self._gone_fwd = set()
        self._gone_rev = set()
        self._gone_arr = set()

    def _purge(self, heap: list, gone: set, seq_of) -> None:
        while heap and seq_of(heap[0]) in gone:
            gone.discard(seq_of(heapq.heappop(heap)))

    def _fwd_head(self, cls: str):
        heap = self._heaps[cls]
        self._purge(heap, self._gone_fwd, lambda e: e[1])
        return heap[0]

    def _present(self) -> List[str]:
        """Classes with live entries, highest priority (lowest rank)
        first. Unknown classes rank beyond last — lowest priority on
        BOTH the dequeue and the shed side (see :meth:`shed_victim`)."""
        return sorted(
            (c for c, n in self._live.items() if n > 0),
            key=lambda c: QOS_RANK.get(c, len(QOS_RANK)),
        )

    def pop(self):
        """Next item: highest-priority class, earliest deadline — except
        that every :data:`ANTI_STARVATION_STRIDE`-th bypass serves the
        lower-priority class whose head has waited longest (pinned
        anti-starvation bound)."""
        present = self._present()
        if not present:
            return None
        if len(present) == 1:
            self._skips = 0
            cls = present[0]
        elif self._skips >= ANTI_STARVATION_STRIDE:
            self._skips = 0
            cls = min(
                present[1:],
                key=lambda c: self._fwd_head(c)[2].arrival_ms,
            )
        else:
            self._skips += 1
            cls = present[0]
        self._fwd_head(cls)  # ensure a live head
        _deadline, seq, item = heapq.heappop(self._heaps[cls])
        self._gone_rev.add(seq)
        self._gone_arr.add(seq)
        self._live[cls] -= 1
        self._size -= 1
        return item

    def shed_victim(self, incoming):
        """The queued item to evict so ``incoming`` fits, or None when the
        incoming request IS the shed victim (nothing lower-priority is
        queued — equal class drops the newcomer, the pre-QoS behavior)."""
        present = self._present()
        if not present:
            return None
        lowest = present[-1]
        worst_rank = len(QOS_RANK)
        if QOS_RANK.get(lowest, worst_rank) <= QOS_RANK.get(
            incoming.qos_class, worst_rank
        ):
            return None
        # Latest deadline = least urgent work of the least important class.
        heap = self._rev_heaps[lowest]
        self._purge(heap, self._gone_rev, lambda e: -e[1])
        _negdl, negseq, victim = heapq.heappop(heap)
        self._gone_fwd.add(-negseq)
        self._gone_arr.add(-negseq)
        self._live[lowest] -= 1
        self._size -= 1
        return victim

    def earliest_arrival_ms(self) -> Optional[float]:
        self._purge(self._arrival_heap, self._gone_arr, lambda e: e[1])
        return self._arrival_heap[0][0] if self._arrival_heap else None

    def depth_by_class(self) -> Dict[str, int]:
        return {c: n for c, n in self._live.items() if n > 0}


class ClassCounters:
    """Per-class slices of the queue counters — ONE implementation shared
    by the live and sim queues (same no-drift discipline as
    :class:`ClassBuckets`): per-class "enqueued" counts every request
    OFFERED at the door (door-drops included), so conservation holds
    unconditionally: enqueued == completed + stale + dropped + depth.
    Lock-free; the owning queue serializes access."""

    KEYS = ("enqueued", "dropped", "stale", "completed", "violations")

    def __init__(self) -> None:
        self._counters: Dict[str, Dict[str, float]] = {}

    def cls(self, qos: str) -> Dict[str, float]:
        c = self._counters.get(qos)
        if c is None:
            c = self._counters[qos] = {k: 0.0 for k in self.KEYS}
        return c

    def stats(self, depths: Dict[str, int]) -> Dict[str, Dict[str, float]]:
        """Counter slices + live depth per class (sorted for
        deterministic report rendering)."""
        out = {}
        for cls in sorted(set(self._counters) | set(depths)):
            c = dict(self._counters.get(cls, {k: 0.0 for k in self.KEYS}))
            c["depth"] = float(depths.get(cls, 0))
            out[cls] = c
        return out


class RequestQueue:
    """Bounded class-then-deadline queue for one model."""

    def __init__(self, model: str, max_len: int = 4096):
        self.model = model
        self.max_len = max_len
        self._buckets = ClassBuckets()
        self._lock = OrderedLock("request_queue")
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        # Optional decision ring (scheduler/audit.AuditLog): class-aware
        # displacement sheds are control-plane-visible decisions; the
        # router/controller wires its ring here (None = unaudited).
        self.audit = None
        # --- stats (ref :324-372) ---
        # Rolling quantile SKETCHES: the compliance signals the
        # router/failover/governor read (`_retry_hint_s`, `stats()`
        # percentiles) hold a guaranteed relative error (default 1%)
        # and read in O(bins) instead of an O(n log n) sort under the
        # queue lock per stats() call. RECENCY is preserved: epochs
        # rotate every 1000 observations, so a read reflects at most
        # the last ~2000 completions — a retry hint must describe the
        # queue NOW, not a whole healthy morning. Same observe/
        # percentile surface as the deprecated RollingWindow(1000).
        self.latency_window = RollingSketch(1000)
        self.queue_delay_window = RollingSketch(1000)
        # Service-time slice of the same completions (total minus queue
        # delay): the live "engine.step" hop the SLO observatory grades
        # against the cost model's profile-row prediction — same hop
        # name, same sketch type as the sim's virtual-event ledger.
        self.service_window = RollingSketch(1000)
        self._recent_outcomes = []
        self.total_enqueued = 0
        self.total_dropped = 0
        self.total_stale = 0
        self.total_completed = 0
        self.total_violations = 0
        # Live-migration accounting (page fabric): a stream moved to a
        # peer engine leaves this queue's books through migrated_out
        # (neither completed nor dropped — it finishes elsewhere) and
        # enters the destination's through migrated_in (counted as
        # offered-at-door enqueued there). Conservation extends to
        # ``enqueued == completed + stale + dropped + migrated_out +
        # depth`` — trivially the old identity while both stay zero.
        self.total_migrated_out = 0
        self.total_migrated_in = 0
        # Per-class slices of the same counters (ClassCounters docstring
        # has the offered-at-door conservation contract).
        self._classes = ClassCounters()

    def _cls(self, qos: str) -> Dict[str, float]:
        return self._classes.cls(qos)

    def _retry_hint_s(self) -> float:
        """Computed ``Retry-After`` for capacity rejects: the recent p50
        request latency is the expected time for a queue slot to free —
        a client that waits it out meets a drained-a-little queue. 1 s
        before any completion (no data beats a wrong hint)."""
        p50_ms = self.latency_window.percentile(0.5)
        return max(0.05, p50_ms / 1000.0) if p50_ms > 0 else 1.0

    def _audit_shed(self, victim: Request, incoming: Request) -> None:
        if self.audit is not None:
            self.audit.record(
                "qos_shed",
                key=self.model,
                observed={"victim": victim.request_id,
                          "victim_qos": victim.qos_class,
                          "victim_tenant": victim.tenant,
                          "for_qos": incoming.qos_class},
                diff={"displaced": victim.qos_class},
                note="full queue: lowest-class latest-deadline displaced",
            )

    # --- producer side ----------------------------------------------------
    def add_request(self, request: Request, reject_on_full: bool = True,
                    requeue: bool = False) -> bool:
        """Enqueue; when full, shed the lowest-priority latest-deadline
        queued request to make room (class-aware shed), or — when nothing
        queued is lower-priority than the arrival — drop the arrival
        itself, rejecting the future (ref :238-254) unless
        ``reject_on_full=False`` (router retry path: a failed assign must
        stay retryable on another replica, not poison the future).
        ``requeue=True`` marks work RETURNING to the queue (chunked
        admission handing back a popped request): it must not count as a
        fresh offer or per-class conservation over-counts ``enqueued``."""
        victim: Optional[Request] = None
        with self._lock:
            if self._closed:
                if reject_on_full:
                    self.total_dropped += 1
                    c = self._cls(request.qos_class)
                    c["enqueued"] += 1  # offered-at-door (conservation)
                    c["dropped"] += 1
                    SHED_TOTAL.inc(tags={"model": self.model,
                                         "qos": request.qos_class,
                                         "reason": "closed"})
                    request.reject(
                        RequestDropped(f"{self.model}: closed")
                    )
                return False
            if len(self._buckets) >= self.max_len:
                victim = self._buckets.shed_victim(request)
                if victim is None:
                    if reject_on_full:
                        # Retryable declines (reject_on_full=False) are not
                        # drops — another replica may serve the request.
                        self.total_dropped += 1
                        c = self._cls(request.qos_class)
                        c["enqueued"] += 1  # offered-at-door
                        c["dropped"] += 1
                        SHED_TOTAL.inc(tags={"model": self.model,
                                             "qos": request.qos_class,
                                             "reason": "full"})
                        exc = RequestDropped(
                            f"{self.model}: queue full ({self.max_len})"
                        )
                        exc.retry_after_s = self._retry_hint_s()
                        request.reject(exc)
                    return False
                self.total_dropped += 1
                self._cls(victim.qos_class)["dropped"] += 1
                SHED_TOTAL.inc(tags={"model": self.model,
                                     "qos": victim.qos_class,
                                     "reason": "displaced"})
            request.enqueue_ms = now_ms()
            self._buckets.push(request)
            if not requeue:
                self.total_enqueued += 1
                self._cls(request.qos_class)["enqueued"] += 1
            self._not_empty.notify()
        if victim is not None:
            self._audit_shed(victim, request)
            exc = RequestDropped(
                f"{self.model}: displaced by {request.qos_class} "
                f"arrival (queue full, {victim.qos_class} sheds first)"
            )
            exc.retry_after_s = self._retry_hint_s()
            victim.reject(exc)
        return True

    # --- consumer side ----------------------------------------------------
    def get_batch(
        self,
        batch_size: int,
        expected_latency_ms: float = 0.0,
        discard_stale: bool = True,
    ) -> List[Request]:
        """Pop up to ``batch_size`` requests in one locked sweep — class
        then deadline, anti-starvation stride applied — discarding any
        that cannot finish inside their SLO even if run right now
        (arrival + slo < now + expected_latency — ref :281-283)."""
        now = now_ms()
        out: List[Request] = []
        stale: List[Request] = []
        cancelled: List[Request] = []
        with self._lock:
            while len(self._buckets) and len(out) < batch_size:
                req = self._buckets.pop()
                if getattr(req, "cancelled", False):
                    # Hedge-race loser: its outcome was already delivered
                    # by the winning dispatch. Free the slot and account
                    # it EXACTLY once (dropped/cancelled) so enqueued ==
                    # completed + stale + dropped + depth conserves; the
                    # future is already resolved, so no reject.
                    cancelled.append(req)
                    self.total_dropped += 1
                    self._cls(req.qos_class)["dropped"] += 1
                    continue
                if (
                    discard_stale
                    and req.deadline_ms < now + expected_latency_ms
                ):
                    stale.append(req)
                    self._cls(req.qos_class)["stale"] += 1
                    continue
                out.append(req)
            self.total_stale += len(stale)
            depth_after = len(self._buckets)
        for req in cancelled:
            SHED_TOTAL.inc(tags={"model": self.model,
                                 "qos": req.qos_class,
                                 "reason": "cancelled"})
        for req in stale:
            SHED_TOTAL.inc(tags={"model": self.model,
                                 "qos": req.qos_class, "reason": "stale"})
            exc = RequestStale(
                f"{req.request_id}: deadline missed before execution"
            )
            exc.retry_after_s = self._retry_hint_s()
            req.reject(exc)
        if out and tracer().enabled:
            # Retroactive queue-wait span per popped request: enqueue ->
            # this pop, joined to the request's trace (the recorder's
            # "where did the milliseconds go" hop between routing and
            # batch execution). Tenant/class ride the span so overload
            # triage can slice wait time by service tier.
            pop_ms = now_ms()
            for req in out:
                tracer().record_span(
                    "queue.wait",
                    ctx=req.trace_ctx,
                    start_ms=req.enqueue_ms or req.arrival_ms,
                    end_ms=pop_ms,
                    model=self.model,
                    lane=self.model,
                    depth_after=depth_after,
                    tenant=req.tenant,
                    qos_class=req.qos_class,
                )
        return out

    def wait_for_requests(self, timeout_s: float) -> bool:
        """Block until the queue is non-empty (engine idle wait)."""
        with self._lock:
            if len(self._buckets):
                return True
            if self._closed:
                return False
            return self._not_empty.wait(timeout_s)

    def wait_for_batch(
        self,
        batch_size: int,
        wait_timeout_s: float,
        idle_wait_s: float = 0.5,
    ) -> None:
        """Block until ``batch_size`` requests are queued OR
        ``wait_timeout_s`` has elapsed since the FIRST queued request arrived
        (Serve's size-or-timeout discipline, ref serve/batching.py:146-197).
        Condition-variable based: no polling, woken by add_request. An EMPTY
        queue blocks up to ``idle_wait_s`` per arm — the batch timeout only
        gates a partially-filled batch, so idle consumers don't spin at the
        (possibly sub-ms) batch cadence. Returns immediately once closed."""
        import time as _time

        with self._lock:
            while not self._closed:
                if len(self._buckets) >= batch_size:
                    return
                earliest = self._buckets.earliest_arrival_ms()
                if earliest is not None:
                    deadline_s = earliest / 1000.0 + wait_timeout_s
                    remaining = deadline_s - _time.monotonic()
                    if remaining <= 0:
                        return
                    self._not_empty.wait(remaining)
                else:
                    if not self._not_empty.wait(max(idle_wait_s, wait_timeout_s)):
                        return  # stayed empty for a full idle window

    def wake_waiters(self) -> None:
        """Wake any consumer blocked in wait_for_batch/wait_for_requests
        (they re-arm if the queue is still open and empty)."""
        with self._lock:
            self._not_empty.notify_all()

    def close(self) -> None:
        """Unblock and permanently release all waiters; new adds are
        declined (shutdown path — a closed queue never blocks a consumer)."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def peek_arrival_ms(self) -> Optional[float]:
        with self._lock:
            return self._buckets.earliest_arrival_ms()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)

    # --- accounting (ref record_batch_completion, :324-341) ---------------
    def record_batch_completion(
        self, batch: List[Request], completed_at_ms: Optional[float] = None
    ) -> int:
        """Count per-request SLO outcomes against arrival time; returns the
        number of violations in this batch."""
        t = completed_at_ms if completed_at_ms is not None else now_ms()
        violations = 0
        with self._lock:
            for req in batch:
                total_ms = t - req.arrival_ms
                ok = total_ms <= req.slo_ms
                violations += 0 if ok else 1
                self.latency_window.observe(total_ms)
                delay_ms = req.queue_delay_ms(t)
                self.queue_delay_window.observe(delay_ms)
                self.service_window.observe(max(0.0, total_ms - delay_ms))
                self._recent_outcomes.append(ok)
                c = self._cls(req.qos_class)
                c["completed"] += 1
                c["violations"] += 0 if ok else 1
            if len(self._recent_outcomes) > SLO_WINDOW:
                del self._recent_outcomes[:-SLO_WINDOW]
            self.total_completed += len(batch)
            self.total_violations += violations
        return violations

    def count_external_drop(self, request: Request,
                            reason: str = "closed") -> None:
        """Account a drop decided OUTSIDE the queue (drain-and-stop and
        teardown paths): work popped by ``drain_queue`` and then rejected
        would otherwise vanish from ``enqueued == completed + stale +
        dropped + depth`` conservation."""
        with self._lock:
            self.total_dropped += 1
            self._cls(request.qos_class)["dropped"] += 1
        SHED_TOTAL.inc(tags={"model": self.model,
                             "qos": request.qos_class, "reason": reason})

    def note_migrated_out(self, request: Request) -> None:
        """Close this queue's books on a stream the page fabric moved to
        a peer engine: it was enqueued here but will complete THERE —
        neither a completion nor a drop (the client sees one unbroken
        stream). Called by the engine thread at migrate-out commit."""
        with self._lock:
            self.total_migrated_out += 1

    def note_migrated_in(self, request: Request) -> None:
        """Open this queue's books on a stream migrated in from a peer:
        counted as offered-at-door enqueued (same rule as every other
        arrival) so its eventual record_batch_completion balances."""
        with self._lock:
            self.total_enqueued += 1
            self.total_migrated_in += 1
            self._cls(request.qos_class)["enqueued"] += 1

    def slo_compliance(self) -> float:
        """Fraction of recent completions inside SLO (1.0 when idle)."""
        # Snapshot under the lock: an unlocked sum()/len() pair can
        # straddle complete_batch's trim and report > 1.0 (the sum sees
        # the pre-trim list, the len the post-trim one).
        with self._lock:
            outcomes = list(self._recent_outcomes)
        if not outcomes:
            return 1.0
        return sum(outcomes) / len(outcomes)

    def stats(self) -> Dict[str, float]:
        out = {
            "depth": float(len(self)),
            "enqueued": float(self.total_enqueued),
            "dropped": float(self.total_dropped),
            "stale": float(self.total_stale),
            "completed": float(self.total_completed),
            "violations": float(self.total_violations),
            "slo_compliance": self.slo_compliance(),
            "latency_p50_ms": self.latency_window.percentile(0.50),
            "latency_p95_ms": self.latency_window.percentile(0.95),
            "latency_p99_ms": self.latency_window.percentile(0.99),
            "queue_delay_p95_ms": self.queue_delay_window.percentile(0.95),
        }
        # Elided when zero so non-migrating deployments' stats payloads
        # stay byte-identical to pre-fabric builds.
        if self.total_migrated_out:
            out["migrated_out"] = float(self.total_migrated_out)
        if self.total_migrated_in:
            out["migrated_in"] = float(self.total_migrated_in)
        return out

    def class_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-class counter slices + live depth, for QoS accounting
        (same key set as the sim queue's — report code reads either)."""
        with self._lock:
            return self._classes.stats(self._buckets.depth_by_class())


class QueueManager:
    """Name → queue registry shared by ingress, engines, and control loop."""

    def __init__(self, max_len: int = 4096):
        self.max_len = max_len
        self._queues: Dict[str, RequestQueue] = {}
        self._lock = threading.Lock()

    def queue(self, model: str) -> RequestQueue:
        with self._lock:
            if model not in self._queues:
                self._queues[model] = RequestQueue(model, self.max_len)
            return self._queues[model]

    def queues(self) -> Dict[str, RequestQueue]:
        with self._lock:
            return dict(self._queues)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {m: q.stats() for m, q in self.queues().items()}
