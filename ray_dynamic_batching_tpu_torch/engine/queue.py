"""Per-model request queue with staleness discard and SLO accounting.

Port of ``ray_dynamic_batching_tpu/engine/queue.py`` — the semantics the
decode engine relies on: class-then-deadline ordering with the
anti-starvation stride (:class:`ClassBuckets`, copied as is), class-aware
shedding when full, the stale discard at pop time, per-class counters
(:class:`ClassCounters`), SLO compliance and ``stats``. The JAX package's
``RollingSketch`` quantile windows are a plain bounded window here
(:class:`RollingWindow`); its metrics counters and tracer spans are not
ported yet.
"""

from __future__ import annotations

import collections
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

SLO_WINDOW = 200  # completions tracked for compliance stats

# After this many consecutive pops that served a class while lower-priority
# work waited, one pop goes to the longest-waiting lower class.
ANTI_STARVATION_STRIDE = 8


class RollingWindow:
    """The last ``size`` observations with exact percentiles."""

    def __init__(self, size: int = 1000) -> None:
        self._vals: collections.deque = collections.deque(maxlen=size)

    def observe(self, value: float) -> None:
        self._vals.append(float(value))

    def percentile(self, q: float) -> float:
        if not self._vals:
            return 0.0
        s = sorted(self._vals)
        return s[min(len(s) - 1, int(q * len(s)))]

    def __len__(self) -> int:
        return len(self._vals)


class ClassBuckets:
    """Pure class-then-deadline ordering over items exposing ``qos_class``,
    ``deadline_ms`` and ``arrival_ms``. Not thread-safe — the owning queue
    locks. Heaps with lazy deletion (per-heap tombstone sets)."""

    def __init__(self) -> None:
        self._heaps: Dict[str, list] = {}
        self._rev_heaps: Dict[str, list] = {}
        self._live: Dict[str, int] = {}
        self._arrival_heap: list = []
        self._seq = itertools.count()
        self._size = 0
        self._skips = 0
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
        them (bounds the lazily-deleted residue)."""
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
        return sorted(
            (c for c, n in self._live.items() if n > 0),
            key=lambda c: QOS_RANK.get(c, len(QOS_RANK)),
        )

    def pop(self):
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
        self._fwd_head(cls)
        _deadline, seq, item = heapq.heappop(self._heaps[cls])
        self._gone_rev.add(seq)
        self._gone_arr.add(seq)
        self._live[cls] -= 1
        self._size -= 1
        return item

    def shed_victim(self, incoming):
        """The queued item to evict so ``incoming`` fits, or None when the
        incoming request is itself the shed victim."""
        present = self._present()
        if not present:
            return None
        lowest = present[-1]
        worst_rank = len(QOS_RANK)
        if QOS_RANK.get(lowest, worst_rank) <= QOS_RANK.get(
            incoming.qos_class, worst_rank
        ):
            return None
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
    """Per-class slices of the queue counters: ``enqueued`` counts every
    request offered at the door, so enqueued == completed + stale +
    dropped + depth."""

    KEYS = ("enqueued", "dropped", "stale", "completed", "violations")

    def __init__(self) -> None:
        self._counters: Dict[str, Dict[str, float]] = {}

    def cls(self, qos: str) -> Dict[str, float]:
        c = self._counters.get(qos)
        if c is None:
            c = self._counters[qos] = {k: 0.0 for k in self.KEYS}
        return c

    def stats(self, depths: Dict[str, int]) -> Dict[str, Dict[str, float]]:
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
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self.latency_window = RollingWindow(1000)
        self.queue_delay_window = RollingWindow(1000)
        self._recent_outcomes: List[bool] = []
        self.total_enqueued = 0
        self.total_dropped = 0
        self.total_stale = 0
        self.total_completed = 0
        self.total_violations = 0
        self._classes = ClassCounters()

    def _cls(self, qos: str) -> Dict[str, float]:
        return self._classes.cls(qos)

    def _retry_hint_s(self) -> float:
        """Retry-After for capacity rejects: the recent p50 latency."""
        p50_ms = self.latency_window.percentile(0.5)
        return max(0.05, p50_ms / 1000.0) if p50_ms > 0 else 1.0

    # --- producer side ----------------------------------------------------
    def add_request(self, request: Request, reject_on_full: bool = True,
                    requeue: bool = False) -> bool:
        """Enqueue; when full, shed the lowest-priority latest-deadline
        queued request, or drop the arrival itself (rejecting its future
        unless ``reject_on_full=False``). ``requeue=True`` marks work
        returning to the queue, which is not a fresh offer."""
        victim: Optional[Request] = None
        with self._lock:
            if self._closed:
                if reject_on_full:
                    self.total_dropped += 1
                    c = self._cls(request.qos_class)
                    c["enqueued"] += 1
                    c["dropped"] += 1
                    request.reject(RequestDropped(f"{self.model}: closed"))
                return False
            if len(self._buckets) >= self.max_len:
                victim = self._buckets.shed_victim(request)
                if victim is None:
                    if reject_on_full:
                        self.total_dropped += 1
                        c = self._cls(request.qos_class)
                        c["enqueued"] += 1
                        c["dropped"] += 1
                        exc = RequestDropped(
                            f"{self.model}: queue full ({self.max_len})"
                        )
                        exc.retry_after_s = self._retry_hint_s()
                        request.reject(exc)
                    return False
                self.total_dropped += 1
                self._cls(victim.qos_class)["dropped"] += 1
            request.enqueue_ms = now_ms()
            self._buckets.push(request)
            if not requeue:
                self.total_enqueued += 1
                self._cls(request.qos_class)["enqueued"] += 1
            self._not_empty.notify()
        if victim is not None:
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
        """Pop up to ``batch_size`` requests in one locked sweep,
        discarding any that cannot finish inside their SLO even if run
        right now (deadline < now + expected_latency)."""
        now = now_ms()
        out: List[Request] = []
        stale: List[Request] = []
        with self._lock:
            while len(self._buckets) and len(out) < batch_size:
                req = self._buckets.pop()
                if (
                    discard_stale
                    and req.deadline_ms < now + expected_latency_ms
                ):
                    stale.append(req)
                    self._cls(req.qos_class)["stale"] += 1
                    continue
                out.append(req)
            self.total_stale += len(stale)
        for req in stale:
            exc = RequestStale(
                f"{req.request_id}: deadline missed before execution"
            )
            exc.retry_after_s = self._retry_hint_s()
            req.reject(exc)
        return out

    def wait_for_requests(self, timeout_s: float) -> bool:
        """Block until the queue is non-empty (engine idle wait)."""
        with self._lock:
            if len(self._buckets):
                return True
            if self._closed:
                return False
            return self._not_empty.wait(timeout_s)

    def wake_waiters(self) -> None:
        with self._lock:
            self._not_empty.notify_all()

    def close(self) -> None:
        """Unblock all waiters; new adds are declined."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)

    # --- accounting -------------------------------------------------------
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
                self.queue_delay_window.observe(req.queue_delay_ms(t))
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
        """Account a drop decided outside the queue (teardown paths)."""
        with self._lock:
            self.total_dropped += 1
            self._cls(request.qos_class)["dropped"] += 1

    def slo_compliance(self) -> float:
        """Fraction of recent completions inside SLO (1.0 when idle)."""
        with self._lock:
            outcomes = list(self._recent_outcomes)
        if not outcomes:
            return 1.0
        return sum(outcomes) / len(outcomes)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            latency = [self.latency_window.percentile(q)
                       for q in (0.50, 0.95, 0.99)]
            delay_p95 = self.queue_delay_window.percentile(0.95)
        return {
            "depth": float(len(self)),
            "enqueued": float(self.total_enqueued),
            "dropped": float(self.total_dropped),
            "stale": float(self.total_stale),
            "completed": float(self.total_completed),
            "violations": float(self.total_violations),
            "slo_compliance": self.slo_compliance(),
            "latency_p50_ms": latency[0],
            "latency_p95_ms": latency[1],
            "latency_p99_ms": latency[2],
            "queue_delay_p95_ms": delay_p95,
        }

    def class_stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return self._classes.stats(self._buckets.depth_by_class())
