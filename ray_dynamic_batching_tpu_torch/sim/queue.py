"""Simulated per-model queues — the live queue's semantics at virtual time.

Mirrors ``engine/queue.py`` (``RequestQueue``/``QueueManager``) exactly
where the scheduler can observe behavior, against the injected
:class:`~ray_dynamic_batching_tpu_torch.sim.clock.VirtualClock`:

- bounded add with class-aware shed-when-full (best-effort displaced
  first; equal class drops the newcomer — ref scheduler.py:238-254);
- batch pop ordered class-then-deadline with the SAME pinned
  anti-starvation stride as live (the ordering core,
  ``engine/queue.ClassBuckets``, is imported, not re-expressed — the two
  sides cannot drift);
- stale discard at profiled latency (``deadline < now + expected_latency``
  — the staleness rule, ref :281-283);
- per-request SLO-violation accounting on completion (ref :324-341) and
  latency percentiles (exact over ALL completions here — a simulation
  report wants the whole run, not a rolling window), sliced per QoS class.

No threads, no locks, no futures: the event loop serializes everything,
and a completed request is just a counted outcome. ``stats()`` /
``class_stats()`` return the same keys as the live queue so report code
reads either side.

Own copy of ``ray_dynamic_batching_tpu/sim/queue.py``, whole, with its
import paths rewritten: the ordering core is the port's
``engine/queue.py`` ``ClassBuckets`` / ``ClassCounters``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from ray_dynamic_batching_tpu_torch.engine.queue import ClassBuckets, ClassCounters
from ray_dynamic_batching_tpu_torch.engine.request import (
    DEFAULT_QOS_CLASS,
    DEFAULT_TENANT,
)
from ray_dynamic_batching_tpu_torch.sim.clock import VirtualClock
from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch

# The simulator's slice of the live hop taxonomy (utils/hops.HOP_ORDER):
# the sim has no proxy/handle/router front end — a request exists from
# its (virtual) enqueue — so exactly two hops are observable, and the
# sim<->live drift report compares exactly these.
SIM_HOPS = ("queue.wait", "engine.step")

SLO_WINDOW = 200  # live parity: recent-completion compliance window


@dataclass
class SimRequest:
    """The simulator's request: arrival + contract, nothing else."""

    model: str
    arrival_ms: float
    slo_ms: float
    seq_len: int = 0
    qos_class: str = DEFAULT_QOS_CLASS
    tenant: str = DEFAULT_TENANT
    # Stamped at dequeue: the boundary between the sim's two ledger hops
    # (queue.wait = arrival -> pop, engine.step = pop -> completion).
    popped_ms: Optional[float] = None
    # Prefill cost BEYOND the profile-row step: > 0 marks a
    # long-prompt request whose prefill the engine executes either
    # inside its turn (mono — head-of-line blocking) or as budgeted
    # chunk events between turns (chunked). 0.0 = a bucketed prompt
    # whose prefill the row already covers.
    prefill_ms: float = 0.0
    # Client-retry generation: 0 = first attempt; a stale-shed
    # request resubmitted by the retry model arrives again with this
    # bumped — the amplification axis the retry budget bounds.
    retry_attempt: int = 0
    # Non-None marks a query of death: executing a batch that
    # contains it fails the batch, and isolation costs the engine
    # ceil(log2(B)) bisection probes plus a rescue pass.
    poison_id: Optional[str] = None

    @property
    def deadline_ms(self) -> float:
        return self.arrival_ms + self.slo_ms


def percentile(samples: List[float], p: float) -> float:
    """The live ``RollingWindow.percentile`` rule (nearest-rank via
    ceil), over an explicit sample list."""
    if not samples:
        return 0.0
    data = sorted(samples)
    idx = min(len(data) - 1, max(0, math.ceil(p * len(data)) - 1))
    return data[idx]


class SimRequestQueue:
    """Bounded class-then-deadline queue for one model, advanced by the
    event loop."""

    def __init__(self, model: str, clock: VirtualClock,
                 max_len: int = 4096) -> None:
        self.model = model
        self.clock = clock
        self.max_len = max_len
        self._buckets = ClassBuckets()
        # Optional decision ring (wired to the SimScheduler's AuditLog so
        # class-aware displacement sheds land in the same timeline live
        # queues feed).
        self.audit = None
        # Optional stale-shed hook: called with (queue, req)
        # when get_batch discards a request past its deadline. The
        # scheduler's client-retry model hangs off this; None (default)
        # is byte-identical to the pre-retry simulator.
        self.on_stale = None
        # --- stats (same counters as engine/queue.py) ---
        self.latency_samples: List[float] = []
        self._recent_outcomes: List[bool] = []
        self.total_enqueued = 0
        self.total_dropped = 0
        self.total_stale = 0
        self.total_completed = 0
        self.total_violations = 0
        self.total_poisoned = 0
        # Shared per-class accounting (engine/queue.ClassCounters — the
        # live queue's implementation, imported like ClassBuckets).
        self._classes = ClassCounters()
        # Per-hop latency sketches (virtual-event hop ledger): the SAME
        # sketch + hop names the live decomposer aggregates with, so the
        # sim<->live hop-drift report compares like with like.
        self.hop_sketches: Dict[str, QuantileSketch] = {
            hop: QuantileSketch() for hop in SIM_HOPS
        }

    def _cls(self, qos: str) -> Dict[str, float]:
        return self._classes.cls(qos)

    # --- producer side ----------------------------------------------------
    def add_request(self, request: SimRequest) -> bool:
        if len(self._buckets) >= self.max_len:
            victim = self._buckets.shed_victim(request)
            if victim is None:
                self.total_dropped += 1
                c = self._cls(request.qos_class)
                # Per-class "enqueued" counts offered-at-door (live queue
                # rule) so conservation holds through door-drops too.
                c["enqueued"] += 1
                c["dropped"] += 1
                return False
            self.total_dropped += 1
            self._cls(victim.qos_class)["dropped"] += 1
            if self.audit is not None:
                self.audit.record(
                    "qos_shed",
                    key=self.model,
                    observed={"victim_qos": victim.qos_class,
                              "victim_tenant": victim.tenant,
                              "for_qos": request.qos_class},
                    diff={"displaced": victim.qos_class},
                    note="full queue: lowest-class latest-deadline "
                         "displaced",
                )
        self._buckets.push(request)
        self.total_enqueued += 1
        self._cls(request.qos_class)["enqueued"] += 1
        return True

    # --- consumer side ----------------------------------------------------
    def get_batch(
        self,
        batch_size: int,
        expected_latency_ms: float = 0.0,
        discard_stale: bool = True,
    ) -> List[SimRequest]:
        """Pop up to ``batch_size`` in one sweep at the CURRENT virtual
        time — class then deadline, live anti-starvation stride —
        discarding requests that cannot meet their deadline given the
        profiled batch latency (live ``get_batch`` rule)."""
        now = self.clock.now_ms()
        out: List[SimRequest] = []
        while len(self._buckets) and len(out) < batch_size:
            req = self._buckets.pop()
            if discard_stale and req.deadline_ms < now + expected_latency_ms:
                self.total_stale += 1
                self._cls(req.qos_class)["stale"] += 1
                if self.on_stale is not None:
                    self.on_stale(self, req)
                continue
            req.popped_ms = now
            out.append(req)
        return out

    def __len__(self) -> int:
        return len(self._buckets)

    # --- accounting (live record_batch_completion) ------------------------
    def record_batch_completion(
        self, batch: List[SimRequest], completed_at_ms: float
    ) -> int:
        violations = 0
        for req in batch:
            total_ms = completed_at_ms - req.arrival_ms
            ok = total_ms <= req.slo_ms
            violations += 0 if ok else 1
            self.latency_samples.append(total_ms)
            # Virtual-event hop ledger: arrival -> pop -> completion
            # tiles the request's whole sim lifetime (residual == 0 by
            # construction — the sim has no instrumentation gaps).
            popped = req.popped_ms if req.popped_ms is not None \
                else completed_at_ms
            self.hop_sketches["queue.wait"].observe(
                max(0.0, popped - req.arrival_ms)
            )
            self.hop_sketches["engine.step"].observe(
                max(0.0, completed_at_ms - popped)
            )
            self._recent_outcomes.append(ok)
            c = self._cls(req.qos_class)
            c["completed"] += 1
            c["violations"] += 0 if ok else 1
        if len(self._recent_outcomes) > SLO_WINDOW:
            del self._recent_outcomes[:-SLO_WINDOW]
        self.total_completed += len(batch)
        self.total_violations += violations
        return violations

    def count_poisoned(self, req: SimRequest) -> None:
        """A popped query of death condemned by engine-side bisection
       : terminally rejected, never completed, never retried —
        accounted as a drop (it missed its SLO as surely as a displaced
        request) plus its own counter so the report can tell poison
        verdicts from load shedding. Conservation holds: arrivals ==
        completed + stale + dropped + pending."""
        self.total_dropped += 1
        self.total_poisoned += 1
        self._cls(req.qos_class)["dropped"] += 1

    def count_backlog_stale(self, req: SimRequest) -> None:
        """A popped request shed OUTSIDE the queue (the chunked-prefill
        backlog's deadline economics): its train's remaining
        chunks would land past the deadline, so the engine discards it
        exactly like the queue's own stale rule — and it must stay
        accounted (arrivals == completed + stale + dropped + pending),
        the live ``count_external_drop`` contract."""
        self.total_stale += 1
        self._cls(req.qos_class)["stale"] += 1

    def slo_compliance(self) -> float:
        if not self._recent_outcomes:
            return 1.0
        return sum(self._recent_outcomes) / len(self._recent_outcomes)

    def stats(self) -> Dict[str, float]:
        return {
            "depth": float(len(self)),
            "enqueued": float(self.total_enqueued),
            "dropped": float(self.total_dropped),
            "stale": float(self.total_stale),
            "completed": float(self.total_completed),
            "violations": float(self.total_violations),
            "slo_compliance": self.slo_compliance(),
            "latency_p50_ms": percentile(self.latency_samples, 0.50),
            "latency_p95_ms": percentile(self.latency_samples, 0.95),
            "latency_p99_ms": percentile(self.latency_samples, 0.99),
            # Live records queue delay at completion via
            # queue_delay_ms(t) = t - arrival — numerically the same
            # series as total latency, so derive rather than duplicate.
            "queue_delay_p95_ms": percentile(self.latency_samples, 0.95),
        }

    def class_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-class counter slices + live depth (live queue key set)."""
        return self._classes.stats(self._buckets.depth_by_class())

    def hop_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-hop {count, p50_ms, p95_ms} from the virtual-event
        ledger (report surface; the raw sketches stay mergeable)."""
        return {
            hop: sk.summary(quantiles=(0.5, 0.95))
            for hop, sk in self.hop_sketches.items()
        }


class SimQueueManager:
    """Name → queue registry (live ``QueueManager`` shape)."""

    def __init__(self, clock: VirtualClock, max_len: int = 4096) -> None:
        self.clock = clock
        self.max_len = max_len
        # Shared decision ring handed to every queue created from here
        # (set by the simulation before traffic starts).
        self.audit = None
        # Shared stale-shed hook, likewise handed to every queue (set by
        # the scheduler when the client-retry model is enabled).
        self.on_stale = None
        self._queues: Dict[str, SimRequestQueue] = {}

    def queue(self, model: str) -> SimRequestQueue:
        if model not in self._queues:
            q = SimRequestQueue(model, self.clock, self.max_len)
            q.audit = self.audit
            q.on_stale = self.on_stale
            self._queues[model] = q
        return self._queues[model]

    def queues(self) -> Dict[str, SimRequestQueue]:
        return dict(self._queues)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {m: q.stats() for m, q in self._queues.items()}
