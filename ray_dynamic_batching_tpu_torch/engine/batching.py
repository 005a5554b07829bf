"""Batching disciplines behind one policy interface (SURVEY.md §7 stage 3).

Own copy of ``ray_dynamic_batching_tpu/engine/batching.py``, whole, with
its import paths rewritten.

Two policies from the reference, unified:

- :class:`NexusFixedBatch` — profile-driven fixed batch with staleness
  discard, as executed by the duty-cycle worker
  (``293-project/src/scheduler.py:274-289``): take up to the scheduled batch
  size immediately; the *scheduler* chose the size, the queue enforces
  deadlines.
- :class:`OpportunisticBatch` — Ray Serve's ``@serve.batch`` semantics
  (``python/ray/serve/batching.py:146-197``): return when ``max_batch_size``
  requests are waiting OR ``batch_wait_timeout_s`` has elapsed since the
  FIRST queued request; knobs are runtime-tunable (ref ``batching.py:369-386``).

Both return concrete request lists; padding-to-bucket is the engine's job
(the policy decides *membership*, the compiled-program cache decides *shape*).
"""

from __future__ import annotations

import abc
from typing import List

from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request, now_ms
from ray_dynamic_batching_tpu_torch.utils.tracing import link_to, tracer


class BatchPolicy(abc.ABC):
    @abc.abstractmethod
    def next_batch(self, queue: RequestQueue) -> List[Request]:
        """Return the next batch to execute (possibly empty)."""

    def describe(self) -> str:
        return type(self).__name__


class NexusFixedBatch(BatchPolicy):
    """Scheduled fixed-size batch; never waits (the duty cycle is the wait)."""

    def __init__(self, batch_size: int, expected_latency_ms: float = 0.0,
                 discard_stale: bool = True):
        self.batch_size = batch_size
        self.expected_latency_ms = expected_latency_ms
        self.discard_stale = discard_stale

    def next_batch(self, queue: RequestQueue) -> List[Request]:
        return queue.get_batch(
            self.batch_size,
            expected_latency_ms=self.expected_latency_ms,
            discard_stale=self.discard_stale,
        )

    def describe(self) -> str:
        return f"NexusFixedBatch(b={self.batch_size})"


class OpportunisticBatch(BatchPolicy):
    """Size-or-timeout batching (ref _BatchQueue.wait_for_batch,
    serve/batching.py:146-197)."""

    def __init__(
        self,
        max_batch_size: int = 32,
        batch_wait_timeout_s: float = 0.01,
        expected_latency_ms: float = 0.0,
    ):
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self.expected_latency_ms = expected_latency_ms

    # runtime-tunable knobs (ref batching.py:369-386)
    def set_max_batch_size(self, n: int) -> None:
        self.max_batch_size = n

    def set_batch_wait_timeout_s(self, t: float) -> None:
        self.batch_wait_timeout_s = t

    def next_batch(self, queue: RequestQueue) -> List[Request]:
        # Blocks on the queue's condition variable; deadline anchored at the
        # FIRST request's arrival, not at poll time.
        wait_start = now_ms()
        queue.wait_for_batch(self.max_batch_size, self.batch_wait_timeout_s)
        batch = queue.get_batch(
            self.max_batch_size,
            expected_latency_ms=self.expected_latency_ms,
        )
        if batch and tracer().enabled:
            # Membership decision as its own span: how long the size-or-
            # timeout discipline held the batch open, linked to every
            # member request (fan-in — parent/child cannot express it).
            # Start is clamped to the FIRST member's enqueue: idle-queue
            # time before any request existed is not formation hold.
            first_in = min(
                (r.enqueue_ms or r.arrival_ms) for r in batch
            )
            tracer().record_span(
                "batch.form",
                start_ms=max(wait_start, first_in),
                end_ms=now_ms(),
                links=[link_to(r.trace_ctx) for r in batch],
                policy=self.describe(),
                model=queue.model,
                lane=queue.model,
                size=len(batch),
            )
        return batch

    def describe(self) -> str:
        return (
            f"OpportunisticBatch(max={self.max_batch_size}, "
            f"wait={self.batch_wait_timeout_s * 1000:.0f}ms)"
        )
