"""Request object flowing through queues to the replica engine.

Own copy of ``ray_dynamic_batching_tpu/engine/request.py``, whole, with
its import paths rewritten.

Analogue of the reference's ``BatchRequest``
(``293-project/src/scheduler.py:181-188``: request_id, data, arrival_time,
SLO). Result delivery is a ``concurrent.futures.Future`` so the asyncio
ingress can await it while the engine hot loop stays a plain thread.

Streaming delivery (ref generator batches, ``serve/batching.py:209-276``,
and the streaming replica path, ``serve/_private/replica.py:515-544``) rides
a :class:`TokenStream`: the producer (decode engine / generator callable)
pushes chunks as they exist, the consumer (proxy, client) iterates them
before the request completes. The future still resolves with the final
result, so non-streaming callers are unaffected.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock

_req_counter = itertools.count(1)


def now_ms() -> float:
    return time.monotonic() * 1000.0


# --- QoS classes (Shepherd-style priority tiers) --------------------------
# Rank orders DEQUEUE priority (lower = served first) and the inverse shed
# order (highest rank sheds first). Weights price an SLO miss for the
# planner's weighted attainment (scheduler/replan.weighted_attainment):
# an interactive miss costs 4x a best-effort one.
QOS_CLASSES = ("interactive", "standard", "best_effort")
QOS_RANK = {"interactive": 0, "standard": 1, "best_effort": 2}
QOS_WEIGHTS = {"interactive": 4.0, "standard": 2.0, "best_effort": 1.0}
DEFAULT_QOS_CLASS = "standard"
DEFAULT_TENANT = "default"


def normalize_qos(value: Optional[str]) -> str:
    """Validate a client-supplied class name; unknown values are the
    CLIENT's fault (BadRequest -> 4xx), never a silent default — a typo'd
    'interactve' must not quietly serve at best-effort shed priority."""
    if value is None or value == "":
        return DEFAULT_QOS_CLASS
    if value not in QOS_RANK:
        raise BadRequest(
            f"unknown qos_class {value!r} (one of: {', '.join(QOS_CLASSES)})"
        )
    return value


class StreamClosed(Exception):
    """Raised by :meth:`TokenStream.get` after close + drain."""


class TokenStream:
    """Single-producer single-consumer chunk stream with blocking reads.

    The producer calls :meth:`put` per chunk and exactly one of
    :meth:`close` / :meth:`abort`; the consumer iterates (or calls
    :meth:`get`) and stops at close. Thread-safe; the hot producer path is
    one lock acquire + notify.
    """

    def __init__(self, max_buffer: int = 4096) -> None:
        self._chunks: deque = deque()
        self._lock = OrderedLock("token_stream")
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._error: Optional[Exception] = None
        self._on_chunk = None
        self._on_close = None
        self.max_buffer = max_buffer
        # Chunks actually delivered toward the consumer (buffered or pushed).
        # The failover layer reads this to enforce at-most-once-after-first-
        # token: a streaming request that already emitted a chunk must NOT
        # be transparently retried — the client has observed partial output.
        self.emitted = 0
        # Invoked exactly once, on the emitted 0 -> 1 edge (producer
        # thread, outside the lock). The hedge race claims first-winner
        # here: the instant a primary emits its first token, the hedge
        # is cancelled — the at-most-once-after-first-token boundary,
        # enforced at the token source rather than by polling. A hook
        # that returns ``False`` VETOES delivery of the triggering chunk
        # (the producer lost the claim while this chunk was in flight;
        # ``emitted`` still counts it — the winner's grafted chunks keep
        # the stream's observed-output contract honest).
        self.on_first_emit = None

    def put(self, chunk: Any, drop_if=None) -> None:
        """``drop_if`` (checked under the lock, at entry AND delivery)
        lets a producer make its own suppression atomic with delivery:
        the hedge loser passes its ``cancelled`` flag so a chunk that
        passed an earlier check cannot land after the race resolves."""
        first_emit_cb = None
        with self._cond:
            if self._closed:
                return  # consumer gone / finished — drop quietly
            if drop_if is not None and drop_if():
                return  # producer suppressed (lost the hedge race)
            self.emitted += 1
            if self.emitted == 1 and self.on_first_emit is not None:
                first_emit_cb = self.on_first_emit
        if first_emit_cb is not None:
            if first_emit_cb() is False:
                return  # race hook vetoed this producer's chunk
        with self._cond:
            if self._closed:
                return  # the first-emit hook may have closed us
            if drop_if is not None and drop_if():
                return  # race resolved against this producer mid-put
            if self._on_chunk is not None:
                cb = self._on_chunk
            else:
                if len(self._chunks) >= self.max_buffer:
                    # Slow consumer: drop oldest (token streams are advisory;
                    # the future still carries the complete result).
                    self._chunks.popleft()
                self._chunks.append(chunk)
                self._cond.notify()
                return
        cb(chunk)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            cb = self._on_close
        if cb is not None:
            cb(None)

    def abort(self, exc: Exception) -> None:
        with self._cond:
            self._error = exc
            self._closed = True
            self._cond.notify_all()
            cb = self._on_close
        if cb is not None:
            cb(exc)

    def subscribe(self, on_chunk, on_close) -> None:
        """Switch to push delivery: buffered chunks replay immediately, then
        the producer invokes ``on_chunk(chunk)`` inline per put and exactly
        one ``on_close(error_or_None)`` at the end. Callbacks must be cheap
        and thread-safe (they run on the producer thread) — an asyncio
        consumer bridges with ``loop.call_soon_threadsafe``. This removes
        the blocked-reader thread a pull consumer would need."""
        with self._cond:
            # Backlog replays while the lock is held, BEFORE inline delivery
            # becomes visible to put() — otherwise a concurrent put could
            # deliver a new chunk ahead of older buffered ones.
            for c in self._chunks:
                on_chunk(c)
            self._chunks.clear()
            self._on_chunk = on_chunk
            self._on_close = on_close
            closed, err = self._closed, self._error
        if closed:
            on_close(err)

    def get(self, timeout_s: Optional[float] = None) -> Any:
        """Next chunk; raises :class:`StreamClosed` when drained+closed,
        ``TimeoutError`` on timeout, or the producer's abort error."""
        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        with self._cond:
            while True:
                if self._chunks:
                    return self._chunks.popleft()
                if self._closed:
                    if self._error is not None:
                        raise self._error
                    raise StreamClosed()
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("TokenStream.get timed out")
                self._cond.wait(remaining)

    def __iter__(self) -> Iterator[Any]:
        while True:
            try:
                yield self.get()
            except StreamClosed:
                return

    def drain(self, timeout_s: float = 10.0) -> List[Any]:
        """Collect every chunk until close (tests / non-incremental readers)."""
        out: List[Any] = []
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                out.append(self.get(timeout_s=deadline - time.monotonic()))
            except StreamClosed:
                return out


@dataclass
class Request:
    model: str
    payload: Any                      # model-specific input (np arrays, tokens)
    slo_ms: float
    request_id: str = ""
    arrival_ms: float = field(default_factory=now_ms)
    # Stamped by the decode engine when the request is dequeued into a slot
    # (TTFT = [arrival..admit: queue/scan wait] + [admit..first token:
    # prefill]); None until an engine admits it.
    admit_ms: Optional[float] = None
    # Stamped by RequestQueue.add_request on the LAST enqueue (a request can
    # be requeued on router retry / slot starvation): the queue-wait span
    # measures from here, not from arrival — routing time is its own hop.
    enqueue_ms: Optional[float] = None
    seq_len: int = 0                  # shape bucket hint for LLM inputs
    future: Future = field(default_factory=Future)
    trace_ctx: Dict[str, Any] = field(default_factory=dict)
    # Present iff the caller asked for incremental delivery; producers that
    # don't stream simply never touch it (future-only contract unchanged).
    stream: Optional[TokenStream] = None
    # Model-multiplexing hint (ref pow_2_scheduler.py:52): the router
    # prefers replicas that already hold this model in HBM.
    multiplexed_model_id: Optional[str] = None
    # Dispatch count (router assignments, including failover re-dispatches).
    # The failover layer bounds this with its attempt budget; it never
    # resets on retry, so a bouncing request cannot circulate forever.
    attempts: int = 0
    # Frozen at admission (arrival + SLO). Retries budget against THIS
    # deadline: a re-dispatched request gets no fresh SLO clock, exactly
    # like the reference's shed accounting (a request either completes
    # within its admitted deadline or is counted shed).
    admission_deadline_ms: float = 0.0
    # Multi-tenant QoS: who sent it and at which service
    # tier. Both ride the request through every retry/requeue — failover
    # re-dispatches the SAME object, so class and tenant survive failover
    # by construction (pinned in tests/test_qos.py).
    tenant: str = DEFAULT_TENANT
    qos_class: str = DEFAULT_QOS_CLASS
    # Set by the hedge race's loser-cancellation: a cancelled request
    # still QUEUED is discarded at pop time (counted once, reason
    # "cancelled" — its outcome was already delivered by the winner); a
    # cancelled request already mid-execution finishes harmlessly (its
    # fulfill/reject no-op against the resolved future).
    cancelled: bool = False
    # True for a hedge shadow (never armed for a further hedge itself).
    is_hedge: bool = False

    def __post_init__(self) -> None:
        if not self.request_id:
            self.request_id = f"{self.model}-{next(_req_counter)}"
        if not self.admission_deadline_ms:
            self.admission_deadline_ms = self.arrival_ms + self.slo_ms
        self.qos_class = normalize_qos(self.qos_class)
        if not self.tenant:
            self.tenant = DEFAULT_TENANT

    @property
    def deadline_ms(self) -> float:
        return self.admission_deadline_ms

    def remaining_ms(self, now: Optional[float] = None) -> float:
        """Deadline budget left (negative = already past due)."""
        return self.deadline_ms - (now if now is not None else now_ms())

    def queue_delay_ms(self, now: Optional[float] = None) -> float:
        return (now if now is not None else now_ms()) - self.arrival_ms

    def reject(self, exc: Exception, force: bool = False) -> None:
        """``force=True`` is the hedge winner's delivery path: a
        cancelled request's own (late, lost) execution must not touch
        the client — only the race winner resolves it."""
        if self.cancelled and not force:
            return
        if self.stream is not None:
            self.stream.abort(exc)
        if not self.future.done():
            self.future.set_exception(exc)

    def fulfill(self, result: Any, force: bool = False) -> None:
        if self.cancelled and not force:
            return
        if self.stream is not None:
            self.stream.close()
        if not self.future.done():
            self.future.set_result(result)

    def stream_put(self, chunk: Any) -> None:
        """Push one incremental chunk (no-op for non-streaming requests).
        A cancelled dispatch's chunks are dropped at the source — and
        re-checked under the stream lock at delivery (``drop_if``), so a
        chunk in flight when the hedge race resolves cannot interleave
        with the winner's grafted stream."""
        if self.stream is not None and not self.cancelled:
            self.stream.put(chunk, drop_if=lambda: self.cancelled)

    def cancel(self) -> None:
        """Mark this dispatch redundant (the hedge race was won by the
        other arm). Queues discard it at pop; a running execution keeps
        computing but its chunks, result, and errors are suppressed —
        the winner owns the client-visible outcome."""
        self.cancelled = True


class BadRequest(ValueError):
    """The request payload itself is malformed — the CLIENT's fault. The
    HTTP proxy maps this (and only this) to a 4xx; plain ValueError from
    replica/engine internals stays a server error."""


class RequestDropped(Exception):
    """Raised into a request's future when the queue drops it."""


class RequestStale(Exception):
    """Raised when a request cannot meet its deadline and is discarded
    (staleness discard, ref scheduler.py:281-283)."""
