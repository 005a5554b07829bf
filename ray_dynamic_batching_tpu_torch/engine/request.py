"""Request object flowing through queues to the decode engine.

Port of ``ray_dynamic_batching_tpu/engine/request.py``: ``Request``,
``TokenStream``, the error types, ``now_ms`` and the QoS normalisation.
Result delivery is a ``concurrent.futures.Future`` so callers can wait on
it while the engine loop stays a plain thread. The JAX package's ranked
``OrderedLock`` is a plain ``threading.Lock`` here. Tenants, trace
contexts, retry attempts, hedge cancellation and the ``TokenStream``
hedge-race hooks belong to the router slice and are not ported yet.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional

_req_counter = itertools.count(1)


def now_ms() -> float:
    return time.monotonic() * 1000.0


# Rank orders dequeue priority (lower = served first) and the inverse shed
# order.
QOS_CLASSES = ("interactive", "standard", "best_effort")
QOS_RANK = {"interactive": 0, "standard": 1, "best_effort": 2}
DEFAULT_QOS_CLASS = "standard"


def normalize_qos(value: Optional[str]) -> str:
    """Validate a client-supplied class name; unknown values are the
    client's fault (BadRequest), never a silent default."""
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
    :meth:`get`) and stops at close."""

    def __init__(self, max_buffer: int = 4096) -> None:
        self._chunks: deque = deque()
        self._cond = threading.Condition(threading.Lock())
        self._closed = False
        self._error: Optional[Exception] = None
        self.max_buffer = max_buffer
        self.emitted = 0

    def put(self, chunk: Any) -> None:
        with self._cond:
            if self._closed:
                return  # consumer gone / finished — drop quietly
            self.emitted += 1
            if len(self._chunks) >= self.max_buffer:
                # Slow consumer: drop oldest (the future still carries the
                # complete result).
                self._chunks.popleft()
            self._chunks.append(chunk)
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def abort(self, exc: Exception) -> None:
        with self._cond:
            self._error = exc
            self._closed = True
            self._cond.notify_all()

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
        """Collect every chunk until close."""
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
    payload: Any                      # model-specific input (token ids)
    slo_ms: float
    request_id: str = ""
    arrival_ms: float = field(default_factory=now_ms)
    # Stamped by the decode engine at dequeue (TTFT decomposition).
    admit_ms: Optional[float] = None
    # Stamped by RequestQueue.add_request on the last enqueue.
    enqueue_ms: Optional[float] = None
    future: Future = field(default_factory=Future)
    # Present iff the caller asked for incremental delivery.
    stream: Optional[TokenStream] = None
    # Model-multiplexing hint: the replica records it as resident.
    multiplexed_model_id: Optional[str] = None
    # Frozen at admission (arrival + SLO); the stale discard reads it.
    admission_deadline_ms: float = 0.0
    qos_class: str = DEFAULT_QOS_CLASS

    def __post_init__(self) -> None:
        if not self.request_id:
            self.request_id = f"{self.model}-{next(_req_counter)}"
        if not self.admission_deadline_ms:
            self.admission_deadline_ms = self.arrival_ms + self.slo_ms
        self.qos_class = normalize_qos(self.qos_class)

    @property
    def deadline_ms(self) -> float:
        return self.admission_deadline_ms

    def queue_delay_ms(self, now: Optional[float] = None) -> float:
        return (now if now is not None else now_ms()) - self.arrival_ms

    def reject(self, exc: Exception) -> None:
        if self.stream is not None:
            self.stream.abort(exc)
        if not self.future.done():
            self.future.set_exception(exc)

    def fulfill(self, result: Any) -> None:
        if self.stream is not None:
            self.stream.close()
        if not self.future.done():
            self.future.set_result(result)

    def stream_put(self, chunk: Any) -> None:
        """Push one incremental chunk (no-op for non-streaming requests)."""
        if self.stream is not None:
            self.stream.put(chunk)


class BadRequest(ValueError):
    """The request payload itself is malformed — the client's fault."""


class RequestDropped(Exception):
    """Raised into a request's future when the queue drops it."""


class RequestStale(Exception):
    """Raised when a request cannot meet its deadline and is discarded."""
