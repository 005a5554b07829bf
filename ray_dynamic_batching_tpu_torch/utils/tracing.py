"""Lightweight span tracing with context propagation and span links.

Own copy of ``ray_dynamic_batching_tpu/utils/tracing.py`` with its
import paths rewritten, whole: the port has its own process tracer.

Analogue of the reference's OpenTelemetry task/actor tracing
(``python/ray/util/tracing/tracing_helper.py:293,326,411`` — spans injected
around every call, context carried in task metadata via ``_DictPropagator``).
Here spans are in-process dataclasses with dict-based propagation so they can
cross actor mailboxes and HTTP hops; an exporter hook collects finished spans.

Beyond parent/child, spans carry **links** (OTel span links): dynamic
batching fans N request traces into ONE batch execution, which parent/child
cannot express — the batch span links to every member request span and each
member's execution span links back to the batch. HTTP/gRPC ingest honors
inbound W3C ``traceparent`` headers (:func:`parse_traceparent`), and
:func:`format_traceparent` mints one for clients that want to originate the
trace — there is no downstream HTTP hop here to forward it to.
"""

from __future__ import annotations

import contextvars
import random
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

# Process-unique random ids: a per-process counter would collide when spans
# from multiple workers are aggregated by one exporter.
def _new_span_id() -> int:
    return random.getrandbits(63)


_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "rdb_current_span", default=None
)

# Finished spans kept in-process are bounded; the exporter is the durable sink.
_FINISHED_SPAN_CAP = 10_000

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    start_ms: float
    end_ms: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    # Span links (fan-in/fan-out across traces): each entry is a context
    # dict {"trace_id": str, "span_id": int} of the linked span.
    links: List[Dict[str, Any]] = field(default_factory=list)

    def duration_ms(self) -> float:
        return (self.end_ms or time.monotonic() * 1000.0) - self.start_ms

    def context(self) -> Dict[str, Any]:
        """Propagation/link context naming THIS span as the peer."""
        return {"trace_id": self.trace_id, "parent_span_id": self.span_id}


def link_to(span_or_ctx: Any) -> Optional[Dict[str, Any]]:
    """Normalize a Span or a propagated context dict into a link entry.
    Returns None for empty/contextless inputs so callers can filter."""
    if span_or_ctx is None:
        return None
    if isinstance(span_or_ctx, Span):
        return {"trace_id": span_or_ctx.trace_id, "span_id": span_or_ctx.span_id}
    trace_id = span_or_ctx.get("trace_id")
    span_id = span_or_ctx.get("parent_span_id", span_or_ctx.get("span_id"))
    if not trace_id or span_id is None:
        return None
    return {"trace_id": trace_id, "span_id": span_id}


def format_traceparent(ctx: Dict[str, Any]) -> Optional[str]:
    """W3C traceparent header from a propagated context (version 00,
    sampled flag set — this tracer records everything it is handed)."""
    link = link_to(ctx)
    if link is None:
        return None
    return f"00-{link['trace_id']}-{link['span_id']:016x}-01"


def parse_traceparent(header: Optional[str]) -> Dict[str, Any]:
    """Propagated context from a ``traceparent`` header; {} on absent or
    malformed input (a bad header must start a fresh trace, not error).
    The all-zero trace/span ids are invalid per W3C — honoring them would
    merge every unsampled client's requests into one degenerate trace."""
    if not header:
        return {}
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None or m.group(1) == "ff":
        return {}
    if set(m.group(2)) == {"0"} or set(m.group(3)) == {"0"}:
        return {}
    return {"trace_id": m.group(2), "parent_span_id": int(m.group(3), 16)}


class Tracer:
    def __init__(self) -> None:
        self._finished: deque = deque(maxlen=_FINISHED_SPAN_CAP)
        self._lock = threading.Lock()
        self._exporter: Optional[Callable[[Span], None]] = None
        self._export_error_logged = False
        self.enabled = False

    def set_exporter(self, exporter: Callable[[Span], None]) -> None:
        self._exporter = exporter
        self._export_error_logged = False
        self.enabled = True

    def reset(self) -> None:
        """Disable tracing and drop exporter + buffered spans (test hygiene)."""
        self._exporter = None
        self.enabled = False
        self.clear()

    def _finish(self, s: Span) -> None:
        with self._lock:
            self._finished.append(s)
        exporter = self._exporter
        if exporter is None:
            return
        try:
            exporter(s)
        except Exception:  # noqa: BLE001 — a broken sink (disk full,
            # closed file) must degrade TRACING, never the serving path
            # that emitted the span (spans finish inside queue pops and
            # engine hot loops; a propagated error there drops already-
            # popped requests on the floor).
            if not self._export_error_logged:
                self._export_error_logged = True
                import logging

                logging.getLogger("rdb.tracing").exception(
                    "span exporter failed; further errors suppressed"
                )

    @contextmanager
    def span(
        self,
        name: str,
        links: Optional[List[Optional[Dict[str, Any]]]] = None,
        **attributes: Any,
    ) -> Iterator[Optional[Span]]:
        if not self.enabled:
            yield None
            return
        parent = _current_span.get()
        s = Span(
            name=name,
            trace_id=parent.trace_id if parent else uuid.uuid4().hex,
            span_id=_new_span_id(),
            parent_id=parent.span_id if parent else None,
            start_ms=time.monotonic() * 1000.0,
            attributes=dict(attributes),
            links=[l for l in (links or []) if l],
        )
        token = _current_span.set(s)
        try:
            yield s
        finally:
            s.end_ms = time.monotonic() * 1000.0
            _current_span.reset(token)
            self._finish(s)

    # --- context propagation (ref: _DictPropagator, tracing_helper.py:165) ---
    def inject_context(self) -> Dict[str, Any]:
        s = _current_span.get()
        if s is None:
            return {}
        return {"trace_id": s.trace_id, "parent_span_id": s.span_id}

    def current_span(self) -> Optional[Span]:
        return _current_span.get()

    def current_trace_id(self) -> Optional[str]:
        """Trace id of the active span (metrics exemplars hook)."""
        s = _current_span.get()
        return s.trace_id if s is not None else None

    @contextmanager
    def attach_context(
        self,
        ctx: Dict[str, Any],
        name: str,
        links: Optional[List[Optional[Dict[str, Any]]]] = None,
        **attributes: Any,
    ) -> Iterator[Optional[Span]]:
        if not self.enabled or not ctx:
            with self.span(name, links=links, **attributes):
                yield _current_span.get()
            return
        s = Span(
            name=name,
            trace_id=ctx.get("trace_id", uuid.uuid4().hex),
            span_id=_new_span_id(),
            parent_id=ctx.get("parent_span_id"),
            start_ms=time.monotonic() * 1000.0,
            attributes=dict(attributes),
            links=[l for l in (links or []) if l],
        )
        token = _current_span.set(s)
        try:
            yield s
        finally:
            s.end_ms = time.monotonic() * 1000.0
            _current_span.reset(token)
            self._finish(s)

    def record_span(
        self,
        name: str,
        ctx: Optional[Dict[str, Any]] = None,
        start_ms: Optional[float] = None,
        end_ms: Optional[float] = None,
        links: Optional[List[Optional[Dict[str, Any]]]] = None,
        **attributes: Any,
    ) -> Optional[Span]:
        """Emit an already-finished span for a retroactively-measured
        interval (queue wait, prefill): the duration was observed by
        timestamps on the request, not by code running inside a ``with``
        block, so there is nothing to wrap. Joined to ``ctx``'s trace when
        given, else parented under the current span."""
        if not self.enabled:
            return None
        now = time.monotonic() * 1000.0
        parent = _current_span.get()
        if ctx:
            trace_id = ctx.get("trace_id", uuid.uuid4().hex)
            parent_id = ctx.get("parent_span_id")
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = uuid.uuid4().hex, None
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id=_new_span_id(),
            parent_id=parent_id,
            start_ms=start_ms if start_ms is not None else now,
            end_ms=end_ms if end_ms is not None else now,
            attributes=dict(attributes),
            links=[l for l in (links or []) if l],
        )
        self._finish(s)
        return s

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


_tracer = Tracer()


def tracer() -> Tracer:
    return _tracer
