"""Chrome-trace / Perfetto export for finished spans.

Own copy of ``ray_dynamic_batching_tpu/utils/trace_export.py``, whole,
with its import paths rewritten.

The reference exports OTel spans to whatever backend the operator wires up;
here the flight recorder renders spans in the Chrome trace-event JSON format
(the ``{"traceEvents": [...]}`` shape Perfetto and ``chrome://tracing`` both
open directly):

- one **process lane per component** (proxy, router, queue, engine, decode,
  replica, ...) derived from the span-name prefix;
- one **thread lane per chip/replica/model** inside the component, from the
  span's ``lane`` attribute when present;
- complete (``ph: "X"``) events carrying trace/span ids + attributes in
  ``args``;
- **flow arrows** (``ph: "s"``/``"f"``) rendering span links, so a batch
  execution visually connects to its N member request spans.

Two exporters feed this: :class:`ChromeTraceCollector` buffers spans
in-process (demos, tests), :class:`FileSpanExporter` appends one JSON object
per finished span to a JSONL file that ``tools/dump_trace.py`` converts
offline.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, Iterable, List, Optional

from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.concurrency import assert_owner
from ray_dynamic_batching_tpu_torch.utils.tracing import Span

# Spans a sink refused (cap reached, sink closed): counted per sink, and
# every export surface stamps ``truncated`` so a capped capture can never
# masquerade as a complete one (repo rule: no silent caps).
TRACE_DROPPED = m.Counter(
    "rdb_trace_dropped_spans_total",
    "Finished spans an export sink dropped (cap reached / sink closed)",
    tag_keys=("sink",),
)

# JSONL header sentinel key (first line of a FileSpanExporter capture).
_HEADER_KEY = "_rdb_export"
# Fixed header width: the line is written at open and REWRITTEN in place
# at close with the final counts, so it must occupy constant bytes.
_HEADER_WIDTH = 96

# Span-name prefix -> process lane. Unknown prefixes get their own lane
# appended after these, so new components never collapse into one row.
_COMPONENT_ORDER = (
    "proxy", "grpc", "handle", "router", "scheduler", "queue", "batch",
    "replica", "collate", "engine", "decode",
)


def span_component(span: Span) -> str:
    return span.name.split(".", 1)[0]


def span_to_dict(span: Span) -> Dict[str, Any]:
    return {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_id": span.parent_id,
        "start_ms": span.start_ms,
        "end_ms": span.end_ms,
        "attributes": dict(span.attributes),
        "links": list(span.links),
    }


def span_from_dict(d: Dict[str, Any]) -> Span:
    return Span(
        name=d["name"],
        trace_id=d["trace_id"],
        span_id=int(d["span_id"]),
        parent_id=d.get("parent_id"),
        start_ms=float(d["start_ms"]),
        end_ms=d.get("end_ms"),
        attributes=dict(d.get("attributes") or {}),
        links=list(d.get("links") or []),
    )


def journal_to_chrome_events(
    events: Iterable[Dict[str, Any]],
    pid: int,
    lane: str = "paging",
) -> List[Dict[str, Any]]:
    """Paged-KV allocator journal entries (``engine/paging.
    PageEventJournal``) as Chrome trace events: one INSTANT event
    (``ph: "i"``) per alloc/free/CoW-copy/cache-reclaim/eviction, plus a
    ``kv_pages_in_use`` COUNTER track (``ph: "C"``) sampled at every
    event — time-aligned with the decode-turn spans because the journal
    stamps the same monotonic-ms clock the tracer uses."""
    out: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": lane}},
    ]
    for ev in events:
        args = {k: v for k, v in ev.items() if k != "t_ms"}
        out.append({
            "ph": "i", "s": "p", "name": ev["kind"], "cat": "paging",
            "pid": pid, "tid": 0,
            "ts": float(ev["t_ms"]) * 1000.0,
            "args": args,
        })
        if "pages_in_use" in ev:
            out.append({
                "ph": "C", "name": "kv_pages_in_use", "pid": pid, "tid": 0,
                "ts": float(ev["t_ms"]) * 1000.0,
                "args": {"pages": ev["pages_in_use"]},
            })
    return out


def to_chrome_trace(
    spans: Iterable[Span],
    journal: Optional[Iterable[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Render spans as a Chrome trace-event JSON document. ``journal``
    optionally appends a paged-KV allocator event lane
    (:func:`journal_to_chrome_events`) after the component lanes."""
    spans = [s for s in spans if s.end_ms is not None]
    components: List[str] = [
        c for c in _COMPONENT_ORDER
        if any(span_component(s) == c for s in spans)
    ]
    for s in spans:
        c = span_component(s)
        if c not in components:
            components.append(c)
    pid_of = {c: i + 1 for i, c in enumerate(components)}

    # Thread lanes: per component, the distinct `lane` attributes (chip /
    # replica / model ids); spans without one share lane 0.
    tid_of: Dict[tuple, int] = {}
    events: List[Dict[str, Any]] = []
    for c in components:
        events.append({
            "ph": "M", "name": "process_name", "pid": pid_of[c], "tid": 0,
            "args": {"name": c},
        })
    by_span_id = {s.span_id: s for s in spans}
    flow_seq = 0
    for s in spans:
        c = span_component(s)
        lane = str(s.attributes.get("lane", ""))
        key = (c, lane)
        if key not in tid_of:
            tid_of[key] = len([k for k in tid_of if k[0] == c])
            events.append({
                "ph": "M", "name": "thread_name",
                "pid": pid_of[c], "tid": tid_of[key],
                "args": {"name": lane or c},
            })
        args: Dict[str, Any] = {
            "trace_id": s.trace_id,
            "span_id": f"{s.span_id:x}",
        }
        if s.parent_id is not None:
            args["parent_id"] = f"{s.parent_id:x}"
        if s.links:
            args["links"] = [
                {"trace_id": l["trace_id"], "span_id": f"{l['span_id']:x}"}
                for l in s.links
            ]
        args.update(s.attributes)
        events.append({
            "ph": "X", "name": s.name,
            "pid": pid_of[c], "tid": tid_of[key],
            "ts": s.start_ms * 1000.0,            # trace-event ts is in us
            "dur": max(0.0, (s.end_ms - s.start_ms) * 1000.0),
            "args": args,
        })
        # Flow arrows for links whose peer is in this capture: start at the
        # linked span, finish at this one (the batch span "collects" its
        # member requests in the viewer).
        for l in s.links:
            peer = by_span_id.get(l.get("span_id"))
            if peer is None or peer.end_ms is None:
                continue
            flow_seq += 1
            pk = (span_component(peer), str(peer.attributes.get("lane", "")))
            events.append({
                "ph": "s", "id": flow_seq, "name": "link", "cat": "link",
                "pid": pid_of[span_component(peer)], "tid": tid_of.get(pk, 0),
                "ts": peer.start_ms * 1000.0,
            })
            events.append({
                "ph": "f", "id": flow_seq, "name": "link", "cat": "link",
                "bp": "e",
                "pid": pid_of[c], "tid": tid_of[key],
                "ts": s.start_ms * 1000.0 + 0.001,
            })
    if journal is not None:
        events.extend(
            journal_to_chrome_events(journal, pid=len(components) + 1)
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class ChromeTraceCollector:
    """In-process exporter: buffer finished spans, write one Chrome trace.

    Usage: ``tracer().set_exporter(collector.export)`` ... ``collector.
    write(path)``. Spans past ``cap`` are dropped — COUNTED in
    ``rdb_trace_dropped_spans_total{sink="collector"}`` and stamped into
    the trace header (``truncated``/``dropped_spans``), never silently.
    """

    def __init__(self, cap: int = 100_000) -> None:
        self._spans: List[Span] = []
        self._cap = cap
        self._dropped = 0
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self._cap:
                self._spans.append(span)
            else:
                self._dropped += 1
                TRACE_DROPPED.inc(tags={"sink": "collector"})

    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            spans, dropped = list(self._spans), self._dropped
        doc = to_chrome_trace(spans)
        # Top-level metadata rides the trace JSON (Perfetto ignores
        # unknown keys): a capped capture says so in its own header.
        doc["metadata"] = {"truncated": dropped > 0,
                           "dropped_spans": dropped}
        return doc

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the span count."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(self.spans)


class FileSpanExporter:
    """Append-one-JSON-object-per-span exporter (JSONL): the durable sink
    for long runs — convert offline with ``tools/dump_trace.py``.

    Writes are buffered (flushed every ``flush_every`` spans and on
    close): export runs inside queue pops and engine hot loops, so a
    per-span fsync-ish flush would serialize producers on disk latency.
    The file is TRUNCATED per exporter instance: span timestamps are
    process-monotonic, so mixing captures from different runs would
    render a garbled timeline.

    The first line is a fixed-width export header
    (``{"_rdb_export": {...}}``), rewritten in place at close with the
    final span/dropped counts and a ``truncated`` flag: spans refused
    past ``max_spans`` (disk-bound runs) are counted there and in
    ``rdb_trace_dropped_spans_total{sink="jsonl"}`` — a capped capture
    announces itself to every downstream reader. Spans arriving AFTER
    close (straggling threads) are counted in the metric and the
    ``dropped`` property only: the on-disk header is final at close and
    cannot reflect them.
    """

    def __init__(self, path: str, flush_every: int = 64,
                 max_spans: int = 1_000_000) -> None:
        self.path = path
        self.flush_every = flush_every
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._f = open(path, "w")
        self._written = 0
        self._dropped = 0
        self._pending = 0
        with self._lock:
            self._f.write(self._header_line())

    def _header_line(self) -> str:
        assert_owner(self._lock)  # counts must not move mid-render
        body = json.dumps({_HEADER_KEY: {
            "truncated": self._dropped > 0,
            "spans": self._written,
            "dropped": self._dropped,
        }})
        if len(body) > _HEADER_WIDTH:  # pragma: no cover - counts are ints
            raise ValueError("export header overflowed its fixed width")
        return body + " " * (_HEADER_WIDTH - len(body)) + "\n"

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def export(self, span: Span) -> None:
        line = json.dumps(span_to_dict(span))
        with self._lock:
            if self._f.closed or self._written >= self.max_spans:
                # Late span from a straggling thread, or cap reached:
                # counted, stamped at close — never silent.
                self._dropped += 1
                TRACE_DROPPED.inc(tags={"sink": "jsonl"})
                return
            self._f.write(line + "\n")
            self._written += 1
            self._pending += 1
            if self._pending >= self.flush_every:
                self._f.flush()
                self._pending = 0

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                # Rewrite the fixed-width header with the final counts.
                self._f.flush()
                self._f.seek(0)
                self._f.write(self._header_line())
                self._f.close()


def read_export_header(path: str) -> Optional[Dict[str, Any]]:
    """The capture's export header ({truncated, spans, dropped}), or
    None for legacy/foreign captures without one."""
    with open(path) as f:
        first = f.readline().strip()
    if not first:
        return None
    try:
        d = json.loads(first)
    except ValueError:
        return None
    return d.get(_HEADER_KEY) if isinstance(d, dict) else None


def read_spans_jsonl(path: str) -> List[Span]:
    out: List[Span] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if _HEADER_KEY in d:
                continue  # export header/trailer, not a span
            out.append(span_from_dict(d))
    return out


def trace_summary(spans: Iterable[Span]) -> Dict[str, Any]:
    """Small human-facing digest: span/trace counts and per-component spans."""
    spans = list(spans)
    comps: Dict[str, int] = {}
    for s in spans:
        comps[span_component(s)] = comps.get(span_component(s), 0) + 1
    return {
        "spans": len(spans),
        "traces": len({s.trace_id for s in spans}),
        "links": sum(len(s.links) for s in spans),
        "components": comps,
    }
