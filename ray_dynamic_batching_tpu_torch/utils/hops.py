"""Latency budget ledger: per-request hop decomposition of a span tree.

Own copy of ``ray_dynamic_batching_tpu/utils/hops.py``, whole, with its
import paths rewritten: the taxonomy is the reference's, name for name,
since budgets and drift reports speak these hop names.

The flight recorder emits every hop span, but a span dump answers
"what happened" — not "where did THIS request's milliseconds go". This
module turns one request's trace (plus the batch/turn spans that link
into it) into an exhaustive, CONSERVING per-hop ledger:

    sum(hop durations) + unattributed == end-to-end      (asserted)

against a FIXED hop taxonomy, so budgets, drift reports, and regression
gates all speak the same hop names.

Taxonomy & attribution rule
---------------------------
Every span name maps (``SPAN_TO_HOP``) into one of the ordered hops in
``HOP_ORDER`` — front door to decode. The ledger window is the trace's
ROOT span (the request's end-to-end extent). Non-root spans are clipped
to the window and swept: each instant of the window attributes to the
DEEPEST covering hop (max taxonomy rank — a ``router.assign`` inside a
``handle.remote`` is router time, a ``failover`` window swallows the
re-dispatch's inner assign), producing non-overlapping durations that
tile the window exactly. Instants covered by NO non-root span are the
**unattributed residual** — the root span's own un-delegated work (parse,
response serialization) plus every instrumentation gap: page-table
refreshes between decode turns, host work between queue pop and step
dispatch, allocator evictions — precisely the "invisible between a
span's start and end" cost the budget ledger exists to surface. The
residual is explicit and budgetable, never silently dropped.

Linked spans (``batch.form``, ``engine.step``, ``decode.turn``) live in
their OWN traces — dynamic batching fans N requests into one execution,
which parent/child cannot express — and are joined here by following
span links one hop, exactly like ``tools/dump_trace.py --trace-id``.
From the request's wall-clock perspective the whole batch window is time
the request spent in that hop, so the full (clipped) interval counts.

Failover: a re-dispatched request carries a ``failover.redispatch`` span
(submit -> re-assign) that OUTRANKS ``router.assign``, so retry windows
— backoff included — attribute to the ``failover`` hop, never to an
innocent router.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch
from ray_dynamic_batching_tpu_torch.utils.tracing import Span

# The residual's reserved name (a manifest may budget it like any hop).
UNATTRIBUTED = "unattributed"

# Hop -> the span names that feed it. Order IS the attribution rank:
# later (deeper-pipeline) hops win overlaps. "admission" and "failover"
# are the taxonomy's control-plane hops (token-bucket check at the front
# door; deadline-budgeted re-dispatch after a system failure).
HOP_SPANS: Dict[str, Tuple[str, ...]] = {
    "proxy.request": ("proxy.request", "grpc.predict", "grpc.predict_stream"),
    "handle.remote": ("handle.remote", "handle.remote_stream"),
    "admission.check": ("admission.check",),
    "router.assign": ("router.assign",),
    "failover": ("failover.redispatch",),
    "queue.wait": ("queue.wait",),
    "batch.form": ("batch.form",),
    "engine.step": ("engine.step", "engine.request", "replica.batch",
                    "replica.execute", "collate.batch"),
    "decode.prefill": ("decode.prefill",),
    "decode.turn": ("decode.turn",),
}

HOP_ORDER: Tuple[str, ...] = tuple(HOP_SPANS)
HOP_RANK: Dict[str, int] = {h: i for i, h in enumerate(HOP_ORDER)}

SPAN_TO_HOP: Dict[str, str] = {
    name: hop for hop, names in HOP_SPANS.items() for name in names
}

# Root span names that mark a trace as a full request flight record
# (front door or handle): only these yield ledgers whose window IS the
# request's end-to-end latency.
FRONT_DOOR_SPANS = frozenset(
    HOP_SPANS["proxy.request"] + HOP_SPANS["handle.remote"]
)

# Hops that exist only on the dispatch path: a ledger containing none
# of these never reached a queue. Front-door spans wrap EVERYTHING the
# proxy serves — admission 429s, 404 route misses, /metrics scrapes —
# and those sub-ms "requests" must not be graded as request latency
# (during an overload most captures traces would be rejects, diluting
# every percentile toward zero and poisoning a ratchet).
DISPATCH_HOPS = frozenset(
    ("queue.wait", "batch.form", "engine.step",
     "decode.prefill", "decode.turn")
)

# Conservation tolerance: the sweep tiles the window exactly, so any
# disagreement is float summation noise — a millisecond ledger that is
# off by more than a nanosecond-scale epsilon has a real bug.
_EPSILON_MS = 1e-6


class LedgerError(AssertionError):
    """The ledger failed to conserve (sum(hops) + residual != e2e) or
    produced a negative hop — a decomposer bug, surfaced loudly; a
    budget gate built on a leaky ledger proves nothing."""


@dataclass
class HopLedger:
    """One request's conserving latency decomposition."""

    trace_id: str
    root: str                      # root span name (the window's owner)
    start_ms: float
    end_ms: float
    hops: Dict[str, float] = field(default_factory=dict)
    unattributed_ms: float = 0.0
    # The root span's attributes (HTTP code, route, …): the budget gate
    # uses them to grade only SERVED requests — a 429 reject or a
    # /metrics scrape also rides a front-door span, and its sub-ms
    # "latency" would dilute every percentile it sneaks into.
    root_attributes: Dict[str, Any] = field(default_factory=dict)
    # Mapped span time falling OUTSIDE the root window (e.g. decode
    # turns of a stream whose handle span closed at assign time) —
    # informational, excluded from conservation by definition.
    outside_window_ms: float = 0.0

    @property
    def end_to_end_ms(self) -> float:
        return self.end_ms - self.start_ms

    def check(self) -> None:
        """Assert the conservation contract. Never skipped, never
        silently clamped: Sigma(hops) + residual == end-to-end, every
        hop and the residual >= 0."""
        for hop, dur in self.hops.items():
            if dur < 0.0:
                raise LedgerError(
                    f"trace {self.trace_id}: negative hop {hop} = {dur} ms"
                )
        if self.unattributed_ms < -_EPSILON_MS:
            raise LedgerError(
                f"trace {self.trace_id}: negative residual "
                f"{self.unattributed_ms} ms"
            )
        total = sum(self.hops.values()) + self.unattributed_ms
        e2e = self.end_to_end_ms
        tol = _EPSILON_MS * max(1.0, abs(e2e))
        if abs(total - e2e) > tol:
            raise LedgerError(
                f"trace {self.trace_id}: ledger does not conserve — "
                f"sum(hops)+residual = {total} ms vs end-to-end {e2e} ms "
                f"(delta {total - e2e} ms)"
            )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "root": self.root,
            "start_ms": self.start_ms,
            "end_ms": self.end_ms,
            "end_to_end_ms": self.end_to_end_ms,
            "hops": {h: self.hops[h] for h in HOP_ORDER if h in self.hops},
            UNATTRIBUTED: self.unattributed_ms,
            "outside_window_ms": self.outside_window_ms,
        }


def _find_root(spans: Sequence[Span]) -> Optional[Span]:
    """The trace's root: a span whose parent is absent from the capture
    (``parent_id`` None, or pointing at an uncaptured span — an inbound
    ``traceparent`` names the CLIENT's span as parent). Earliest start
    wins among candidates; ties take the longest extent."""
    ids = {s.span_id for s in spans}
    candidates = [
        s for s in spans
        if s.end_ms is not None
        and (s.parent_id is None or s.parent_id not in ids)
    ]
    if not candidates:
        return None
    return min(candidates, key=lambda s: (s.start_ms, -(s.end_ms - s.start_ms)))


def decompose(trace_spans: Sequence[Span],
              linked_spans: Sequence[Span] = (),
              require_front_door: bool = True) -> Optional[HopLedger]:
    """One trace's spans (+ spans from other traces that link into it)
    -> a conserving :class:`HopLedger`, or None when the trace has no
    usable root (``require_front_door=True`` additionally demands a
    front-door/handle root — a singleton ``queue.wait`` trace from an
    untraced load generator is not a request flight record).

    The returned ledger has ALREADY passed :meth:`HopLedger.check` —
    a non-conserving decomposition raises :class:`LedgerError` here,
    it does not return quietly.
    """
    root = _find_root(trace_spans)
    if root is None:
        return None
    if require_front_door and root.name not in FRONT_DOOR_SPANS:
        return None
    w_start, w_end = root.start_ms, root.end_ms
    # (rank, start, end) coverage intervals from every mapped NON-ROOT
    # span, clipped to the window. The root defines the window but does
    # not cover it: time only the root accounts for is the residual.
    intervals: List[Tuple[int, float, float]] = []
    outside = 0.0
    for s in list(trace_spans) + list(linked_spans):
        if s is root or s.end_ms is None:
            continue
        hop = SPAN_TO_HOP.get(s.name)
        if hop is None:
            continue
        start, end = max(s.start_ms, w_start), min(s.end_ms, w_end)
        outside += max(0.0, (s.end_ms - s.start_ms) - max(0.0, end - start))
        if end > start:
            intervals.append((HOP_RANK[hop], start, end))

    hops: Dict[str, float] = {}
    unattributed = 0.0
    # Boundary sweep: between consecutive boundaries the covering set is
    # constant; the deepest-ranked ACTIVE hop wins the slice. Per-rank
    # active counters instead of re-scanning every interval per slice —
    # a 4k-token generation links ~4k decode.turn spans into one trace,
    # and an O(intervals^2) sweep would spend minutes on one ledger.
    events: Dict[float, List[Tuple[int, int]]] = {}
    for rank, s, e in intervals:
        events.setdefault(s, []).append((rank, +1))
        events.setdefault(e, []).append((rank, -1))
    bounds = sorted({w_start, w_end} | set(events))
    active = [0] * len(HOP_ORDER)
    for lo, hi in zip(bounds, bounds[1:]):
        for rank, delta in events.get(lo, ()):
            active[rank] += delta
        if hi <= w_start or lo >= w_end:
            continue
        best = -1
        for rank in range(len(active) - 1, -1, -1):
            if active[rank] > 0:
                best = rank
                break
        if best < 0:
            unattributed += hi - lo
        else:
            hop = HOP_ORDER[best]
            hops[hop] = hops.get(hop, 0.0) + (hi - lo)

    ledger = HopLedger(
        trace_id=root.trace_id,
        root=root.name,
        start_ms=w_start,
        end_ms=w_end,
        hops=hops,
        unattributed_ms=max(0.0, unattributed),
        outside_window_ms=outside,
        root_attributes=dict(root.attributes),
    )
    ledger.check()
    return ledger


def _link_index(spans: Sequence[Span]) -> Dict[int, List[Span]]:
    """linked-target span_id -> the spans that link to it (the batch /
    turn spans fan-in via links; this reverses them in one pass)."""
    idx: Dict[int, List[Span]] = {}
    for s in spans:
        for l in s.links:
            sid = l.get("span_id")
            if sid is not None:
                idx.setdefault(sid, []).append(s)
    return idx


def request_ledgers(
    spans: Sequence[Span],
    require_front_door: bool = True,
) -> Tuple[List[HopLedger], int]:
    """Every request flight record in a capture -> its ledger.

    Returns ``(ledgers, skipped_traces)`` — skipped are traces with no
    qualifying root (load-generator singletons, batch-span traces);
    the count is returned, not swallowed, so a gate can report how much
    of the capture it actually graded.
    """
    by_trace: Dict[str, List[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    links = _link_index(spans)
    ledgers: List[HopLedger] = []
    skipped = 0
    for trace_id, mine in by_trace.items():
        linked: List[Span] = []
        seen = set()
        for s in mine:
            for peer in links.get(s.span_id, ()):
                if peer.trace_id != trace_id and peer.span_id not in seen:
                    seen.add(peer.span_id)
                    linked.append(peer)
        ledger = decompose(mine, linked,
                           require_front_door=require_front_door)
        if ledger is None:
            skipped += 1
        else:
            ledgers.append(ledger)
    ledgers.sort(key=lambda l: (l.start_ms, l.trace_id))
    return ledgers, skipped


def is_served(ledger: "HopLedger") -> bool:
    """True when the ledger describes a DISPATCHED request — the only
    kind whose latency a TTFT budget grades. Excludes error/reject
    roots (HTTP ``code`` attribute outside 2xx) and ledgers that never
    touched a dispatch hop (admission rejects, 404s, metrics scrapes —
    all of which ride front-door spans too)."""
    code = str(ledger.root_attributes.get("code", "") or "")
    if code and not code.startswith("2"):
        return False
    return any(h in ledger.hops for h in DISPATCH_HOPS)


def hop_sketches(
    ledgers: Iterable[HopLedger],
    relative_accuracy: float = 0.01,
) -> Dict[str, QuantileSketch]:
    """Per-hop mergeable quantile sketches over a set of ledgers (the
    residual included under :data:`UNATTRIBUTED`, end-to-end under
    ``end_to_end`` — both budgetable)."""
    out: Dict[str, QuantileSketch] = {}

    def _observe(name: str, value: float) -> None:
        sk = out.get(name)
        if sk is None:
            sk = out[name] = QuantileSketch(
                relative_accuracy=relative_accuracy
            )
        sk.observe(max(0.0, value))

    for ledger in ledgers:
        for hop, dur in ledger.hops.items():
            _observe(hop, dur)
        _observe(UNATTRIBUTED, ledger.unattributed_ms)
        _observe("end_to_end", ledger.end_to_end_ms)
    return out


def format_ledger_table(ledgers: Sequence[HopLedger]) -> str:
    """Terminal table: one row per request, one column per hop present
    in the set (plus residual and end-to-end) — ``tools/dump_trace.py
    --hops``."""
    present = [h for h in HOP_ORDER if any(h in l.hops for l in ledgers)]
    cols = present + [UNATTRIBUTED, "e2e_ms"]
    head = f"{'trace':<14} {'root':<20}" + "".join(
        f" {c:>14}" for c in cols
    )
    lines = [head, "-" * len(head)]
    for l in ledgers:
        row = f"{l.trace_id[:12]:<14} {l.root:<20}"
        for h in present:
            row += f" {l.hops.get(h, 0.0):>14.2f}"
        row += f" {l.unattributed_ms:>14.2f} {l.end_to_end_ms:>14.2f}"
        lines.append(row)
    return "\n".join(lines)
