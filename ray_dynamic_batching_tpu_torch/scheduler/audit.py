"""Scheduler decision audit log — a bounded structured ring of replans.

Own copy of ``ray_dynamic_batching_tpu/scheduler/audit.py``, whole, with
its import paths rewritten.

The reference logs schedule changes as free-text lines (``293-project/src/
scheduler.py:46-86``); operators debugging a live rebalance need structure:
WHAT triggered the decision (rate delta, health event, quarantine), what the
scheduler SAW (observed rates, profile rows consulted), what CHANGED
(old -> new plan diff), and what the move COST (compile + weight-upload
weighted transfer cost / engines moved). Every control plane writes
:class:`AuditRecord` entries into one of these rings; ``snapshot()`` /
``ServeController.status()`` / the dashboard's audit panel read them back.

The ring is bounded (default 256) so a chatty monitor can never grow the
control plane's memory; it is the in-process analogue of the reference's
metrics.json history, but queryable and diff-shaped.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class AuditRecord:
    """One control-plane decision, diff-shaped."""

    seq: int                    # monotonically increasing per ring
    wall_time: float            # time.time() at the decision
    domain: str                 # "nexus" | "llm" | "serve" | "frontdoor"
    trigger: str                # "manual" | "rate_change" | "quarantine" |
                                # "heal" | "rolling_update" | "scale" |
                                # "store_fenced" | "failover_adopt" |
                                # "admission_drift" | ...
    key: str = ""               # deployment/model the decision is about
                                # ("" = domain-wide, e.g. a full replan)
    observed: Dict[str, Any] = field(default_factory=dict)   # inputs seen
    inputs: Dict[str, Any] = field(default_factory=dict)     # rows consulted
    before: Any = None          # old plan / state (JSON-safe)
    after: Any = None           # new plan / state (JSON-safe)
    diff: Dict[str, Any] = field(default_factory=dict)       # old -> new
    migration_cost: float = 0.0
    note: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "wall_time": self.wall_time,
            "domain": self.domain,
            "trigger": self.trigger,
            "key": self.key,
            "observed": self.observed,
            "inputs": self.inputs,
            "before": self.before,
            "after": self.after,
            "diff": self.diff,
            "migration_cost": self.migration_cost,
            "note": self.note,
        }


class AuditLog:
    """Thread-safe bounded ring of :class:`AuditRecord`.

    ``now`` injects the decision timestamp source (default wall clock):
    the what-if simulator (``sim/``) passes its virtual clock so replayed
    replans carry VIRTUAL timestamps and the dashboard timeline renders a
    simulated run identically to a live one. Live callers are unchanged.
    """

    def __init__(self, domain: str, capacity: int = 256,
                 now=time.time) -> None:
        self.domain = domain
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._now = now

    def record(self, trigger: str, **fields: Any) -> AuditRecord:
        rec = AuditRecord(
            seq=next(self._seq),
            wall_time=self._now(),
            domain=self.domain,
            trigger=trigger,
            **fields,
        )
        with self._lock:
            self._ring.append(rec)
        return rec

    def records(
        self, key: Optional[str] = None, last: Optional[int] = None
    ) -> List[AuditRecord]:
        with self._lock:
            out = list(self._ring)
        if key is not None:
            out = [r for r in out if r.key == key or r.key == ""]
        if last is not None:
            out = out[-last:]
        return out

    def to_dicts(
        self, key: Optional[str] = None, last: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.records(key=key, last=last)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def plan_diff(
    before: List[Optional[List[str]]], after: List[Optional[List[str]]]
) -> Dict[str, Any]:
    """Old -> new placement diff over per-engine model lists: which engines
    changed, which models joined/left the serving set."""
    n = max(len(before), len(after))
    before = list(before) + [None] * (n - len(before))
    after = list(after) + [None] * (n - len(after))
    changed = {}
    for i, (b, a) in enumerate(zip(before, after)):
        b, a = sorted(b or []), sorted(a or [])
        if b != a:
            changed[str(i)] = {"old": b, "new": a}
    all_before = {m for b in before for m in (b or [])}
    all_after = {m for a in after for m in (a or [])}
    return {
        "engines_changed": changed,
        "models_added": sorted(all_after - all_before),
        "models_removed": sorted(all_before - all_after),
    }
