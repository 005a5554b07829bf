"""Workload sources for the simulator — three roads into one arrival list.

An arrival is ``(t_s, model)``: offset seconds from run start. Sources:

1. **synthetic** — the live load generator's own ``RatePattern`` +
   ``arrival_times`` (``engine/workload.py``), which are already pure
   and seeded; the simulator replays exactly the offsets a threaded
   ``WorkloadDriver`` with the same (pattern, seed) would submit at.
2. **recorded** — the JSONL a ``WorkloadDriver(record_path=...)`` (or
   ``tools/run_slo_demo.py``) wrote: ``{"t_s": ..., "model": ...}`` per
   line. Any demo/live run that recorded arrivals is replayable.
3. **flight-recorder spans** — a ``spans.jsonl`` dump: every
   request's ``queue.wait`` span starts at its enqueue, tagged with the
   model, so a trace capture IS an arrival log (offsets re-anchored to
   the earliest span).

``scale_arrivals`` answers "at 2x traffic?": integer part replicates
each arrival (tiny deterministic stagger so copies are distinct
queue entries), fractional part admits by seeded coin-flip.

Own copy of ``ray_dynamic_batching_tpu/sim/workload.py``, whole, with
its import paths rewritten; spans are read with the port's
``utils/trace_export.read_spans_jsonl``.
"""

from __future__ import annotations

import json
import random
from typing import Dict, Iterable, List, Tuple

from ray_dynamic_batching_tpu_torch.engine.request import (
    DEFAULT_QOS_CLASS,
    QOS_RANK,
)
from ray_dynamic_batching_tpu_torch.engine.workload import (
    RatePattern,
    arrival_times,
)

Arrival = Tuple[float, str]  # (offset seconds, model)
# Class-tagged arrival: (offset seconds, model, qos_class). Workload
# plumbing accepts either shape — untagged arrivals serve at the default
# class — so pre-QoS recordings stay replayable.
ClassArrival = Tuple[float, str, str]


def draw_qos(rng: random.Random, class_mix: Dict[str, float]) -> str:
    """One seeded weighted class draw from a mix — THE tagging primitive
    shared by :func:`assign_qos_classes` and the simulator's per-model
    streams (one implementation, no drift). An empty mix is the default
    class; unknown classes and non-positive totals are rejected loudly
    (a silently-mistagged what-if is a confidently wrong one)."""
    if not class_mix:
        return DEFAULT_QOS_CLASS
    unknown = set(class_mix) - set(QOS_RANK)
    if unknown:
        raise ValueError(
            f"unknown qos class(es) in mix: {sorted(unknown)} "
            f"(known: {sorted(QOS_RANK)})"
        )
    classes = sorted(class_mix)  # deterministic draw order
    total = sum(class_mix[c] for c in classes)
    if total <= 0:
        raise ValueError("class_mix fractions must sum > 0")
    x = rng.random() * total
    acc = 0.0
    for c in classes:
        acc += class_mix[c]
        if x < acc:
            return c
    return classes[-1]


def assign_qos_classes(
    arrivals: List[Arrival],
    class_mix: Dict[str, float],
    seed: int = 0,
) -> List[ClassArrival]:
    """Tag each arrival with a QoS class drawn from ``class_mix``
    (fractions, normalized) by seeded draw — same trace + mix + seed =>
    byte-identical tags. An empty mix tags everything default-class."""
    rng = random.Random(seed)
    return [(t, m, draw_qos(rng, class_mix)) for t, m in arrivals]


def synthetic_arrivals(
    model: str,
    pattern: RatePattern,
    duration_s: float,
    poisson: bool = False,
    seed: int = 0,
) -> List[Arrival]:
    return [
        (t, model)
        for t in arrival_times(pattern, duration_s, poisson=poisson,
                               seed=seed)
    ]


def merge_arrivals(streams: Iterable[List]) -> List:
    """One time-ordered list; ties keep stream order (stable sort) so
    the event sequence is canonical. Accepts plain or class-tagged
    arrivals (mixing is fine — the consumer defaults untagged ones)."""
    out: List = []
    for s in streams:
        out.extend(s)
    out.sort(key=lambda a: a[0])
    return out


def load_recorded_arrivals(path: str) -> List[Arrival]:
    """Parse a ``WorkloadDriver(record_path=...)`` JSONL."""
    out: List[Arrival] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.append((float(rec["t_s"]), str(rec["model"])))
    out.sort(key=lambda a: a[0])
    return out


def arrivals_from_spans(path: str) -> List[Arrival]:
    """Reconstruct arrivals from a flight-recorder span JSONL: each
    ``queue.wait`` span starts at the request's enqueue and carries the
    model attribute. Offsets are re-anchored to the earliest such span.

    SURVIVOR BIAS caveat: ``queue.wait`` spans are recorded only for
    requests actually POPPED into a batch — requests the live run
    dropped at enqueue or stale-discarded left no such span, so a dump
    captured during overload under-counts offered load by exactly the
    shed fraction, and what-if conclusions replay optimistic. For
    overload studies prefer a ``WorkloadDriver(record_path=...)``
    recording, which logs every SUBMITTED arrival."""
    raw: List[Arrival] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            span = json.loads(line)
            if span.get("name") != "queue.wait":
                continue
            model = (span.get("attributes") or {}).get("model")
            if model is None:
                continue
            raw.append((float(span["start_ms"]) / 1000.0, str(model)))
    if not raw:
        return []
    t0 = min(t for t, _ in raw)
    out = [(t - t0, m) for t, m in raw]
    out.sort(key=lambda a: a[0])
    return out


def scale_arrivals(
    arrivals: List[Arrival], scale: float, seed: int = 0
) -> List[Arrival]:
    """What-if traffic scaling of a FIXED trace. ``scale=2.0`` doubles
    every arrival (copies staggered 0.1 ms apart so they are distinct
    queue entries at distinct instants); ``scale=1.5`` doubles half of
    them by seeded coin-flip; ``scale=0.5`` thins. Deterministic."""
    if scale == 1.0:
        return list(arrivals)
    if scale <= 0.0:
        return []
    rng = random.Random(seed)
    whole = int(scale)
    frac = scale - whole
    out: List = []
    for arrival in arrivals:
        t, rest = arrival[0], arrival[1:]
        copies = whole + (1 if rng.random() < frac else 0)
        for i in range(copies):
            out.append((t + i * 1e-4, *rest))
    out.sort(key=lambda a: a[0])
    return out
