"""Simulation reports — deterministic JSON + the A/B comparison.

Own copy of ``ray_dynamic_batching_tpu/sim/report.py``, whole, with its
import paths rewritten.

The report is the simulator's product: per-model SLO attainment (shed
load counts as missed, same formula as ``tools/run_slo_demo.py``'s
per-phase grading), latency percentiles, per-chip measured occupancy,
drop/stale counts, migration count, and the full audit trail (virtual
timestamps). ``render_json`` is byte-deterministic — sorted keys, floats
rounded at fixed precision — so same-seed runs are ``diff``-clean and CI
can ratchet on exact output.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional


def slo_attainment(counters: Dict[str, float]) -> float:
    """Fraction of accounted requests that met their SLO, counting shed
    load (stale discards + drops) as misses — a dropped request missed
    its SLO as surely as a late completion (run_slo_demo's rule)."""
    accounted = (counters.get("completed", 0.0)
                 + counters.get("stale", 0.0)
                 + counters.get("dropped", 0.0))
    misses = (counters.get("violations", 0.0)
              + counters.get("stale", 0.0)
              + counters.get("dropped", 0.0))
    return 1.0 - misses / accounted if accounted else 1.0


def shed_by_class(model_report: Dict[str, Any]) -> Dict[str, float]:
    """Per-class shed volume (queue sheds: stale + dropped) from one
    model's report entry. Rejected-at-admission is deliberately NOT shed
    — it is its own accounting category (offered = admission_rejected +
    enqueued; enqueued = completed + shed + pending)."""
    out: Dict[str, float] = {}
    for cls, c in (model_report.get("classes") or {}).items():
        out[cls] = float(c.get("stale", 0)) + float(c.get("dropped", 0))
    return out


def shed_fraction(model_report: Dict[str, Any], qos_class: str) -> float:
    """Fraction of the model's total shed volume carried by ``qos_class``
    (1.0 when nothing shed — an empty shed trivially satisfies any
    "class X absorbs the shed" floor)."""
    sheds = shed_by_class(model_report)
    total = sum(sheds.values())
    if total <= 0:
        return 1.0
    return sheds.get(qos_class, 0.0) / total


def merged_hop_sketches(queues) -> Dict[str, Any]:
    """One mergeable sketch per hop across every model's sim queue
    (sketch merge is exact — this is the aggregation the live side's
    ``utils.hops.hop_sketches`` produces, so drift compares align)."""
    from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch

    groups: Dict[str, list] = {}
    for q in queues.queues().values():
        for hop, sk in q.hop_sketches.items():
            groups.setdefault(hop, []).append(sk)
    return {hop: QuantileSketch.merged(sks) for hop, sks in groups.items()}


def hop_drift_report(
    live: Dict[str, Any],
    sim: Dict[str, Any],
    tolerance: float = 0.5,
    quantiles=(0.5, 0.95),
    min_count: int = 5,
) -> Dict[str, Any]:
    """Name the hops where the simulator's cost model diverges from a
    live trace beyond ``tolerance`` (relative, per quantile).

    ``live``/``sim`` map hop -> QuantileSketch (or anything exposing
    ``quantile``/``count``). Only hops observed on BOTH sides with at
    least ``min_count`` samples are graded — a hop the sim cannot
    express (proxy/handle/router) is listed under ``ungraded``, never
    silently skipped. A parity pin says "the sim agrees in
    aggregate"; this says WHICH hop's pricing drifted when it stops
    agreeing."""
    graded: Dict[str, Any] = {}
    drifting = []
    ungraded = {}
    for hop in sorted(set(live) | set(sim)):
        a, b = live.get(hop), sim.get(hop)
        if a is None or b is None or min(a.count, b.count) < min_count:
            ungraded[hop] = {
                "live_count": 0 if a is None else a.count,
                "sim_count": 0 if b is None else b.count,
            }
            continue
        entry: Dict[str, Any] = {"live_count": a.count, "sim_count": b.count}
        worst = 0.0
        for q in quantiles:
            lv, sv = a.quantile(q), b.quantile(q)
            denom = max(abs(lv), 1e-9)
            drift = abs(sv - lv) / denom
            entry[f"p{round(q * 100):d}"] = {
                "live_ms": lv, "sim_ms": sv, "drift": drift,
            }
            worst = max(worst, drift)
        entry["worst_drift"] = worst
        entry["ok"] = worst <= tolerance
        if not entry["ok"]:
            drifting.append(hop)
        graded[hop] = entry
    return {
        "metric": "hop_drift",
        "tolerance": tolerance,
        "hops": graded,
        "ungraded": ungraded,
        "drifting_hops": drifting,
        "ok": not drifting,
    }


def gray_timeline(report: Dict[str, Any]) -> Dict[str, list]:
    """Per-replica gray_state timeline from one report: engine id ->
    ordered ``[{at, from, to, p50_ms, p95_ms}, ...]``. Empty when the
    scenario ran without gray detection. The straggler soak reads this
    to grade detection latency (degradation onset -> first probation
    entry) and the reclaim edge (heal -> back to healthy)."""
    gray = report.get("gray") or {}
    out: Dict[str, list] = {}
    for t in gray.get("timeline", []):
        out.setdefault(t["replica"], []).append(
            {k: t[k] for k in ("at", "from", "to", "p50_ms", "p95_ms")
             if k in t}
        )
    return out


def format_gray_timeline(report: Dict[str, Any]) -> str:
    """Terminal block for the per-replica gray_state timeline."""
    timeline = gray_timeline(report)
    if not timeline:
        return "gray: detection disabled or no transitions"
    lines = [f"{'replica':<10} {'t(s)':>8}  transition"]
    for rid in sorted(timeline):
        for t in timeline[rid]:
            lines.append(
                f"{rid:<10} {t['at']:>8.2f}  {t['from']} -> {t['to']}"
            )
    final = (report.get("gray") or {}).get("final_states", {})
    if final:
        lines.append("final: " + ", ".join(
            f"{rid}={st}" for rid, st in sorted(final.items())
        ))
    return "\n".join(lines)


def alert_timeline(report: Dict[str, Any]) -> Dict[str, list]:
    """Per-(deployment/qos) burn-alert timeline from one report:
    ``"model/qos" -> ordered [{at, from, to, fast_burn, slow_burn},
    ...]``. Empty when the scenario ran without the observatory. The
    observatory soak reads this to pin the overload arm's transition
    sequence (``ok -> warning -> page -> resolved``) — the alert
    analogue of :func:`gray_timeline`."""
    obs = report.get("observatory") or {}
    alerts = obs.get("alerts") or {}
    out: Dict[str, list] = {}
    for t in alerts.get("timeline", []):
        out.setdefault(f"{t['key']}/{t['qos']}", []).append(
            {k: t[k] for k in ("at", "from", "to", "fast_burn",
                               "slow_burn") if k in t}
        )
    return out


def format_alert_timeline(report: Dict[str, Any]) -> str:
    """Terminal block for the burn-alert timeline."""
    timeline = alert_timeline(report)
    if not timeline:
        return "alerts: observatory disabled or no transitions"
    lines = [f"{'deployment/qos':<20} {'t(s)':>8}  transition"]
    for key in sorted(timeline):
        for t in timeline[key]:
            lines.append(
                f"{key:<20} {t['at']:>8.2f}  {t['from']} -> {t['to']}"
                f"  (fast={t.get('fast_burn')} slow={t.get('slow_burn')})"
            )
    final = ((report.get("observatory") or {}).get("alerts") or {}).get(
        "final_states", {}
    )
    if final:
        lines.append("final: " + ", ".join(
            f"{key}/{qos}={st}"
            for key, per_qos in sorted(final.items())
            for qos, st in sorted(per_qos.items())
        ))
    return "\n".join(lines)


def format_partition_story(report: Dict[str, Any]) -> str:
    """Terminal block for one partition-sim arm (sim/frontdoor.
    run_partition_sim): the leadership story, the replay cost, the
    over-admission vs its fail-closed bound, and per-shard ledger
    degradation — the human-readable face of what the soak gate pins."""
    st = report.get("store", {})
    lines = [
        f"partition[{report.get('scenario', {}).get('name', '?')}] "
        f"leader={st.get('leader')} epoch={st.get('epoch')} "
        f"self_demotions={st.get('self_demotions')} "
        f"split_brain_commits={st.get('split_brain_commits')} "
        f"fence_rejections={st.get('rejected_appends')}",
        f"  log: appended_total={st.get('appended_total')} "
        f"tail={st.get('log_tail_records')} "
        f"max_tail_replayed={st.get('max_tail_replayed')} "
        f"snapshots={st.get('snapshots_taken')}",
        f"  budget: max_over_admitted={report.get('max_over_admitted')} "
        f"bound={report.get('degrade_bound')} "
        f"reconverged={report.get('reconverged')}",
    ]
    for fo in st.get("failovers", []):
        lines.append(
            f"  failover @{fo['at_s']}s -> {fo['owner']} "
            f"epoch {fo['epoch']} (snapshot_index={fo['snapshot_index']}, "
            f"tail_replayed={fo['tail_replayed']})"
        )
    for sid, lg in sorted((report.get("ledgers") or {}).items()):
        if lg.get("degraded_entries"):
            lines.append(
                f"  ledger {sid}: degraded {lg['degraded_entries']}x, "
                f"merged={lg['merged']} stale_at_end={lg['stale_at_end']}"
            )
    return "\n".join(lines)


def _round(value: Any, nd: int = 4) -> Any:
    if isinstance(value, float):
        return round(value, nd)
    if isinstance(value, dict):
        return {k: _round(v, nd) for k, v in value.items()}
    if isinstance(value, list):
        return [_round(v, nd) for v in value]
    return value


def render_json(report: Dict[str, Any]) -> str:
    """Canonical bytes: sorted keys, fixed float precision, newline-
    terminated. Two same-seed runs must produce IDENTICAL output."""
    return json.dumps(_round(report), sort_keys=True, indent=2) + "\n"


def compare_reports(a: Dict[str, Any], b: Dict[str, Any],
                    label_a: str = "A", label_b: str = "B") -> Dict[str, Any]:
    """The A/B harness: per-model attainment/p99 deltas, chip usage,
    migrations — the decision surface for "can we drop a chip?" /
    "would plan B hold the SLOs?"."""
    models = sorted(set(a.get("models", {})) | set(b.get("models", {})))
    per_model = {}
    for m in models:
        am = a.get("models", {}).get(m, {})
        bm = b.get("models", {}).get(m, {})
        per_model[m] = {
            "slo_attainment": {
                label_a: am.get("slo_attainment"),
                label_b: bm.get("slo_attainment"),
                "delta": (
                    None
                    if m not in a.get("models", {})
                    or m not in b.get("models", {})
                    else round(bm["slo_attainment"] - am["slo_attainment"], 4)
                ),
            },
            "latency_p99_ms": {
                label_a: am.get("latency_p99_ms"),
                label_b: bm.get("latency_p99_ms"),
            },
            "shed": {
                label_a: (am.get("dropped", 0) + am.get("stale", 0)),
                label_b: (bm.get("dropped", 0) + bm.get("stale", 0)),
            },
        }
    worst_a = min(
        (m.get("slo_attainment", 1.0) for m in a.get("models", {}).values()),
        default=1.0,
    )
    worst_b = min(
        (m.get("slo_attainment", 1.0) for m in b.get("models", {}).values()),
        default=1.0,
    )
    return {
        "labels": [label_a, label_b],
        "models": per_model,
        "chips_used": {label_a: a.get("chips_used"),
                       label_b: b.get("chips_used")},
        "schedule_changes": {label_a: a.get("schedule_changes"),
                             label_b: b.get("schedule_changes")},
        "worst_slo_attainment": {label_a: round(worst_a, 4),
                                 label_b: round(worst_b, 4)},
        "winner": (label_a if worst_a > worst_b
                   else label_b if worst_b > worst_a else "tie"),
    }


def format_compare(diff: Dict[str, Any]) -> str:
    """Terminal table for the A/B diff."""
    la, lb = diff["labels"]
    lines = [
        f"{'model':<20} {'attain ' + la:>12} {'attain ' + lb:>12} "
        f"{'delta':>8} {'p99 ' + la:>10} {'p99 ' + lb:>10}",
    ]
    for m, row in sorted(diff["models"].items()):
        att = row["slo_attainment"]
        p99 = row["latency_p99_ms"]

        def fmt(v: Optional[float], nd: int = 4) -> str:
            return "-" if v is None else f"{v:.{nd}f}"

        lines.append(
            f"{m:<20} {fmt(att[la]):>12} {fmt(att[lb]):>12} "
            f"{fmt(att['delta']):>8} {fmt(p99[la], 1):>10} "
            f"{fmt(p99[lb], 1):>10}"
        )
    lines.append(
        f"chips: {la}={diff['chips_used'][la]} {lb}={diff['chips_used'][lb]}"
        f"  schedule_changes: {la}={diff['schedule_changes'][la]} "
        f"{lb}={diff['schedule_changes'][lb]}  worst attainment: "
        f"{la}={diff['worst_slo_attainment'][la]:.4f} "
        f"{lb}={diff['worst_slo_attainment'][lb]:.4f}"
        f"  winner: {diff['winner']}"
    )
    return "\n".join(lines)
