"""SLO observatory — burn-rate alerting, forecast scoring, fidelity drift.

Own copy of ``ray_dynamic_batching_tpu/serve/observatory.py``, with its
import paths rewritten, whole: the fidelity replay
(:class:`FidelityMonitor`) grades with the port's own
``sim/report.hop_drift_report``.

Every prior control-plane defense here trusts a model of the system:
the planner trusts the profile tables, the rate-change trigger trusts
the sliding-window estimate, CI trusts that the sim's hop pricing still
matches live. This module is the layer that MEASURES that trust,
continuously, from inside the control loop — so ROADMAP item 2's
predictive planner lands on instrumented ground instead of hope. Three
instruments share one audited surface:

- **Burn-rate alerting** (:class:`BurnRateMonitor`): per-(deployment,
  qos_class) SLO error budgets consumed from the EXISTING attainment /
  shed counters (``class_stats()`` — misses = violations + stale +
  dropped, the ``sim/report.slo_attainment`` formula), graded over two
  burn windows (fast ~5 m / slow ~1 h) built as rotated cumulative-
  counter epochs — the RollingSketch discipline applied to counters.
  ``burn = miss_fraction_over_window / (1 - slo_target)``: 1.0 means
  the budget spends exactly at the sustainable rate; paging requires
  BOTH windows above ``page_burn`` (the multi-window rule — a fast
  spike alone is noise, a slow burn alone is history). Verdicts drive
  a flap-proof hysteresis machine ``ok -> warning -> page -> resolved``
  (GrayHealthMonitor's streak discipline; a window with too little
  traffic is UNGRADED and holds state — never paged, and never resolved,
  by absence of data).
- **Forecast scoring** (:class:`ForecastScorer`): each tick it asks
  ``RateRegistry`` for a short-horizon arrival forecast per model
  (``RateTracker.forecast_rps`` — EWMA level+trend over the integer-
  second buckets; refuses below ``min_span_s``, the cold-window rule),
  holds the prediction, and when the horizon elapses grades it against
  what ACTUALLY arrived. Errors land in per-model quantile sketches
  (``rdb_forecast_error``) so a planner can gate on "forecast p95
  error < X" instead of trusting an untested predictor. Refusals and
  expired windows are COUNTED, never silent.
- **Fidelity drift** (:class:`FidelityMonitor`): a bounded in-process
  ring of recent real arrivals; every ``replay_every_ticks`` ticks it
  replays them through the installed cost model (``price(model) ->
  {hop: expected_ms}`` — the sim prices from the planner's profile
  rows) into predicted per-hop sketches and grades them against the
  LIVE hop sketches with the existing ``sim/report.hop_drift_report``
  machinery. A drifting hop is NAMED in a ``fidelity_drift`` audit
  record; a hop the cost model cannot price, or with sub-floor
  latencies, or without live samples, is listed ``ungraded`` with its
  reason — never silently skipped.

The whole module is the shared-component pattern: the SAME
:class:`SLOObservatory` instance shape is ticked by
``ServeController._control_step`` (wall clock) and ``SimScheduler``
(virtual clock) — everything clock-injected, no wall-clock reads, no
unseeded randomness (the ``sim-determinism`` lint walks this file).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.engine.rates import RateRegistry
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

logger = get_logger("observatory")

ALERT_STATES = ("ok", "warning", "page", "resolved")

SLO_BURN_RATE = m.Gauge(
    "rdb_slo_burn_rate",
    "SLO error-budget burn rate per (deployment, qos, window); 1.0 = "
    "spending the budget exactly at the sustainable rate",
    tag_keys=("deployment", "qos", "window"),
    bounded_tags={"deployment": 8, "qos": 8},
)
SLO_ALERT_STATE = m.Gauge(
    "rdb_slo_alert_state",
    "Burn-rate alert state per (deployment, qos): "
    "0=ok 1=warning 2=page 3=resolved",
    tag_keys=("deployment", "qos"),
    bounded_tags={"deployment": 8, "qos": 8},
)
FORECAST_ERROR = m.Sketch(
    "rdb_forecast_error",
    "Absolute arrival-forecast error (rps) per model, scored when each "
    "prediction's horizon elapses",
    tag_keys=("model",),
    bounded_tags={"model": 8},
)
FIDELITY_DRIFT = m.Gauge(
    "rdb_fidelity_drift",
    "Worst relative drift between the cost model's predicted and the "
    "live per-hop latency sketches, per (hop, model)",
    tag_keys=("hop", "model"),
    bounded_tags={"model": 8},
)


@dataclass(frozen=True)
class ObservatoryPolicy:
    """Knobs for all three instruments. Window lengths are SECONDS of
    the injected clock, so a sim scenario shrinks them onto its virtual
    horizon while live deployments keep the SRE-classic 5 m / 1 h pair.

    The page rule is deliberately two-window (fast AND slow above
    ``page_burn``): the slow window stops a single boundary-straddling
    burst from paging, the fast window stops a long-resolved incident
    from paging forever. ``min_accounted`` is the grading floor — burn
    over three requests is noise, and an UNGRADED tick holds state
    exactly like a gray-health tick without samples."""

    slo_target: float = 0.99        # budget = 1 - slo_target
    fast_window_s: float = 300.0    # ~5 m
    slow_window_s: float = 3600.0   # ~1 h
    epochs_per_window: int = 6      # rotated counter epochs per window
    warn_burn: float = 2.0          # fast burn >= this -> warn-level
    page_burn: float = 10.0         # fast AND slow >= this -> page-level
    min_accounted: int = 10         # window delta needed to grade at all
    warn_after: int = 1             # consecutive warn ticks ok -> warning
    page_after: int = 2             # consecutive page ticks -> page
    resolve_after: int = 2          # consecutive clear ticks -> resolved/ok
    resolved_hold_ticks: int = 2    # quiet resolved ticks -> back to ok
    # --- forecast scoring -------------------------------------------------
    forecast_horizon_s: float = 5.0
    forecast_alpha: float = 0.5
    forecast_beta: float = 0.2
    forecast_min_span_s: float = 3.0  # refuse (not extrapolate) below this
    # --- fidelity drift ---------------------------------------------------
    replay_every_ticks: int = 4
    drift_tolerance: float = 0.5
    drift_min_count: int = 5
    drift_min_abs_ms: float = 1.0   # both sides sub-floor -> ungraded
    arrival_ring: int = 4096


def budget_counters(counters: Dict[str, float]) -> Tuple[float, float]:
    """(misses, accounted) from one cumulative ``class_stats()`` slice —
    the ``sim/report.slo_attainment`` accounting, shared verbatim so the
    burn a live tick grades equals the attainment the report prints."""
    accounted = (counters.get("completed", 0.0)
                 + counters.get("stale", 0.0)
                 + counters.get("dropped", 0.0))
    misses = (counters.get("violations", 0.0)
              + counters.get("stale", 0.0)
              + counters.get("dropped", 0.0))
    return misses, accounted


class BurnWindow:
    """One burn horizon as rotated epochs of CUMULATIVE counter
    snapshots. An epoch closes every ``window_s / epochs`` seconds; the
    window's burn is the delta against the oldest retained snapshot, so
    an incident ages out exactly one epoch at a time and is fully gone
    once the whole window has rotated past it — no decay math, no
    resettable counters, same recency discipline as RollingSketch."""

    def __init__(self, window_s: float, epochs: int, clock) -> None:
        self.window_s = float(window_s)
        self.epoch_s = float(window_s) / max(1, int(epochs))
        self._clock = clock
        # (closed_at_s, misses, accounted); maxlen keeps the oldest
        # baseline ~window_s old.
        self._snaps: deque = deque(maxlen=max(1, int(epochs)) + 1)

    def observe(self, misses: float, accounted: float) -> None:
        now = self._clock()
        if not self._snaps or now - self._snaps[-1][0] >= self.epoch_s:
            self._snaps.append((now, misses, accounted))

    def burn(self, misses: float, accounted: float, budget: float,
             min_accounted: int) -> Optional[float]:
        """Burn rate over the window, or None when the window's delta
        carries too little traffic to grade (never guilty — or clear —
        by absence of data)."""
        if not self._snaps:
            return None
        _, m0, a0 = self._snaps[0]
        d_acc = accounted - a0
        if d_acc < min_accounted:
            return None
        d_miss = max(0.0, misses - m0)
        return (d_miss / d_acc) / max(budget, 1e-9)


@dataclass
class _AlertState:
    fast: BurnWindow
    slow: BurnWindow
    state: str = "ok"
    warn_streak: int = 0
    page_streak: int = 0
    clear_streak: int = 0
    quiet_ticks: int = 0
    since: float = 0.0
    fast_burn: Optional[float] = None
    slow_burn: Optional[float] = None


class BurnRateMonitor:
    """Per-(key, qos_class) burn-rate alert machine over cumulative
    ``class_stats()`` counters. Thread-safe; the injected ``clock``
    keeps the sim deterministic while live callers default to
    ``time.monotonic``."""

    def __init__(self, scope: str, policy: ObservatoryPolicy,
                 clock=time.monotonic) -> None:
        self.scope = scope
        self.policy = policy
        self._clock = clock
        self._lock = OrderedLock("observatory")
        self._states: Dict[Tuple[str, str], _AlertState] = {}
        self.audit = None
        # Bounded ring (GrayHealthMonitor's cap): a flapping deployment
        # must not grow a long-lived monitor without limit.
        self.transitions: deque = deque(maxlen=4096)

    def _st(self, key: Tuple[str, str]) -> _AlertState:
        st = self._states.get(key)
        if st is None:
            p = self.policy
            st = self._states[key] = _AlertState(
                fast=BurnWindow(p.fast_window_s, p.epochs_per_window,
                                self._clock),
                slow=BurnWindow(p.slow_window_s, p.epochs_per_window,
                                self._clock),
                since=self._clock(),
            )
        return st

    def tick(
        self, class_counters: Dict[str, Dict[str, Dict[str, float]]]
    ) -> List[Dict[str, Any]]:
        """Advance every (key, qos) machine one tick from cumulative
        counters (key -> qos -> class_stats slice). Returns the
        transitions this tick caused (also ringed and audited)."""
        p = self.policy
        budget = max(1e-9, 1.0 - p.slo_target)
        fired: List[Dict[str, Any]] = []
        with self._lock:
            for key, per_qos in sorted(class_counters.items()):
                for qos, counters in sorted(per_qos.items()):
                    misses, accounted = budget_counters(counters)
                    st = self._st((key, qos))
                    st.fast.observe(misses, accounted)
                    st.slow.observe(misses, accounted)
                    fast = st.fast.burn(misses, accounted, budget,
                                        p.min_accounted)
                    slow = st.slow.burn(misses, accounted, budget,
                                        p.min_accounted)
                    st.fast_burn, st.slow_burn = fast, slow
                    SLO_BURN_RATE.set(
                        0.0 if fast is None else fast,
                        tags={"deployment": key, "qos": qos,
                              "window": "fast"},
                    )
                    SLO_BURN_RATE.set(
                        0.0 if slow is None else slow,
                        tags={"deployment": key, "qos": qos,
                              "window": "slow"},
                    )
                    if fast is None:
                        # Ungraded tick: hold state, hold streaks.
                        continue
                    page_level = (fast >= p.page_burn
                                  and slow is not None
                                  and slow >= p.page_burn)
                    warn_level = fast >= p.warn_burn
                    if page_level:
                        st.page_streak += 1
                    else:
                        st.page_streak = 0
                    if warn_level:
                        st.warn_streak += 1
                        st.clear_streak = 0
                        st.quiet_ticks = 0
                    else:
                        st.clear_streak += 1
                        st.warn_streak = 0
                        st.quiet_ticks += 1
                    new_state = self._next_state_locked(st)
                    if new_state is not None:
                        fired.append(self._transition_locked(
                            key, qos, st, new_state
                        ))
                    SLO_ALERT_STATE.set(
                        float(ALERT_STATES.index(st.state)),
                        tags={"deployment": key, "qos": qos},
                    )
        for t in fired:
            self._publish(t)
        return fired

    def _next_state_locked(self, st: _AlertState) -> Optional[str]:
        p = self.policy
        if st.state == "ok":
            if st.warn_streak >= p.warn_after:
                return "warning"
        elif st.state == "warning":
            if st.page_streak >= p.page_after:
                return "page"
            if st.clear_streak >= p.resolve_after:
                return "ok"
        elif st.state == "page":
            if st.clear_streak >= p.resolve_after:
                return "resolved"
        elif st.state == "resolved":
            if st.warn_streak >= p.warn_after:
                return "warning"
            if st.quiet_ticks >= p.resolved_hold_ticks:
                return "ok"
        return None

    def _transition_locked(
        self, key: str, qos: str, st: _AlertState, new_state: str
    ) -> Dict[str, Any]:
        record = {
            "at": self._clock(),
            "key": key,
            "qos": qos,
            "from": st.state,
            "to": new_state,
            "fast_burn": (None if st.fast_burn is None
                          else round(st.fast_burn, 3)),
            "slow_burn": (None if st.slow_burn is None
                          else round(st.slow_burn, 3)),
        }
        st.state = new_state
        st.warn_streak = 0
        st.page_streak = 0
        st.clear_streak = 0
        st.quiet_ticks = 0
        st.since = record["at"]
        self.transitions.append(record)
        return record

    def _publish(self, t: Dict[str, Any]) -> None:
        log = logger.warning if t["to"] in ("warning", "page") \
            else logger.info
        log(
            "%s: %s/%s slo-burn %s -> %s (fast=%s slow=%s)",
            self.scope, t["key"], t["qos"], t["from"], t["to"],
            t["fast_burn"], t["slow_burn"],
        )
        if self.audit is not None:
            self.audit.record(
                f"slo_{t['to']}",
                key=t["key"],
                observed={"qos": t["qos"], "fast_burn": t["fast_burn"],
                          "slow_burn": t["slow_burn"]},
                before={"state": t["from"]},
                after={"state": t["to"]},
                diff={"alert": f"{t['from']}->{t['to']}"},
            )
        # Flight record: a zero-length marker span so dump_trace
        # --alerts renders the alert timeline next to the hop ledger
        # (no-op unless an exporter is installed — sim runs stay pure).
        tracer().record_span(
            "observatory.alert", component="observatory",
            deployment=t["key"], qos=t["qos"],
            alert_from=t["from"], alert_to=t["to"],
            fast_burn=t["fast_burn"], slow_burn=t["slow_burn"],
            at_s=t["at"],
        )

    def states(self) -> Dict[str, Dict[str, str]]:
        with self._lock:
            out: Dict[str, Dict[str, str]] = {}
            for (key, qos), st in self._states.items():
                out.setdefault(key, {})[qos] = st.state
            return out

    def snapshot(self, key: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            states = {
                f"{k}/{qos}": {
                    "state": st.state,
                    "fast_burn": st.fast_burn,
                    "slow_burn": st.slow_burn,
                    "since": st.since,
                }
                for (k, qos), st in sorted(self._states.items())
                if key is None or k == key
            }
            transitions = [t for t in self.transitions
                           if key is None or t["key"] == key]
            return {"states": states, "transitions": transitions[-20:]}


class ForecastScorer:
    """Holds each model's outstanding arrival forecast and grades it
    when the horizon elapses. Refusals (cold window) and expirations
    (the rate window rotated past the prediction's span before a tick
    could score it) are counted, never silent."""

    def __init__(self, policy: ObservatoryPolicy,
                 clock=time.monotonic) -> None:
        self.policy = policy
        self._clock = clock
        self._lock = OrderedLock("observatory")
        # model -> (made_at_s, predicted_rps)
        self._pending: Dict[str, Tuple[float, float]] = {}
        self._sketches: Dict[str, QuantileSketch] = {}
        self._scored: Dict[str, int] = {}
        self._refused: Dict[str, int] = {}
        self._expired: Dict[str, int] = {}
        self._last: Dict[str, Dict[str, float]] = {}

    def tick(self, rates: RateRegistry) -> None:
        p = self.policy
        now = self._clock()
        with self._lock:
            # 1. Grade predictions whose horizon elapsed.
            for model in sorted(self._pending):
                made_at, predicted = self._pending[model]
                if now - made_at < p.forecast_horizon_s:
                    continue
                del self._pending[model]
                n = rates.tracker(model).count_between(
                    made_at, made_at + p.forecast_horizon_s
                )
                if n is None:
                    # The sliding window rotated past the prediction
                    # span (a stalled control loop): the truth is gone,
                    # so the score would be fiction — count it instead.
                    self._expired[model] = self._expired.get(model, 0) + 1
                    continue
                actual = n / p.forecast_horizon_s
                err = abs(predicted - actual)
                sk = self._sketches.setdefault(model, QuantileSketch())
                sk.observe(err)
                FORECAST_ERROR.observe(err, tags={"model": model})
                self._scored[model] = self._scored.get(model, 0) + 1
                self._last[model] = {
                    "predicted_rps": predicted, "actual_rps": actual,
                }
            # 2. Make the next round of predictions.
            forecasts = rates.forecasts(
                p.forecast_horizon_s,
                alpha=p.forecast_alpha, beta=p.forecast_beta,
                min_span_s=p.forecast_min_span_s,
            )
            for model in sorted(forecasts):
                if model in self._pending:
                    continue
                predicted = forecasts[model]
                if predicted is None:
                    # Cold window: the forecast REFUSES rather than
                    # extrapolating a partial bucket (the cold-
                    # window under-read foot-gun).
                    self._refused[model] = self._refused.get(model, 0) + 1
                    continue
                self._pending[model] = (now, predicted)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            models = (set(self._sketches) | set(self._refused)
                      | set(self._expired) | set(self._pending))
            out: Dict[str, Any] = {}
            for model in sorted(models):
                sk = self._sketches.get(model)
                out[model] = {
                    "scored": self._scored.get(model, 0),
                    "refused": self._refused.get(model, 0),
                    "expired": self._expired.get(model, 0),
                    "p50_abs_err_rps": (None if sk is None or not sk.count
                                        else sk.quantile(0.5)),
                    "p95_abs_err_rps": (None if sk is None or not sk.count
                                        else sk.quantile(0.95)),
                    **({"last": dict(self._last[model])}
                       if model in self._last else {}),
                }
            return out


# price(model) -> {hop: expected_ms} or None when the cost model has no
# belief about the model (not yet planned / unknown).
PriceFn = Callable[[str], Optional[Dict[str, float]]]


class FidelityMonitor:
    """Online sim-vs-live drift: ring-buffer real arrivals, replay them
    through the installed cost model every N ticks, and grade predicted
    vs live per-hop sketches with ``sim/report.hop_drift_report`` —
    The guilty-hop CI sentinel promoted to a continuously-running
    instrument. Contract: a hop is GRADED only when the cost model
    prices it AND both sides carry enough super-floor samples;
    everything else is listed under ``ungraded`` with its counts —
    never silently skipped.

    Each arrival is stamped with the cost model's price AT ARRIVAL
    TIME, so the predicted sketch is the same *mixture* the live hop
    sketch accumulates: a replan that re-sizes batches changes the
    price for future arrivals without retroactively indicting (or
    absolving) requests the old plan served. Grading current price
    against cumulative history would flag every replan as drift."""

    def __init__(self, scope: str, policy: ObservatoryPolicy,
                 clock=time.monotonic,
                 price: Optional[PriceFn] = None) -> None:
        self.scope = scope
        self.policy = policy
        self._clock = clock
        self.price = price
        self.audit = None
        self._lock = OrderedLock("observatory")
        # (t_s, model, price-at-arrival) ring — the WorkloadDriver
        # recording path, in-process and bounded.
        self._ring: deque = deque(maxlen=policy.arrival_ring)
        self._ticks = 0
        self.replays = 0
        self._last: Dict[str, Any] = {}
        # model -> last drifting-hop tuple (audit on CHANGE, not every
        # replay — a steady drift is one record, not a record per tick).
        self._last_drifting: Dict[str, tuple] = {}

    def note_arrivals(self, model: str, n: int = 1) -> None:
        if n <= 0:
            return
        now = self._clock()
        prices = self.price(model) if self.price is not None else None
        with self._lock:
            for _ in range(min(int(n), self._ring.maxlen)):
                self._ring.append((now, model, prices))

    def tick(self, live_hops: Dict[str, Dict[str, Any]]) -> None:
        """``live_hops``: model -> hop -> sketch-like (``.count`` +
        ``.quantile``). Replays only every ``replay_every_ticks`` ticks;
        intermediate ticks just advance the cadence counter."""
        with self._lock:
            self._ticks += 1
            if self._ticks % max(1, self.policy.replay_every_ticks):
                return
            window = list(self._ring)
        self._replay(window, live_hops)

    def _replay(self, window: List[Tuple[float, str, Any]],
                live_hops: Dict[str, Dict[str, Any]]) -> None:
        from ray_dynamic_batching_tpu_torch.sim.report import hop_drift_report

        p = self.policy
        self.replays += 1
        arrivals_by_model: Dict[str, int] = {}
        priced_by_model: Dict[str, int] = {}
        predicted_by_model: Dict[str, Dict[str, QuantileSketch]] = {}
        for _, model, prices in window:
            arrivals_by_model[model] = arrivals_by_model.get(model, 0) + 1
            if not prices:
                continue
            priced_by_model[model] = priced_by_model.get(model, 0) + 1
            sketches = predicted_by_model.setdefault(model, {})
            for hop, ms in prices.items():
                if hop not in sketches:
                    sketches[hop] = QuantileSketch()
                sketches[hop].observe(float(ms))
        reports: Dict[str, Any] = {}
        drift_changes: List[Dict[str, Any]] = []
        for model in sorted(set(arrivals_by_model) | set(live_hops)):
            report = hop_drift_report(
                live_hops.get(model, {}),
                predicted_by_model.get(model, {}),
                tolerance=p.drift_tolerance,
                min_count=p.drift_min_count,
            )
            for hop, entry in report["ungraded"].items():
                # Never-silent: say WHY each ungraded hop went ungraded.
                entry["reason"] = (
                    "not-priced" if entry["sim_count"] == 0
                    else "no-live-samples" if entry["live_count"] == 0
                    else "insufficient-samples"
                )
            self._apply_floor(report)
            if not priced_by_model.get(model):
                report["ungraded_reason"] = "unpriced: no cost model"
            reports[model] = report
            for hop, entry in report["hops"].items():
                FIDELITY_DRIFT.set(entry["worst_drift"],
                                   tags={"hop": hop, "model": model})
            drifting = tuple(report["drifting_hops"])
            if drifting != self._last_drifting.get(model, ()):
                drift_changes.append({
                    "at": self._clock(),
                    "model": model,
                    "drifting_hops": list(drifting),
                    "was": list(self._last_drifting.get(model, ())),
                    "hops": {
                        hop: round(entry["worst_drift"], 4)
                        for hop, entry in report["hops"].items()
                    },
                })
                self._last_drifting[model] = drifting
        with self._lock:
            self._last = {
                "at": self._clock(),
                "arrivals_replayed": len(window),
                "models": reports,
            }
        for change in drift_changes:
            self._publish(change)

    def _apply_floor(self, report: Dict[str, Any]) -> None:
        """Move graded hops where BOTH sides sit under the latency floor
        into ``ungraded``: a 0.2 ms live wait vs a 0 ms prediction is a
        relative drift of 1.0 and a lie — sub-floor hops carry no
        pricing signal either way."""
        floor = self.policy.drift_min_abs_ms
        for hop in list(report["hops"]):
            entry = report["hops"][hop]
            sides = [q["live_ms"] for k, q in entry.items()
                     if isinstance(q, dict)]
            sides += [q["sim_ms"] for k, q in entry.items()
                      if isinstance(q, dict)]
            if sides and max(sides) < floor:
                del report["hops"][hop]
                report["ungraded"][hop] = {
                    "live_count": entry["live_count"],
                    "sim_count": entry["sim_count"],
                    "reason": "sub-floor",
                }
                if hop in report["drifting_hops"]:
                    report["drifting_hops"].remove(hop)
        report["ok"] = not report["drifting_hops"]

    def _publish(self, change: Dict[str, Any]) -> None:
        drifting = change["drifting_hops"]
        if drifting:
            logger.warning(
                "%s: fidelity drift on %s — mispriced hop(s) %s (%s)",
                self.scope, change["model"], drifting, change["hops"],
            )
        else:
            logger.info("%s: fidelity drift on %s cleared",
                        self.scope, change["model"])
        if self.audit is not None:
            self.audit.record(
                "fidelity_drift" if drifting else "fidelity_clean",
                key=change["model"],
                observed={"hops": change["hops"]},
                before={"drifting_hops": change["was"]},
                after={"drifting_hops": drifting},
                diff={"mispriced": drifting},
            )
        tracer().record_span(
            "observatory.drift", component="observatory",
            model=change["model"],
            drifting_hops=",".join(drifting),
            at_s=change["at"],
        )

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replays": self.replays,
                "ring_depth": len(self._ring),
                "last": dict(self._last),
            }


class SLOObservatory:
    """The three instruments behind one tick and one audited snapshot —
    constructed once, ticked by ``ServeController._control_step`` live
    and by ``SimScheduler._on_monitor`` at virtual time (the same
    classes, no re-expression)."""

    def __init__(self, scope: str,
                 policy: Optional[ObservatoryPolicy] = None,
                 clock=time.monotonic,
                 price: Optional[PriceFn] = None) -> None:
        self.scope = scope
        self.policy = policy or ObservatoryPolicy()
        self._clock = clock
        self.burn = BurnRateMonitor(scope, self.policy, clock=clock)
        self.forecast = ForecastScorer(self.policy, clock=clock)
        self.fidelity = FidelityMonitor(scope, self.policy, clock=clock,
                                        price=price)

    @property
    def audit(self):
        return self.burn.audit

    @audit.setter
    def audit(self, log) -> None:
        self.burn.audit = log
        self.fidelity.audit = log

    def note_arrivals(self, model: str, n: int = 1) -> None:
        """Feed the fidelity replay ring (the host also records the same
        arrivals into its RateRegistry — demand is counted once per
        consumer, at the same door)."""
        self.fidelity.note_arrivals(model, n)

    def tick(
        self,
        class_counters: Dict[str, Dict[str, Dict[str, float]]],
        rates: RateRegistry,
        live_hops: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> List[Dict[str, Any]]:
        """One observatory tick: grade burn, score/refresh forecasts,
        advance the fidelity replay cadence. Returns the burn-alert
        transitions this tick fired."""
        fired = self.burn.tick(class_counters)
        self.forecast.tick(rates)
        self.fidelity.tick(live_hops or {})
        return fired

    def snapshot(self, key: Optional[str] = None) -> Dict[str, Any]:
        """JSON-clean block shared by controller ``status()`` and the
        sim report (``key`` filters the burn view to one deployment;
        forecast/fidelity are per-model already)."""
        return {
            "alerts": self.burn.snapshot(key=key),
            "forecast": self.forecast.snapshot(),
            "fidelity": self.fidelity.snapshot(),
        }
