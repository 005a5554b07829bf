"""Gray-failure detection — straggler scoring against peer consensus.

Own copy of ``ray_dynamic_batching_tpu/serve/grayhealth.py``, whole,
with its import paths rewritten.

A binary failure taxonomy falls short: ``healthy()`` is a bool, ``ReplicaDeadError``
is the only replica-level failure, and a replica running 5-10x slow (a
thermally throttled chip, a wedged DMA queue, a noisy neighbor) holds
its breaker closed forever because every slow batch still SUCCEEDS.
Dean & Barroso ("The Tail at Scale", CACM 2013) show exactly this class
of degradation dominates tail latency at fan-out — and the quantile-sketch
substrate makes per-replica latency distributions cheap enough to
compare continuously. This module is the detector on top of them:

- **Scoring** (:func:`grade_observations`, pure): each replica's recent
  latency (p50, p95) is compared against the MEDIAN of its peers for
  the same deployment. A replica is an *outlier* when its p50 or p95
  exceeds ``ratio x peer-median`` (relative — absolute thresholds can't
  serve a fleet where one model answers in 2 ms and another in 2 s).
  Replicas without enough samples, or without enough graded peers to
  form a consensus, are UNGRADED — never guilty by absence of data.
- **Hysteresis state machine** (:class:`GrayHealthMonitor`):
  ``healthy -> suspect -> probation -> ejected``, driven by consecutive
  outlier ticks (one slow batch is noise; N consecutive graded ticks is
  a straggler), with the reverse edges ``suspect/probation -> healthy``
  after consecutive clear ticks. Probation drains the replica from the
  router's power-of-two candidate pool but keeps PROBING it (one
  request per probe interval — the breaker's half-open arm,
  generalized), so a healed replica earns its way back. Ejection is the
  terminal verdict: the replica feeds the existing engine-death replan
  /heal path and the planner reclaims the chip.
- **Capacity pricing**: :meth:`GrayHealthMonitor.capacity_factor` maps
  states onto the fraction of a chip the planner may still count
  (``scheduler/replan.decide_replan(capacity_factors=...)``) —
  probation is fractional capacity, not alive/dead.

The monitor is shared verbatim by the serve tier (controller ticks it
with per-replica queue sketches) and the simulator (``sim/control.py``
ticks it with observed/expected step-latency ratios) — the no-drift
discipline every cross-tier policy here follows. Every transition lands
in the audit ring next to heals and breaker trips.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.utils.concurrency import assert_owner
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m

logger = get_logger("grayhealth")

GRAY_STATES = ("healthy", "suspect", "probation", "ejected")

GRAY_TRANSITIONS = m.Counter(
    "rdb_gray_transitions_total",
    "Gray-health state transitions (to: suspect | probation | ejected | "
    "healthy)",
    tag_keys=("deployment", "to"),
)


@dataclass(frozen=True)
class GrayHealthPolicy:
    """Detection knobs — ratios are RELATIVE to the peer consensus.

    The defaults are deliberately conservative (3x the peer median,
    two consecutive graded ticks per escalation): a false probation
    costs real capacity, while a true straggler is caught within a few
    monitor intervals either way. ``eject_after=0`` disables automatic
    ejection — probation already removes the replica from the serving
    pool, and ejection (replace/reclaim) is an operator-level policy a
    deployment opts into."""

    p50_ratio: float = 3.0        # outlier when p50 > ratio * peer median
    p95_ratio: float = 3.0        # ... or p95 > ratio * peer median p95
    min_abs_ms: float = 1.0       # ignore sub-floor latencies (ratio noise)
    min_samples: int = 8          # sketch samples needed to grade a replica
    min_peers: int = 2            # graded peers needed for a consensus
    suspect_after: int = 2        # consecutive outlier ticks -> suspect
    probation_after: int = 2      # further outlier ticks -> probation
    eject_after: int = 0          # probation ticks still-outlier -> ejected
                                  # (0 = never auto-eject)
    heal_after: int = 2           # consecutive clear ticks -> healthy
    probation_capacity: float = 0.35   # planner's fractional-chip price
    probe_interval_s: float = 0.25     # probation probe admission cadence


# One observation per replica per tick: (p50_ms, p95_ms, sample_count).
Observation = Tuple[float, float, int]


def grade_observations(
    observations: Dict[str, Observation], policy: GrayHealthPolicy
) -> Dict[str, Optional[bool]]:
    """Pure scoring: replica id -> True (outlier) / False (clear) /
    None (ungraded: too few samples, or too few graded peers to form a
    consensus). Shared by the live controller tick and the sim monitor
    so detection thresholds tuned in the sim transfer unchanged."""
    graded = {
        rid: obs for rid, obs in observations.items()
        if obs[2] >= policy.min_samples
    }
    out: Dict[str, Optional[bool]] = {rid: None for rid in observations}
    for rid, (p50, p95, _n) in graded.items():
        peers = [o for pid, o in graded.items() if pid != rid]
        if len(peers) < policy.min_peers:
            continue
        peer_p50 = median_or_zero([o[0] for o in peers])
        peer_p95 = median_or_zero([o[1] for o in peers])
        out[rid] = bool(
            (p50 > policy.min_abs_ms and p50 > policy.p50_ratio * peer_p50)
            or (p95 > policy.min_abs_ms
                and p95 > policy.p95_ratio * peer_p95)
        )
    return out


def median_or_zero(values: List[float]) -> float:
    """``statistics.median`` with the empty-input -> 0.0 convention the
    grader and the hedge threshold share (no consensus = no bar)."""
    return float(statistics.median(values)) if values else 0.0


def rank_percentile(samples: List[float], p: float) -> float:
    """The live ``RollingWindow.percentile`` rule (nearest-rank via
    ceil), over an explicit sample list. One definition for every
    ratio-window grader (live scheduler, sim) — no drift."""
    if not samples:
        return 0.0
    data = sorted(samples)
    idx = min(len(data) - 1, max(0, math.ceil(p * len(data)) - 1))
    return data[idx]


def ratio_observations(
    drained_by_id: Dict[str, List[float]],
    windows: Dict[str, List[List[float]]],
    window_ticks: int,
    probes: Optional[Dict[str, float]] = None,
) -> Dict[str, Observation]:
    """Fold one monitor tick's drained observed/expected ratio lists
    into the per-replica tick windows and produce grade-ready
    ``(p50, p95, n)`` observations. Shared VERBATIM by
    ``LiveScheduler.check_gray_health`` and the sim twin.

    Windows are TICK-bounded (last ``window_ticks`` drains): a 10x-slow
    engine finishes ~10x fewer batches per tick, so slow evidence must
    stay visible across ticks, while a heal flushes within
    ``window_ticks``. ``probes`` maps replica id -> synthetic probe
    ratio used when that replica's drain came back EMPTY (the sim's
    probation probe; the live tier has no ground truth to synthesize
    and passes none — an idled probationed engine holds state there)."""
    obs: Dict[str, Observation] = {}
    for rid, drained in drained_by_id.items():
        if not drained and probes is not None and rid in probes:
            drained = [probes[rid]]
        window = windows.setdefault(rid, [])
        window.append(drained)
        del window[:-window_ticks]
        samples = [x for tick in window for x in tick]
        obs[rid] = (
            rank_percentile(samples, 0.5),
            rank_percentile(samples, 0.95),
            len(samples),
        )
    return obs


@dataclass
class _ReplicaGrayState:
    state: str = "healthy"
    outlier_streak: int = 0
    clear_streak: int = 0
    probation_ticks: int = 0
    last_probe_at: float = 0.0
    since: float = 0.0            # clock() at the last transition


class GrayHealthMonitor:
    """Per-deployment gray-health state machine over a replica set.

    Thread-safe (the controller tick, the router's candidate filter and
    status() readers race); the injected ``clock`` keeps the simulator
    deterministic (virtual seconds) while live callers default to
    ``time.monotonic``."""

    def __init__(
        self,
        scope: str,
        policy: Optional[GrayHealthPolicy] = None,
        clock=time.monotonic,
    ) -> None:
        self.scope = scope
        self.policy = policy or GrayHealthPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._states: Dict[str, _ReplicaGrayState] = {}
        # Optional decision ring (scheduler/audit.AuditLog): gray
        # transitions are control-plane decisions and belong in the same
        # timeline as heals, breaker trips and governor transitions.
        self.audit = None
        # Bounded ring: a long-lived live monitor with a flapping
        # replica must not grow without limit; the cap is far above any
        # sim scenario's timeline (reports read the whole deque).
        self.transitions: deque = deque(maxlen=4096)

    # --- state machine ----------------------------------------------------
    def _st(self, rid: str) -> _ReplicaGrayState:
        assert_owner(self._lock)  # callers hold it (tick)
        st = self._states.get(rid)
        if st is None:
            st = self._states[rid] = _ReplicaGrayState(
                since=self._clock()
            )
        return st

    def tick(
        self, observations: Dict[str, Observation]
    ) -> List[Dict[str, Any]]:
        """Grade one monitor tick's observations and advance every
        replica's state machine. Returns the transitions this tick
        caused (also appended to :attr:`transitions` and audited)."""
        verdicts = grade_observations(observations, self.policy)
        fired: List[Dict[str, Any]] = []
        with self._lock:
            for rid, verdict in verdicts.items():
                st = self._st(rid)
                if st.state == "ejected" or verdict is None:
                    # Ungraded ticks hold state: never guilty (or healed)
                    # by absence of data.
                    continue
                if verdict:
                    st.outlier_streak += 1
                    st.clear_streak = 0
                else:
                    st.clear_streak += 1
                    st.outlier_streak = 0
                new_state = self._next_state_locked(st)
                if new_state is not None:
                    fired.append(self._transition_locked(
                        rid, st, new_state, observations[rid]
                    ))
        for t in fired:
            self._publish(t)
        return fired

    def _next_state_locked(
        self, st: _ReplicaGrayState
    ) -> Optional[str]:
        p = self.policy
        if st.state == "healthy":
            if st.outlier_streak >= p.suspect_after:
                return "suspect"
        elif st.state == "suspect":
            if st.outlier_streak >= p.probation_after:
                return "probation"
            if st.clear_streak >= p.heal_after:
                return "healthy"
        elif st.state == "probation":
            if st.outlier_streak:
                st.probation_ticks += 1
            if p.eject_after > 0 and st.probation_ticks >= p.eject_after:
                return "ejected"
            if st.clear_streak >= p.heal_after:
                return "healthy"
        return None

    def _transition_locked(
        self, rid: str, st: _ReplicaGrayState, new_state: str,
        obs: Observation,
    ) -> Dict[str, Any]:
        record = {
            "at": self._clock(),
            "replica": rid,
            "from": st.state,
            "to": new_state,
            "p50_ms": round(obs[0], 3),
            "p95_ms": round(obs[1], 3),
        }
        st.state = new_state
        st.outlier_streak = 0
        st.clear_streak = 0
        st.since = record["at"]
        if new_state != "probation":
            st.probation_ticks = 0
        self.transitions.append(record)
        return record

    def _publish(self, t: Dict[str, Any]) -> None:
        GRAY_TRANSITIONS.inc(tags={"deployment": self.scope,
                                   "to": t["to"]})
        log = logger.warning if t["to"] != "healthy" else logger.info
        log(
            "%s: replica %s gray-health %s -> %s (p50=%.1fms p95=%.1fms)",
            self.scope, t["replica"], t["from"], t["to"],
            t["p50_ms"], t["p95_ms"],
        )
        if self.audit is not None:
            self.audit.record(
                f"gray_{'heal' if t['to'] == 'healthy' else t['to']}",
                key=self.scope,
                observed={"replica": t["replica"], "p50_ms": t["p50_ms"],
                          "p95_ms": t["p95_ms"]},
                before={"state": t["from"]},
                after={"state": t["to"]},
                diff={("readmitted" if t["to"] == "healthy"
                       else "degraded"): t["replica"]},
            )

    # --- routing surface --------------------------------------------------
    def state(self, rid: str) -> str:
        with self._lock:
            st = self._states.get(rid)
            return st.state if st is not None else "healthy"

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {rid: st.state for rid, st in self._states.items()}

    def is_candidate(self, rid: str) -> bool:
        """May this replica sit in the pow-2 candidate pool right now?
        healthy/suspect: yes. probation: only when a probe is due (the
        half-open arm — one request per probe interval keeps its sketch
        fresh so heals are observable). ejected: never."""
        with self._lock:
            st = self._states.get(rid)
            if st is None or st.state in ("healthy", "suspect"):
                return True
            if st.state == "probation":
                return (self._clock() - st.last_probe_at
                        >= self.policy.probe_interval_s)
            return False

    def mark_probe(self, rid: str) -> None:
        """One probation probe dispatched: start the next probe window."""
        with self._lock:
            st = self._states.get(rid)
            if st is not None and st.state == "probation":
                st.last_probe_at = self._clock()

    def capacity_factor(self, rid: str) -> float:
        """The planner's price for this replica/engine: a full chip while
        healthy or merely suspect, a fraction in probation, zero once
        ejected (``scheduler/replan`` folds the displaced load onto
        full-capacity peers)."""
        state = self.state(rid)
        if state == "probation":
            return self.policy.probation_capacity
        if state == "ejected":
            return 0.0
        return 1.0

    def forget(self, rid: str) -> None:
        """Drop a retired/replaced replica's state (the replacement
        starts healthy — it is new hardware, not the old verdict)."""
        with self._lock:
            self._states.pop(rid, None)

    def prune(self, live: set) -> None:
        with self._lock:
            for rid in [r for r in self._states if r not in live]:
                del self._states[rid]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "states": {rid: {
                    "state": st.state,
                    "outlier_streak": st.outlier_streak,
                    "clear_streak": st.clear_streak,
                    "since": st.since,
                } for rid, st in self._states.items()},
                "transitions": list(self.transitions)[-20:],
            }
