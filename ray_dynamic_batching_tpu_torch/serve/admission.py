"""Token-bucket admission control + the overload governor.

Own copy of ``ray_dynamic_batching_tpu/serve/admission.py``, whole, with
its import paths rewritten.

Shepherd's (NSDI '23) serving-layer lesson applied to this stack: overload
protection belongs AHEAD of the queue. Both proxies consult a
per-(deployment, tenant, qos_class) token bucket before any work is routed
or queued; a reject costs the client one round trip and a computed
``Retry-After`` (the bucket's refill time) instead of a queue slot, a
batch slot, and a deadline-doomed wait. The planner then only ever plans
for load the system actually accepted.

Two layers:

- :class:`TokenBucket` — classic refill-on-read bucket, clock-injected so
  the simulator reuses it verbatim at virtual time (deterministic).
- :class:`AdmissionController` — policy table + bucket registry + the
  **overload governor**: a per-deployment ``normal <-> degraded`` state
  machine fed queue-depth / SLO-compliance signals by the control plane
  (``ServeController._control_step`` live, the monitor tick in sim). In
  the degraded state each class's bucket rate is multiplied by its
  ``degraded_class_fractions`` entry — best-effort throttles to a trickle
  while interactive keeps its full rate — so overload lands on the tier
  that contracted for it. Transitions have hysteresis BOTH ways (enter on
  high depth or low compliance, exit only when both recover) and every
  transition is recorded in the scheduler audit ring.

Rejections raise (or return) :class:`AdmissionRejected`, which the shared
error table (``serve/failover.reject_disposition``) maps to HTTP 429 /
gRPC RESOURCE_EXHAUSTED with the computed ``Retry-After``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ray_dynamic_batching_tpu_torch.engine.request import (
    DEFAULT_QOS_CLASS,
    DEFAULT_TENANT,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m

logger = get_logger("admission")

ADMISSION_TOTAL = m.Counter(
    "rdb_admission_total",
    "Admission decisions (outcome: admit | reject)",
    tag_keys=("deployment", "tenant", "qos", "outcome"),
    bounded_tags={"tenant": m.DEFAULT_TENANT_TOP_K},
)
GOVERNOR_STATE = m.Gauge(
    "rdb_admission_governor_degraded",
    "1 while the overload governor holds the deployment degraded",
    tag_keys=("deployment",),
)


class AdmissionRejected(Exception):
    """The request was turned away BEFORE any work was queued (bucket
    empty). Carries the computed retry hint; client-visible as
    429 + Retry-After (gRPC RESOURCE_EXHAUSTED) — capacity economics,
    never a server fault."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class TokenBucket:
    """Refill-on-read token bucket. ``clock`` returns monotonic seconds —
    the simulator injects its virtual clock, so admission decisions are
    byte-deterministic under replay. Not thread-safe by itself; the
    controller serializes access."""

    def __init__(self, rate_rps: float, burst: float,
                 clock=time.monotonic) -> None:
        self.rate_rps = float(rate_rps)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate_rps
        )
        self._last = now

    def set_rate(self, rate_rps: float) -> None:
        """Governor rate flips refill at the OLD rate first, so tokens
        earned before the transition are kept, not re-priced."""
        self._refill()
        self.rate_rps = float(rate_rps)

    def try_acquire(self, n: float = 1.0) -> Tuple[bool, float]:
        """(admitted, retry_after_s). The retry hint is the exact refill
        time for the missing tokens — a well-behaved client that waits it
        out is admitted on its next attempt (barring new contention)."""
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True, 0.0
        if self.rate_rps <= 0.0:
            return False, 60.0  # administratively closed: poll slowly
        return False, (n - self._tokens) / self.rate_rps


@dataclass
class AdmissionPolicy:
    """Per-deployment admission contract.

    ``rate_rps``/``burst`` size each (tenant, class) bucket in the normal
    state; ``degraded_class_fractions`` multiply the per-class rate while
    the governor holds the deployment degraded. Hysteresis: degrade when
    queue depth fraction >= ``depth_high`` OR SLO compliance <=
    ``compliance_low``; recover only when depth <= ``depth_low`` AND
    compliance >= ``compliance_high``."""

    rate_rps: float
    burst: float = 0.0                      # 0 -> defaults to rate_rps
    # Distinct tenants that get their OWN buckets (first-come); overflow
    # tenants share one ``__other__`` bucket. Tenant is unauthenticated
    # client input: without a cap, rotating the header would both grow
    # the bucket table without bound AND mint a fresh burst of tokens
    # per made-up tenant — an admission bypass. Same top-K discipline as
    # the metrics layer's bounded tenant labels.
    max_tenants: int = 64
    degraded_class_fractions: Dict[str, float] = field(
        default_factory=lambda: {
            "interactive": 1.0, "standard": 0.5, "best_effort": 0.1,
        }
    )
    depth_high: float = 0.5
    depth_low: float = 0.1
    compliance_low: float = 0.80
    compliance_high: float = 0.95
    # --- congested state (metastability defense, serve/retrybudget.py) ---
    # While first-attempt SLO compliance sits at/below this floor the
    # deployment is CONGESTED: the retry/hedge budget is held at zero —
    # every re-dispatch would displace a first attempt that already
    # cannot make its deadline, which is how retries hold a recovered
    # cluster in collapse (metastable failure). 0.0 disables the state.
    congested_floor: float = 0.0
    # Exit bar (hysteresis): compliance must recover to at least this
    # before the budget is restored; 0.0 defaults to compliance_high.
    congested_exit: float = 0.0

    def __post_init__(self) -> None:
        if self.burst <= 0.0:
            self.burst = self.rate_rps
        if self.depth_low > self.depth_high:
            raise ValueError("depth_low must be <= depth_high (hysteresis)")
        if self.compliance_high < self.compliance_low:
            raise ValueError(
                "compliance_high must be >= compliance_low (hysteresis)"
            )
        if self.congested_floor > 0.0:
            if self.congested_exit <= 0.0:
                self.congested_exit = self.compliance_high
            if self.congested_exit < self.congested_floor:
                raise ValueError(
                    "congested_exit must be >= congested_floor (hysteresis)"
                )

    def class_rate(self, qos: str, degraded: bool) -> float:
        if not degraded:
            return self.rate_rps
        return self.rate_rps * self.degraded_class_fractions.get(qos, 1.0)


class AdmissionController:
    """Policy table + bucket registry + overload governor for a serving
    domain. One instance per controller (live) or per simulation run."""

    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._policies: Dict[str, AdmissionPolicy] = {}
        self._degraded: Dict[str, bool] = {}
        # Congested: first-attempt attainment under floor — the retry
        # budget is zeroed until it recovers (metastability
        # defense). Orthogonal to degraded: a deployment can shed
        # best-effort (degraded) without being so far gone that
        # re-dispatches must stop (congested).
        self._congested: Dict[str, bool] = {}
        # (deployment, tenant, qos) -> bucket; tenants over the policy's
        # top-K collapse into one shared overflow bucket (see
        # AdmissionPolicy.max_tenants).
        self._buckets: Dict[Tuple[str, str, str], TokenBucket] = {}
        self._tenants_seen: Dict[str, set] = {}
        # Optional decision ring (scheduler/audit.AuditLog): every governor
        # transition is a control-plane decision and must land next to
        # replans, heals and breaker trips.
        self.audit = None
        self.transitions = 0
        self.admitted = 0
        self.rejected = 0
        # Rejects per deployment since its last observe() tick: while the
        # governor holds a deployment degraded, ongoing rejects mean the
        # flood is still arriving — recovery on depth/compliance alone
        # would flap (degrade sheds the load, the queue looks healthy one
        # tick later, recovery readmits the flood, repeat).
        self._rejects_since_observe: Dict[str, int] = {}

    # --- configuration ----------------------------------------------------
    def configure(self, deployment: str,
                  policy: Optional[AdmissionPolicy]) -> None:
        """Install (or with ``None`` remove) a deployment's policy.
        Unconfigured deployments admit everything."""
        with self._lock:
            if policy is None:
                self._policies.pop(deployment, None)
                self._degraded.pop(deployment, None)
                self._congested.pop(deployment, None)
                self._tenants_seen.pop(deployment, None)
                for key in [k for k in self._buckets if k[0] == deployment]:
                    del self._buckets[key]
                return
            previous = self._policies.get(deployment)
            self._policies[deployment] = policy
            self._degraded.setdefault(deployment, False)
            if previous is not None and previous != policy:
                # A CHANGED contract must bind existing buckets too:
                # admit() lazily re-derives rate_rps, but burst and the
                # tenant top-K are frozen into the bucket/seen state —
                # drop them so the new knobs apply from the next admit
                # (an unchanged redeploy keeps its budgets untouched).
                self._tenants_seen.pop(deployment, None)
                for key in [k for k in self._buckets if k[0] == deployment]:
                    del self._buckets[key]

    def policy(self, deployment: str) -> Optional[AdmissionPolicy]:
        with self._lock:
            return self._policies.get(deployment)

    def degraded(self, deployment: str) -> bool:
        with self._lock:
            return self._degraded.get(deployment, False)

    def congested(self, deployment: str) -> bool:
        with self._lock:
            return self._congested.get(deployment, False)

    def force_state(self, deployment: str, degraded: bool,
                    congested: Optional[bool] = None) -> None:
        """Restore the governor state from a durable mirror (controller
        failover: the successor's fresh controller must keep enforcing
        the degraded-mode contract the old leader declared, not re-admit
        the flood until its own hysteresis re-detects it). Bucket rates
        re-derive lazily at the next admit, as with observe().
        ``congested=None`` leaves the congested verdict untouched (old
        mirrors predate the key)."""
        with self._lock:
            if deployment in self._policies:
                self._degraded[deployment] = bool(degraded)
                if congested is not None:
                    self._congested[deployment] = bool(congested)

    # --- the admission decision -------------------------------------------
    def admit(
        self,
        deployment: str,
        tenant: str = DEFAULT_TENANT,
        qos_class: str = DEFAULT_QOS_CLASS,
    ) -> Tuple[bool, float]:
        """(admitted, retry_after_s) — consulted by the proxies BEFORE any
        routing or queueing."""
        with self._lock:
            policy = self._policies.get(deployment)
            if policy is None:
                return True, 0.0
            # Top-K tenant buckets: a tenant string beyond the cap shares
            # the overflow bucket — rotating the (unauthenticated) tenant
            # header cannot mint fresh burst tokens or unbounded state.
            seen = self._tenants_seen.setdefault(deployment, set())
            if tenant not in seen:
                if len(seen) < policy.max_tenants:
                    seen.add(tenant)
                else:
                    tenant = m.OTHER_LABEL
            degraded = self._degraded.get(deployment, False)
            key = (deployment, tenant, qos_class)
            bucket = self._buckets.get(key)
            rate = policy.class_rate(qos_class, degraded)
            if bucket is None:
                bucket = self._buckets[key] = TokenBucket(
                    rate, policy.burst, clock=self._clock
                )
            elif bucket.rate_rps != rate:
                bucket.set_rate(rate)  # governor flipped since last use
            ok, retry_after_s = bucket.try_acquire()
            if ok:
                self.admitted += 1
            else:
                self.rejected += 1
                self._rejects_since_observe[deployment] = (
                    self._rejects_since_observe.get(deployment, 0) + 1
                )
        ADMISSION_TOTAL.inc(tags={
            "deployment": deployment, "tenant": tenant, "qos": qos_class,
            "outcome": "admit" if ok else "reject",
        })
        if ok:
            return True, 0.0
        return False, retry_after_s

    def admit_or_raise(self, deployment: str, tenant: str = DEFAULT_TENANT,
                       qos_class: str = DEFAULT_QOS_CLASS) -> None:
        ok, retry_after_s = self.admit(deployment, tenant, qos_class)
        if not ok:
            raise AdmissionRejected(  # rdb-lint: disable=shed-accounting (admit() above already counted this reject in ADMISSION_TOTAL and the controller stats)
                f"{deployment}: admission rate exceeded for tenant "
                f"{tenant!r} class {qos_class!r}",
                retry_after_s=retry_after_s,
            )

    # --- overload governor -------------------------------------------------
    def observe(self, deployment: str, depth_frac: float,
                slo_compliance: float) -> Optional[str]:
        """Feed one control-tick's signals; returns the transition name
        (``"degrade"``/``"recover"``) when the state flipped, else None.
        Recovery additionally requires ZERO rejects since the last tick:
        a degraded deployment still turning traffic away is still under
        the flood — readmitting it would flap (degrade sheds the load,
        the queue reads healthy one tick later, recovery readmits,
        repeat). Bucket rates re-derive lazily at the next admit — no
        bucket churn on quiet ticks."""
        with self._lock:
            policy = self._policies.get(deployment)
            if policy is None:
                return None
            recent_rejects = self._rejects_since_observe.pop(deployment, 0)
            degraded = self._degraded.get(deployment, False)
            transition = None
            if not degraded and (
                depth_frac >= policy.depth_high
                or slo_compliance <= policy.compliance_low
            ):
                self._degraded[deployment] = True
                transition = "degrade"
            elif degraded and (
                depth_frac <= policy.depth_low
                and slo_compliance >= policy.compliance_high
                and recent_rejects == 0
            ):
                self._degraded[deployment] = False
                transition = "recover"
            # Congested hysteresis (its OWN axis — a tick may flip both):
            # enter at/below the attainment floor, exit only at/above the
            # exit bar. No zero-rejects gate here: while congested the
            # budget itself sheds re-dispatches, so rejects are the
            # defense WORKING, not evidence the flood persists.
            congest_transition = None
            if policy.congested_floor > 0.0:
                congested = self._congested.get(deployment, False)
                if not congested and \
                        slo_compliance <= policy.congested_floor:
                    self._congested[deployment] = True
                    congest_transition = "congest"
                elif congested and \
                        slo_compliance >= policy.congested_exit:
                    self._congested[deployment] = False
                    congest_transition = "clear_congestion"
            if transition is None and congest_transition is None:
                return None
            self.transitions += (transition is not None) + (
                congest_transition is not None)
            now_degraded = self._degraded[deployment]
            now_congested = self._congested.get(deployment, False)
            fractions = dict(policy.degraded_class_fractions)
        if transition is not None:
            GOVERNOR_STATE.set(
                1.0 if now_degraded else 0.0, tags={"deployment": deployment}
            )
            logger.warning(
                "%s: admission governor %s (depth_frac=%.3f "
                "compliance=%.3f)",
                deployment, transition.upper(), depth_frac, slo_compliance,
            )
            if self.audit is not None:
                self.audit.record(
                    "admission_governor",
                    key=deployment,
                    observed={"depth_frac": round(depth_frac, 4),
                              "slo_compliance": round(slo_compliance, 4)},
                    before={"state": "normal" if now_degraded
                            else "degraded"},
                    after={"state": "degraded" if now_degraded
                           else "normal"},
                    diff={"class_rate_fractions": (
                        fractions if now_degraded else
                        {c: 1.0 for c in fractions}
                    )},
                )
        if congest_transition is not None:
            logger.warning(
                "%s: admission governor %s (compliance=%.3f floor=%.3f)",
                deployment, congest_transition.upper(), slo_compliance,
                policy.congested_floor,
            )
            if self.audit is not None:
                self.audit.record(
                    "admission_governor",
                    key=deployment,
                    observed={"slo_compliance": round(slo_compliance, 4),
                              "congested_floor": policy.congested_floor},
                    before={"congested": not now_congested},
                    after={"congested": now_congested},
                    diff={"retry_budget": ("zeroed" if now_congested
                                           else "restored")},
                )
        return transition or congest_transition

    # --- observability -----------------------------------------------------
    def snapshot(self, deployment: str) -> Dict[str, object]:
        with self._lock:
            policy = self._policies.get(deployment)
            return {
                "configured": policy is not None,
                "state": ("degraded"
                          if self._degraded.get(deployment, False)
                          else "normal"),
                "congested": self._congested.get(deployment, False),
                "rate_rps": policy.rate_rps if policy else None,
                "buckets": sum(
                    1 for k in self._buckets if k[0] == deployment
                ),
            }

    def stats(self) -> Dict[str, float]:
        return {
            "admitted": float(self.admitted),
            "rejected": float(self.rejected),
            "governor_transitions": float(self.transitions),
        }
