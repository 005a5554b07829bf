"""Work-conserving retry/hedge budgets — the anti-amplification governor.

Own copy of ``ray_dynamic_batching_tpu/serve/retrybudget.py``, whole,
with its import paths rewritten.

Retries, hedges, and requeues are *load amplifiers*: each one re-enters
the dispatch path carrying work the cluster already accepted once. Under
a transient fault that is exactly right (the re-dispatch lands on a
healthy replica and the request survives); under sustained overload it
is exactly wrong — the amplified load holds queues saturated after the
original trigger heals, the signature of a metastable failure (Bronson
et al., "Metastable Failures in Distributed Systems", HotOS '21).

:class:`RetryBudget` bounds the amplification: re-dispatches may consume
at most ``fraction`` of the deployment's recent *first-attempt* volume.
Volume is tracked with the same two-epoch rotation discipline as
``utils.sketch.RollingSketch`` — a current and a previous epoch of
counters, rotated every ``window`` first attempts, so "recent" is
count-bounded (between ``window`` and ``2*window`` first attempts),
deterministic, and clock-free (the sim twin shares the class verbatim).

Two modes:

- **permissive** (``fraction is None``, the default) — every spend is
  granted but still *accounted*, so ``status()`` dashboards show what a
  budget WOULD have charged before an operator turns one on.
- **enforcing** (``fraction`` set) — over-budget spends are denied; the
  caller sheds the re-dispatch as ``RetryBudgetExhausted`` (429 +
  Retry-After via the shared ``reject_disposition`` table). First
  attempts are never charged — admission already priced them.

The overload governor's ``congested`` verdict (serve/admission.py)
zeroes the budget outright in either mode: while first-attempt
attainment is below floor, every re-dispatch is one more first attempt
that won't fit — recovery must be monotone, so amplification stops
first. ``min_first_attempts`` keeps enforcement off until there is
enough recent volume for the fraction to mean anything (cold starts and
single-request failovers are not amplification).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.utils import metrics as m

RETRY_BUDGET_TOTAL = m.Counter(
    "rdb_retry_budget_total",
    "Re-dispatch budget decisions (granted/denied) by kind",
    tag_keys=("deployment", "kind", "outcome"),
)
RETRY_BUDGET_CONGESTED = m.Gauge(
    "rdb_retry_budget_congested",
    "1 while the overload governor holds this deployment's retry "
    "budget at zero",
    tag_keys=("deployment",),
)


@dataclass
class RetryBudgetPolicy:
    """Knobs for one deployment's amplification budget.

    ``fraction`` — re-dispatches (retries + hedges) allowed per recent
    first attempt; ``None`` tracks without enforcing. ``window`` — first
    attempts per accounting epoch (recent = current + previous epoch).
    ``min_first_attempts`` — enforcement floor: below this much recent
    first-attempt volume every spend is granted (a fraction of nothing
    is noise, and low-volume failovers are recovery, not amplification).
    """

    fraction: Optional[float] = None
    window: int = 512
    min_first_attempts: int = 16

    def __post_init__(self) -> None:
        if self.fraction is not None and not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"retry budget fraction must be in [0, 1], got "
                f"{self.fraction}"
            )
        if self.window <= 0:
            raise ValueError("retry budget window must be positive")
        if self.min_first_attempts < 0:
            raise ValueError("min_first_attempts must be >= 0")


class RetryBudget:
    """Per-deployment amplification ledger; thread-safe; clock-free.

    Shared by FailoverManager (backoff retries), HedgeManager (hedge
    fires), and the sim twin's client-retry model — one ledger per
    deployment so every amplifier draws from the same pool.
    """

    def __init__(self, deployment: str,
                 policy: Optional[RetryBudgetPolicy] = None) -> None:
        self.deployment = deployment
        self.policy = policy or RetryBudgetPolicy()
        # Same rank as the RollingSketch epoch state it mirrors: consulted
        # under router_pool/failover locks, bumps metrics inside.
        self._lock = OrderedLock("sketch")
        self._congested = False
        # Two-epoch rotation (utils.sketch.RollingSketch discipline):
        # "recent" = previous epoch + current epoch, rotated every
        # `window` first attempts.
        self._cur_first = 0
        self._prev_first = 0
        self._cur_spent = 0
        self._prev_spent = 0
        # Cumulative observability (never rotated).
        self._granted: Dict[str, int] = {}
        self._denied: Dict[str, int] = {}
        self._first_total = 0

    # --- accounting --------------------------------------------------------
    def record_first_attempt(self, n: int = 1) -> None:
        """A first dispatch happened: it funds the budget, never draws
        from it."""
        with self._lock:
            self._cur_first += n
            self._first_total += n
            if self._cur_first >= self.policy.window:
                self._prev_first = self._cur_first
                self._prev_spent = self._cur_spent
                self._cur_first = 0
                self._cur_spent = 0

    def try_spend(self, kind: str = "retry") -> bool:
        """Check-and-consume one re-dispatch. ``kind`` is observability
        only ("retry" | "hedge" | "requeue"); all kinds draw from the
        one pool — a hedge and a retry amplify identically."""
        with self._lock:
            if self._congested:
                # Governor verdict outranks the fraction in BOTH modes:
                # while first-attempt attainment is under floor, zero
                # re-dispatches is the only monotone-recovery answer.
                self._denied[kind] = self._denied.get(kind, 0) + 1
                RETRY_BUDGET_TOTAL.inc(tags={
                    "deployment": self.deployment, "kind": kind,
                    "outcome": "denied_congested",
                })
                return False
            frac = self.policy.fraction
            recent_first = self._prev_first + self._cur_first
            recent_spent = self._prev_spent + self._cur_spent
            if (
                frac is not None
                and recent_first >= self.policy.min_first_attempts
                and recent_spent + 1 > frac * recent_first
            ):
                self._denied[kind] = self._denied.get(kind, 0) + 1
                RETRY_BUDGET_TOTAL.inc(tags={
                    "deployment": self.deployment, "kind": kind,
                    "outcome": "denied",
                })
                return False
            self._cur_spent += 1
            self._granted[kind] = self._granted.get(kind, 0) + 1
            RETRY_BUDGET_TOTAL.inc(tags={
                "deployment": self.deployment, "kind": kind,
                "outcome": "granted",
            })
            return True

    # --- governor coupling -------------------------------------------------
    def set_congested(self, congested: bool) -> None:
        """Driven by the overload governor's `congested` hysteresis
        (serve/admission.py): True zeroes the budget, False restores the
        configured fraction. Idempotent."""
        with self._lock:
            if congested == self._congested:
                return
            self._congested = congested
        RETRY_BUDGET_CONGESTED.set(
            1.0 if congested else 0.0,
            tags={"deployment": self.deployment},
        )

    @property
    def congested(self) -> bool:
        with self._lock:
            return self._congested

    # --- config / observability --------------------------------------------
    def reconfigure(self, policy: RetryBudgetPolicy) -> None:
        """Redeploy repricing (controller._apply_router_policies): swap
        the knobs, keep the ledger — history stays honest across a knob
        change."""
        with self._lock:
            self.policy = policy

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enforcing": self.policy.fraction is not None,
                "fraction": self.policy.fraction,
                "congested": self._congested,
                "recent_first_attempts":
                    self._prev_first + self._cur_first,
                "recent_redispatches":
                    self._prev_spent + self._cur_spent,
                "first_attempts_total": self._first_total,
                "granted": dict(self._granted),
                "denied": dict(self._denied),
            }
