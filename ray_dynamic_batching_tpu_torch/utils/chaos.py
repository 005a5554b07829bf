"""Fault-injection hooks — the ``RAY_testing_rpc_failure`` equivalent.

Own copy of ``ray_dynamic_batching_tpu/utils/chaos.py`` with its import
paths rewritten, whole; the ``RDB_TESTING_*`` variable names are the
reference's, so one environment arms both packages.

The reference injects request/response failures at the RPC layer from an
env spec (``src/ray/rpc/rpc_chaos.h:23-31``, parsed at ``rpc_chaos.cc:32``:
``RAY_testing_rpc_failure=method1=N,method2=M``). Here the injection points
are the framework's own boundaries (replica batch execution, replica loop,
router assignment, ingress handling), named and budgeted the same way:

    RDB_TESTING_FAILURE="replica.process_batch=3,replica.loop=1"

Each ``point=N`` allows at most N injected failures (-1 = unlimited); an
optional ``:p<float>`` suffix makes injection probabilistic
(``point=5:p0.5`` — up to 5 failures, each opportunity failing with
probability 0.5). Injection is a no-op unless configured, so production
paths pay one dict lookup.

**Gray-failure (slowdown) modes**: binary death misses the
failures that actually erode SLO attainment — a replica running 5-10x
slow, a stall before the first token, a stream that never EOSes. A
second spec injects those, same grammar plus a mode suffix:

    RDB_TESTING_SLOWDOWN="replica.process_batch=-1:mult10"
    RDB_TESTING_SLOWDOWN="replica.process_batch=3:stall50:p0.5"
    RDB_TESTING_SLOWDOWN="replica.process_batch@soak#0=-1:mult10"

Modes: ``mult<F>`` (latency_multiplier — the batch takes F x as long),
``stall<MS>`` (stall_before_first_token — MS ms dead air before
execution), ``stuck<MS>`` (stuck_stream — output produced, EOS withheld
for MS ms). A ``point@instance`` key targets ONE replica/engine (the
straggler soak slows one replica of three); instance-less keys hit every
caller of the point. Probabilistic draws use the same seeded RNG
discipline as failures (``config.chaos_seed``), so a slowdown schedule
replays byte-identically.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

ENV_VAR = "RDB_TESTING_FAILURE"
SLOWDOWN_ENV_VAR = "RDB_TESTING_SLOWDOWN"
# Query-of-death injection: a batch whose payloads carry the
# poison marker raises at execution, driving the replica's bisection +
# quarantine path end-to-end. Grammar: ``point=N[:pP]`` — the first N
# DISTINCT marked requests seen at the point are armed as poisonous;
# an armed marker keeps failing every re-execution that contains it
# (bisection probes included), which is what makes isolation possible.
POISON_ENV_VAR = "RDB_TESTING_POISON"
# Payload marker: a dict payload with this key truthy (or a string
# payload containing the token) is poison-eligible. The VALUE of the
# marker is the poison's identity — distinct values are distinct
# poisons against the injection budget.
POISON_MARKER = "__rdb_poison__"

SLOWDOWN_MODES = (
    "latency_multiplier", "stall_before_first_token", "stuck_stream",
)


@dataclass(frozen=True)
class Slowdown:
    """One degradation verdict: HOW to be slow (the degradation
    taxonomy shared with ``sim.simulator.EngineDegradation``)."""

    mode: str                  # one of SLOWDOWN_MODES
    factor: float = 1.0        # latency_multiplier: execution time x F
    ms: float = 0.0            # stall/stuck: milliseconds of dead air


def _parse_slowdown_mode(token: str) -> Slowdown:
    if token.startswith("mult"):
        factor = float(token[4:])
        if factor < 1.0:
            raise ValueError(f"mult factor must be >= 1, got {factor}")
        return Slowdown("latency_multiplier", factor=factor)
    if token.startswith("stall"):
        return Slowdown("stall_before_first_token", ms=float(token[5:]))
    if token.startswith("stuck"):
        return Slowdown("stuck_stream", ms=float(token[5:]))
    raise ValueError(
        f"bad slowdown mode {token!r} (want mult<F>|stall<MS>|stuck<MS>)"
    )


class ChaosInjected(RuntimeError):
    """Raised at an injection point whose failure budget fired."""


class PoisonInjected(RuntimeError):
    """Raised by a batch execution containing an armed poison marker.

    Deliberately NOT a :class:`ChaosInjected` subclass: chaos failures
    classify *retryable* (the payload was never the problem) while a
    poison is the payload itself — it must reach the replica's
    non-retryable path so bisection, not failover, handles it."""


class ChaosInjector:
    def __init__(self, spec: Optional[str] = None,
                 seed: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._budgets: Dict[str, int] = {}
        self._probs: Dict[str, float] = {}
        self._fired: Dict[str, int] = {}
        # Probabilistic injections draw from a dedicated seeded RNG so a
        # chaos run replays deterministically; the seed comes from
        # ``config.chaos_seed`` (RDB_CHAOS_SEED) unless given explicitly.
        self._seed = seed if seed is not None else self._config_seed()
        self._rng = random.Random(self._seed)
        self._active = False  # unlocked fast-path flag for hot callers
        # Slowdown (gray-failure) injection state: its own budgets, fired
        # counts, seeded RNG and fast-path flag — a failure budget and a
        # slowdown budget on the same point are independent.
        self._slow: Dict[str, Tuple[int, float, Slowdown]] = {}
        self._slow_fired: Dict[str, int] = {}
        self._slow_rng = random.Random(self._seed)
        self._slow_active = False
        # Poison (query-of-death) injection state: budgets count DISTINCT
        # armed markers; an armed marker stays poisonous for every later
        # execution containing it (bisection needs the fault to follow
        # the request through probe subsets deterministically).
        self._poison_budgets: Dict[str, int] = {}
        self._poison_probs: Dict[str, float] = {}
        self._poison_armed: Dict[str, set] = {}
        self._poison_fired: Dict[str, int] = {}
        self._poison_rng = random.Random(self._seed)
        self._poison_active = False
        self.configure(spec if spec is not None else os.environ.get(ENV_VAR, ""))
        self.configure_slowdowns(os.environ.get(SLOWDOWN_ENV_VAR, ""))
        self.configure_poisons(os.environ.get(POISON_ENV_VAR, ""))

    @staticmethod
    def _config_seed() -> int:
        from ray_dynamic_batching_tpu_torch.utils.config import get_config

        return get_config().chaos_seed

    def configure(self, spec: str, seed: Optional[int] = None) -> None:
        """Parse ``point=N[:pP],point2=M`` (reference rpc_chaos.cc:32).
        Parses fully before swapping state, so an invalid spec leaves the
        previous configuration untouched. Every (re)configure reseeds the
        injection RNG — same spec + same seed replays the same failure
        schedule (``seed`` overrides the configured default)."""
        budgets: Dict[str, int] = {}
        probs: Dict[str, float] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"bad chaos spec entry {part!r}")
            point, rhs = part.split("=", 1)
            prob = 1.0
            if ":p" in rhs:
                rhs, prob_s = rhs.split(":p", 1)
                prob = float(prob_s)
            budgets[point.strip()] = int(rhs)
            probs[point.strip()] = prob
        with self._lock:
            self._budgets = budgets
            self._probs = probs
            self._fired = {}
            if seed is not None:
                self._seed = seed
            self._rng = random.Random(self._seed)
            self._active = bool(budgets)

    def should_fail(self, point: str) -> bool:
        """Consume one unit of the point's failure budget (thread-safe).
        Free when chaos is unconfigured: one unlocked attribute read."""
        if not self._active:  # rdb-lint: disable=lock-discipline (unconfigured fast path: arming flips in quiesced configure(); one-op staleness only shifts chaos onset by one call)
            return False
        with self._lock:
            budget = self._budgets.get(point)
            if budget is None or budget == 0:
                return False
            if self._probs.get(point, 1.0) < 1.0:
                if self._rng.random() >= self._probs[point]:
                    return False
            if budget > 0:
                self._budgets[point] = budget - 1
            self._fired[point] = self._fired.get(point, 0) + 1
            return True

    def maybe_fail(self, point: str) -> None:
        if self.should_fail(point):
            raise ChaosInjected(f"chaos injected at {point}")

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)

    # --- slowdown (gray-failure) injection --------------------------------
    def configure_slowdowns(self, spec: str,
                            seed: Optional[int] = None) -> None:
        """Parse ``point[@instance]=N:mode[:pP],...``. Same all-or-
        nothing swap and reseed-on-configure discipline as
        :meth:`configure`: same spec + same seed replays the same
        slowdown schedule byte-identically (the seeded-replay pin)."""
        table: Dict[str, Tuple[int, float, Slowdown]] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"bad slowdown spec entry {part!r}")
            point, rhs = part.split("=", 1)
            prob = 1.0
            tokens = rhs.split(":")
            if len(tokens) < 2:
                raise ValueError(
                    f"slowdown entry {part!r} needs a mode "
                    "(point=N:mult<F>|stall<MS>|stuck<MS>[:pP])"
                )
            if len(tokens) > 2:
                if not tokens[2].startswith("p"):
                    raise ValueError(
                        f"bad slowdown suffix {tokens[2]!r} (want p<float>)"
                    )
                prob = float(tokens[2][1:])
            table[point.strip()] = (
                int(tokens[0]), prob, _parse_slowdown_mode(tokens[1])
            )
        with self._lock:
            self._slow = table
            self._slow_fired = {}
            if seed is not None:
                self._seed = seed
            self._slow_rng = random.Random(self._seed)
            self._slow_active = bool(table)

    def slowdown(self, point: str,
                 instance: Optional[str] = None) -> Optional[Slowdown]:
        """The degradation to apply at this point right now, or None.
        ``point@instance`` entries outrank bare ``point`` entries so a
        spec can slow exactly one replica of a fleet. Consumes one unit
        of the matched entry's budget. Free when unconfigured: one
        unlocked attribute read."""
        if not self._slow_active:  # rdb-lint: disable=lock-discipline (unconfigured fast path: arming flips in quiesced configure(); one-op staleness only shifts chaos onset by one call)
            return None
        keys = ([f"{point}@{instance}"] if instance is not None else [])
        keys.append(point)
        with self._lock:
            for key in keys:
                entry = self._slow.get(key)
                if entry is None:
                    continue
                budget, prob, verdict = entry
                if budget == 0:
                    continue
                if prob < 1.0 and self._slow_rng.random() >= prob:
                    return None  # this opportunity drew a pass
                if budget > 0:
                    self._slow[key] = (budget - 1, prob, verdict)
                self._slow_fired[key] = self._slow_fired.get(key, 0) + 1
                return verdict
            return None

    def slowdown_fired(self, point: str,
                       instance: Optional[str] = None) -> int:
        key = f"{point}@{instance}" if instance is not None else point
        with self._lock:
            return self._slow_fired.get(key, 0)

    # --- poison (query-of-death) injection --------------------------------
    def configure_poisons(self, spec: str,
                          seed: Optional[int] = None) -> None:
        """Parse ``point=N[:pP],...`` — same grammar and all-or-nothing
        swap/reseed discipline as :meth:`configure`. ``N`` bounds how
        many DISTINCT poison markers may arm at the point (-1 =
        unlimited); ``:pP`` makes each arming opportunity probabilistic
        over the seeded RNG."""
        budgets: Dict[str, int] = {}
        probs: Dict[str, float] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"bad poison spec entry {part!r}")
            point, rhs = part.split("=", 1)
            prob = 1.0
            if ":p" in rhs:
                rhs, prob_s = rhs.split(":p", 1)
                prob = float(prob_s)
            budgets[point.strip()] = int(rhs)
            probs[point.strip()] = prob
        with self._lock:
            self._poison_budgets = budgets
            self._poison_probs = probs
            self._poison_armed = {}
            self._poison_fired = {}
            if seed is not None:
                self._seed = seed
            self._poison_rng = random.Random(self._seed)
            self._poison_active = bool(budgets)

    @staticmethod
    def poison_marker(payload) -> Optional[str]:
        """The payload's poison identity, or None. Dict payloads carry
        ``{POISON_MARKER: <id>}``; string payloads embed the token."""
        if isinstance(payload, dict):
            marker = payload.get(POISON_MARKER)
            if marker:
                return str(marker)
            return None
        if isinstance(payload, str) and POISON_MARKER in payload:
            return payload
        return None

    def poison_verdict(self, point: str, payloads) -> Optional[int]:
        """Index of the first poisonous payload in this execution, or
        None. An already-armed marker fires WITHOUT consuming budget (a
        poison stays poisonous — that is what bisection relies on); an
        unarmed marker arms iff the point's distinct-marker budget and
        probability allow. Free when unconfigured: one unlocked read."""
        if not self._poison_active:  # rdb-lint: disable=lock-discipline (unconfigured fast path: arming flips in quiesced configure_poisons(); one-op staleness only shifts poison onset by one call)
            return None
        with self._lock:
            budget = self._poison_budgets.get(point)
            if budget is None:
                return None
            armed = self._poison_armed.setdefault(point, set())
            for idx, payload in enumerate(payloads):
                marker = self.poison_marker(payload)
                if marker is None:
                    continue
                if marker in armed:
                    self._poison_fired[point] = \
                        self._poison_fired.get(point, 0) + 1
                    return idx
                if budget == 0:
                    continue
                prob = self._poison_probs.get(point, 1.0)
                if prob < 1.0 and self._poison_rng.random() >= prob:
                    continue
                armed.add(marker)
                if budget > 0:
                    self._poison_budgets[point] = budget - 1
                    budget -= 1
                self._poison_fired[point] = \
                    self._poison_fired.get(point, 0) + 1
                return idx
            return None

    def maybe_poison(self, point: str, payloads) -> None:
        idx = self.poison_verdict(point, payloads)
        if idx is not None:
            raise PoisonInjected(
                f"poison injected at {point} (batch index {idx})"
            )

    def poison_fired(self, point: str) -> int:
        with self._lock:
            return self._poison_fired.get(point, 0)

    @property
    def active(self) -> bool:
        return self._active  # rdb-lint: disable=lock-discipline (observability read of the arming flag; torn/stale by one op is benign)


_GLOBAL: Optional[ChaosInjector] = None
_GLOBAL_LOCK = threading.Lock()


def chaos() -> ChaosInjector:
    """Process-global injector, configured from the environment on first
    use (mirrors the reference's static init)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = ChaosInjector()
    return _GLOBAL


def reset_chaos(spec: str = "", seed: Optional[int] = None,
                slowdown: str = "", poison: str = "") -> ChaosInjector:
    """Re-configure (and optionally reseed) the global injector (tests /
    soak harnesses): ``reset_chaos(spec, seed=N)`` pins the probabilistic
    failure schedule for a deterministic replay. ``slowdown`` carries the
    gray-failure spec and ``poison`` the query-of-death spec — both
    cleared by default, so every existing ``reset_chaos("")`` teardown
    also disarms them."""
    inj = chaos()
    inj.configure(spec, seed=seed)
    inj.configure_slowdowns(slowdown, seed=seed)
    inj.configure_poisons(poison, seed=seed)
    return inj
