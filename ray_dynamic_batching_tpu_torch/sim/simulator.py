"""Scenario + Simulation — one what-if run, end to end.

A :class:`Scenario` is everything a run needs besides the profile
tables: the model contracts (SLO, seq bucket), the traffic (synthetic
``RatePattern`` per model, or an explicit arrival list recorded from a
live run), the cluster size, the control-loop knobs, and the seed.
:class:`Simulation` wires the virtual-clock substrate under the REAL
planner stack and runs the event loop to the horizon:

    profiles -> SquishyBinPacker -> decide_replan     (live planner code)
    RateRegistry(clock=virtual) -> changed_models     (live rate code)
    SimQueueManager / SimEngine                       (live semantics, §sim/)
    AuditLog(now=virtual)                             (live audit ring)

The output is a plain dict; ``sim.report.render_json`` renders it
byte-deterministically. Same profiles + same scenario => same bytes.

Own copy of ``ray_dynamic_batching_tpu/sim/simulator.py``, whole, with
its import paths rewritten. Its scheduler plans by the port's rule
(``sim/control.py``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_dynamic_batching_tpu_torch.engine.request import (
    DEFAULT_QOS_CLASS,
    DEFAULT_TENANT,
    QOS_RANK,
)
from ray_dynamic_batching_tpu_torch.engine.workload import RatePattern
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
from ray_dynamic_batching_tpu_torch.scheduler.nexus import SquishyBinPacker
from ray_dynamic_batching_tpu_torch.sim.clock import EventLoop, VirtualClock
from ray_dynamic_batching_tpu_torch.sim.control import SimScheduler
from ray_dynamic_batching_tpu_torch.sim.engine import SimEngine
from ray_dynamic_batching_tpu_torch.sim.queue import SimQueueManager
from ray_dynamic_batching_tpu_torch.scheduler.replan import weighted_attainment
from ray_dynamic_batching_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
)
from ray_dynamic_batching_tpu_torch.sim.report import slo_attainment
from ray_dynamic_batching_tpu_torch.sim.workload import (
    Arrival,
    draw_qos,
    merge_arrivals,
    scale_arrivals,
    synthetic_arrivals,
)

# RatePattern knobs a scenario dict may set (everything but kind/seed).
_PATTERN_FIELDS = (
    "base_rps", "slope", "amplitude", "period_s", "step_at_s",
    "jitter", "spike_at_s", "spike_len_s",
)


# Keys a model entry may carry; anything else is a typo'd knob and a
# silently-defaulted what-if is a confidently wrong one — reject loudly.
_MODEL_KEYS = frozenset(
    ("name", "slo_ms", "seq_len", "rate_rps", "pattern", "poisson",
     "class_mix", "tenant", "mesh_shape", "spec", "spec_acceptance",
     "spec_tokens", "long_frac", "long_prefill_ms")
    + _PATTERN_FIELDS
)

# AdmissionPolicy knobs a scenario's "admission" object may set.
_ADMISSION_KEYS = frozenset(
    ("rate_rps", "burst", "degraded_class_fractions", "depth_high",
     "depth_low", "compliance_low", "compliance_high", "max_tenants",
     "congested_floor", "congested_exit")
)


@dataclass
class SimModelSpec:
    """One model's serving contract + its synthetic traffic shape."""

    name: str
    slo_ms: float
    seq_len: int = 0
    pattern: Optional[RatePattern] = None   # None when arrivals are explicit
    poisson: bool = True
    # QoS traffic mix: class -> fraction of this model's arrivals (empty =
    # everything at the default class). Tagging is seeded per model, so
    # the same scenario always produces the same per-request classes.
    class_mix: Dict[str, float] = None
    tenant: str = DEFAULT_TENANT
    # Preferred serving mesh shape ("1x4" = a 4-chip TP slice priced
    # from the profile table's mesh rows; ROADMAP item 2). "1x1" keeps
    # the classic single-chip contract.
    mesh_shape: str = "1x1"
    # Speculative serving arm: spec=True prices and executes
    # this model through its spec profile rows at spec_acceptance (the
    # PROFILED draft-token acceptance rate — what an on-chip capture's
    # rdb_decode_spec_acceptance gauge read). AcceptanceCollapse events
    # move the LIVE rate out from under this belief mid-run.
    spec: bool = False
    spec_acceptance: float = 0.7
    spec_tokens: int = 4
    # Long-prompt mix: ``long_frac`` of this model's arrivals
    # carry ``long_prefill_ms`` of prefill cost beyond the profile row
    # (a seeded per-model draw — deterministic, independent of
    # interleaving). How that cost executes is the SCENARIO's
    # ``prefill_mode`` (mono head-of-line vs budgeted chunk events).
    long_frac: float = 0.0
    long_prefill_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.class_mix is None:
            self.class_mix = {}
        unknown = set(self.class_mix) - set(QOS_RANK)
        if unknown:
            raise ValueError(
                f"{self.name}: unknown qos class(es) {sorted(unknown)} in "
                f"class_mix (known: {sorted(QOS_RANK)})"
            )
        if self.class_mix and sum(self.class_mix.values()) <= 0:
            raise ValueError(
                f"{self.name}: class_mix fractions must sum > 0"
            )
        if not 0.0 <= self.long_frac <= 1.0:
            raise ValueError(
                f"{self.name}: long_frac must be in [0, 1]"
            )
        if self.long_frac > 0.0 and self.long_prefill_ms <= 0.0:
            raise ValueError(
                f"{self.name}: long_frac > 0 needs long_prefill_ms > 0"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any], seed: int = 0) -> "SimModelSpec":
        unknown = set(d) - _MODEL_KEYS
        if unknown:
            raise ValueError(
                f"unknown model key(s) {sorted(unknown)} for "
                f"{d.get('name', '<unnamed>')!r}; known: "
                f"{sorted(_MODEL_KEYS)}"
            )
        pattern = None
        if "rate_rps" in d or "pattern" in d:
            kwargs = {k: d[k] for k in _PATTERN_FIELDS if k in d}
            if "rate_rps" in d:
                kwargs["base_rps"] = float(d["rate_rps"])
            pattern = RatePattern(
                kind=d.get("pattern", "constant"), seed=seed, **kwargs
            )
        return cls(
            name=d["name"],
            slo_ms=float(d["slo_ms"]),
            seq_len=int(d.get("seq_len", 0)),
            pattern=pattern,
            poisson=bool(d.get("poisson", True)),
            class_mix={k: float(v)
                       for k, v in dict(d.get("class_mix", {})).items()},
            tenant=str(d.get("tenant", DEFAULT_TENANT)),
            mesh_shape=str(d.get("mesh_shape", "1x1")),
            spec=bool(d.get("spec", False)),
            spec_acceptance=float(d.get("spec_acceptance", 0.7)),
            spec_tokens=int(d.get("spec_tokens", 4)),
            long_frac=float(d.get("long_frac", 0.0)),
            long_prefill_ms=float(d.get("long_prefill_ms", 0.0)),
        )


@dataclass
class EngineFailure:
    """One injected engine death: the engine indexed ``engine`` dies at
    virtual time ``at_s`` (the sim analogue of an injected
    ``replica.loop`` crash / a chaos-killed worker). The scheduler's
    monitor detects it at its next tick and replans over survivors.

    ``chip`` (slice scenarios only) names WHICH chip of a multi-chip
    slice dies: the whole slice fails (SliceDeadError semantics), and
    the surviving chips re-form as narrower slices at the heal tick."""

    at_s: float
    engine: int
    chip: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineFailure":
        unknown = set(d) - {"at_s", "engine", "chip"}
        if unknown:
            raise ValueError(
                f"unknown failure key(s) {sorted(unknown)}; "
                "known: ['at_s', 'engine', 'chip']"
            )
        return cls(at_s=float(d["at_s"]), engine=int(d["engine"]),
                   chip=(None if d.get("chip") is None
                         else int(d["chip"])))


@dataclass
class EngineDegradation:
    """One injected GRAY failure: from ``at_s`` the engine runs every
    step at ``factor x`` its profiled latency plus ``stall_ms`` of dead
    air, while still answering ``healthy()`` — the sim twin of the live
    ``RDB_TESTING_SLOWDOWN`` modes (a thermally throttled chip, a slow
    HBM lane). ``heal_at_s`` ends the episode (None = degraded to the
    horizon), so probation-then-reclaim stories are expressible. The
    gray monitor — not liveness — must catch it."""

    at_s: float
    engine: int
    factor: float = 1.0
    stall_ms: float = 0.0
    heal_at_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.factor < 1.0:
            raise ValueError(
                f"degradation factor must be >= 1, got {self.factor}"
            )
        if self.heal_at_s is not None and self.heal_at_s <= self.at_s:
            raise ValueError(
                f"heal_at_s ({self.heal_at_s}) must be after at_s "
                f"({self.at_s})"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineDegradation":
        known = {"at_s", "engine", "factor", "stall_ms", "heal_at_s"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown degradation key(s) {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        return cls(
            at_s=float(d["at_s"]),
            engine=int(d["engine"]),
            factor=float(d.get("factor", 1.0)),
            stall_ms=float(d.get("stall_ms", 0.0)),
            heal_at_s=(None if d.get("heal_at_s") is None
                       else float(d["heal_at_s"])),
        )


@dataclass
class AcceptanceCollapse:
    """One injected speculative-acceptance collapse (chaos):
    from ``at_s`` the named model's LIVE draft-token acceptance rate
    drops to ``rate`` (adversarial prompts the draft cannot predict —
    the planner keeps pricing at the PROFILED rate), recovering to the
    model's ``spec_acceptance`` at ``heal_at_s`` (None = collapsed to
    the horizon). The gate's claim: throughput degrades to within a
    bounded factor of the non-spec paged arm — a verify round always
    emits >= 1 token — never off a cliff, with zero client-visible
    errors."""

    at_s: float
    model: str
    rate: float = 0.0
    heal_at_s: Optional[float] = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(
                f"collapse rate must be in [0, 1], got {self.rate}"
            )
        if self.heal_at_s is not None and self.heal_at_s <= self.at_s:
            raise ValueError(
                f"heal_at_s ({self.heal_at_s}) must be after at_s "
                f"({self.at_s})"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AcceptanceCollapse":
        known = {"at_s", "model", "rate", "heal_at_s"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown collapse key(s) {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        return cls(
            at_s=float(d["at_s"]),
            model=str(d["model"]),
            rate=float(d.get("rate", 0.0)),
            heal_at_s=(None if d.get("heal_at_s") is None
                       else float(d["heal_at_s"])),
        )


@dataclass
class PoisonInjection:
    """One injected query of death: at ``at_s`` a poison
    request is submitted to ``model`` — any batch executing it fails,
    and the engine pays ceil(log2 B) bisection probes plus a rescue
    pass to isolate it (the live replica's quarantine path, priced at
    virtual time). ``repeat_at_s`` resubmits the SAME poison later: the
    scenario's claim is that the repeat is fenced at the front door
    (quarantine gossip), never poisoning a second batch."""

    at_s: float
    model: str
    poison_id: str = ""
    qos_class: str = DEFAULT_QOS_CLASS
    repeat_at_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.at_s < 0:
            raise ValueError(f"poison at_s must be >= 0, got {self.at_s}")
        if self.repeat_at_s is not None and self.repeat_at_s <= self.at_s:
            raise ValueError(
                f"repeat_at_s ({self.repeat_at_s}) must be after at_s "
                f"({self.at_s})"
            )
        if self.qos_class not in QOS_RANK:
            raise ValueError(
                f"poison qos_class {self.qos_class!r} unknown "
                f"(known: {sorted(QOS_RANK)})"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PoisonInjection":
        known = {"at_s", "model", "poison_id", "qos_class", "repeat_at_s"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown poison key(s) {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        return cls(
            at_s=float(d["at_s"]),
            model=str(d["model"]),
            poison_id=str(d.get("poison_id", "")),
            qos_class=str(d.get("qos_class", DEFAULT_QOS_CLASS)),
            repeat_at_s=(None if d.get("repeat_at_s") is None
                         else float(d["repeat_at_s"])),
        )


# Client-retry model knobs a scenario's "retry" object may set
# (SimScheduler.enable_retries parameters).
_RETRY_KEYS = frozenset(
    ("max_attempts", "backoff_ms", "budget_fraction", "budget_window",
     "min_first_attempts")
)


@dataclass
class Scenario:
    """One simulated deployment under one traffic story."""

    models: List[SimModelSpec]
    duration_s: float = 60.0
    drain_s: float = 5.0
    n_engines: int = 2
    # Slice widths per schedulable unit (ROADMAP item 2): [4, 2, 1, 1]
    # = one 4-chip TP slice, one half-slice, two single chips
    # (len == n_engines). None = the classic all-singles cluster.
    engine_widths: Optional[List[int]] = None
    seed: int = 0
    rate_scale: float = 1.0          # the "at 2x traffic?" knob
    max_queue_len: int = 4096
    monitoring_interval_s: float = 5.0
    rate_threshold: float = 0.05
    rate_decrease_multiplier: float = 2.0
    rate_window_s: float = 10.0
    rate_min_span_s: float = 0.0     # cold-window replan guard (live knob)
    hbm_budget_bytes: int = 12 << 30
    # Planner knobs pinned IN the scenario (not read from ambient
    # RDBConfig): a what-if report must not change because some other
    # code in the process mutated the global config.
    slo_safety_factor: float = 2.2   # live default (ref SLO_hack=2.2)
    slo_compute_fraction: float = 0.5
    hbm_plan_fraction: float = 0.9
    warm_start: bool = True          # initial manual rebalance at t=0
    latency_jitter: bool = False     # seeded gaussian around row means
    # Decode cost model (sim/engine.py): "batch" = slab pricing (every
    # pop costs the full profile row), "slot" = paged/continuous pricing
    # (partially-full turns cost their fill-scaled share above the
    # fill-invariant floor). Slot occupancy is reported in BOTH modes.
    decode_occupancy_model: str = "batch"
    occupancy_floor: float = 0.35
    # Prefill interleave model: "mono" executes a long
    # request's prefill inside its popped turn (head-of-line blocking —
    # the legacy admission); "chunked" spends it as
    # ``prefill_chunk_ms x prefill_chunks_per_turn`` virtual-clock
    # chunk events between cycles — the token-budget scheduler's twin.
    # The packer prices chunk-interleaved turns via
    # Session.prefill_chunk_ms when chunked.
    prefill_mode: str = "mono"
    prefill_chunk_ms: float = 0.0
    prefill_chunks_per_turn: int = 1
    # Injected engine deaths (chaos conformance): each kills one sim
    # engine at virtual time t; the monitor heals over survivors.
    failures: List[EngineFailure] = field(default_factory=list)
    # Injected GRAY failures (straggler conformance): slowdowns the gray
    # monitor — not liveness — must catch.
    degradations: List[EngineDegradation] = field(default_factory=list)
    # Injected speculative-acceptance collapses (chaos):
    # adversarial traffic drives a model's LIVE acceptance toward 0
    # while the planner keeps its profiled belief.
    spec_collapses: List[AcceptanceCollapse] = field(default_factory=list)
    # Injected queries of death: each poisons one batch;
    # bisection isolates it at ceil(log2 B) probe cost and repeats are
    # fenced at the front door.
    poisons: List[PoisonInjection] = field(default_factory=list)
    # Client-retry model knobs (SimScheduler.enable_retries
    # parameters). None = no retry loop: canon scenarios stay
    # byte-identical. budget_fraction=None inside the dict models naive
    # unbounded clients — the metastable control arm.
    retry: Optional[Dict[str, Any]] = None

    def retry_config(self) -> Optional[Dict[str, Any]]:
        if self.retry is None:
            return None
        unknown = set(self.retry) - _RETRY_KEYS
        if unknown:
            raise ValueError(
                f"unknown retry key(s) {sorted(unknown)}; known: "
                f"{sorted(_RETRY_KEYS)}"
            )
        return {
            "max_attempts": int(self.retry.get("max_attempts", 3)),
            "backoff_ms": float(self.retry.get("backoff_ms", 50.0)),
            "budget_fraction": (
                None if self.retry.get("budget_fraction") is None
                else float(self.retry["budget_fraction"])
            ),
            "budget_window": int(self.retry.get("budget_window", 512)),
            "min_first_attempts": int(
                self.retry.get("min_first_attempts", 16)
            ),
        }
    # Gray-detection knobs (serve/grayhealth.GrayHealthPolicy fields).
    # None = detection disabled: canon scenarios stay byte-identical.
    gray: Optional[Dict[str, Any]] = None

    def gray_policy(self):
        from ray_dynamic_batching_tpu_torch.serve.grayhealth import (
            GrayHealthPolicy,
        )
        import dataclasses as _dc

        if self.gray is None:
            return None
        known = {f.name for f in _dc.fields(GrayHealthPolicy)}
        unknown = set(self.gray) - known
        if unknown:
            raise ValueError(
                f"unknown gray key(s) {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        return GrayHealthPolicy(**self.gray)
    # Token-bucket admission + overload governor, applied per model
    # (serve/admission.AdmissionPolicy knobs; None = admit everything).
    # The LIVE AdmissionController runs here on the virtual clock.
    admission: Optional[Dict[str, Any]] = None
    # SLO observatory knobs (serve/observatory.ObservatoryPolicy fields).
    # None = disabled: canon scenarios stay byte-identical. The LIVE
    # observatory classes run here on the virtual clock.
    observatory: Optional[Dict[str, Any]] = None

    def observatory_policy(self):
        from ray_dynamic_batching_tpu_torch.serve.observatory import (
            ObservatoryPolicy,
        )
        import dataclasses as _dc

        if self.observatory is None:
            return None
        known = {f.name for f in _dc.fields(ObservatoryPolicy)}
        unknown = set(self.observatory) - known
        if unknown:
            raise ValueError(
                f"unknown observatory key(s) {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        return ObservatoryPolicy(**self.observatory)
    arrivals: Optional[List[Arrival]] = field(default=None, repr=False)

    def admission_policy(self) -> Optional[AdmissionPolicy]:
        if self.admission is None:
            return None
        unknown = set(self.admission) - _ADMISSION_KEYS
        if unknown:
            raise ValueError(
                f"unknown admission key(s) {sorted(unknown)}; known: "
                f"{sorted(_ADMISSION_KEYS)}"
            )
        kwargs = dict(self.admission)
        if "degraded_class_fractions" in kwargs:
            kwargs["degraded_class_fractions"] = {
                k: float(v)
                for k, v in dict(kwargs["degraded_class_fractions"]).items()
            }
        return AdmissionPolicy(**kwargs)

    # Loader-level keys (profiles/arrivals paths) ride in the same JSON
    # object; everything else must be a real Scenario field.
    _LOADER_KEYS = frozenset({"profiles", "profiles_dir", "arrivals",
                              "_comment"})

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        import dataclasses as _dc

        known = {f.name for f in _dc.fields(cls)} | cls._LOADER_KEYS
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown scenario key(s) {sorted(unknown)}; known: "
                f"{sorted(known - cls._LOADER_KEYS)}"
            )
        seed = int(d.get("seed", 0))
        return cls(
            models=[
                SimModelSpec.from_dict(m, seed=seed + i)
                for i, m in enumerate(d["models"])
            ],
            duration_s=float(d.get("duration_s", 60.0)),
            drain_s=float(d.get("drain_s", 5.0)),
            n_engines=int(d.get("n_engines", 2)),
            engine_widths=(
                None if d.get("engine_widths") is None
                else [int(w) for w in d["engine_widths"]]
            ),
            seed=seed,
            rate_scale=float(d.get("rate_scale", 1.0)),
            max_queue_len=int(d.get("max_queue_len", 4096)),
            monitoring_interval_s=float(d.get("monitoring_interval_s", 5.0)),
            rate_threshold=float(d.get("rate_threshold", 0.05)),
            rate_decrease_multiplier=float(
                d.get("rate_decrease_multiplier", 2.0)
            ),
            rate_window_s=float(d.get("rate_window_s", 10.0)),
            rate_min_span_s=float(d.get("rate_min_span_s", 0.0)),
            hbm_budget_bytes=int(d.get("hbm_budget_bytes", 12 << 30)),
            slo_safety_factor=float(d.get("slo_safety_factor", 2.2)),
            slo_compute_fraction=float(d.get("slo_compute_fraction", 0.5)),
            hbm_plan_fraction=float(d.get("hbm_plan_fraction", 0.9)),
            warm_start=bool(d.get("warm_start", True)),
            latency_jitter=bool(d.get("latency_jitter", False)),
            decode_occupancy_model=str(
                d.get("decode_occupancy_model", "batch")
            ),
            occupancy_floor=float(d.get("occupancy_floor", 0.35)),
            prefill_mode=str(d.get("prefill_mode", "mono")),
            prefill_chunk_ms=float(d.get("prefill_chunk_ms", 0.0)),
            prefill_chunks_per_turn=int(
                d.get("prefill_chunks_per_turn", 1)
            ),
            failures=[
                EngineFailure.from_dict(f) for f in d.get("failures", [])
            ],
            degradations=[
                EngineDegradation.from_dict(g)
                for g in d.get("degradations", [])
            ],
            spec_collapses=[
                AcceptanceCollapse.from_dict(c)
                for c in d.get("spec_collapses", [])
            ],
            poisons=[
                PoisonInjection.from_dict(p) for p in d.get("poisons", [])
            ],
            retry=d.get("retry"),
            gray=d.get("gray"),
            admission=d.get("admission"),
            observatory=d.get("observatory"),
        )


class Simulation:
    """One run of one scenario against one set of profile tables."""

    def __init__(self, profiles: Dict[str, BatchProfile],
                 scenario: Scenario) -> None:
        self.profiles = profiles
        self.scenario = scenario

    # --- workload ---------------------------------------------------------
    def _arrivals(self) -> List[Arrival]:
        sc = self.scenario
        if sc.arrivals is not None:
            return scale_arrivals(sc.arrivals, sc.rate_scale, seed=sc.seed)
        streams = []
        for i, spec in enumerate(sc.models):
            if spec.pattern is None:
                continue
            pattern = spec.pattern
            if sc.rate_scale != 1.0:
                # Synthetic traffic scales at the SOURCE (rate, not trace).
                pattern = RatePattern(
                    kind=pattern.kind,
                    base_rps=pattern.base_rps * sc.rate_scale,
                    slope=pattern.slope * sc.rate_scale,
                    amplitude=pattern.amplitude * sc.rate_scale,
                    period_s=pattern.period_s,
                    step_at_s=pattern.step_at_s,
                    jitter=pattern.jitter,
                    spike_at_s=pattern.spike_at_s,
                    spike_len_s=pattern.spike_len_s,
                    seed=pattern.seed,
                )
            streams.append(
                synthetic_arrivals(
                    spec.name, pattern, sc.duration_s,
                    poisson=spec.poisson, seed=sc.seed * 8191 + i,
                )
            )
        return merge_arrivals(streams)

    def _warm_start_rates(self, arrivals: List[Arrival]) -> Dict[str, float]:
        """The rates the t=0 manual rebalance plans for: the synthetic
        base rates, or (for a recorded trace) the measured rate over the
        first rate window."""
        sc = self.scenario
        if sc.arrivals is None:
            return {
                spec.name: spec.pattern.base_rps * sc.rate_scale
                for spec in sc.models
                if spec.pattern is not None
            }
        span = max(min(sc.rate_window_s, sc.duration_s), 1e-9)
        counts: Dict[str, int] = {}
        for arrival in arrivals:  # plain or class-tagged tuples
            if arrival[0] <= span:
                model = arrival[1]
                counts[model] = counts.get(model, 0) + 1
        return {spec.name: counts.get(spec.name, 0) / span
                for spec in sc.models}

    # --- the run ----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        sc = self.scenario
        clock = VirtualClock()
        loop = EventLoop(clock)
        queues = SimQueueManager(clock, max_len=sc.max_queue_len)
        jitter_rng = (
            random.Random(sc.seed * 7919 + 13) if sc.latency_jitter else None
        )
        if sc.engine_widths is not None and \
                len(sc.engine_widths) != sc.n_engines:
            raise ValueError(
                f"engine_widths has {len(sc.engine_widths)} entries for "
                f"{sc.n_engines} engines"
            )
        # LIVE speculative acceptance per spec model: seeded from each
        # spec's PROFILED rate, shared by every engine (one dict — the
        # cluster serves one traffic population), mutated by
        # AcceptanceCollapse events at virtual time.
        spec_rates: Dict[str, float] = {
            spec.name: spec.spec_acceptance
            for spec in sc.models if spec.spec
        }
        if sc.prefill_mode == "chunked" and sc.prefill_chunk_ms <= 0.0:
            raise ValueError(
                "prefill_mode='chunked' needs prefill_chunk_ms > 0 — a "
                "zero-cost chunk would silently price as mono"
            )
        engines = []
        chip_base = 0
        for i in range(sc.n_engines):
            width = (sc.engine_widths[i]
                     if sc.engine_widths is not None else 1)
            # Classic clusters keep the historic chip{i} ids (canon);
            # width-typed clusters name units slice{i} over chip ids.
            if sc.engine_widths is None:
                eid, chips = f"chip{i}", None
            else:
                eid = f"slice{i}"
                chips = [f"chip{chip_base + j}" for j in range(width)]
                chip_base += width
            engines.append(
                SimEngine(eid, queues, self.profiles, loop, clock,
                          jitter_rng=jitter_rng,
                          occupancy_model=sc.decode_occupancy_model,
                          occupancy_floor=sc.occupancy_floor,
                          width=width, chip_ids=chips,
                          spec_rates=spec_rates,
                          prefill_mode=sc.prefill_mode,
                          prefill_chunk_ms=sc.prefill_chunk_ms,
                          prefill_chunks_per_turn=(
                              sc.prefill_chunks_per_turn))
            )
        packer = SquishyBinPacker(
            self.profiles, hbm_budget_bytes=sc.hbm_budget_bytes
        )
        # Pin every planner knob from the scenario — the constructor read
        # the ambient config, which is not part of a what-if's inputs.
        packer.hbm_budget = int(sc.hbm_budget_bytes * sc.hbm_plan_fraction)
        packer.slo_safety = sc.slo_safety_factor
        packer.compute_fraction = sc.slo_compute_fraction
        # Slot pricing reaches BOTH halves of the what-if: the planner
        # packs fill-priced turns, and the sim engines execute them at
        # the same fill-scaled cost — plan and timeline stay consistent.
        packer.occupancy_pricing = sc.decode_occupancy_model
        packer.occupancy_floor = sc.occupancy_floor
        sched = SimScheduler(
            packer, engines, queues, loop, clock,
            monitoring_interval_s=sc.monitoring_interval_s,
            rate_threshold=sc.rate_threshold,
            rate_decrease_multiplier=sc.rate_decrease_multiplier,
            rate_window_s=sc.rate_window_s,
            rate_min_span_s=sc.rate_min_span_s,
            gray_policy=sc.gray_policy(),
            observatory_policy=sc.observatory_policy(),
        )
        for spec in sc.models:
            # Chunk-interleaved turns are priced to the planner only
            # when the scenario runs them (one quantum may ride each
            # turn) — mono scenarios register byte-identically.
            chunk_price = (
                sc.prefill_chunk_ms * sc.prefill_chunks_per_turn
                if sc.prefill_mode == "chunked" and spec.long_frac > 0.0
                else 0.0
            )
            sched.register_model(spec.name, slo_ms=spec.slo_ms,
                                 seq_len=spec.seq_len,
                                 mesh_shape=spec.mesh_shape,
                                 spec="on" if spec.spec else "off",
                                 spec_acceptance=spec.spec_acceptance,
                                 spec_tokens=spec.spec_tokens,
                                 prefill_chunk_ms=chunk_price)

        # Admission control at virtual time: the LIVE controller module
        # with the virtual clock injected (deterministic buckets), wired
        # into the scheduler's audit ring so governor transitions land in
        # the same timeline as replans and heals.
        policy = sc.admission_policy()
        if policy is not None:
            admission = AdmissionController(clock=clock.now_s)
            admission.audit = sched.audit
            for spec in sc.models:
                admission.configure(spec.name, policy)
            sched.admission = admission
        queues.audit = sched.audit  # displacement sheds are audited too
        retry_cfg = sc.retry_config()
        if retry_cfg is not None:
            # Stale sheds become budgeted client resubmissions with fresh
            # deadlines — the retry amplification loop the metastability
            # scenarios exercise with budgets on (bounded) and off
            # (naive clients, the control arm).
            sched.enable_retries(**retry_cfg)

        # Only arrivals the horizon will actually fire count as offered
        # load: a recorded trace longer than duration_s is TRUNCATED and
        # says so, and arrivals for models the scenario never registered
        # are IGNORED and say so — both silently inflating 'arrivals'
        # would let capacity conclusions be drawn from a workload the
        # run never carried.
        known = {spec.name for spec in sc.models}
        all_arrivals = self._arrivals()
        arrivals: list = []
        ignored_models: Dict[str, int] = {}
        truncated = 0
        for arrival in all_arrivals:
            t_s, model = arrival[0], arrival[1]
            if model not in known:
                ignored_models[model] = ignored_models.get(model, 0) + 1
            elif t_s >= sc.duration_s:
                truncated += 1
            else:
                arrivals.append(arrival)
        # QoS class tagging: explicit 3-tuple arrivals keep their class;
        # untagged ones draw from the model's class_mix with a per-model
        # seeded stream (deterministic, independent of interleaving).
        specs = {spec.name: spec for spec in sc.models}
        class_rngs = {
            spec.name: random.Random(sc.seed * 4099 + 17 * i)
            for i, spec in enumerate(sc.models)
        }
        # Long-prompt tagging: its own per-model seeded
        # stream, drawn ONLY for models with a long mix — canon
        # scenarios consume no RNG state and stay byte-identical.
        long_rngs = {
            spec.name: random.Random(sc.seed * 6007 + 23 * i)
            for i, spec in enumerate(sc.models)
        }

        arrival_counts: Dict[str, int] = {}
        class_offered: Dict[str, Dict[str, int]] = {}
        for arrival in arrivals:
            t_s, model = arrival[0], arrival[1]
            if len(arrival) > 2:
                # Explicitly-tagged trace entry: validate like the live
                # doors do — a typo'd class in a recorded JSONL must not
                # silently serve at beyond-last priority.
                qos = arrival[2]
                if qos not in QOS_RANK:
                    raise ValueError(
                        f"arrival for {model!r} carries unknown qos class "
                        f"{qos!r} (known: {sorted(QOS_RANK)})"
                    )
            else:
                qos = draw_qos(class_rngs[model],
                               specs[model].class_mix)
            arrival_counts[model] = arrival_counts.get(model, 0) + 1
            per_cls = class_offered.setdefault(model, {})
            per_cls[qos] = per_cls.get(qos, 0) + 1
            spec_m = specs[model]
            pre_ms = 0.0
            if (spec_m.long_frac > 0.0
                    and long_rngs[model].random() < spec_m.long_frac):
                pre_ms = spec_m.long_prefill_ms
            loop.schedule_at(
                t_s * 1000.0,
                lambda m=model, q=qos, t=specs[model].tenant,
                pm=pre_ms: (
                    sched.submit(m, qos_class=q, tenant=t, prefill_ms=pm)
                ),
            )

        for i, p in enumerate(sc.poisons):
            if p.model not in known:
                raise ValueError(
                    f"poison names model {p.model!r}, which this scenario "
                    "never registered"
                )
            pid = p.poison_id or f"qod{i}"
            # Injections are offered load like any arrival — conservation
            # (offered == rejected + enqueued) must hold over them too,
            # with the quarantine fence counting as a front-door reject.
            per_cls = class_offered.setdefault(p.model, {})
            n_inj = 1 + (1 if p.repeat_at_s is not None else 0)
            per_cls[p.qos_class] = per_cls.get(p.qos_class, 0) + n_inj
            arrival_counts[p.model] = (
                arrival_counts.get(p.model, 0) + n_inj
            )
            loop.schedule_at(
                p.at_s * 1000.0,
                lambda m=p.model, q=p.qos_class, t=specs[p.model].tenant,
                pid=pid: sched.submit(m, qos_class=q, tenant=t,
                                      poison_id=pid),
            )
            if p.repeat_at_s is not None:
                # Same fingerprint, later arrival: the quarantine fence's
                # moment of truth.
                loop.schedule_at(
                    p.repeat_at_s * 1000.0,
                    lambda m=p.model, q=p.qos_class,
                    t=specs[p.model].tenant, pid=pid: sched.submit(
                        m, qos_class=q, tenant=t, poison_id=pid
                    ),
                )

        for f in sc.failures:
            if not 0 <= f.engine < sc.n_engines:
                raise ValueError(
                    f"failure names engine {f.engine} but the scenario has "
                    f"{sc.n_engines} engine(s)"
                )
            if f.chip is not None:
                if not 0 <= f.chip < engines[f.engine].width:
                    raise ValueError(
                        f"failure names chip {f.chip} of engine "
                        f"{f.engine}, a width-"
                        f"{engines[f.engine].width} unit"
                    )

                def _fail_chip(original=engines[f.engine], c=f.chip):
                    # Resolve the PHYSICAL chip to whichever unit owns
                    # it AT FIRE TIME: after a slice death + re-form,
                    # the chip belongs to a re-formed sub-slice (a
                    # fresh engine the scheduler enrolled mid-run) —
                    # failing the original dead object would let the
                    # sub-slice keep serving on dead hardware in a
                    # correlated rack event.
                    chip_id = original.chip_ids[c]
                    for e in sched.engines:
                        if e.alive and chip_id in e.chip_ids:
                            e.fail_chip(e.chip_ids.index(chip_id))
                            return
                    # Owner already dead: keep the bookkeeping honest
                    # so a LATER re-form can never resurrect the chip.
                    for e in sched.engines:
                        if chip_id in e.chip_ids:
                            e.dead_chips.add(e.chip_ids.index(chip_id))
                            return

                loop.schedule_at(f.at_s * 1000.0, _fail_chip)
            else:
                loop.schedule_at(
                    f.at_s * 1000.0, lambda e=engines[f.engine]: e.fail()
                )

        specs_by_name = {spec.name: spec for spec in sc.models}
        for c in sc.spec_collapses:
            target = specs_by_name.get(c.model)
            if target is None or not target.spec:
                raise ValueError(
                    f"acceptance collapse names {c.model!r}, which is not "
                    "a spec=True model in this scenario"
                )
            loop.schedule_at(
                c.at_s * 1000.0,
                lambda m=c.model, r=c.rate: spec_rates.__setitem__(m, r),
            )
            if c.heal_at_s is not None:
                loop.schedule_at(
                    c.heal_at_s * 1000.0,
                    lambda m=c.model, r=target.spec_acceptance: (
                        spec_rates.__setitem__(m, r)
                    ),
                )

        for g in sc.degradations:
            if not 0 <= g.engine < sc.n_engines:
                raise ValueError(
                    f"degradation names engine {g.engine} but the scenario "
                    f"has {sc.n_engines} engine(s)"
                )
            loop.schedule_at(
                g.at_s * 1000.0,
                lambda e=engines[g.engine], d=g: e.degrade(
                    d.factor, d.stall_ms
                ),
            )
            if g.heal_at_s is not None:
                loop.schedule_at(
                    g.heal_at_s * 1000.0,
                    lambda e=engines[g.engine]: e.heal_degradation(),
                )

        if sc.warm_start:
            sched.rebalance(rates=self._warm_start_rates(arrivals),
                            trigger="manual")
        sched.start_monitoring(until_ms=sc.duration_s * 1000.0)
        for e in engines:
            e.start()

        horizon_ms = (sc.duration_s + sc.drain_s) * 1000.0
        events = loop.run_until(horizon_ms)
        for e in engines:
            # Chunk trains still in flight at the horizon shed as stale
            # (the live drain's abort path) — conservation stays exact.
            e.flush_prefill_backlog()
        elapsed_ms = clock.now_ms()
        # Kept for post-run consumers that need the raw (mergeable) hop
        # sketches rather than the report's rendered quantiles — the
        # hop-drift CLI merges these against a live capture's.
        self.last_queues = queues

        # --- report -------------------------------------------------------
        models: Dict[str, Any] = {}
        for spec in sc.models:
            queue = queues.queue(spec.name)
            stats = queue.stats()
            rejected_total = sum(
                n for (mdl, _cls), n in sched.admission_rejected.items()
                if mdl == spec.name
            )
            classes: Dict[str, Any] = {}
            class_counters = queue.class_stats()
            for cls in sorted(
                set(class_counters)
                | set(class_offered.get(spec.name, {}))
            ):
                c = class_counters.get(cls, {})
                rejected = sched.admission_rejected.get(
                    (spec.name, cls), 0
                )
                classes[cls] = {
                    "offered": class_offered.get(spec.name, {}).get(cls, 0),
                    "admission_rejected": rejected,
                    "enqueued": int(c.get("enqueued", 0)),
                    "completed": int(c.get("completed", 0)),
                    "dropped": int(c.get("dropped", 0)),
                    "stale": int(c.get("stale", 0)),
                    "violations": int(c.get("violations", 0)),
                    "pending": int(c.get("depth", 0)),
                    "slo_attainment": slo_attainment(c),
                }
            models[spec.name] = {
                "slo_ms": spec.slo_ms,
                "arrivals": arrival_counts.get(spec.name, 0),
                "admission_rejected": rejected_total,
                "completed": int(stats["completed"]),
                "dropped": int(stats["dropped"]),
                "stale": int(stats["stale"]),
                "violations": int(stats["violations"]),
                "pending": int(stats["depth"]),
                # Poison verdicts are a subset of "dropped" (conservation
                # unchanged); keyed out only in poison scenarios so canon
                # reports keep their exact key set.
                **({"poisoned": int(queue.total_poisoned)}
                   if sc.poisons else {}),
                "slo_attainment": slo_attainment(stats),
                # Class-weighted attainment: the planner's pricing of a
                # miss (scheduler/replan.weighted_attainment — interactive
                # misses cost 4x best-effort ones).
                "weighted_attainment": weighted_attainment(class_counters),
                "classes": classes,
                "latency_p50_ms": stats["latency_p50_ms"],
                "latency_p95_ms": stats["latency_p95_ms"],
                "latency_p99_ms": stats["latency_p99_ms"],
                # Virtual-event hop ledger (sim slice of the live hop
                # taxonomy): feeds ``sim --hop-drift``.
                "hops": queue.hop_stats(),
            }
        chips: Dict[str, Any] = {}
        # sched.engines, not the construction list: slice re-formation
        # (SimScheduler._reform_slices) enrolls fresh units mid-run and
        # their execution must be accounted like anyone else's.
        engines = list(sched.engines)
        for e in engines:
            chips[e.engine_id] = {
                "busy_ms": e.busy_ms,
                "occupancy": e.occupancy(elapsed_ms),
                "slot_occupancy": e.slot_occupancy(),
                "batches": e.batches,
                "requests": e.requests,
                "cycles": e.cycle_count,
                "swaps": e.swap_count,
                "models": sorted(e.models),
                "alive": e.alive,
                "failed_at_ms": e.failed_at_ms,
            }
            if sc.engine_widths is not None:
                chips[e.engine_id]["width"] = e.width
                chips[e.engine_id]["chip_ids"] = list(e.chip_ids)
                chips[e.engine_id]["mesh_shape"] = e.mesh_shape
                chips[e.engine_id]["failed_chip"] = e.failed_chip
            if sched.gray is not None:
                chips[e.engine_id]["gray_state"] = sched.gray.state(
                    e.engine_id
                )
                chips[e.engine_id]["degraded"] = e.degraded
        audit = sched.audit.to_dicts()
        migrations = sum(
            1 for r in audit
            if r["diff"].get("engines_changed") and any(r["before"] or [])
        )
        return {
            "metric": "sim_report",
            "seed": sc.seed,
            "duration_s": sc.duration_s,
            "drain_s": sc.drain_s,
            "n_engines": sc.n_engines,
            **({"engine_widths": list(sc.engine_widths)}
               if sc.engine_widths is not None else {}),
            "rate_scale": sc.rate_scale,
            "decode_occupancy_model": sc.decode_occupancy_model,
            "events": events,
            "arrivals_total": len(arrivals),
            "arrivals_truncated_past_horizon": truncated,
            "arrivals_ignored_unregistered_model": ignored_models,
            "failures": [
                ({"at_s": f.at_s, "engine": f.engine} if f.chip is None
                 else {"at_s": f.at_s, "engine": f.engine, "chip": f.chip})
                for f in sc.failures
            ],
            "degradations": [
                {"at_s": g.at_s, "engine": g.engine, "factor": g.factor,
                 "stall_ms": g.stall_ms, "heal_at_s": g.heal_at_s}
                for g in sc.degradations
            ],
            # Query-of-death arm (conditional: poison-free scenarios stay
            # byte-identical): injection/fence/isolation ledger plus the
            # per-engine bisection cost actually paid.
            **({"poison": sched.poison_report()} if sc.poisons else {}),
            # Client-retry arm (conditional, same discipline): budget
            # stats, resubmission/denial counts, and the monitor-tick
            # windowed-attainment timeline the metastability pin grades.
            **({"retry": sched.retry_report()}
               if retry_cfg is not None else {}),
            # Speculative arm (conditional: pre-spec scenarios stay
            # byte-identical): planned vs final LIVE acceptance per spec
            # model, plus the injected collapse timeline.
            **({"spec": {
                "models": {
                    spec.name: {
                        "spec_tokens": spec.spec_tokens,
                        "planned_acceptance": spec.spec_acceptance,
                        "final_acceptance": spec_rates[spec.name],
                    }
                    for spec in sc.models if spec.spec
                },
                "collapses": [
                    {"at_s": c.at_s, "model": c.model, "rate": c.rate,
                     "heal_at_s": c.heal_at_s}
                    for c in sc.spec_collapses
                ],
            }} if spec_rates else {}),
            # Per-replica gray_state timeline (sim/report.gray_timeline
            # slices it per engine): every detector transition with its
            # virtual timestamp, plus the final verdicts.
            "gray": (
                None if sched.gray is None else {
                    "timeline": [dict(t) for t in sched.gray.transitions],
                    "final_states": sched.gray.states(),
                }
            ),
            "admission": (
                None if sched.admission is None else {
                    **sched.admission.stats(),
                    "final_state": {
                        spec.name: sched.admission.snapshot(
                            spec.name
                        )["state"]
                        for spec in sc.models
                    },
                }
            ),
            # SLO observatory block (conditional: pre-observatory
            # scenarios stay byte-identical). Alert timelines join
            # gray_timeline as first-class scenario output via
            # sim/report.alert_timeline.
            **({"observatory": {
                **sched.observatory.snapshot(),
                "alerts": {
                    "timeline": [
                        dict(t)
                        for t in sched.observatory.burn.transitions
                    ],
                    "final_states": sched.observatory.burn.states(),
                },
            }} if sched.observatory is not None else {}),
            "models": models,
            "chips": chips,
            "chips_used": sum(1 for e in engines if e.batches > 0),
            "schedule_changes": sched.schedule_changes,
            "migrations": migrations,
            "final_plan": [n.describe() for n in sched._current_plan],
            "audit": audit,
        }
