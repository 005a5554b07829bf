"""Built-in scenarios + synthetic profile fixtures.

The smoke scenario is the CI gate's fixture (``python -m
ray_dynamic_batching_tpu_torch.sim --smoke``): three models with distinct
latency/memory shapes under a mid-run traffic spike on one of them —
enough to exercise saturate +
residue packing, a monitor-detected rate change, a live migration, and
SLO accounting, in well under a second of wall time. The profile
fixtures are synthetic (hermetic: the smoke must not move when committed
CPU tables are re-measured); committed-table replays go through
``python -m ray_dynamic_batching_tpu_torch.sim --profiles``.

Own copy of ``ray_dynamic_batching_tpu/sim/scenarios.py``, whole (every
builder and ``PartitionScenario``), with its import paths rewritten.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from ray_dynamic_batching_tpu_torch.engine.workload import RatePattern
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile, ProfileRow
from ray_dynamic_batching_tpu_torch.sim.simulator import (
    AcceptanceCollapse,
    EngineDegradation,
    EngineFailure,
    PoisonInjection,
    Scenario,
    SimModelSpec,
)

MB = 1024 * 1024


def linear_profile(
    name: str,
    base_ms: float,
    per_sample_ms: float,
    weight_mb: int = 100,
    act_mb_per_sample: float = 1.0,
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
    compile_ms: float = 1000.0,
    std_fraction: float = 0.0,
    mesh: str = "1x1",
    spec: str = "off",
) -> BatchProfile:
    """Latency = base + per_sample*batch — the canonical accelerator
    shape (same generator as ``tests/fixtures.py``, duplicated here so
    shipped tools never import the test tree). ``mesh`` stamps the rows
    as measured over that slice shape (per-slice latency, per-chip
    footprint — the ProfileRow mesh-axis contract); ``spec`` stamps them
    as speculative verify-ROUND costs (the ProfileRow spec-axis
    contract)."""
    rows = [
        ProfileRow(
            batch_size=b,
            seq_len=0,
            latency_ms=base_ms + per_sample_ms * b,
            latency_std_ms=std_fraction * (base_ms + per_sample_ms * b),
            hbm_bytes=int((weight_mb + act_mb_per_sample * b) * MB),
            compile_ms=compile_ms,
            mesh=mesh,
            spec=spec,
        )
        for b in buckets
    ]
    return BatchProfile(name, rows)


def fixture_profiles() -> Dict[str, BatchProfile]:
    """Three models with distinct latency/memory shapes: a shufflenet-
    like sprinter, a steep burst-prone mid-tier (its SLO caps the
    bucket at b=16 / ~116 rps per chip, so a real spike SATURATES a
    chip), and a memory-fat heavyweight."""
    return {
        "fast": linear_profile("fast", base_ms=1.0, per_sample_ms=0.05,
                               weight_mb=20, act_mb_per_sample=0.2),
        "burst": linear_profile("burst", base_ms=10.0, per_sample_ms=8.0,
                                weight_mb=300, act_mb_per_sample=2.0),
        "fat": linear_profile("fat", base_ms=5.0, per_sample_ms=0.5,
                              weight_mb=4000, act_mb_per_sample=40.0),
    }


def smoke_scenario(seed: int = 0) -> Scenario:
    """60 virtual seconds, 3 chips, Poisson arrivals: ``burst`` spikes
    30 -> 160 rps mid-run — past its ~116 rps single-chip SLO capacity —
    so the monitor must catch the drift and migrate it across chips (and
    scale back down after). Expected story: ``fast``/``fat`` hold their
    SLOs throughout; ``burst`` sheds transiently during the detection
    lag, then recovers on the migrated plan."""
    return Scenario(
        models=[
            SimModelSpec(
                name="fast", slo_ms=200.0,
                pattern=RatePattern("constant", base_rps=60.0),
            ),
            SimModelSpec(
                name="burst", slo_ms=500.0,
                pattern=RatePattern(
                    "spike", base_rps=30.0, amplitude=130.0,
                    spike_at_s=25.0, spike_len_s=20.0,
                ),
            ),
            SimModelSpec(
                name="fat", slo_ms=800.0,
                pattern=RatePattern("constant", base_rps=7.0),
            ),
        ],
        duration_s=60.0,
        drain_s=5.0,
        n_engines=3,
        seed=seed,
        monitoring_interval_s=2.0,
    )


def overload_scenario(rate_scale: float = 1.0, seed: int = 0) -> Scenario:
    """The overload-soak fixture (``tools/run_overload_soak.py --sim``):
    one saturation-prone model, three chips, a mixed-class tenant
    population (80% best-effort bulk, 10% standard, 10% interactive) and
    token-bucket admission with the overload governor armed.

    At ``rate_scale=1.0`` (180 rps) capacity covers demand and every
    class serves clean. At 5x (900 rps offered) the story the gate
    asserts: the admission bucket clips the flood, the first saturated
    monitor ticks flip the governor to degraded (best-effort throttled to
    a trickle, interactive untouched), the class-then-deadline queue
    serves interactive first, and the backlog's stale discards land
    almost entirely on best-effort — interactive attainment holds its
    1x value while best-effort absorbs the shed, with every turned-away
    request accounted as rejected-at-admission."""
    return Scenario(
        models=[
            SimModelSpec(
                name="burst", slo_ms=500.0,
                pattern=RatePattern("constant", base_rps=180.0),
                class_mix={"interactive": 0.10, "standard": 0.10,
                           "best_effort": 0.80},
                tenant="mixed-pop",
            ),
        ],
        duration_s=30.0,
        drain_s=5.0,
        n_engines=3,
        seed=seed,
        rate_scale=rate_scale,
        max_queue_len=1024,
        monitoring_interval_s=2.0,
        admission={
            "rate_rps": 400.0,
            "burst": 50.0,
            "degraded_class_fractions": {
                "interactive": 1.0, "standard": 0.6, "best_effort": 0.1,
            },
            # Tuned to the fixture's observed overload dynamics: the
            # stale sweep holds depth near 0.16-0.18 of max_len at 5x, so
            # 0.15 catches the first saturated tick; recovery is gated by
            # the zero-recent-rejects rule, not these floors.
            "depth_high": 0.15,
            "depth_low": 0.02,
        },
    )


def chaos_scenario(seed: int = 0) -> Scenario:
    """The chaos conformance fixture (``tools/run_chaos_soak.py --sim``):
    two comfortably-provisioned models on 3 chips, one engine KILLED
    mid-run. Expected story: the monitor detects the death at its next
    tick, a heal replan migrates the dead chip's models to survivors,
    and — because capacity still covers demand — queued work completes
    within SLO: the failure costs at most a detection-window of sheds,
    never a silent stall. Roomy SLOs keep the accounting robust so the
    conformance gate grades the HEAL story, not knife-edge shedding."""
    return Scenario(
        models=[
            SimModelSpec(
                name="fast", slo_ms=2000.0,
                pattern=RatePattern("constant", base_rps=50.0),
            ),
            SimModelSpec(
                name="fat", slo_ms=4000.0,
                pattern=RatePattern("constant", base_rps=6.0),
            ),
        ],
        duration_s=30.0,
        drain_s=5.0,
        n_engines=3,
        seed=seed,
        monitoring_interval_s=2.0,
        failures=[EngineFailure(at_s=10.0, engine=0)],
    )


def straggler_scenario(seed: int = 0) -> Scenario:
    """The gray-failure conformance fixture (``tools/
    run_straggler_soak.py --sim``; first installment of ROADMAP item 3's
    slow-drip-straggler matrix): a 3-chip deployment at steady traffic,
    one chip running 10x SLOW (not dead — ``healthy()`` keeps lying)
    from t=8s until it heals at t=20s.

    Expected story: the gray monitor's ratio consensus flags chip0
    within a few 1 s ticks (suspect at 2 consecutive outlier ticks,
    probation 2 ticks later), the probation replan reprices it to
    fractional capacity — the heavy ``burst`` load moves to healthy
    chips while the light ``fast`` node keeps the straggler probed — and
    after the heal the clear-streak readmits it to full capacity.
    ``fast`` carries the interactive mix whose attainment the gate
    floors; ``burst`` is the load that HURTS while it sits on a 10x
    chip, so the detection window is visible in its attainment without
    sinking the gate."""
    return Scenario(
        models=[
            SimModelSpec(
                name="fast", slo_ms=200.0,
                pattern=RatePattern("constant", base_rps=60.0),
                class_mix={"interactive": 0.5, "standard": 0.5},
            ),
            # Past burst's ~116 rps single-chip SLO capacity: the packer
            # MUST spread the deployment over multiple chips, which is
            # what gives the gray monitor executing peers to form its
            # consensus from (a one-chip plan has nobody to compare).
            SimModelSpec(
                name="burst", slo_ms=2000.0,
                pattern=RatePattern("constant", base_rps=150.0),
            ),
        ],
        duration_s=35.0,
        drain_s=5.0,
        n_engines=3,
        seed=seed,
        monitoring_interval_s=1.0,
        degradations=[
            EngineDegradation(at_s=8.0, engine=0, factor=10.0,
                              heal_at_s=20.0),
        ],
        gray={
            # Ratio-space observations (observed/expected ~1.0 healthy):
            # 3x the peer median is decisive, min_abs_ms below 1.0 keeps
            # healthy engines (ratio exactly 1.0) ungradeable as
            # outliers by construction. min_samples=2: sim ratios are
            # EXACT (no measurement noise — the hysteresis ticks are the
            # noise filter), and a lightly-loaded chip may only run a
            # couple of batches per 1 s tick. min_peers=1: ratio space
            # is model-agnostic, so a single healthy executing peer is a
            # valid consensus.
            "p50_ratio": 3.0,
            "p95_ratio": 3.0,
            "min_abs_ms": 0.5,
            "min_samples": 2,
            "min_peers": 1,
            "suspect_after": 2,
            "probation_after": 2,
            "heal_after": 2,
            "probation_capacity": 0.4,
        },
    )


def mesh_profiles() -> Dict[str, BatchProfile]:
    """The mesh-placement fixtures (ROADMAP item 2): the single-chip
    trio plus ``tp_llm``, a model with NO single-chip rows — it only
    exists as a 4-chip TP slice (fast steps) or a 2-chip half-slice
    (~2.2x slower per step, the collective-vs-compute tax of the
    narrower mesh). Per the ProfileRow mesh contract, hbm_bytes are
    PER-CHIP: the 1x2 rows carry twice the weight shard of the 1x4
    rows."""
    profiles = dict(fixture_profiles())
    tp4 = linear_profile(
        "tp_llm", base_ms=6.0, per_sample_ms=1.0, weight_mb=2500,
        act_mb_per_sample=4.0, mesh="1x4",
    )
    tp2 = linear_profile(
        "tp_llm", base_ms=13.0, per_sample_ms=2.2, weight_mb=5000,
        act_mb_per_sample=8.0, mesh="1x2",
    )
    profiles["tp_llm"] = BatchProfile("tp_llm", tp4.rows + tp2.rows)
    return profiles


def mesh_scenario(seed: int = 0) -> Scenario:
    """Mesh-sharded placement fixture (``tools/run_mesh_soak.py``): a
    cluster of one 4-chip TP slice, one 2-chip half-slice, and two
    single chips serving ``tp_llm`` (a model that only exists at mesh
    shapes 1x4/1x2) next to single-chip ``fast`` traffic. Expected
    story: the planner prices tp_llm from its 1x4 rows and pins it to
    the wide slice, fast packs onto the singles, and both hold their
    SLOs — the (model, mesh_shape) schedulable unit working end to
    end."""
    return Scenario(
        models=[
            SimModelSpec(
                name="tp_llm", slo_ms=400.0, mesh_shape="1x4",
                pattern=RatePattern("constant", base_rps=120.0),
                class_mix={"interactive": 0.5, "standard": 0.5},
            ),
            SimModelSpec(
                name="fast", slo_ms=200.0,
                pattern=RatePattern("constant", base_rps=60.0),
            ),
        ],
        duration_s=30.0,
        drain_s=5.0,
        n_engines=4,
        engine_widths=[4, 2, 1, 1],
        seed=seed,
        monitoring_interval_s=2.0,
    )


def slice_failure_scenario(seed: int = 0) -> Scenario:
    """Slice-death fixture (the mesh half of the chaos story): same
    cluster as :func:`mesh_scenario`, but chip 1 of the 4-chip slice
    dies at t=10s. One dead chip fails the WHOLE slice (SliceDeadError
    semantics); the monitor detects it at the next tick, the surviving
    3 chips re-form as a 1x2 half-slice + a single, and the heal replan
    DEGRADES tp_llm to its 1x2 profile row on a surviving half-slice —
    slower steps, but the queue never starves. Roomy SLO so the gate
    grades the heal/degrade story, not knife-edge shedding."""
    return Scenario(
        models=[
            SimModelSpec(
                name="tp_llm", slo_ms=2500.0, mesh_shape="1x4",
                pattern=RatePattern("constant", base_rps=60.0),
            ),
            SimModelSpec(
                name="fast", slo_ms=2000.0,
                pattern=RatePattern("constant", base_rps=40.0),
            ),
        ],
        duration_s=30.0,
        drain_s=5.0,
        n_engines=4,
        engine_widths=[4, 2, 1, 1],
        seed=seed,
        monitoring_interval_s=2.0,
        failures=[EngineFailure(at_s=10.0, engine=0, chip=1)],
    )


# --- speculative decoding over the paged engine ------------------


SPEC_ROUND_OVERHEAD = 1.4   # verify round cost vs a plain step (draft k+1
                            # steps + window verify on top of one target step)
SPEC_PROFILED_ACCEPTANCE = 0.7
SPEC_COLLAPSED_ACCEPTANCE = 0.05


def spec_profiles() -> Dict[str, BatchProfile]:
    """The spec-soak fixtures: the single-chip trio plus ``paged_llm``,
    a decode-shaped model with BOTH arms profiled — plain rows (one
    decode step) and ``spec="on"`` rows at ``SPEC_ROUND_OVERHEAD`` x the
    step cost (one verify round: draft k+1 cheap steps + the target's
    k+1-window verify). At the profiled acceptance 0.7 with k=4 a round
    emits E = (1-0.7^5)/0.3 ~ 2.77 tokens, so the spec arm's effective
    step cost is ~2x cheaper than plain — the Leviathan multiplier the
    paged engine's memory-bound decode path exists to collect."""
    profiles = dict(fixture_profiles())
    plain = linear_profile(
        "paged_llm", base_ms=8.0, per_sample_ms=1.0, weight_mb=1500,
        act_mb_per_sample=4.0,
    )
    spec = linear_profile(
        "paged_llm", base_ms=8.0 * SPEC_ROUND_OVERHEAD,
        per_sample_ms=1.0 * SPEC_ROUND_OVERHEAD, weight_mb=1800,
        act_mb_per_sample=4.0, spec="on",
    )
    profiles["paged_llm"] = BatchProfile("paged_llm",
                                         plain.rows + spec.rows)
    return profiles


def spec_scenario(spec: bool = False, collapse: bool = False,
                  seed: int = 0) -> Scenario:
    """The speculative-decoding soak fixture (``tools/run_spec_soak.py``),
    three arms over IDENTICAL traffic on the slot-priced (paged) cost
    model:

    - ``spec=False``: the plain paged arm — the baseline the win
      condition is measured against.
    - ``spec=True``: speculation at the profiled acceptance rate. The
      planner prices the spec rows ~2x cheaper per effective step, so
      the same 2 chips carry the offered load that mildly saturates the
      plain arm — the gate asserts it completes MORE at equal-or-better
      attainment (the spec arm's sim win condition).
    - ``collapse=True``: adversarial prompts drive the LIVE acceptance
      to ~0 from t=8s to t=22s while the planner keeps its profiled
      belief. A verify round still emits >= 1 token, so the worst case
      is the round overhead (1.4x a plain step) — the gate floors
      throughput at a bounded factor of the plain arm and requires zero
      drops (client-visible errors)."""
    return Scenario(
        models=[
            SimModelSpec(
                name="paged_llm", slo_ms=900.0,
                pattern=RatePattern("constant", base_rps=850.0),
                spec=spec,
                spec_acceptance=SPEC_PROFILED_ACCEPTANCE,
                spec_tokens=4,
            ),
            SimModelSpec(
                name="fast", slo_ms=200.0,
                pattern=RatePattern("constant", base_rps=40.0),
            ),
        ],
        duration_s=30.0,
        drain_s=5.0,
        n_engines=2,
        seed=seed,
        max_queue_len=16384,
        monitoring_interval_s=2.0,
        decode_occupancy_model="slot",
        spec_collapses=(
            [AcceptanceCollapse(
                at_s=8.0, model="paged_llm",
                rate=SPEC_COLLAPSED_ACCEPTANCE, heal_at_s=22.0,
            )] if collapse else []
        ),
    )


# --- chunked-prefill interleave ----------------------------------

# One long prompt's full prefill beyond the profile row (the mono arm
# executes it inside the popped turn), and the chunk quantum the
# chunked arm spends between decode turns. 8 chunks per train: a
# 120 ms train vs a 15 ms stall bound.
INTERLEAVE_LONG_PREFILL_MS = 120.0
INTERLEAVE_CHUNK_MS = 15.0


def interleave_profiles() -> Dict[str, BatchProfile]:
    """The interleave-soak fixtures: a latency-sensitive interactive
    model sharing chips with a decode-shaped LLM whose traffic carries
    long prompts. The LLM's profile rows cover only the BUCKETED step —
    the long-prompt prefill cost rides per-request (SimRequest
    .prefill_ms), which is exactly what makes the two admission
    disciplines diverge."""
    return {
        "interactive": linear_profile(
            "interactive", base_ms=2.0, per_sample_ms=0.5,
            weight_mb=100, act_mb_per_sample=0.5,
        ),
        "llm_long": linear_profile(
            "llm_long", base_ms=10.0, per_sample_ms=1.5,
            weight_mb=1500, act_mb_per_sample=4.0,
        ),
    }


def interleave_scenario(chunked: bool = False, seed: int = 0) -> Scenario:
    """The interleave-soak fixture (``tools/run_interleave_soak.py``),
    two arms over IDENTICAL traffic on the slot-priced cost model: an
    interactive stream (SLO 250 ms) co-located with an LLM whose
    arrivals are 70% long prompts, plus a long-prompt FLASH CROWD
    (spike 12 -> 42 rps mid-run). The mono arm runs each long train
    inside its turn — every pop behind it waits the full 120 ms — so
    the interactive p50 inflates under the crowd; the chunked arm
    spends the same milliseconds as 15 ms budgeted chunk events between
    decode turns, and the interactive stream keeps its cadence. The
    gate pins the p50 gap, equal-or-better completions, and exact
    conservation."""
    return Scenario(
        models=[
            SimModelSpec(
                name="interactive", slo_ms=250.0,
                pattern=RatePattern("constant", base_rps=50.0),
            ),
            SimModelSpec(
                name="llm_long", slo_ms=4000.0,
                pattern=RatePattern(
                    "spike", base_rps=12.0, amplitude=30.0,
                    spike_at_s=10.0, spike_len_s=12.0,
                ),
                long_frac=0.7,
                long_prefill_ms=INTERLEAVE_LONG_PREFILL_MS,
            ),
        ],
        duration_s=40.0,
        drain_s=12.0,
        n_engines=2,
        seed=seed,
        max_queue_len=16384,
        monitoring_interval_s=2.0,
        decode_occupancy_model="slot",
        prefill_mode="chunked" if chunked else "mono",
        prefill_chunk_ms=INTERLEAVE_CHUNK_MS if chunked else 0.0,
        prefill_chunks_per_turn=1,
    )


# --- control-plane partition matrix ------------------------------
#
# These fixtures parameterize sim/frontdoor.run_partition_sim, which rides
# the REAL fabric/store/frontdoor classes on the virtual clock — the same
# objects the live soak partitions, not simplified stand-ins. Node names:
# controllers ctl-A (initial leader) / ctl-B (cold standby), store
# substrate "log" + "lease", front-door shards fd-0..fd-{n-1}. Partition
# windows are virtual seconds in the fabric spec grammar
# (serve/fabric.parse_partition_spec).


@dataclass
class PartitionScenario:
    """One partition-defense story: a seeded 2x-oversubscribed admission
    flood over a sharded front door plus a leader/standby replicated
    store, with fabric partition windows cut mid-run. The CI smoke
    (tools/run_partition_soak.py --sim, tools/partition_smoke.json
    floors) replays each fixture twice and compares bytes."""

    name: str = "partition"
    seed: int = 0
    duration_s: float = 30.0
    drain_s: float = 5.0
    # Front door: global budget under an over-subscribed flood (the
    # budget must bind, so over-admission during the partition is
    # measurable against the allowance line).
    n_shards: int = 4
    rate_rps: float = 200.0
    burst: float = 200.0
    offered_rps: float = 400.0
    gossip_interval_s: float = 0.5
    # Fail-closed bound: 3 missed gossip rounds is a partition, not
    # jitter.
    staleness_bound_s: float = 1.5
    n_sessions: int = 40
    n_tenants: int = 4
    # Store: leader heartbeats a txn per tick; ctl-B is a COLD standby
    # (created at start, catches up only inside acquire_leadership —
    # the realistic new-controller-process failover, and what makes the
    # snapshot + tail-replay path the one under test).
    control_interval_s: float = 0.5
    lease_duration_s: float = 2.0
    snapshot_every: int = 16
    # Synthetic uptime: preloaded txns before the flood, so failover
    # replay cost is judged against a LONG log (the O(tail) ratchet).
    preload_txns: int = 0
    # Fabric chaos: partition windows + per-edge drop/delay/dup.
    partition_spec: str = ""
    edge_spec: str = ""


PARTITION_SCENARIOS: Tuple[str, ...] = (
    "symmetric_split",
    "leader_isolated",
    "gossip_only",
    "partition_during_flood",
    "heal_reconverge",
)


def partition_scenario(kind: str = "leader_isolated",
                       seed: int = 0) -> PartitionScenario:
    """The partition matrix. Each entry is one failure class from the
    partition taxonomy; ARCHITECTURE.md's "Partition semantics" table
    names each class's detector / degraded mode / client outcome /
    heal path — these fixtures are the executable versions."""
    if kind == "symmetric_split":
        # The control plane tears in half: the leader keeps two shards
        # but loses log, lease, AND the other half's gossip. Renewal
        # becomes unreachable -> the leader demotes on the lease-loss
        # path; the standby's side owns the quorum substrate and takes
        # over; BOTH gossip sides degrade fail-closed, then re-converge
        # on heal.
        return PartitionScenario(
            name=kind, seed=seed,
            partition_spec=("ctl-A+fd-0+fd-1|ctl-B+log+lease+fd-2+fd-3"
                            "@t=10:heal=10"),
        )
    if kind == "leader_isolated":
        # THE asymmetric case: the leader can renew its lease but not
        # reach the log. Without defense it would stay leader on a
        # heartbeat it cannot write under (split-brain); with it, the
        # bounded unreachable window self-demotes (store_unreachable),
        # the lease lapses unrenewed, and the standby — which CAN reach
        # the log — takes over by snapshot + tail replay. The long
        # preloaded log is what the O(tail) failover ratchet grades.
        return PartitionScenario(
            name=kind, seed=seed,
            preload_txns=400,
            partition_spec="ctl-A|log@t=10:heal=12",
        )
    if kind == "gossip_only":
        # Store untouched; the shard mesh splits 2|2. Each side's
        # ledgers lose half the fleet, degrade fail-closed at the
        # staleness bound (bounded over-admission, never unbounded),
        # and re-converge to exact global counts on heal.
        return PartitionScenario(
            name=kind, seed=seed,
            partition_spec="fd-0+fd-1|fd-2+fd-3@t=10:heal=10",
        )
    if kind == "partition_during_flood":
        # Correlated worst case: leader isolation AND a gossip split
        # open together at peak offered load (4x the budget), plus
        # chaos-duplicated gossip so the CRDT replacement's idempotence
        # is load-bearing, not decorative.
        return PartitionScenario(
            name=kind, seed=seed,
            offered_rps=800.0,
            preload_txns=200,
            partition_spec=("ctl-A|log@t=12:heal=8;"
                            "fd-0+fd-1|fd-2+fd-3@t=12:heal=8"),
            edge_spec="frontdoor.gossip=-1:dup:p0.2",
        )
    if kind == "heal_reconverge":
        # A minority shard drops off and returns; the long post-heal
        # window pins EXACT re-convergence (every shard's merged count
        # equals the oracle) and that degraded mode exits cleanly.
        return PartitionScenario(
            name=kind, seed=seed,
            duration_s=35.0,
            partition_spec="fd-0+fd-1+fd-2|fd-3@t=8:heal=6",
        )
    raise ValueError(
        f"unknown partition scenario {kind!r} "
        f"(known: {', '.join(PARTITION_SCENARIOS)})"
    )


def correlated_failure_scenario(seed: int = 0) -> Scenario:
    """Correlated deaths (ROADMAP item 3's matrix, second entry): two of
    four chips die 400 ms apart — one rack event, not independent
    failures — under comfortable provisioning. Expected story: the
    monitor sees BOTH deaths (same tick or consecutive ticks), the heal
    replan(s) fold four chips' load onto two survivors, and because
    capacity still covers demand every model recovers: the event costs
    detection-window sheds, never a starved queue. Roomy SLOs keep the
    gate grading the heal story."""
    return Scenario(
        models=[
            SimModelSpec(
                name="fast", slo_ms=2000.0,
                pattern=RatePattern("constant", base_rps=60.0),
            ),
            SimModelSpec(
                name="fat", slo_ms=4000.0,
                pattern=RatePattern("constant", base_rps=6.0),
            ),
        ],
        duration_s=30.0,
        drain_s=5.0,
        n_engines=4,
        seed=seed,
        monitoring_interval_s=2.0,
        failures=[
            EngineFailure(at_s=10.0, engine=0),
            EngineFailure(at_s=10.4, engine=1),
        ],
    )


# --- SLO observatory ---------------------------------------------

# Shared observatory knobs for the soak fixtures: SRE window lengths
# shrunk onto a sub-minute virtual horizon (fast 10 s / slow 30 s at
# 2 s epochs) so a 45 s scenario exercises the WHOLE alert lifecycle —
# fire, page, age out, resolve — and drift replays land every other
# monitor tick. page_burn stays multi-window: both horizons must burn.
OBSERVATORY_SOAK_POLICY = {
    "slo_target": 0.99,
    "fast_window_s": 10.0,
    "slow_window_s": 30.0,
    "epochs_per_window": 5,
    "warn_burn": 2.0,
    "page_burn": 10.0,
    "min_accounted": 20,
    "warn_after": 1,
    "page_after": 1,
    "resolve_after": 2,
    "resolved_hold_ticks": 3,
    "forecast_horizon_s": 5.0,
    "forecast_min_span_s": 3.0,
    "replay_every_ticks": 2,
    "drift_tolerance": 0.5,
    "drift_min_count": 5,
    "drift_min_abs_ms": 1.0,
}


def observatory_overload_scenario(seed: int = 0) -> Scenario:
    """The observatory soak's BURN arm (``tools/run_observatory_soak.py
    --sim``): ``burst`` spikes 30 -> 430 rps for 8 s — roughly double
    the ~230 rps two-chip SLO capacity — then subsides to a base load
    the pair serves trivially (no residual shed trickle to re-trip the
    alert after it clears). Expected story: the spike's sheds and
    violations torch the 1% error budget (fast AND slow burn past
    ``page_burn``), the alert machine walks ``ok -> warning -> page``;
    after the spike both windows rotate the incident out and the clear
    streak lands ``page -> resolved`` (then ``-> ok`` once the resolved
    hold expires). The gate pins that exact sequence, twice,
    byte-identically."""
    return Scenario(
        models=[
            SimModelSpec(
                name="burst", slo_ms=2000.0,
                pattern=RatePattern(
                    "spike", base_rps=30.0, amplitude=400.0,
                    spike_at_s=10.0, spike_len_s=8.0,
                ),
                class_mix={"interactive": 0.2, "best_effort": 0.8},
            ),
        ],
        duration_s=50.0,
        drain_s=5.0,
        n_engines=2,
        seed=seed,
        max_queue_len=256,
        monitoring_interval_s=1.0,
        observatory=dict(OBSERVATORY_SOAK_POLICY),
    )


def observatory_mispricing_scenario(seed: int = 0) -> Scenario:
    """The observatory soak's GUILTY-HOP arm: light steady traffic with
    a generous SLO (no burn alerts — this arm isolates the fidelity
    instrument), but the one chip runs 3x SLOW from t=1 s and never
    heals, with NO gray detection armed to catch it. The cost model
    keeps pricing ``engine.step`` from the profile row, so live runs
    ~3x its prediction — drift ~0.67 against the 0.5 tolerance. The
    gate asserts the ``fidelity_drift`` audit record names
    ``engine.step`` and does NOT name ``queue.wait`` (unpriced by
    contract: the profile tables never claimed to know queueing, so a
    mispriced engine cannot defame the queue)."""
    return Scenario(
        models=[
            SimModelSpec(
                name="fast", slo_ms=4000.0,
                pattern=RatePattern("constant", base_rps=40.0),
            ),
        ],
        duration_s=40.0,
        drain_s=5.0,
        n_engines=1,
        seed=seed,
        monitoring_interval_s=1.0,
        degradations=[
            EngineDegradation(at_s=1.0, engine=0, factor=3.0),
        ],
        observatory=dict(OBSERVATORY_SOAK_POLICY),
    )


# --- compound-fault scenario matrix -------------------------------
#
# Single-fault soaks prove each defense in isolation; production outages
# are COMPOUND — a spike lands while a chip is dying, a query of death
# arrives mid-overload, and the client retry loop amplifies whatever is
# already wrong (Bronson et al.'s metastable-failure shape). The matrix
# composes the existing fault axes into named compound scenarios over
# one shared deployment, with the client-retry model armed in EVERY
# entry: retries are the amplifier that turns a transient fault into a
# sustained one, so every compound story is graded with amplification
# live. ``defenses=True`` arms the budget fraction + the governor's
# congested floor; ``defenses=False`` is the naive-client control arm
# (unbounded retries, no congested coupling) the metastability pin must
# grade STRICTLY worse.

# Every fault fires inside [COMPOUND_FAULT_AT_S, COMPOUND_FAULT_END_S];
# the metastability pin compares windowed attainment before the fault
# against the window after COMPOUND_RECOVER_BY_S — recovery must be
# monotone and complete within the bounded horizon.
COMPOUND_FAULT_AT_S = 12.0
COMPOUND_FAULT_END_S = 24.0
COMPOUND_RECOVER_BY_S = 38.0
COMPOUND_DURATION_S = 50.0

# The fault axes a compound name may compose ("retries" is implicit in
# every entry and accepted in names for readability).
COMPOUND_AXES: Tuple[str, ...] = (
    "spike", "death", "slowchip", "poison", "retries",
)

COMPOUND_SCENARIOS: Tuple[str, ...] = (
    "spike+retries",          # overload + retry storm
    "death+retries",          # engine death + retry storm
    "slowchip+retries",       # gray straggler + retry storm
    "poison+retries",         # query of death + retry storm
    "spike+death",            # overload lands on a dying cluster
    "spike+poison",           # query of death arrives mid-overload
    "death+slowchip",         # death + gray straggler (half-lame heal)
    "spike+death+poison",     # the kitchen sink
)

# The designated metastability scenario: the matrix soak runs its
# control arm (defenses=False) alongside and pins that the defended arm
# recovers to >= 0.95x pre-fault attainment within the horizon while
# the naive arm recovers strictly worse.
METASTABILITY_SCENARIO = "spike+death"


def compound_scenario(name: str, defenses: bool = True,
                      seed: int = 0) -> Scenario:
    """Build one named compound-fault scenario (cross-product grammar:
    ``axis+axis[+axis]`` over :data:`COMPOUND_AXES`).

    Shared deployment: 3 chips, ``fast`` (interactive mix, 60 rps) +
    ``burst`` (150 rps steady — ~0.65 of the 2-chip post-death
    capacity) with token-bucket admission armed. Client retries: up to
    6 attempts, 50 ms exponential backoff — every stale shed re-enters
    the front door as fresh demand. The defended arm bounds that to
    0.25x first-attempt volume and lets the governor's congested state
    zero it; the control arm retries without bound."""
    axes = [a for a in name.split("+") if a]
    unknown = set(axes) - set(COMPOUND_AXES)
    if unknown:
        raise ValueError(
            f"unknown compound axis(es) {sorted(unknown)} in {name!r}; "
            f"known: {', '.join(COMPOUND_AXES)}"
        )
    spike = "spike" in axes
    # Base demand sits at ~0.65 of POST-death capacity (150 rps burst on
    # the 2 surviving chips' ~230 rps): room enough for the defended arm
    # to recover fully within the horizon, tight enough that unbounded
    # retry amplification (up to 5 re-dispatches per shed) keeps the
    # naive arm shedding past it — the metastable gap the pin grades.
    burst_pattern = (
        RatePattern("spike", base_rps=150.0, amplitude=250.0,
                    spike_at_s=COMPOUND_FAULT_AT_S, spike_len_s=10.0)
        if spike else RatePattern("constant", base_rps=150.0)
    )
    sc = Scenario(
        models=[
            SimModelSpec(
                name="fast", slo_ms=400.0,
                pattern=RatePattern("constant", base_rps=60.0),
                class_mix={"interactive": 0.5, "standard": 0.5},
            ),
            SimModelSpec(
                name="burst", slo_ms=500.0,
                pattern=burst_pattern,
                class_mix={"interactive": 0.2, "standard": 0.3,
                           "best_effort": 0.5},
            ),
        ],
        duration_s=COMPOUND_DURATION_S,
        drain_s=5.0,
        n_engines=3,
        seed=seed,
        max_queue_len=2048,
        monitoring_interval_s=1.0,
        admission={
            "rate_rps": 500.0,
            "burst": 60.0,
            "degraded_class_fractions": {
                "interactive": 1.0, "standard": 0.6, "best_effort": 0.1,
            },
            "depth_high": 0.15,
            "depth_low": 0.02,
            # The congested floor is a DEFENSE: while first-attempt
            # compliance sits under it, the governor zeroes the retry
            # budget so recovery is monotone. The control arm runs
            # without it (0.0 = disabled).
            **({"congested_floor": 0.55, "congested_exit": 0.85}
               if defenses else {}),
        },
        retry={
            "max_attempts": 6,
            "backoff_ms": 50.0,
            # Work-conserving bound vs naive unbounded clients.
            "budget_fraction": 0.25 if defenses else None,
            "budget_window": 256,
            "min_first_attempts": 16,
        },
    )
    if "death" in axes:
        sc.failures.append(
            EngineFailure(at_s=COMPOUND_FAULT_AT_S, engine=2)
        )
    if "slowchip" in axes:
        sc.degradations.append(
            EngineDegradation(at_s=COMPOUND_FAULT_AT_S, engine=0,
                              factor=8.0,
                              heal_at_s=COMPOUND_FAULT_END_S)
        )
        # Gray detection armed (straggler_scenario's ratio-space knobs)
        # so the straggler is repriced, not just endured.
        sc.gray = {
            "p50_ratio": 3.0, "p95_ratio": 3.0, "min_abs_ms": 0.5,
            "min_samples": 2, "min_peers": 1, "suspect_after": 2,
            "probation_after": 2, "heal_after": 2,
            "probation_capacity": 0.4,
        }
    if "poison" in axes:
        sc.poisons.append(
            PoisonInjection(at_s=COMPOUND_FAULT_AT_S + 2.0,
                            model="burst",
                            repeat_at_s=COMPOUND_RECOVER_BY_S - 8.0)
        )
    return sc


def observatory_steady_scenario(seed: int = 0) -> Scenario:
    """The observatory soak's SILENCE arm: comfortably-provisioned
    steady traffic, nothing injected. Expected story: ZERO alert
    transitions, zero fidelity-drift records (``engine.step`` graded
    clean, ``queue.wait`` ungraded by contract), and a working
    forecaster — predictions scored every horizon with small error.
    An observatory that pages on a healthy cluster is worse than none;
    this arm is the false-positive gate."""
    return Scenario(
        models=[
            SimModelSpec(
                name="fast", slo_ms=2000.0,
                pattern=RatePattern("constant", base_rps=50.0),
            ),
            SimModelSpec(
                name="fat", slo_ms=4000.0,
                pattern=RatePattern("constant", base_rps=6.0),
            ),
        ],
        duration_s=40.0,
        drain_s=5.0,
        n_engines=3,
        seed=seed,
        monitoring_interval_s=1.0,
        observatory=dict(OBSERVATORY_SOAK_POLICY),
    )
