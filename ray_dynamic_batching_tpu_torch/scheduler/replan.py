"""The decide-replan step — pure, clock-free, shared by live and simulated.

``LiveScheduler.rebalance`` used to fuse three things: reading rates,
DECIDING (bin-pack + minimal-movement matching + audit payload), and
APPLYING (engine.assign, mark_scheduled, audit ring). The decision is a
pure function of (packer, engine residency, sessions, rates) — no
threads, no wall clock, no jax — so it lives here, consumed by BOTH the
threaded live path (`scheduler/control.py`) and the what-if simulator
(`sim/control.py`). The two callers must never fork this logic: a plan
the simulator grades is only trustworthy if it is byte-for-byte the plan
the live control loop would install (the no-drift pin in
``tests/test_sim.py``, same pattern as ``ops/tile_math.py`` sharing the
VMEM math between runtime picker and linter).

Reference lineage: rate-triggered replan + minimal-movement matching,
``293-project/src/scheduler.py:794-929``.

Own copy of ``ray_dynamic_batching_tpu/scheduler/replan.py``, whole, with
its import paths rewritten: on the same packer, residency, sessions and
rates both packages decide the same plan, assignment and audit payload.
The port has no simulator yet (``sim/``); the live path consumes it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_dynamic_batching_tpu_torch.engine.request import QOS_WEIGHTS
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile, mesh_chips
from ray_dynamic_batching_tpu_torch.scheduler.audit import plan_diff
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    NodePlan,
    Placement,
    Session,
    SquishyBinPacker,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("replan")

BRUTE_FORCE_LIMIT = 7  # assignment is brute-forced up to this many nodes

# Cross-mesh-shape migration premium (ms-equivalent per weight MB, on
# top of the load+compile the matcher already charges): re-laying a
# resident weight set over a different slice geometry moves every
# parameter byte through an all-gather + re-slice over ICI — roughly a
# read plus a write of the weights — where a same-shape move is a plain
# upload. One constant shared by matcher objective and audit pricing.
RESHARD_MB_FACTOR = 2.0

# Live-stream parcel courier rate (ms per MB of parcel bytes): a page
# fabric migration ships KV page contents + the stream cursor through
# host RAM across replicas (~8 GB/s effective for the gather-serialize-
# scatter round trip -> ~0.125 ms/MB). Priced in the SAME objective as
# resharding so "move the live streams" competes fairly with "move the
# weights"; the sim twin and the soak's pause model read this
# exact constant, the usual no-drift discipline.
COURIER_MS_PER_MB = 0.125


@dataclass
class ModelEntry:
    """Registered model contract (ref models_config, scheduler.py:30-35)."""

    name: str
    slo_ms: float
    seq_len: int = 0
    # Preferred serving mesh shape: "1x1" = single chip (the default,
    # and the only shape pre-mesh deployments ever register).
    mesh_shape: str = "1x1"
    # Speculative serving arm: "on" makes the packer price
    # this model from its spec profile rows at the PROFILED acceptance
    # rate (Session.spec/spec_acceptance/spec_tokens). Defaults keep
    # every pre-spec registration byte-identical.
    spec: str = "off"
    spec_acceptance: float = 0.0
    spec_tokens: int = 4
    # Chunk-interleaved prefill overhead per decode turn
    # (Session.prefill_chunk_ms — 0.0 keeps pre-chunked registrations
    # byte-identical).
    prefill_chunk_ms: float = 0.0


def weighted_attainment(
    class_counters: Dict[str, Dict[str, float]],
    weights: Optional[Dict[str, float]] = None,
) -> float:
    """Class-weighted SLO attainment — the planner's pricing of a miss.

    Plain attainment treats every shed request equally; the QoS contract
    does not: an interactive miss costs :data:`QOS_WEIGHTS` (4x) a
    best-effort one. This is the SHARED pricing function (sim reports,
    the overload-soak grade, live snapshots) so "did degradation stay
    graceful?" is answered by one formula on both sides — same no-drift
    discipline as ``decide_replan`` itself. Shed load (stale + dropped)
    counts as missed, exactly like ``sim/report.slo_attainment``.

    ``class_counters`` is per class ``{completed, violations, stale,
    dropped}`` (the queue's ``class_stats()`` shape). 1.0 when idle."""
    weights = weights if weights is not None else QOS_WEIGHTS
    w_accounted = 0.0
    w_missed = 0.0
    for cls, c in class_counters.items():
        w = weights.get(cls, 1.0)
        accounted = (c.get("completed", 0.0) + c.get("stale", 0.0)
                     + c.get("dropped", 0.0))
        missed = (c.get("violations", 0.0) + c.get("stale", 0.0)
                  + c.get("dropped", 0.0))
        w_accounted += w * accounted
        w_missed += w * missed
    return 1.0 - w_missed / w_accounted if w_accounted else 1.0


def sessions_for(
    models: Dict[str, ModelEntry], rates: Dict[str, float]
) -> List[Session]:
    """Sessions at the observed rates — the packer's input."""
    return [
        Session(
            model=e.name,
            slo_ms=e.slo_ms,
            rate_rps=rates.get(e.name, 0.0),
            seq_len=e.seq_len,
            mesh_shape=e.mesh_shape,
            spec=e.spec,
            spec_acceptance=e.spec_acceptance,
            spec_tokens=e.spec_tokens,
            prefill_chunk_ms=e.prefill_chunk_ms,
        )
        for e in models.values()
    ]


def degrade_sessions(
    sessions: List[Session],
    engine_widths: Optional[Sequence[int]],
    profiles: Dict[str, BatchProfile],
) -> Tuple[List[Session], Dict[str, Dict[str, str]]]:
    """Clamp each session's mesh shape to the SURVIVING slice geometry.

    A TP=4 model whose 4-chip slice just died must not demand a slice
    that no longer exists — it degrades to the largest profiled shape a
    surviving slice can carry (TP=4 -> the TP=2 row when only a
    half-slice remains), and upgrades back the moment a wide slice
    reappears (the same clamp, run at every decision, is the heal).
    Returns (sessions, {model: {"from": .., "to": ..}}) — the second
    half feeds the replan audit so a degraded placement is never
    silent. Pure: same inputs, same outputs, live and sim share it."""
    widths = {int(w) for w in (engine_widths if engine_widths else [1])}
    out: List[Session] = []
    degraded: Dict[str, Dict[str, str]] = {}
    for s in sessions:
        prof = profiles.get(s.model)
        shapes = prof.meshes() if prof is not None else ["1x1"]
        if s.chips in widths and s.mesh_shape in shapes:
            out.append(s)
            continue
        fitting = [sh for sh in shapes if mesh_chips(sh) in widths]
        best = None
        for sh in fitting:  # meshes() is ascending in chips
            if mesh_chips(sh) <= s.chips:
                best = sh
        if best is None and fitting:
            best = fitting[0]  # nothing smaller profiled: smallest fit
        if best is None or best == s.mesh_shape:
            out.append(s)  # nowhere to degrade to — starve loudly below
            continue
        degraded[s.model] = {"from": s.mesh_shape, "to": best}
        out.append(replace(s, mesh_shape=best))
    return out, degraded


def reshard_cost(
    model: str,
    from_mesh: str,
    to_mesh: str,
    profiles: Dict[str, BatchProfile],
) -> float:
    """Premium for moving a resident model BETWEEN mesh shapes: every
    weight byte transits an all-gather + re-slice over ICI on top of the
    plain upload the matcher already prices. 0 for a same-shape move.
    Priced at the DESTINATION shape's per-chip shard (the bytes each
    chip of the new slice must end up holding) — on mixed-mesh tables
    the unrestricted weights min is the widest mesh's shard, which
    would underprice every narrowing reshard."""
    if from_mesh == to_mesh:
        return 0.0
    prof = profiles.get(model)
    weight_mb = (prof.weights_hbm_bytes(to_mesh) / 1e6
                 if prof is not None else 1.0)
    return RESHARD_MB_FACTOR * weight_mb


def transfer_cost(
    engine_models: frozenset,
    plan: NodePlan,
    profiles: Dict[str, BatchProfile],
    resident_meshes: Optional[Dict[str, str]] = None,
) -> float:
    """Cost of pointing an engine at ``plan``: for every model the engine
    doesn't already host, charge weight bytes (upload) + compile time —
    plus the reshard premium when the model is currently resident
    SOMEWHERE in the domain at a different mesh shape than the plan's
    (``resident_meshes``: model -> hosted shape; None = classic
    single-chip pricing, byte-identical to the pre-mesh matcher)."""
    cost = 0.0
    for p in plan.placements:
        name = p.session.model
        if name in engine_models:
            continue
        prof = profiles.get(name)
        if prof is None:
            cost += 1.0
            continue
        # Keyed by the session's SPEC arm too: a spec
        # session's resident program set (draft + verify) is described
        # by its spec rows — compile_ms/hbm differ from the plain arm,
        # and on a spec-only table the default "off" lookup would find
        # nothing and silently price the 1000 ms compile guess.
        row = prof.row_for(
            p.batch_size, p.session.seq_len, plan.mesh_shape,
            p.session.spec,
        ) or prof.bucket_for(p.batch_size, p.session.seq_len,
                             plan.mesh_shape, p.session.spec)
        compile_ms = row.compile_ms if row else 1000.0
        # Upload priced at the PLAN's shape AND the session's spec arm:
        # each chip of the slice uploads its own weight shard, and a
        # spec session's set includes the draft model's weights (the
        # plain rows' min would shave them off). Single-shape/-arm
        # tables are unchanged.
        weight_mb = prof.weights_hbm_bytes(
            plan.mesh_shape, p.session.spec
        ) / 1e6
        cost += compile_ms + weight_mb  # ms-equivalent weighting
        if resident_meshes is not None and name in resident_meshes:
            cost += reshard_cost(
                name, resident_meshes[name], plan.mesh_shape, profiles
            )
    return cost


def fold_node_plans(target: NodePlan, extra: NodePlan) -> NodePlan:
    """Merge two node plans onto one chip: duty cycles add, occupancies
    rescale (``occ * old_duty / new_duty``) so every placement keeps its
    absolute slice milliseconds — degraded latency, never starvation.
    The fold keeps the TARGET's mesh shape (callers only fold
    same-shape plans — a program compiled for one slice geometry cannot
    time-slice on another)."""
    new_duty = target.duty_cycle_ms + extra.duty_cycle_ms
    if new_duty <= 0:
        return NodePlan(
            placements=list(target.placements) + list(extra.placements),
            duty_cycle_ms=new_duty,
            mesh_shape=target.mesh_shape,
        )
    rescaled = []
    for node in (target, extra):
        scale = node.duty_cycle_ms / new_duty
        rescaled.extend(
            Placement(p.session, p.batch_size, p.latency_ms,
                      p.occupancy * scale, p.hbm_bytes)
            for p in node.placements
        )
    return NodePlan(placements=rescaled, duty_cycle_ms=new_duty,
                    mesh_shape=target.mesh_shape)


def merge_overflow_nodes(
    plans: List[NodePlan], n_engines: int
) -> List[NodePlan]:
    """Fold a plan that needs more chips than exist onto the chips that
    do exist (degraded latency, never starvation).

    When the packer wants ``len(plans) > n_engines`` — typical right
    after an engine death shrinks the cluster — simply truncating would
    SILENTLY drop every model exclusive to the overflow nodes: their
    shared queues starve with no shed accounting (requests neither
    complete nor reject). Instead each overflow node is merged into the
    least-occupied retained node: duty cycles add, and occupancies are
    rescaled (``occ * old_duty / new_duty``) so every placement keeps
    its absolute slice milliseconds — each model still runs every
    ``new_duty`` ms, trading latency for coverage, which the SLO
    accounting then prices honestly as violations/sheds rather than
    hangs."""
    if n_engines <= 0 or len(plans) <= n_engines:
        return list(plans)
    merged = [
        NodePlan(placements=list(n.placements),
                 duty_cycle_ms=n.duty_cycle_ms,
                 mesh_shape=n.mesh_shape)
        for n in plans[:n_engines]
    ]
    for extra in plans[n_engines:]:
        host = min(range(len(merged)), key=lambda i: merged[i].occupancy)
        merged[host] = fold_node_plans(merged[host], extra)
    return merged


def fit_plans_to_geometry(
    plans: List[NodePlan], engine_widths: Sequence[int]
) -> List[NodePlan]:
    """Shrink a plan list onto a WIDTH-TYPED engine set: plans group by
    slice width, each group folds down (``merge_overflow_nodes``) to the
    number of engines of that width, and a group whose width has no
    engine at all is dropped with a loud capacity warning (its models
    re-enter planning next tick — typically degraded to a surviving
    shape by ``degrade_sessions`` — instead of silently starving behind
    an unassignable plan)."""
    from collections import Counter

    cap = Counter(int(w) for w in engine_widths)
    by_width: Dict[int, List[NodePlan]] = {}
    for p in plans:
        by_width.setdefault(p.chips, []).append(p)
    out: List[NodePlan] = []
    for width in sorted(by_width):
        group = by_width[width]
        have = cap.get(width, 0)
        if have == 0:
            logger.warning(
                "no %d-chip slice exists for %d node plan(s) (%s); "
                "dropping — geometry cannot carry this shape (capacity!)",
                width, len(group),
                sorted({m for n in group for m in n.models}),
            )
            continue
        if len(group) > have:
            logger.warning(
                "plan needs %d %d-chip slices but only %d exist; merging "
                "overflow nodes (degraded latency; capacity!)",
                len(group), width, have,
            )
            group = merge_overflow_nodes(group, have)
        out.extend(group)
    return out


def derate_for_capacity(
    assignment: List[Optional[NodePlan]],
    capacity_factors: Sequence[float],
    engine_widths: Optional[Sequence[int]] = None,
) -> Dict[int, Dict[str, int]]:
    """Price degraded engines as FRACTIONAL capacity (gray-failure
    probation) instead of alive/dead. Mutates ``assignment``
    in place; returns per-engine notes for the audit payload.

    An engine with ``factor < 1`` may only carry a plan whose occupancy
    fits the factor. First choice: SWAP its plan with the lightest
    fitting plan held by a full-capacity engine — the probationed chip
    keeps serving (its traffic doubles as the probe stream that makes a
    heal observable) while the heavy work moves to healthy hardware.
    Fallback: FOLD the whole plan onto the least-occupied full-capacity
    engine (degraded latency there, honest shed accounting — never a
    starved queue). With no full-capacity engine at all, the plan stays:
    slow beats starved. Width-typed engine sets (mesh slices) swap and
    fold only between SAME-WIDTH engines — a slice program cannot land
    on a chip set of a different width."""
    moved: Dict[int, Dict[str, int]] = {}
    widths = ([int(w) for w in engine_widths] if engine_widths is not None
              else [1] * len(capacity_factors))
    full = [j for j, f in enumerate(capacity_factors) if f >= 1.0 - 1e-9]
    for e, factor in enumerate(capacity_factors):
        plan = assignment[e]
        if (factor >= 1.0 - 1e-9 or plan is None
                or plan.occupancy <= factor + 1e-9):
            continue
        swaps = [
            j for j in full
            if widths[j] == widths[e]
            and assignment[j] is not None
            and assignment[j].occupancy <= factor + 1e-9
            and assignment[j].occupancy < plan.occupancy
        ]
        if swaps:
            j = min(swaps, key=lambda j: (assignment[j].occupancy, j))
            assignment[e], assignment[j] = assignment[j], assignment[e]
            moved[e] = {"swapped_with": j}
            continue
        hosts = [j for j in full if j != e and widths[j] == widths[e]]
        if not hosts:
            continue
        j = min(hosts, key=lambda j: (
            assignment[j].occupancy if assignment[j] is not None else 0.0,
            j,
        ))
        assignment[j] = (fold_node_plans(assignment[j], plan)
                         if assignment[j] is not None else plan)
        assignment[e] = None
        moved[e] = {"folded_into": j}
    return moved


def match_plans_to_engines(
    engine_models: List[frozenset],
    plans: List[NodePlan],
    profiles: Dict[str, BatchProfile],
    engine_widths: Optional[Sequence[int]] = None,
    resident_meshes: Optional[Dict[str, str]] = None,
) -> List[Optional[NodePlan]]:
    """Assign new node plans to engines minimizing total transfer cost.

    Brute-force over permutations for small counts (the reference's approach,
    scheduler.py:857-891), greedy best-match beyond BRUTE_FORCE_LIMIT.
    Returns, per engine, its new plan (None = engine idles).

    ``engine_widths`` types each engine as a chip SET (a mesh slice):
    a node plan may only land on an engine of exactly its width — a
    4-chip TP program cannot run on a single chip, and a single-chip
    duty cycle does not time-slice a gang-scheduled slice. None (the
    classic callers) = every engine is one chip, byte-identical
    behavior. ``resident_meshes`` threads the reshard premium into the
    matcher's own objective (see :func:`transfer_cost`)."""
    n_engines = len(engine_models)
    if engine_widths is None:
        padded: List[Optional[NodePlan]] = list(plans) + [None] * max(
            0, n_engines - len(plans)
        )
        if len(plans) > n_engines:
            logger.warning(
                "plan needs %d chips but only %d engines; merging overflow "
                "nodes (degraded latency; capacity!)",
                len(plans), n_engines,
            )
            padded = merge_overflow_nodes(plans, n_engines)
        widths = [1] * n_engines
    else:
        widths = [int(w) for w in engine_widths]
        fitted = fit_plans_to_geometry(plans, widths)
        padded = list(fitted) + [None] * (n_engines - len(fitted))

    def compatible(plan: Optional[NodePlan], e: int) -> bool:
        return plan is None or plan.chips == widths[e]

    if n_engines <= BRUTE_FORCE_LIMIT:
        best: Optional[Tuple[float, Tuple[int, ...]]] = None
        for perm in itertools.permutations(range(n_engines)):
            if not all(
                compatible(padded[i], e) for i, e in enumerate(perm)
            ):
                continue
            cost = sum(
                transfer_cost(engine_models[e], padded[i], profiles,
                              resident_meshes)
                for i, e in enumerate(perm)
                if padded[i] is not None
            )
            if best is None or cost < best[0]:
                best = (cost, perm)
        assignment: List[Optional[NodePlan]] = [None] * n_engines
        if best is None:  # fit_plans_to_geometry makes this unreachable
            logger.warning("no width-compatible assignment exists")
            return assignment
        for i, e in enumerate(best[1]):
            assignment[e] = padded[i]
        return assignment

    # Greedy: most expensive-to-move plans pick their cheapest engine first.
    order = sorted(
        [i for i, p in enumerate(padded) if p is not None],
        key=lambda i: -max(
            transfer_cost(m, padded[i], profiles, resident_meshes)
            for m in engine_models
        ),
    )
    free = set(range(n_engines))
    assignment = [None] * n_engines
    for i in order:
        fits = [e for e in free if compatible(padded[i], e)]
        if not fits:  # fit_plans_to_geometry makes this unreachable
            logger.warning(
                "no free %d-chip engine for plan %s",
                padded[i].chips, padded[i].describe(),
            )
            continue
        # Tie-break toward engines hosting fewer models so a zero-savings
        # plan lands on an empty engine instead of displacing a warm one.
        e = min(
            fits,
            key=lambda e: (
                transfer_cost(engine_models[e], padded[i], profiles,
                              resident_meshes),
                len(engine_models[e]),
                e,
            ),
        )
        assignment[e] = padded[i]
        free.remove(e)
    return assignment


@dataclass
class ReplanDecision:
    """Everything one replan decided, before anything is applied."""

    plan: List[NodePlan]
    assignment: List[Optional[NodePlan]]   # per engine; None = idle
    old_models: List[List[str]] = field(default_factory=list)
    new_models: List[List[str]] = field(default_factory=list)
    migration_cost: float = 0.0
    rates: Dict[str, float] = field(default_factory=dict)
    # Gray-failure pricing: the per-engine capacity factors the
    # decision was made under (None = every engine priced as a full chip)
    # and what the derate pass moved because of them.
    capacity_factors: Optional[List[float]] = None
    derated: Dict[int, Dict[str, int]] = field(default_factory=dict)
    # Mesh geometry (ROADMAP item 2): the slice widths the decision was
    # made over, and any sessions clamped to a surviving shape
    # (``degrade_sessions``). Empty/None on classic single-chip domains
    # so pre-mesh audit payloads stay byte-identical.
    engine_widths: Optional[List[int]] = None
    mesh_degraded: Dict[str, Dict[str, str]] = field(default_factory=dict)
    # Page-fabric courier share of migration_cost: what the
    # live-stream parcels leaving reassigned engines cost, already summed
    # into migration_cost. 0.0 (and elided from audits) when the caller
    # passed no parcel sizes — pre-fabric decisions stay byte-identical.
    live_migration_cost: float = 0.0

    def audit_fields(self) -> Dict[str, Any]:
        """The structured-audit payload (``scheduler/audit.py``), built
        fresh per call so rings never alias a shared dict."""
        observed: Dict[str, Any] = {
            "rates_rps": {k: round(v, 2) for k, v in self.rates.items()},
        }
        if self.capacity_factors is not None and any(
            f < 1.0 for f in self.capacity_factors
        ):
            observed["capacity_factors"] = [
                round(f, 3) for f in self.capacity_factors
            ]
            observed["derated"] = {
                str(k): v for k, v in sorted(self.derated.items())
            }
        if self.engine_widths is not None and any(
            w != 1 for w in self.engine_widths
        ):
            observed["engine_widths"] = list(self.engine_widths)
        if self.mesh_degraded:
            observed["mesh_degraded"] = {
                k: dict(v) for k, v in sorted(self.mesh_degraded.items())
            }
        placements = []
        for n in self.plan:
            for p in n.placements:
                entry = {"model": p.session.model, "batch": p.batch_size,
                         "latency_ms": round(p.latency_ms, 2),
                         "occupancy": round(p.occupancy, 3)}
                if n.mesh_shape != "1x1":
                    entry["mesh"] = n.mesh_shape
                placements.append(entry)
        if self.live_migration_cost > 0:
            observed["live_migration_cost"] = round(
                self.live_migration_cost, 1
            )
        return {
            "observed": observed,
            "inputs": {
                # The profile rows the packer committed to: per
                # placement, the (batch, latency) row that sized it.
                "placements": placements,
            },
            "before": [", ".join(m) for m in self.old_models],
            "after": [", ".join(m) for m in self.new_models],
            "diff": plan_diff(self.old_models, self.new_models),
            "migration_cost": round(self.migration_cost, 1),
        }


def decide_replan(
    packer: SquishyBinPacker,
    engine_models: Sequence[frozenset],
    sessions: List[Session],
    rates: Dict[str, float],
    capacity_factors: Optional[Sequence[float]] = None,
    engine_widths: Optional[Sequence[int]] = None,
    engine_meshes: Optional[Sequence[str]] = None,
    live_parcel_bytes: Optional[Sequence[float]] = None,
) -> ReplanDecision:
    """One replan, decided but not applied: bin-pack the sessions, match
    the resulting node plans onto the engines with minimal movement, and
    price the migration (the matcher's own objective — compile_ms +
    weight-MB for models not already resident, plus the reshard premium
    for cross-mesh-shape moves).

    ``capacity_factors`` (aligned with ``engine_models``; default all
    1.0) prices gray-degraded engines as FRACTIONAL chips: after
    matching, plans that overfill a derated engine are swapped with or
    folded onto full-capacity peers (:func:`derate_for_capacity`) — the
    probation story between alive and dead.

    ``engine_widths`` / ``engine_meshes`` (aligned with
    ``engine_models``) make the schedulable unit a chip SET: sessions
    degrade to the surviving slice geometry (:func:`degrade_sessions` —
    a TP=4 model falls back to its TP=2 row when only a half-slice
    remains), plans land only on width-matching engines, and moving a
    resident model between shapes is priced as a weight-reshard. None =
    the classic one-chip-per-engine domain, byte-identical decisions.

    ``live_parcel_bytes`` (aligned with ``engine_models``)
    gives each engine's live-stream KV parcel size: engines whose model
    set CHANGES under the new assignment must also courier those streams
    to their new homes, priced at :data:`COURIER_MS_PER_MB` in the same
    objective — a replan that would bounce many hot streams loses to one
    that leaves them put. None keeps pre-fabric decisions byte-identical."""
    engine_models = [frozenset(m) for m in engine_models]
    widths: Optional[List[int]] = None
    mesh_degraded: Dict[str, Dict[str, str]] = {}
    resident_meshes: Optional[Dict[str, str]] = None
    if engine_widths is not None:
        widths = [int(w) for w in engine_widths]
        if len(widths) != len(engine_models):
            raise ValueError(
                f"engine_widths has {len(widths)} entries for "
                f"{len(engine_models)} engines"
            )
        sessions, mesh_degraded = degrade_sessions(
            sessions, widths, packer.profiles
        )
    if engine_meshes is not None:
        if len(engine_meshes) != len(engine_models):
            raise ValueError(
                f"engine_meshes has {len(engine_meshes)} entries for "
                f"{len(engine_models)} engines"
            )
        resident_meshes = {}
        for mesh, models in zip(engine_meshes, engine_models):
            for m in models:
                resident_meshes.setdefault(m, str(mesh))
    plan = packer.plan(sessions)
    assignment = match_plans_to_engines(
        engine_models, plan, packer.profiles,
        engine_widths=widths, resident_meshes=resident_meshes,
    )
    derated: Dict[int, Dict[str, int]] = {}
    factors: Optional[List[float]] = None
    if capacity_factors is not None:
        factors = [float(f) for f in capacity_factors]
        if len(factors) != len(engine_models):
            raise ValueError(
                f"capacity_factors has {len(factors)} entries for "
                f"{len(engine_models)} engines"
            )
        derated = derate_for_capacity(assignment, factors,
                                      engine_widths=widths)
    migration_cost = sum(
        transfer_cost(engine_models[e], n, packer.profiles,
                      resident_meshes)
        for e, n in enumerate(assignment)
        if n is not None
    )
    live_cost = 0.0
    if live_parcel_bytes is not None:
        parcels = [float(b) for b in live_parcel_bytes]
        if len(parcels) != len(engine_models):
            raise ValueError(
                f"live_parcel_bytes has {len(parcels)} entries for "
                f"{len(engine_models)} engines"
            )
        for e, n in enumerate(assignment):
            new = frozenset(n.models) if n is not None else frozenset()
            if new != engine_models[e] and parcels[e] > 0:
                live_cost += parcels[e] / 1e6 * COURIER_MS_PER_MB
        migration_cost += live_cost
    return ReplanDecision(
        plan=plan,
        assignment=assignment,
        old_models=[sorted(m) for m in engine_models],
        new_models=[
            sorted(n.models) if n is not None else [] for n in assignment
        ],
        migration_cost=migration_cost,
        rates=dict(rates),
        capacity_factors=factors,
        derated=derated,
        engine_widths=widths,
        mesh_degraded=mesh_degraded,
        live_migration_cost=live_cost,
    )
