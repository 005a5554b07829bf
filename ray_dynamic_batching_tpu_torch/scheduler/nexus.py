"""Squishy bin packing — SLO-aware multi-model chip allocation (Nexus §6.1).

Own copy of ``ray_dynamic_batching_tpu/scheduler/nexus.py``, whole, with
its import paths rewritten: the duty-cycle packer for the vision path
(:class:`SquishyBinPacker`) and the decode colocation packer
(:func:`pack_llm_engines`). On the same sessions, profiles and config both
packages give equal plans. The text below is the reference's; on a card
"HBM" reads as the card's device memory, and its budget is the config's
``hbm_budget_bytes``, which the caller sets from the card.

Re-creates the algorithm of the reference's ``293-project/src/nexus.py``
(``scheduleSaturate`` :145, ``scheduleResidue`` :241, ``mergeNodes`` :203,
entry ``squishyBinPacking`` :129) with a TPU cost model:

- **HBM budget replaces gpu_mem** (ref nexus.py:156-165): a placement's
  footprint comes from the profile row's measured program footprint
  (weights + activations), and co-located models must *sum* within the chip's
  planning budget — weights stay resident in HBM across the duty cycle
  (there is no ``torch.cuda.empty_cache()`` hot path on TPU).
- **Batches are buckets**: candidate batch sizes are the profiled XLA
  buckets; merges re-derive batch = ceil(duty*rate/1000) (ref nexus.py:208)
  then round UP to a bucket, so a merged schedule never runs an uncompiled
  shape.
- **No preemptive time-slicing** (SURVEY.md §7(c)): occupancy is computed
  from worst-case step latency (mean + 2*std) because a long compiled step
  cannot be preempted mid-flight to honor a co-tenant's slice.
- The **SLO/2 rule** (ref nexus.py:154): a batch is admissible iff
  2 * worst_latency(batch) <= slo — half the budget for queueing, half for
  compute.

Vocabulary mapping (reference → here): session → :class:`Session`,
node → :class:`NodePlan`, (session, occupancy) pairs → :class:`Placement`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.profiles.table import (
    BatchProfile,
    ProfileRow,
    expected_tokens_per_round,
    mesh_chips,
)
from ray_dynamic_batching_tpu_torch.utils.config import get_config


@dataclass(frozen=True)
class Session:
    """A model's serving contract at the current request rate
    (ref: session, nexus.py:17)."""

    model: str
    slo_ms: float
    rate_rps: float
    seq_len: int = 0  # shape bucket for LLM prefill; 0 = fixed-shape
    # Mesh shape this model serves at (ROADMAP item 2): the packer prices
    # it from the profile rows measured at this shape and emits node
    # plans over mesh_chips(mesh_shape)-wide chip SETS. "1x1" = the
    # classic single-chip duty-cycle placement.
    mesh_shape: str = "1x1"
    # Speculative serving arm: "on" prices this model from
    # its spec profile rows — a row's per-ROUND latency divided by
    # expected_tokens_per_round(spec_acceptance, spec_tokens), the
    # planner's honest belief about what the PROFILED acceptance rate
    # buys. "off" (default) is byte-identical to the pre-spec packer.
    spec: str = "off"
    spec_acceptance: float = 0.0
    spec_tokens: int = 4
    # Chunk-interleaved prefill overhead: the expected
    # per-turn milliseconds of budgeted chunk work riding each decode
    # turn of this model (prefill_token_budget's worth of chunk program
    # between turns, amortized over the turns a cycle runs). 0.0 — the
    # default every pre-chunked registration keeps — is byte-identical
    # to the pre-interleave packer.
    prefill_chunk_ms: float = 0.0

    @property
    def chips(self) -> int:
        return mesh_chips(self.mesh_shape)


@dataclass
class Placement:
    """One session's slice of a chip (ref: node.sessions + occupancy lists)."""

    session: Session
    batch_size: int
    latency_ms: float       # worst-case step latency at this batch
    occupancy: float        # latency / duty_cycle
    hbm_bytes: int


@dataclass
class NodePlan:
    """One schedulable unit's duty-cycle schedule (ref: node, nexus.py:75).

    A unit is one chip (``mesh_shape == "1x1"``) or one mesh SLICE: a
    gang of ``chips`` chips running the co-located models' programs
    GSPMD-partitioned over the slice. ``hbm_bytes`` stays per-chip
    (mesh profile rows record per-chip footprints), so the chip budget
    check is shape-invariant."""

    placements: List[Placement] = field(default_factory=list)
    duty_cycle_ms: float = 0.0
    mesh_shape: str = "1x1"

    @property
    def chips(self) -> int:
        return mesh_chips(self.mesh_shape)

    @property
    def occupancy(self) -> float:
        return sum(p.occupancy for p in self.placements)

    @property
    def hbm_bytes(self) -> int:
        return sum(p.hbm_bytes for p in self.placements)

    @property
    def models(self) -> List[str]:
        return [p.session.model for p in self.placements]

    def describe(self) -> str:
        parts = ", ".join(
            f"{p.session.model}(b={p.batch_size}, occ={p.occupancy:.2f})"
            for p in self.placements
        )
        mesh = "" if self.mesh_shape == "1x1" else f"mesh={self.mesh_shape}, "
        return f"NodePlan(duty={self.duty_cycle_ms:.1f}ms, {mesh}[{parts}])"


def worst_latency_ms(row: ProfileRow) -> float:
    """Occupancy math uses worst-case step latency (no preemption on TPU)."""
    return row.latency_ms + 2.0 * row.latency_std_ms


class SquishyBinPacker:
    """The planner. One instance per scheduling domain (a set of identical
    chips); profiles keyed by model name."""

    def __init__(
        self,
        profiles: Dict[str, BatchProfile],
        hbm_budget_bytes: Optional[int] = None,
    ):
        cfg = get_config()
        self.profiles = profiles
        self.hbm_budget = int(
            (hbm_budget_bytes or cfg.hbm_budget_bytes) * cfg.hbm_plan_fraction
        )
        self.slo_safety = cfg.slo_safety_factor
        self.compute_fraction = cfg.slo_compute_fraction
        # Turn-cost pricing: "batch" charges every duty-cycle
        # slice the FULL bucket latency regardless of expected fill —
        # correct for slab/shape-bucketed decode, where a 3-request turn
        # in a 16-slot program costs the whole step. "slot" prices the
        # slice at its expected fill (continuous batching on the paged
        # pool: turn cost ~ floor + (1 - floor) * fill), so residue
        # merges pack partially-full decode turns instead of whole-batch
        # steps. SLO admission stays worst-case (a full turn can still
        # happen); only CAPACITY pricing changes. Default "batch" — the
        # sim pins it per scenario; live control opts in with the paged
        # engines.
        self.occupancy_pricing = "batch"
        self.occupancy_floor = 0.35

    def _session_wl(self, session: Session, row: ProfileRow) -> float:
        """Worst-case EFFECTIVE step latency of ``session`` at ``row``:
        a spec row's latency is one verify ROUND, so a spec session
        divides it by the expected tokens that round emits at the
        PROFILED acceptance rate (``expected_tokens_per_round`` — one
        shared formula with the sim engine's execution model). Non-spec
        sessions (and spec sessions whose table lacks spec rows — the
        ``_seq_rows`` fallback hands back plain rows, ``row.spec ==
        "off"``) price exactly as before, bit for bit."""
        wl = worst_latency_ms(row)
        if session.spec == "on" and row.spec == "on":
            wl = wl / expected_tokens_per_round(
                session.spec_acceptance, session.spec_tokens
            )
        if session.prefill_chunk_ms > 0.0:
            # Chunk-interleaved turns: each decode turn of a
            # chunked-admission engine may carry one budget's worth of
            # chunk program between it and the next — the stall bound
            # the engine enforces is exactly the cost the planner must
            # price, or co-located tenants get admitted into turns that
            # are secretly longer than their profile row.
            wl = wl + session.prefill_chunk_ms
        return wl

    def _turn_cost_ms(self, wl: float, fill: float) -> float:
        """Expected cost of one duty-cycle turn at ``fill`` (0..1] of the
        bucket: the fill-invariant floor is the weight stream every
        decode turn pays, the proportional part the per-slot KV scan."""
        if self.occupancy_pricing != "slot":
            return wl
        fill = min(max(fill, 0.0), 1.0)
        return wl * (self.occupancy_floor
                     + (1.0 - self.occupancy_floor) * fill)

    # --- admissible batch selection (ref nexus.py:145-165) ----------------
    def _effective_slo(self, session: Session) -> float:
        return session.slo_ms / self.slo_safety

    def saturate_row(self, session: Session) -> Optional[ProfileRow]:
        """Largest profiled bucket with worst_latency <= compute share of SLO
        and footprint within the chip budget. Rows come from the
        session's MESH SHAPE (per-slice latency, per-chip footprint), so
        a TP placement is priced from its own measured tables."""
        prof = self.profiles[session.model]
        budget_ms = self._effective_slo(session) * self.compute_fraction
        best = None
        for row in prof._seq_rows(session.seq_len, session.mesh_shape,
                                  session.spec):
            if (
                self._session_wl(session, row) <= budget_ms
                and row.hbm_bytes <= self.hbm_budget
            ):
                best = row
        return best

    # --- phase 1: saturated nodes (ref scheduleSaturate, nexus.py:145) ----
    def schedule_saturate(
        self, sessions: List[Session]
    ) -> Tuple[List[NodePlan], List[Session]]:
        """Split each session's rate R = n * maxThroughput + r
        (ref nexus.py:181-190); emit n fully-saturated single-model nodes and
        return the residue sessions for phase 2."""
        nodes: List[NodePlan] = []
        residues: List[Session] = []
        for session in sessions:
            row = self.saturate_row(session)
            if row is None:
                # No bucket fits the SLO: serve at the smallest bucket anyway
                # (degraded), one request-rate's worth of nodes.
                prof = self.profiles[session.model]
                rows = prof._seq_rows(session.seq_len, session.mesh_shape,
                                      session.spec)
                if not rows:
                    raise KeyError(
                        f"no profile rows for {session.model} at mesh "
                        f"{session.mesh_shape}"
                    )
                row = rows[0]
            wl = self._session_wl(session, row)
            max_throughput = row.batch_size / (wl / 1000.0)
            n_full = int(session.rate_rps // max_throughput)
            residue_rate = session.rate_rps - n_full * max_throughput
            for _ in range(n_full):
                nodes.append(
                    NodePlan(
                        placements=[
                            Placement(
                                session=session,
                                batch_size=row.batch_size,
                                latency_ms=wl,
                                occupancy=1.0,
                                hbm_bytes=row.hbm_bytes,
                            )
                        ],
                        duty_cycle_ms=wl,
                        mesh_shape=session.mesh_shape,
                    )
                )
            if residue_rate > 1e-9:
                residues.append(replace(session, rate_rps=residue_rate))
        return nodes, residues

    # --- phase 2: residue nodes (ref scheduleResidue, nexus.py:241) -------
    def residue_node(self, session: Session) -> Optional[NodePlan]:
        """Single-session node at its residual rate: pick the largest bucket
        whose *end-to-end* time — batch fill at the arrival rate plus compute —
        fits the SLO (ref nexus.py:246-257: bisect over latency + batch/rate);
        duty = batch/rate*1000, occupancy = latency/duty (ref nexus.py:263-268).
        """
        prof = self.profiles[session.model]
        rows = prof._seq_rows(session.seq_len, session.mesh_shape,
                              session.spec)
        rows = [r for r in rows if r.hbm_bytes <= self.hbm_budget]
        if not rows:
            return None
        slo = self._effective_slo(session)
        rate = max(session.rate_rps, 1e-9)
        chosen = rows[0]
        feasible = False
        for cand in rows:
            fill_ms = cand.batch_size / rate * 1000.0
            if self._session_wl(session, cand) + fill_ms <= slo:
                chosen = cand
                feasible = True
        wl = self._session_wl(session, chosen)
        duty = max(chosen.batch_size / rate * 1000.0, wl)
        if not feasible:
            # Even the smallest bucket cannot FILL within the SLO at this
            # arrival rate (the ref's duty = batch/rate, nexus.py:263-268,
            # would stretch the cycle past the deadline and every queued
            # request would wait it out). Serve under-filled batches
            # instead: bound the cycle by the SLO headroom so wait-one-
            # cycle + compute still fits. Costs occupancy, holds the SLO.
            duty = max(min(duty, slo - wl), wl)
        # Expected fill of one cycle's turn at this duty: under-filled
        # cycles (the not-feasible branch above) cost less than a full
        # step under slot pricing.
        fill = duty * rate / 1000.0 / chosen.batch_size
        return NodePlan(
            placements=[
                Placement(
                    session=session,
                    batch_size=chosen.batch_size,
                    latency_ms=wl,
                    occupancy=min(self._turn_cost_ms(wl, fill) / duty, 1.0),
                    hbm_bytes=chosen.hbm_bytes,
                )
            ],
            duty_cycle_ms=duty,
            mesh_shape=session.mesh_shape,
        )

    # --- merge (ref mergeNodes, nexus.py:202-228) --------------------------
    def try_merge(self, a: NodePlan, b: NodePlan) -> Optional[NodePlan]:
        """Merge two nodes onto one chip at duty = min(duties) (the reference
        keeps the lower-duty node's cycle so no session ever waits longer,
        nexus.py:203-207): every session's batch is re-derived as
        ceil(duty * rate / 1000) rounded UP to a profiled bucket
        (ref nexus.py:211); feasible iff total occupancy <= 1
        (ref nexus.py:218), summed HBM fits (ref nexus.py:222-226, gpu_mem →
        HBM budget), and — TPU addition — each re-derived bucket still meets
        its session's SLO end-to-end (bucket rounding can pick a bigger
        program than the exact batch the reference would run). Mesh
        addition: co-location is WITHIN a slice shape only — a 1x4
        slice's duty cycle can host another 1x4 program, but folding a
        single-chip program onto a slice (or vice versa) would change
        the chip set under a compiled program."""
        if a.mesh_shape != b.mesh_shape:
            return None
        duty = min(a.duty_cycle_ms, b.duty_cycle_ms)
        placements: List[Placement] = []
        hbm_total = 0
        occ_total = 0.0
        for p in a.placements + b.placements:
            s = p.session
            need = max(math.ceil(duty * s.rate_rps / 1000.0), 1)
            prof = self.profiles[s.model]
            row = prof.bucket_for(need, s.seq_len, s.mesh_shape, s.spec)
            if row is None:
                return None  # rate too high for any compiled bucket at this duty
            wl = self._session_wl(s, row)
            if wl + duty > self._effective_slo(s):
                return None  # wait-one-cycle + compute would blow the SLO
            # Capacity pricing at the EXPECTED turn fill (need requests
            # arrive per cycle; the bucket rounded up past it): slab
            # pricing charges the full step, slot pricing the fill-scaled
            # turn — the packing lever continuous batching unlocks.
            occ = self._turn_cost_ms(wl, need / row.batch_size) / duty
            occ_total += occ
            hbm_total += row.hbm_bytes
            if occ_total > 1.0 + 1e-9 or hbm_total > self.hbm_budget:
                return None
            placements.append(
                Placement(
                    session=s,
                    batch_size=row.batch_size,
                    latency_ms=wl,
                    occupancy=occ,
                    hbm_bytes=row.hbm_bytes,
                )
            )
        return NodePlan(placements=placements, duty_cycle_ms=duty,
                        mesh_shape=a.mesh_shape)

    def merge_residues(self, nodes: List[NodePlan]) -> List[NodePlan]:
        """Best-fit decreasing: walk residue nodes by descending occupancy and
        merge each into whichever existing node yields the highest resulting
        occupancy (ref nexus.py:271-293)."""
        merged: List[NodePlan] = []
        for residual in sorted(nodes, key=lambda n: -n.occupancy):
            best: Optional[NodePlan] = None
            best_idx = -1
            for i, existing in enumerate(merged):
                candidate = self.try_merge(existing, residual)
                if candidate is not None and (
                    best is None or candidate.occupancy > best.occupancy
                ):
                    best, best_idx = candidate, i
            if best is not None:
                merged[best_idx] = best
            else:
                merged.append(residual)
        return merged

    # --- entry point (ref squishyBinPacking, nexus.py:129) -----------------
    def plan(self, sessions: List[Session]) -> List[NodePlan]:
        active = [s for s in sessions if s.rate_rps > 0]
        saturated, residues = self.schedule_saturate(active)
        residue_nodes = [
            n for s in residues if (n := self.residue_node(s)) is not None
        ]
        return saturated + self.merge_residues(residue_nodes)

    def chips_required(self, sessions: List[Session]) -> int:
        """Physical chips the plan consumes: each node costs its slice
        width (1 for classic single-chip nodes — unchanged there)."""
        return sum(n.chips for n in self.plan(sessions))


# --- LLM decode colocation (the control theory applied to decode) ----------
#
# The duty-cycle packer above time-slices ONE compiled program per model
# through a cycle; continuous-batching decode engines instead run all the
# time, so their cost model is a COMPUTE FRACTION plus resident HBM:
# an engine with a measured per-substep latency `step_ms` at `num_slots`
# occupancy produces slots/step tokens per ms of chip time. Serving
# R tokens/s therefore needs fraction f = R*step_ms/(1000*slots) of the
# chip, and a co-tenant set fits iff fractions sum under a headroom and
# resident footprints sum under the HBM budget — the same
# admissibility-from-measured-tables discipline as the reference's
# squishyBinPacking (293-project/src/nexus.py:129-296), with the decode
# tables of profiles.decode_profiler as ground truth.


@dataclass(frozen=True)
class LLMSession:
    """One LLM's decode serving contract (the decode analogue of
    :class:`Session`)."""

    model: str
    rate_tok_s: float        # offered decode demand, tokens/s
    token_slo_ms: float      # per-token latency SLO (inter-token gap)
    # Minimum KV capacity (prompt + generation) a placement must hold:
    # shorter-capacity rows are cheaper on every axis, so without this
    # filter the picker would always "win" with caches too small for the
    # workload's real conversations (mirror of Session.seq_len).
    min_context: int = 0


@dataclass(frozen=True)
class LLMPlacement:
    model: str
    num_slots: int
    capacity: int            # KV capacity (max_len) of the chosen config
    step_ms: float
    compute_fraction: float
    hbm_bytes: int


def _pick_llm_row(
    session: LLMSession, profile: BatchProfile, headroom: float,
    hbm_budget: float,
) -> Optional[LLMPlacement]:
    """The measured (slots, capacity) config serving this session's rate
    within its token SLO at minimal COMPUTE FRACTION (ties: minimal HBM)
    — compute is the binding resource for colocation density; a config
    that halves the fraction for a few hundred KB of extra KV rows packs
    strictly more co-tenants per chip.

    Sharing stretches the observed inter-token gap to ~step_ms/f, so the
    SLO requires f >= step_ms/slo on top of the capacity requirement
    f >= rate*step/(1000*slots); a row is feasible iff that combined
    fraction fits under the headroom, its program fits the HBM budget,
    and its KV capacity covers the session's context. SLO feasibility
    uses worst-case latency (mean + 2*std, ``worst_latency_ms``) — the
    no-preemption discipline of the duty-cycle packer — while capacity
    throughput uses the mean.
    """
    best: Optional[LLMPlacement] = None
    for row in profile.rows:
        if row.spec != "off":
            # Spec rows cost one verify ROUND, not one step:
            # pricing them here without the expected_tokens_per_round
            # conversion would mis-unit step_ms/compute_fraction by up
            # to E(a,k)x. This packer plans plain decode engines; the
            # duty-cycle packer above is the spec-aware one.
            continue
        if row.latency_ms <= 0 or row.hbm_bytes <= 0:
            continue
        if row.hbm_bytes > hbm_budget:
            continue  # the budget filters per ROW, like saturate_row
        if row.seq_len < session.min_context:
            continue  # cache too small for the workload's conversations
        worst_ms = worst_latency_ms(row)
        if worst_ms > session.token_slo_ms:
            continue  # even a dedicated chip would miss the SLO
        f_capacity = (
            session.rate_tok_s * row.latency_ms
            / (1000.0 * row.batch_size)
        )
        f_slo = worst_ms / session.token_slo_ms
        f = max(f_capacity, f_slo)
        if f > headroom:
            continue
        cand = LLMPlacement(
            model=session.model,
            num_slots=row.batch_size,
            capacity=row.seq_len,
            step_ms=row.latency_ms,
            compute_fraction=f,
            hbm_bytes=row.hbm_bytes,
        )
        if (best is None
                or (cand.compute_fraction, cand.hbm_bytes)
                < (best.compute_fraction, best.hbm_bytes)):
            best = cand
    return best


def pack_llm_engines(
    sessions: List[LLMSession],
    decode_profiles: Dict[str, BatchProfile],
    hbm_budget_bytes: Optional[int] = None,
    compute_headroom: float = 0.85,
) -> List[List[LLMPlacement]]:
    """First-fit-decreasing colocation of decode engines onto chips.

    Returns one list of placements per chip. Raises ``ValueError`` when a
    session has no feasible measured config (missing table, SLO tighter
    than every measured step, or demand beyond a whole chip) — the caller
    must re-profile or relax, exactly like the duty-cycle packer's
    contract that only profiled shapes are schedulable.
    """
    cfg = get_config()
    budget = float(
        hbm_budget_bytes
        if hbm_budget_bytes is not None
        else cfg.hbm_budget_bytes * cfg.hbm_plan_fraction
    )
    placements: List[LLMPlacement] = []
    for session in sessions:
        profile = decode_profiles.get(session.model)
        if profile is None:
            raise ValueError(
                f"{session.model}: no decode profile — run the decode "
                "profiler (tools/run_profiles.py)"
            )
        placed = _pick_llm_row(session, profile, compute_headroom, budget)
        if placed is None:
            raise ValueError(
                f"{session.model}: no measured decode config serves "
                f"{session.rate_tok_s:.0f} tok/s within a "
                f"{session.token_slo_ms:.0f} ms token SLO "
                f"(min context {session.min_context}) under "
                f"{budget / 1e9:.1f} GB on one chip"
            )
        placements.append(placed)
    chips: List[List[LLMPlacement]] = []
    for p in sorted(placements, key=lambda p: -p.compute_fraction):
        for chip in chips:
            if (sum(c.compute_fraction for c in chip) + p.compute_fraction
                    <= compute_headroom
                    and sum(c.hbm_bytes for c in chip) + p.hbm_bytes
                    <= budget):
                chip.append(p)
                break
        else:
            chips.append([p])
    return chips
