"""Simulated duty-cycle engine — ``engine/worker.py`` advanced by events.

One :class:`SimEngine` is one chip. It re-enacts ``ReplicaEngine``'s hot
loop against the virtual clock, with the committed profile tables as the
execution cost model (Clockwork's premise: per-batch latency on static
XLA buckets is predictable, so the table row IS the step):

live ``ReplicaEngine``                  | here
----------------------------------------|----------------------------------
``assign()`` queues a plan; swap lands  | ``assign()`` stores a pending
at a cycle boundary after off-thread    | plan; swapped at the next
prepare                                 | slice-0 event (prepare is
                                        | off-path live, so it costs the
                                        | simulated timeline nothing)
``_run_placement``: pop batch (fixed    | same pop against the sim queue
size, staleness discard at profiled     | (same staleness rule), then the
latency), run the compiled step         | step "runs" by advancing virtual
                                        | time by the profile row latency
slice sleep: co-tenant gets its         | slice advance =
``occupancy * duty`` share              | max(step_ms, occupancy * duty)
leftover duty-cycle absorption          | cycle end = max(cycle_start +
                                        | duty, last slice end)
idle engine sleeps ``idle_wait_s``      | idle event re-armed at
                                        | ``idle_wait_ms``

Each placement's slice is its OWN event (not one synchronous cycle), so
arrivals that land mid-cycle are visible to later slices exactly as they
are to the live pop at wall time.

Step latency uses the row's MEAN (what a live run actually measures per
step); optional seeded gaussian jitter (``latency_std_ms``) stays
deterministic. The planner's occupancy math keeps using worst-case —
that asymmetry is the live system's too.

Own copy of ``ray_dynamic_batching_tpu/sim/engine.py``, whole, with its
import paths rewritten. The ``batch`` / ``slot`` occupancy models, mesh
slices and the spec and chunked-prefill cost terms are host arithmetic
over ``BatchProfile`` rows and come whole; the spec and mesh engines
they price are not ported (ROADMAP queue 1 items 5 and 8).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from ray_dynamic_batching_tpu_torch.profiles.table import (
    BatchProfile,
    expected_tokens_per_round,
)
from ray_dynamic_batching_tpu_torch.scheduler.nexus import NodePlan, Placement
from ray_dynamic_batching_tpu_torch.sim.clock import EventLoop, VirtualClock
from ray_dynamic_batching_tpu_torch.sim.queue import SimQueueManager


class SimEngine:
    """One simulated chip's duty-cycle executor."""

    def __init__(
        self,
        engine_id: str,
        queues: SimQueueManager,
        profiles: Dict[str, BatchProfile],
        loop: EventLoop,
        clock: VirtualClock,
        idle_wait_ms: float = 10.0,
        jitter_rng: Optional[random.Random] = None,
        occupancy_model: str = "batch",
        occupancy_floor: float = 0.35,
        width: int = 1,
        chip_ids: Optional[List[str]] = None,
        spec_rates: Optional[Dict[str, float]] = None,
        prefill_mode: str = "mono",
        prefill_chunk_ms: float = 0.0,
        prefill_chunks_per_turn: int = 1,
    ) -> None:
        if occupancy_model not in ("batch", "slot"):
            raise ValueError(
                f"unknown occupancy_model {occupancy_model!r} "
                "(want 'batch' or 'slot')"
            )
        if prefill_mode not in ("mono", "chunked"):
            raise ValueError(
                f"unknown prefill_mode {prefill_mode!r} "
                "(want 'mono' or 'chunked')"
            )
        self.engine_id = engine_id
        self.queues = queues
        self.profiles = profiles
        self.loop = loop
        self.clock = clock
        self.idle_wait_ms = idle_wait_ms
        self.jitter_rng = jitter_rng  # None = exact mean latencies
        # Mesh slice (ROADMAP item 2): one SimEngine is one SCHEDULABLE
        # UNIT — a single chip (width 1, the classic domain) or a
        # gang-scheduled TP slice of ``width`` chips. A slice executes
        # node plans priced from its mesh profile rows; a single dead
        # chip fails the WHOLE slice (``fail_chip`` — the sim twin of
        # serve/failover.SliceDeadError), and the scheduler re-forms the
        # survivors into narrower slices at the heal tick.
        self.width = max(1, int(width))
        self.chip_ids = list(chip_ids) if chip_ids else [engine_id]
        self.dead_chips: set = set()
        self.failed_chip: Optional[int] = None
        # Decode cost model: "batch" prices every pop at the
        # profile row regardless of fill — the slab/shape-bucketed story,
        # where a 3-request pop in a 16-slot bucket pays the full step.
        # "slot" prices a partially-full pop at
        #   row_latency * (floor + (1 - floor) * fill)
        # — the paged/continuous-batching story: the floor is the
        # fill-invariant share (the weight stream a decode step pays no
        # matter how many slots are live), the proportional part the
        # per-slot KV traffic. Occupancy is ACCOUNTED in both modes (the
        # report's slot_occupancy) so slab-vs-paged what-ifs compare it.
        self.occupancy_model = occupancy_model
        self.occupancy_floor = float(occupancy_floor)
        # Speculative cost model: model -> LIVE draft-token
        # acceptance rate, a dict SHARED across the cluster's engines
        # and mutated by AcceptanceCollapse scenario events — the sim's
        # ground truth, which may diverge from the PROFILED rate the
        # planner priced with (that divergence is exactly what the
        # acceptance-collapse chaos arm measures). A spec placement's
        # step cost is its spec row's per-ROUND latency divided by
        # expected_tokens_per_round(live_rate, k); absent from the dict,
        # the session's planned rate applies.
        self.spec_rates: Dict[str, float] = (
            spec_rates if spec_rates is not None else {}
        )
        # Prefill interleave model: long-prompt requests
        # carry ``prefill_ms`` of prefill cost BEYOND the profile row.
        # "mono" executes it inside the popped turn (the whole train
        # stalls the slice — head-of-line blocking, the legacy
        # admission). "chunked" enqueues it on a FIFO chunk backlog the
        # engine drains between cycles at ``prefill_chunk_ms x
        # prefill_chunks_per_turn`` per cycle — the virtual-clock twin
        # of the engine's token-budget scheduler: decode turns advance
        # every cycle, and a long request completes when its last chunk
        # event lands.
        self.prefill_mode = prefill_mode
        self.prefill_chunk_ms = float(prefill_chunk_ms)
        self.prefill_chunks_per_turn = max(1, int(prefill_chunks_per_turn))
        self._prefill_backlog: List[list] = []  # [queue, request, remaining]
        self._plan = NodePlan()
        self._pending: Optional[NodePlan] = None
        self._cycle_start_ms = 0.0
        self._started = False
        # Scenario failure injection: a dead engine stops popping work at
        # its next event (queued requests live in the SHARED per-model
        # queues, so they wait for the heal replan, exactly as live).
        self.alive = True
        self.failed_at_ms: Optional[float] = None
        # Gray degradation (EngineDegradation): step latency multiplies
        # by slow_factor and gains stall_ms of dead air — the sim twin of
        # the live chaos slowdown modes. The engine stays "healthy()":
        # gray failures are exactly the ones liveness checks miss.
        self.slow_factor = 1.0
        self.stall_ms = 0.0
        self.degraded_at_ms: Optional[float] = None
        # Observed/expected step-latency ratios for the LAST executed
        # batches (model-agnostic: a healthy engine reads ~1.0 whatever
        # it hosts, a 10x straggler reads ~10). The gray monitor's sim
        # observations come from here; drained per monitor tick so a
        # heal is visible the tick after it happens. Armed only when a
        # scenario enables gray monitoring (no silent growth otherwise).
        self.track_ratios = False
        self._fresh_ratios: list = []
        # Last pre-degradation step cost: the synthetic probation
        # probe's baseline (an idled probationed engine executes no
        # batches, so it remembers what a step SHOULD cost).
        self._last_expected_ms = 10.0
        # --- accounting ---
        self.busy_ms = 0.0
        self.batches = 0
        self.requests = 0
        self.cycle_count = 0
        self.swap_count = 0
        # Slot-occupancy accounting: filled vs offered slots over every
        # EXECUTED batch (empty pops don't count — an idle engine is not
        # a half-empty one).
        self.slots_filled = 0
        self.slots_offered = 0
        # Query-of-death accounting: a popped batch holding a
        # poison request fails, and the engine pays ceil(log2(B)) full
        # bisection probes plus one rescue pass to isolate it (the live
        # replica's _bisect_poison cost model). The scheduler's
        # on_poison hook quarantines the condemned id cluster-wide.
        self.on_poison = None
        self.poison_probes = 0
        self.poison_rescues = 0
        self.poison_isolated = 0

    # --- scheduler-facing surface (duck-matches ReplicaEngine) -----------
    @property
    def models(self) -> List[str]:
        return [p.session.model for p in self._plan.placements]

    def assign(self, plan: NodePlan) -> None:
        """Queue a new node plan; applied at the next cycle boundary
        (live: background prepare, pointer swap at cycle boundary)."""
        self._pending = plan

    def healthy(self) -> bool:
        """Same liveness surface the live schedulers consult
        (``ReplicaEngine.healthy`` / test fakes)."""
        return self.alive

    @property
    def mesh_shape(self) -> str:
        """The slice's mesh-shape string (the planner's width key)."""
        return f"1x{self.width}"

    def fail(self) -> None:
        """Kill this engine at the current virtual time (a ``Scenario``
        failure event): every already-scheduled cycle/slice event becomes
        a no-op, so the engine executes nothing past this instant. The
        scheduler's monitor detects the death at its next tick — the same
        detection lag a live control loop pays."""
        if self.alive:
            self.alive = False
            self.failed_at_ms = self.clock.now_ms()

    def fail_chip(self, chip: int) -> None:
        """One chip of the slice dies -> the WHOLE slice fails (its
        compiled programs gang-schedule every chip; losing one loses the
        collective — the SliceDeadError semantics). The surviving chips
        stay healthy silicon: ``surviving_chips`` hands them to the
        scheduler's re-form pass at the heal tick."""
        if not 0 <= chip < self.width:
            raise ValueError(
                f"{self.engine_id}: chip {chip} out of range for a "
                f"width-{self.width} slice"
            )
        # Record the dead chip UNCONDITIONALLY: a second chip of an
        # already-dead slice (correlated rack event) must not be handed
        # back to _reform_slices as healthy silicon. Only the
        # slice-kill itself is once-only (fail() guards).
        self.dead_chips.add(int(chip))
        if self.failed_chip is None:
            self.failed_chip = int(chip)
        self.fail()

    def surviving_chips(self) -> List[str]:
        """Chip ids of this (dead) slice that are still good silicon."""
        return [
            c for i, c in enumerate(self.chip_ids)
            if i not in self.dead_chips
        ]

    def degrade(self, factor: float = 1.0, stall_ms: float = 0.0) -> None:
        """Apply a gray degradation (an ``EngineDegradation`` event):
        every later step costs ``factor x`` its profiled latency plus
        ``stall_ms`` of dead air. ``healthy()`` keeps answering True —
        detection is the gray monitor's job, not liveness's."""
        self.slow_factor = float(factor)
        self.stall_ms = float(stall_ms)
        self.degraded_at_ms = self.clock.now_ms()

    def heal_degradation(self) -> None:
        """The chip recovers (thermal event over): later steps cost the
        profile row again; the gray monitor sees ratios normalize."""
        self.slow_factor = 1.0
        self.stall_ms = 0.0

    @property
    def degraded(self) -> bool:
        return self.slow_factor != 1.0 or self.stall_ms != 0.0

    def drain_ratios(self) -> list:
        """Observed/expected step ratios since the last drain (the gray
        monitor's per-tick observation window)."""
        out, self._fresh_ratios = self._fresh_ratios, []
        return out

    def probe_ratio(self) -> float:
        """One synthetic probation probe: the observed/expected ratio a
        step would score under the CURRENT degradation, stall included —
        based on the last expected step cost so a stall-only straggler
        (factor 1.0, stall_ms > 0) still grades as an outlier instead of
        being prematurely readmitted. 1.0 once healed."""
        base = max(self._last_expected_ms, 1e-9)
        return (base * self.slow_factor + self.stall_ms) / base

    def describe(self) -> str:
        return (
            f"SimEngine({self.engine_id}, "
            f"duty={self._plan.duty_cycle_ms:.1f}ms, "
            f"models={sorted(self.models)})"
        )

    # --- event-driven hot loop -------------------------------------------
    def start(self) -> None:
        if not self._started:
            self._started = True
            self.loop.schedule_at(self.clock.now_ms(), self._on_cycle_start)

    def _step_latency_ms(self, p: Placement) -> float:
        """The cost model: the profile row for the placement's compiled
        bucket. Falls back to the placement's planned latency when the
        table lacks the row (the planner sized it from SOME row).

        Spec placements (session.spec == "on") execute at the spec
        row's per-ROUND latency divided by the expected tokens per
        round at the LIVE acceptance rate (``spec_rates`` — collapse
        events move it out from under the planner's profiled belief).
        Same ``expected_tokens_per_round`` formula the packer priced
        with: only the RATE can diverge, never the model."""
        prof = self.profiles.get(p.session.model)
        row = None
        if prof is not None:
            # Keyed by the session's mesh shape: a TP placement's cost
            # comes from its own slice rows (a default "1x1" lookup
            # would miss them and flatten every TP step to planned
            # worst-case latency, jitter-free).
            mesh = p.session.mesh_shape
            spec = p.session.spec
            row = (prof.row_for(p.batch_size, p.session.seq_len, mesh,
                                spec)
                   or prof.bucket_for(p.batch_size, p.session.seq_len,
                                      mesh, spec))
        if row is None:
            return p.latency_ms
        mean = row.latency_ms
        if self.jitter_rng is not None and row.latency_std_ms > 0:
            mean = max(
                0.1 * mean,
                self.jitter_rng.gauss(mean, row.latency_std_ms),
            )
        if p.session.spec == "on" and row.spec == "on":
            rate = self.spec_rates.get(
                p.session.model, p.session.spec_acceptance
            )
            mean = mean / expected_tokens_per_round(
                rate, p.session.spec_tokens
            )
        return mean

    def _drain_prefill_backlog(self) -> float:
        """Spend up to one cycle's chunk budget advancing the FIFO
        prefill backlog; requests whose last chunk lands complete at
        that virtual instant. Returns the virtual time spent (0.0 with
        an empty backlog — the pre-interleave timeline, bit for bit)."""
        if not self._prefill_backlog:
            return 0.0
        # Deadline economics FIRST: a train whose owner is already past
        # its deadline is shed like the queue's own stale discard (the
        # live engine never admits it — the queue stales it before a
        # slot frees) — never silently retained, never a drop.
        now = self.clock.now_ms()
        keep = []
        for entry in self._prefill_backlog:
            if entry[1].deadline_ms < now:
                entry[0].count_backlog_stale(entry[1])
            else:
                keep.append(entry)
        self._prefill_backlog = keep
        quantum = self.prefill_chunk_ms * self.prefill_chunks_per_turn
        spent = 0.0
        while self._prefill_backlog and spent < quantum - 1e-9:
            entry = self._prefill_backlog[0]
            step = min(entry[2], quantum - spent)
            entry[2] -= step
            spent += step
            if entry[2] <= 1e-9:
                self._prefill_backlog.pop(0)
                entry[0].record_batch_completion([entry[1]], now + spent)
        self.busy_ms += spent
        return spent

    def flush_prefill_backlog(self) -> int:
        """End-of-run shed: trains still holding chunks when the
        simulation horizon closes are discarded as stale (the live
        drain's abort path) so accounting conserves exactly. Returns
        the count."""
        n = len(self._prefill_backlog)
        for queue, req, _remaining in self._prefill_backlog:
            queue.count_backlog_stale(req)
        self._prefill_backlog = []
        return n

    def _on_cycle_start(self) -> None:
        if not self.alive:
            return
        if self._pending is not None:
            self._plan = self._pending
            self._pending = None
            self.swap_count += 1
        # Budgeted chunk work rides the cycle boundary: at most one
        # quantum between decode turns — the engine-side stall bound.
        spent = self._drain_prefill_backlog()
        if not self._plan.placements:
            self.loop.schedule_in(
                max(self.idle_wait_ms, spent), self._on_cycle_start
            )
            return
        self._cycle_start_ms = self.clock.now_ms()
        if spent > 0.0:
            self.loop.schedule_in(spent, lambda: self._on_slice(0))
        else:
            self._on_slice(0)

    def _on_slice(self, idx: int) -> None:
        if not self.alive:
            return
        plan = self._plan
        if idx >= len(plan.placements):  # plan shrank under us: new cycle
            self._end_cycle()
            return
        p = plan.placements[idx]
        queue = self.queues.queue(p.session.model)
        # Live NexusFixedBatch: fixed scheduled size, never waits, stale
        # discard priced at the placement's (worst-case) latency.
        batch = queue.get_batch(
            p.batch_size, expected_latency_ms=p.latency_ms
        )
        exec_ms = 0.0
        if batch:
            exec_ms = self._step_latency_ms(p)
            fill = len(batch) / max(1, p.batch_size)
            if self.occupancy_model == "slot":
                # Continuous/paged pricing: a partially-full decode turn
                # costs its fill-scaled share above the fixed floor —
                # the batch-formation stall's cost (full-step pricing of
                # near-empty batches) disappears.
                exec_ms *= (
                    self.occupancy_floor
                    + (1.0 - self.occupancy_floor) * min(1.0, fill)
                )
            if self.degraded or self.track_ratios:
                expected_ms = exec_ms
                self._last_expected_ms = expected_ms
                if self.degraded:
                    # Gray degradation prices on top of everything the
                    # healthy cost model charges (jitter, slot fill):
                    # a 10x straggler is 10x whatever it SHOULD cost.
                    exec_ms = exec_ms * self.slow_factor + self.stall_ms
                if self.track_ratios:
                    self._fresh_ratios.append(
                        exec_ms / max(expected_ms, 1e-9)
                    )
            self.slots_filled += len(batch)
            self.slots_offered += max(1, p.batch_size)
            poisoned = [r for r in batch
                        if getattr(r, "poison_id", None) is not None]
            if poisoned:
                # The step raised: bisect to isolate the query of death.
                # Cost = the failed step + one full re-execution per
                # probe (ceil(log2 B) of them) + one rescue pass for the
                # deferred half — same probe count the live replica's
                # bisection pin asserts. Innocents complete at the
                # delayed instant; the poison is terminally condemned
                # and its id quarantined at the front door.
                probes = (int(math.ceil(math.log2(len(batch))))
                          if len(batch) > 1 else 0)
                rescue = 1 if len(batch) > 1 else 0
                exec_ms += exec_ms * (probes + rescue)
                self.poison_probes += probes
                self.poison_rescues += rescue
                self.poison_isolated += len(poisoned)
                for r in poisoned:
                    queue.count_poisoned(r)
                    if self.on_poison is not None:
                        self.on_poison(r.poison_id, r.model)
                batch = [r for r in batch
                         if getattr(r, "poison_id", None) is None]
            # Long-prompt prefill beyond the profile row:
            # mono runs the whole train inside THIS turn (stalling the
            # slice and everything behind it); chunked defers it to the
            # cycle-boundary backlog — those requests complete when
            # their last budgeted chunk event lands, while the rest of
            # the batch completes on time.
            deferred = []
            if self.prefill_mode == "chunked" and self.prefill_chunk_ms > 0.0:
                deferred = [r for r in batch
                            if getattr(r, "prefill_ms", 0.0) > 0.0]
                self._prefill_backlog.extend(
                    [queue, r, r.prefill_ms] for r in deferred
                )
            else:
                exec_ms += sum(getattr(r, "prefill_ms", 0.0)
                               for r in batch)
            done = ([r for r in batch if r not in deferred]
                    if deferred else batch)
            if done:
                queue.record_batch_completion(
                    done, self.clock.now_ms() + exec_ms
                )
            self.busy_ms += exec_ms
            self.batches += 1
            self.requests += len(batch)
        slice_ms = p.occupancy * plan.duty_cycle_ms
        advance_ms = max(exec_ms, slice_ms)
        if idx + 1 < len(plan.placements):
            self.loop.schedule_in(
                advance_ms, lambda: self._on_slice(idx + 1)
            )
        else:
            # Floor the cycle at 0.5 ms of virtual time: a degenerate
            # zero-duty plan must not stall the event loop's clock.
            self.loop.schedule_at(
                max(
                    self._cycle_start_ms + max(plan.duty_cycle_ms, 0.5),
                    self.clock.now_ms() + advance_ms,
                ),
                self._end_cycle,
            )

    def _end_cycle(self) -> None:
        self.cycle_count += 1
        self._on_cycle_start()

    # --- accounting -------------------------------------------------------
    def occupancy(self, elapsed_ms: float) -> float:
        """Measured busy fraction over the run (the live engine's
        ENGINE_OCCUPANCY gauge analogue, but measured not scheduled)."""
        return self.busy_ms / elapsed_ms if elapsed_ms > 0 else 0.0

    def slot_occupancy(self) -> float:
        """Filled fraction of offered batch slots over executed batches
        (the live engine's ACTIVE_SLOTS / num_slots analogue): what share
        of the decode turns' slot capacity carried real work. 1.0 when
        the engine never ran a batch (an idle engine wastes nothing)."""
        if self.slots_offered == 0:
            return 1.0
        return self.slots_filled / self.slots_offered
