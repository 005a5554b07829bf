"""The port's simulator (``ray_dynamic_batching_tpu_torch/sim``) against
the JAX package's.

Twins of the reference's ``tests/test_sim.py``, ``tests/test_spec_sim.py``
and ``tests/test_partition_sim.py``: event kernel, live-semantics queues,
determinism, replay sources, the spike/migration story, the A/B harness,
virtual-time audit records, the decide-replan no-drift pin, the
occupancy, interleave and spec cost models, the CLI and the partition
matrix, each on the port's modules. The twins that pin the reference's
canon run inside ``reference_headroom()`` (the reference's rule, rates
as read); the rest run at the port's rule (``1 + RATE_HEADROOM``).

Then both packages side by side: under ``reference_headroom()`` every
``sim/scenarios.py`` builder, ``run_frontdoor_sim``, each
``run_partition_sim`` kind and each ``run_migration_sim`` arm render
byte-identical reports; the ``--smoke`` reference arm reproduces the
canon and the port arm its own numbers; and the demo's rate step on the
H100 tables replays to the JAX simulator's halves at 0.0 and holds every
half at the port's rule.
"""

import json

import pytest

from ray_dynamic_batching_tpu_torch.engine.workload import (
    RatePattern,
    WorkloadDriver,
)
from ray_dynamic_batching_tpu_torch.profiles.table import (
    BatchProfile,
    ProfileRow,
    expected_tokens_per_round,
)
from ray_dynamic_batching_tpu_torch.scheduler import control
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    Session,
    SquishyBinPacker,
)
from ray_dynamic_batching_tpu_torch.scheduler.replan import decide_replan
from ray_dynamic_batching_tpu_torch.sim import (
    EventLoop,
    Simulation,
    VirtualClock,
    compare_reports,
    render_json,
)
from ray_dynamic_batching_tpu_torch.sim.frontdoor import run_partition_sim
from ray_dynamic_batching_tpu_torch.sim.queue import (
    SimRequest,
    SimRequestQueue,
)
from ray_dynamic_batching_tpu_torch.sim.scenarios import (
    PARTITION_SCENARIOS,
    SPEC_ROUND_OVERHEAD,
    fixture_profiles,
    partition_scenario,
    smoke_scenario,
    spec_profiles,
    spec_scenario,
)
from ray_dynamic_batching_tpu_torch.sim.simulator import (
    AcceptanceCollapse,
    Scenario,
    SimModelSpec,
)
from ray_dynamic_batching_tpu_torch.sim.workload import (
    arrivals_from_spans,
    load_recorded_arrivals,
    scale_arrivals,
    synthetic_arrivals,
)


@pytest.fixture
def reference_rule():
    """The reference's planning rule (headroom 0.0) for one test."""
    with control.reference_headroom():
        yield


# --- twins of tests/test_sim.py -------------------------------------------
class TestEventKernel:
    def test_events_fire_in_time_order_with_insertion_ties(self):
        clock = VirtualClock()
        loop = EventLoop(clock)
        fired = []
        loop.schedule_at(20.0, lambda: fired.append(("b", clock.now_ms())))
        loop.schedule_at(10.0, lambda: fired.append(("a", clock.now_ms())))
        loop.schedule_at(20.0, lambda: fired.append(("c", clock.now_ms())))
        n = loop.run_until(30.0)
        assert n == 3
        assert fired == [("a", 10.0), ("b", 20.0), ("c", 20.0)]
        assert clock.now_ms() == 30.0

    def test_events_scheduled_during_run_interleave(self):
        clock = VirtualClock()
        loop = EventLoop(clock)
        fired = []

        def recurring():
            fired.append(clock.now_ms())
            loop.schedule_in(10.0, recurring)

        loop.schedule_at(0.0, recurring)
        loop.run_until(35.0)
        assert fired == [0.0, 10.0, 20.0, 30.0]

    def test_past_schedules_clamp_to_now(self):
        clock = VirtualClock()
        loop = EventLoop(clock)
        loop.run_until(50.0)
        fired = []
        loop.schedule_at(10.0, lambda: fired.append(clock.now_ms()))
        loop.run_until(60.0)
        assert fired == [50.0]


class TestSimQueue:
    """The live RequestQueue contract (engine/queue.py) at virtual time."""

    def _q(self, max_len=4):
        clock = VirtualClock()
        return SimRequestQueue("m", clock, max_len=max_len), clock

    def test_drop_when_full(self):
        q, _ = self._q(max_len=2)
        assert q.add_request(SimRequest("m", 0.0, 100.0))
        assert q.add_request(SimRequest("m", 0.0, 100.0))
        assert not q.add_request(SimRequest("m", 0.0, 100.0))
        assert q.total_dropped == 1 and q.total_enqueued == 2

    def test_stale_discard_at_profiled_latency(self):
        # Live rule: deadline < now + expected_latency => discarded.
        q, clock = self._q()
        q.add_request(SimRequest("m", arrival_ms=0.0, slo_ms=100.0))
        q.add_request(SimRequest("m", arrival_ms=90.0, slo_ms=100.0))
        clock._now_ms = 95.0
        batch = q.get_batch(8, expected_latency_ms=10.0)
        # req1 deadline 100 < 95+10 -> stale; req2 deadline 190 survives
        assert len(batch) == 1 and batch[0].arrival_ms == 90.0
        assert q.total_stale == 1

    def test_completion_accounting_and_percentiles(self):
        q, clock = self._q()
        reqs = [SimRequest("m", arrival_ms=0.0, slo_ms=50.0)
                for _ in range(4)]
        for r in reqs:
            q.add_request(r)
        clock._now_ms = 10.0
        batch = q.get_batch(4, expected_latency_ms=5.0)
        violations = q.record_batch_completion(batch, completed_at_ms=60.0)
        assert violations == 4 and q.total_violations == 4
        stats = q.stats()
        assert stats["completed"] == 4.0
        assert stats["latency_p99_ms"] == 60.0
        assert stats["slo_compliance"] == 0.0


def _packer():
    packer = SquishyBinPacker(fixture_profiles(), hbm_budget_bytes=12 << 30)
    packer.hbm_budget = int((12 << 30) * 0.9)
    packer.slo_safety = 2.2
    packer.compute_fraction = 0.5
    return packer


class TestDecideReplanNoDrift:
    """Pin: LiveScheduler.rebalance and the sim consume the SAME pure
    decision — plan, assignment, audit payload, migration cost. A fork
    of the decide step in either caller fails this."""

    class _FakeEngine:
        def __init__(self):
            self.assigned = []

        @property
        def models(self):
            return (sorted(self.assigned[-1].models)
                    if self.assigned else [])

        def assign(self, plan):
            self.assigned.append(plan)

        def describe(self):
            return "fake"

    def _live(self):
        from ray_dynamic_batching_tpu_torch.scheduler.control import (
            LiveScheduler,
        )

        engines = [self._FakeEngine(), self._FakeEngine()]
        sched = LiveScheduler(_packer(), engines)
        sched.register_model("fast", slo_ms=200.0)
        sched.register_model("burst", slo_ms=500.0)
        return sched, engines

    def test_live_rebalance_matches_pure_decision(self):
        rates = {"fast": 60.0, "burst": 30.0}
        sched, engines = self._live()
        live_plan = sched.rebalance(rates=rates)
        live_audit = sched.audit.records()[-1]

        decision = decide_replan(
            _packer(), [frozenset(), frozenset()],
            control.planned_sessions(sched._models, rates), rates,
        )
        assert [n.describe() for n in live_plan] == \
               [n.describe() for n in decision.plan]
        fields = decision.audit_fields()
        assert live_audit.before == fields["before"]
        assert live_audit.after == fields["after"]
        assert live_audit.diff == fields["diff"]
        assert live_audit.observed == fields["observed"]
        assert live_audit.inputs == fields["inputs"]
        assert live_audit.migration_cost == fields["migration_cost"]

    def test_second_rebalance_sees_residency(self):
        # The minimal-movement matcher prices residency; a second replan
        # through the live path must equal the pure decision computed
        # from the engines' post-first-replan residency.
        sched, engines = self._live()
        sched.rebalance(rates={"fast": 60.0, "burst": 30.0})
        resident = [frozenset(e.models) for e in engines]

        rates2 = {"fast": 60.0, "burst": 160.0}
        decision = decide_replan(
            _packer(), resident,
            control.planned_sessions(sched._models, rates2), rates2,
        )
        sched.rebalance(rates=rates2)
        live_audit = sched.audit.records()[-1]
        assert live_audit.diff == decision.audit_fields()["diff"]
        assert live_audit.migration_cost == \
               decision.audit_fields()["migration_cost"]


class TestDeterminism:
    def test_same_seed_byte_identical_reports(self):
        a = render_json(Simulation(fixture_profiles(), smoke_scenario()).run())
        b = render_json(Simulation(fixture_profiles(), smoke_scenario()).run())
        assert a == b

    def test_different_seed_differs(self):
        a = render_json(
            Simulation(fixture_profiles(), smoke_scenario(seed=0)).run()
        )
        b = render_json(
            Simulation(fixture_profiles(), smoke_scenario(seed=1)).run()
        )
        assert a != b  # Poisson arrivals re-drawn

    def test_latency_jitter_stays_deterministic(self):
        sc1 = smoke_scenario()
        sc1.latency_jitter = True
        sc2 = smoke_scenario()
        sc2.latency_jitter = True
        profiles = fixture_profiles()
        assert render_json(Simulation(profiles, sc1).run()) == \
               render_json(Simulation(profiles, sc2).run())


class TestSpikeScenario:
    def test_spike_forces_migration_and_cotenants_hold(self):
        report = Simulation(fixture_profiles(), smoke_scenario()).run()
        assert report["migrations"] >= 1
        assert report["chips_used"] >= 2
        # Co-tenants ride through the spike; burst sheds only transiently.
        assert report["models"]["fast"]["slo_attainment"] >= 0.93
        assert report["models"]["fat"]["slo_attainment"] >= 0.99
        assert report["models"]["burst"]["slo_attainment"] >= 0.80
        assert report["models"]["burst"]["completed"] > 0
        # The audit ring saw the rate_change decisions.
        triggers = {r["trigger"] for r in report["audit"]}
        assert "rate_change" in triggers

    def test_what_if_more_chips_cannot_hurt(self):
        sc2 = smoke_scenario()
        sc2.n_engines = 1  # starve it instead: one chip for everything
        starved = Simulation(fixture_profiles(), sc2).run()
        full = Simulation(fixture_profiles(), smoke_scenario()).run()
        worst_starved = min(
            m["slo_attainment"] for m in starved["models"].values()
        )
        worst_full = min(
            m["slo_attainment"] for m in full["models"].values()
        )
        assert worst_full >= worst_starved - 1e-9
        diff = compare_reports(starved, full, "one_chip", "three_chips")
        assert diff["winner"] in ("three_chips", "tie")

    def test_rate_scale_what_if_degrades_attainment(self):
        base = Simulation(fixture_profiles(), smoke_scenario()).run()
        sc = smoke_scenario()
        sc.rate_scale = 6.0
        sc.n_engines = 1
        heavy = Simulation(fixture_profiles(), sc).run()
        assert heavy["arrivals_total"] > 4 * base["arrivals_total"]
        assert (
            min(m["slo_attainment"] for m in heavy["models"].values())
            < min(m["slo_attainment"] for m in base["models"].values())
        )


class TestAuditVirtualTime:
    def test_audit_records_carry_virtual_timestamps(self):
        report = Simulation(fixture_profiles(), smoke_scenario()).run()
        times = [r["wall_time"] for r in report["audit"]]
        assert times, "no audit records"
        # Virtual seconds within the run horizon, monotonically ordered.
        assert all(0.0 <= t <= 65.0 for t in times)
        assert times == sorted(times)
        assert report["audit"][0]["trigger"] == "manual"
        assert all(r["domain"] == "sim" for r in report["audit"])

    def test_live_default_still_wall_clock(self):
        import time

        from ray_dynamic_batching_tpu_torch.scheduler.audit import AuditLog

        rec = AuditLog("nexus").record("manual")
        assert abs(rec.wall_time - time.time()) < 5.0


class TestWorkloadSources:
    def test_synthetic_matches_live_driver_offsets(self, tmp_path):
        # The WorkloadDriver records EXACTLY the offsets the simulator
        # synthesizes for the same (pattern, seed): record a real driven
        # run, then check the replay list.
        pattern = RatePattern("constant", base_rps=200.0)
        path = tmp_path / "arrivals.jsonl"
        path.write_text("")
        driver = WorkloadDriver(
            lambda model, offset: None, "m", pattern,
            duration_s=0.2, poisson=True, seed=11,
            record_path=str(path),
        )
        driver.start()
        driver.join(10.0)
        recorded = load_recorded_arrivals(str(path))
        synthetic = synthetic_arrivals("m", pattern, 0.2,
                                       poisson=True, seed=11)
        assert driver.sent == len(synthetic)
        assert [round(t, 6) for t, _ in synthetic] == \
               [round(t, 6) for t, _ in recorded]

    def test_recorded_replay_through_simulation(self, tmp_path):
        arrivals = synthetic_arrivals(
            "fast", RatePattern("constant", base_rps=50.0), 10.0,
            poisson=True, seed=3,
        )
        path = tmp_path / "arr.jsonl"
        path.write_text("".join(
            json.dumps({"t_s": t, "model": m}) + "\n" for t, m in arrivals
        ))
        sc = Scenario(
            models=[SimModelSpec("fast", slo_ms=200.0)],
            duration_s=10.0, n_engines=1, seed=0,
            monitoring_interval_s=2.0,
            arrivals=load_recorded_arrivals(str(path)),
        )
        report = Simulation(fixture_profiles(), sc).run()
        assert report["arrivals_total"] == len(arrivals)
        m = report["models"]["fast"]
        # Every recorded arrival is accounted for: served, shed, or
        # still queued at the horizon (short runs shed on cold start).
        assert m["completed"] + m["stale"] + m["dropped"] + m["pending"] \
               == len(arrivals)
        assert m["completed"] > 0.7 * len(arrivals)

    def test_arrivals_from_span_dump(self, tmp_path):
        spans = [
            {"name": "queue.wait", "trace_id": "t1", "span_id": 1,
             "parent_id": None, "start_ms": 1000.0, "end_ms": 1010.0,
             "attributes": {"model": "fast"}, "links": []},
            {"name": "engine.step", "trace_id": "t1", "span_id": 2,
             "parent_id": None, "start_ms": 1010.0, "end_ms": 1020.0,
             "attributes": {"model": "fast"}, "links": []},
            {"name": "queue.wait", "trace_id": "t2", "span_id": 3,
             "parent_id": None, "start_ms": 1500.0, "end_ms": 1600.0,
             "attributes": {"model": "burst"}, "links": []},
        ]
        path = tmp_path / "spans.jsonl"
        path.write_text("".join(json.dumps(s) + "\n" for s in spans))
        arrivals = arrivals_from_spans(str(path))
        assert arrivals == [(0.0, "fast"), (0.5, "burst")]

    def test_truncated_and_unregistered_arrivals_are_reported(self):
        # A trace longer than the horizon, plus a model the scenario
        # never registered: neither silently counts as offered load.
        arrivals = [(0.5, "fast"), (1.0, "ghost"), (2.0, "fast"),
                    (9.0, "fast")]
        sc = Scenario(
            models=[SimModelSpec("fast", slo_ms=200.0)],
            duration_s=5.0, n_engines=1, seed=0,
            monitoring_interval_s=2.0, arrivals=arrivals,
        )
        report = Simulation(fixture_profiles(), sc).run()
        assert report["arrivals_total"] == 2          # the two in-horizon fast
        assert report["models"]["fast"]["arrivals"] == 2
        assert report["arrivals_truncated_past_horizon"] == 1
        assert report["arrivals_ignored_unregistered_model"] == {"ghost": 1}

    def test_scale_arrivals_integer_and_fractional(self):
        base = [(0.0, "m"), (1.0, "m"), (2.0, "m"), (3.0, "m")]
        doubled = scale_arrivals(base, 2.0, seed=0)
        assert len(doubled) == 8
        assert scale_arrivals(base, 1.0) == base
        assert scale_arrivals(base, 0.0) == []
        one_and_half = scale_arrivals(base, 1.5, seed=0)
        assert len(base) <= len(one_and_half) <= 2 * len(base)
        assert one_and_half == scale_arrivals(base, 1.5, seed=0)


class TestOccupancyModel:
    """Slot (paged/continuous) turn pricing — the planner packs
    fill-priced decode turns and the engines execute at the same
    fill-scaled cost. Contract: deterministic, and never worse than the
    slab (batch) pricing at equal traffic."""

    def _run(self, kind):
        import dataclasses

        sc = dataclasses.replace(
            smoke_scenario(), decode_occupancy_model=kind
        )
        return Simulation(fixture_profiles(), sc).run()

    @pytest.mark.usefixtures("reference_rule")
    def test_slot_pricing_deterministic_and_no_worse(self):
        batch = self._run("batch")
        slot = self._run("slot")
        slot2 = self._run("slot")
        assert render_json(slot) == render_json(slot2)
        for m in batch["models"]:
            assert slot["models"][m]["slo_attainment"] \
                >= batch["models"][m]["slo_attainment"] - 1e-9
        done_b = sum(v["completed"] for v in batch["models"].values())
        done_s = sum(v["completed"] for v in slot["models"].values())
        assert done_s >= done_b
        for chip in slot["chips"].values():
            assert 0.0 <= chip["slot_occupancy"] <= 1.0

    @pytest.mark.usefixtures("reference_rule")
    def test_batch_mode_canon_untouched(self):
        # The default pricing must reproduce the canon exactly:
        # adding the knob cannot move a single historical number.
        report = self._run("batch")
        got = {m: round(v["slo_attainment"], 4)
               for m, v in report["models"].items()}
        assert got == {"fast": 0.9559, "burst": 0.8463, "fat": 1.0}
        assert report["migrations"] == 5

    def test_turn_cost_pricing_math(self):
        packer = SquishyBinPacker(fixture_profiles())
        wl = 100.0
        assert packer._turn_cost_ms(wl, 0.5) == wl  # default: batch
        packer.occupancy_pricing = "slot"
        packer.occupancy_floor = 0.4
        assert packer._turn_cost_ms(wl, 1.0) == wl
        assert packer._turn_cost_ms(wl, 0.0) == 40.0
        assert packer._turn_cost_ms(wl, 0.5) == 70.0
        assert packer._turn_cost_ms(wl, 2.0) == wl  # clamped

    def test_scenario_from_dict_knobs(self):
        sc = Scenario.from_dict({
            "models": [{"name": "fast", "slo_ms": 100.0,
                        "rate_rps": 5.0}],
            "decode_occupancy_model": "slot",
            "occupancy_floor": 0.5,
        })
        assert sc.decode_occupancy_model == "slot"
        assert sc.occupancy_floor == 0.5

    def test_unknown_occupancy_model_rejected(self):
        import pytest

        from ray_dynamic_batching_tpu_torch.sim.engine import SimEngine

        clock = VirtualClock()
        with pytest.raises(ValueError, match="occupancy_model"):
            SimEngine("c0", None, {}, EventLoop(clock), clock,
                      occupancy_model="paged")


class TestRunSimCLI:
    def test_smoke_gate_passes(self, capsys):
        from ray_dynamic_batching_tpu_torch.sim.__main__ import main

        assert main(["--smoke"]) == 0
        out = json.loads(capsys.readouterr().out.splitlines()[0])
        assert out["ok"] and out["reference"]["deterministic"]
        assert out["port"]["deterministic"]

    def test_report_bytes_stable_across_invocations(self, tmp_path, capsys):
        from ray_dynamic_batching_tpu_torch.sim.__main__ import main

        scenario = {
            "profiles": "fixture",
            "duration_s": 20, "n_engines": 2, "seed": 5,
            "models": [
                {"name": "fast", "slo_ms": 200, "rate_rps": 40},
                {"name": "burst", "slo_ms": 500, "rate_rps": 20,
                 "pattern": "spike", "amplitude": 100,
                 "spike_at_s": 8, "spike_len_s": 6},
            ],
        }
        path = tmp_path / "scenario.json"
        path.write_text(json.dumps(scenario))
        out_a, out_b = tmp_path / "a.json", tmp_path / "b.json"
        assert main(["--scenario", str(path), "--out", str(out_a)]) == 0
        assert main(["--scenario", str(path), "--out", str(out_b)]) == 0
        assert out_a.read_bytes() == out_b.read_bytes()
        report = json.loads(out_a.read_text())
        assert report["metric"] == "sim_report"
        assert set(report["models"]) == {"fast", "burst"}

    def test_compare_mode(self, tmp_path, capsys):
        from ray_dynamic_batching_tpu_torch.sim.__main__ import main

        base = {
            "profiles": "fixture",
            "duration_s": 20, "n_engines": 3, "seed": 1,
            "models": [
                {"name": "burst", "slo_ms": 500, "rate_rps": 30,
                 "pattern": "spike", "amplitude": 130,
                 "spike_at_s": 8, "spike_len_s": 8},
            ],
        }
        squeezed = dict(base, rate_scale=6.0, n_engines=1)
        a, b = tmp_path / "a.json", tmp_path / "b.json"
        a.write_text(json.dumps(base))
        b.write_text(json.dumps(squeezed))
        out = tmp_path / "cmp.json"
        assert main(["--compare", str(a), str(b),
                     "--out", str(out)]) == 0
        text = capsys.readouterr().out
        assert "winner" in text
        diff = json.loads(out.read_text())["compare"]
        assert diff["winner"] == "a.json"  # 6x traffic on 1 chip loses

    def test_usage_error_without_workload(self, capsys):
        from ray_dynamic_batching_tpu_torch.sim.__main__ import main

        assert main(["--model", "fast=200"]) == 2
        assert main(["--model", "malformed"]) == 2


class TestInterleavePrefill:
    """Virtual-clock chunked-prefill interleave + packer
    pricing of chunk-interleaved turns."""

    def _run(self, chunked, seed=0):
        from ray_dynamic_batching_tpu_torch.sim.scenarios import (
            interleave_profiles,
            interleave_scenario,
        )

        return Simulation(
            interleave_profiles(),
            interleave_scenario(chunked=chunked, seed=seed),
        ).run()

    def test_arms_deterministic_and_chunked_wins(self):
        a1, a2 = self._run(False), self._run(False)
        b1, b2 = self._run(True), self._run(True)
        assert render_json(a1) == render_json(a2)
        assert render_json(b1) == render_json(b2)
        ia_mono = a1["models"]["interactive"]
        ia_chunk = b1["models"]["interactive"]
        # The interleave's whole point: long-prompt head-of-line
        # blocking leaves the interactive p50; volume does not drop.
        assert ia_chunk["latency_p50_ms"] < ia_mono["latency_p50_ms"]
        total = lambda r: sum(  # noqa: E731
            m["completed"] for m in r["models"].values()
        )
        assert total(b1) >= total(a1)

    def test_conservation_with_chunk_backlog(self):
        for chunked in (False, True):
            report = self._run(chunked)
            for name, s in report["models"].items():
                accounted = (s["completed"] + s["stale"] + s["dropped"]
                             + s["pending"])
                assert s["arrivals"] == accounted, (chunked, name)
                assert s["dropped"] == 0

    @pytest.mark.usefixtures("reference_rule")
    def test_long_draw_is_seeded_and_canon_free(self):
        """Canon guard: scenarios without a long mix consume NO RNG
        state from the long-draw stream and stay byte-identical to the
        pre-interleave simulator."""
        from ray_dynamic_batching_tpu_torch.sim.scenarios import (
            fixture_profiles,
            smoke_scenario,
        )

        r1 = Simulation(fixture_profiles(), smoke_scenario(seed=0)).run()
        assert round(r1["models"]["fast"]["slo_attainment"], 4) == 0.9559
        assert round(r1["models"]["burst"]["slo_attainment"], 4) == 0.8463

    def test_chunked_requires_chunk_cost(self):
        import pytest

        from ray_dynamic_batching_tpu_torch.sim.scenarios import (
            interleave_profiles,
            interleave_scenario,
        )

        sc = interleave_scenario(chunked=True)
        sc.prefill_chunk_ms = 0.0
        with pytest.raises(ValueError, match="prefill_chunk_ms"):
            Simulation(interleave_profiles(), sc).run()

    def test_packer_prices_chunk_interleaved_turns(self):
        """Session.prefill_chunk_ms = 0 is bit-identical to the
        pre-chunked packer; > 0 adds exactly the quantum to the
        effective step latency (the stall bound's planner-side price)."""
        from ray_dynamic_batching_tpu_torch.scheduler.nexus import Session
        from ray_dynamic_batching_tpu_torch.sim.scenarios import (
            fixture_profiles,
        )

        profiles = fixture_profiles()
        packer = SquishyBinPacker(profiles)
        base = Session(model="fast", slo_ms=200.0, rate_rps=50.0)
        priced = Session(model="fast", slo_ms=200.0, rate_rps=50.0,
                         prefill_chunk_ms=3.0)
        row = packer.saturate_row(base)
        assert packer._session_wl(base, row) + 3.0 == \
            packer._session_wl(priced, row)
        plan_base = packer.residue_node(base)
        plan_priced = packer.residue_node(priced)
        assert plan_priced.placements[0].latency_ms == \
            plan_base.placements[0].latency_ms + 3.0

    def test_scenario_dict_roundtrip_with_prefill_knobs(self):
        sc = Scenario.from_dict({
            "models": [
                {"name": "llm_long", "slo_ms": 4000, "rate_rps": 10,
                 "long_frac": 0.5, "long_prefill_ms": 100.0},
            ],
            "prefill_mode": "chunked",
            "prefill_chunk_ms": 12.5,
            "prefill_chunks_per_turn": 2,
        })
        assert sc.prefill_mode == "chunked"
        assert sc.prefill_chunk_ms == 12.5
        assert sc.models[0].long_frac == 0.5
        import pytest

        with pytest.raises(ValueError, match="long_frac"):
            SimModelSpec(name="x", slo_ms=100.0, long_frac=0.3)


# --- twins of tests/test_spec_sim.py --------------------------------------
class TestExpectedTokensPerRound:
    def test_bounds_and_endpoints(self):
        # A round always emits at least the target's own token...
        assert expected_tokens_per_round(0.0, 4) == 1.0
        assert expected_tokens_per_round(-1.0, 4) == 1.0
        # ...and at most the whole window.
        assert expected_tokens_per_round(1.0, 4) == 5.0
        assert expected_tokens_per_round(2.0, 4) == 5.0

    def test_leviathan_expectation(self):
        # E = (1 - a^(k+1)) / (1 - a): the geometric-prefix expectation.
        e = expected_tokens_per_round(0.7, 4)
        assert abs(e - (1 - 0.7 ** 5) / 0.3) < 1e-12
        assert 1.0 < e < 5.0

    def test_monotone_in_acceptance(self):
        vals = [expected_tokens_per_round(a / 10, 4) for a in range(11)]
        assert vals == sorted(vals)


class TestSpecProfileAxis:
    def _table(self):
        return BatchProfile("m", [
            ProfileRow(8, 0, 10.0, 0.0, 100, 0.0),
            ProfileRow(8, 0, 14.0, 0.0, 120, 0.0, spec="on"),
        ])

    def test_default_lookup_sees_only_off_rows(self):
        prof = self._table()
        assert prof.row_for(8).spec == "off"
        assert prof.row_for(8).latency_ms == 10.0
        assert prof.row_for(8, spec="on").latency_ms == 14.0
        assert prof.specs() == ["off", "on"]

    def test_spec_lookup_falls_back_to_off_rows(self):
        """A spec session over a table with no spec rows prices from
        the plain rows (row.spec == 'off' disables the speedup) — never
        a KeyError mid-plan."""
        prof = BatchProfile("m", [ProfileRow(8, 0, 10.0, 0.0, 100, 0.0)])
        row = prof.row_for(8, spec="on")
        assert row is not None and row.spec == "off"

    def test_csv_roundtrip_keeps_spec_column(self):
        prof = self._table()
        back = BatchProfile.from_csv("m", prof.to_csv())
        assert [r.spec for r in back.rows] == ["off", "on"]
        # Pre-spec CSVs (no column) load as "off".
        legacy = "batch_size,seq_len,latency_ms\n8,0,10.0\n"
        assert BatchProfile.from_csv("m", legacy).rows[0].spec == "off"


class TestPackerSpecPricing:
    def _packer(self):
        rows = [ProfileRow(b, 0, 1.0 + b, 0.0, 100 << 20, 0.0)
                for b in (1, 8, 32)]
        rows += [ProfileRow(b, 0, (1.0 + b) * 1.4, 0.0, 100 << 20, 0.0,
                            spec="on") for b in (1, 8, 32)]
        return SquishyBinPacker({"m": BatchProfile("m", rows)},
                                hbm_budget_bytes=8 << 30)

    def test_spec_session_prices_effective_latency(self):
        packer = self._packer()
        off = Session("m", slo_ms=500.0, rate_rps=100.0)
        on = Session("m", slo_ms=500.0, rate_rps=100.0, spec="on",
                     spec_acceptance=0.7, spec_tokens=4)
        row_off = packer.saturate_row(off)
        row_on = packer.saturate_row(on)
        assert row_off.spec == "off" and row_on.spec == "on"
        e = expected_tokens_per_round(0.7, 4)
        assert packer._session_wl(on, row_on) == pytest.approx(
            (row_on.latency_ms) / e
        )
        # The honest claim: at alpha=0.7 the spec arm is ~2x cheaper.
        assert (packer._session_wl(on, row_on)
                < packer._session_wl(off, row_off))

    def test_off_session_is_byte_identical(self):
        """spec='off' sessions never touch the conversion — pre-spec
        plans are bit-for-bit what they were (canon safety)."""
        packer = self._packer()
        s = Session("m", slo_ms=500.0, rate_rps=100.0)
        row = packer.saturate_row(s)
        from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
            worst_latency_ms,
        )
        assert packer._session_wl(s, row) == worst_latency_ms(row)

    def test_llm_colocation_packer_skips_spec_rows(self):
        """Review regression: _pick_llm_row plans PLAIN decode engines —
        a spec row's per-ROUND latency must never be priced as a
        per-token step cost (mis-unit by up to E(a,k)x). On a table
        carrying both arms, the chosen placement comes from the off
        row even when the spec row would win on raw numbers."""
        from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
            LLMSession,
            pack_llm_engines,
        )

        rows = [
            ProfileRow(16, 128, 20.0, 0.0, 200 << 20, 0.0),
            # "Cheaper-looking" spec row: smaller fraction if mis-read
            # as a step cost.
            ProfileRow(16, 128, 10.0, 0.0, 100 << 20, 0.0, spec="on"),
        ]
        chips = pack_llm_engines(
            [LLMSession("m", rate_tok_s=100.0, token_slo_ms=100.0)],
            {"m": BatchProfile("m", rows)},
            hbm_budget_bytes=8 << 30,
        )
        placed = chips[0][0]
        assert placed.step_ms == 20.0  # the off row, not the round row

    def test_zero_acceptance_spec_prices_round_overhead(self):
        """Collapsed acceptance: E -> 1, so the spec arm prices at the
        full round cost — WORSE than plain by the bounded overhead
        factor, which is the collapse arm's whole story."""
        packer = self._packer()
        on = Session("m", slo_ms=500.0, rate_rps=100.0, spec="on",
                     spec_acceptance=0.0, spec_tokens=4)
        row = packer.saturate_row(on)
        off_row = packer.saturate_row(Session("m", 500.0, 100.0))
        assert packer._session_wl(on, row) == pytest.approx(
            1.4 * (off_row.latency_ms)
        )


class TestTransferPricing:
    def test_transfer_cost_prices_the_spec_arm(self):
        """Review regression: pointing an engine at a spec placement
        prices the SPEC rows' compile/footprint (draft weights
        included), not the plain arm's — and off sessions stay
        byte-identical."""
        from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
            NodePlan,
            Placement,
            Session,
        )
        from ray_dynamic_batching_tpu_torch.scheduler.replan import (
            transfer_cost,
        )

        prof = BatchProfile("m", [
            ProfileRow(8, 0, 10.0, 0.0, 1500 * 1024 * 1024, 500.0),
            ProfileRow(8, 0, 14.0, 0.0, 1800 * 1024 * 1024, 900.0,
                       spec="on"),
        ])

        def plan(spec):
            s = Session("m", slo_ms=500.0, rate_rps=10.0, spec=spec,
                        spec_acceptance=0.7)
            return NodePlan(placements=[
                Placement(s, 8, 10.0, 0.5, 1500 * 1024 * 1024)
            ], duty_cycle_ms=20.0)

        off_cost = transfer_cost(frozenset(), plan("off"), {"m": prof})
        on_cost = transfer_cost(frozenset(), plan("on"), {"m": prof})
        mb = 1024 * 1024 / 1e6
        assert off_cost == pytest.approx(500.0 + 1500 * mb)
        assert on_cost == pytest.approx(900.0 + 1800 * mb)


class TestSpecScenario:
    def test_spec_arm_beats_paged_arm(self):
        """The spec arm's sim win condition: same scenario, the spec arm's
        busy-normalized throughput (tok/s/chip proxy) beats the plain
        paged arm at equal-or-better SLO attainment."""
        paged = Simulation(spec_profiles(), spec_scenario()).run()
        spec = Simulation(spec_profiles(), spec_scenario(spec=True)).run()
        m_p, m_s = paged["models"]["paged_llm"], spec["models"]["paged_llm"]
        assert m_s["slo_attainment"] >= m_p["slo_attainment"]
        assert m_s["completed"] >= m_p["completed"]
        busy_p = sum(c["busy_ms"] for c in paged["chips"].values())
        busy_s = sum(c["busy_ms"] for c in spec["chips"].values())
        tput_p = m_p["completed"] / busy_p
        tput_s = m_s["completed"] / busy_s
        # At alpha=0.7, k=4, overhead 1.4: E/overhead ~ 1.98x; well
        # above 1.3 with planner slack.
        assert tput_s > 1.3 * tput_p
        assert spec["spec"]["models"]["paged_llm"]["planned_acceptance"] \
            == 0.7

    def test_collapse_is_bounded_not_a_cliff(self):
        """Acceptance-collapse chaos: the worst case of a verify round
        is >= 1 token, so throughput degrades to within the round
        overhead of the plain arm — zero drops, bounded completed
        deficit."""
        paged = Simulation(spec_profiles(), spec_scenario()).run()
        collapse = Simulation(
            spec_profiles(), spec_scenario(spec=True, collapse=True)
        ).run()
        m_p = paged["models"]["paged_llm"]
        m_c = collapse["models"]["paged_llm"]
        assert m_c["dropped"] == 0
        accounted = (m_c["completed"] + m_c["stale"] + m_c["dropped"]
                     + m_c["pending"])
        assert m_c["arrivals"] == accounted
        # Bounded factor: the collapse arm completes at least
        # 1/SPEC_ROUND_OVERHEAD of the plain arm's volume (with slack).
        floor = 1.0 / (SPEC_ROUND_OVERHEAD * 1.15)
        assert m_c["completed"] >= floor * m_p["completed"]
        assert collapse["spec"]["collapses"][0]["model"] == "paged_llm"

    def test_byte_deterministic(self):
        blobs = [
            render_json(Simulation(
                spec_profiles(), spec_scenario(spec=True, collapse=True)
            ).run())
            for _ in range(2)
        ]
        assert blobs[0] == blobs[1]

    def test_collapse_validation(self):
        with pytest.raises(ValueError, match="not a spec=True model"):
            Simulation(spec_profiles(), Scenario(
                models=[SimModelSpec(name="fast", slo_ms=100.0)],
                duration_s=1.0, n_engines=1,
                spec_collapses=[AcceptanceCollapse(at_s=0.5, model="fast")],
            )).run()
        with pytest.raises(ValueError, match="rate must be in"):
            AcceptanceCollapse(at_s=1.0, model="m", rate=1.5)
        with pytest.raises(ValueError, match="heal_at_s"):
            AcceptanceCollapse(at_s=1.0, model="m", rate=0.1, heal_at_s=0.5)

    def test_scenario_from_dict_roundtrip(self):
        sc = Scenario.from_dict({
            "models": [{"name": "paged_llm", "slo_ms": 900.0,
                        "rate_rps": 100.0, "spec": True,
                        "spec_acceptance": 0.6, "spec_tokens": 3}],
            "n_engines": 1,
            "spec_collapses": [{"at_s": 5.0, "model": "paged_llm",
                                "rate": 0.1, "heal_at_s": 9.0}],
        })
        assert sc.models[0].spec and sc.models[0].spec_tokens == 3
        assert sc.spec_collapses[0].heal_at_s == 9.0

    def test_no_spec_block_without_spec_models(self):
        """Canon safety: pre-spec scenarios' reports carry NO spec key —
        existing canon byte comparisons cannot move."""
        report = Simulation(spec_profiles(), spec_scenario()).run()
        assert "spec" not in report


# --- twins of tests/test_partition_sim.py ---------------------------------
def _run_twice(kind):
    r1 = run_partition_sim(partition_scenario(kind))
    r2 = run_partition_sim(partition_scenario(kind))
    return r1, r2


class TestPartitionSim:
    def test_unknown_scenario_raises(self):
        with pytest.raises(ValueError):
            partition_scenario("half-open-schism")

    def test_matrix_names_are_constructible(self):
        for kind in PARTITION_SCENARIOS:
            assert partition_scenario(kind).name == kind

    def test_leader_isolation_story(self):
        r1, r2 = _run_twice("leader_isolated")
        assert json.dumps(r1, sort_keys=True) == \
            json.dumps(r2, sort_keys=True)
        st = r1["store"]
        # The asymmetric case: bounded self-demotion, failover to the
        # standby on the log's side, zero split-brain, O(tail) replay.
        assert st["self_demotions"]["ctl-A"] == 1
        assert st["leader"] == "ctl-B" and st["epoch"] == 2
        assert st["stale_write_rejected"] and st["rejected_appends"] >= 1
        assert st["split_brain_commits"] == 0
        assert st["appended_total"] >= 400         # long synthetic log
        assert st["max_tail_replayed"] <= 16       # replay stays O(tail)
        c = r1["counts"]
        assert c["arrivals"] == c["admitted"] + c["rejected"]
        assert c["completed"] == c["admitted"]

    def test_gossip_partition_story(self):
        r1, r2 = _run_twice("gossip_only")
        assert json.dumps(r1, sort_keys=True) == \
            json.dumps(r2, sort_keys=True)
        # Store untouched; every shard degrades fail-closed within the
        # bound and re-converges exactly on heal.
        st = r1["store"]
        assert st["leader"] == "ctl-A" and st["epoch"] == 1
        assert st["rejected_appends"] == 0
        assert all(lg["degraded_entries"] >= 1
                   for lg in r1["ledgers"].values())
        assert r1["max_over_admitted"] <= r1["degrade_bound"]
        assert r1["reconverged"]
        assert all(not lg["stale_at_end"]
                   for lg in r1["ledgers"].values())


# --- both packages side by side ---------------------------------------------
# (builder, profile fixture, kwargs): one case for each builder of
# sim/scenarios.py, the spec and interleave builders in both arms, the
# compound builder for every named scenario and the metastability
# control arm.
def _builder_cases():
    from ray_dynamic_batching_tpu_torch.sim import scenarios as ts

    cases = [
        ("smoke_scenario", "fixture_profiles", {}),
        ("overload_scenario", "fixture_profiles", {"rate_scale": 5.0}),
        ("chaos_scenario", "fixture_profiles", {}),
        ("straggler_scenario", "fixture_profiles", {}),
        ("mesh_scenario", "mesh_profiles", {}),
        ("slice_failure_scenario", "mesh_profiles", {}),
        ("spec_scenario", "spec_profiles", {}),
        ("spec_scenario", "spec_profiles", {"spec": True, "collapse": True}),
        ("interleave_scenario", "interleave_profiles", {}),
        ("interleave_scenario", "interleave_profiles", {"chunked": True}),
        ("correlated_failure_scenario", "fixture_profiles", {}),
        ("observatory_overload_scenario", "fixture_profiles", {}),
        ("observatory_mispricing_scenario", "fixture_profiles", {}),
        ("observatory_steady_scenario", "fixture_profiles", {}),
    ]
    cases += [("compound_scenario", "fixture_profiles", {"name": n})
              for n in ts.COMPOUND_SCENARIOS]
    cases.append(("compound_scenario", "fixture_profiles",
                  {"name": ts.METASTABILITY_SCENARIO, "defenses": False}))
    return cases


def _case_id(case):
    name, _, kw = case
    return name + "".join(f"-{k}={v}" for k, v in sorted(kw.items()))


def _jax_sim():
    from ray_dynamic_batching_tpu import sim as j_sim
    from ray_dynamic_batching_tpu.sim import scenarios as j_scen

    return j_sim, j_scen


@pytest.mark.usefixtures("reference_rule")
@pytest.mark.parametrize("case", _builder_cases(), ids=_case_id)
def test_builder_reports_equal_across_packages(case):
    """Each builder's scenario on its profile fixture: the port's report
    renders to the JAX package's bytes."""
    from ray_dynamic_batching_tpu_torch.sim import scenarios as ts

    name, profiles, kw = case
    j_sim, j_scen = _jax_sim()
    want = j_sim.render_json(j_sim.Simulation(
        getattr(j_scen, profiles)(), getattr(j_scen, name)(**kw)).run())
    got = render_json(Simulation(
        getattr(ts, profiles)(), getattr(ts, name)(**kw)).run())
    assert got == want
    assert json.loads(got)["metric"] == "sim_report"


@pytest.mark.usefixtures("reference_rule")
@pytest.mark.parametrize("kind", PARTITION_SCENARIOS)
def test_partition_sim_reports_equal_across_packages(kind):
    from ray_dynamic_batching_tpu.sim.frontdoor import (
        run_partition_sim as j_run,
    )

    _, j_scen = _jax_sim()
    want = j_run(j_scen.partition_scenario(kind))
    got = run_partition_sim(partition_scenario(kind))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                        sort_keys=True)


@pytest.mark.usefixtures("reference_rule")
def test_frontdoor_sim_reports_equal_across_packages():
    from ray_dynamic_batching_tpu.sim.frontdoor import (
        run_frontdoor_sim as j_run,
    )
    from ray_dynamic_batching_tpu_torch.sim.frontdoor import (
        run_frontdoor_sim,
    )

    want = j_run()
    got = run_frontdoor_sim()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                        sort_keys=True)
    assert got == run_frontdoor_sim()          # deterministic


@pytest.mark.usefixtures("reference_rule")
@pytest.mark.parametrize("arm", ["drain", "migrate"])
def test_migration_sim_reports_equal_across_packages(arm):
    from ray_dynamic_batching_tpu.sim import kvfabric as j_kv
    from ray_dynamic_batching_tpu_torch.sim import kvfabric as t_kv

    for kw in ({}, {"replicas": 4, "streams_per_replica": 9, "seed": 3}):
        want = j_kv.run_migration_sim(j_kv.MigrationScenario(**kw), arm)
        got = t_kv.run_migration_sim(t_kv.MigrationScenario(**kw), arm)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)


def test_smoke_arms_reproduce_their_canons(capsys):
    """``--smoke``: the reference arm reproduces the reference's canon
    (``tools/sim_smoke.json``'s comment) and passes every check; the port
    arm, planning at 1.5x, passes determinism and the floors, and its two
    occupancy comparisons do not hold (ROADMAP queue 3): slot pricing
    serves burst 0.9260 against the batch arm's 0.9281, and completes
    8003 requests against 8009."""
    from ray_dynamic_batching_tpu_torch.sim.__main__ import main

    assert main(["--smoke"]) == 0
    lines = capsys.readouterr().out.splitlines()
    out = json.loads(lines[0])
    ref, port = out["reference"], out["port"]
    assert ref["slo_attainment"] == {"fast": 0.9559, "burst": 0.8463,
                                     "fat": 1.0}
    assert (ref["migrations"], ref["chips_used"]) == (5, 2)
    assert ref["occupancy_model"]["slot_attainment"] == {
        "fast": 0.9599, "burst": 0.8632, "fat": 1.0}
    assert all(ref["occupancy_model"]["comparisons"].values())
    assert port["rate_headroom"] == control.RATE_HEADROOM == 0.5
    assert port["deterministic"] and port["occupancy_model"]["deterministic"]
    assert port["slo_attainment"] == {"fast": 0.998, "burst": 0.9281,
                                      "fat": 1.0}
    assert (port["migrations"], port["chips_used"]) == (15, 3)
    assert port["occupancy_model"]["slot_attainment"] == {
        "fast": 0.9989, "burst": 0.926, "fat": 1.0}
    assert (port["completed"], port["occupancy_model"]["completed"]) == (
        8009, 8003)
    assert port["occupancy_model"]["comparisons"] == {
        "slot_vs_batch_no_worse[fast]": True,
        "slot_vs_batch_no_worse[burst]": False,
        "slot_vs_batch_no_worse[fat]": True,
        "min_completed_ratio": False,
    }
    assert sum("not gated" in ln for ln in lines) == 2


def test_smoke_reference_arm_equals_the_reference_cli(tmp_path, capsys):
    """The reference arm's report is the reference CLI's, byte for byte."""
    from ray_dynamic_batching_tpu_torch.sim.__main__ import main
    from tools.run_sim import main as j_main

    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    assert main(["--smoke", "--out", str(a)]) == 0
    assert j_main(["--smoke", "--out", str(b)]) == 0
    capsys.readouterr()
    assert a.read_bytes() == b.read_bytes()


def test_packaged_ratchet_is_the_reference_ratchet():
    import os

    from ray_dynamic_batching_tpu_torch.sim.__main__ import RATCHET_PATH

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tools", "sim_smoke.json")) as f:
        want = json.load(f)
    with open(RATCHET_PATH) as f:
        assert json.load(f) == want


def _write_span_dump(path, seed: int = 0) -> None:
    """A flight-recorder dump of the three vision models: one
    ``queue.wait`` and one ``engine.step`` span for each arrival, seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lines, t = [], 1000.0
    for i in range(600):
        t += float(rng.exponential(25.0))
        model = ("resnet50", "shufflenet_v2", "vit_b_16")[i % 3]
        wait = float(rng.uniform(1.0, 40.0))
        step = float(rng.uniform(20.0, 60.0))
        lines.append({"name": "queue.wait", "trace_id": f"t{i}",
                      "span_id": 2 * i + 1, "parent_id": None,
                      "start_ms": t, "end_ms": t + wait,
                      "attributes": {"model": model}, "links": []})
        lines.append({"name": "engine.step", "trace_id": f"s{i}",
                      "span_id": 2 * i + 2, "parent_id": None,
                      "start_ms": t + wait, "end_ms": t + wait + step,
                      "attributes": {"model": model, "batch_bucket": 1},
                      "links": []})
    path.write_text("".join(json.dumps(s) + "\n" for s in lines))


MODEL_ARGS = ["--model", "resnet50=2000", "--model", "shufflenet_v2=1500",
              "--model", "vit_b_16=4000"]


@pytest.mark.usefixtures("reference_rule")
@pytest.mark.parametrize("mode", ["arrivals", "spans", "hop-drift",
                                  "pattern"])
def test_cli_modes_equal_across_packages(mode, tmp_path, capsys):
    """Each replay mode of the CLI over ``profiles/cpu/``: the same exit
    code and the same ``--out`` bytes from both packages' CLIs, with the
    what-if options set."""
    from ray_dynamic_batching_tpu_torch.sim.__main__ import main
    from tools.run_sim import main as j_main

    spans = tmp_path / "spans.jsonl"
    _write_span_dump(spans)
    if mode == "arrivals":
        arrivals = tmp_path / "arrivals.jsonl"
        arrivals.write_text("".join(
            json.dumps({"t_s": t, "model": m}) + "\n"
            for t, m in arrivals_from_spans(str(spans))))
        args = ["--arrivals", str(arrivals), "--rate-scale", "1.5"]
    elif mode == "pattern":
        args = ["--pattern", "step", "--amplitude", "20",
                "--model", "resnet50=2000:20", "--model",
                "vit_b_16=4000:10", "--duration", "20"]
    else:
        args = [f"--{mode}", str(spans)]
    if mode != "pattern":
        args += MODEL_ARGS
    args += ["--profiles", "profiles/cpu", "--engines", "3", "--seed", "2"]
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    rc = main(args + ["--out", str(a)])
    j_rc = j_main(args + ["--out", str(b)])
    capsys.readouterr()
    assert rc == j_rc and rc in (0, 1)
    assert a.read_bytes() == b.read_bytes()
    report = json.loads(a.read_text())
    if mode == "hop-drift":
        assert report["hops"]                       # something was graded
    else:
        assert report["arrivals_total"] > 0


def test_port_sim_replays_the_demo_step():
    """The demo's rate step on the H100 tables (``tools/run_slo_demo.py``:
    resnet50's rate doubled at 30 s; 3 engines) through the port's
    simulator, per half: at the reference's rule it equals the JAX
    simulator's halves (resnet50 loses its second half), and at the
    port's rule every half holds 0.95."""
    from ray_dynamic_batching_tpu.engine.workload import (
        RatePattern as JRatePattern,
    )
    from ray_dynamic_batching_tpu.profiles import table as j_table
    from ray_dynamic_batching_tpu.sim.simulator import (
        Scenario as JScenario,
        SimModelSpec as JSimModelSpec,
    )
    from ray_dynamic_batching_tpu_torch.profiles import table as t_table
    from tests.test_torch_vision_serving import (
        DEMO_RPS,
        DEMO_SLO,
        _h100_profiles,
    )

    j_sim, _ = _jax_sim()

    def halves(sim_mod, table, scenario, spec, pattern):
        specs = [spec(n, DEMO_SLO[n], pattern=pattern(
            "step", base_rps=r, amplitude=r if n == "resnet50" else 0.0,
            step_at_s=30.0)) for n, r in DEMO_RPS.items()]
        runs = []
        for duration_s in (30.0, 60.0):
            rep = sim_mod.Simulation(_h100_profiles(table), scenario(
                models=specs, duration_s=duration_s, n_engines=3,
                seed=0)).run()
            runs.append({n: (m["arrivals"], m["stale"] + m["dropped"]
                             + m["violations"])
                         for n, m in rep["models"].items()})
        first, whole = runs
        out = {}
        for n in DEMO_RPS:
            (a1, m1), (a, m) = first[n], whole[n]
            out[n] = (1.0 - m1 / a1, 1.0 - (m - m1) / (a - a1))
        return out

    import ray_dynamic_batching_tpu_torch.sim as t_sim

    want = halves(j_sim, j_table, JScenario, JSimModelSpec, JRatePattern)
    with control.reference_headroom():
        ref = halves(t_sim, t_table, Scenario, SimModelSpec, RatePattern)
    port = halves(t_sim, t_table, Scenario, SimModelSpec, RatePattern)
    assert ref == want
    assert ref["resnet50"][0] == 1.0 and ref["resnet50"][1] < 0.95
    assert min(min(h) for h in port.values()) >= 0.95, port


# The smoke scenario at seeds 0-4, both rules: (batch arm attainment
# fast / burst / fat and completions, slot arm the same). The reference's
# gate runs seed 0 only; its two occupancy comparisons (slot no worse than
# batch per model; slot completions >= batch completions) hold at seed 0
# under the reference's rule and fail at seeds 3 and 4 under it too.
SMOKE_BY_SEED = {
    (0, "reference"): (
        (0.9559, 0.8463, 1.0, 7502), (0.9599, 0.8632, 1.0, 7590)),
    (0, "port"): (
        (0.998, 0.9281, 1.0, 8009), (0.9989, 0.926, 1.0, 8003)),
    (1, "reference"): (
        (0.9757, 0.8511, 1.0, 7677), (0.9762, 0.866, 1.0, 7744)),
    (1, "port"): (
        (0.9997, 0.9315, 1.0, 8116), (0.9997, 0.9315, 1.0, 8116)),
    (2, "reference"): (
        (0.9681, 0.8469, 1.0, 7480), (0.9704, 0.8655, 1.0, 7568)),
    (2, "port"): (
        (1.0, 0.9303, 1.0, 7951), (0.9997, 0.9289, 1.0, 7944)),
    (3, "reference"): (
        (0.9604, 0.8623, 0.991, 7467), (0.957, 0.8623, 0.991, 7455)),
    (3, "port"): (
        (1.0, 0.9384, 1.0, 7932), (1.0, 0.9362, 1.0, 7923)),
    (4, "reference"): (
        (0.9705, 0.8606, 0.9925, 7751), (0.9636, 0.8773, 1.0, 7804)),
    (4, "port"): (
        (1.0, 0.9278, 1.0, 8162), (1.0, 0.9359, 1.0, 8198)),
}



@pytest.mark.parametrize("seed", range(5))
def test_occupancy_comparisons_by_seed(seed):
    """Both arms of the smoke at each seed, under both rules, equal the
    table above (ROADMAP queue 3 records it). At the port's rule the two
    comparisons fail at seeds 0, 2 and 3; at the reference's, at 3 and 4."""
    import contextlib
    import dataclasses

    got = {}
    for rule in ("reference", "port"):
        ctx = (control.reference_headroom() if rule == "reference"
               else contextlib.nullcontext())
        arms = []
        with ctx:
            for kind in ("batch", "slot"):
                r = Simulation(fixture_profiles(), dataclasses.replace(
                    smoke_scenario(seed=seed),
                    decode_occupancy_model=kind)).run()
                arms.append(tuple(
                    round(r["models"][m]["slo_attainment"], 4)
                    for m in ("fast", "burst", "fat"))
                    + (sum(v["completed"] for v in r["models"].values()),))
        got[(seed, rule)] = tuple(arms)
        assert got[(seed, rule)] == SMOKE_BY_SEED[(seed, rule)]
    holds = {rule: all(s >= b for b, s in zip(*got[(seed, rule)]))
             for rule in ("reference", "port")}
    assert holds == {"reference": seed not in (3, 4),
                     "port": seed not in (0, 2, 3)}
