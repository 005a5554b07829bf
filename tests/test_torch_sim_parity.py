"""Sim-vs-live parity pin of the port: the same seeded fixture workload
through (a) the port's simulator and (b) the port's REAL
``LiveScheduler`` monitor loop driving fake profiled engines on the CPU,
asserting SLO attainment and schedule-change counts agree within the
reference's tolerances (twin of ``tests/test_sim_parity.py``).

Both sides plan by the port's rule (``scheduler/control.
planned_sessions``: each model at ``1 + RATE_HEADROOM`` times the rate
read) and share the rate estimator (``engine/rates.py``), the decide
step (``scheduler/replan.decide_replan``), the queue semantics, and the
duty-cycle execution discipline — the live side on threads and
wall-clock sleeps, the sim side on the virtual clock. The fake engine
"executes" a batch by sleeping the profile row's latency, which is
exactly the cost model the sim charges, so any disagreement beyond
measurement noise means one side's CONTROL behavior drifted. Every
thread the live side starts is stopped, and the test checks it."""

import threading
import time

import pytest

from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.engine.workload import (
    RatePattern,
    WorkloadDriver,
)
from ray_dynamic_batching_tpu_torch.profiles.table import (
    BatchProfile,
    ProfileRow,
)
from ray_dynamic_batching_tpu_torch.scheduler.control import LiveScheduler
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    NodePlan,
    SquishyBinPacker,
)
from ray_dynamic_batching_tpu_torch.sim import Simulation, slo_attainment
from ray_dynamic_batching_tpu_torch.sim.simulator import Scenario, SimModelSpec
from ray_dynamic_batching_tpu_torch.sim.workload import (
    merge_arrivals,
    synthetic_arrivals,
)

MB = 1024 * 1024

# The shared fixture: two models, uniform 40 rps each, roomy SLOs (the
# pin grades CONTROL agreement, not knife-edge shedding — wall-clock CI
# noise on the live side must not flip outcomes). The cold-window guard
# (rate_min_span_s = the window) is ON for both sides: without it the
# first window_s seconds of any run are governed by the estimator's
# phase relative to its integer-second buckets — real live behavior,
# but noise, not the control logic this pin grades.
MODELS = [("alpha", 1500.0), ("beta", 1500.0)]
RATE_RPS = 40.0
DURATION_S = 12.0
MONITOR_S = 1.0
WINDOW_S = 10.0
SEEDS = {"alpha": 31, "beta": 32}


def parity_profiles():
    def prof(name, base_ms, per_sample_ms):
        rows = [
            ProfileRow(b, 0, latency_ms=base_ms + per_sample_ms * b,
                       latency_std_ms=0.0, hbm_bytes=100 * MB,
                       compile_ms=500.0)
            for b in (1, 2, 4, 8, 16)
        ]
        return BatchProfile(name, rows)

    return {"alpha": prof("alpha", 4.0, 0.5), "beta": prof("beta", 6.0, 1.0)}


def make_packer():
    packer = SquishyBinPacker(parity_profiles(), hbm_budget_bytes=12 << 30)
    # Pin the knobs the sim pins (ambient config must not skew the pin).
    packer.hbm_budget = int((12 << 30) * 0.9)
    packer.slo_safety = 2.2
    packer.compute_fraction = 0.5
    return packer


class FakeProfiledEngine:
    """ReplicaEngine's duty-cycle loop with the compiled step replaced by
    a wall-clock sleep of the profile row's latency — the live analogue
    of the simulator's cost model (no model, no device)."""

    def __init__(self, engine_id, queues, profiles):
        self.engine_id = engine_id
        self.queues = queues
        self.profiles = profiles
        self._plan = NodePlan()
        self._pending = None
        self._lock = threading.Lock()
        self._active = threading.Event()
        self._thread = None

    @property
    def models(self):
        return [p.session.model for p in self._plan.placements]

    def assign(self, plan):
        with self._lock:
            self._pending = plan

    def describe(self):
        return f"FakeProfiledEngine({self.engine_id})"

    def _step_latency_ms(self, p):
        prof = self.profiles[p.session.model]
        row = prof.row_for(p.batch_size) or prof.bucket_for(p.batch_size)
        return row.latency_ms if row else p.latency_ms

    def _loop(self):
        while self._active.is_set():
            with self._lock:
                if self._pending is not None:
                    self._plan = self._pending
                    self._pending = None
            plan = self._plan
            if not plan.placements:
                time.sleep(0.01)
                continue
            cycle_start = time.perf_counter()
            for p in plan.placements:
                queue = self.queues.queue(p.session.model)
                batch = queue.get_batch(
                    p.batch_size, expected_latency_ms=p.latency_ms
                )
                elapsed_ms = 0.0
                if batch:
                    elapsed_ms = self._step_latency_ms(p)
                    time.sleep(elapsed_ms / 1000.0)
                    for req in batch:
                        req.fulfill(None)
                    queue.record_batch_completion(batch)
                slice_ms = p.occupancy * plan.duty_cycle_ms
                remaining_ms = slice_ms - elapsed_ms
                if remaining_ms > 0.05:
                    time.sleep(remaining_ms / 1000.0)
            leftover_ms = (
                plan.duty_cycle_ms
                - (time.perf_counter() - cycle_start) * 1000.0
            )
            if leftover_ms > 0.05:
                time.sleep(leftover_ms / 1000.0)

    def start(self):
        self._active.set()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._active.clear()
        if self._thread is not None:
            self._thread.join(5.0)


def run_live():
    queues = QueueManager()
    profiles = parity_profiles()
    engines = [FakeProfiledEngine(f"e{i}", queues, profiles)
               for i in range(2)]
    sched = LiveScheduler(make_packer(), engines, queues=queues)
    sched.monitoring_interval_s = MONITOR_S
    sched.rates.window_s = WINDOW_S
    sched.rate_min_span_s = WINDOW_S
    for name, slo_ms in MODELS:
        sched.register_model(name, slo_ms=slo_ms)
    slos = dict(MODELS)

    def submit(model, _offset):
        sched.submit_request(Request(model=model, payload=None,
                                     slo_ms=slos[model]))

    for e in engines:
        e.start()
    try:
        sched.rebalance(
            rates={name: RATE_RPS for name, _ in MODELS}, trigger="manual"
        )
        sched.start_monitoring()
        drivers = [
            WorkloadDriver(
                submit, name,
                RatePattern("constant", base_rps=RATE_RPS),
                duration_s=DURATION_S, poisson=False, seed=SEEDS[name],
            )
            for name, _ in MODELS
        ]
        for d in drivers:
            d.start()
        for d in drivers:
            d.join(DURATION_S + 30)
        # Monitor horizon parity: the sim monitors until duration_s and
        # then drains; keep monitoring during drain here and the decaying
        # rate window replans on every tick of dying traffic.
        sched.stop_monitoring()
        deadline = time.monotonic() + 20
        while (any(len(queues.queue(n)) > 0 for n, _ in MODELS)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(1.0)  # let the in-flight cycle complete + record
    finally:
        sched.stop_monitoring()
        for e in engines:
            e.stop()
    return {
        "attainment": {
            name: slo_attainment(queues.queue(name).stats())
            for name, _ in MODELS
        },
        "sent": {d.model: d.sent for d in drivers},
        "completed": {
            name: queues.queue(name).stats()["completed"]
            for name, _ in MODELS
        },
        "schedule_changes": sched.schedule_changes,
    }


def run_sim():
    arrivals = merge_arrivals([
        synthetic_arrivals(
            name, RatePattern("constant", base_rps=RATE_RPS),
            DURATION_S, poisson=False, seed=SEEDS[name],
        )
        for name, _ in MODELS
    ])
    sc = Scenario(
        models=[SimModelSpec(name, slo_ms=slo_ms, poisson=False)
                for name, slo_ms in MODELS],
        duration_s=DURATION_S,
        drain_s=3.0,
        n_engines=2,
        seed=0,
        monitoring_interval_s=MONITOR_S,
        rate_window_s=WINDOW_S,
        rate_min_span_s=WINDOW_S,
        arrivals=arrivals,
    )
    report = Simulation(parity_profiles(), sc).run()
    return {
        "attainment": {
            name: report["models"][name]["slo_attainment"]
            for name, _ in MODELS
        },
        "arrivals": {
            name: report["models"][name]["arrivals"] for name, _ in MODELS
        },
        "completed": {
            name: report["models"][name]["completed"] for name, _ in MODELS
        },
        "schedule_changes": report["schedule_changes"],
    }


class TestSimLiveParity:
    def test_attainment_and_schedule_changes_agree(self):
        before = set(threading.enumerate())
        live = run_live()
        leaked = [t.name for t in threading.enumerate()
                  if t not in before and t.is_alive()]
        assert not leaked, leaked
        sim = run_sim()
        # Identical workload on both sides (same pattern, seed, length).
        for name, _ in MODELS:
            assert live["sent"][name] == sim["arrivals"][name]
        for name, _ in MODELS:
            assert live["attainment"][name] == pytest.approx(
                sim["attainment"][name], abs=0.05
            ), (live, sim)
            # Neither side sheds this comfortably-provisioned fixture.
            assert sim["attainment"][name] >= 0.95
            assert live["attainment"][name] >= 0.90  # wall-clock noise
        # Control-plane activity agrees: the warm-start replan plus at
        # most a couple of cold-window wobbles on either side.
        assert live["schedule_changes"] >= 1
        assert sim["schedule_changes"] >= 1
        assert abs(live["schedule_changes"] - sim["schedule_changes"]) <= 2, \
            (live["schedule_changes"], sim["schedule_changes"])
        # Throughput parity: completions within 10%.
        for name, _ in MODELS:
            assert live["completed"][name] == pytest.approx(
                sim["completed"][name], rel=0.10
            ), (live, sim)
