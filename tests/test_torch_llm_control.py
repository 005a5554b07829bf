"""The port's live LLM scheduler and colocation executor against the JAX
package's, with fake engines and fake chips (no model, no device).

Twins of ``tests/test_llm_control.py`` (the control decisions: chip
matching, shape-stable placements, the over-capacity and infeasible
branches, drains, shutdown, token-demand accounting, cold-window guard)
and ``tests/test_colocate_fuzz.py`` (seeded rate storms through the real
executor and control loop, migration storms, failing, stalled, stale and
wedged engines, a dead executor thread). Every scenario runs on both
packages' classes with the same fakes, and the decisions must be the
same: hosted models after each step, plans, served requests and the
audit records' triggers, notes, diffs and placements. Every scheduler is
shut down and every wait has a timeout.

The last section holds where the port departs from the reference: a
replan keeps a hosted engine's shape while that measured row still
serves the model's rate, where the reference moves the engine to
whichever tied row the packer's HBM tie-break picks for the reading.
"""

import contextlib
import dataclasses
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ray_dynamic_batching_tpu.engine.colocate as j_colocate
import ray_dynamic_batching_tpu.engine.queue as j_queue
import ray_dynamic_batching_tpu.engine.rates as j_rates
import ray_dynamic_batching_tpu.engine.request as j_request
import ray_dynamic_batching_tpu.profiles.table as j_table
import ray_dynamic_batching_tpu.scheduler.llm_control as j_control
import ray_dynamic_batching_tpu_torch.engine.colocate as t_colocate
import ray_dynamic_batching_tpu_torch.engine.queue as t_queue
import ray_dynamic_batching_tpu_torch.engine.rates as t_rates
import ray_dynamic_batching_tpu_torch.engine.request as t_request
import ray_dynamic_batching_tpu_torch.profiles.table as t_table
import ray_dynamic_batching_tpu_torch.scheduler.llm_control as t_control

GB = 1 << 30
JAX = SimpleNamespace(colocate=j_colocate, queue=j_queue, rates=j_rates,
                      request=j_request, table=j_table, control=j_control)
PORT = SimpleNamespace(colocate=t_colocate, queue=t_queue, rates=t_rates,
                       request=t_request, table=t_table, control=t_control)


class FakeEngine:
    """What the control loop touches of a decode engine."""

    def __init__(self, model_name, num_slots, max_len):
        self.num_slots = num_slots
        self.max_len = max_len
        self.active_slots = 0
        self._thread = None
        self.released = False
        self.model = type("M", (), {"name": model_name})()

    def abort_active(self, exc):
        self.active_slots = 0

    def release_buffers(self):
        self.released = True


class FakeChip:
    """ColocatedLLMEngines' control surface without a loop."""

    def __init__(self, name):
        self.name = name
        self.device = None
        self.running = False
        self._hosted = {}

    def models(self):
        return list(self._hosted)

    def placements(self):
        return {m: p for m, (e, p) in self._hosted.items()}

    def attach(self, model, engine, placement=None):
        self._hosted[model] = (engine, placement)

    def detach(self, model, drain=True):
        self._hosted.pop(model, None)
        ev = threading.Event()
        ev.set()
        return ev

    def shutdown(self, timeout_s=5.0):
        self._hosted.clear()

    def busy_fractions(self):
        return {}

    def describe(self):
        return f"{self.name}{sorted(self._hosted)}"


class InstantEngine:
    """Serves every queued request in one 'scan': the executor-facing
    surface of a decode engine with no model."""

    def __init__(self, model_name, num_slots, max_len, queue):
        self.num_slots = num_slots
        self.max_len = max_len
        self.queue = queue
        self.model = type("M", (), {"name": model_name})()
        self._thread = None
        self._active_mask = np.zeros((num_slots,), dtype=bool)
        self._pending = []
        self.last_heartbeat = 0.0
        self.released = False
        self.served = 0

    def _device_ctx(self):
        return contextlib.nullcontext()

    def _admit(self) -> int:
        batch = self.queue.get_batch(self.num_slots, discard_stale=False)
        self._pending.extend(batch)
        self._active_mask[: min(len(self._pending), self.num_slots)] = True
        return len(batch)

    def _step(self, horizon=None) -> None:
        assert not self.released, "stepped after release_buffers"
        for req in self._pending:
            req.fulfill({"tokens": [1], "served_by": self.model.name})
            self.served += 1
        self._pending = []
        self._active_mask[:] = False

    @property
    def active_slots(self) -> int:
        return int(self._active_mask.sum())

    def abort_active(self, exc) -> None:
        for req in self._pending:
            req.reject(exc)
        self._pending = []
        self._active_mask[:] = False

    def release_buffers(self) -> None:
        self.released = True


class BrokenEngine(InstantEngine):
    def _admit(self):
        raise RuntimeError("device wedged")


def _profile(ns, name, step_ms=10.0, hbm_gb=1.0):
    return ns.table.BatchProfile(f"{name}_decode", [
        ns.table.ProfileRow(batch_size=4, seq_len=128, latency_ms=step_ms,
                            latency_std_ms=0.0, hbm_bytes=int(hbm_gb * GB),
                            compile_ms=100.0)])


def _rate(fraction):
    return fraction * 1000.0 * 4 / 10.0     # slots 4, step 10 ms


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _audit(sched):
    """The audit ring without its sequence numbers and wall stamps."""
    return [{k: v for k, v in r.to_dict().items()
             if k not in ("seq", "wall_time")} for r in sched.audit.records()]


def _fake_sched(ns, models=("a", "b"), n_chips=2, **kw):
    profiles = {m: _profile(ns, m) for m in models}
    chips = [FakeChip(f"chip{i}") for i in range(n_chips)]
    built = []

    def factory(model, placement, queue, device):
        built.append((model, placement.num_slots, placement.capacity))
        return FakeEngine(model, placement.num_slots, placement.capacity)

    sched = ns.control.LLMLiveScheduler(profiles, chips, factory, **kw)
    for m in models:
        sched.register_model(m, token_slo_ms=1000.0)
    return sched, chips, built


def _hosted(chips):
    return [sorted(c.models()) for c in chips]


def _twin(scenario):
    """Run ``scenario(ns)`` on both packages; the traces must be equal."""
    ref, port = scenario(JAX), scenario(PORT)
    assert port == ref
    return port


# --- twins of tests/test_llm_control.py --------------------------------------
def _colocate_then_split(ns):
    sched, chips, built = _fake_sched(ns)
    trace = [_plain(sched.rebalance(rates={m: _rate(0.3) for m in "ab"})),
             _hosted(chips)]
    trace += [_plain(sched.rebalance(rates={"a": _rate(0.6),
                                            "b": _rate(0.3)})),
              _hosted(chips), built, _audit(sched)]
    return trace


def test_colocates_then_splits_on_surge():
    plan1, hosted1, plan2, hosted2, *_ = _twin(_colocate_then_split)
    assert len(plan1) == 1 and hosted1[0] == ["a", "b"]
    assert len(plan2) == 2 and ["a"] in hosted2 and ["b"] in hosted2


def _shape_stable(ns):
    sched, chips, built = _fake_sched(ns)
    sched.rebalance(rates={m: _rate(0.3) for m in "ab"})
    n = len(built)
    sched.rebalance(rates={m: _rate(0.35) for m in "ab"})
    return [len(built) - n, sched.migrations, _audit(sched)]


def test_shape_stable_placement_keeps_engine():
    rebuilt, migrations, _ = _twin(_shape_stable)
    assert rebuilt == 0 and migrations == 0


def _over_capacity(ns, n_chips, low_first):
    sched, chips, built = _fake_sched(ns, models=("a", "b", "c"),
                                      n_chips=n_chips)
    trace = []
    if low_first:
        trace.append(_plain(sched.rebalance(
            rates={m: _rate(0.3) for m in "abc"})))
        trace.append(_hosted(chips))
    trace.append(_plain(sched.rebalance(rates={m: _rate(0.8)
                                               for m in "abc"})))
    trace += [_hosted(chips), _audit(sched)]
    return trace


def test_over_capacity_first_plan_serves_truncated():
    plan, hosted, audit = _twin(lambda ns: _over_capacity(ns, 1, False))
    assert len(plan) == 1 and len(hosted[0]) == 1


def test_over_capacity_later_keeps_previous_plan():
    plan, hosted, plan2, hosted2, audit = _twin(
        lambda ns: _over_capacity(ns, 2, True))
    assert plan2 == plan and hosted2 == hosted
    assert "over capacity (3 chips needed, 2 available)" in audit[-1]["note"]


def _infeasible(ns):
    sched, chips, built = _fake_sched(ns)
    low = {m: _rate(0.3) for m in "ab"}
    plan = _plain(sched.rebalance(rates=low))
    plan2 = _plain(sched.rebalance(rates=dict(low, a=_rate(2.0))))
    return [plan, plan2, _hosted(chips), _audit(sched)]


def test_infeasible_rate_keeps_previous_plan():
    plan, plan2, hosted, audit = _twin(_infeasible)
    assert plan2 == plan
    assert sorted(sum(hosted, [])) == ["a", "b"]
    assert audit[-1]["note"].startswith("infeasible, kept previous plan")


def _zero_rate(ns):
    sched, chips, _ = _fake_sched(ns)
    sched.rebalance(rates={m: _rate(0.3) for m in "ab"})
    sched.rebalance(rates={"a": _rate(0.3), "b": 0.0})
    return [_hosted(chips), _audit(sched)]


def test_zero_rate_model_is_drained():
    hosted, _ = _twin(_zero_rate)
    assert sorted(sum(hosted, [])) == ["a"]


def _incumbent(ns):
    sched, chips, _ = _fake_sched(ns)
    low = {m: _rate(0.3) for m in "ab"}
    sched.rebalance(rates=low)
    incumbent = next(c for c in chips if c.models()).name
    sched.rebalance(rates=dict(low, a=_rate(0.6)))
    sched.rebalance(rates=low)
    merged = next(c for c in chips if len(c.models()) == 2).name
    return [incumbent, merged, _audit(sched)]


def test_matching_prefers_incumbent_chip():
    incumbent, merged, _ = _twin(_incumbent)
    assert merged == incumbent


def _shutdown_first(ns):
    sched, chips, _ = _fake_sched(ns)
    sched.shutdown()
    return [_plain(sched.rebalance(rates={m: _rate(0.3) for m in "ab"})),
            _hosted(chips)]


def test_shutdown_closes_future_rebalances():
    assert _twin(_shutdown_first) == [[], [[], []]]


def _unregistered(ns):
    sched, _, _ = _fake_sched(ns)
    req = ns.request.Request(model="nope", payload={"tokens": [1]},
                             slo_ms=1000.0)
    ok = sched.submit_request(req)
    with pytest.raises(KeyError) as info:
        req.future.result(timeout=1)
    return [ok, str(info.value)]


def test_submit_unregistered_rejects():
    ok, _ = _twin(_unregistered)
    assert ok is False


def _token_demand(ns):
    fake = {"t": 1000.0}
    sched, _, _ = _fake_sched(
        ns, rates=ns.rates.RateRegistry(window_s=10.0,
                                        clock=lambda: fake["t"]),
        clock=lambda: fake["t"])
    sched.submit_request(ns.request.Request(
        model="a", payload={"tokens": [1, 2], "max_new_tokens": 40},
        slo_ms=1000.0))
    sched.submit_request(ns.request.Request(
        model="b", payload=[1, 2, 3], slo_ms=1000.0))
    return sched.rates.rates()


def test_submit_records_token_demand():
    rates = _twin(_token_demand)
    assert rates == {"a": pytest.approx(40.0), "b": pytest.approx(64.0)}


def _status(ns):
    sched, _, _ = _fake_sched(ns)
    sched.submit_request(ns.request.Request(
        model="a", payload={"tokens": [1], "max_new_tokens": 8},
        slo_ms=1000.0))
    return sched.render_status()


def test_render_status_produces_slo_table():
    table = _twin(_status)
    assert "model" in table and "a" in table


def _cold_start(ns):
    fake = {"t": 1000.0}
    reg = ns.rates.RateRegistry(window_s=30.0, clock=lambda: fake["t"])
    sched, _, _ = _fake_sched(ns, rates=reg, clock=lambda: fake["t"])
    low = {m: _rate(0.3) for m in "ab"}
    sched.rebalance(rates=low)
    reg.record("a", int(low["a"] * 3))
    return reg.changed_models(sched.rate_threshold,
                              sched.rate_decrease_multiplier,
                              min_span_s=reg.window_s / 2.0)


def test_monitor_ignores_cold_start_inflation():
    assert _twin(_cold_start) == {}


# --- twins of tests/test_colocate_fuzz.py ------------------------------------
def _storm(ns, seed):
    rng = random.Random(seed)
    models = ("a", "b", "c")
    chips = [ns.colocate.ColocatedLLMEngines(name=f"chip{i}")
             for i in range(3)]
    engines = []

    def factory(model, placement, queue, device):
        e = InstantEngine(model, placement.num_slots, placement.capacity,
                          queue)
        engines.append(e)
        return e

    sched = ns.control.LLMLiveScheduler(
        {m: _profile(ns, m) for m in models}, chips, factory)
    for m in models:
        sched.register_model(m, token_slo_ms=1000.0)
    trace, submitted = [], []
    try:
        for _ in range(120):
            op = rng.random()
            if op < 0.45:
                sched.rebalance(rates={
                    m: _rate(rng.choice([0.0, 0.2, 0.4, 0.6, 0.8]))
                    for m in models})
            elif op < 0.75:
                req = ns.request.Request(
                    model=rng.choice(models),
                    payload={"tokens": [1, 2], "max_new_tokens": 4},
                    slo_ms=600_000.0)
                sched.submit_request(req)
                submitted.append(req)
            else:
                for chip in chips:
                    chip.step_once()
            hosted = [m for chip in chips for m in chip.models()]
            assert len(hosted) == len(set(hosted)), f"double: {hosted}"
            trace.append(_hosted(chips))
        sched.rebalance(rates={m: _rate(0.3) for m in models})
        for _ in range(10):
            for chip in chips:
                chip.step_once()
        served = [r.future.result(timeout=5)["served_by"] for r in submitted]
        assert served == [r.model for r in submitted]
        trace += [served, sched.migrations, _audit(sched)]
    finally:
        sched.shutdown()
    assert all(not chip.models() for chip in chips)
    assert all(e.released for e in engines)
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_random_rate_storm_holds_invariants(seed):
    _twin(lambda ns: _storm(ns, seed))


def _migration_storm(ns):
    chips = [ns.colocate.ColocatedLLMEngines(name=f"chip{i}")
             for i in range(2)]

    def factory(model, placement, queue, device):
        return InstantEngine(model, placement.num_slots,
                             placement.capacity, queue)

    sched = ns.control.LLMLiveScheduler(
        {m: _profile(ns, m) for m in "ab"}, chips, factory)
    for m in "ab":
        sched.register_model(m, token_slo_ms=1000.0)
    reqs, trace = [], []
    try:
        for i in range(30):
            f_a = 0.3 if i % 2 == 0 else 0.7
            sched.rebalance(rates={"a": _rate(f_a), "b": _rate(0.3)})
            req = ns.request.Request(model="a", payload={"tokens": [i]},
                                     slo_ms=600_000.0)
            sched.submit_request(req)
            reqs.append(req)
            if i % 3 == 0:
                for chip in chips:
                    chip.step_once()
            trace.append(_hosted(chips))
        for _ in range(5):
            for chip in chips:
                chip.step_once()
        trace.append([r.future.result(timeout=5)["served_by"]
                      for r in reqs])
        trace.append(sched.migrations)
    finally:
        sched.shutdown()
    return trace


def test_migration_storm_preserves_queued_work():
    trace = _twin(_migration_storm)
    assert trace[-2] == ["a"] * 30


def _failing_cotenant(ns):
    chip = ns.colocate.ColocatedLLMEngines(name="chip0")
    q_bad = ns.queue.RequestQueue("bad", max_len=16)
    q_bad.add_request(ns.request.Request(model="bad",
                                         payload={"tokens": [1]},
                                         slo_ms=600_000.0))
    chip.attach("bad", BrokenEngine("bad", 2, 64, q_bad))
    q_ok = ns.queue.RequestQueue("ok", max_len=16)
    reqs = []
    for i in range(4):
        r = ns.request.Request(model="ok", payload={"tokens": [i]},
                               slo_ms=600_000.0)
        q_ok.add_request(r)
        reqs.append(r)
    chip.attach("ok", InstantEngine("ok", 2, 64, q_ok))
    try:
        for _ in range(12):
            chip.step_once()
        return [r.future.result(timeout=1)["served_by"] for r in reqs]
    finally:
        chip.shutdown()


def test_failing_engine_does_not_starve_cotenants():
    assert _twin(_failing_cotenant) == ["ok"] * 4


def _stalled(ns):
    chips = [ns.colocate.ColocatedLLMEngines(name="chip0",
                                             idle_wait_s=0.001)]
    built = []

    def factory(model, placement, queue, device):
        cls = BrokenEngine if not built else InstantEngine
        e = cls(model, placement.num_slots, placement.capacity, queue)
        built.append(e)
        return e

    sched = ns.control.LLMLiveScheduler({"a": _profile(ns, "a")}, chips,
                                        factory)
    sched.register_model("a", token_slo_ms=1000.0)
    try:
        sched.rebalance(rates={"a": _rate(0.3)})
        reqs = []
        for i in range(3):
            r = ns.request.Request(model="a", payload={"tokens": [i]},
                                   slo_ms=600_000.0)
            sched.submit_request(r)
            reqs.append(r)
        chips[0].start()
        time.sleep(0.3)
        replaced = sched.check_engine_health(stall_timeout_s=0.2)
        deadline = time.monotonic() + 5
        served = [r.future.result(
            timeout=max(0.1, deadline - time.monotonic()))["served_by"]
            for r in reqs]
        return [replaced, served, built[0].released,
                sched.engine_replacements,
                [(a["trigger"], a["note"], a["diff"])
                 for a in _audit(sched)]]
    finally:
        sched.shutdown()


def test_stalled_engine_is_replaced_and_backlog_served():
    replaced, served, released, n, _ = _twin(_stalled)
    assert replaced == 1 and served == ["a"] * 3 and released and n == 1


def _stale_replacement(ns):
    chip = ns.colocate.ColocatedLLMEngines(name="chip0")
    q = ns.queue.RequestQueue("a", max_len=16)
    chip.attach("a", InstantEngine("a", 2, 64, q))
    successor = InstantEngine("a", 2, 64, q)
    chip.replace("a", successor)
    chip.detach("a", drain=False)
    trace = [successor.released]
    chip.step_once()
    trace.append(chip.models())
    chip.attach("a", InstantEngine("a", 2, 64, q))
    s1, s2 = InstantEngine("a", 2, 64, q), InstantEngine("a", 2, 64, q)
    chip.replace("a", s1)
    chip.replace("a", s2)
    trace.append([s1.released, s2.released])
    chip.shutdown()
    trace.append(s2.released)
    return trace


def test_stale_replacement_is_dropped_not_resurrected():
    assert _twin(_stale_replacement) == [True, [], [True, False], True]


def _wedged(ns):
    wedge = threading.Event()

    class WedgedEngine(InstantEngine):
        def _admit(self):
            self._admitting_batch = self.queue.get_batch(
                1, discard_stale=False)
            wedge.wait(timeout=30)
            return 0

    chips = [ns.colocate.ColocatedLLMEngines(name=f"chip{i}",
                                             idle_wait_s=0.001)
             for i in range(2)]
    built = []

    def factory(model, placement, queue, device):
        cls = WedgedEngine if not built else InstantEngine
        e = cls(model, placement.num_slots, placement.capacity, queue)
        built.append(e)
        return e

    sched = ns.control.LLMLiveScheduler({"a": _profile(ns, "a")}, chips,
                                        factory)
    sched.chip_stall_timeout_s = 0.3
    sched.register_model("a", token_slo_ms=1000.0)
    try:
        sched.rebalance(rates={"a": _rate(0.3)})
        host = next(c for c in chips if c.models())
        spare = next(c for c in chips if c is not host)
        for c in chips:
            c.start()
        req = ns.request.Request(model="a", payload={"tokens": [1]},
                                 slo_ms=600_000.0)
        sched.submit_request(req)
        time.sleep(0.6)
        sched.check_engine_health()
        rejected = False
        try:
            req.future.result(timeout=2)
        except Exception:  # noqa: BLE001 — the wedged admission's request
            rejected = True
        req2 = ns.request.Request(model="a", payload={"tokens": [2]},
                                  slo_ms=600_000.0)
        sched.submit_request(req2)
        served = req2.future.result(timeout=5)["served_by"]
        return [sched.chip_quarantines, host in sched.quarantined,
                rejected, served, "a" in spare.models(),
                [(a["trigger"], a["note"]) for a in _audit(sched)]]
    finally:
        wedge.set()
        sched.shutdown()


def test_wedged_chip_is_quarantined_and_models_replan():
    assert _twin(_wedged)[:5] == [1, True, True, "a", True]


def _dead_executor(ns):
    chips = [ns.colocate.ColocatedLLMEngines(name="chip0",
                                             idle_wait_s=0.001)]

    def factory(model, placement, queue, device):
        return InstantEngine(model, placement.num_slots,
                             placement.capacity, queue)

    sched = ns.control.LLMLiveScheduler({"a": _profile(ns, "a")}, chips,
                                        factory)
    sched.register_model("a", token_slo_ms=1000.0)
    try:
        sched.rebalance(rates={"a": _rate(0.3)})
        chips[0].start()
        chips[0]._run.clear()
        deadline = time.monotonic() + 5
        while chips[0].running and time.monotonic() < deadline:
            time.sleep(0.01)
        dead = not chips[0].running and chips[0]._thread is not None
        chips[0]._run.set()
        sched.check_engine_health()
        req = ns.request.Request(model="a", payload={"tokens": [1]},
                                 slo_ms=600_000.0)
        sched.submit_request(req)
        return [dead, chips[0].running,
                req.future.result(timeout=5)["served_by"]]
    finally:
        sched.shutdown()


def test_dead_executor_thread_is_restarted():
    assert _twin(_dead_executor) == [True, True, "a"]


# --- where the port departs: a hosted shape is kept while it serves ----------
def _tied_profile(ns, name):
    """Flat 10 ms steps at 4, 8 and 32 slots (the host-bound shape of the
    card's rows): at a 40 ms token SLO every row's SLO term is 0.25, so a
    low rate ties them and the packer's HBM tie-break takes the fewest
    slots whose capacity term stays under 0.25."""
    return ns.table.BatchProfile(f"{name}_decode", [
        ns.table.ProfileRow(batch_size=n, seq_len=128, latency_ms=10.0,
                            latency_std_ms=0.0, hbm_bytes=int(gb * GB),
                            compile_ms=100.0)
        for n, gb in ((4, 1.0), (8, 1.1), (32, 1.3))])


def _tied_sched(ns, models):
    chips = [FakeChip(f"chip{i}") for i in range(2)]
    built = []

    def factory(model, placement, queue, device):
        built.append((model, placement.num_slots))
        return FakeEngine(model, placement.num_slots, placement.capacity)

    sched = ns.control.LLMLiveScheduler(
        {m: _tied_profile(ns, m) for m in models}, chips, factory)
    for m in models:
        sched.register_model(m, token_slo_ms=40.0)
    return sched, chips, built


def _slots(sched):
    return {p.model: p.num_slots for chip in sched._current_plan
            for p in chip}


def _rate_noise(ns):
    """One model's rate reading wanders 160 -> 80 -> 160 -> 200 -> 500
    tok/s. At 80 four slots tie on the SLO floor; from 100 to 200 eight
    slots do; at 500 four slots would need 1.25 of the chip, eight 0.625
    and 32 the 0.25 floor."""
    sched, chips, built = _tied_sched(ns, ("a",))
    trace = []
    try:
        for r in (160.0, 80.0, 160.0, 200.0, 500.0):
            sched.rebalance(rates={"a": r})
            trace.append((_slots(sched)["a"], sched.migrations))
    finally:
        sched.shutdown()
    return trace, built


def test_replan_keeps_a_hosted_shape_while_it_serves():
    ref, ref_built = _rate_noise(JAX)
    port, port_built = _rate_noise(PORT)
    # The reference follows the tie-break across every reading.
    assert ref == [(8, 0), (4, 1), (8, 2), (8, 2), (32, 3)]
    assert [n for _, n in ref_built] == [8, 4, 8, 32]
    # The port keeps 8 slots while they serve (0.25 up to 200 tok/s,
    # 0.625 at 500, under the 0.85 headroom): one build.
    assert port == [(8, 0)] * 5
    assert port_built == [("a", 8)]


def _hosted_row_stops_serving(ns):
    sched, chips, built = _tied_sched(ns, ("a",))
    try:
        sched.rebalance(rates={"a": 60.0})     # 4 slots: 0.25
        sched.rebalance(rates={"a": 400.0})    # 4 slots would need 1.0
        return _slots(sched)["a"], sched.migrations
    finally:
        sched.shutdown()


def test_a_hosted_shape_that_no_longer_serves_moves_as_the_packer_says():
    # 8 slots would need 0.5 at 400 tok/s, 32 slots the 0.25 floor.
    assert _twin(_hosted_row_stops_serving) == (32, 1)


def _keeping_costs_a_chip(ns):
    sched, chips, built = _tied_sched(ns, ("a", "b"))
    try:
        sched.rebalance(rates={"a": 60.0, "b": 60.0})
        first = (_slots(sched), _hosted(chips))
        # a at 300 tok/s: its 4 slots alone would serve it (0.75), but
        # beside b's 0.25 they need a second chip; 32 slots (0.25) keep
        # the pair on one.
        sched.rebalance(rates={"a": 300.0, "b": 60.0})
        return first, (_slots(sched), _hosted(chips))
    finally:
        sched.shutdown()


def test_kept_shapes_yield_when_they_cost_a_chip():
    (slots1, hosted1), (slots2, hosted2) = _twin(_keeping_costs_a_chip)
    assert slots1 == {"a": 4, "b": 4} and hosted1 == [["a", "b"], []]
    assert slots2 == {"a": 32, "b": 4} and hosted2 == [["a", "b"], []]
