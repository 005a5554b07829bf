"""The port's vision serving path against the JAX package's (CPU, f32).

- Collation: ``collate_vision`` / ``collate_text`` build the batches the
  JAX package's build (padded rows zero, one valid key per padding row),
  and the dispatcher's ``collate.batch`` span links every request.
- ``ModelHost``: reference counts, seed-built weights, the refused
  checkpoint surface.
- ``ReplicaEngine`` twins of ``tests/test_engine.py::TestReplicaEngine``
  on both packages with the same tiny models (``vit_tiny``,
  ``shufflenet_tiny``), the same params (the JAX host's own, converted
  by ``models/convert.py`` and loaded into the port host's models) and
  the same requests: served logits equal
  within 1e-4 x max|logit|, hot swaps release and acquire host
  references, partial batches are padded and trimmed.
- Scheduling twins of ``tests/test_control.py``: ``match_plans_to_engines``
  and ``transfer_cost`` on both packages; the port's ``LiveScheduler``
  rebalances and serves, its monitor replans on a rate change, it writes
  the metrics file; ``decide_replan`` over ``SquishyBinPacker`` gives the
  same ``NodePlan.describe()`` strings and audit fields as the JAX
  package's on ``profiles/cpu/{resnet50,shufflenet_v2,vit_b_16}`` for a
  grid of rates, residencies and capacity factors.
- The rate the port's window reads equals the reference's; the port's
  ``LiveScheduler`` plans at ``1 + RATE_HEADROOM`` times it; and the JAX
  package's own simulator, replaying the SLO demo's rate step on the
  H100-profiled tables, loses resnet50's second half at the reference's
  headroom of 0 and holds every half at the port's.

Every test stops its engines and its scheduler's monitor; every wait has
a timeout.
"""

import dataclasses
import json
import os
import time
from concurrent.futures import wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine import collate as j_collate
from ray_dynamic_batching_tpu.engine.host import ModelHost as JHost
from ray_dynamic_batching_tpu.engine.queue import QueueManager as JQueues
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.engine.worker import ReplicaEngine as JEngine
from ray_dynamic_batching_tpu.models import registry as j_reg
from ray_dynamic_batching_tpu.profiles import table as j_table
from ray_dynamic_batching_tpu.scheduler import nexus as j_nexus
from ray_dynamic_batching_tpu.scheduler import replan as j_replan
from ray_dynamic_batching_tpu.utils import config as j_config
from ray_dynamic_batching_tpu_torch.engine import collate as t_collate
from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.engine.worker import ReplicaEngine
from ray_dynamic_batching_tpu_torch.models import convert
from ray_dynamic_batching_tpu_torch.models import registry as t_reg
from ray_dynamic_batching_tpu_torch.profiles import table as t_table
from ray_dynamic_batching_tpu_torch.scheduler import nexus as t_nexus
from ray_dynamic_batching_tpu_torch.scheduler import control
from ray_dynamic_batching_tpu_torch.scheduler import replan as t_replan
from ray_dynamic_batching_tpu_torch.scheduler.control import (
    LiveScheduler,
    match_plans_to_engines,
    transfer_cost,
)
from ray_dynamic_batching_tpu_torch.utils import config as t_config
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer
from tests.fixtures import make_profiles

torch.set_num_threads(2)

CONVERT = {"vit_tiny": convert.vit_params_from_flax,
           "shufflenet_tiny": convert.shufflenet_params_from_flax}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _configs():
    yield
    j_config.reset_config()
    t_config.reset_config()


def _image(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (32, 32, 3)).astype(np.float32)


def _close(got, want) -> None:
    got, want = np.stack(got), np.stack(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


# --- collation ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collate_vision_matches_jax(dtype):
    jm = j_reg.get_model("vit_tiny", dtype=getattr(jnp, dtype))
    tm = t_reg.get_model("vit_tiny", dtype=getattr(torch, dtype),
                         device="cpu", seed=None)
    payloads = [_image(i) for i in range(3)]
    (want,), n_j = j_collate.collate_vision(
        jm, [JRequest("vit_tiny", p, slo_ms=1e4) for p in payloads], 4)
    (got,), n_t = t_collate.collate_vision(
        tm, [Request(model="vit_tiny", payload=p, slo_ms=1e4)
             for p in payloads], 4)
    assert n_j == n_t == 3
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, dtype=np.float32))
    assert not got[3].any()


def test_collate_text_and_dispatch_match_jax():
    tm = t_reg.get_model("llama_tiny", dtype=torch.float32, device="cpu",
                         seed=None)
    payloads = [np.arange(5), np.arange(3) + 7, np.arange(9)]
    j_reqs = [JRequest("m", p, slo_ms=1e4) for p in payloads]
    t_reqs = [Request(model="m", payload=p, slo_ms=1e4) for p in payloads]
    (jt, jmask), _ = j_collate.collate_text(None, j_reqs, 4, 8)
    (tt, tmask), n = t_collate.collate_text(tm, t_reqs, 4, 8)
    assert n == 3 and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    # The dispatcher's seq bucket defaults to the longest payload.
    (tt, _), _ = t_collate.collate(tm, t_reqs, 4)
    assert tuple(tt.shape) == (4, 9)


def test_collate_refusals():
    tm = t_reg.get_model("whisper_tiny_test", device="cpu", seed=None)
    with pytest.raises(ValueError, match="empty batch"):
        t_collate.collate_asr(tm, [], 1)
    tm.family = "unknown"
    with pytest.raises(ValueError, match="no collator"):
        t_collate.collate(tm, [], 1)


def test_collate_span_links_every_request():
    tm = t_reg.get_model("vit_tiny", device="cpu", seed=None)
    spans = []
    tracer().set_exporter(spans.append)
    try:
        with tracer().span("client") as parent:
            reqs = [Request(model="vit_tiny", payload=_image(i), slo_ms=1e4,
                            trace_ctx=tracer().inject_context())
                    for i in range(2)]
        t_collate.collate(tm, reqs, 2)
    finally:
        tracer().reset()
    (span,) = [s for s in spans if s.name == "collate.batch"]
    assert len(span.links) == 2
    assert all(link["trace_id"] == parent.trace_id for link in span.links)
    assert span.attributes["batch_bucket"] == 2


# --- the host ----------------------------------------------------------------
def test_model_host_refcounts_and_seeded_weights():
    host = ModelHost(device="cpu", seed=3)
    a = host.acquire("resnet18_tiny")
    assert host.acquire("resnet18_tiny") is a
    assert host.loaded_models() == {"resnet18_tiny": 2}
    other = ModelHost(device="cpu", seed=3).acquire("resnet18_tiny")
    assert torch.equal(a.stem_conv.weight, other.stem_conv.weight)
    assert a.device.type == "cpu" and a.dtype == torch.bfloat16
    host.release("resnet18_tiny")
    host.release("resnet18_tiny")
    assert host.loaded_models() == {}
    host.release("resnet18_tiny")        # a stray release is a no-op


def test_model_host_refuses_checkpoints():
    """What the host still refuses: saving a model it has not loaded, or
    with nowhere to write. A model with no checkpoint directory under
    ``checkpoint_dir`` is drawn from the seed (the reference's rule)."""
    host = ModelHost(checkpoint_dir="/nonexistent", device="cpu", seed=3)
    with pytest.raises(KeyError, match="not loaded"):
        host.save_checkpoint("vit_tiny")
    a = host.acquire("vit_tiny")
    b = ModelHost(device="cpu", seed=3).acquire("vit_tiny")
    assert all(torch.equal(x, y) for x, y in zip(
        a.state_dict().values(), b.state_dict().values()))
    bare = ModelHost(device="cpu")
    bare.acquire("vit_tiny")
    with pytest.raises(ValueError, match="no checkpoint_dir"):
        bare.save_checkpoint("vit_tiny")


# --- the engine twins --------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    """The JAX host's own params for the tiny models (it holds one
    reference to each for the module), and their port state_dicts."""
    j_host = JHost(model_kwargs={n: {"dtype": jnp.float32} for n in CONVERT})
    sds = {}
    for name, conv in CONVERT.items():
        _, params = j_host.acquire(name)
        sds[name] = conv(jax.tree_util.tree_map(np.asarray, params))
    yield j_host, sds
    for name in CONVERT:
        j_host.release(name)


@pytest.fixture
def twins(weights):
    """Both packages' engines; the port host holds one reference to each
    tiny model for the test, with the JAX host's weights loaded in."""
    j_host, sds = weights
    host = ModelHost(device="cpu", model_kwargs={
        n: {"dtype": torch.float32} for n in CONVERT})
    for name, sd in sds.items():
        host.acquire(name).load_state_dict(sd)
    sides = {
        "jax": (JQueues(), j_host, JEngine, j_nexus, JRequest),
        "port": (QueueManager(), host, ReplicaEngine, t_nexus, Request),
    }
    engines = {k: (q, h, E("e0", q, h), nx, R)
               for k, (q, h, E, nx, R) in sides.items()}
    yield engines
    for _, _, engine, _, _ in engines.values():
        engine.stop()
    for name in sds:
        host.release(name)


def _plan_for(nexus, model: str, batch: int, duty_ms: float = 20.0):
    s = nexus.Session(model, slo_ms=5000.0, rate_rps=100.0)
    return nexus.NodePlan(
        placements=[nexus.Placement(session=s, batch_size=batch,
                                    latency_ms=5.0, occupancy=0.5,
                                    hbm_bytes=0)],
        duty_cycle_ms=duty_ms,
    )


def _serve(side, model: str, batch: int, payloads):
    queues, _, engine, nexus, Req = side
    engine.assign(_plan_for(nexus, model, batch))
    engine.start()
    reqs = [Req(model=model, payload=p, slo_ms=30_000) for p in payloads]
    for r in reqs:
        queues.queue(model).add_request(r)
    done, not_done = wait([r.future for r in reqs], timeout=60)
    assert not not_done
    return [np.asarray(r.future.result()) for r in reqs]


def test_serves_requests_end_to_end(twins):
    payloads = [_image(i) for i in range(10)]
    out = {k: _serve(side, "vit_tiny", 4, payloads)
           for k, side in twins.items()}
    assert all(o.shape == (10,) for o in out["port"])
    _close(out["port"], out["jax"])
    queues = twins["port"][0]
    stats = queues.queue("vit_tiny").stats()
    assert stats["completed"] == 10
    assert stats["slo_compliance"] == 1.0
    assert twins["port"][2].busy_ms > 0


def test_hot_swap_models(twins):
    for key, side in twins.items():
        queues, host, engine, nexus, Req = side
        before = host.loaded_models().get("shufflenet_tiny", 0)
        first = _serve(side, "shufflenet_tiny", 2, [_image(0)])
        assert engine.models == ["shufflenet_tiny"]
        assert host.loaded_models()["shufflenet_tiny"] == before + 1
        engine.assign(_plan_for(nexus, "vit_tiny", 2))
        deadline = time.monotonic() + 60
        out = None
        while out is None and time.monotonic() < deadline:
            rv = Req(model="vit_tiny", payload=_image(1), slo_ms=30_000)
            queues.queue("vit_tiny").add_request(rv)
            try:
                out = rv.future.result(timeout=5)
            except Exception:  # noqa: BLE001 — not swapped in yet
                continue
        assert out is not None and np.asarray(out).shape == (10,)
        assert engine.models == ["vit_tiny"]
        # The swap released the old schedule's reference.
        assert host.loaded_models().get("shufflenet_tiny", 0) == before
        assert first[0].shape == (10,)


def test_padding_partial_batches(twins):
    out = {k: _serve(side, "vit_tiny", 8, [_image(5)])
           for k, side in twins.items()}
    assert out["port"][0].shape == (10,)
    _close(out["port"], out["jax"])
    # Unpadded: the same image alone through the port's model.
    model = twins["port"][1].acquire("vit_tiny")
    try:
        with torch.inference_mode():
            alone = model(torch.from_numpy(_image(5))[None]).numpy()
    finally:
        twins["port"][1].release("vit_tiny")
    _close(out["port"], list(alone))


# --- matching and transfer cost ----------------------------------------------
def _port_profile(ref):
    return t_table.BatchProfile(ref.model_name, [
        t_table.ProfileRow(**dataclasses.asdict(r)) for r in ref.rows])


def _node(nexus, model: str, batch: int = 4, duty: float = 50.0):
    s = nexus.Session(model, slo_ms=1000.0, rate_rps=100.0)
    return nexus.NodePlan(
        placements=[nexus.Placement(s, batch, 5.0, 0.5, 10_000_000)],
        duty_cycle_ms=duty,
    )


MATCH_CASES = {
    "keeps_models_in_place": ([{"fast"}, {"heavy"}], ["heavy", "fast"]),
    "extra_engines_idle": ([set(), {"fast"}, set()], ["fast"]),
    "capacity_truncation": ([set()], ["fast", "heavy"]),
    "greedy_beyond_brute_force": ([{"fast"}] + [set()] * 8,
                                  ["fast"] + ["heavy"] * 8),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_plans_to_engines_twin(case):
    residency, models = MATCH_CASES[case]
    engines = [frozenset(m) for m in residency]
    ref = j_replan.match_plans_to_engines(
        engines, [_node(j_nexus, m) for m in models], make_profiles())
    got = match_plans_to_engines(
        engines, [_node(t_nexus, m) for m in models],
        {k: _port_profile(v) for k, v in make_profiles().items()})
    assert [a.describe() if a else None for a in got] == [
        a.describe() if a else None for a in ref]
    if case == "keeps_models_in_place":
        assert got[0].models == ["fast"] and got[1].models == ["heavy"]
    if case == "extra_engines_idle":
        assert got.count(None) == 2 and got[1].models == ["fast"]
    if case == "capacity_truncation":
        assert len(got) == 1 and got[0] is not None
    if case == "greedy_beyond_brute_force":
        assert got[0].models == ["fast"]
        assert sum(a is not None for a in got) == 9


def test_transfer_cost_twin():
    ports = {k: _port_profile(v) for k, v in make_profiles().items()}
    for resident in (frozenset({"fat"}), frozenset()):
        got = transfer_cost(resident, _node(t_nexus, "fat"), ports)
        assert got == j_replan.transfer_cost(
            resident, _node(j_nexus, "fat"), make_profiles())
    assert transfer_cost(frozenset({"fat"}), _node(t_nexus, "fat"),
                         ports) == 0.0
    assert transfer_cost(frozenset(), _node(t_nexus, "fat"),
                         ports) > 1000.0       # compile_ms + weight MB


# --- decide_replan on the committed CPU tables -------------------------------
DEMO = {"resnet50": 6000.0, "shufflenet_v2": 4500.0, "vit_b_16": 40000.0}


def _tables(table):
    return {n: table.BatchProfile.from_csv(
        n, os.path.join(ROOT, "profiles", "cpu", f"{n}_summary.csv"))
        for n in DEMO}


@pytest.mark.parametrize("scale", [0.05, 0.2, 0.5, 1.0, 2.0])
@pytest.mark.parametrize("residency,factors", [
    ([set(), set(), set()], None),
    ([{"resnet50"}, {"vit_b_16", "shufflenet_v2"}, set()], None),
    ([{"vit_b_16"}, {"resnet50"}, {"shufflenet_v2"}], [1.0, 0.5, 1.0]),
])
def test_decide_replan_equals_jax_on_cpu_tables(scale, residency, factors):
    engines = [frozenset(m) for m in residency]
    rates = {"resnet50": 1.0 * scale, "shufflenet_v2": 2.0 * scale,
             "vit_b_16": 0.3 * scale}

    def decide(nexus, replan, table):
        packer = nexus.SquishyBinPacker(_tables(table),
                                        hbm_budget_bytes=12 << 30)
        models = {n: replan.ModelEntry(n, slo) for n, slo in DEMO.items()}
        return replan.decide_replan(
            packer, engines, replan.sessions_for(models, rates), rates,
            capacity_factors=factors)

    ref = decide(j_nexus, j_replan, j_table)
    got = decide(t_nexus, t_replan, t_table)
    assert [n.describe() for n in got.plan] == [
        n.describe() for n in ref.plan]
    assert [a.describe() if a else None for a in got.assignment] == [
        a.describe() if a else None for a in ref.assignment]
    assert got.audit_fields() == ref.audit_fields()
    assert got.plan, "every grid point plans at least one node"


# --- the rate the live scheduler reads, and the headroom it plans with ------
@pytest.mark.parametrize("now,ref_rps", [(12.3, 93.0), (0.5, 50.0)])
def test_rate_window_reads_as_the_reference(now, ref_rps):
    """100 arrivals a second until ``now``, a 10 s window: the port's
    tracker reads what the reference's does, span rule included (the
    filling second counts whole, so 93 rps on a full window and 50 in
    the first half second)."""
    from ray_dynamic_batching_tpu.engine.rates import RateTracker as JTracker
    from ray_dynamic_batching_tpu_torch.engine.rates import RateTracker

    t = {"now": 0.0}
    clock = lambda: t["now"]  # noqa: E731
    trackers = [JTracker(10.0, clock), RateTracker(10.0, clock)]
    for i in range(int(now * 100)):
        t["now"] = i / 100.0
        for tr in trackers:
            tr.record()
    t["now"] = now
    ref, got = (tr.rate_rps() for tr in trackers)
    assert got == ref == pytest.approx(ref_rps)


# The demo's three models as an H100 80GB HBM3 (700 W) profiled them
# (chip_smoke.py phase 13): (batch, latency ms, std ms, hbm bytes).
H100_ROWS = {
    "resnet50": [(1, 5.760, 0.235, 59106640), (8, 4.732, 0.522, 108432720),
                 (32, 6.125, 0.367, 283626832),
                 (64, 5.918, 0.171, 507432272),
                 (128, 10.719, 0.025, 964480336),
                 (256, 20.395, 0.060, 1875430736),
                 (512, 39.746, 0.010, 3699428688),
                 (1024, 78.180, 0.019, 7347424592)],
    "shufflenet_v2": [(1, 4.108, 0.101, 6675152), (8, 4.418, 0.240, 20794064),
                      (32, 8.412, 0.325, 57640144),
                      (128, 7.974, 0.249, 264313552),
                      (256, 7.768, 0.008, 522291920),
                      (512, 14.792, 0.019, 1037832400),
                      (1024, 28.640, 0.058, 2071010512),
                      (2048, 56.556, 0.092, 4135305936)],
    "vit_b_16": [(1, 5.066, 0.129, 179590048), (8, 4.996, 0.130, 213469600),
                 (16, 3.604, 0.086, 252189088), (32, 5.601, 0.132, 329939360),
                 (64, 10.688, 0.021, 485390752),
                 (128, 20.285, 0.014, 795048352),
                 (256, 39.128, 0.027, 1415870880)],
}
# tools/run_slo_demo.py's non-CPU SLOs, and 0.010 x each table's peak
# throughput (200 rps at most); resnet50 doubles at 30 s.
DEMO_SLO = {"resnet50": 2000.0, "shufflenet_v2": 1500.0, "vit_b_16": 4000.0}
DEMO_RPS = {"resnet50": 130.98, "shufflenet_v2": 200.0, "vit_b_16": 65.43}


def _h100_profiles(table):
    return {n: table.BatchProfile(n, [
        table.ProfileRow(b, 0, latency_ms=ms, latency_std_ms=std,
                         hbm_bytes=hbm, compile_ms=80.0)
        for b, ms, std, hbm in rows]) for n, rows in H100_ROWS.items()}


def test_rebalance_plans_with_rate_headroom():
    """The port's ``LiveScheduler`` hands the packer 1 + RATE_HEADROOM
    times the rates it reads; the schedule log and the audit keep the
    rates as read. On the H100 tables the reference's plan serves
    resnet50 at exactly its rate, the port's at 2.3x."""
    profiles = _h100_profiles(t_table)
    packer = t_nexus.SquishyBinPacker(profiles, hbm_budget_bytes=12 << 30)
    sched = LiveScheduler(packer, [])
    for n, slo in DEMO_SLO.items():
        sched.register_model(n, slo_ms=slo)
    scale = 1.0 + control.RATE_HEADROOM
    want = packer.plan([t_nexus.Session(n, DEMO_SLO[n], r * scale)
                        for n, r in DEMO_RPS.items()])
    got = sched.rebalance(rates=DEMO_RPS)
    assert [n.describe() for n in got] == [n.describe() for n in want]
    assert sched.schedule_log[-1]["rates"] == DEMO_RPS
    assert sched.audit.to_dicts()[-1]["observed"]["rates_rps"] == DEMO_RPS
    assert sched.rates.scheduled_rates() == DEMO_RPS

    def served(plan):
        (node,) = plan
        (p,) = [p for p in node.placements if p.session.model == "resnet50"]
        return p.batch_size / node.duty_cycle_ms * 1000.0

    ref = j_nexus.SquishyBinPacker(_h100_profiles(j_table),
                                   hbm_budget_bytes=12 << 30).plan(
        [j_nexus.Session(n, DEMO_SLO[n], r) for n, r in DEMO_RPS.items()])
    assert served(ref) == pytest.approx(DEMO_RPS["resnet50"], rel=1e-3)
    assert served(got) >= 2.0 * DEMO_RPS["resnet50"]


@pytest.mark.parametrize("headroom", [0.0, control.RATE_HEADROOM])
def test_reference_sim_replays_the_demo_step(headroom, monkeypatch):
    """The demo's traffic on the H100 tables through the JAX package's
    own simulator (``sim/``: its ``SquishyBinPacker``, ``decide_replan``,
    monitor and duty-cycle engines), per half of the run. At the
    reference's headroom (0.0) resnet50's doubled rate leaves a backlog
    that never drains, under 0.95 after the step as on the card; planned
    the port's way (rates x 1.5 into the packer) every half holds."""
    from ray_dynamic_batching_tpu.engine.workload import RatePattern
    from ray_dynamic_batching_tpu.sim import control as sim_control
    from ray_dynamic_batching_tpu.sim import (
        Scenario,
        SimModelSpec,
        Simulation,
    )

    plain = sim_control.sessions_for
    monkeypatch.setattr(sim_control, "sessions_for", lambda models, rates: (
        plain(models, {m: r * (1.0 + headroom) for m, r in rates.items()})))
    specs = [SimModelSpec(n, DEMO_SLO[n], pattern=RatePattern(
        "step", base_rps=r, amplitude=r if n == "resnet50" else 0.0,
        step_at_s=30.0)) for n, r in DEMO_RPS.items()]

    def run(duration_s):
        rep = Simulation(_h100_profiles(j_table), Scenario(
            models=specs, duration_s=duration_s, n_engines=3,
            seed=0)).run()
        return {n: (m["arrivals"], m["stale"] + m["dropped"]
                    + m["violations"]) for n, m in rep["models"].items()}

    first, whole = run(30.0), run(60.0)
    halves = {}
    for n in DEMO_RPS:
        (a1, m1), (a, m) = first[n], whole[n]
        halves[n] = (1.0 - m1 / a1, 1.0 - (m - m1) / (a - a1))
    if headroom == 0.0:
        assert halves["resnet50"][0] == 1.0
        assert halves["resnet50"][1] < 0.95
    else:
        assert min(min(h) for h in halves.values()) >= 0.95, halves


# --- the live scheduler ------------------------------------------------------
@pytest.fixture
def system():
    t_config.set_config(t_config.RDBConfig.from_env(slo_safety_factor=1.0))
    rows = [
        t_table.ProfileRow(b, 0, latency_ms=2.0 + 0.5 * b,
                           latency_std_ms=0.0, hbm_bytes=50_000_000,
                           compile_ms=100.0)
        for b in (1, 2, 4, 8)
    ]
    profiles = {"vit_tiny": t_table.BatchProfile("vit_tiny", rows)}
    packer = t_nexus.SquishyBinPacker(profiles, hbm_budget_bytes=16 << 30)
    queues = QueueManager()
    host = ModelHost(device="cpu",
                     model_kwargs={"vit_tiny": {"dtype": torch.float32}})
    engines = [ReplicaEngine(f"e{i}", queues, host) for i in range(2)]
    sched = LiveScheduler(packer, engines, queues=queues)
    sched.register_model("vit_tiny", slo_ms=5000.0)
    for e in engines:
        e.start()
    yield sched, engines, queues
    for e in engines:
        e.stop()
    sched.stop_monitoring()


def test_register_requires_profile(system):
    sched, _, _ = system
    assert control.RATE_HEADROOM == 0.5   # plans at 1.5x the rates it reads
    with pytest.raises(KeyError):
        sched.register_model("unprofiled", slo_ms=100.0)


def test_submit_unregistered_rejected(system):
    sched, _, _ = system
    r = Request(model="nope", payload=_image(0), slo_ms=100.0)
    assert not sched.submit_request(r)
    with pytest.raises(KeyError):
        r.future.result(timeout=1)


def test_rebalance_and_serve(system):
    sched, engines, queues = system
    plan = sched.rebalance(rates={"vit_tiny": 50.0})
    assert len(plan) == 1
    reqs = [Request(model="vit_tiny", payload=_image(i), slo_ms=30_000)
            for i in range(6)]
    for r in reqs:
        assert sched.submit_request(r)
    for r in reqs:
        assert r.future.result(timeout=60).shape == (10,)
    snap = sched.snapshot()
    assert snap["queues"]["vit_tiny"]["completed"] == 6
    assert snap["schedule_changes"] == 1
    assert sched.audit.to_dicts()[-1]["trigger"] == "manual"
    status = sched.render_status()
    assert "vit_tiny" in status and "ok" in status


def test_monitor_triggers_rebalance_on_rate_change(system):
    sched, engines, queues = system
    sched.monitoring_interval_s = 0.05
    sched.rebalance(rates={"vit_tiny": 10.0})
    changes_before = sched.schedule_changes
    # Traffic whose measured rate (> 0) deviates > 5% from 10 rps.
    sched.start_monitoring()
    deadline = time.monotonic() + 30
    while sched.schedule_changes == changes_before:
        sched.submit_request(Request(model="vit_tiny", payload=_image(0),
                                     slo_ms=30_000))
        time.sleep(0.005)
        if time.monotonic() > deadline:
            pytest.fail("monitor never rebalanced")
    assert sched.schedule_changes > changes_before
    assert sched.audit.to_dicts()[-1]["trigger"] == "rate_change"


def test_metrics_file(system, tmp_path):
    sched, _, _ = system
    sched.metrics_path = str(tmp_path / "metrics.json")
    sched.rebalance(rates={"vit_tiny": 5.0})
    sched.write_metrics()
    data = json.loads((tmp_path / "metrics.json").read_text())
    assert "queues" in data and "plan" in data
    assert data["plan"] == [n.describe() for n in sched._current_plan]
