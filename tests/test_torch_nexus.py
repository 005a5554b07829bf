"""The port's Nexus packers against the JAX package's, on the same inputs.

Twins of ``tests/test_nexus.py``: every scenario (saturate, residue,
merge, scale, LLM colocation) runs through both packages'
``SquishyBinPacker`` / ``pack_llm_engines`` with the same sessions, the
same ``tests/fixtures`` profiles and the same config, and the plans must
be equal field for field (exact floats); the reference test's own
assertions are then held on the port's plan. Both packages' config
singletons are set alike and reset after each test.
"""

import dataclasses
import math
from types import SimpleNamespace

import pytest

import ray_dynamic_batching_tpu.scheduler.nexus as j_nexus
import ray_dynamic_batching_tpu_torch.scheduler.nexus as t_nexus
from ray_dynamic_batching_tpu.profiles import table as j_table
from ray_dynamic_batching_tpu.utils import config as j_config
from ray_dynamic_batching_tpu_torch.profiles import table as t_table
from ray_dynamic_batching_tpu_torch.utils import config as t_config
from tests.fixtures import make_profiles

GB = 1024**3


def _port_profile(ref):
    return t_table.BatchProfile(ref.model_name, [
        t_table.ProfileRow(**dataclasses.asdict(r)) for r in ref.rows])


def _llm_profile(table, name, step_ms=10.0, hbm_gb=3.0):
    """``tests/test_nexus.py`` TestLLMColocation's three-row table."""
    rows = [
        table.ProfileRow(batch_size=s, seq_len=256,
                         latency_ms=step_ms * (1 + 0.05 * i),
                         latency_std_ms=0.0,
                         hbm_bytes=int((hbm_gb + i) * (1 << 30)),
                         compile_ms=100.0)
        for i, s in enumerate((8, 16, 32))
    ]
    return table.BatchProfile(f"{name}_decode", rows)


JAX = SimpleNamespace(nexus=j_nexus, table=j_table, config=j_config,
                      profiles=make_profiles)
PORT = SimpleNamespace(
    nexus=t_nexus, table=t_table, config=t_config,
    profiles=lambda: {k: _port_profile(v)
                      for k, v in make_profiles().items()})


@pytest.fixture(autouse=True)
def _configs():
    yield
    j_config.reset_config()
    t_config.reset_config()


def _set(ns, **kw):
    ns.config.set_config(ns.config.RDBConfig.from_env(**kw))


def _plain(x):
    """A plan as plain nested data (dataclasses of either package)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _packer(ns, budget=int(16 * GB / 0.9), **cfg):
    _set(ns, **{"slo_safety_factor": 1.0, **cfg})
    return ns.nexus.SquishyBinPacker(ns.profiles(), hbm_budget_bytes=budget)


def _both(scenario):
    """Run ``scenario(ns)`` on both packages; equal results; the port's."""
    ref, port = scenario(JAX), scenario(PORT)
    assert _plain(port) == _plain(ref)
    return port


def _sessions(ns, *specs):
    return [ns.nexus.Session(*s) for s in specs]


# --- the duty-cycle packer ---------------------------------------------------
def test_saturate_row_slo_over_2_rule():
    row = _both(lambda ns: _packer(ns).saturate_row(
        ns.nexus.Session("fast", slo_ms=10.0, rate_rps=100.0)))
    assert row.batch_size == 64
    assert 2 * t_nexus.worst_latency_ms(row) <= 10.0


def test_rate_split_into_saturated_nodes():
    nodes, residues = _both(lambda ns: _packer(ns).schedule_saturate(
        _sessions(ns, ("fast", 10.0, 40000.0))))
    assert len(nodes) == 2
    assert all(n.occupancy == pytest.approx(1.0) for n in nodes)
    assert residues[0].rate_rps == pytest.approx(40000 - 2 * (64 / 0.0042))


def test_zero_rate_sessions_dropped():
    assert _both(lambda ns: _packer(ns).plan(
        _sessions(ns, ("fast", 10.0, 0.0)))) == []


@pytest.mark.parametrize("spec,batch", [
    (("heavy", 200.0, 50.0), 8),          # latency + fill <= SLO
    (("fast", 100.0, 10.0), None),        # low rate: a small batch
    (("heavy", 500.0, 0.5), None),        # duty capped by SLO headroom
    (("heavy", 500.0, 100.0), None),      # feasible: batch / rate duty
])
def test_residue_node(spec, batch):
    node = _both(lambda ns: _packer(ns).residue_node(ns.nexus.Session(*spec)))
    p = node.placements[0]
    assert p.occupancy <= 1.0
    assert node.duty_cycle_ms + p.latency_ms <= spec[1] + 1e-9
    if batch is not None:
        assert p.batch_size == batch


@pytest.mark.parametrize("specs,chips", [
    ([("fast", 50.0, 200.0), ("fat", 400.0, 20.0)], 1),     # colocate
    ([("fast", 25.0, 200.0), ("heavy", 400.0, 20.0)], 2),   # cycles clash
    ([("fast", 20.0, 3000.0), ("heavy", 300.0, 30.0),
      ("fat", 100.0, 100.0)], None),
    ([("fast", 20.0, 5000.0), ("heavy", 300.0, 40.0)], None),
    ([("fast", 20.0, 1234.0), ("heavy", 250.0, 77.0),
      ("fat", 90.0, 55.0)], None),
])
def test_plan_equal_and_within_the_chip(specs, chips):
    plan = _both(lambda ns: _packer(ns).plan(_sessions(ns, *specs)))
    if chips is not None:
        assert len(plan) == chips
    budget = int(int(16 * GB / 0.9) * 0.9)
    for node in plan:
        assert node.occupancy <= 1.0 + 1e-9
        assert node.hbm_bytes <= budget
    served = {}
    for node in plan:
        for p in node.placements:
            served[p.session.model] = served.get(p.session.model, 0.0) + (
                p.batch_size / node.duty_cycle_ms * 1000.0)
    for model, _slo, rate in specs:
        assert served[model] >= rate * 0.99


def test_merge_rejected_when_hbm_exceeded():
    plan = _both(lambda ns: _packer(
        ns, budget=5 * GB, hbm_plan_fraction=1.0).plan(
            _sessions(ns, ("fat", 400.0, 20.0), ("fat", 400.0, 20.0))))
    assert len(plan) == 2


def test_merge_rederives_batches_from_duty():
    def scenario(ns):
        packer = _packer(ns)
        packer.profiles["fast2"] = ns.profiles()["fast"]
        return packer.plan(_sessions(ns, ("fast", 50.0, 400.0),
                                     ("fast2", 50.0, 100.0)))

    plan = _both(scenario)
    assert len(plan) == 1
    for p in plan[0].placements:
        need = math.ceil(plan[0].duty_cycle_ms * p.session.rate_rps / 1000.0)
        assert p.batch_size >= need
        assert p.batch_size in [1, 2, 4, 8, 16, 32, 64, 128, 256]


def test_more_rate_needs_more_chips():
    low, high = _both(lambda ns: [
        _packer(ns).chips_required(_sessions(ns, ("heavy", 300.0, r)))
        for r in (50.0, 2000.0)])
    assert high > low


@pytest.mark.parametrize("pricing", ["batch", "slot"])
def test_occupancy_pricing_modes_agree(pricing):
    def scenario(ns):
        packer = _packer(ns)
        packer.occupancy_pricing = pricing
        return packer.plan(_sessions(ns, ("fast", 40.0, 700.0),
                                     ("heavy", 300.0, 25.0),
                                     ("fat", 200.0, 30.0)))

    _both(scenario)


# --- the decode colocation packer --------------------------------------------
def _llm(ns, sessions, tables, **kw):
    _set(ns)
    return ns.nexus.pack_llm_engines(
        [ns.nexus.LLMSession(*s) for s in sessions],
        {name: _llm_profile(ns.table, name, *args)
         for name, args in tables.items()}, **kw)


def test_two_llms_share_one_chip():
    chips = _both(lambda ns: _llm(
        ns, [("a", 300.0, 50.0), ("b", 300.0, 50.0)],
        {"a": (), "b": ()}, hbm_budget_bytes=12 << 30))
    assert len(chips) == 1 and {p.model for p in chips[0]} == {"a", "b"}
    assert 0 < sum(p.compute_fraction for p in chips[0]) <= 0.85


@pytest.mark.parametrize("tables,budget,n_chips", [
    ({"a": (), "b": (40.0,)}, 12 << 30, 2),        # b re-measured 4x slower
    ({"a": (10.0, 4.0), "b": (10.0, 4.0)}, 6 << 30, 2),   # memory forces it
    ({"a": (), "b": ()}, None, 1),                  # the config's budget
])
def test_llm_packing_follows_the_tables(tables, budget, n_chips):
    chips = _both(lambda ns: _llm(
        ns, [("a", 300.0, 50.0), ("b", 300.0, 50.0)], tables,
        hbm_budget_bytes=budget))
    assert len(chips) == n_chips


@pytest.mark.parametrize("sessions,tables,match", [
    ([("a", 10.0, 5.0)], {"a": (10.0,)}, "no measured decode config"),
    ([("zz", 1.0, 100.0)], {}, "no decode profile"),
])
def test_llm_packing_refusals_match(sessions, tables, match):
    msgs = []
    for ns in (JAX, PORT):
        with pytest.raises(ValueError, match=match) as info:
            _llm(ns, sessions, tables)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
