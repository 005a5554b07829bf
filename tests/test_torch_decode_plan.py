"""Deployment sizing in the port against the JAX package (CPU).

Twins of ``tests/test_decode_plan.py``, and of ``TestAutoSlots``
(``tests/test_llm_serving.py:402``): ``plan_from_tables`` on fixture
tables and on the committed ``profiles/cpu/`` tables (llama_tiny, its
int8-KV table, gpt2_medium), ``build_engine`` through ``profiles_dir``
(the table plan, pinned slots, the analytic fallback), and
``auto_num_slots`` on bridged llama_tiny over several budgets — each on
both packages with the same inputs and config, and equal answers. A CSV
written by either package parses identically in the other.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.profiles import table as j_table
from ray_dynamic_batching_tpu.serve.llm import LLMDeployment as JDeployment
from ray_dynamic_batching_tpu.utils import config as j_config
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.models.quant import tree_weight_bytes
from ray_dynamic_batching_tpu_torch.profiles import table as t_table
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
from ray_dynamic_batching_tpu_torch.utils import config as t_config

torch.set_num_threads(2)

GB = 1 << 30
PROFILES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "profiles", "cpu")


@pytest.fixture(autouse=True)
def _configs():
    j_config.reset_config()
    t_config.reset_config()
    yield
    j_config.reset_config()
    t_config.reset_config()


def _set_both(**kw):
    j_config.set_config(j_config.RDBConfig.from_env(**kw))
    t_config.set_config(t_config.RDBConfig.from_env(**kw))


def _row(table, slots, cap, step_ms, hbm_gb):
    return table.ProfileRow(
        batch_size=slots, seq_len=cap, latency_ms=step_ms,
        latency_std_ms=0.0, hbm_bytes=int(hbm_gb * GB), compile_ms=100.0)


def _decode_table(table, step_scale=1.0, slow64=None):
    # Throughput (slots/step): 4/5, 16/8, 64/20, 128/45 per ms at scale 1.
    steps = {4: 5.0, 16: 8.0, 64: slow64 or 20.0, 128: 45.0}
    hbm = {4: 1.0, 16: 2.0, 64: 5.0, 128: 9.0}
    return table.BatchProfile("m_decode", [
        _row(table, s, 256, steps[s] * step_scale, hbm[s]) for s in steps])


def _prefill_table(table, latency_ms=40.0):
    return table.BatchProfile("m_prefill", [
        table.ProfileRow(batch_size=g, seq_len=64, latency_ms=latency_ms * m,
                         latency_std_ms=0.0, hbm_bytes=GB, compile_ms=50.0)
        for g, m in ((1, 1.0), (4, 2.0))])


def _deployments(name="llama_tiny", **kw):
    return (JDeployment(name, dtype=jnp.float32, warmup=False, **kw),
            LLMDeployment(name, dtype=torch.float32, warmup=False,
                          device="cpu", **kw))


@pytest.mark.parametrize("case", [
    dict(kw=dict(token_slo_ms=30.0), want={"num_slots": 64,
                                           "decode_horizon": 1}),
    dict(kw=dict(token_slo_ms=10.0), want={"num_slots": 16}),
    dict(kw=dict(token_slo_ms=30.0), slow64=60.0, want={"num_slots": 16}),
    dict(kw=dict(token_slo_ms=160.0), want={"decode_horizon": 8}),
    dict(kw=dict(token_slo_ms=160.0, ttft_slo_ms=300.0), prefill=True,
         want={"ttft_horizon": 8}),
    dict(kw=dict(token_slo_ms=160.0, ttft_slo_ms=150.0), prefill=True,
         want={"ttft_horizon": 4}),
    dict(kw=dict(token_slo_ms=1.0), want={"num_slots": 4}),
    dict(kw=dict(token_slo_ms=160.0, num_slots=128),
         want={"num_slots": 128, "decode_horizon": 3}),
    dict(kw=dict(), budget=3 * GB, want={"num_slots": 16}),
], ids=["throughput", "slo_excludes", "changed_table", "horizon",
        "ttft_wide", "ttft_narrow", "fastest_fallback", "pinned",
        "budget"])
def test_plan_from_tables_matches(case):
    if "budget" in case:
        _set_both(hbm_budget_bytes=case["budget"])
    plans = []
    for dep, table in zip(_deployments(max_len=256), (j_table, t_table)):
        plans.append(dep.plan_from_tables(
            _decode_table(table, slow64=case.get("slow64")),
            _prefill_table(table) if case.get("prefill") else None,
            **{"token_slo_ms": 30.0, **case["kw"]}))
    assert plans[0] == plans[1]
    assert {k: plans[1][k] for k in case["want"]} == case["want"]


@pytest.mark.parametrize("rows,match", [
    ([(4, 512, 5.0, 1.0)], "re-run the decode profiler"),
    ([(4, 256, 5.0, 1.0)], "no measured decode row"),
])
def test_plan_refusals_match(rows, match):
    msgs = []
    for dep, table in zip(_deployments(max_len=256), (j_table, t_table)):
        with pytest.raises(ValueError, match=match) as info:
            dep.plan_from_tables(
                table.BatchProfile("m_decode",
                                   [_row(table, *r) for r in rows]),
                token_slo_ms=30.0,
                num_slots=8 if "row" in match else None)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def _engine_shape(engine):
    return (engine.num_slots, engine.decode_horizon, engine.ttft_horizon)


@pytest.mark.parametrize("case", [
    dict(dep=dict(num_slots=0, token_slo_ms=160.0, ttft_slo_ms=300.0),
         tables=("decode", "prefill"), want=(64, 8, 8)),
    dict(dep=dict(num_slots=4), tables=(), want=(4, 8, 2)),
    dict(dep=dict(num_slots=0, token_slo_ms=160.0), tables=("decode",),
         build=dict(num_slots=128), want=(128, 3, 1)),
    dict(dep=dict(num_slots=0, token_slo_ms=160.0, decode_horizon=6),
         tables=("decode",), build=dict(num_slots=48), want=(48, 6, 1)),
], ids=["table_plan", "missing_table", "pinned_row", "pinned_no_row"])
def test_build_engine_from_profiles_dir_matches(tmp_path, case):
    if "decode" in case["tables"]:
        _decode_table(j_table).to_csv(
            str(tmp_path / "llama_tiny_decode_summary.csv"))
    if "prefill" in case["tables"]:
        _prefill_table(j_table).to_csv(
            str(tmp_path / "llama_tiny_prefill_summary.csv"))
    shapes = []
    for dep, queue in zip(
            _deployments(max_len=256, prompt_buckets=[8],
                         profiles_dir=str(tmp_path), **case["dep"]),
            (JQueue, RequestQueue)):
        engine = dep.build_engine(queue("llama_tiny", max_len=16),
                                  **case.get("build", {}))
        try:
            shapes.append(_engine_shape(engine))
        finally:
            engine.release_buffers()
    assert shapes[0] == shapes[1] == case["want"]


def _committed(table, model):
    path = os.path.join(PROFILES_DIR, f"{model}_decode_summary.csv")
    return table.BatchProfile.from_csv(f"{model}_decode", path)


@pytest.mark.parametrize("model", ["llama_tiny", "gpt2_medium",
                                   "llama_tiny_int8kv"])
def test_committed_tables_plan_alike(model):
    plans = []
    for dep, table in zip((JDeployment, LLMDeployment), (j_table, t_table)):
        prof = _committed(table, model)
        cap = max(r.seq_len for r in prof.rows)
        kw = dict(device="cpu") if dep is LLMDeployment else {}
        d = dep(model, warmup=False, max_len=cap, profiles_dir=PROFILES_DIR,
                **kw)
        for slo in (1.0, 100.0 * max(r.latency_ms for r in prof.rows)):
            plans.append(d.plan_from_tables(prof, token_slo_ms=slo,
                                            ttft_slo_ms=500.0))
    assert plans[:2] == plans[2:]
    assert plans[3]["num_slots"] in {
        r.batch_size for r in _committed(t_table, model).rows}


def test_int8_deployment_builds_its_int8_model():
    _jdep, dep = _deployments("llama_tiny_int8kv", max_len=256,
                              profiles_dir=PROFILES_DIR)
    assert dep._ensure_model().kv_dtype == torch.int8


def test_committed_tables_pack_alike():
    import ray_dynamic_batching_tpu.scheduler.nexus as j_nexus
    import ray_dynamic_batching_tpu_torch.scheduler.nexus as t_nexus

    plans = []
    for nexus, table in ((j_nexus, j_table), (t_nexus, t_table)):
        llama, gpt2 = (_committed(table, m)
                       for m in ("llama_tiny", "gpt2_medium"))
        steps = {m: min(r.latency_ms for r in p.rows)
                 for m, p in (("llama_tiny", llama), ("gpt2_medium", gpt2))}
        chips = nexus.pack_llm_engines(
            [nexus.LLMSession(m, rate_tok_s=0.3 * 1000 * 2 / s,
                              token_slo_ms=100.0 * s)
             for m, s in steps.items()],
            {"llama_tiny": llama, "gpt2_medium": gpt2},
            hbm_budget_bytes=8 << 30)
        plans.append([[dataclasses.astuple(p) for p in chip]
                      for chip in chips])
    assert plans[0] == plans[1]
    assert {p[0] for chip in plans[1] for p in chip} == {"llama_tiny",
                                                          "gpt2_medium"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_csv_written_by_either_package_reads_alike(tmp_path, writer):
    src = {"jax": j_table, "port": t_table}[writer]
    tables = [_decode_table(src), _committed(src, "gpt2_medium")]
    for i, prof in enumerate(tables):
        path = str(tmp_path / f"t{i}.csv")
        text = prof.to_csv(path)
        rows = [[dataclasses.astuple(r) for r in table.BatchProfile.from_csv(
            "m", arg).rows] for table in (j_table, t_table)
            for arg in (path, text)]
        assert rows[0] == rows[1] == rows[2] == rows[3]
        assert rows[0] == [dataclasses.astuple(r) for r in prof.rows]
    # The JSON form as well.
    text = tables[0].to_json()
    assert [dataclasses.astuple(r) for r in
            j_table.BatchProfile.from_json(text).rows] == \
        [dataclasses.astuple(r) for r in
         t_table.BatchProfile.from_json(text).rows]


@pytest.fixture(scope="module")
def bridged():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


def test_weight_bytes_equal_the_flax_tree(bridged):
    from ray_dynamic_batching_tpu.models.quant import (
        tree_weight_bytes as j_bytes,
    )

    _jm, params, tm = bridged
    assert tree_weight_bytes(tm) == j_bytes(params)


@pytest.mark.parametrize("budget", [64 << 20, 256 << 20, 1 << 30, 14 * GB])
def test_auto_num_slots_matches(bridged, budget):
    """``TestAutoSlots`` on both packages: the same count for every
    (chips, capacity, budget share), a power of two, and it fits."""
    jm, params, tm = bridged
    _set_both(hbm_budget_bytes=budget)
    jdep = JDeployment("llama_tiny", num_slots=0, max_len=64,
                       prompt_buckets=[8], model=jm, params=params,
                       warmup=False)
    dep = LLMDeployment("llama_tiny", num_slots=0, max_len=64,
                        prompt_buckets=[8], model=tm, warmup=False,
                        device="cpu")
    for n_chips in (1, 4):
        for max_len in (None, 256):
            for fraction in (1.0, 0.5):
                want = jdep.auto_num_slots(n_chips, max_len=max_len,
                                           budget_fraction=fraction)
                got = dep.auto_num_slots(n_chips, max_len=max_len,
                                         budget_fraction=fraction)
                assert got == want
                assert got & (got - 1) == 0
    n1 = dep.auto_num_slots(1)
    assert n1 == 1 or n1 * tm.kv_bytes_per_slot(64) <= budget
    assert dep.auto_num_slots(4) >= n1


def test_num_slots_zero_without_tables_sizes_from_the_budget(bridged):
    _jm, _params, tm = bridged
    _set_both(hbm_budget_bytes=1 << 30)
    dep = LLMDeployment("llama_tiny", num_slots=0, max_len=64,
                        prompt_buckets=[8], model=tm, warmup=False,
                        device="cpu", length_buckets=[32, 64])
    for cap in (32, 64):
        engine = dep.build_engine(RequestQueue("t"), max_len=cap)
        try:
            assert engine.num_slots == dep.auto_num_slots(
                1, max_len=cap, budget_fraction=0.5)
        finally:
            engine.release_buffers()
