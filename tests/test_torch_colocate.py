"""Colocated decode execution, the decode profiler and length buckets in
the port, on real llama_tiny engines (CPU, f32, params bridged from the
JAX package's).

Twins of ``tests/test_colocate.py`` and of the decode profiler and
length-bucket tests (``tests/test_profiles.py:110``,
``tests/test_llm_serving.py:502``):

- two engines of different shapes colocated on one ``ColocatedLLMEngines``
  give every greedy request the tokens the JAX ``DecodeEngine`` gives it
  alone;
- under sustained backlog the executor delivers the planned compute
  fractions as measured busy shares (0.7 / 0.3), and equal shares
  without a plan;
- a long prompt's chunked fill on one tenant does not stall the other;
- a token-rate surge is detected, replans, and moves an engine across two
  CPU executors while traffic keeps completing;
- ``DecodeProfiler`` sweeps the reference sweep's grid with positive
  latencies and footprints, and its tables drive ``num_slots=0``;
- ``length_buckets`` routes each request to the smallest cache that
  fits, as the JAX replica routes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu_torch.engine.colocate import (
    ColocatedLLMEngines,
)
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.rates import RateRegistry
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.profiles.decode_profiler import (
    DecodeProfiler,
)
from ray_dynamic_batching_tpu_torch.profiles.profiler import (
    write_profile_outputs,
)
from ray_dynamic_batching_tpu_torch.profiles.table import (
    BatchProfile,
    ProfileRow,
)
from ray_dynamic_batching_tpu_torch.scheduler.llm_control import (
    LLMLiveScheduler,
)
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    LLMPlacement,
    worst_latency_ms,
)
from ray_dynamic_batching_tpu_torch.utils import config as t_config

torch.set_num_threads(2)

SHAPES = {"a": (4, 64), "b": (2, 32)}     # (slots, capacity) per tenant


@pytest.fixture(scope="module")
def models():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


@pytest.fixture(autouse=True)
def _config():
    t_config.reset_config()
    yield
    t_config.reset_config()


def _engine(tm, queue, slots, cap, **kw):
    return DecodeEngine(tm, queue, num_slots=slots, max_len=cap,
                        prompt_buckets=[8], default_max_new_tokens=12,
                        decode_horizon=kw.pop("decode_horizon", 1),
                        device="cpu", **kw)


def _payloads(seed, n, max_new=12):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, int(rng.integers(3, 9))).tolist(),
             "max_new_tokens": max_new} for _ in range(n)]


def test_colocated_greedy_tokens_equal_the_jax_engine_alone(models):
    jm, params, tm = models
    ex = ColocatedLLMEngines(name="card0")
    reqs = {}
    try:
        for name, (slots, cap) in SHAPES.items():
            q = RequestQueue(name, max_len=64)
            ex.attach(name, _engine(tm, q, slots, cap, decode_horizon=2))
            reqs[name] = [Request(model=name, payload=p, slo_ms=1e7)
                          for p in _payloads(ord(name), 5)]
            for r in reqs[name]:
                q.add_request(r)
        ex.run_until_idle(timeout_s=120)
        got = {n: [r.future.result(timeout=5).tokens for r in rs]
               for n, rs in reqs.items()}
        busy = ex.busy_fractions()
    finally:
        ex.shutdown()
    assert set(busy) == {"a", "b"} and all(f > 0 for f in busy.values())
    for name, (slots, cap) in SHAPES.items():
        jq = JQueue(name)
        je = JEngine(jm, params, jq, num_slots=slots, max_len=cap,
                     prompt_buckets=[8], default_max_new_tokens=12,
                     decode_horizon=2)
        jreqs = [JRequest(model=name, payload=p, slo_ms=1e7)
                 for p in _payloads(ord(name), 5)]
        for r in jreqs:
            jq.add_request(r)
        je.run_until_idle(timeout_s=120)
        want = [r.future.result(timeout=5).tokens for r in jreqs]
        assert got[name] == want


def _saturate(engine, queue, waves):
    for _ in range(waves * engine.num_slots):
        queue.add_request(Request(
            model=engine.model.name,
            payload={"tokens": [1, 2, 3], "max_new_tokens": engine.max_len},
            slo_ms=600_000.0))


def _colocated_shares(tm, fractions, passes=250):
    """Two engines of different step costs saturated on one executor;
    their measured busy shares."""
    ex = ColocatedLLMEngines(name="shared")
    engines = {}
    try:
        for name, (slots, cap) in SHAPES.items():
            q = RequestQueue(name, max_len=256)
            placement = None
            if fractions.get(name) is not None:
                placement = LLMPlacement(
                    model=name, num_slots=slots, capacity=cap, step_ms=1.0,
                    compute_fraction=fractions[name], hbm_bytes=1)
            e = _engine(tm, q, slots, cap)
            ex.attach(name, e, placement)
            engines[name] = (e, q)
        for e, q in engines.values():
            _saturate(e, q, waves=8)
        for _ in range(8):
            ex.step_once()
        ex.reset_accounting()
        done = 0
        while done < passes and all(e.active_slots > 0 or len(q) > 0
                                    for e, q in engines.values()):
            ex.step_once()
            done += 1
        assert done >= 50, "window too short to mean anything"
        return ex.busy_fractions()
    finally:
        ex.shutdown()


@pytest.mark.parametrize("fractions,share_a", [
    ({"a": 0.7, "b": 0.3}, 0.7),
    ({"a": None, "b": None}, 0.5),
], ids=["planned", "unplanned"])
def test_planned_fractions_are_delivered(models, fractions, share_a):
    fr = _colocated_shares(models[2], fractions)
    share = fr["a"] / max(fr["a"] + fr["b"], 1e-9)
    assert abs(share - share_a) <= 0.12, (
        f"a's planned {share_a:.2f} of executor time measured {share:.2f}")
    assert 0.8 <= fr["a"] + fr["b"] <= 1.01


def test_long_prompt_fill_does_not_stall_cotenant(models):
    tm = models[2]
    ex = ColocatedLLMEngines(name="isolation")
    q_a, q_b = RequestQueue("a", max_len=64), RequestQueue("b", max_len=64)
    e_a = _engine(tm, q_a, 2, 256)
    e_b = _engine(tm, q_b, 2, 128)
    ex.attach("a", e_a)
    ex.attach("b", e_b)
    try:
        for _ in range(2):
            q_b.add_request(Request(
                model="llama_tiny",
                payload={"tokens": [1, 2, 3], "max_new_tokens": 120},
                slo_ms=600_000.0))
        while e_b.active_slots == 0:
            ex.step_once()
        prompt = list(range(1, 121))    # 15 chunks of the 8-token bucket
        n_chunks = (len(prompt) + 7) // 8
        q_a.add_request(Request(
            model="llama_tiny",
            payload={"tokens": prompt, "max_new_tokens": 4},
            slo_ms=600_000.0))
        b_steps0 = None
        while e_a.active_slots == 0:
            b_steps0 = e_b.steps
            assert ex.step_once(), "executor stalled before admission"
        gained = e_b.steps - b_steps0
        assert e_a.long_chunk_dispatches == n_chunks
        assert gained >= n_chunks - 3, (
            f"co-tenant starved: B stepped {gained} times across a "
            f"{n_chunks}-chunk admission")
    finally:
        ex.shutdown()


@pytest.fixture(scope="module")
def measured_rows(models):
    """Solo-measured decode rows for the two tenant shapes."""
    prof = DecodeProfiler(models[2], timing_iters=4, warmup_iters=1)
    return {shape: prof.profile_decode_config(*shape)
            for shape in SHAPES.values()}


def _rate_for_fraction(row: ProfileRow, fraction: float) -> float:
    return fraction * 1000.0 * row.batch_size / row.latency_ms


def _token_slo(row: ProfileRow) -> float:
    return max(50.0, 50.0 * worst_latency_ms(row))


def test_rate_shift_detected_replans_and_migrates(models, measured_rows):
    tm = models[2]
    row_a, row_b = measured_rows[SHAPES["a"]], measured_rows[SHAPES["b"]]
    profiles = {"tiny_a": BatchProfile("tiny_a_decode", [row_a]),
                "tiny_b": BatchProfile("tiny_b_decode", [row_b])}
    fake = {"t": 1000.0}

    def clock():
        return fake["t"]

    rates = RateRegistry(window_s=10.0, clock=clock)
    chips = [ColocatedLLMEngines(name="chip0"),
             ColocatedLLMEngines(name="chip1")]
    built = []

    def factory(name, placement, queue, device):
        e = _engine(tm, queue, placement.num_slots, placement.capacity)
        built.append(e)
        return e

    sched = LLMLiveScheduler(profiles, chips, factory, rates=rates,
                             clock=clock)
    sched.register_model("tiny_a", token_slo_ms=_token_slo(row_a))
    sched.register_model("tiny_b", token_slo_ms=_token_slo(row_b))

    def submit(model, n):
        out = []
        for p in _payloads(n, n):
            req = Request(model=model, payload=p, slo_ms=600_000.0)
            assert sched.submit_request(req)
            out.append(req)
        return out

    low_b = _rate_for_fraction(row_b, 0.25)
    try:
        plan = sched.rebalance(rates={
            "tiny_a": _rate_for_fraction(row_a, 0.25), "tiny_b": low_b})
        assert len(plan) == 1
        host0 = next(c for c in chips if c.models())
        reqs = submit("tiny_a", 3) + submit("tiny_b", 3)
        host0.run_until_idle(timeout_s=120)
        for r in reqs:
            assert r.future.result(timeout=5).finish_reason == "length"
        # Surge tiny_a to a 0.7 fraction over six fake seconds: the pair
        # (0.95) no longer fits one chip under the 0.85 headroom.
        surge_a = int(_rate_for_fraction(row_a, 0.7))
        for i in range(6):
            if i:
                fake["t"] += 1.0
            rates.record("tiny_a", n=surge_a)
            rates.record("tiny_b", n=int(low_b))
        changed = rates.changed_models(
            sched.rate_threshold, sched.rate_decrease_multiplier,
            min_span_s=rates.window_s / 2.0)
        assert "tiny_a" in changed
        plan2 = sched.rebalance()
        assert len(plan2) == 2 and sched.migrations >= 1
        hosts = {m: c.name for c in chips for m in c.models()}
        assert hosts["tiny_a"] != hosts["tiny_b"]
        reqs2 = submit("tiny_a", 2) + submit("tiny_b", 2)
        for c in chips:
            c.run_until_idle(timeout_s=120)
        for r in reqs2:
            assert r.future.result(timeout=5).finish_reason == "length"
        assert all(len(c.busy_fractions()) <= 1 for c in chips)
        assert sum(e._cache is None for e in built) >= 1   # drained, freed
    finally:
        sched.shutdown()
    assert all(e._cache is None for e in built)


def test_decode_profiler_sweeps_the_reference_grid(models, tmp_path):
    """The reference test's grid (slots 2 and 4 at capacity 64; prompt
    bucket 8 at groups 1 and 2), positive rows, the JAX profiler's
    (batch, seq) keys, and tables that size a ``num_slots=0``
    deployment."""
    from ray_dynamic_batching_tpu.profiles.decode_profiler import (
        DecodeProfiler as JProfiler,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    jm, params, tm = models
    grid = dict(slot_buckets=(2, 4), capacities=(64,), prompt_buckets=(8,),
                group_sizes=(1, 2))
    prof = DecodeProfiler(tm, timing_iters=2, warmup_iters=1)
    assert prof.dispatches_per_config == 7
    decode, prefill = prof.sweep(**grid)
    jdecode, jprefill = JProfiler(jm, params, timing_iters=2,
                                  warmup_iters=1).sweep(**grid)
    for ours, ref in ((decode, jdecode), (prefill, jprefill)):
        assert [(r.batch_size, r.seq_len) for r in ours.rows] == \
            [(r.batch_size, r.seq_len) for r in ref.rows]
        assert ours.model_name == ref.model_name
        for r in ours.rows:
            assert r.latency_ms > 0 and r.hbm_bytes > 0 and r.compile_ms > 0
    weights = tm.param_bytes()
    for r in decode.rows:
        # weights + the slab k/v (2 layers, 2 kv heads, head_dim 16) at
        # least; a CPU row has no transient term.
        assert r.hbm_bytes >= weights + tm.kv_bytes_per_slot(64) * \
            r.batch_size
    d_csv, _, _ = write_profile_outputs(decode, str(tmp_path))
    write_profile_outputs(prefill, str(tmp_path))
    assert d_csv.endswith("llama_tiny_decode_summary.csv")
    dep = LLMDeployment("llama_tiny", model=tm, warmup=False, max_len=64,
                        num_slots=0, profiles_dir=str(tmp_path),
                        token_slo_ms=10_000.0, device="cpu")
    engine = dep.build_engine(RequestQueue("llama_tiny", max_len=16))
    try:
        assert engine.num_slots in (2, 4)
    finally:
        engine.release_buffers()


def test_length_buckets_route_to_the_smallest_fitting_cache(models):
    """``TestLengthBuckets``: short requests decode in the small cache,
    long ones in the large, oversized ones in the largest with a
    capacity finish; the JAX replica routes the same payloads alike."""
    from ray_dynamic_batching_tpu.serve.controller import (
        DeploymentConfig as JConfig,
    )
    from ray_dynamic_batching_tpu.serve.llm import (
        LLMDeployment as JDeployment,
    )
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    jm, params, tm = models
    knobs = dict(num_slots=2, max_len=64, prompt_buckets=[8],
                 default_max_new_tokens=4, length_buckets=[16, 64])
    payloads = [{"tokens": [1, 2, 3], "max_new_tokens": 4},
                {"tokens": [1, 2, 3, 4, 5, 6], "max_new_tokens": 20},
                {"tokens": [1] * 8, "max_new_tokens": 200},
                {"tokens": [1] * 12}, [5, 6, 7]]
    jrep = JDeployment("llama_tiny", model=jm, params=params, warmup=False,
                       **knobs).make_replica("j", JConfig(name="buckets"))
    want = [jrep._engine_for(p) for p in payloads]
    jrep.stop(timeout_s=0.5)

    controller = ServeController(control_interval_s=0.2)
    dep = LLMDeployment("llama_tiny", model=tm, device="cpu", **knobs)
    router = controller.deploy(DeploymentConfig(name="buckets"),
                               factory=dep)
    handle = DeploymentHandle(router, default_slo_ms=60_000.0)
    try:
        replica = controller._deployments["buckets"].replicas[0]
        assert sorted(replica.engines) == [16, 64]
        assert [replica._engine_for(p) for p in payloads] == want \
            == [16, 64, 64, 16, 16]
        short = handle.remote(payloads[0]).result(timeout=60)
        assert len(short.tokens) == 4
        long = handle.remote(payloads[1]).result(timeout=60)
        assert len(long.tokens) == 20
        over = handle.remote(payloads[2]).result(timeout=60)
        assert over.finish_reason == "capacity"
        deadline = __import__("time").monotonic() + 10
        while (replica.engines[64].completed < 2
               and __import__("time").monotonic() < deadline):
            __import__("time").sleep(0.01)
        stats = replica.stats()
        assert stats["bucket_16"]["completed"] == 1.0
        assert stats["bucket_64"]["completed"] == 2.0
        assert stats["completed"] == 3.0
    finally:
        controller.shutdown()
