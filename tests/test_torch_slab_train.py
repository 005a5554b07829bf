"""The slab-train arm: ``chunked_prefill=True`` on a slab engine.

Every admission becomes a chunk train on a private row cache, advanced one
chunk of the largest bucket at a time under the token budget. Held here
against the JAX package's slab-train arm on the canonical engine of
``tools/check_compiles.py`` (llama_tiny f32, 4 slots, ``max_len`` 96,
buckets [8, 16], horizon 4) with ``paged=False``: identical greedy
streams for prompts of 5-60 tokens, in the model dtype and with the int8
KV cache; against the port's own monolithic slab arm; and against the
budget (chunk dispatches between two decode turns).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

torch.set_num_threads(2)

SLAB_TRAINS = dict(num_slots=4, max_len=96, prompt_buckets=[8, 16],
                   eos_token_id=None, default_max_new_tokens=8,
                   decode_horizon=4, paged=False, chunked_prefill=True)


def _bridged(name, **jkw):
    jm = j_lm.CausalLM(j_lm.TINY_LM, name=name, dtype=jnp.float32, **jkw)
    params = jm.init(jax.random.PRNGKey(0))
    tm = registry.get_model(name, dtype=torch.float32, device="cpu",
                            seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return _bridged("llama_tiny")


@pytest.fixture(scope="module")
def models_int8():
    return _bridged("llama_tiny_int8kv", kv_dtype=jnp.int8)


def _payloads(seed=5, n=8):
    """Prompts of 5-60 tokens: single-chunk trains (<= 16) and trains of
    two to four chunks past the largest bucket; one row stops early."""
    rng = np.random.default_rng(seed)
    lens = [5, 60, 12, 33, 16, 47, 9, 17][:n]
    return [{"tokens": rng.integers(1, 500, plen).tolist(),
             "max_new_tokens": 4 + i % 5} for i, plen in enumerate(lens)]


def _serve_jax(jm, params, payloads, cfg):
    jq = JQueue("j", max_len=256)
    je = JEngine(jm, params, jq, **cfg)
    reqs = [JRequest(model="j", payload=p, slo_ms=6e4) for p in payloads]
    for r in reqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5) for r in reqs]


def _serve_torch(tm, payloads, cfg, on_step=None, setup=None):
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **cfg)
    if setup is not None:
        setup(engine)
    if on_step is not None:
        inner = engine._step

        def step(horizon=None):
            on_step(engine)
            return inner(horizon)

        engine._step = step
    reqs = [Request(model="t", payload=p, slo_ms=1e7) for p in payloads]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5) for r in reqs], engine


def test_slab_trains_identical_to_jax_engine(models):
    jm, params, tm = models
    payloads = _payloads()
    want = _serve_jax(jm, params, payloads, SLAB_TRAINS)
    got, engine = _serve_torch(tm, payloads, SLAB_TRAINS)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    # One chunk per 16 tokens of every prompt; no other prefill path.
    assert engine.chunk_dispatches == sum(
        -(-len(p["tokens"]) // 16) for p in payloads)
    assert engine.prefill_groups == engine.long_chunk_dispatches == 0
    assert not engine._trains and not engine._train_slots


def test_slab_trains_int8_kv_identical_to_jax_engine(models_int8):
    jm, params, tm = models_int8
    payloads = _payloads(seed=6)
    want = _serve_jax(jm, params, payloads, SLAB_TRAINS)
    got, engine = _serve_torch(tm, payloads, SLAB_TRAINS)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine._cache.quantized and engine.chunk_dispatches > 0


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_slab_chunked_equals_slab_mono(models, kind):
    """The port's own two slab arms give one stream (the reference's
    ``test_slab_chunked_matches_slab_mono``): chunk trains against
    bucketed groups plus the long fill, greedy and a seeded sampled row."""
    _jm, _params, tm = models
    payloads = _payloads(seed=7)
    if kind == "sampled":
        payloads[3].update(temperature=0.7, top_k=12, seed=99)
    mono_cfg = dict(SLAB_TRAINS, chunked_prefill=False)
    mono, mono_engine = _serve_torch(tm, payloads, mono_cfg)
    chunked, _ = _serve_torch(tm, payloads, SLAB_TRAINS)
    assert [r.tokens for r in chunked] == [r.tokens for r in mono]
    assert mono_engine.long_chunk_dispatches > 0


@pytest.mark.parametrize("budget", [16, 32, 48])
def test_chunk_dispatches_between_decode_turns_stay_in_budget(models,
                                                              budget):
    """While any stream decodes, at most ``budget // C`` chunks run
    between two of its decode turns (the stall bound; an idle engine
    pumps on without a turn to wait for)."""
    _jm, _params, tm = models
    seen = []
    pending = [0]

    def on_step(engine):
        seen.append(pending[0])
        pending[0] = 0

    def setup(engine):
        inner = engine._advance_train_slab

        def advance(train):
            if engine._active_mask.any():
                pending[0] += 1
            return inner(train)

        engine._advance_train_slab = advance

    payloads = _payloads(seed=8)
    _got, engine = _serve_torch(
        tm, payloads, dict(SLAB_TRAINS, prefill_token_budget=budget),
        on_step=on_step, setup=setup)
    assert seen and max(seen) <= budget // 16
    assert max(seen) == budget // 16   # a saturating burst uses the budget
    assert engine.prefill_token_budget == budget


def test_slab_train_warmup_and_deployment(models):
    """Warmup runs the row-cache chunk and commit and leaves the cache
    empty; ``LLMDeployment(chunked_prefill=True)`` serves on the slab."""
    _jm, _params, tm = models
    engine = DecodeEngine(tm, RequestQueue("t"), device="cpu", **SLAB_TRAINS)
    engine.warmup()
    assert engine._cache.lengths.eq(0).all()
    assert engine.chunk_dispatches == 0
    dep = LLMDeployment("llama_tiny", model=tm, device="cpu", warmup=False,
                        chunked_prefill=True,
                        **{k: v for k, v in SLAB_TRAINS.items()
                           if k not in ("paged", "chunked_prefill")})
    replica = dep.make_replica("llama_tiny-0",
                               DeploymentConfig(name="llama_tiny"))
    assert replica.engine.chunked_prefill and not replica.engine.paged
    replica.start()
    try:
        reqs = [Request(model="llama_tiny", payload=p, slo_ms=1e7)
                for p in _payloads(seed=9, n=4)]
        assert all(replica.assign(r) for r in reqs)
        got = [r.future.result(timeout=120) for r in reqs]
    finally:
        replica.stop()
    want, _ = _serve_torch(tm, _payloads(seed=9, n=4), SLAB_TRAINS)
    assert [r.tokens for r in got] == [r.tokens for r in want]
