"""Weight-only int8 serving: the port's engine vs the JAX package's (CPU,
f32, ``llama_tiny`` and ``llama_tiny_int8kv``, weights bridged by
``params_from_flax``).

Both engines take ``quantize_weights=True`` (the JAX engine quantizes its
params and dequantizes inside every program; the port quantizes the model
in place and reads the codes in every product) and serve the same
prompts, one of them past the largest bucket (the long fill on the
monolithic arms, a multi-chunk train on the chunked ones): greedy tokens
must be identical on the five arms — slab, paged (chunked), int8 KV
(slab), int8 KV paged, slab trains — and on a speculative arm whose target
is quantized and whose draft (a different tiny model) is not, as the JAX
engine allows. A self-draft of a quantized target drafts from the
full-precision weights, as the JAX engine's self-draft reads its
full-precision ``draft_params``: on the slab and paged arms the spec books
(per round: accepted and proposed; so rounds, proposed and accepted in
all) equal the JAX engine's exactly, with identical greedy tokens; a
self-draft of a model that arrives already quantized is refused.
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
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.models.quant import is_quantized

torch.set_num_threads(2)

SLAB = dict(num_slots=4, max_len=64, prompt_buckets=[16],
            default_max_new_tokens=6)
PAGED = dict(num_slots=4, max_len=96, prompt_buckets=[8, 16],
             default_max_new_tokens=6, decode_horizon=4, paged=True,
             page_size=128, chunked_prefill=True)
SLAB_TRAINS = dict(PAGED, paged=False)
# arm -> (registry model, engine knobs)
ARMS = {
    "slab": ("llama_tiny", SLAB),
    "paged": ("llama_tiny", PAGED),
    "int8_kv": ("llama_tiny_int8kv", SLAB),
    "int8_kv_paged": ("llama_tiny_int8kv", PAGED),
    "slab_trains": ("llama_tiny", SLAB_TRAINS),
}


def _bridge(name, params):
    tm = registry.get_model(name, dtype=torch.float32, device="cpu",
                            seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return tm


@pytest.fixture(scope="module")
def params():
    """Flax params of llama_tiny (PRNGKey(0)) and of a draft (42)."""
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    return jm.init(jax.random.PRNGKey(0)), jm.init(jax.random.PRNGKey(42))


def _payloads():
    """Five prompts of 3-14 tokens and one of 40, past every bucket."""
    rng = np.random.default_rng(7)
    lens = [5, 40, 12, 3, 14, 9]
    return [{"tokens": rng.integers(1, 500, n).tolist(),
             "max_new_tokens": 4 + i % 3} for i, n in enumerate(lens)]


def _serve(engine, queue, payloads, req_cls):
    reqs = [req_cls(model="t", payload=p, slo_ms=6e4) for p in payloads]
    for r in reqs:
        queue.add_request(r)
    engine.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5) for r in reqs]


def _jax_engine(name, params, cfg, **kw):
    kv = {"kv_dtype": jnp.int8} if name.endswith("int8kv") else {}
    jm = j_lm.CausalLM(j_lm.TINY_LM, name=name, dtype=jnp.float32, **kv)
    q = JQueue("j", max_len=256)
    return JEngine(jm, params, q, quantize_weights=True, **cfg, **kw), q


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_int8_weight_streams_identical_to_jax_engine(params, arm):
    name, cfg = ARMS[arm]
    payloads = _payloads()
    want = _serve(*_jax_engine(name, params[0], cfg), payloads, JRequest)
    tm = _bridge(name, params[0])
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", quantize_weights=True, **cfg)
    assert engine.quantized and is_quantized(tm)
    got = _serve(engine, q, payloads, Request)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert engine._cache.quantized == name.endswith("int8kv")
    if engine.paged:
        engine._allocator.check()
        assert engine._allocator.free_pages == engine.num_pages
    if not engine.chunked_prefill:
        assert engine.long_chunk_dispatches > 0      # the long fill ran


def test_quantized_target_with_an_unquantized_draft(params):
    """Speculative decoding: the target int8, the draft (another model)
    in f32, on both packages; greedy tokens identical, and the draft's
    weights untouched."""
    payloads = [dict(p, max_new_tokens=8) for p in _payloads()]
    jdraft = j_lm.CausalLM(j_lm.TINY_LM, name="d", dtype=jnp.float32)
    want = _serve(*_jax_engine("llama_tiny", params[0], SLAB,
                               draft_model=jdraft, draft_params=params[1],
                               spec_tokens=3), payloads, JRequest)
    tm = _bridge("llama_tiny", params[0])
    draft = _bridge("llama_tiny", params[1])
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", quantize_weights=True,
                          draft_model=draft, spec_tokens=3, **SLAB)
    got = _serve(engine, q, payloads, Request)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.spec_rounds > 0
    assert is_quantized(tm) and not is_quantized(draft)


@pytest.mark.parametrize("arm", ["slab", "paged"])
def test_self_draft_of_a_quantized_target_books_like_the_jax_engine(params,
                                                                   arm):
    """A self-draft of a quantized target drafts from the weights as they
    were before quantization (the JAX engine quantizes only the target's
    params; its draft reads the caller's f32 ``draft_params``): the spec
    books — every round's (accepted, proposed) — and the greedy tokens
    equal the JAX engine's."""
    cfg = ARMS[arm][1]
    payloads = [dict(p, max_new_tokens=8) for p in _payloads()]
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="d", dtype=jnp.float32)
    jeng, jq = _jax_engine("llama_tiny", params[0], cfg, draft_model=jm,
                           draft_params=params[0], spec_tokens=3)
    want = _serve(jeng, jq, payloads, JRequest)
    tm = _bridge("llama_tiny", params[0])
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", quantize_weights=True,
                          draft_model=tm, spec_tokens=3, **cfg)
    assert is_quantized(tm) and engine.draft_model is not tm
    assert not is_quantized(engine.draft_model)
    got = _serve(engine, q, payloads, Request)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    books = list(engine._spec_acc_window)
    assert books == list(jeng._spec_acc_window)
    assert engine.spec_rounds == len(books) > 0
    # Not the int8 target reading its own codes, which accepts everything.
    assert sum(a for a, _ in books) < sum(d for _, d in books)
    if engine.paged:
        engine._allocator.check()


def test_self_draft_of_an_already_quantized_model_is_refused(params):
    """A model quantized before the engine sees it has no full-precision
    weights left for a self-draft: the engine raises rather than draft
    from the codes."""
    from ray_dynamic_batching_tpu_torch.models.quant import quantize_tree

    tm = quantize_tree(_bridge("llama_tiny", params[0]))
    for quantize in (False, True):
        with pytest.raises(ValueError, match="self-draft"):
            DecodeEngine(tm, RequestQueue("t"), device="cpu",
                         quantize_weights=quantize, draft_model=tm,
                         spec_tokens=3, **SLAB)


@pytest.mark.parametrize("budget", [1 << 20, 64 << 20])
def test_quantized_self_draft_deployment_sizes_like_the_jax_one(params,
                                                               budget):
    """``LLMDeployment(quantize_weights=True)`` with a self-draft keeps a
    full-precision draft (the model's weights before quantization) and
    sizes its slots as the JAX deployment does, whose sizing counts the
    int8 target and the f32 ``draft_params``."""
    from ray_dynamic_batching_tpu.serve.llm import (
        LLMDeployment as JDeployment,
    )
    from ray_dynamic_batching_tpu.utils import config as j_config
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils import config as t_config

    for cfg in (j_config, t_config):
        cfg.set_config(cfg.RDBConfig.from_env(hbm_budget_bytes=budget))
    try:
        kw = dict(num_slots=0, max_len=64, prompt_buckets=[8], warmup=False,
                  quantize_weights=True, spec_tokens=3)
        jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny",
                           dtype=jnp.float32)
        # The JAX deployment's self-draft: the same registry model (f32)
        # over the caller's f32 params.
        jdep = JDeployment("llama_tiny", model=jm, params=params[0],
                           draft_model_name="llama_tiny",
                           draft_params=params[0], dtype=jnp.float32, **kw)
        tm = _bridge("llama_tiny", params[0])
        dep = LLMDeployment("llama_tiny", model=tm, draft_model=tm,
                            device="cpu", **kw)
        for n_chips, max_len in ((1, None), (1, 128)):
            assert dep.auto_num_slots(n_chips, max_len=max_len) == \
                jdep.auto_num_slots(n_chips, max_len=max_len)
        assert is_quantized(tm) and dep._draft_model is not tm
        assert not is_quantized(dep._draft_model)
    finally:
        j_config.reset_config()
        t_config.reset_config()
