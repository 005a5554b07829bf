"""Port DecodeEngine / LLMDeployment vs the JAX package's engine (CPU, f32).

Both engines serve llama_tiny with the same weights (bridged with
``params_from_flax``), 4 slots, ``max_len`` 64, one prompt bucket of 16,
and the same prompts: greedy token streams must be identical. Sampled
streams cannot match JAX's (its threefry keys are not reproduced), so
they are held to the properties JAX has: reproducible regardless of slot
and neighbours, and inside the top-k support.
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
from ray_dynamic_batching_tpu_torch.engine.decode import (
    DecodeEngine,
    gumbel_noise,
)
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import (
    BadRequest,
    Request,
)
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

torch.set_num_threads(2)

ENGINE = dict(num_slots=4, max_len=64, prompt_buckets=[16],
              default_max_new_tokens=12)


@pytest.fixture(scope="module")
def models():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(3, 17))).tolist()
            for _ in range(n)]


def _serve_torch(tm, payloads, **kw):
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **{**ENGINE, **kw})
    reqs = [Request(model="t", payload=p, slo_ms=1e7) for p in payloads]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=120)
    return [r.future.result(timeout=5) for r in reqs], engine


def _extras(i):
    """Per-request options both samplers must apply identically on greedy
    rows: none, logit bias + a ban, presence/frequency penalties."""
    return [{}, {"logit_bias": {7: 3.0, 100: -2.5}, "banned_tokens": [3]},
            {"presence_penalty": 0.7, "frequency_penalty": 0.4}][i % 3]


@pytest.mark.parametrize("options", [False, True],
                         ids=["plain", "bias_and_penalties"])
def test_greedy_streams_identical_to_jax_engine(models, options):
    """Six prompts through four slots: admissions, mid-stream joins and
    finishes, over several decode horizons — with and without logit
    bias, bans and repetition penalties on the greedy rows."""
    jm, params, tm = models
    payloads = [{"tokens": p, "max_new_tokens": 10 + i,
                 **(_extras(i) if options else {})}
                for i, p in enumerate(_prompts(1, 6))]
    jq = JQueue("j")
    je = JEngine(jm, params, jq, **ENGINE)
    jreqs = [JRequest(model="j", payload=p, slo_ms=1e7) for p in payloads]
    for r in jreqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=120)
    got, engine = _serve_torch(tm, payloads)
    for j, t in zip(jreqs, got):
        want = j.future.result(timeout=5)
        assert t.tokens == want.tokens
        assert t.finish_reason == want.finish_reason == "length"
    assert engine.completed == 6 and engine.active_slots == 0


def test_streamed_tokens_match_the_result(models):
    from ray_dynamic_batching_tpu_torch.engine.request import TokenStream

    _jm, _params, tm = models
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **ENGINE)
    req = Request(model="t", payload={"tokens": _prompts(6, 1)[0]},
                  slo_ms=1e7, stream=TokenStream())
    q.add_request(req)
    engine.run_until_idle(timeout_s=60)
    assert req.stream.drain(timeout_s=5) == req.future.result(5).tokens


def test_sampled_stream_independent_of_slot_and_neighbours(models):
    _jm, _params, tm = models
    sampled = {"tokens": _prompts(2, 1)[0], "temperature": 0.9,
               "top_k": 8, "seed": 1234, "max_new_tokens": 12}
    alone, _ = _serve_torch(tm, [sampled])
    # Behind three greedy neighbours it lands in slot 3, mid-batch.
    crowd, _ = _serve_torch(
        tm, [{"tokens": p} for p in _prompts(3, 3)] + [sampled])
    assert alone[0].tokens == crowd[-1].tokens
    other_seed, _ = _serve_torch(tm, [{**sampled, "seed": 99}])
    assert other_seed[0].tokens != alone[0].tokens


def test_sampled_tokens_stay_in_top_k_support(models):
    _jm, _params, tm = models
    prompt = _prompts(4, 1)[0]
    k = 3
    res, _ = _serve_torch(tm, [{"tokens": prompt, "temperature": 2.0,
                                "top_k": k, "seed": 5,
                                "max_new_tokens": 10}])
    seq = list(prompt)
    with torch.inference_mode():
        for tok in res[0].tokens:
            tokens = torch.tensor([seq], dtype=torch.int32)
            logits, _ = tm.prefill(tokens, torch.ones_like(tokens),
                                   tm.make_cache(1, 64))
            top = torch.topk(logits[0].float(), k).indices.tolist()
            assert tok in top
            seq.append(tok)
    assert len(set(res[0].tokens)) > 1   # temperature 2.0 actually samples


def test_gumbel_noise_is_a_pure_counter_function():
    seeds = torch.tensor([7, 7, 8], dtype=torch.int32)
    idx = torch.tensor([3, 3, 3], dtype=torch.int32)
    g = gumbel_noise(0, seeds, idx, 1000)
    assert torch.isfinite(g).all()
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert not torch.equal(g[0], gumbel_noise(1, seeds, idx, 1000)[0])
    # Gumbel(0, 1) has mean ~0.5772.
    assert abs(g.mean().item() - 0.5772) < 0.05


def test_prompt_past_largest_bucket_names_long_fill_path(models):
    _jm, _params, tm = models
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **ENGINE)
    req = Request(model="t", payload={"tokens": list(range(20))},
                  slo_ms=1e7)
    q.add_request(req)
    engine.run_until_idle(timeout_s=30)
    with pytest.raises(BadRequest, match="long-fill"):
        req.future.result(timeout=5)


def test_engine_default_device_is_cuda(models):
    _jm, _params, tm = models
    with pytest.raises((RuntimeError, ValueError)):
        # A CPU model under the default device: either CUDA is missing
        # (RuntimeError) or the devices disagree (ValueError).
        DecodeEngine(tm, RequestQueue("t"), **ENGINE)


def test_llm_deployment_replica_answers_requests():
    dep = LLMDeployment("llama_tiny", num_slots=2, max_len=64,
                        prompt_buckets=[16], default_max_new_tokens=5,
                        dtype=torch.float32, device="cpu", seed=3)
    replica = dep.make_replica("llama_tiny-0")
    replica.start()
    try:
        reqs = [Request(model="llama_tiny", payload={"tokens": p},
                        slo_ms=1e7) for p in _prompts(5, 3)]
        assert all(replica.assign(r) for r in reqs)
        results = [r.future.result(timeout=60) for r in reqs]
        assert replica.healthy()
    finally:
        replica.stop()
    assert [len(r.tokens) for r in results] == [5, 5, 5]
    assert all(0 <= t < 512 for r in results for t in r.tokens)
    assert replica.stats()["completed"] == 3.0
