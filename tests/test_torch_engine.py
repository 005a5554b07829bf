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
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
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
    """A prompt past the largest bucket (20 > 16) takes the long-fill path
    on the slab engine: two chunks of 16 into a row cache, then the
    commit; its greedy stream equals the JAX engine's."""
    jm, params, tm = models
    payload = [{"tokens": list(range(20))}]
    want = _serve_jax(jm, params, payload, **ENGINE)
    got, engine = _serve_torch(tm, payload)
    assert got[0].tokens == want[0].tokens
    assert got[0].finish_reason == want[0].finish_reason == "length"
    assert engine.long_chunk_dispatches == 2 and engine.prefill_groups == 0


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
    replica = dep.make_replica("llama_tiny-0",
                               DeploymentConfig(name="llama_tiny"))
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


# --- the paged pool with token-budget chunked prefill -----------------------
# The canonical paged engine (tools/check_compiles.py): llama_tiny f32, 4
# slots, max_len 96, buckets [8, 16], 128-token pages, chunked, horizon 4.
PAGED = dict(num_slots=4, max_len=96, prompt_buckets=[8, 16],
             eos_token_id=None, default_max_new_tokens=8, decode_horizon=4,
             paged=True, page_size=128, chunked_prefill=True)


def _canonical_mix(n=10):
    """check_compiles.py's seed-17 mix: mostly bucketed single-chunk
    trains, every third an over-bucket multi-chunk train (40-69 tokens)."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(n):
        plen = (int(rng.integers(3, 14)) if i % 3
                else int(rng.integers(40, 70)))
        out.append({"tokens": rng.integers(1, 500, plen).tolist(),
                    "max_new_tokens": 6})
    return out


def _serve_jax(jm, params, payloads, **kw):
    jq = JQueue("j", max_len=256)
    je = JEngine(jm, params, jq, **kw)
    reqs = [JRequest(model="j", payload=p, slo_ms=6e4) for p in payloads]
    for r in reqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=300)
    if je.paged:
        je._allocator.check()
    return [r.future.result(timeout=5) for r in reqs]


@pytest.mark.parametrize("pool", [None, 2], ids=["full_pool", "tight_pool"])
def test_paged_chunked_streams_identical_to_jax_engine(models, pool):
    """Greedy streams and finish reasons of the canonical mix, multi-chunk
    prompts included, equal the JAX paged engine's — with the full pool,
    and with a pool of 2 pages for 4 slots, where trains park until
    streams finish and free their pages. The allocator is whole after."""
    jm, params, tm = models
    payloads = _canonical_mix()
    cfg = {**PAGED, "kv_pool_pages": pool}
    want = _serve_jax(jm, params, payloads, **cfg)
    got, engine = _serve_torch(tm, payloads, **cfg)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert all(len(r.tokens) == 6 for r in got)
    engine._allocator.check()
    assert engine._allocator.free_pages == engine.num_pages
    assert engine.chunk_dispatches > 0 and engine.prefill_groups == 0
    if pool is not None:
        # At most two streams ever held pages at once.
        assert max(e["pages_in_use"] for e in
                   engine._page_journal.snapshot()) == 2


def test_paged_mono_arm_equals_slab_arm(models):
    """paged=True, chunked_prefill=False gives the slab engine's streams
    (the reference's test_paged_matches_slab_f32), and returns every
    page."""
    _jm, _params, tm = models
    payloads = [{"tokens": p, "max_new_tokens": 10 + i}
                for i, p in enumerate(_prompts(8, 6))]
    slab, _ = _serve_torch(tm, payloads)
    paged, engine = _serve_torch(tm, payloads, paged=True, page_size=128,
                                 chunked_prefill=False)
    assert [r.tokens for r in paged] == [r.tokens for r in slab]
    assert engine.prefill_groups > 0 and engine.chunk_dispatches == 0
    engine._allocator.check()
    assert engine._allocator.free_pages == engine.num_pages


def test_stop_token_frees_pages_mid_cycle(models):
    """A stream that stops on a stop token returns its pages at the
    harvest that sees it, while its neighbour keeps decoding."""
    _jm, _params, tm = models
    prompts = _prompts(9, 2)
    first, _ = _serve_torch(tm, [{"tokens": prompts[0],
                                  "max_new_tokens": 8}], **PAGED)
    stop_at = first[0].tokens[2]
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **PAGED)
    reqs = [Request(model="t", payload=p, slo_ms=1e7) for p in (
        {"tokens": prompts[0], "max_new_tokens": 8,
         "stop_token_ids": [stop_at]},
        {"tokens": prompts[1], "max_new_tokens": 30})]
    for r in reqs:
        q.add_request(r)
    engine._admit()
    engine._drain_prefill()
    assert engine._allocator.allocated_pages == 2
    while not reqs[0].future.done():
        engine._step(horizon=1)
    assert engine.active_slots == 1
    assert engine._allocator.allocated_pages == 1       # freed mid-cycle
    engine._allocator.check()
    res = reqs[0].future.result(timeout=5)
    assert res.finish_reason == "eos" and res.tokens[-1] == stop_at
    engine.run_until_idle(timeout_s=60)
    assert reqs[1].future.result(timeout=5).finish_reason == "length"
    assert engine._allocator.free_pages == engine.num_pages


def test_paged_generation_stops_at_max_len_like_slab(models):
    """Paged capacity rounds up to whole pages (128 here) but both arms
    stop at max_len: a request asking past it finishes "capacity" at the
    same token on both."""
    _jm, _params, tm = models
    payload = [{"tokens": _prompts(12, 1)[0], "max_new_tokens": 200}]
    slab, _ = _serve_torch(tm, payload)
    paged, engine = _serve_torch(tm, payload, paged=True, page_size=128,
                                 chunked_prefill=False)
    assert paged[0].finish_reason == slab[0].finish_reason == "capacity"
    assert paged[0].tokens == slab[0].tokens
    assert engine._paged_capacity == 128 and engine.max_len == 64


def test_chunked_prefill_on_a_slab_engine_names_long_fill(models):
    """``chunked_prefill=True`` on a slab engine serves the slab-train arm:
    a prompt past the largest bucket (20 > 16) runs as a two-chunk train
    instead of the long fill, with the JAX engine's stream; the bad page
    configurations still raise."""
    jm, params, tm = models
    payload = [{"tokens": list(range(20))}]
    want = _serve_jax(jm, params, payload, chunked_prefill=True, **ENGINE)
    got, engine = _serve_torch(tm, payload, chunked_prefill=True)
    assert got[0].tokens == want[0].tokens
    assert engine.chunked_prefill and not engine.paged
    assert engine.chunk_dispatches == 2 and engine.long_chunk_dispatches == 0
    with pytest.raises(ValueError, match="multiple of 128"):
        DecodeEngine(tm, RequestQueue("t"), device="cpu", paged=True,
                     page_size=64, **ENGINE)
    with pytest.raises(ValueError, match="cannot back even one slot"):
        DecodeEngine(tm, RequestQueue("t"), device="cpu", paged=True,
                     kv_pool_pages=3, **{**ENGINE, "max_len": 512})


def test_paged_warmup_leaves_the_pool_whole(models):
    _jm, _params, tm = models
    engine = DecodeEngine(tm, RequestQueue("t"), device="cpu", **PAGED)
    engine.warmup()
    engine._allocator.check()
    assert engine._allocator.free_pages == engine.num_pages
    assert engine._cache.lengths.eq(0).all()
    assert engine._cache.page_table.eq(engine.num_pages).all()


def test_llm_deployment_paged_answers_a_long_prompt():
    dep = LLMDeployment("llama_tiny", num_slots=2, max_len=128,
                        prompt_buckets=[16], default_max_new_tokens=5,
                        dtype=torch.float32, device="cpu", seed=3,
                        paged=True, page_size=128)
    replica = dep.make_replica("llama_tiny-0",
                               DeploymentConfig(name="llama_tiny"))
    assert replica.engine.paged and replica.engine.chunked_prefill
    replica.start()
    try:
        prompts = _prompts(5, 2) + [list(range(1, 60))]   # 59 > bucket 16
        reqs = [Request(model="llama_tiny", payload={"tokens": p},
                        slo_ms=1e7) for p in prompts]
        assert all(replica.assign(r) for r in reqs)
        results = [r.future.result(timeout=60) for r in reqs]
    finally:
        replica.stop()
    assert [len(r.tokens) for r in results] == [5, 5, 5]
    assert all(r.finish_reason == "length" for r in results)
    assert replica.engine.chunk_dispatches >= 4 + 1    # 4 chunks for 59
