"""The long fill of the monolithic arms vs the JAX engine's (CPU).

A prompt longer than the largest bucket (16) and shorter than ``max_len``
(64) is prefilled in chunks of 16 into a private row cache, one decode
step for the active batch between chunks, then committed into the shared
cache (slab) or cut into its pages (paged-mono). Both engines serve
llama_tiny with the same bridged weights and the same prompts; greedy
streams must be identical, on both arms, with the model's own cache and
with the int8 cache.
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
from ray_dynamic_batching_tpu_torch.engine.request import (
    BadRequest,
    Request,
)
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(2)

ENGINE = dict(num_slots=4, max_len=64, prompt_buckets=[16],
              default_max_new_tokens=10)
ARMS = {"slab_mono": {},
        "paged_mono": dict(paged=True, page_size=128, chunked_prefill=False)}
KV = {"model_dtype": (None, None), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module", params=sorted(KV))
def models(request):
    j_kv, t_kv = KV[request.param]
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32,
                       kv_dtype=j_kv)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None, kv_dtype=t_kv)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


def _payloads():
    """Two short prompts first (they decode while the long ones fill, so
    the fills interleave decode steps), then four of 17-63 tokens: 2 to 4
    chunks of 16, the last one partial or full."""
    rng = np.random.default_rng(5)
    lengths = [9, 14, 17, 32, 47, 63]
    return [{"tokens": rng.integers(0, 512, n).tolist(),
             "max_new_tokens": 6 + i} for i, n in enumerate(lengths)]


def _serve_jax(jm, params, payloads, cfg):
    jq = JQueue("j", max_len=256)
    je = JEngine(jm, params, jq, **cfg)
    reqs = [JRequest(model="j", payload=p, slo_ms=6e4) for p in payloads]
    for r in reqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5) for r in reqs]


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_long_prompts_stream_identical_to_jax_engine(models, arm):
    jm, params, tm = models
    cfg = {**ENGINE, **ARMS[arm]}
    payloads = _payloads()
    want = _serve_jax(jm, params, payloads, cfg)
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **cfg)
    interleaved = []
    step = engine._interleave_step

    def spy():
        interleaved.append(bool(engine._active_mask.any()))
        step()

    engine._interleave_step = spy
    reqs = [Request(model="t", payload=p, slo_ms=1e7) for p in payloads]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=300)
    got = [r.future.result(timeout=5) for r in reqs]
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    # The 63-token prompt fills the 64-position cache after two tokens.
    assert [len(r.tokens) for r in got] == [6, 7, 8, 9, 10, 2]
    assert got[-1].finish_reason == "capacity"
    # 17 -> 2 chunks, 32 -> 2, 47 -> 3, 63 -> 4.
    assert engine.long_chunk_dispatches == 11
    assert any(interleaved), "no decode step ran between long-fill chunks"
    if engine.paged:
        engine._allocator.check()
        assert engine._allocator.free_pages == engine.num_pages


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_prompt_of_max_len_names_kv_capacity(models, arm):
    """A prompt of max_len tokens has no room for a generated token: it is
    refused before any dispatch, and the engine serves on."""
    _jm, _params, tm = models
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **{**ENGINE, **ARMS[arm]})
    bad = Request(model="t", payload={"tokens": list(range(1, 65))},
                  slo_ms=1e7)
    ok = Request(model="t", payload={"tokens": list(range(1, 64))},
                 slo_ms=1e7)
    q.add_request(bad)
    q.add_request(ok)
    engine.run_until_idle(timeout_s=60)
    with pytest.raises(BadRequest, match="exceeds KV capacity 64"):
        bad.future.result(timeout=5)
    res = ok.future.result(timeout=5)
    # 63 prompt tokens: the first token is sampled from the fill, the
    # second from the decode step that writes position 63; then the cache
    # is full.
    assert res.finish_reason == "capacity" and len(res.tokens) == 2
    assert engine.long_chunk_dispatches == 4


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_long_fill_requeues_when_slots_run_out(arm):
    """Groups take the free slots first; a long prompt of the same batch
    that finds none goes back to the queue untouched (its pages released)
    and is served once a slot frees."""
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=4)
    q = RequestQueue("t")
    # Paged: a pool of 3 pages, so all three admissions get theirs.
    pool = {"kv_pool_pages": 3} if ARMS[arm] else {}
    engine = DecodeEngine(tm, q, device="cpu",
                          **{**ENGINE, **ARMS[arm], **pool, "num_slots": 2})
    reqs = [Request(model="t", payload={"tokens": p, "max_new_tokens": 3},
                    slo_ms=1e7)
            for p in (list(range(1, 41)), [1, 2, 3], [4, 5, 6])]
    for r in reqs:
        q.add_request(r)
    assert engine._admit_batch(q.get_batch(3), [0, 1]) == 2
    assert len(q) == 1 and engine.long_chunk_dispatches == 0
    if engine.paged:
        assert engine._allocator.allocated_pages == 2
    engine.run_until_idle(timeout_s=60)
    assert [len(r.future.result(timeout=5).tokens) for r in reqs] == [3] * 3
    assert engine.long_chunk_dispatches == 3
