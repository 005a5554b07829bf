"""Speculative decoding on the slab cache: the port against the JAX
package's engine (CPU, f32, ``llama_tiny``, weights bridged by
``params_from_flax``).

Twins of the JAX package's speculation tests — ``tests/test_decode.py``
(bias exactness, penalty bypass, divergent and self drafts, the sampled
fallback, the draft kept in step through plain intervals, a long prompt
with a stop token), ``tests/test_kv_int8.py`` (an int8-KV target), the
deployment through the controller (``tests/test_llm_serving.py``) and a
spec arm of the randomized feature mix (``tests/test_decode_fuzz.py``):
the same prompts through both engines, greedy tokens identical to the
JAX engine's and to the port's own plain engine, with the reference
test's own assertions on both. Also: the verify window that reaches past
capacity leaves the k/v at S - 1 as the JAX ``verify_step`` writes them
(the slab's per-row window write drops through its sink row), and the
speculation metric families and ``snapshot()["spec"]`` carry the
reference's names, tags and keys.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.engine import decode as j_decode
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu_torch.engine import decode as t_decode
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(2)

SPEC = dict(num_slots=4, max_len=64, prompt_buckets=[8, 16],
            default_max_new_tokens=8)


def _bridge(params, kv_dtype=None):
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None, kv_dtype=kv_dtype)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return tm


@pytest.fixture(scope="module")
def lm():
    """(JAX model, params, port model): the target, PRNGKey(0)."""
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, _bridge(params)


@pytest.fixture(scope="module")
def draft_lm(lm):
    """A DIFFERENT tiny model as the draft (PRNGKey(42), as the JAX
    test's): partial acceptance."""
    jm = lm[0]
    params = jm.init(jax.random.PRNGKey(42))
    return jm, params, _bridge(params)


def _jax_engine(lm, draft=None, **kw):
    jm, params, _ = lm
    q = JQueue(jm.name, max_len=256)
    extra = {}
    if draft is not None:
        extra = dict(draft_model=draft[0], draft_params=draft[1],
                     spec_tokens=3)
    return j_decode.DecodeEngine(jm, params, q, **{**SPEC, **extra, **kw}), q


def _port_engine(lm, draft=None, **kw):
    q = RequestQueue("llama_tiny", max_len=256)
    extra = {}
    if draft is not None:
        extra = dict(draft_model=draft[2], spec_tokens=3)
    return t_decode.DecodeEngine(lm[2], q, device="cpu",
                                 **{**SPEC, **extra, **kw}), q


def _submit(queue, prompt, jax_side: bool, **payload):
    cls = JRequest if jax_side else Request
    req = cls(model="llama_tiny",
              payload={"tokens": np.asarray(prompt, np.int32), **payload},
              slo_ms=60_000.0)
    queue.add_request(req)
    return req


def _serve(pair, payloads, timeout_s=180.0):
    """Serve ``payloads`` through an (engine, queue) pair; results."""
    engine, q = pair
    jax_side = isinstance(engine, j_decode.DecodeEngine)
    reqs = [_submit(q, p["tokens"], jax_side,
                    **{k: v for k, v in p.items() if k != "tokens"})
            for p in payloads]
    engine.run_until_idle(timeout_s=timeout_s)
    return [r.future.result(timeout=5) for r in reqs]


def _tokens(results):
    return [r.tokens for r in results]


# --- twins of tests/test_decode.py --------------------------------------------
def test_bias_spec_exactness(lm):
    """Biased greedy under speculative decoding equals biased greedy under
    plain decoding (verify applies the same bias), on both packages."""
    plain = _port_engine(lm)
    ban = _serve(plain, [{"tokens": [5, 9, 2, 7],
                          "max_new_tokens": 8}])[0].tokens[2]
    load = [{"tokens": [5, 9, 2, 7], "max_new_tokens": 8,
             "banned_tokens": [ban]}]
    got = _tokens(_serve(_port_engine(lm, draft=lm), load))
    assert got == _tokens(_serve(plain, load))
    assert got == _tokens(_serve(_jax_engine(lm, draft=lm), load))
    assert ban not in got[0]


def test_penalty_rows_bypass_speculation(lm):
    engine, q = _port_engine(lm, draft=lm, num_slots=2)
    req = _submit(q, [1, 2, 3], False, max_new_tokens=8,
                  frequency_penalty=2.0)
    engine._admit()
    assert not engine._use_spec()
    engine.run_until_idle(timeout_s=120)
    assert engine.completed == 1
    assert engine.spec_rounds == 0 and engine.steps > 0
    # A negative penalty counts too (magnitude, not the signed max).
    engine2, q2 = _port_engine(lm, draft=lm, num_slots=2)
    _submit(q2, [1, 2, 3], False, max_new_tokens=4, presence_penalty=-1.0)
    engine2._admit()
    assert not engine2._use_spec()
    engine2.run_until_idle(timeout_s=120)
    assert len(req.future.result(5).tokens) == 8


PROMPTS = [[5, 9, 2, 7], [3, 1, 4], [11, 13], [2, 4, 6, 8, 10]]


def test_exact_greedy_with_divergent_draft(lm, draft_lm):
    """A draft with other weights: partial acceptance, yet the verified
    output is exactly plain greedy — the port's plain engine's and the JAX
    spec engine's, finish reasons included (a row short only because the
    draft was rejected does not finish "capacity")."""
    load = [{"tokens": p, "max_new_tokens": 12} for p in PROMPTS]
    spec_engine = _port_engine(lm, draft=draft_lm)
    got = _serve(spec_engine, load)
    want = _serve(_jax_engine(lm, draft=draft_lm), load)
    assert _tokens(got) == _tokens(_serve(_port_engine(lm), load))
    assert _tokens(got) == _tokens(want)
    assert [r.finish_reason for r in got] == ["length"] * 4
    assert spec_engine[0].spec_rounds > 0


def test_self_draft_accepts_everything(lm):
    """draft == target: every proposal verifies, so each round lands
    spec_tokens + 1 tokens: 12 tokens = 1 from prefill + 3 rounds of 4."""
    load = [{"tokens": [5, 9, 2, 7], "max_new_tokens": 12}]
    spec = _port_engine(lm, draft=lm, num_slots=2, prompt_buckets=[8])
    jspec = _jax_engine(lm, draft=lm, num_slots=2, prompt_buckets=[8])
    got = _tokens(_serve(spec, load))
    assert got == _tokens(_serve(jspec, load))
    assert len(got[0]) == 12
    assert spec[0].steps == jspec[0].steps == 3
    assert spec[0].spec_acceptance() == 1.0


def test_sampled_rows_fall_back_to_plain_decode(lm, draft_lm):
    """temperature > 0 in the batch bypasses speculation (exactness holds
    for greedy only); the plain steps catch the draft up."""
    engine, q = _port_engine(lm, draft=draft_lm)
    req = _submit(q, [1, 2, 3], False, max_new_tokens=6, temperature=0.8,
                  seed=7)
    engine._admit()
    assert not engine._use_spec()
    engine.run_until_idle(timeout_s=120)
    assert len(req.future.result(timeout=5).tokens) == 6
    # One catch-up a plain dispatch (a dispatch runs several steps).
    assert engine.spec_rounds == 0
    assert 0 < engine.draft_catchups <= engine.steps


def test_draft_stays_synced_through_plain_intervals(lm):
    """Plain steps (the long fill's interleave) catch the DRAFT cache up:
    with draft == target, speculation afterwards still accepts every
    proposal (a desynced draft would accept about none)."""
    tags = {"model": "llama_tiny", "paged": "false"}
    outs = {}
    for side in ("port", "jax"):
        mk = _port_engine if side == "port" else _jax_engine
        mod = t_decode if side == "port" else j_decode
        engine, q = mk(lm, draft=lm, num_slots=2, max_len=96,
                       prompt_buckets=[8])
        r1 = _submit(q, [5, 9, 2, 7], side == "jax", max_new_tokens=30)
        engine._admit()
        engine._step()
        r2 = _submit(q, [(i * 7) % 50 + 1 for i in range(20)],
                     side == "jax", max_new_tokens=30)
        rounds0 = mod.SPEC_ROUNDS.get(tags=tags)
        acc0 = mod.SPEC_ACCEPTED.get(tags=tags)
        engine.run_until_idle(timeout_s=180)
        rounds = mod.SPEC_ROUNDS.get(tags=tags) - rounds0
        acc = mod.SPEC_ACCEPTED.get(tags=tags) - acc0
        outs[side] = [r1.future.result(5).tokens, r2.future.result(5).tokens]
        assert [len(t) for t in outs[side]] == [30, 30]
        assert rounds > 0
        assert acc >= rounds * 3, (side, acc, rounds)
        if side == "port":
            assert engine.draft_catchups > 0
            assert engine.draft_chunk_dispatches == 3    # 20 tokens, C = 8
    assert outs["port"] == outs["jax"]


def test_spec_with_long_prompt_and_eos(lm, draft_lm):
    """The long fill fills the DRAFT cache too; a stop token cuts a round's
    accepted run mid-window exactly like plain decode."""
    long_prompt = [(i * 7) % 50 + 1 for i in range(20)]
    toks = _serve(_port_engine(lm), [{"tokens": long_prompt,
                                      "max_new_tokens": 8}])[0].tokens
    load = [{"tokens": long_prompt, "max_new_tokens": 8,
             "stop_token_ids": [toks[4]]}]
    got = _serve(_port_engine(lm, draft=draft_lm), load)
    assert _tokens(got) == _tokens(_serve(_port_engine(lm), load))
    assert _tokens(got) == _tokens(_serve(_jax_engine(lm, draft=draft_lm),
                                          load))
    assert got[0].finish_reason == "eos"


# --- the verify window past capacity ------------------------------------------
def test_verify_window_past_capacity_keeps_the_last_position(lm):
    """Row 0 at ``lengths = S - 2``: its window writes S - 2 and S - 1 for
    real and drops three positions past capacity (through the sink row,
    never as duplicate writes onto S - 1); row 1 is inactive (every write
    dropped). The cache afterwards and the logits of the positions that
    landed equal the JAX ``verify_step``'s; the k/v at S - 1 is the second
    window token's, and nothing below S - 2 moved."""
    jm, params, tm = lm
    S, T = 16, 5
    rng = np.random.default_rng(3)
    lengths = np.asarray([S - 2, 4], np.int32)
    active = np.asarray([True, False])
    tokens = rng.integers(1, 500, (2, T)).astype(np.int32)
    jc = jm.make_cache(2, S)
    k0 = rng.standard_normal(jc.k.shape).astype(np.float32)
    v0 = rng.standard_normal(jc.v.shape).astype(np.float32)
    jc = jc.replace(k=jnp.asarray(k0), v=jnp.asarray(v0),
                    lengths=jnp.asarray(lengths))
    j_logits, jc = jm.verify_step(params, jnp.asarray(tokens), jc,
                                  jnp.asarray(active))
    tc = tm.make_cache(2, S)
    with torch.inference_mode():
        tc.k.copy_(torch.from_numpy(k0))
        tc.v.copy_(torch.from_numpy(v0))
        tc.lengths.copy_(torch.from_numpy(lengths))
        t_logits, tc = tm.verify_step(torch.from_numpy(tokens), tc,
                                      torch.from_numpy(active))
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(tc.k[:, :, : S - 2].numpy(),
                                  k0[:, :, : S - 2])
    np.testing.assert_array_equal(tc.k[:, 1].numpy(), k0[:, 1])
    assert not np.allclose(tc.k[:, 0, S - 1].numpy(), k0[:, 0, S - 1])
    assert tc.lengths.tolist() == lengths.tolist()   # not advanced
    np.testing.assert_allclose(t_logits[0, :2].numpy(),
                               np.asarray(j_logits)[0, :2], atol=1e-4)


def test_window_write_index_drops_to_the_sink_row():
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        KVCache,
        sink_rows,
        window_write_index,
    )

    idx = window_write_index(torch.tensor([[6, 7, 8, 9], [8, 8, 8, 8]]), 8)
    assert idx.tolist() == [[6, 7, 16, 16], [16, 16, 16, 16]]
    cache = KVCache.zeros(t_lm.TINY_LM, 2, 8, dtype=torch.float32)
    rows = sink_rows(cache.k[1])
    assert rows.shape[0] == 17 and rows.data_ptr() == cache.k[1].data_ptr()
    rows[idx] = torch.ones((2, 4) + tuple(rows.shape[1:]))
    assert cache.k[1, 0, 6:].eq(1).all()
    assert cache.k.sum() == 2 * rows[0].numel()
    with pytest.raises(ValueError, match="sink row"):
        sink_rows(torch.zeros((2, 8, 2, 16)))


# --- twin of tests/test_kv_int8.py --------------------------------------------
def test_speculative_decode_with_quantized_target_cache(lm):
    """The draft proposes from its f32 cache, the int8-KV target verifies
    through the quantized window write: tokens equal the JAX engine's and
    the port's plain int8 engine's."""
    jm8 = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32,
                        kv_dtype=jnp.int8)
    params = lm[1]
    target = (jm8, params, _bridge(params, torch.int8))
    kw = dict(num_slots=2, max_len=32, prompt_buckets=[8],
              default_max_new_tokens=6)
    load = [{"tokens": [1, 2, 3], "max_new_tokens": 6},
            {"tokens": [4, 5], "max_new_tokens": 6}]
    got = _tokens(_serve(_port_engine(target, draft=lm, **kw), load))
    assert got == _tokens(_serve(_jax_engine(target, draft=lm, **kw), load))
    assert got == _tokens(_serve(_port_engine(target, **kw), load))
    assert all(len(t) == 6 for t in got)


# --- twin of tests/test_llm_serving.py ----------------------------------------
def test_speculative_deployment_matches_plain(lm):
    """``LLMDeployment(draft_model_name=...)`` through the controller and
    a handle serves greedy-identical output: the plain deployment's and
    the JAX engine's on the same (bridged) target weights."""
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    payload = {"tokens": [5, 9, 2, 7], "max_new_tokens": 10}
    knobs = dict(num_slots=4, max_len=64, prompt_buckets=[8, 16],
                 default_max_new_tokens=8, dtype=torch.float32,
                 device="cpu", model=lm[2])
    controller = ServeController(control_interval_s=0.1)
    spec = LLMDeployment("llama_tiny", draft_model_name="llama_tiny",
                         spec_tokens=3, **knobs)
    plain = LLMDeployment("llama_tiny", **knobs)
    handles = [DeploymentHandle(controller.deploy(
        DeploymentConfig(name=name), factory=dep))
        for name, dep in (("llama_spec", spec), ("llama_plain", plain))]
    controller.start()
    try:
        a, b = (h.remote(dict(payload)).result(timeout=120) for h in handles)
    finally:
        controller.shutdown()
    assert a.tokens == b.tokens
    assert a.tokens == _tokens(_serve(_jax_engine(lm), [payload]))[0]
    assert spec._draft_model is not lm[2]
    assert spec._draft_model.device.type == "cpu"


def test_deployment_sizes_slots_with_the_draft(lm, monkeypatch):
    """``auto_num_slots`` takes the draft's weights and a draft KV row of
    ``max_len + spec_tokens + 1`` per slot off the budget, as the
    reference does; a self-draft adds only the row."""
    from ray_dynamic_batching_tpu.serve.llm import LLMDeployment as JDep
    from ray_dynamic_batching_tpu.utils import config as j_config
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils import config as t_config

    monkeypatch.setenv("RDB_HBM_BUDGET_BYTES", str(3 * 2 ** 20))
    for mod in (j_config, t_config):
        mod.reset_config()
    try:
        knobs = dict(max_len=64, num_slots=0)
        port = LLMDeployment("llama_tiny", dtype=torch.float32,
                             device="cpu", draft_model_name="llama_tiny",
                             **knobs)
        ref = JDep("llama_tiny", dtype=jnp.float32,
                   draft_model_name="llama_tiny", **knobs)
        plain = LLMDeployment("llama_tiny", dtype=torch.float32,
                              device="cpu", **knobs)
        n = port.auto_num_slots()
        assert n == ref.auto_num_slots()
        assert n < plain.auto_num_slots()
        selfd = LLMDeployment("llama_tiny", dtype=torch.float32,
                              device="cpu", model=lm[2], draft_model=lm[2],
                              **knobs)
        assert n <= selfd.auto_num_slots() <= plain.auto_num_slots()
    finally:
        monkeypatch.delenv("RDB_HBM_BUDGET_BYTES")
        for mod in (j_config, t_config):
            mod.reset_config()


def test_engine_refuses_a_draft_it_cannot_serve(lm):
    other = t_lm.CausalLM(t_lm.GPT2_DRAFT, name="gpt2_draft",
                          dtype=torch.float32, device="cpu", seed=0)
    with pytest.raises(ValueError, match="vocab"):
        _port_engine(lm, draft=(None, None, other))
    meta = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny",
                         dtype=torch.float32, device="meta", seed=None)
    with pytest.raises(ValueError, match="draft model lives on"):
        _port_engine(lm, draft=(None, None, meta))


# --- observability ------------------------------------------------------------
SPEC_FAMILIES = ("SPEC_ROUNDS", "SPEC_ACCEPTED", "SPEC_DRAFTED",
                 "SPEC_REJECTED", "SPEC_ACCEPTANCE")


@pytest.mark.parametrize("family", SPEC_FAMILIES)
def test_spec_metric_family_matches_the_reference(family):
    t, j = getattr(t_decode, family), getattr(j_decode, family)
    assert (t.name, t.tag_keys, type(t).__name__) == (
        j.name, j.tag_keys, type(j).__name__)


def test_snapshot_spec_block_and_turn_spans_match_the_reference(lm):
    """``snapshot()["spec"]`` has the reference's keys and values after
    the same run, and every ``decode.turn`` span of a spec round says
    ``spec=True`` (the plain steps' say False)."""
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    load = [{"tokens": [5, 9, 2, 7], "max_new_tokens": 12},
            {"tokens": [1, 2, 3], "max_new_tokens": 6, "temperature": 0.7}]
    port = _port_engine(lm, draft=lm)
    collector = ChromeTraceCollector()
    tracer().set_exporter(collector.export)
    try:
        _serve(port, load[:1])
        _serve(port, load[1:])
    finally:
        tracer().reset()
    jax_side = _jax_engine(lm, draft=lm)
    _serve(jax_side, load[:1])
    _serve(jax_side, load[1:])
    t_snap, j_snap = port[0].snapshot()["spec"], jax_side[0].snapshot()["spec"]
    assert t_snap == j_snap == {"spec_tokens": 3, "acceptance": 1.0,
                                "rounds_windowed": 3}
    turns = [sp.attributes for sp in collector.spans
             if sp.name == "decode.turn"]
    assert sum(a["spec"] for a in turns) == port[0].spec_rounds == 3
    assert sum(not a["spec"] for a in turns) == port[0].draft_catchups > 0
    assert "spec" not in _port_engine(lm)[0].snapshot()


# --- a spec arm of the randomized feature mix (tests/test_decode_fuzz.py) -----
@pytest.mark.parametrize("int8_kv", [False, True])
def test_fuzz_spec_engine_greedy_rows_equal_the_reference(lm, int8_kv):
    """A seeded mix of greedy, sampled, top-p, biased, penalised, stopped,
    long and session requests through one speculative engine (self-draft,
    ``spec_tokens=2``, prefix and session caches), served between
    arrivals: every request resolves within its bound, bans hold, the
    engine drains and serves again, and the pure-greedy requests replayed
    one by one on the JAX package's plain engine give the same tokens."""
    jm, params, tm = lm
    if int8_kv:
        jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny",
                           dtype=jnp.float32, kv_dtype=jnp.int8)
        tm = _bridge(params, torch.int8)
    rng = np.random.default_rng(1234 + int8_kv)
    q = RequestQueue("llama_tiny", max_len=512)
    engine = t_decode.DecodeEngine(
        tm, q, device="cpu", num_slots=4, max_len=96, prompt_buckets=[8, 16],
        default_max_new_tokens=6, decode_horizon=4, spec_tokens=2,
        draft_model=tm, prefix_cache_size=4, session_cache_size=4)
    submitted = []
    for i in range(16):
        kind = int(rng.integers(0, 7))
        plen = (int(rng.integers(20, 60)) if kind == 4
                else int(rng.integers(2, 14)))
        payload = {"tokens": rng.integers(1, 500, plen).tolist(),
                   "max_new_tokens": int(rng.integers(2, 10))}
        if kind == 1:
            payload.update(temperature=float(rng.uniform(0.3, 1.2)),
                           top_p=float(rng.uniform(0.5, 1.0)),
                           seed=int(rng.integers(0, 1 << 30)))
        elif kind == 2:
            payload.update(banned_tokens=rng.integers(1, 50, 3).tolist())
        elif kind == 3:
            payload.update(frequency_penalty=float(rng.uniform(0.5, 5.0)))
        elif kind == 5:
            payload.update(session_id=f"fuzz-{int(rng.integers(0, 3))}")
        elif kind == 6:
            payload.update(stop_token_ids=rng.integers(1, 50, 2).tolist())
        req = _submit(q, payload["tokens"], False,
                      **{k: v for k, v in payload.items() if k != "tokens"})
        submitted.append((payload, req))
        if rng.random() < 0.4:
            engine._admit()
            if engine._active_mask.any():
                engine._step()
    engine.run_until_idle(timeout_s=300)
    assert engine.active_slots == 0 and engine.spec_rounds > 0
    pure = []
    for payload, req in submitted:
        res = req.future.result(timeout=5)
        assert 1 <= len(res.tokens) <= payload["max_new_tokens"]
        if len(res.tokens) < payload["max_new_tokens"]:
            assert res.finish_reason in ("eos", "capacity")
        for t in payload.get("banned_tokens", ()):
            assert t not in res.tokens
        if payload.keys() <= {"tokens", "max_new_tokens"}:
            pure.append((payload, res.tokens))
    assert pure
    jq = JQueue("llama_tiny", max_len=512)
    ref = j_decode.DecodeEngine(jm, params, jq, num_slots=2, max_len=96,
                                prompt_buckets=[8, 16],
                                default_max_new_tokens=6)
    for payload, want in pure:
        assert _serve((ref, jq), [payload])[0].tokens == want
    again = _serve((engine, q), [{"tokens": [1, 2, 3], "max_new_tokens": 4}])
    assert len(again[0].tokens) == 4
