"""KV reuse and the page fabric on a tensor-parallel engine (CPU, f32).

A TP engine on a gloo world of 2 CPU ranks (spawned once for the module)
serves llama_tiny with the JAX package's weights, with the caches on:

- the mirror of the JAX package's ``test_tp2_session_continuation_parity``:
  turn 2 continued from its session equals the sessionless full-prompt
  decode on the same engine, and both equal the JAX single-device
  engine's tokens — on the slab (the row extract and seed run per rank on
  its kv-head shard) and on both paged arms, where the history is past
  one page so turn 2 borrows it;
- a prefix hit (chunk-granular on the slab, page-granular on the pool)
  and a spill and reload through the host tier, each rank moving its own
  shard: tokens equal the JAX engine's, and the pool is whole once the
  caches clear;
- parcels between a TP 2 paged engine and a one-card paged engine in
  both directions: a stream migrated mid-decode finishes with the tokens
  of the unmigrated run, a prefix pushed across hits on arrival, and the
  TP engine's exported pages are the one-card engine's, bit for bit (the
  JAX package's layout, every kv head).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu_torch.engine import pagefabric as t_fabric
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh

torch.set_num_threads(2)

NAME = "llama_tiny"
ARMS = {
    "slab": {},
    "paged_chunked": dict(paged=True, page_size=128),
    "paged_mono": dict(paged=True, page_size=128, chunked_prefill=False),
}
SESSION = dict(num_slots=2, max_len=256, prompt_buckets=[32],
               default_max_new_tokens=5, decode_horizon=4,
               session_cache_size=2)
REUSE = dict(num_slots=2, max_len=384, prompt_buckets=[128],
             default_max_new_tokens=4, decode_horizon=4,
             prefix_cache_size=4)
FABRIC = dict(num_slots=4, max_len=384, prompt_buckets=[128],
              eos_token_id=None, default_max_new_tokens=8,
              decode_horizon=4, paged=True, page_size=128,
              prefix_cache_size=8)


@pytest.fixture(scope="module")
def models():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name=NAME, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name=NAME, dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def mesh():
    built = t_mesh.build_mesh(t_mesh.MeshConfig(tp=2), ["cpu"] * 2)
    try:
        yield built
    finally:
        built.shutdown()


@pytest.fixture(scope="module")
def shard(models, mesh):
    return t_mesh.shard_params(mesh, models[2])


def _ask(engine, q, tokens, sid=None, max_new=None):
    payload = {"tokens": list(tokens)}
    if max_new is not None:
        payload["max_new_tokens"] = max_new
    if sid is not None:
        payload["session_id"] = sid
    cls = JRequest if isinstance(q, JQueue) else Request
    req = cls(model=NAME, payload=payload, slo_ms=600_000.0)
    q.add_request(req)
    engine.run_until_idle(timeout_s=180)
    return list(req.future.result(timeout=10).tokens)


def _jax_tokens(models, prompts, **kw):
    """The JAX single-device engine's greedy tokens for each prompt (a
    token list, or a payload with its ``max_new_tokens``), one at a
    time."""
    jm, params, _tm = models
    q = JQueue(NAME, max_len=512)
    engine = JEngine(jm, params, q, **kw)
    return [_ask(engine, q, p["tokens"], max_new=p["max_new_tokens"])
            if isinstance(p, dict) else _ask(engine, q, p)
            for p in prompts]


def _tp_engine(shard, mesh, **kw):
    q = RequestQueue(NAME, max_len=512)
    return DecodeEngine(shard, q, device="cpu", mesh=mesh, **kw), q


def _whole_after_clear(engine):
    if engine.paged:
        for cache in (engine.paged_prefix, engine.paged_sessions):
            if cache is not None:
                cache.clear()
        engine._allocator.check()
        assert engine._allocator.free_pages == engine.num_pages


@pytest.mark.timeout(180)
@pytest.mark.parametrize("arm", list(ARMS))
def test_tp2_session_continuation_parity(models, shard, mesh, arm):
    """Turn 2 continued from the session equals the sessionless
    full-prompt decode on the same engine (and the JAX engine's)."""
    rng = np.random.default_rng(3)
    turn1 = rng.integers(1, 500, 140).tolist()
    engine, q = _tp_engine(shard, mesh, **SESSION, **ARMS[arm])
    try:
        gen1 = _ask(engine, q, turn1, sid="tp-chat")
        turn2 = turn1 + gen1 + [17, 23]
        stored = (engine.paged_sessions if engine.paged
                  else engine.session_cache)
        assert len(stored) == 1
        journal = len(engine._page_journal.snapshot()) if engine.paged \
            else 0
        continued = _ask(engine, q, turn2, sid="tp-chat")
        if engine.paged:
            # The stored turn's full page was borrowed (copy-on-write).
            cow = [e for e in engine._page_journal.snapshot()[journal:]
                   if e["kind"] == "cow_copy"]
            assert cow and cow[0]["pages"] == 1
        fresh = _ask(engine, q, turn2)
        assert continued == fresh
        assert [gen1, fresh] == _jax_tokens(
            models, [turn1, turn2],
            **{k: v for k, v in SESSION.items()
               if k != "session_cache_size"})
        _whole_after_clear(engine)
    finally:
        engine.release_buffers()
    assert not mesh.world.failed


@pytest.mark.timeout(180)
@pytest.mark.parametrize("arm", list(ARMS))
def test_tp2_prefix_hit_and_spill_reload(models, shard, mesh, arm):
    """A shared prefix hits; on the pool a spilled entry reloads from
    host memory (every rank its own shard) and hits again."""
    rng = np.random.default_rng(4)
    head = rng.integers(1, 500, 256).tolist()
    prompts = [head + rng.integers(1, 500, 9).tolist() for _ in range(3)]
    kw = dict(REUSE, **ARMS[arm])
    if "paged" in kw:
        kw["host_spill_pages"] = 8
    engine, q = _tp_engine(shard, mesh, **kw)
    try:
        got = [_ask(engine, q, prompts[0]), _ask(engine, q, prompts[1])]
        if engine.paged:
            assert len(engine.paged_prefix) >= 1
            key, pages = engine.paged_prefix.peek_lru()
            assert engine.host_spill.spill(
                key, list(pages), engine._allocator.allocated_pages)
            while engine.paged_prefix.evict_lru():
                pass
            assert len(engine.host_spill) == 1
        else:
            assert len(engine.prefix_cache) == 1
        got.append(_ask(engine, q, prompts[2]))
        if engine.paged:
            assert engine.host_spill.reloads == 1
            assert len(engine.paged_prefix) >= 1
        want = _jax_tokens(models, prompts,
                           **{k: v for k, v in kw.items()
                              if k not in ("prefix_cache_size",
                                           "host_spill_pages")})
        assert got == want
        _whole_after_clear(engine)
    finally:
        engine.release_buffers()
    assert not mesh.world.failed


def _payloads(n=3, seed=11):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(1, 500, int(rng.integers(4, 14)))
             .tolist(), "max_new_tokens": int(rng.integers(10, 20))}
            for _ in range(n)]


def _drive_until_live(engine, want, iters=60):
    for _ in range(iters):
        engine._admit()
        engine._pump_prefill()
        if engine._active_mask.any():
            engine._step()
        if len(engine.live_stream_ids()) >= want:
            return
    raise AssertionError(f"never reached {want} live streams")


def _one_card(models):
    q = RequestQueue(NAME, max_len=512)
    return DecodeEngine(models[2], q, device="cpu", **FABRIC), q


@pytest.mark.timeout(180)
@pytest.mark.parametrize("direction", ["tp_to_one", "one_to_tp"])
def test_parcel_round_trip_between_tp2_and_one_card(models, shard, mesh,
                                                     direction):
    payloads = _payloads()
    one, q1 = _one_card(models)
    tp, q2 = _tp_engine(shard, mesh, **FABRIC)
    src, qs, dst = (tp, q2, one) if direction == "tp_to_one" \
        else (one, q1, tp)
    try:
        straight = _jax_tokens(models, payloads,
                               **{k: v for k, v in FABRIC.items()
                                  if k != "prefix_cache_size"})
        reqs = [Request(model=NAME, payload=dict(p), slo_ms=600_000.0)
                for p in payloads]
        for r in reqs:
            qs.add_request(r)
        _drive_until_live(src, want=len(reqs))
        live = src.live_stream_ids()
        # A TP engine's export is the one-card layout: every kv head.
        idx = next(i for i, s in enumerate(src._slots) if not s.free)
        parcel = t_fabric.export_stream_parcel(src, idx)
        K, H = models[2].cfg.num_kv_heads, models[2].cfg.head_dim
        assert parcel.payload["k"].shape[3:] == (K, H)
        for rid in live:
            assert src.request_migration(rid, dst.accept_parcel)
        src._service_fabric()
        dst.run_until_idle(timeout_s=180)
        src.run_until_idle(timeout_s=180)
        got = [list(r.future.result(timeout=10).tokens) for r in reqs]
        assert got == straight
        assert src.migrated_out == dst.migrated_in == len(reqs)

        # A prefix pushed the other way hits on arrival.
        prompt = list(range(1, 257))
        for _ in range(2):
            _ask(dst, q1 if dst is one else q2, prompt, max_new=4)
        hexkey, n_pages, _hits = dst.paged_prefix.hot(limit=4)[0]
        push = t_fabric.export_prefix_parcel(dst, bytes.fromhex(hexkey))
        assert push.payload["k"].shape[3:] == (K, H)
        assert src.accept_parcel(push)
        src.run_until_idle(timeout_s=180)
        assert src.pushes_in == 1
        hit = src.paged_prefix.lookup(np.asarray(prompt, np.int32))
        assert hit is not None and hit[1] == n_pages * 128
        back = t_fabric.export_prefix_parcel(src, bytes.fromhex(hexkey))
        for name, arr in push.payload.items():
            assert torch.equal(back.payload[name], arr), name
        for engine in (src, dst):
            _whole_after_clear(engine)
    finally:
        one.release_buffers()
        tp.release_buffers()
    assert not mesh.world.failed
