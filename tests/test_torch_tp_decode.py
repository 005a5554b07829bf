"""Tensor-parallel serving: ``DecodeEngine(mesh=)`` against the JAX
package's single-device engine (CPU, f32).

A TP engine on a gloo world of 2 or 4 CPU ranks (one spawned world per
size for the module) serves llama_tiny with the JAX package's weights;
its greedy token streams must be IDENTICAL to the JAX single-device
``DecodeEngine``'s on the same prompts — the bar the JAX package's own
``tests/test_tp_decode.py`` sets its TP engine. Arms: slab with
monolithic prefill (a prompt past the bucket takes the long fill), the
slab train (``chunked_prefill=True``), paged with token-budget chunks and
paged monolithic, with the f32 KV cache here and the int8 one in
``tests/test_torch_tp_int8.py`` (which also checks that params and
caches are cut). At tp 4 the two kv heads replicate while q is cut (each
rank's query head reads the kv head of its global index), and the paged
read takes the gather path as the reference's kernel declines. The
reference's refusals raise before any rank does work; the page fabric's
entry points take a TP engine's streams and parcels as a one-card
engine's (the round trips: ``tests/test_torch_tp_reuse.py``; drafts:
``tests/test_torch_tp_spec.py``); a 2-device bundle's ``make_replica``
answers requests with the JAX engine's tokens and leaves no process
behind.
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
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh
from ray_dynamic_batching_tpu_torch.parallel import spmd

from tests import torch_ranks

torch.set_num_threads(2)

BASE = dict(num_slots=4, max_len=64, prompt_buckets=[16],
            default_max_new_tokens=6, decode_horizon=4)
ARMS = {
    "slab_mono": {},
    "slab_train": dict(chunked_prefill=True),
    "paged_chunked": dict(paged=True, page_size=128),
    "paged_mono": dict(paged=True, page_size=128, chunked_prefill=False),
}


def _payloads():
    """Seven prompts over four slots; two past the bucket (the long fill,
    multi-chunk trains)."""
    rng = np.random.default_rng(5)
    out = []
    for i, n in enumerate((5, 12, 30, 3, 9, 40, 16)):
        out.append({"tokens": rng.integers(1, 500, n).tolist(),
                    "max_new_tokens": 4 + i % 3})
    return out


@pytest.fixture(scope="module")
def models():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    jm8 = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny_int8kv",
                        dtype=jnp.float32, kv_dtype=jnp.int8)
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                             t_lm.TINY_LM)
    out = {}
    for kv, jmodel in (("f32", jm), ("int8", jm8)):
        tm = t_lm.CausalLM(t_lm.TINY_LM, name=jmodel.name,
                           dtype=torch.float32, device="cpu", seed=None,
                           kv_dtype=torch.int8 if kv == "int8" else None)
        tm.module.load_state_dict(state)
        out[kv] = (jmodel, params, tm)
    return out


@pytest.fixture(scope="module")
def worlds():
    built = {}
    try:
        for tp in (2, 4):
            built[tp] = t_mesh.build_mesh(t_mesh.MeshConfig(tp=tp),
                                          ["cpu"] * tp)
        yield built
    finally:
        for mesh in built.values():
            mesh.shutdown()


class _Lazy(dict):
    """A dict whose missing entries ``make(key)`` fills once."""

    def __init__(self, make):
        super().__init__()
        self._make = make

    def __missing__(self, key):
        self[key] = value = self._make(key)
        return value


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX single-device engine's greedy streams, per KV dtype (its
    slab, paged and chunked arms give the same tokens: layouts and
    admission are pure scheduling, as the JAX package's own tests pin)."""
    def serve(kv):
        jm, params, _tm = models[kv]
        jq = JQueue("j", max_len=256)
        je = JEngine(jm, params, jq, **BASE)
        reqs = [JRequest(model="j", payload=p, slo_ms=6e4)
                for p in _payloads()]
        for r in reqs:
            jq.add_request(r)
        je.run_until_idle(timeout_s=120)
        return [r.future.result(timeout=5).tokens for r in reqs]

    return _Lazy(serve)


@pytest.fixture(scope="module")
def sharded(models, worlds):
    """A KV dtype's model sharded once over a world, on first use."""
    return _Lazy(lambda key: t_mesh.shard_params(worlds[key[0]],
                                                 models[key[1]][2]))


def check_tp_streams(sharded, worlds, jax_tokens, tp, arm, kv):
    """One arm's TP streams against the JAX engine's; the pool whole
    after, the world healthy."""
    model = sharded[tp, kv]
    got, engine = _serve(model, worlds[tp], warm=arm == "paged_chunked",
                         **ARMS[arm])
    try:
        assert got == jax_tokens[kv]
        if engine.paged:
            engine._allocator.check()
            assert engine._allocator.free_pages == engine.num_pages
    finally:
        engine.release_buffers()
    assert not worlds[tp].world.failed


def _serve(model, mesh, warm, **kw):
    q = RequestQueue("t", max_len=256)
    engine = DecodeEngine(model, q, device="cpu", mesh=mesh,
                          **{**BASE, **kw})
    if warm:
        engine.warmup()
    reqs = [Request(model="t", payload=p, slo_ms=6e4) for p in _payloads()]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=120)
    return [r.future.result(timeout=5).tokens for r in reqs], engine


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_greedy_streams_identical_to_jax_single_device(
        sharded, worlds, jax_tokens, tp, arm):
    """f32 KV (the int8 cache's arms: ``test_torch_tp_int8.py``)."""
    check_tp_streams(sharded, worlds, jax_tokens, tp, arm, "f32")


def params_and_caches_are_cut(models, sharded, worlds, tp):
    """Each rank holds 1/tp of every cut weight and, at tp 2, of the
    pool's kv heads (at tp 4 the 2 kv heads replicate, as the reference's
    feasible-spec rule replicates them); the page table and lengths are
    whole; each rank's engine runs on its own device."""
    _jm, _p, whole = models["int8"]
    mesh = worlds[tp]
    model = sharded[tp, "int8"]
    engine = DecodeEngine(model, RequestQueue("t"), device="cpu", mesh=mesh,
                          paged=True, page_size=128, **BASE)
    try:
        mesh.world.ctx.objects[engine._tp_key] = engine
        feet = mesh.world.call(torch_ranks.engine_footprint, engine._tp_key)
    finally:
        mesh.world.ctx.objects.pop(engine._tp_key, None)
        engine.release_buffers()
    full = sum(p.numel() * p.element_size()
               for p in whole.module.parameters())
    norms = sum(p.numel() * p.element_size()
                for n, p in whole.module.named_parameters() if "norm" in n)
    kv_cut = tp == 2
    kv_bytes = sum(p.numel() * p.element_size()
                   for n, p in whole.module.named_parameters()
                   if n.endswith((".k.weight", ".v.weight")))
    want = (full - norms - (0 if kv_cut else kv_bytes)) / tp + norms \
        + (0 if kv_cut else kv_bytes)
    for foot in feet:
        assert foot["param_bytes"] == want
        K = 2 // tp if kv_cut else 2
        assert foot["cache"]["k"][3] == K and foot["cache"]["v"][3] == K
        assert foot["cache"]["k_scale"][3] == K
        assert foot["cache"]["page_table"] == (4, 1)
        assert foot["cache"]["lengths"] == (4,)
        assert foot["device"] == "cpu"


def test_refusals_raise_before_any_sharding(models, worlds):
    """The reference's refusals (ValueError) in its order: none reaches
    the ranks."""
    _jm, _p, tm = models["f32"]
    mesh = worlds[2]
    seq = mesh.world._seq
    q = RequestQueue("t")
    cases = [
        (ValueError, "TP-mesh paged",
         dict(paged=True, draft_model=tm, quantize_weights=True)),
        (ValueError, "TP-mesh paged",
         dict(paged=True, page_size=128, draft_model=tm,
              prefix_cache_size=2)),
        (ValueError, "quantize_weights", dict(quantize_weights=True,
                                              prefix_cache_size=2)),
        (ValueError, "quantize_weights", dict(quantize_weights=True,
                                              draft_model=tm)),
    ]
    for exc, match, kw in cases:
        with pytest.raises(exc, match=match):
            DecodeEngine(tm, q, device="cpu", mesh=mesh, **{**BASE, **kw})

    class NoPspec:
        name = "bare"

    with pytest.raises(ValueError, match="paged_cache_pspec"):
        DecodeEngine(NoPspec(), q, device="cpu", mesh=mesh, paged=True,
                     **BASE)
    assert mesh.world._seq == seq


def test_page_fabric_refused_on_a_tp_engine(sharded, worlds):
    """A TP paged engine's fabric entry points answer as a one-card
    engine's: nothing is refused for the mesh (a stream that is not live
    is not queued, a push is queued, a stream parcel is accepted into a
    free slot), and its queued push is served (skipped: the entry is
    gone)."""
    from ray_dynamic_batching_tpu_torch.engine.pagefabric import (
        STREAM,
        PageParcel,
    )

    engine = DecodeEngine(sharded[2, "f32"], RequestQueue("t"),
                          device="cpu", mesh=worlds[2], paged=True,
                          page_size=128, prefix_cache_size=2, **BASE)
    try:
        assert not engine.request_migration("r", None)
        assert engine.request_prefix_push(b"k", None)
        parcel = PageParcel(kind=STREAM, page_size=128, cache_len=3,
                            payload={}, digest=b"", src="t",
                            generated=[1], max_new_tokens=4)
        assert engine.accept_parcel(parcel)
        with engine._fabric_lock:
            engine._parcel_in_q.clear()
        engine._service_fabric()
        assert engine.pushes_out == 0 and not engine._fabric_pending()
    finally:
        engine.release_buffers()
    assert not worlds[2].world.failed


@pytest.mark.timeout(180)
@pytest.mark.parametrize("arm", ["slab_mono", "paged_chunked"])
def test_straddling_query_groups_serve_the_jax_tokens(worlds, arm):
    """6 query heads over 3 kv heads at tp 2: each rank's 3 query heads
    straddle a group boundary (rank 0 reads kv heads 0, 0, 1 and rank 1
    1, 2, 2 of the replicated kv heads); greedy tokens equal the JAX
    single-device engine's, each rank gathering one kv head a query head
    (``ops/attention.gather_kv_heads``)."""
    import dataclasses

    straddle = dict(d_model=96, num_heads=6, num_kv_heads=3)
    jm = j_lm.CausalLM(dataclasses.replace(j_lm.TINY_LM, **straddle),
                       name="llama_6q3kv", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(dataclasses.replace(t_lm.TINY_LM, **straddle),
                       name="llama_6q3kv", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    jq = JQueue("j", max_len=256)
    je = JEngine(jm, params, jq, **BASE)
    jreqs = [JRequest(model="j", payload=p, slo_ms=6e4) for p in _payloads()]
    for r in jreqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=120)
    mesh = worlds[2]
    shard = t_mesh.shard_params(mesh, tm)
    try:
        layouts = mesh.world.call(torch_ranks.sharded_layout,
                                  shard.tp_shard.key)
        assert [lay["kv_index"] for lay in layouts] == [[0, 0, 1],
                                                        [0, 1, 1]]
        assert [lay["kv_window"] for lay in layouts] == [(0, 2), (1, 2)]
        got, engine = _serve(shard, mesh, warm=False, **ARMS[arm])
        engine.release_buffers()
        assert got == [r.future.result(timeout=5).tokens for r in jreqs]
        assert all(mesh.world.call(torch_ranks.kv_gathers))
    finally:
        spmd.drop_objects(mesh.world, shard.tp_shard.key)
    assert not mesh.world.failed


def test_two_device_bundle_replica_serves_the_jax_tokens(models,
                                                          jax_tokens):
    """``make_replica`` with a two-device bundle builds a TP replica over
    its own mesh, answers the payloads with the JAX engine's tokens, and
    its ranks end with it."""
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    _jm, params, _tm = models["f32"]
    dep = LLMDeployment("llama_tiny", dtype=torch.float32, device="cpu",
                        params=jax.tree_util.tree_map(np.asarray, params),
                        warmup=True, **BASE)
    replica = dep.make_replica("tp2", DeploymentConfig(name="llama_tiny"),
                               devices=["cpu", "cpu"])
    procs = list(replica.mesh.world._procs)
    try:
        assert replica.engine.mesh.shape["tp"] == 2
        replica.start()
        reqs = [Request(model="llama_tiny", payload=p, slo_ms=6e4)
                for p in _payloads()]
        for r in reqs:
            assert replica.assign(r)
        got = [r.future.result(timeout=60).tokens for r in reqs]
        assert got == jax_tokens["f32"]
    finally:
        replica.stop(timeout_s=5.0)
    assert not any(p.is_alive() for p in procs)
    assert replica.mesh.world.closed
    with pytest.raises(spmd.WorldError):
        replica.mesh.world.call(torch_ranks.launch_counts)
