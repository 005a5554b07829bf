"""Speculative decoding over the paged pool: the port against the JAX
package's engine (CPU, f32 and int8 KV, ``llama_tiny``, weights bridged by
``params_from_flax``).

Twins of every test in ``tests/test_spec_paged.py`` — token exactness
(paged+spec against slab+spec and paged-plain, f32 and int8, the kernel
route against the JAX package's Pallas kernel), the splice semantics of
the scratch pages (accepted pages spliced with no copy, rejected tails
freed, the counters conserving, a tight pool making rounds plain, the
admission's window headroom, the rollbacks), the exclusions and the
staircase window kernel — and of ``tests/test_paged_decode.py``'s paged
deployment with a draft, ``tests/test_paging.py``'s journal kinds and
``tests/test_chunked_prefill.py``'s chunked spec composition; plus a
verify window that never writes a page shared with a prefix entry. The
greedy tokens of every run equal the JAX engine's on the same knobs.
"""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.engine import decode as j_decode
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.ops.attention import set_attention_backend
from ray_dynamic_batching_tpu_torch.engine import decode as t_decode
from ray_dynamic_batching_tpu_torch.engine.paging import (
    PageEventJournal,
    spec_scratch_pages,
    table_array,
)
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.ops import attention as t_attn
from ray_dynamic_batching_tpu_torch.ops import decode_attention as t_dec

torch.set_num_threads(2)


def _bridge(params, kv_dtype=None):
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None, kv_dtype=kv_dtype)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return tm


@pytest.fixture(scope="module")
def lm():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, _bridge(params)


@pytest.fixture(scope="module")
def lm_int8(lm):
    """The same weights with the int8 KV cache."""
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny_int8kv",
                       dtype=jnp.float32, kv_dtype=jnp.int8)
    return jm, lm[1], _bridge(lm[1], torch.int8)


@pytest.fixture(scope="module")
def draft_lm(lm):
    """A DIFFERENT tiny model as the draft (PRNGKey(7)): acceptance near
    zero, the adversarial arm."""
    params = lm[0].init(jax.random.PRNGKey(7))
    return lm[0], params, _bridge(params)


DEFAULTS = dict(num_slots=4, max_len=64, prompt_buckets=[8, 16],
                eos_token_id=None, default_max_new_tokens=8,
                decode_horizon=4, page_size=128)


def _engine(side, model, *, paged, draft=None, **kw):
    """(engine, queue) of ``side`` ("port" or "jax") on ``model`` (the
    fixtures' triple); ``draft`` a triple too, three proposals a round."""
    knobs = dict(DEFAULTS, paged=paged, **kw)
    if side == "jax":
        q = JQueue(model[0].name, max_len=256)
        if draft is not None:
            knobs.update(draft_model=draft[0], draft_params=draft[1],
                         spec_tokens=3)
        return j_decode.DecodeEngine(model[0], model[1], q, **knobs), q
    q = RequestQueue("llama_tiny", max_len=256)
    if draft is not None:
        knobs.update(draft_model=draft[2], spec_tokens=3)
    return t_decode.DecodeEngine(model[2], q, device="cpu", **knobs), q


def _request(side, payload):
    cls = JRequest if side == "jax" else Request
    return cls(model="llama_tiny", payload=dict(payload), slo_ms=60_000.0)


def _workload(seed=7, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(3, 30))
        out.append({"tokens": rng.integers(1, 500, plen).tolist(),
                    "max_new_tokens": int(rng.integers(4, 12))})
    return out


def _run(side, model, *, paged, draft=None, payloads=None, **kw):
    engine, q = _engine(side, model, paged=paged, draft=draft, **kw)
    reqs = [_request(side, p) for p in (payloads or _workload())]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=300)
    return [tuple(r.future.result(timeout=5).tokens) for r in reqs], engine


def _whole(engine):
    engine._allocator.check()
    assert engine._allocator.free_pages == engine.num_pages
    assert not engine._spec_scratch


# --- token exactness ------------------------------------------------------------
def test_paged_spec_matches_slab_spec_and_plain_f32(lm, draft_lm):
    """paged+spec, slab+spec and paged-plain give one token stream with a
    divergent draft, and it is the JAX paged+spec engine's; the pool is
    whole afterwards."""
    plain_paged, _ = _run("port", lm, paged=True)
    slab_spec, _ = _run("port", lm, paged=False, draft=draft_lm)
    paged_spec, engine = _run("port", lm, paged=True, draft=draft_lm)
    assert paged_spec == slab_spec == plain_paged
    assert paged_spec == _run("jax", lm, paged=True, draft=draft_lm)[0]
    assert engine.spec_rounds > 0
    _whole(engine)


def test_paged_spec_matches_slab_spec_int8_kv(lm_int8, draft_lm):
    slab_spec, _ = _run("port", lm_int8, paged=False, draft=draft_lm)
    paged_spec, engine = _run("port", lm_int8, paged=True, draft=draft_lm)
    assert paged_spec == slab_spec
    assert paged_spec == _run("jax", lm_int8, paged=True, draft=draft_lm)[0]
    _whole(engine)


def _verify_routes_to_the_paged_kernel(model):
    cfg = model[2].cfg
    shape = (DEFAULTS["num_slots"], 4, cfg.num_heads, cfg.head_dim)
    pool = (4, 128, cfg.num_kv_heads, cfg.head_dim)
    assert t_attn.route(shape, pool, causal=False,
                        page_table_shape=(shape[0], 1),
                        lengths_shape=(shape[0],)) == "paged_decode"


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_spec_kernel_route_matches_the_pallas_kernel(lm, lm_int8,
                                                           draft_lm, kv):
    """The port's verify window takes the paged kernel's route (on the CPU
    its plain version) and emits the tokens of the JAX engine running its
    staircase Pallas kernel (interpret mode) — the twin of the JAX
    package's kernel-against-XLA pins, f32 and int8."""
    model = lm if kv == "f32" else lm_int8
    _verify_routes_to_the_paged_kernel(model)
    port, _ = _run("port", model, paged=True, draft=draft_lm)
    set_attention_backend("pallas")
    try:
        kernel, _ = _run("jax", model, paged=True, draft=draft_lm)
    finally:
        set_attention_backend("auto")
    assert port == kernel


def test_self_draft_accepts_everything_paged(lm):
    """draft == target on the pool: every proposal verifies, 12 tokens
    in 3 rounds, acceptance 1.0 — on both packages."""
    load = [{"tokens": [1, 2, 3], "max_new_tokens": 12}]
    kw = dict(num_slots=2, prompt_buckets=[8])
    out = {side: _run(side, lm, paged=True, draft=lm, payloads=load, **kw)
           for side in ("port", "jax")}
    assert out["port"][0] == out["jax"][0]
    for _toks, engine in out.values():
        assert engine.steps == 3
        assert engine.spec_acceptance() == 1.0
    assert len(out["port"][0][0]) == 12


# --- splice semantics ----------------------------------------------------------
LONG = dict(num_slots=2, max_len=192, prompt_buckets=[128],
            default_max_new_tokens=24)


def _long_run(side, lm, draft, max_new=24):
    rng = np.random.default_rng(3)
    load = [{"tokens": rng.integers(1, 500, 120).tolist(),
             "max_new_tokens": max_new}]
    toks, engine = _run(side, lm, paged=True, draft=draft, payloads=load,
                        **LONG)
    kinds = [ev["kind"] for ev in engine._page_journal.snapshot()]
    return toks[0], kinds, engine


def test_accept_path_splices_without_copy(lm):
    """A self-draft generation across a page boundary: the scratch page
    commits by table splice (``spec_commit``, no ``cow_copy``, nothing
    rejected), the tokens are the JAX engine's, the pool conserves."""
    toks, kinds, engine = _long_run("port", lm, lm)
    assert toks == _long_run("jax", lm, lm)[0]
    assert len(toks) == 24
    assert "spec_commit" in kinds
    assert "cow_copy" not in kinds
    assert "spec_reject" not in kinds
    _whole(engine)


def test_reject_path_frees_scratch(lm, draft_lm):
    exact, _, _ = _long_run("port", lm, lm)
    toks, kinds, engine = _long_run("port", lm, draft_lm)
    assert toks == exact
    assert toks == _long_run("jax", lm, draft_lm)[0]
    assert "spec_reject" in kinds
    _whole(engine)


def test_counter_conservation_accepted_plus_rejected_is_drafted(lm,
                                                                draft_lm):
    """accepted + rejected == drafted from the live counters over a
    multi-slot run; the gauge reads the engine's rolling rate."""
    tags = {"model": "llama_tiny", "paged": "true"}
    fams = (t_decode.SPEC_ACCEPTED, t_decode.SPEC_REJECTED,
            t_decode.SPEC_DRAFTED, t_decode.SPEC_ROUNDS)
    before = [f.get(tags=tags) for f in fams]
    _toks, engine = _run("port", lm, paged=True, draft=draft_lm)
    a, rj, d, rounds = (f.get(tags=tags) - b for f, b in zip(fams, before))
    assert d > 0 and a + rj == d
    assert rounds == engine.spec_rounds
    assert t_decode.SPEC_ACCEPTANCE.get(tags=tags) == pytest.approx(
        engine.spec_acceptance())
    assert 0.0 <= engine.spec_acceptance() <= 1.0


def _tight_engine(side, lm):
    return _engine(side, lm, paged=True, draft=lm, num_slots=2, max_len=192,
                   prompt_buckets=[128], default_max_new_tokens=40,
                   decode_horizon=1, kv_pool_pages=2)


def test_pool_pressure_degrades_to_plain_rounds(lm):
    """A pool too tight for a verify window makes the round one plain
    paged step: with the pool's other page held, the stream runs on plain
    steps to the plain path's own boundary (capacity), counted in
    ``spec_pool_fallbacks``, and nothing leaks; the tokens are the JAX
    engine's under the same pressure."""
    rng = np.random.default_rng(5)
    payload = {"tokens": rng.integers(1, 500, 120).tolist(),
               "max_new_tokens": 40}
    results = {}
    for side in ("port", "jax"):
        engine, q = _tight_engine(side, lm)
        held = engine._allocator.alloc(1)
        r = _request(side, payload)
        q.add_request(r)
        engine.run_until_idle(timeout_s=300)
        results[side] = r.future.result(timeout=5)
        assert results[side].finish_reason == "capacity"
        assert len(results[side].tokens) >= 5
        assert not engine._spec_scratch
        engine._allocator.decref(held)
        engine._allocator.check()
        assert engine._allocator.free_pages == 2
        if side == "port":
            assert engine.spec_pool_fallbacks > 0 and engine.spec_rounds > 0
    assert results["port"].tokens == results["jax"].tokens


def test_admission_reserves_spec_window_headroom(lm):
    """pages_for(len + spec_tokens + 1) at admission: a 126-token prompt
    takes two pages on a spec engine and one on a plain one, a 124-token
    prompt one — on both packages."""
    for spec, plen, expect in ((False, 126, 1), (True, 126, 2),
                               (True, 124, 1)):
        for side in ("port", "jax"):
            engine, q = _engine(
                side, lm, paged=True, draft=lm if spec else None,
                num_slots=2, max_len=192, prompt_buckets=[128],
                default_max_new_tokens=4, decode_horizon=1)
            r = _request(side, {"tokens": list(range(1, plen + 1)),
                                "max_new_tokens": 4})
            q.add_request(r)
            engine._admit()
            engine._drain_prefill()
            assert engine._allocator.allocated_pages == expect, (
                side, spec, plen)
            engine.run_until_idle(timeout_s=120)
            r.future.result(timeout=5)


def test_mono_admission_reserves_spec_window_headroom(lm):
    """The monolithic paged arm reserves the same window at admission."""
    engine, q = _engine("port", lm, paged=True, draft=lm,
                        chunked_prefill=False, num_slots=2, max_len=192,
                        prompt_buckets=[128], decode_horizon=1)
    r = _request("port", {"tokens": list(range(1, 127)),
                          "max_new_tokens": 4})
    q.add_request(r)
    engine._admit()
    assert engine._allocator.allocated_pages == 2
    engine.run_until_idle(timeout_s=120)
    r.future.result(timeout=5)
    _whole(engine)


def _armed_engine(lm):
    engine, q = _engine("port", lm, paged=True, draft=lm, num_slots=2,
                        max_len=256, prompt_buckets=[128],
                        default_max_new_tokens=8, decode_horizon=1)
    r = _request("port", {"tokens": list(range(1, 125)),
                          "max_new_tokens": 8})
    q.add_request(r)
    engine._admit()
    engine._drain_prefill()
    return engine, r


def test_crashed_dispatch_rolls_scratch_back_immediately(lm):
    """A verify dispatch that raises resolves the round's scratch on the
    error path: nothing in flight, no extra page held."""
    engine, r = _armed_engine(lm)
    engine._len_host[0] = 126      # the window crosses: scratch needed
    allocated_before = engine._allocator.allocated_pages

    def boom(*a, **k):
        raise RuntimeError("injected dispatch failure")

    real_fn = engine._spec_fn
    engine._spec_fn = boom
    with pytest.raises(RuntimeError, match="injected"):
        engine._spec_step()
    engine._spec_fn = real_fn
    assert not engine._spec_scratch
    assert engine._allocator.allocated_pages == allocated_before
    engine._allocator.check()
    engine._len_host[0] = 124
    engine.run_until_idle(timeout_s=120)
    r.future.result(timeout=5)


def test_stale_scratch_rollback_rebuilds_table_row(lm):
    """A round that died between reserve and splice, after which the
    slot legitimately grew its own next page: the rollback rebuilds the
    row from the slot's owned pages (the grown page stays mapped)."""
    engine, r = _armed_engine(lm)
    engine._len_host[0] = 126
    assert engine._reserve_spec_scratch()
    assert engine._spec_scratch
    grown = engine._allocator.alloc(1)
    engine._slots[0].pages.extend(grown)
    engine._table_host[0] = table_array(
        engine._slots[0].pages, engine._n_table_entries, engine.num_pages)
    engine._rollback_spec_scratch()
    assert engine._table_host[0, 1] == grown[0]
    engine._allocator.check()
    engine._len_host[0] = 124
    engine.run_until_idle(timeout_s=120)
    r.future.result(timeout=5)
    engine._allocator.check()


def test_verify_window_never_writes_a_shared_page(lm):
    """A slot that borrowed a prefix page (refcount 2: the prefix entry
    and the slot) decodes through spec rounds: before every verify
    dispatch, each page the active windows ``[len, len + k + 1)`` reach
    has refcount 1. Tokens equal the cache-off engine's and the JAX
    engine's with the same prefix cache."""
    rng = np.random.default_rng(11)
    head = rng.integers(1, 500, 140).tolist()
    load = [{"tokens": head + rng.integers(1, 500, 10).tolist(),
             "max_new_tokens": 12} for _ in range(2)]
    kw = dict(num_slots=2, max_len=320, prompt_buckets=[64, 128],
              default_max_new_tokens=12, decode_horizon=4,
              prefix_cache_size=4)
    engine, q = _engine("port", lm, paged=True, draft=lm, **kw)
    checked = []
    real_fn = engine._spec_fn

    def guarded(*args):
        ps, k1 = engine.page_size, engine.spec_tokens + 1
        for i in np.flatnonzero(engine._active_mask):
            n = int(engine._len_host[i])
            pids = engine._table_host[i, n // ps:(n + k1 - 1) // ps + 1]
            refs = [engine._allocator.refcount[p] for p in pids
                    if p < engine.num_pages]
            assert refs and all(c == 1 for c in refs), (i, n, refs)
            checked.append(engine._slots[i].shared_pages)
        return real_fn(*args)

    engine._spec_fn = guarded
    toks = []
    for p in load:      # one after the other: the second borrows page 0
        r = _request("port", p)
        q.add_request(r)
        engine.run_until_idle(timeout_s=300)
        toks.append(tuple(r.future.result(timeout=5).tokens))
    assert max(checked) == 1           # the borrower's windows were checked
    assert t_decode.PREFIX_HITS.get(
        tags={"model": "llama_tiny", "granularity": "page"}) > 0
    plain, _ = _run("port", lm, paged=True, payloads=load,
                    **dict(kw, prefix_cache_size=0))
    assert toks == plain
    jax_toks = []
    je, jq = _engine("jax", lm, paged=True, draft=lm, **kw)
    for p in load:
        r = _request("jax", p)
        jq.add_request(r)
        je.run_until_idle(timeout_s=300)
        jax_toks.append(tuple(r.future.result(timeout=5).tokens))
    assert toks == jax_toks


# --- exclusions ------------------------------------------------------------------
def test_paged_spec_takes_no_mesh(lm, draft_lm):
    """Both engines take a mesh, and both refuse paged + spec over a TP
    mesh with the reference's ``ValueError``, before any sharding work
    (the port's mesh here has no ranks: nothing may reach them)."""
    from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
    from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh

    assert "mesh" in inspect.signature(j_decode.DecodeEngine).parameters
    assert "mesh" in inspect.signature(t_decode.DecodeEngine).parameters
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=2), jax.devices()[:2])
    with pytest.raises(ValueError, match="TP-mesh paged"):
        _engine("jax", lm, paged=True, draft=draft_lm, mesh=jmesh)
    with pytest.raises(ValueError, match="TP-mesh paged"):
        _engine("port", lm, paged=True, draft=draft_lm,
                mesh=t_mesh.Mesh({"tp": 2}, ["cpu"] * 2))


def test_paged_with_draft_constructs(lm):
    engine, _q = _engine("port", lm, paged=True, draft=lm)
    assert engine.paged and engine.draft_model is lm[2]
    assert engine._dcache.capacity == DEFAULTS["max_len"] + 3 + 1


def test_llm_deployment_accepts_paged_spec():
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    dep = LLMDeployment("llama_tiny", paged=True,
                        draft_model_name="llama_tiny", device="cpu")
    assert dep.paged and dep.draft_model_name == "llama_tiny"


# --- the staircase window kernel -------------------------------------------------
def _pool(int8: bool, Tq: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    B, N, K, H, P, ps = 3, 8, 4, 32, 10, 128
    x = dict(q=rng.standard_normal((B, Tq, N, H)).astype(np.float32))
    if int8:
        x.update(k=rng.integers(-127, 127, (P, ps, K, H)).astype(np.int8),
                 v=rng.integers(-127, 127, (P, ps, K, H)).astype(np.int8),
                 ks=rng.uniform(0.01, 0.1, (P, ps, K)).astype(np.float32),
                 vs=rng.uniform(0.01, 0.1, (P, ps, K)).astype(np.float32))
    else:
        x.update(k=rng.standard_normal((P, ps, K, H)).astype(np.float32),
                 v=rng.standard_normal((P, ps, K, H)).astype(np.float32))
    x["pt"] = np.asarray([[3, 7], [1, P], [5, 0]], np.int32)
    x["lens"] = np.asarray([200, 100, 126], np.int32)    # crossing pages
    return x


def _gather_ref(x):
    """The JAX package's gather + window-mask XLA reference."""
    from ray_dynamic_batching_tpu.models.decoder import (
        dequantize_kv,
        paged_window_mask,
    )
    from ray_dynamic_batching_tpu.ops.attention import _xla_attention

    B, NP = x["pt"].shape
    P, ps, K, H = x["k"].shape
    safe = np.minimum(x["pt"], P - 1)
    kg = jnp.asarray(x["k"][safe].reshape(B, NP * ps, K, H))
    vg = jnp.asarray(x["v"][safe].reshape(B, NP * ps, K, H))
    if "ks" in x:
        kg = dequantize_kv(kg, jnp.asarray(
            x["ks"][safe].reshape(B, NP * ps, K)), jnp.float32)
        vg = dequantize_kv(vg, jnp.asarray(
            x["vs"][safe].reshape(B, NP * ps, K)), jnp.float32)
    win = paged_window_mask(jnp.asarray(x["lens"]), NP * ps,
                            x["q"].shape[1])
    return np.asarray(_xla_attention(jnp.asarray(x["q"]), kg, vg,
                                     causal=False, mask=win, scale=None))


def _port_kernel(x):
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    return t_dec.paged_decode_attention(
        t["q"], t["k"], t["v"], t["pt"], t["lens"], k_scale=t.get("ks"),
        v_scale=t.get("vs")).numpy()


@pytest.mark.parametrize("Tq", [2, 4, 5])
def test_window_kernel_matches_gather_f32(Tq):
    """The paged kernel's wrapper (its plain version on the CPU) at
    staircase windows, the verify's Tq = 5 among them, against the JAX
    gather reference: 1e-5 (f32, the same sums in another order)."""
    x = _pool(False, Tq)
    np.testing.assert_allclose(_port_kernel(x), _gather_ref(x), atol=1e-5)


def test_window_kernel_matches_gather_int8():
    """Int8 codes (|x| <= 127) times scales up to 0.1: values of ~10, so
    1e-4 absolute is the f32 sums' order difference."""
    x = _pool(True, 4)
    np.testing.assert_allclose(_port_kernel(x), _gather_ref(x), atol=1e-4)


def test_window_one_is_decode_mask():
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        decode_mask,
        paged_window_mask,
    )

    lens = torch.tensor([0, 5, 255], dtype=torch.int32)
    assert torch.equal(paged_window_mask(lens, 256, 1),
                       decode_mask(lens, 256))


def test_kernel_declines_past_window_cap():
    """Past ``MAX_WINDOW_FOR_KERNEL`` the route is prefill-shaped (the
    gathered view), and the kernel's wrapper refuses the window."""
    x = _pool(False, 9)
    assert t_attn.route(x["q"].shape, x["k"].shape, causal=False,
                        page_table_shape=x["pt"].shape,
                        lengths_shape=x["lens"].shape) != "paged_decode"
    with pytest.raises(ValueError):
        _port_kernel(x)


def test_scratch_page_math():
    from ray_dynamic_batching_tpu.ops.tile_math import (
        spec_scratch_pages as j_pages,
    )

    assert spec_scratch_pages(10, 4, 128, 256) == 1
    assert spec_scratch_pages(126, 4, 128, 256) == 2
    assert spec_scratch_pages(254, 4, 128, 256) == 2
    for length in range(0, 400, 7):
        for win in (1, 4, 5, 8):
            for cap in (128, 256, 384):
                assert (spec_scratch_pages(length, win, 128, cap)
                        == j_pages(length, win, 128, cap))


# --- twins of tests/test_paged_decode.py, test_paging.py, test_chunked_prefill.py
def test_paged_with_draft_accepted_at_deployment():
    """A paged deployment with a draft builds a replica whose engine
    speculates over the pool, and a request round-trips."""
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    dep = LLMDeployment("llama_tiny", paged=True, page_size=128,
                        draft_model_name="llama_tiny", num_slots=4,
                        max_len=128, prompt_buckets=[16],
                        dtype=torch.float32, device="cpu")
    assert dep.paged and dep.draft_model_name == "llama_tiny"
    replica = dep.make_replica("llama_tiny#p",
                               DeploymentConfig(name="llama_tiny"))
    replica.start()
    try:
        r = Request(model="llama_tiny", payload={
            "tokens": [3, 1, 4, 1, 5], "max_new_tokens": 4}, slo_ms=6e4)
        assert replica.assign(r)
        assert len(r.future.result(timeout=60).tokens) == 4
        assert replica.engine.paged and replica.engine.spec_rounds > 0
    finally:
        replica.stop()


def test_journal_accepts_spec_kinds():
    from ray_dynamic_batching_tpu.engine.paging import (
        PageEventJournal as JJournal,
    )

    for cls in (PageEventJournal, JJournal):
        j = cls()
        j.record("spec_commit", 1, 3, slot=0)
        j.record("spec_reject", 2, 1, slot=1)
        assert [e["kind"] for e in j.snapshot()] == ["spec_commit",
                                                     "spec_reject"]
        with pytest.raises(ValueError):
            j.record("spec_banana", 1, 0)


def test_chunked_spec_composition(lm):
    """chunked+spec: the draft replays the prompt through its own chunk
    program after the target's final chunk; a self-draft on the chunked
    paged arm equals plain chunked, the monolithic paged arm with the
    draft, and the JAX chunked engine."""
    plain, _ = _run("port", lm, paged=True, chunked_prefill=True)
    spec, engine = _run("port", lm, paged=True, chunked_prefill=True,
                        draft=lm)
    mono, mono_engine = _run("port", lm, paged=True, chunked_prefill=False,
                             draft=lm)
    assert spec == plain == mono
    assert spec == _run("jax", lm, paged=True, chunked_prefill=True)[0]
    assert engine.draft_chunk_dispatches > 0 and engine.spec_rounds > 0
    assert mono_engine.draft_prefill_groups > 0
    _whole(engine)
    _whole(mono_engine)
