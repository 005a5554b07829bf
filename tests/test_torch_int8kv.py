"""The port's int8 KV cache vs the JAX package's (CPU).

The same numpy inputs, made from a seed, go through the JAX function and
its port:

- ``quantize_kv_rows`` / ``dequantize_kv``: bit-identical (both divide by
  absmax / 127 in f32 and round half to even);
- the decode kernels' int8 branches: the port's plain versions against the
  JAX kernels in interpret mode — f32 atol 1e-5 (the same math summed in
  another order: the JAX kernels tile the KV axis), bf16 atol 2e-2
  (probabilities round to bf16 at another running max: a couple of bf16
  ulps at |x| < 4);
- ``llama_tiny_int8kv`` in f32 with the JAX params bridged by
  ``params_from_flax``: logits atol 1e-4 (two layers of f32 matmuls that
  XLA and PyTorch sum in other orders, and the JAX CPU path dequantizes
  before its products where the port's kernel rule scales after them;
  observed ~3e-6), cache codes within 1 (a k or v that lands on a .5
  rounding boundary may round the other way after a reordered f32 sum;
  observed equal);
- greedy token streams identical to the JAX engine's on the slab-mono,
  paged-chunked and paged-mono arms, and through ``LLMDeployment``.
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
from ray_dynamic_batching_tpu.models import decoder as j_dec
from ray_dynamic_batching_tpu.ops import attention as j_attention
from ray_dynamic_batching_tpu.ops import decode_attention as j_decode
from ray_dynamic_batching_tpu.ops import flash_attention as j_flash
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.models.decoder import (
    KVCache,
    PagedKVCache,
    dequantize_kv,
    quantize_kv_rows,
)
from ray_dynamic_batching_tpu_torch.ops import attention as t_attention
from ray_dynamic_batching_tpu_torch.ops import decode_attention as t_decode
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

torch.set_num_threads(2)

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LOGIT_ATOL = 1e-4
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    """A JAX array as numpy f32 (bf16 widened exactly)."""
    return np.asarray(jnp.asarray(x, jnp.float32))


# --- quantize / dequantize ----------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_and_dequantize_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 4, 2, 32)) * 3).astype(np.float32)
    x[0, 0] = 0.0                                   # all-zero rows: scale 1
    # absmax 127 gives scale 1.0 exactly: the other values sit on .5
    # code boundaries, which round half to even on both sides.
    x[1, 0, 0] = np.arange(32) - 15.5
    x[1, 0, 0, 0] = 127.0
    x[2, 1, 1] = -np.arange(32) * 2.5
    xt = _t(x).to(dtype)
    xj = jnp.asarray(x, JNP[dtype])
    j_codes, j_scale = j_dec.quantize_kv_rows(xj)
    codes, scale = quantize_kv_rows(xt)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    assert scale[0, 0].eq(1.0).all() and codes[0, 0].eq(0).all()
    # -14.5, -13.5, -12.5, -11.5: half to even.
    assert codes[1, 0, 0, 1:5].tolist() == [-14, -14, -12, -12]
    for out in (torch.float32, torch.bfloat16):
        got = dequantize_kv(codes, scale, out)
        want = j_dec.dequantize_kv(j_codes, j_scale, JNP[out])
        assert got.dtype == out
        np.testing.assert_array_equal(got.float().numpy(), _np(want))


# --- the kernels' int8 branches -----------------------------------------------
def _int8_kv(rng, shape):
    """Codes and scales of random rows, quantized by the JAX rule."""
    x = rng.standard_normal(shape).astype(np.float32)
    codes, scale = j_dec.quantize_kv_rows(jnp.asarray(x))
    return np.asarray(codes), np.asarray(scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Tq", [1, 4])
def test_slab_int8_plain_vs_jax_kernel(dtype, Tq):
    """S = 256 in two 128-wide JAX tiles, GQA 8/2, a staircase window per
    slot and one slot with no attended key (it averages the scaled V)."""
    rng = np.random.default_rng(10 + Tq)
    B, S, N, K, H = 3, 256, 8, 2, 32
    q = rng.standard_normal((B, Tq, N, H)).astype(np.float32)
    k, ks = _int8_kv(rng, (B, S, K, H))
    v, vs = _int8_kv(rng, (B, S, K, H))
    lengths = np.array([3, 200, 90])
    mask = (np.arange(S)[None, None, None, :]
            <= (lengths[:, None] + np.arange(Tq))[:, None, :, None])
    mask[2] = False
    want = j_decode.decode_attention(
        jnp.asarray(q, JNP[dtype]), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), block_k=128, interpret=True)
    got = t_decode.decode_attention(
        _t(q).to(dtype), _t(k), _t(v), mask=_t(mask), k_scale=_t(ks),
        v_scale=_t(vs))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=ATOL[dtype])


def _paged_int8(rng, B, Tq, N, K, H, P, ps, NP, lengths):
    """int8 pools and scales [P, ps, K], a shuffled table with sentinel
    entries past each slot's length + window, and q."""
    q = rng.standard_normal((B, Tq, N, H)).astype(np.float32)
    k, ks = _int8_kv(rng, (P, ps, K, H))
    v, vs = _int8_kv(rng, (P, ps, K, H))
    perm = rng.permutation(P)
    table = np.full((B, NP), P, np.int32)
    used = 0
    for b in range(B):
        n = -(-(int(lengths[b]) + Tq) // ps)
        table[b, :n] = perm[used: used + n]
        used += n
    return q, k, v, ks, vs, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Tq", [1, 4])
def test_paged_int8_plain_vs_jax_kernel(dtype, Tq):
    rng = np.random.default_rng(20 + Tq)
    B, N, K, H, P, ps, NP = 3, 8, 2, 32, 8, 128, 3
    q, k, v, ks, vs, table, lens = _paged_int8(rng, B, Tq, N, K, H, P, ps,
                                               NP, [5, 200, 380 - Tq])
    assert (table[0] == P).sum() == 2          # one page, two sentinels
    want = j_decode.paged_decode_attention(
        jnp.asarray(q, JNP[dtype]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(lens), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True)
    got = t_decode.paged_decode_attention(
        _t(q).to(dtype), _t(k), _t(v), _t(table), _t(lens), k_scale=_t(ks),
        v_scale=_t(vs))
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=ATOL[dtype])


def _spy(taken, name, fn):
    def wrapped(*a, **kw):
        kw.setdefault("interpret", True)
        out = fn(*a, **kw)
        if out is not None:
            taken.append(name)
        return out
    return wrapped


@pytest.mark.parametrize("Tq,paged", [(1, False), (12, False), (16, False),
                                      (1, True), (16, True)])
def test_dispatcher_int8_routes_match_reference(Tq, paged, monkeypatch):
    """Scales never change a route: the decode kernels take the codes;
    every other route (flash, plain, the paged gather) dequantizes first,
    as the JAX dispatcher does on its Pallas branch."""
    rng = np.random.default_rng(30 + Tq)
    B, N, K, H = 2, 4, 2, 32
    if paged:
        q, k, v, ks, vs, table, lens = _paged_int8(rng, B, Tq, N, K, H, 5,
                                                   128, 2, [3, 100])
        mask = None
        extra = dict(page_table=table, kv_lengths=lens)
    else:
        S = 128
        q = rng.standard_normal((B, Tq, N, H)).astype(np.float32)
        k, ks = _int8_kv(rng, (B, S, K, H))
        v, vs = _int8_kv(rng, (B, S, K, H))
        mask = rng.random((B, 1, Tq, S)) < 0.7
        mask[..., 0] = True
        extra = {}
    taken = []
    monkeypatch.setattr(j_decode, "paged_decode_attention",
                        _spy(taken, "paged_decode",
                             j_decode.paged_decode_attention))
    monkeypatch.setattr(j_decode, "decode_attention",
                        _spy(taken, "decode", j_decode.decode_attention))
    monkeypatch.setattr(j_flash, "flash_attention",
                        _spy(taken, "flash", j_flash.flash_attention))
    j_attention.set_attention_backend("pallas")
    try:
        want = j_attention.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if mask is None else jnp.asarray(mask),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
            **{n: jnp.asarray(a) for n, a in extra.items()})
    finally:
        j_attention.set_attention_backend("auto")
    jax_route = taken[0] if taken else "plain"
    port_route = t_attention.route(
        q.shape, k.shape, causal=False,
        mask_shape=None if mask is None else mask.shape,
        page_table_shape=table.shape if paged else None,
        lengths_shape=lens.shape if paged else None)
    assert port_route == jax_route
    t_attention.reset_counts()
    got = t_attention.dot_product_attention(
        _t(q), _t(k), _t(v), mask=None if mask is None else _t(mask),
        k_scale=_t(ks), v_scale=_t(vs),
        **{n: _t(a) for n, a in extra.items()})
    assert t_attention.plain_launches == (1 if port_route == "plain" else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_attention_covers_the_scale_branches():
    rng = np.random.default_rng(40)
    q = _t(rng.standard_normal((2, 1, 4, 32)).astype(np.float32))
    k, ks = (_t(a) for a in _int8_kv(rng, (2, 128, 2, 32)))
    v, vs = (_t(a) for a in _int8_kv(rng, (2, 128, 2, 32)))
    with t_attention.plain_attention():
        got = t_attention.dot_product_attention(q, k, v, k_scale=ks,
                                                v_scale=vs)
    assert torch.equal(got, t_decode.decode_attention_plain(
        q, k, v, k_scale=ks, v_scale=vs))
    with pytest.raises(ValueError, match="both"):
        t_attention.dot_product_attention(q, k, v, k_scale=ks)


# --- llama_tiny_int8kv against the JAX model ------------------------------------
@pytest.fixture(scope="module")
def models():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny_int8kv",
                       dtype=jnp.float32, kv_dtype=jnp.int8)
    params = jm.init(jax.random.PRNGKey(0))
    tm = registry.get_model("llama_tiny_int8kv", dtype=torch.float32,
                            device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


def _assert_cache_close(t_cache, j_cache, P=None):
    """Codes within 1, scales to f32 rounding, of every real row/page."""
    sl = slice(None) if P is None else slice(0, P)
    for name in ("k", "v"):
        got = getattr(t_cache, name)[:, sl].numpy().astype(np.int32)
        want = np.asarray(getattr(j_cache, name)).astype(np.int32)
        assert np.abs(got - want).max() <= 1
        np.testing.assert_allclose(
            getattr(t_cache, f"{name}_scale")[:, sl].numpy(),
            np.asarray(getattr(j_cache, f"{name}_scale")), rtol=1e-5)


def test_cache_layouts_and_bytes(models):
    jm, _params, tm = models
    assert tm.kv_dtype == torch.int8
    c = tm.make_cache(3, 32)
    assert c.quantized and c.k.dtype == torch.int8
    assert tuple(c.k_scale.shape) == (2, 3, 32, 2)
    p = tm.make_paged_cache(2, 5, 128, 256)
    assert p.quantized and tuple(p.v_scale.shape) == (2, 6, 128, 2)
    assert not KVCache.zeros(tm.cfg, 1, 8).quantized
    assert not PagedKVCache.zeros(tm.cfg, 1, 2, 128, 128).quantized
    assert tm.kv_bytes_per_slot(512) == jm.kv_bytes_per_slot(512)
    full = j_lm.CausalLM(j_lm.TINY_LM, name="t", dtype=jnp.bfloat16)
    tfull = t_lm.CausalLM(t_lm.TINY_LM, "t", dtype=torch.bfloat16,
                          device="cpu", seed=None)
    assert tfull.kv_bytes_per_slot(512) == full.kv_bytes_per_slot(512)


def test_prefill_and_decode_match_jax(models):
    jm, params, tm = models
    rng = np.random.default_rng(0)
    B, T, S = 3, 16, 32
    tokens = rng.integers(0, 512, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    j_logits, j_cache = jm.prefill(params, jnp.asarray(tokens),
                                   jnp.asarray(mask), jm.make_cache(B, S))
    with torch.inference_mode():
        t_logits, t_cache = tm.prefill(_t(tokens), _t(mask),
                                       tm.make_cache(B, S))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=LOGIT_ATOL)
    _assert_cache_close(t_cache, j_cache)
    nxt = rng.integers(0, 512, (B, 1)).astype(np.int32)
    active = np.array([True, False, True])
    for _ in range(3):
        j_logits, j_cache = jm.decode_step(params, jnp.asarray(nxt), j_cache,
                                           jnp.asarray(active))
        with torch.inference_mode():
            t_logits, t_cache = tm.decode_step(_t(nxt), t_cache,
                                               _t(active))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=LOGIT_ATOL)
        _assert_cache_close(t_cache, j_cache)
        nxt = np.asarray(j_logits).argmax(-1).astype(np.int32)[:, None]


def test_prefill_chunk_matches_jax(models):
    """A 40-token prompt in chunks of 16 on a 64-position row cache: each
    chunk's logits at its last real token, the codes, the lengths."""
    jm, params, tm = models
    prompt = np.random.default_rng(1).integers(0, 512, 40).astype(np.int32)
    j_row, t_row = jm.make_cache(1, 64), tm.make_cache(1, 64)
    for start in (0, 16, 32):
        piece = prompt[start: start + 16]
        tokens = np.zeros((1, 16), np.int32)
        mask = np.zeros((1, 16), np.int32)
        tokens[0, :piece.size], mask[0, :piece.size] = piece, 1
        j_last, j_row = jm.prefill_chunk(
            params, jnp.asarray(tokens), jnp.asarray(mask), j_row,
            jnp.int32(start), jnp.int32(piece.size - 1))
        with torch.inference_mode():
            t_last, t_row = tm.prefill_chunk(_t(tokens), _t(mask), t_row,
                                             start, int(piece.size) - 1)
        np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last),
                                   atol=LOGIT_ATOL)
        _assert_cache_close(t_row, j_row)
        np.testing.assert_array_equal(t_row.lengths.numpy(),
                                      np.asarray(j_row.lengths))


def test_paged_chunks_then_decode_match_jax(models):
    """A 40-token prompt as chunks of 16, 16 and 8 (W = 8 takes the paged
    kernel's int8 route, W = 16 the gathered, dequantized flash route)
    beside a 10-token single chunk; then three paged decode steps. Pools
    start from random codes and scales on both sides, so a stray write
    shows."""
    jm, params, tm = models
    rng = np.random.default_rng(3)
    P, ps, NP = 6, 128, 2
    j_cache = jm.make_paged_cache(2, P, ps, NP * ps)
    k0, ks0 = _int8_kv(rng, tuple(j_cache.k.shape))
    v0, vs0 = _int8_kv(rng, tuple(j_cache.v.shape))
    j_cache = j_cache.replace(k=jnp.asarray(k0), v=jnp.asarray(v0),
                              k_scale=jnp.asarray(ks0),
                              v_scale=jnp.asarray(vs0))
    t_cache = tm.make_paged_cache(2, P, ps, NP * ps)
    for name, a in (("k", k0), ("v", v0), ("k_scale", ks0),
                    ("v_scale", vs0)):
        getattr(t_cache, name)[:, :P] = _t(a)
    long_p = rng.integers(0, 512, 40).astype(np.int32)
    short_p = rng.integers(0, 512, 10).astype(np.int32)
    tables = np.array([[4, 1], [2, P]], np.int32)
    for start, W in ((0, 16), (16, 16), (32, 8)):
        tokens = np.zeros((2, W), np.int32)
        mask = np.zeros((2, W), np.int32)
        piece = long_p[start: start + W]
        tokens[0, :piece.size], mask[0, :piece.size] = piece, 1
        starts = np.array([start, 0], np.int32)
        take = np.array([piece.size - 1, 9 if start == 0 else 0], np.int32)
        rows = tables.copy()
        if start == 0:
            tokens[1, :10], mask[1, :10] = short_p, 1
        else:
            rows[1] = P      # an idle row of the group: every write drops
        j_taken, j_cache = jm.prefill_chunk_paged(
            params, jnp.asarray(tokens), jnp.asarray(mask), j_cache,
            jnp.asarray(rows), jnp.asarray(starts), jnp.asarray(take))
        with torch.inference_mode():
            t_taken, t_cache = tm.prefill_chunk_paged(
                _t(tokens), _t(mask), t_cache, _t(rows), _t(starts),
                _t(take))
        np.testing.assert_allclose(t_taken.numpy(), np.asarray(j_taken),
                                   atol=LOGIT_ATOL)
        _assert_cache_close(t_cache, j_cache, P)
    lengths = np.array([40, 10], np.int32)
    j_cache = j_cache.replace(page_table=jnp.asarray(tables),
                              lengths=jnp.asarray(lengths))
    t_cache.page_table, t_cache.lengths = _t(tables), _t(lengths)
    nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
    active = np.array([True, True])
    for _ in range(3):
        j_logits, j_cache = jm.decode_step_paged(
            params, jnp.asarray(nxt), j_cache, jnp.asarray(active))
        with torch.inference_mode():
            t_logits, t_cache = tm.decode_step_paged(_t(nxt), t_cache,
                                                     _t(active))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=LOGIT_ATOL)
        _assert_cache_close(t_cache, j_cache, P)
        nxt = np.asarray(j_logits).argmax(-1).astype(np.int32)[:, None]


# --- engines: greedy streams identical to the JAX engine's --------------------
ENGINE = dict(num_slots=4, max_len=64, prompt_buckets=[16],
              default_max_new_tokens=12)
# The canonical paged engine (tools/check_compiles.py).
PAGED = dict(num_slots=4, max_len=96, prompt_buckets=[8, 16],
             eos_token_id=None, default_max_new_tokens=8, decode_horizon=4,
             paged=True, page_size=128, chunked_prefill=True)
ARMS = {
    "slab_mono": ENGINE,
    "paged_chunked": PAGED,
    "paged_mono": dict(ENGINE, paged=True, page_size=128,
                       chunked_prefill=False),
}


def _payloads(arm):
    """Six bucketed prompts of 3-16 tokens (new-token counts 10..15) on the
    monolithic arms; the canonical seed-17 mix, multi-chunk trains
    included, on the chunked arm."""
    if arm == "paged_chunked":
        rng = np.random.default_rng(17)
        return [{"tokens": rng.integers(1, 500, int(rng.integers(3, 14))
                                        if i % 3 else
                                        int(rng.integers(40, 70))).tolist(),
                 "max_new_tokens": 6} for i in range(10)]
    rng = np.random.default_rng(1)
    return [{"tokens": rng.integers(0, 512, int(rng.integers(3, 17))).tolist(),
             "max_new_tokens": 10 + i} for i in range(6)]


def _serve_jax(jm, params, payloads, cfg):
    jq = JQueue("j", max_len=256)
    je = JEngine(jm, params, jq, **cfg)
    reqs = [JRequest(model="j", payload=p, slo_ms=6e4) for p in payloads]
    for r in reqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5) for r in reqs]


def _serve_torch(tm, payloads, cfg):
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", **cfg)
    reqs = [Request(model="t", payload=p, slo_ms=1e7) for p in payloads]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5) for r in reqs], engine


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_greedy_streams_identical_to_jax_engine(models, arm):
    jm, params, tm = models
    payloads = _payloads(arm)
    want = _serve_jax(jm, params, payloads, ARMS[arm])
    got, engine = _serve_torch(tm, payloads, ARMS[arm])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert engine._cache.quantized
    if engine.paged:
        engine._allocator.check()
        assert engine._allocator.free_pages == engine.num_pages


def test_llm_deployment_int8_streams_identical_to_jax_engine(models):
    """``LLMDeployment(quantize_kv=True)`` around the bridged int8 model
    (an injected model with ``kv_dtype=int8`` passes the check) serves the
    slab-mono arm's streams."""
    jm, params, tm = models
    payloads = _payloads("slab_mono")
    want = _serve_jax(jm, params, payloads, ENGINE)
    dep = LLMDeployment("llama_tiny_int8kv", model=tm, quantize_kv=True,
                        device="cpu", warmup=False, **ENGINE)
    replica = dep.make_replica("llama_tiny_int8kv-0",
                               DeploymentConfig(name="llama_tiny_int8kv"))
    replica.start()
    try:
        reqs = [Request(model="llama_tiny_int8kv", payload=p, slo_ms=1e7)
                for p in payloads]
        assert all(replica.assign(r) for r in reqs)
        got = [r.future.result(timeout=120) for r in reqs]
        assert replica.engine._cache.k.dtype == torch.int8
    finally:
        replica.stop()
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_quantize_kv_builds_int8_and_refuses_a_full_precision_model():
    dep = LLMDeployment("llama_tiny", quantize_kv=True, device="cpu",
                        dtype=torch.float32, seed=3, num_slots=2, max_len=32)
    assert dep._ensure_model().kv_dtype == torch.int8
    plain = t_lm.CausalLM(t_lm.TINY_LM, "llama_tiny", dtype=torch.float32,
                          device="cpu", seed=3)
    dep = LLMDeployment("llama_tiny", model=plain, quantize_kv=True,
                        device="cpu", num_slots=2, max_len=32)
    with pytest.raises(ValueError, match="kv_dtype=int8"):
        dep.make_replica("llama_tiny-0",
                         DeploymentConfig(name="llama_tiny"))
