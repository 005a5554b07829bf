"""Port decoder vs the JAX package's CausalLM (CPU, f32).

The JAX params (made from a seed) are bridged with ``params_from_flax``;
the same numpy prompts go to both. Tolerance: atol 1e-4 on logits and
cache rows — two layers of f32 matmuls that XLA and PyTorch sum in other
orders (observed ~3e-6); the port's CPU attention is the kernels' plain
versions, the JAX side its XLA path.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.models.decoder import DecoderConfig as JCfg
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.models.decoder import (
    DecoderConfig,
    apply_rope,
    decode_write_index,
    paged_window_mask,
    paged_write_index,
    write_decode_rows,
)

torch.set_num_threads(2)

ATOL = 1e-4

# A tiny GPT-2-family config: learned positions, LayerNorm, GeLU, bias,
# tied embeddings (MHA).
GPT2_TINY = dict(vocab_size=300, d_model=64, num_layers=2, num_heads=4,
                 num_kv_heads=4, mlp_dim=128, max_seq_len=64, pos="learned",
                 norm="ln", gated_mlp=False, use_bias=True,
                 tie_embeddings=True)
LLAMA_TINY = dataclasses.asdict(j_lm.TINY_LM)


def _pair(cfg_kwargs, seed=0):
    j_cfg = JCfg(**cfg_kwargs)
    jm = j_lm.CausalLM(j_cfg, name="tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed))
    cfg = DecoderConfig(**{f.name: getattr(j_cfg, f.name)
                           for f in dataclasses.fields(DecoderConfig)})
    tm = t_lm.CausalLM(cfg, name="tiny", dtype=torch.float32, device="cpu",
                       seed=None)
    tm.module.load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jm, params, tm


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def pair(request):
    return _pair(LLAMA_TINY if request.param == "llama" else GPT2_TINY)


def test_params_from_flax_covers_every_weight(pair):
    _jm, params, tm = pair
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                          tm.cfg)
    assert set(sd) == set(tm.module.state_dict())
    n_flax = sum(int(np.size(x))
                 for x in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_flax


def test_prefill_and_decode_match_jax(pair):
    jm, params, tm = pair
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(0)
    B, T, S = 3, 16, 32
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    j_logits, j_cache = jm.prefill(params, jnp.asarray(tokens),
                                   jnp.asarray(mask), jm.make_cache(B, S))
    with torch.inference_mode():
        t_logits, t_cache = tm.prefill(torch.from_numpy(tokens),
                                       torch.from_numpy(mask),
                                       tm.make_cache(B, S))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=ATOL)
    np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k),
                               atol=ATOL)
    np.testing.assert_allclose(t_cache.v.numpy(), np.asarray(j_cache.v),
                               atol=ATOL)
    np.testing.assert_array_equal(t_cache.lengths.numpy(),
                                  np.asarray(j_cache.lengths))
    nxt = rng.integers(0, V, (B, 1)).astype(np.int32)
    active = np.array([True, False, True])
    for _ in range(3):
        j_logits, j_cache = jm.decode_step(params, jnp.asarray(nxt), j_cache,
                                           jnp.asarray(active))
        with torch.inference_mode():
            t_logits, t_cache = tm.decode_step(
                torch.from_numpy(nxt), t_cache, torch.from_numpy(active))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL)
        np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k),
                                   atol=ATOL)
        np.testing.assert_array_equal(t_cache.lengths.numpy(),
                                      np.asarray(j_cache.lengths))
        nxt = np.asarray(j_logits).argmax(-1).astype(np.int32)[:, None]


def test_capacity_full_row_write_is_dropped(pair):
    """A row at capacity: its decode write at position S is dropped (the
    reference's mode="drop"), its length stays S, other rows advance."""
    jm, params, tm = pair
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(1)
    B, T, S = 2, 8, 8
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 5:] = 0
    _, j_cache = jm.prefill(params, jnp.asarray(tokens), jnp.asarray(mask),
                            jm.make_cache(B, S))
    with torch.inference_mode():
        _, t_cache = tm.prefill(torch.from_numpy(tokens),
                                torch.from_numpy(mask), tm.make_cache(B, S))
        before = t_cache.k.clone()
    nxt = rng.integers(0, V, (B, 1)).astype(np.int32)
    act = np.array([True, True])
    _, j_cache = jm.decode_step(params, jnp.asarray(nxt), j_cache,
                                jnp.asarray(act))
    with torch.inference_mode():
        _, t_cache = tm.decode_step(torch.from_numpy(nxt), t_cache,
                                    torch.from_numpy(act))
    assert t_cache.lengths.tolist() == [S, 6]
    np.testing.assert_array_equal(t_cache.lengths.numpy(),
                                  np.asarray(j_cache.lengths))
    assert torch.equal(t_cache.k[:, 0], before[:, 0])   # full row untouched
    np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k),
                               atol=ATOL)


def test_write_decode_rows_drops_out_of_range():
    full = torch.zeros((3, 4, 1, 2))
    new = torch.ones((3, 1, 2))
    write_decode_rows(full, decode_write_index(torch.tensor([0, 4, 3]), 4),
                      new)
    assert full[0, 0].eq(1).all() and full[2, 3].eq(1).all()
    assert full[1].eq(0).all()


def test_apply_rope_matches_jax():
    from ray_dynamic_batching_tpu.models.decoder import apply_rope as j_rope

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 8000, (2, 5)).astype(np.int32)
    want = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_registry_and_device_default():
    from ray_dynamic_batching_tpu_torch.models import registry

    assert {"llama3_8b", "gpt2_medium", "llama_tiny"} <= set(
        registry.registered_models())
    for name in ("LLAMA3_8B", "GPT2_MEDIUM", "TINY_LM"):
        j_cfg = dataclasses.asdict(getattr(j_lm, name))
        t_cfg = dataclasses.asdict(getattr(t_lm, name))
        assert {k: j_cfg[k] for k in t_cfg} == t_cfg
    if torch.cuda.is_available():
        assert registry.get_model("llama_tiny").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            registry.get_model("llama_tiny")


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_bf16_dtype_points_match_jax(family):
    """In the model dtype bf16: layer weights cast to bf16 before each
    product, the untied lm_head in f32, tied logits through ``attend`` in
    the embedding dtype, cache rows in bf16. Tolerance: bf16 rounds at
    other points in XLA and PyTorch, so logits and cache rows (|x| < 4)
    agree to 4 bf16 ulps at that scale: 4 * 2^-6 = 6.25e-2 (observed
    3.1e-2)."""
    cfg_kwargs = LLAMA_TINY if family == "llama" else GPT2_TINY
    j_cfg = JCfg(**cfg_kwargs)
    jm = j_lm.CausalLM(j_cfg, name="tiny", dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(1))
    cfg = DecoderConfig(**{f.name: getattr(j_cfg, f.name)
                           for f in dataclasses.fields(DecoderConfig)})
    tm = t_lm.CausalLM(cfg, name="tiny", dtype=torch.bfloat16, device="cpu",
                       seed=None)
    tm.module.load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 7:] = 0
    j_logits, j_cache = jm.prefill(params, jnp.asarray(tokens),
                                   jnp.asarray(mask), jm.make_cache(2, 32))
    with torch.inference_mode():
        t_logits, t_cache = tm.prefill(torch.from_numpy(tokens),
                                       torch.from_numpy(mask),
                                       tm.make_cache(2, 32))
    want_dtype = torch.bfloat16 if cfg.tie_embeddings else torch.float32
    assert str(j_logits.dtype) == str(want_dtype).replace("torch.", "")
    assert t_logits.dtype == want_dtype
    assert t_cache.k.dtype == torch.bfloat16
    np.testing.assert_allclose(t_logits.float().numpy(),
                               np.asarray(j_logits, np.float32), atol=6.25e-2)
    np.testing.assert_allclose(t_cache.k.float().numpy(),
                               np.asarray(j_cache.k, np.float32), atol=6.25e-2)


# Paged pool geometry for the tiny llama: 128-token pages (the engine's
# page rule), 2 table entries per slot (logical capacity 256), 6 pages.
PS, NP, P = 128, 2, 6


@pytest.fixture(scope="module")
def llama_pair():
    return _pair(LLAMA_TINY, seed=2)


def _paged_caches(jm, tm, B, rng):
    """The same random pool contents on both sides (so a dropped or stray
    write shows), all-sentinel tables, zero lengths."""
    j_cache = jm.make_paged_cache(B, P, PS, NP * PS)
    shape = tuple(j_cache.k.shape)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    j_cache = j_cache.replace(k=jnp.asarray(k0), v=jnp.asarray(v0))
    t_cache = tm.make_paged_cache(B, P, PS, NP * PS)
    assert tuple(t_cache.k.shape) == (shape[0], P + 1) + shape[2:]
    t_cache.k[:, :P] = torch.from_numpy(k0)
    t_cache.v[:, :P] = torch.from_numpy(v0)
    return j_cache, t_cache, k0


def _chunk_both(jm, params, tm, j_cache, t_cache, tokens, mask, tables,
                starts, take):
    args = [tokens, mask, None, tables, starts, take]
    j_args = [jnp.asarray(a) if a is not None else None for a in args]
    j_args[2] = j_cache
    j_taken, j_cache = jm.prefill_chunk_paged(params, *j_args)
    t_args = [torch.from_numpy(a) if a is not None else None for a in args]
    t_args[2] = t_cache
    with torch.inference_mode():
        t_taken, t_cache = tm.prefill_chunk_paged(*t_args)
    return j_taken, j_cache, t_taken, t_cache


def _assert_pools_close(j_cache, t_cache):
    np.testing.assert_allclose(t_cache.k[:, :P].numpy(),
                               np.asarray(j_cache.k), atol=ATOL)
    np.testing.assert_allclose(t_cache.v[:, :P].numpy(),
                               np.asarray(j_cache.v), atol=ATOL)


def test_paged_chunks_then_decode_match_jax(llama_pair):
    """Two trains through one group: a 40-token prompt as chunks of 16,
    16 and 8 (the last chunk W = 8 runs the paged decode route, the W = 16
    ones the gathered flash route) beside a 10-token single chunk; then
    three paged decode steps. Logits and every real page against JAX."""
    jm, params, tm = llama_pair
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(3)
    j_cache, t_cache, _ = _paged_caches(jm, tm, 2, rng)
    long_p = rng.integers(0, V, 40).astype(np.int32)
    short_p = rng.integers(0, V, 10).astype(np.int32)
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
        j_taken, j_cache, t_taken, t_cache = _chunk_both(
            jm, params, tm, j_cache, t_cache, tokens, mask, rows, starts,
            take)
        np.testing.assert_allclose(t_taken.numpy(), np.asarray(j_taken),
                                   atol=ATOL)
        _assert_pools_close(j_cache, t_cache)
    lengths = np.array([40, 10], np.int32)
    j_cache = j_cache.replace(page_table=jnp.asarray(tables),
                              lengths=jnp.asarray(lengths))
    t_cache.page_table = torch.from_numpy(tables)
    t_cache.lengths = torch.from_numpy(lengths)
    nxt = rng.integers(0, V, (2, 1)).astype(np.int32)
    active = np.array([True, True])
    for _ in range(3):
        j_logits, j_cache = jm.decode_step_paged(
            params, jnp.asarray(nxt), j_cache, jnp.asarray(active))
        with torch.inference_mode():
            t_logits, t_cache = tm.decode_step_paged(
                torch.from_numpy(nxt), t_cache, torch.from_numpy(active))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL)
        np.testing.assert_array_equal(t_cache.lengths.numpy(),
                                      np.asarray(j_cache.lengths))
        _assert_pools_close(j_cache, t_cache)
        nxt = np.asarray(j_logits).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("W", [8, 16])
def test_dropped_paged_writes_leave_real_pages_untouched(llama_pair, W):
    """Row A owns page P-1 and writes offsets [0, W); row B's table is all
    sentinel, so its writes at the SAME logical positions drop — clamped
    onto page P-1 they would race A's writes to those very cells; row C
    runs past logical capacity, its overflow positions drop. Every real
    page cell that no kept write names stays bit-identical, and A's and
    C's kept cells hold what JAX writes."""
    jm, params, tm = llama_pair
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(10 + W)
    j_cache, t_cache, k0 = _paged_caches(jm, tm, 3, rng)
    tables = np.array([[P - 1, P], [P, P], [2, 4]], np.int32)
    starts = np.array([0, 0, NP * PS - W // 2], np.int32)
    tokens = rng.integers(0, V, (3, W)).astype(np.int32)
    mask = np.ones((3, W), np.int32)
    take = np.array([W - 1, W - 1, W // 2 - 1], np.int32)
    j_taken, j_cache, t_taken, t_cache = _chunk_both(
        jm, params, tm, j_cache, t_cache, tokens, mask, tables, starts, take)
    _assert_pools_close(j_cache, t_cache)
    for rows in (0, 2):
        np.testing.assert_allclose(t_taken[rows].numpy(),
                                   np.asarray(j_taken)[rows], atol=ATOL)
    written = np.zeros(k0.shape[1:3], bool)     # [P, ps]
    written[P - 1, :W] = True
    written[4, PS - W // 2:] = True
    got = t_cache.k[:, :P].numpy()
    np.testing.assert_array_equal(got[:, ~written], k0[:, ~written])
    assert not np.allclose(got[:, P - 1, :W], k0[:, P - 1, :W])


def test_paged_write_index_steers_drops_to_the_sink():
    table = torch.tensor([[3, 0], [5, 5]], dtype=torch.int32)
    pos = torch.tensor([[0, 130, 256], [1, 2, 3]])
    pid, off = paged_write_index(pos, table, 5, 128)
    assert pid.tolist() == [[3, 0, 5], [5, 5, 5]]
    assert off.tolist() == [[0, 2, 0], [1, 2, 3]]


def test_paged_window_mask_matches_jax():
    from ray_dynamic_batching_tpu.models.decoder import (
        paged_window_mask as j_mask,
    )

    lengths = np.array([0, 5, 30], np.int32)
    for window in (1, 4, 8):
        want = np.asarray(j_mask(jnp.asarray(lengths), 32, window))
        got = paged_window_mask(torch.from_numpy(lengths), 32, window)
        np.testing.assert_array_equal(got.numpy(), want)


def test_learned_positions_past_the_table_are_clamped():
    """GPT-2 family at capacity == max_seq_len: a full row's decode
    position (= capacity) lies past the position table. Its write drops and
    its logits are never used, but it must not raise; the other rows match
    JAX."""
    jm, params, tm = _pair(GPT2_TINY, seed=4)
    V, S = tm.cfg.vocab_size, GPT2_TINY["max_seq_len"]
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, V, (2, S)).astype(np.int32)
    mask = np.ones((2, S), np.int32)
    mask[1, 5:] = 0
    _, j_cache = jm.prefill(params, jnp.asarray(tokens), jnp.asarray(mask),
                            jm.make_cache(2, S))
    with torch.inference_mode():
        _, t_cache = tm.prefill(torch.from_numpy(tokens),
                                torch.from_numpy(mask), tm.make_cache(2, S))
    nxt = rng.integers(0, V, (2, 1)).astype(np.int32)
    act = np.array([True, True])
    j_logits, j_cache = jm.decode_step(params, jnp.asarray(nxt), j_cache,
                                       jnp.asarray(act))
    with torch.inference_mode():
        t_logits, t_cache = tm.decode_step(torch.from_numpy(nxt), t_cache,
                                           torch.from_numpy(act))
    assert t_cache.lengths.tolist() == [S, 6]
    np.testing.assert_allclose(t_logits[1].numpy(), np.asarray(j_logits)[1],
                               atol=ATOL)
