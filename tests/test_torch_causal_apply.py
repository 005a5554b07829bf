"""``CausalLM``'s no-cache surface against the JAX package's, on the CPU
in f32: ``apply`` (the decoder's ``token_mask`` path: causal attention
over the valid tokens, through ``ops/attention.self_attention``),
``apply_with_aux`` (the MoE layers' load-balance losses summed; 0 for a
dense model), ``example_inputs`` and ``flops_per_sample``.

- ``llama_tiny``, ``moe_tiny`` and a GPT-2-family tiny config (learned
  positions, LayerNorm, biases, tied embeddings) from flax params
  (``init(PRNGKey(0))``) bridged by ``params_from_flax``, numpy tokens
  and ragged masks from a seed: logits within atol 1e-5 (the same f32
  math in another summation order), aux within 1e-6, identical argmax,
  at T = 16 (the flash route) and T = 8 (causal, so the plain route).
- ``flops_per_sample`` and ``example_inputs`` equal the reference's for
  every registered decoder config (weights never built: the meta device).
- ``ModelProfiler`` takes (batch, seq) rows of a decoder, as
  ``tools/run_profiles.py``'s ``gpt2_medium`` rows need.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.models import decoder as j_dec
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models import decoder as t_dec
from ray_dynamic_batching_tpu_torch.models import registry as t_reg
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.ops import attention
from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler

torch.set_num_threads(2)

ATOL = 1e-5

GPT2_TINY = dict(vocab_size=512, d_model=64, num_layers=2, num_heads=4,
                 num_kv_heads=4, mlp_dim=128, max_seq_len=64, pos="learned",
                 norm="ln", gated_mlp=False, use_bias=True,
                 tie_embeddings=True)
CONFIGS = {
    "llama_tiny": dataclasses.asdict(j_lm.TINY_LM),
    "moe_tiny": dataclasses.asdict(j_lm.TINY_MOE),
    "gpt2_tiny": GPT2_TINY,
}


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(name):
        if name not in built:
            kw = CONFIGS[name]
            jm = j_lm.CausalLM(j_dec.DecoderConfig(**kw), name=name,
                               dtype=jnp.float32)
            params = jm.init(jax.random.PRNGKey(0))
            tm = t_lm.CausalLM(t_dec.DecoderConfig(**kw), name,
                               dtype=torch.float32, device="cpu", seed=None)
            tm.module.load_state_dict(params_from_flax(
                jax.tree_util.tree_map(np.asarray, params), tm.cfg))
            built[name] = (jm, params, tm.eval())
        return built[name]

    return get


def _batch(rng, B, T, vocab):
    tokens = rng.integers(1, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, T - 3:] = 0            # right padding
    mask[2, 2:] = 0
    return tokens, mask


@pytest.mark.parametrize("T", [16, 8])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_and_aux_match_jax(pairs, name, T):
    jm, params, tm = pairs(name)
    tokens, mask = _batch(np.random.default_rng(T), 3, T, 512)
    want = np.asarray(jm.apply(params, tokens, mask))
    want_l, want_aux = jm.apply_with_aux(params, tokens, mask)
    cfg = tm.cfg
    q = (3, T, cfg.num_heads, cfg.head_dim)
    k = (3, T, cfg.num_kv_heads, cfg.head_dim)
    assert attention.route(q, k, causal=True,
                           mask_shape=(3, 1, 1, T)) == (
        "flash" if T >= 16 else "plain")
    with torch.inference_mode():
        got = tm.apply(torch.from_numpy(tokens), torch.from_numpy(mask))
        got_l, got_aux = tm.apply_with_aux(torch.from_numpy(tokens),
                                           torch.from_numpy(mask))
        via_forward = tm(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert got.shape == (3, T, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0,
                               atol=ATOL)
    assert torch.equal(got, via_forward) and torch.equal(got, got_l)
    valid = mask.astype(bool)
    assert (got.numpy().argmax(-1)[valid] == want.argmax(-1)[valid]).all()
    assert got_aux.shape == () and got_aux.dtype == torch.float32
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=0,
                               atol=1e-6)
    if name == "moe_tiny":
        assert float(got_aux) > 0
    else:
        assert float(got_aux) == 0.0


def test_apply_matches_the_cache_prefill(pairs):
    """The no-cache forward's logit at each row's last valid token is the
    cached prefill's (one model, two paths)."""
    _, _, tm = pairs("llama_tiny")
    tokens, mask = _batch(np.random.default_rng(4), 3, 16, 512)
    t, m = torch.from_numpy(tokens), torch.from_numpy(mask)
    with torch.inference_mode():
        full = tm.apply(t, m)
        last, _ = tm.prefill(t, m, tm.make_cache(3, 32))
    idx = torch.from_numpy(mask.sum(1) - 1)
    np.testing.assert_allclose(full[torch.arange(3), idx].numpy(),
                               last.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["llama3_8b", "gpt2_medium", "gpt2_draft",
                                  "llama_tiny", "moe_tiny"])
def test_flops_and_example_inputs_match_the_reference(name):
    from ray_dynamic_batching_tpu.models import registry as j_reg

    jm = j_reg.get_model(name)
    tm = t_reg.get_model(name, device="meta", seed=None)
    for seq in (None, 64, 256):
        assert tm.flops_per_sample(seq) == jm.flops_per_sample(seq)
        j_in = jm.example_inputs(4, seq)
        t_in = tm.example_inputs(4, seq)
        assert [tuple(x.shape) for x in t_in] == [x.shape for x in j_in]
        assert all(x.dtype == torch.int32 for x in t_in)
    assert [s.shape for s in tm.input_shapes(2, 32)] == [(2, 32), (2, 32)]


def test_model_profiler_takes_decoder_rows(pairs):
    _, _, tm = pairs("gpt2_tiny")
    prof = ModelProfiler(tm, timing_iters=2, warmup_iters=1).sweep(
        batch_buckets=[1, 2], seq_buckets=[16, 32])
    assert [(r.batch_size, r.seq_len) for r in prof.rows] == [
        (1, 16), (2, 16), (1, 32), (2, 32)]
    assert all(r.latency_ms > 0 for r in prof.rows)
