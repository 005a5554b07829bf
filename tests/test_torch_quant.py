"""The port's weight-only int8 vs the JAX package's (CPU, f32).

The same flax params, made from ``PRNGKey(0)``, go to the JAX package and,
through ``params_from_flax``, to the port:

- ``quantize_tree``: codes and scales bit-identical to the JAX package's
  on ``llama_tiny``, a GPT-2-family tiny config (biases, learned
  positions, tied embeddings), a GPT-2 config whose q/k/v biases
  (``[N, H]``, 1024 elements) are quantized too, and ``moe_tiny`` (the
  experts' scales shared by all experts); the same selection
  (embeddings, norms and 1-D biases untouched, ``lm_head`` quantized); the
  same byte counts; idempotent; a JAX-quantized tree bridged with the
  same codes; a bf16 model quantized from its bf16 weights equals the JAX
  rule on those values;
- twins of ``tests/test_quant.py`` (round trip within half a step,
  embeddings unquantized, logits drift under 0.05, the engine serving
  int8 weights, the pre-quantized tree through ``LLMDeployment``);
- the quantized forward against the JAX ``apply`` on
  ``dequantize_tree(quantize_tree(params))``: logits atol 1e-5 (f32 sums in
  another order; observed ~3e-6);
- ``auto_num_slots`` with ``quantize_weights=True`` equal to the JAX
  deployment's for the same budget;
- ``ops/quant_matmul``: the plain route and the shapes it refuses.

Greedy tokens against the JAX engine on the serving arms are in
``tests/test_torch_quant_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.models import decoder as j_dec
from ray_dynamic_batching_tpu.models import quant as j_quant
from ray_dynamic_batching_tpu.serve.llm import LLMDeployment as JDeployment
from ray_dynamic_batching_tpu.utils import config as j_config
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models import decoder as t_dec
from ray_dynamic_batching_tpu_torch.models import quant as t_quant
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.ops import quant_matmul
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
from ray_dynamic_batching_tpu_torch.utils import config as t_config

torch.set_num_threads(2)

LOGIT_ATOL = 1e-5

GPT2_TINY = dict(vocab_size=512, d_model=64, num_layers=2, num_heads=4,
                 num_kv_heads=4, mlp_dim=256, max_seq_len=128,
                 pos="learned", norm="ln", gated_mlp=False, use_bias=True,
                 tie_embeddings=True)
# q/k/v biases [16, 64]: 1024 elements, so the flax rule quantizes them.
GPT2_WIDE_BIAS = dict(GPT2_TINY, d_model=1024, num_layers=1, num_heads=16,
                      num_kv_heads=16, mlp_dim=64, vocab_size=64)
CONFIGS = {
    "llama_tiny": dataclasses.asdict(t_lm.TINY_LM),
    "gpt2_tiny": GPT2_TINY,
    "gpt2_wide_bias": GPT2_WIDE_BIAS,
    "moe_tiny": dataclasses.asdict(t_lm.TINY_MOE),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, dtype=torch.float32):
    """(JAX model, its params, the port model with the same weights)."""
    kw = CONFIGS[name]
    jm = j_lm.CausalLM(j_dec.DecoderConfig(**kw), name=name,
                       dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_dec.DecoderConfig(**kw), name, dtype=dtype,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(_np_tree(params), tm.cfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in CONFIGS}


def _quantized_pair(pairs, name):
    jm, params, _ = pairs[name]
    tm = _pair(name)[2]
    return jm, params, j_quant.quantize_tree(params), t_quant.quantize_tree(tm)


def _flat(tree):
    """{flax path: leaf} with QTensor leaves kept whole."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, j_quant.QTensor))[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in flat}


def _port_leaves(tm):
    return {leaf.path: leaf for leaf in t_quant._leaves(tm)}


def _port_codes(leaf):
    """(codes, scale) of a port leaf in the flax layout, as numpy."""
    codes = getattr(leaf.owner, f"{leaf.attr}_codes")
    scale = getattr(leaf.owner, f"{leaf.attr}_scale")
    if leaf.transpose:
        codes = codes.transpose(1, 2)
    return codes.numpy(), scale.numpy()


# --- codes, scales, selection, bytes ------------------------------------------
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_codes_and_scales_bit_identical_to_jax(pairs, name):
    """Every leaf the JAX package quantizes, the port quantizes, with the
    same codes (in the flax layout, after undoing the port's) and the
    same scales; every other leaf stays unquantized on both sides."""
    _jm, _params, jq, tm = _quantized_pair(pairs, name)
    want = _flat(jq)
    got = _port_leaves(tm)
    sd = params_from_flax(_np_tree(jq), tm.cfg)
    n_quantized = 0
    for path, leaf in got.items():
        j_leaf = want[path]
        if not isinstance(j_leaf, j_quant.QTensor):
            assert not leaf.quantized, path
            continue
        n_quantized += 1
        assert leaf.quantized, path
        # The bridged JAX codes are exactly the port's own, in its layout.
        own = tm.module.state_dict()
        for suffix in ("_codes", "_scale"):
            assert torch.equal(sd[leaf.name + suffix],
                               own[leaf.name + suffix]), path
        codes, scale = _port_codes(leaf)
        np.testing.assert_array_equal(scale,
                                      np.asarray(j_leaf.scale).reshape(-1))
        assert scale.shape == (leaf.shape[-1],)
        # The port's 2-D weight is the flax kernel reshaped: compare in
        # the flax layout.
        jcodes = np.asarray(j_leaf.q)
        if leaf.transpose:
            np.testing.assert_array_equal(codes, jcodes)
        elif leaf.attr == "bias":
            np.testing.assert_array_equal(codes, jcodes.reshape(-1))
        else:
            k_in = int(np.prod(leaf.owner.flax_in))
            np.testing.assert_array_equal(codes.T, jcodes.reshape(k_in, -1))
    assert n_quantized == sum(isinstance(v, j_quant.QTensor)
                              for v in want.values())
    if name == "gpt2_wide_bias":
        assert tm.module.layers[0].q.bias_codes is not None
        assert tm.module.layers[0].o.bias is not None      # 1-D: kept


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_selection_bytes_and_idempotence(pairs, name):
    jm, params, jq, tm = _quantized_pair(pairs, name)
    fresh = _pair(name)[2]
    want = j_quant.tree_weight_bytes(jq)
    assert want == j_quant.quantized_weight_bytes(params)
    assert t_quant.quantized_weight_bytes(fresh) == want
    assert t_quant.tree_weight_bytes(tm) == want
    assert t_quant.tree_weight_bytes(fresh) == j_quant.tree_weight_bytes(
        params)
    assert not t_quant.is_quantized(fresh) and t_quant.is_quantized(tm)
    leaves = _port_leaves(tm)
    for path, leaf in leaves.items():
        if "embed" in path or len(leaf.shape) < 2:
            assert not leaf.quantized, path
    if not tm.cfg.tie_embeddings:
        assert leaves["params/lm_head/kernel"].quantized
    for mod in tm.module.modules():
        if isinstance(mod, (t_dec.RMSNorm, t_dec.LayerNorm)):
            assert mod.scale.dtype == torch.float32
    before = {k: v.clone() for k, v in tm.module.state_dict().items()}
    assert t_quant.quantize_tree(tm) is tm
    after = tm.module.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_moe_expert_scales_are_shared_across_experts(pairs):
    _jm, _params, jq, tm = _quantized_pair(pairs, "moe_tiny")
    moe = tm.module.layers[0].moe
    E, D, F = moe.num_experts, moe.d_model, moe.mlp_dim
    assert moe.wi is None and moe.wi_codes.shape == (E, F, D)
    assert moe.wo_codes.shape == (E, D, F)
    assert moe.wi_scale.shape == (F,) and moe.wo_scale.shape == (D,)
    jmoe = jq["params"]["layer0"]["moe"]
    assert jmoe["wi"].scale.shape == (1, 1, F)
    # One expert's codes use the shared scale: its absmax column reaches
    # 127 only where it holds that column's max over all experts.
    w = _pair("moe_tiny")[2].module.layers[0].moe.wi.detach()
    per_expert = w.abs().amax(dim=1)                     # [E, F]
    assert not torch.equal(per_expert[0], per_expert.amax(dim=0))
    np.testing.assert_array_equal(
        moe.wi_scale.numpy(),
        np.maximum(per_expert.amax(dim=0).numpy(), 1e-12) / np.float32(127))


def test_jax_quantized_tree_bridges_with_its_codes(pairs):
    """``params_from_flax`` of a JAX ``quantize_tree`` output (QTensor
    leaves, or ``{q, scale}`` mappings) installs the JAX codes with no
    requantization: the model equals the port's own quantization."""
    for name in ("llama_tiny", "moe_tiny"):
        _jm, _params, jq, tm = _quantized_pair(pairs, name)
        as_dicts = jax.tree_util.tree_map(
            lambda x: {"q": np.asarray(x.q), "scale": np.asarray(x.scale)}
            if isinstance(x, j_quant.QTensor) else np.asarray(x),
            jq, is_leaf=lambda x: isinstance(x, j_quant.QTensor))
        for tree in (_np_tree(jq), as_dicts):
            bridged = t_lm.CausalLM(tm.cfg, name, dtype=torch.float32,
                                    device="cpu", seed=None)
            t_quant.load_state(bridged, params_from_flax(tree, tm.cfg))
            got, want = bridged.module.state_dict(), tm.module.state_dict()
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert torch.equal(got[k], want[k]), k


def test_bf16_model_quantizes_its_bf16_weights_by_the_jax_rule(pairs):
    """A bf16 port model holds its projections in bf16 (its ``lm_head`` in
    f32); its codes are the JAX rule applied to those values (the JAX
    package quantizes its f32 params)."""
    _jm, params, _ = pairs["llama_tiny"]
    tm = _pair("llama_tiny", dtype=torch.bfloat16)[2]
    rounded = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) if "lm_head" in jax.tree_util.keystr(
            path) else np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
        params)
    jq = j_quant.quantize_tree(rounded)
    t_quant.quantize_tree(tm)
    sd = params_from_flax(_np_tree(jq), tm.cfg)
    own = tm.module.state_dict()
    for k, v in sd.items():
        if k.endswith(("_codes", "_scale")):
            assert torch.equal(v, own[k]), k
    assert tm.module.layers[0].q.weight_dtype == torch.bfloat16
    assert tm.module.lm_head.weight_dtype == torch.bfloat16


# --- twins of tests/test_quant.py ----------------------------------------------
def test_roundtrip_error_within_half_a_step(pairs):
    _jm, params, _jq, tm = _quantized_pair(pairs, "llama_tiny")
    deq = t_quant.dequantize_tree(tm, torch.float32)
    orig = _pair("llama_tiny")[2].module.state_dict()
    assert deq.keys() == orig.keys()
    for leaf in t_quant._leaves(tm):
        if not leaf.quantized:
            continue
        w, got = orig[leaf.name].float(), deq[leaf.name].float()
        wk = w.transpose(1, 2) if leaf.transpose else w
        ax, n = leaf.axis, wk.shape[leaf.axis]
        rows = wk.reshape(wk.shape[:ax] + (n // leaf.period, leaf.period)
                          + wk.shape[ax + 1:])
        step = rows.abs().amax(
            dim=[d for d in range(rows.dim()) if d != ax + 1])
        step = (step / 127.0).repeat(n // leaf.period)
        bshape = [1] * wk.dim()
        bshape[leaf.axis] = -1
        gotk = got.transpose(1, 2) if leaf.transpose else got
        assert torch.all((wk - gotk).abs() <= step.view(bshape) * 0.5 + 1e-7)


def test_embeddings_stay_unquantized(pairs):
    for name in ("llama_tiny", "gpt2_tiny"):
        tm = _quantized_pair(pairs, name)[3]
        assert tm.module.tok_embed.weight.dtype == torch.float32
        if tm.cfg.pos == "learned":
            assert tm.module.pos_embed.weight.dtype == torch.float32
        assert not any("embed" in k and v.dtype == torch.int8
                       for k, v in tm.module.state_dict().items())


def _logits(tm, tokens, mask):
    tokens, mask = torch.from_numpy(tokens), torch.from_numpy(mask)
    pos = torch.arange(tokens.shape[1])[None].expand(*tokens.shape)
    with torch.inference_mode():
        return tm.module(tokens, pos, t_dec.prefill_mask(mask)).numpy()


def test_logits_drift_bounded(pairs):
    jm, params, _jq, tm = _quantized_pair(pairs, "llama_tiny")
    tokens = np.asarray([[5, 9, 2, 7]], np.int32)
    mask = np.ones_like(tokens)
    ref = _logits(pairs["llama_tiny"][2], tokens, mask)
    got = _logits(tm, tokens, mask)
    assert np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-6) < 0.05


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantized_logits_match_jax_dequantized_apply(pairs, name):
    jm, params, jq, tm = _quantized_pair(pairs, name)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, 7:] = 0
    want = np.asarray(jm.apply(j_quant.dequantize_tree(jq, jnp.float32),
                               jnp.asarray(tokens), jnp.asarray(mask)))
    got = _logits(tm, tokens, mask)
    np.testing.assert_allclose(got[0], want[0], atol=LOGIT_ATOL)
    np.testing.assert_allclose(got[1, :7], want[1, :7], atol=LOGIT_ATOL)


def test_engine_serves_with_int8_weights(pairs):
    """The engine quantizes at construction, keeps int8 resident and
    serves a prefill group, scan horizons and a prompt past the bucket
    (the long fill), token for token as the JAX engine."""
    jm, params, _ = pairs["llama_tiny"]
    tm = _pair("llama_tiny")[2]
    cfg = dict(num_slots=2, max_len=64, prompt_buckets=[8],
               default_max_new_tokens=6)
    prompts = ([1, 2, 3], [(i * 7) % 50 + 1 for i in range(20)])
    jq = JQueue("j", max_len=64)
    je = JEngine(jm, params, jq, quantize_weights=True, **cfg)
    jreqs = [JRequest(model="j", payload={"tokens": p}, slo_ms=6e4)
             for p in prompts]
    for r in jreqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=180)
    q = RequestQueue("t", max_len=64)
    engine = DecodeEngine(tm, q, device="cpu", quantize_weights=True, **cfg)
    assert engine.quantized and tm.module.layers[0].mlp_up.weight is None
    assert tm.module.layers[0].mlp_up.weight_codes.dtype == torch.int8
    reqs = [Request(model="t", payload={"tokens": p}, slo_ms=6e4)
            for p in prompts]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=180)
    got = [r.future.result(timeout=5).tokens for r in reqs]
    assert all(len(t) == 6 for t in got)
    assert got == [r.future.result(timeout=5).tokens for r in jreqs]
    assert engine.long_chunk_dispatches > 0


def test_prequantized_params_serve_through_deployment(pairs):
    """``bench_llama3_8b``'s flow at tiny scale: the JAX package's
    ``quantize_tree`` output handed to ``LLMDeployment(params=...,
    quantize_weights=True)`` serves the JAX codes as they are."""
    jm, params, _ = pairs["llama_tiny"]
    jq = j_quant.quantize_tree(params)
    kw = dict(num_slots=2, max_len=64, prompt_buckets=[8],
              default_max_new_tokens=5, warmup=False)
    dep = LLMDeployment("llama_tiny", params=_np_tree(jq),
                        quantize_weights=True, dtype=torch.float32,
                        device="cpu", **kw)
    jdep = JDeployment("llama_tiny", params=jq, quantize_weights=True,
                       dtype=jnp.float32, **kw)
    results = []
    for d, req_cls in ((dep, Request), (jdep, JRequest)):
        replica = d.make_replica("q8-0", DeploymentConfig(name="q8"))
        replica.start()
        try:
            req = req_cls(model="q8", payload={
                "tokens": np.asarray([1, 2, 3], np.int32),
                "max_new_tokens": 5}, slo_ms=6e4)
            assert replica.assign(req)
            results.append(req.future.result(timeout=120).tokens)
        finally:
            replica.stop(timeout_s=2.0)
    assert len(results[0]) == 5 and results[0] == results[1]
    model = dep._ensure_model()
    bridged = params_from_flax(_np_tree(jq), model.cfg)
    own = model.module.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in bridged.items()
               if k.endswith("_codes"))
    with pytest.raises(ValueError, match="params or model"):
        LLMDeployment("llama_tiny", params=_np_tree(jq), model=model,
                      device="cpu")


@pytest.mark.parametrize("budget", [1 << 20, 4 << 20, 64 << 20])
def test_auto_num_slots_counts_the_int8_bytes(pairs, budget):
    jm, params, _ = pairs["llama_tiny"]
    for cfg in (j_config, t_config):
        cfg.set_config(cfg.RDBConfig.from_env(hbm_budget_bytes=budget))
    try:
        kw = dict(num_slots=0, max_len=64, prompt_buckets=[8], warmup=False)
        for quant in (False, True):
            jdep = JDeployment("llama_tiny", model=jm, params=params,
                               quantize_weights=quant, **kw)
            dep = LLMDeployment("llama_tiny", model=_pair("llama_tiny")[2],
                                quantize_weights=quant, device="cpu", **kw)
            for n_chips, max_len in ((1, None), (1, 256), (4, None)):
                assert dep.auto_num_slots(n_chips, max_len=max_len) == \
                    jdep.auto_num_slots(n_chips, max_len=max_len)
            assert t_quant.is_quantized(dep._ensure_model()) == quant
        # int8 weights leave more of a small budget to the KV rows.
        if budget == 1 << 20:
            assert dep.auto_num_slots(1) > LLMDeployment(
                "llama_tiny", model=_pair("llama_tiny")[2], device="cpu",
                **kw).auto_num_slots(1)
    finally:
        j_config.reset_config()
        t_config.reset_config()


# --- ops/quant_matmul on the CPU -------------------------------------------------
def _case(rng, M, N, K, period):
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8))
    scale = torch.from_numpy(rng.random(period).astype(np.float32) / 100)
    return x, codes, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_plain_route(dtype):
    rng = np.random.default_rng(0)
    x, codes, scale = _case(rng, 5, 48, 32, 16)
    bias = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    x, bias = x.to(dtype), bias.to(dtype)
    got = quant_matmul.int8_linear(x, codes, scale, bias,
                                   weight_dtype=dtype)
    w = codes.to(dtype) * scale.to(dtype).repeat(3)[:, None]
    assert got.dtype == dtype
    assert torch.equal(got, torch.nn.functional.linear(x, w, bias))
    # f32 activations over bf16-rounded weights: the lm_head of a bf16
    # model.
    xf = x.float()
    head = quant_matmul.int8_linear(xf, codes, scale,
                                    weight_dtype=torch.bfloat16)
    wb = (codes.to(torch.bfloat16)
          * scale.to(torch.bfloat16).repeat(3)[:, None]).float()
    assert head.dtype == torch.float32
    assert torch.equal(head, xf @ wb.T)
    assert quant_matmul.launches == 0        # the plain route counts none


@pytest.mark.parametrize("M", [16, 17, 256])
def test_int8_linear_plain_route_moves_no_body_count(M):
    """CPU tensors run the plain route on either side of the M = 16 rows
    where the card's bodies divide (bf16 activations: ``decode`` up to 16
    rows, ``prefill`` above; f32 ones: ``split3`` / ``fma``): neither
    ``launches`` nor any entry of ``launches_by_body`` moves. The reset
    zeroes the per-body counts in place, since a captured graph's replay
    adds to that very dict."""
    from ray_dynamic_batching_tpu_torch.ops import attention

    counts = quant_matmul.launches_by_body
    assert tuple(counts) == quant_matmul.BODIES
    counts["prefill"] += 3
    attention.reset_counts()
    assert quant_matmul.launches_by_body is counts
    assert set(counts.values()) == {0} and quant_matmul.launches == 0
    rng = np.random.default_rng(M)
    x, codes, scale = _case(rng, M, 48, 32, 16)
    for act, wd in ((torch.bfloat16, torch.bfloat16),
                    (torch.float32, torch.bfloat16),
                    (torch.float32, torch.float32)):
        got = quant_matmul.int8_linear(x.to(act), codes, scale,
                                       weight_dtype=wd)
        want = quant_matmul.int8_linear_plain(x.to(act), codes, scale,
                                              weight_dtype=wd)
        assert got.shape == (M, 48) and torch.equal(got, want)
    assert set(counts.values()) == {0} and quant_matmul.launches == 0


def test_int8_linear_refuses_what_it_cannot_take():
    rng = np.random.default_rng(1)
    x, codes, scale = _case(rng, 3, 48, 32, 16)
    with pytest.raises(ValueError, match="period"):
        quant_matmul.int8_linear(x, codes, scale[:5],
                                 weight_dtype=torch.float32)
    with pytest.raises(TypeError, match="bf16 weights"):
        quant_matmul.int8_linear(x.bfloat16(), codes, scale,
                                 weight_dtype=torch.float32)
    with pytest.raises(ValueError, match="bias"):
        quant_matmul.int8_linear(x, codes, scale,
                                 torch.zeros(48, dtype=torch.bfloat16),
                                 weight_dtype=torch.float32)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul.int8_linear(x, codes.float(), scale,
                                 weight_dtype=torch.float32)
    with pytest.raises(ValueError, match="contract"):
        quant_matmul.int8_linear(x[:, :16], codes, scale,
                                 weight_dtype=torch.float32)


def test_dequantize_rows_along_an_inner_axis():
    codes = torch.arange(-12, 12, dtype=torch.int8).reshape(2, 3, 4)
    scale = torch.tensor([0.5, 2.0, 4.0])
    got = quant_matmul.dequantize_rows(codes, scale, torch.float32, axis=1)
    assert torch.equal(got, codes.float() * scale[None, :, None])
