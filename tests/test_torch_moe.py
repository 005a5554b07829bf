"""The port's MoE decoder vs the JAX package's (CPU, f32).

- ``MoEBlock`` against the reference block on the same numpy inputs and
  weights: outputs atol 1e-5 (f32 products summed in another order), the
  load-balance loss equal to the one the reference sows, gated and plain
  experts, top-1 and top-2, capacities that drop tokens (twin of
  ``tests/test_pipeline_moe.py::test_capacity_drops_overflow_tokens``,
  and a random one where a quarter of the choices overflow), gates that
  tie (the lower expert index wins, as ``lax.top_k``);
- one expert equals the dense SwiGLU MLP (twin of
  ``test_single_expert_equals_dense_mlp``);
- ``moe_tiny`` bridged by ``params_from_flax``: logits against the JAX
  model; greedy decode equals teacher forcing (twin of
  ``tests/test_decode.py::TestMoEDecode``); greedy tokens identical to
  the JAX engine's on the slab and paged arms, in full precision and with
  ``quantize_weights=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.models.moe import MoEBlock as JMoEBlock
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.models.decoder import prefill_mask
from ray_dynamic_batching_tpu_torch.models.moe import MoEBlock

torch.set_num_threads(2)

ATOL = 1e-5


def _blocks(D, F, E, k, cf, gated, seed=0, x=None):
    """The reference block's params and output on ``x`` (and its sown
    aux loss), and the port's block with the same weights."""
    jb = JMoEBlock(d_model=D, mlp_dim=F, num_experts=E, top_k=k,
                   capacity_factor=cf, gated=gated, dtype=jnp.float32)
    variables = jb.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    y, state = jb.apply(variables, jnp.asarray(x),
                        mutable=["intermediates"])
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    tb = MoEBlock(D, F, E, top_k=k, capacity_factor=cf, gated=gated,
                  dtype=torch.float32)
    sd = {"router.weight": torch.from_numpy(p["router"]["kernel"].T.copy())}
    for w in ("wi", "wg", "wo") if gated else ("wi", "wo"):
        sd[w] = torch.from_numpy(np.array(p[w]))
    tb.load_state_dict(sd)
    aux = state["intermediates"]["moe_aux_loss"][0]
    return np.asarray(y), float(aux), tb, p


def _run(tb, x):
    with torch.inference_mode():
        y, aux = tb(torch.from_numpy(x), return_aux=True)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("D,F,E,k,cf,gated,B,T", [
    (16, 32, 4, 2, 1.25, True, 2, 8),      # moe_tiny's routing
    (16, 32, 4, 1, 1.25, False, 2, 8),     # top-1, GeLU experts
    (16, 32, 4, 2, 0.5, True, 2, 16),      # C = 4: choices overflow
    (8, 16, 3, 2, 2.0, True, 1, 5),        # odd expert count, spare room
])
def test_block_matches_reference(D, F, E, k, cf, gated, B, T):
    x = np.random.default_rng(D + T).standard_normal((B, T, D)).astype(
        np.float32)
    want, want_aux, tb, _ = _blocks(D, F, E, k, cf, gated, x=x)
    got, aux = _run(tb, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert abs(aux - want_aux) < 1e-6
    assert np.array_equal(tb(torch.from_numpy(x)).detach().numpy(), got)


def test_capacity_drops_overflow_tokens():
    """Capacity 1, identical tokens all routed to one expert: only the
    first token gets expert output, the rest fall through as exact 0."""
    D, F, B, T = 8, 16, 1, 6
    x = np.ones((B, T, D), np.float32)
    want, _, tb, _ = _blocks(D, F, 2, 1, 1.0 / 3.0, False, seed=1, x=x)
    got, _ = _run(tb, x)
    assert np.abs(got[0, 0]).max() > 0
    np.testing.assert_array_equal(got[0, 1:], np.zeros((T - 1, D)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tied_gates_pick_the_lower_expert():
    """A zero router makes every gate equal: top-2 is experts 0 and 1 on
    both packages (``lax.top_k`` breaks ties to the lower index)."""
    D, F, E = 8, 16, 4
    x = np.random.default_rng(5).standard_normal((1, 4, D)).astype(
        np.float32)
    jb = JMoEBlock(d_model=D, mlp_dim=F, num_experts=E, top_k=2,
                   capacity_factor=4.0, dtype=jnp.float32)
    variables = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = dict(variables["params"])
    params["router"] = {"kernel": jnp.zeros((D, E), jnp.float32)}
    # Experts 2 and 3 zeroed: only experts 0 and 1 can contribute.
    for w in ("wi", "wg", "wo"):
        params[w] = params[w].at[2:].set(0.0)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x)))
    tb = MoEBlock(D, F, E, top_k=2, capacity_factor=4.0,
                  dtype=torch.float32)
    sd = {"router.weight": torch.zeros((E, D))}
    sd.update({w: torch.from_numpy(np.asarray(params[w]))
               for w in ("wi", "wg", "wo")})
    tb.load_state_dict(sd)
    got, _ = _run(tb, x)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_single_expert_equals_dense_mlp():
    D, F, B, T = 16, 32, 2, 8
    x = np.random.default_rng(0).standard_normal((B, T, D)).astype(
        np.float32)
    _, _, tb, p = _blocks(D, F, 1, 1, 2.0, True, x=x)
    got, _ = _run(tb, x)
    wi, wg, wo = p["wi"][0], p["wg"][0], p["wo"][0]
    gate = x @ wg
    ref = (gate / (1 + np.exp(-gate)) * (x @ wi)) @ wo
    np.testing.assert_allclose(got, ref, atol=ATOL)


# --- moe_tiny -------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    jm = j_lm.CausalLM(j_lm.TINY_MOE, name="moe_tiny", dtype=jnp.float32)
    return jm, jm.init(jax.random.PRNGKey(0))


def _bridge(params):
    tm = registry.get_model("moe_tiny", dtype=torch.float32, device="cpu",
                            seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return tm


def _logits(tm, seq):
    tokens = torch.tensor([seq], dtype=torch.int32)
    pos = torch.arange(len(seq))[None]
    with torch.inference_mode():
        return tm.module(tokens, pos, prefill_mask(torch.ones_like(tokens)))


def test_model_logits_match_jax(lm):
    jm, params = lm
    tm = _bridge(params)
    seq = np.random.default_rng(2).integers(0, 512, 20).tolist()
    want = np.asarray(jm.apply(params, jnp.asarray([seq]),
                               jnp.ones((1, len(seq)), jnp.int32)))
    np.testing.assert_allclose(_logits(tm, seq).numpy(), want, atol=1e-4)
    assert tm.module.layers[0].moe.wi.shape == (4, 64, 128)


def test_moe_decode_matches_teacher_forcing(lm):
    """The MoE decoder serves through the same engine (top-k routing per
    decode step); incremental decode equals full-prefix forcing."""
    tm = _bridge(lm[1])
    q = RequestQueue("moe_tiny", max_len=64)
    engine = DecodeEngine(tm, q, device="cpu", num_slots=2, max_len=32,
                          prompt_buckets=[8], default_max_new_tokens=6)
    prompt = [5, 9, 2, 7]
    req = Request(model="moe_tiny", payload={"tokens": prompt,
                                             "max_new_tokens": 6},
                  slo_ms=60_000.0)
    q.add_request(req)
    engine.run_until_idle(timeout_s=120)
    got = req.future.result(timeout=5).tokens
    seq, expect = list(prompt), []
    for _ in range(6):
        nxt = int(_logits(tm, seq)[0, -1].argmax())
        expect.append(nxt)
        seq.append(nxt)
    assert got == expect


ARMS = {
    "slab": dict(num_slots=4, max_len=64, prompt_buckets=[16],
                 default_max_new_tokens=6),
    "paged": dict(num_slots=4, max_len=96, prompt_buckets=[8, 16],
                  default_max_new_tokens=6, decode_horizon=4, paged=True,
                  page_size=128, chunked_prefill=True),
}


@pytest.mark.parametrize("quantize", [False, True], ids=["full", "int8w"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_greedy_streams_identical_to_jax_engine(lm, arm, quantize):
    jm, params = lm
    rng = np.random.default_rng(11)
    payloads = [{"tokens": rng.integers(1, 500, n).tolist(),
                 "max_new_tokens": 5 + i % 2}
                for i, n in enumerate([6, 30, 11, 3, 15])]
    jq = JQueue("j", max_len=256)
    je = JEngine(jm, params, jq, quantize_weights=quantize, **ARMS[arm])
    jreqs = [JRequest(model="j", payload=p, slo_ms=6e4) for p in payloads]
    for r in jreqs:
        jq.add_request(r)
    je.run_until_idle(timeout_s=300)
    tm = _bridge(params)
    q = RequestQueue("t")
    engine = DecodeEngine(tm, q, device="cpu", quantize_weights=quantize,
                          **ARMS[arm])
    reqs = [Request(model="t", payload=p, slo_ms=6e4) for p in payloads]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=300)
    got = [r.future.result(timeout=5).tokens for r in reqs]
    assert got == [r.future.result(timeout=5).tokens for r in jreqs]
    assert (tm.module.layers[0].moe.wi_codes is not None) == quantize
