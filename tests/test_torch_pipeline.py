"""The port's GPipe stages and expert parallelism against the JAX package
(CPU).

``parallel/pipeline.py`` ports ``PipelinedCausalLM`` with the schedule
written out over point-to-point sends on the ``pp`` group (gradients
sent back in reverse). Mirrors ``tests/test_pipeline_moe.py:122-250``:

- ``split_params`` / ``merge_params``: the port's split of the JAX
  package's flax tree equals the reference's (stacked layers), and
  merging gives the tree back;
- the pipelined forward (pp 2 x tp 2, llama_tiny, 2 microbatches) against
  the unsharded JAX model's logits (5e-4 absolute, the reference's), and
  moe_tiny's logits and aux loss through pp 2 x ep 2 and pp 2 x tp 2
  (experts over ep; their hidden columns over tp) against the JAX model's
  ``apply_with_aux`` (aux 1e-4 relative);
- train steps: pp x tp (llama_tiny) and pp x ep (moe_tiny: experts over
  ep, the aux loss in the loss), the one-step loss (1e-5 relative) and
  the gradients merged from every rank (1e-4 of each leaf's largest
  entry) against ``jax.value_and_grad(train.causal_lm_loss)`` of the
  unsharded model, then two steps whose loss falls.

The two gloo worlds of 4 CPU ranks are spawned once for the module.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
from ray_dynamic_batching_tpu.parallel import pipeline as j_pipe
from ray_dynamic_batching_tpu.parallel import train as j_train
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh
from ray_dynamic_batching_tpu_torch.parallel import optim
from ray_dynamic_batching_tpu_torch.parallel import pipeline as t_pipe
from ray_dynamic_batching_tpu_torch.parallel import train as t_train

from tests import torch_ranks
from tests.test_torch_train import _batch, _merge, _rel

torch.set_num_threads(2)

CASES = {"llama_tiny": ("TINY_LM", j_lm.TINY_LM, "tp"),
         "moe_tiny": ("TINY_MOE", j_lm.TINY_MOE, "ep")}


@pytest.fixture(scope="module")
def worlds():
    built = {}
    try:
        for ax in ("tp", "ep"):
            built[ax] = t_mesh.build_mesh(
                t_mesh.MeshConfig(pp=2, **{ax: 2}), ["cpu"] * 4)
        yield built
    finally:
        for mesh in built.values():
            mesh.shutdown()


@pytest.fixture(scope="module")
def lms():
    out = {}
    for name, (tname, cfg, _ax) in CASES.items():
        jm = j_lm.CausalLM(cfg, name=name, dtype=jnp.float32)
        params = jax.tree_util.tree_map(np.asarray,
                                        jm.init(jax.random.PRNGKey(0)))
        out[name] = (jm, params, getattr(t_lm, tname))
    return out


def _port(cfg, name, params):
    tm = t_lm.CausalLM(cfg, name=name, dtype=torch.float32, device="cpu",
                       seed=None)
    tm.module.load_state_dict(params_from_flax(params, tm.cfg))
    return tm


def test_split_merge_match_the_reference(lms):
    jm, params, tcfg = lms["llama_tiny"]
    jp = j_pipe.PipelinedCausalLM(jm, j_mesh.single_device_mesh(),
                                  n_microbatches=2)
    want = jax.tree_util.tree_map(np.asarray, jp.split_params(params))
    tp = t_pipe.PipelinedCausalLM(_port(tcfg, "llama_tiny", params),
                                  t_mesh.single_device_mesh("cpu"))
    got = tp.split_params(params)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(np.asarray(g), w)
    back = tp.merge_params(got)
    for (pw, w), (pg, g) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pw == pg
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("name,ax", [("llama_tiny", "tp"), ("moe_tiny", "ep"),
                                     ("moe_tiny", "tp")])
def test_pipelined_forward_matches_unsharded(lms, worlds, name, ax):
    """moe_tiny on pp x tp: the experts' hidden columns cut over tp."""
    jm, params, tcfg = lms[name]
    tok, mask = _batch(4)
    ref, aux = jm.apply_with_aux(params, jnp.asarray(tok), jnp.asarray(mask))
    pm = t_pipe.PipelinedCausalLM(_port(tcfg, name, params), worlds[ax],
                                  n_microbatches=2)
    tp, _ = t_pipe.make_pp_train_state(pm, optim.adamw(1e-3))
    out, got_aux = pm.apply_with_aux(tp, tok, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-4,
                               atol=1e-7)
    if name == "moe_tiny":
        assert float(got_aux) > 0.5


@pytest.mark.timeout(150)
@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_train_step_matches_jax(lms, worlds, name):
    jm, params, tcfg = lms[name]
    ax = CASES[name][2]
    tok, mask = _batch(5)
    jl, jg = jax.value_and_grad(lambda p: j_train.causal_lm_loss(
        jm, p, jnp.asarray(tok), jnp.asarray(mask)))(params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jg), tcfg)
    pm = t_pipe.PipelinedCausalLM(_port(tcfg, name, params), worlds[ax],
                                  n_microbatches=2)
    opt = optim.adamw(1e-3)
    tp, ts = t_pipe.make_pp_train_state(pm, opt)
    key = t_train._find_key(worlds[ax], tp)
    loss, _ = t_pipe.pp_loss_and_grads(pm, tp, tok, mask)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    merged = _merge(worlds[ax].world.call(torch_ranks.train_grads, key),
                    {n: tuple(g.shape) for n, g in want.items()})
    assert _rel(merged, want) < 1e-4
    step = t_pipe.make_pp_train_step(pm, opt)
    tp, ts, l1 = step(tp, ts, tok, mask)
    tp, ts, l2 = step(tp, ts, tok, mask)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)
    assert np.isfinite(float(l2)) and float(l2) < float(l1)
