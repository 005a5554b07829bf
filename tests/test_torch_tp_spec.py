"""Speculative decoding on a tensor-parallel slab engine against the JAX
package's spec engine on the same mesh (CPU, f32).

A TP engine on a gloo world of 2 or 4 CPU ranks (one spawned world per
size for the module) serves llama_tiny with the JAX package's weights and
a draft: the target itself (a self-draft shares the target's shard), or
a draft with its own weights (the target's perturbed by seeded noise, so
that some proposals are accepted and some rejected), which every rank
cuts by the same rules as the target — at tp 4 its two kv heads
replicate while q is cut. The greedy streams and the acceptance rate
(accepted / drafted) must equal the JAX package's TP spec engine's on the
same mesh of fake CPU devices, on the monolithic slab arm (prompts past
the bucket take the long fill, the draft's replay included) and the slab
train. This file holds the tp 2 cases; ``test_torch_tp_spec_tp4.py`` the
tp 4 ones (one file held a test worker for over 300 s).
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
from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh

from tests import torch_ranks

torch.set_num_threads(2)

BASE = dict(num_slots=4, max_len=64, prompt_buckets=[16],
            default_max_new_tokens=6, decode_horizon=4, spec_tokens=3)
ARMS = {"slab_mono": {}, "slab_train": dict(chunked_prefill=True)}
CASES = [(2, "self", "slab_mono"), (2, "divergent", "slab_mono"),
         (4, "self", "slab_mono"), (4, "divergent", "slab_mono"),
         (2, "divergent", "slab_train"), (4, "divergent", "slab_train")]
TP = 2    # the world size this file's cases run on


def _payloads():
    """Seven prompts over four slots; two past the bucket."""
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(1, 500, n).tolist(),
             "max_new_tokens": 6 + i % 3}
            for i, n in enumerate((5, 12, 30, 3, 9, 40, 16))]


@pytest.fixture(scope="module")
def models():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    host = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    dhost = jax.tree_util.tree_map(
        lambda x: (x + 0.1 * np.abs(x).mean() * rng.standard_normal(x.shape))
        .astype(x.dtype), host)
    out = {}
    for name, tree in (("target", host), ("divergent", dhost)):
        tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny",
                           dtype=torch.float32, device="cpu", seed=None)
        tm.module.load_state_dict(params_from_flax(tree, tm.cfg))
        out[name] = (tree, tm)
    return jm, out


def world_of(tp: int):
    """One spawned gloo world of ``tp`` CPU ranks, shut down after."""
    mesh = t_mesh.build_mesh(t_mesh.MeshConfig(tp=tp), ["cpu"] * tp)
    try:
        yield mesh
    finally:
        mesh.shutdown()


@pytest.fixture(scope="module")
def world():
    yield from world_of(TP)


def _jax_spec(models, tp, draft, arm):
    jm, trees = models
    mesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=tp), jax.devices()[:tp])
    q = JQueue("j", max_len=256)
    dname = "target" if draft == "self" else draft
    engine = JEngine(jm, trees["target"][0], q, mesh=mesh, draft_model=jm,
                     draft_params=trees[dname][0], **BASE, **ARMS[arm])
    reqs = [JRequest(model="j", payload=p, slo_ms=6e4) for p in _payloads()]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=300)
    return ([list(r.future.result(timeout=5).tokens) for r in reqs],
            engine.spec_acceptance())


def check_case(models, mesh, tp, draft, arm):
    """The TP spec engine's streams and acceptance against the JAX one's."""
    _jm, trees = models
    target = t_mesh.shard_params(mesh, trees["target"][1])
    dmodel = target if draft == "self" else trees[draft][1]
    q = RequestQueue("t", max_len=256)
    engine = DecodeEngine(target, q, device="cpu", mesh=mesh,
                          draft_model=dmodel, **BASE, **ARMS[arm])
    try:
        mesh.world.ctx.objects[engine._tp_key] = engine
        layouts = mesh.world.call(torch_ranks.draft_layout, engine._tp_key)
        for lay in layouts:
            assert lay["self"] == (draft == "self")
            assert (lay["key"] == target.tp_shard.key) == (draft == "self")
            assert lay["heads"] == (4 // tp, 2 // tp if tp == 2 else 2)
            assert lay["cache_kv_heads"] == lay["heads"][1]
        reqs = [Request(model="t", payload=p, slo_ms=6e4)
                for p in _payloads()]
        for r in reqs:
            q.add_request(r)
        engine.run_until_idle(timeout_s=180)
        got = [list(r.future.result(timeout=5).tokens) for r in reqs]
        tokens, acceptance = _jax_spec(models, tp, draft, arm)
        assert got == tokens
        assert engine.spec_rounds > 0
        assert engine.spec_acceptance() == acceptance
        if draft == "divergent":
            assert 0.0 < acceptance < 1.0
    finally:
        mesh.world.ctx.objects.pop(engine._tp_key, None)
        engine.release_buffers()
    assert not mesh.world.failed


@pytest.mark.timeout(240)
@pytest.mark.parametrize("tp,draft,arm", [c for c in CASES if c[0] == TP])
def test_tp_spec_matches_jax_spec_engine_on_the_mesh(models, world, tp,
                                                     draft, arm):
    check_case(models, world, tp, draft, arm)
