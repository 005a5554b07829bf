"""Train-state checkpoints across the two packages (CPU).

``runtime/checkpoint.py``'s ``save_train_state`` / ``restore_train_state``
store the JAX package's layout (the flax params tree and optax's adamw
state, ``opt_state/0/.mu/params/...``; ``models/convert.py`` bridges the
port's names). A train state the JAX package saved after one step resumes
in the port, whose next loss equals the JAX package's next loss (1e-5
relative); one the port saved after one step resumes in the JAX package,
whose next loss equals the port's. Both saves write the same keys, dtypes
and tree structure. A tp 2 mesh's train state saves whole (its slices
gathered to rank 0) and restores in both packages and over the mesh.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
from ray_dynamic_batching_tpu.parallel import train as j_train
from ray_dynamic_batching_tpu.runtime import checkpoint as j_ckpt
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import (
    params_from_flax,
    train_state_from_flax,
)
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh
from ray_dynamic_batching_tpu_torch.parallel import optim
from ray_dynamic_batching_tpu_torch.parallel import train as t_train
from ray_dynamic_batching_tpu_torch.runtime import checkpoint as t_ckpt

from tests.test_torch_train import _batch

torch.set_num_threads(2)


def _setup():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tx = optax.adamw(1e-3)
    jstep = j_train.make_train_step(jm, j_mesh.single_device_mesh(), tx)
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tx, jstep, tm


def test_jax_saved_state_resumes_in_the_port(tmp_path):
    jm, params, tx, jstep, tm = _setup()
    tok, mask = _batch(1)
    p, s = params, tx.init(params)
    p, s, _ = jstep(p, s, jnp.asarray(tok), jnp.asarray(mask))
    j_ckpt.save_train_state(j_ckpt.CheckpointManager(tmp_path), 1, p, s)
    p_np, s_np = jax.tree_util.tree_map(np.asarray, (p, s))  # step donates
    _, _, want = jstep(p, s, jnp.asarray(tok), jnp.asarray(mask))

    opt = optim.adamw(1e-3)
    tp, ts = t_train.make_sharded_train_state(tm, None, opt)
    tp, ts, at = t_ckpt.restore_train_state(
        t_ckpt.CheckpointManager(tmp_path), tp, ts, model=tm)
    assert at == 1 and int(ts[0].count) == 1
    want_p, want_s = train_state_from_flax(p_np, s_np, tm.cfg)
    for n in want_p:
        torch.testing.assert_close(tp[n].detach(), want_p[n], atol=0, rtol=0)
        torch.testing.assert_close(ts[0].mu[n], want_s[0].mu[n], atol=0,
                                   rtol=0)
    _, _, got = t_train.make_train_step(tm, None, opt)(tp, ts, tok, mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_port_saved_state_resumes_in_jax(tmp_path):
    jm, params, tx, jstep, tm = _setup()
    tok, mask = _batch(2)
    opt = optim.adamw(1e-3)
    tp, ts = t_train.make_sharded_train_state(tm, None, opt)
    step = t_train.make_train_step(tm, None, opt)
    tp, ts, _ = step(tp, ts, tok, mask)
    t_ckpt.save_train_state(t_ckpt.CheckpointManager(tmp_path / "t"), 1, tp,
                            ts, model=tm, note="port")
    _, _, want = step(tp, ts, tok, mask)

    jmgr = j_ckpt.CheckpointManager(tmp_path / "t")
    assert jmgr.metadata(1) == {"step": 1, "note": "port"}
    p, s, at = j_ckpt.restore_train_state(jmgr, params, tx.init(params))
    assert at == 1 and int(s[0].count) == 1
    # The same train state saved by the JAX package: same keys, dtypes
    # and structure as the port's save.
    j_ckpt.save_train_state(j_ckpt.CheckpointManager(tmp_path / "j"), 1, p,
                            s)
    _, _, got = jstep(p, s, jnp.asarray(tok), jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    manifests = [json.loads((tmp_path / d / "step_1" / "manifest.json")
                            .read_text()) for d in ("t", "j")]
    assert manifests[0] == manifests[1]


@pytest.mark.timeout(240)
def test_a_sharded_train_state_is_not_saved_as_slices(tmp_path):
    """A tp 2 rank's train state after one step saves WHOLE: the JAX
    package restores it and it equals the JAX package's own tp 2 state
    after the same step (1e-4 of each leaf's largest entry); the port
    restores it on one device bit for bit equal to the ranks' gathered
    leaves, and over the mesh (restored whole, cut by
    ``make_sharded_train_state``) its next loss equals the unsaved
    world's next loss."""
    jm, params, tx, _jstep, tm = _setup()
    tok, mask = _batch(3)
    mesh = t_mesh.build_mesh(t_mesh.MeshConfig(tp=2), ["cpu"] * 2)
    try:
        opt = optim.adamw(1e-3)
        tp, ts = t_train.make_sharded_train_state(tm, mesh, opt)
        step = t_train.make_train_step(tm, mesh, opt)
        tp, ts, _ = step(tp, ts, tok, mask)
        rank0 = t_train._key_of(mesh.world.ctx.objects[
            t_train._find_key(mesh, tp)])
        shard = mesh.world.ctx.objects[rank0]
        mgr = t_ckpt.CheckpointManager(tmp_path / "t")
        path = t_ckpt.save_train_state(mgr, 1, tp, ts, model=shard,
                                       note="tp2")
        assert path == mgr._dir(1) and mgr.steps() == [1]
        _twin, gp, gs = t_train.gather_train_state(shard, tp, ts)
        # Slices, not whole leaves, are what rank 0 holds.
        assert tp["layers.0.q.weight"].shape[0] * 2 == \
            gp["layers.0.q.weight"].shape[0]

        # One device, bit for bit.
        one = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny",
                            dtype=torch.float32, device="cpu", seed=None)
        p0, s0 = t_train.make_sharded_train_state(one, None, opt)
        rp, rs, at = t_ckpt.restore_train_state(mgr, p0, s0, model=one)
        assert at == 1 and int(rs[0].count) == 1
        for n in gp:
            assert torch.equal(rp[n].detach(), gp[n]), n
            assert torch.equal(rs[0].mu[n], gs[0].mu[n]), n
            assert torch.equal(rs[0].nu[n], gs[0].nu[n]), n

        # Over the mesh: restore whole, cut, and step on.
        _, _, want = step(tp, ts, tok, mask)
        mp, ms = t_train.make_sharded_train_state(tm, mesh, opt, params=rp,
                                                  opt_state=rs)
        _, _, got = t_train.make_train_step(tm, mesh, opt)(mp, ms, tok,
                                                            mask)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    finally:
        mesh.shutdown()

    # The JAX package restores it; its own tp 2 state after the same step.
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=2), jax.devices()[:2])
    jp, js = j_train.make_sharded_train_state(jm, jmesh, tx)
    jp, js, _ = j_train.make_train_step(jm, jmesh, tx)(
        jp, js, jnp.asarray(tok), jnp.asarray(mask))
    jmgr = j_ckpt.CheckpointManager(tmp_path / "t")
    assert jmgr.metadata(1) == {"step": 1, "note": "tp2"}
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    p, st, at = j_ckpt.restore_train_state(jmgr, host(params),
                                           host(tx.init(params)))
    assert at == 1 and int(st[0].count) == int(js[0].count) == 1
    # What the JAX package restored is what the port gathered, exactly.
    for got, want in ((p, gp), (st[0].mu, gs[0].mu), (st[0].nu, gs[0].nu)):
        got = params_from_flax(host(got), tm.cfg)
        for n in want:
            assert torch.equal(got[n], want[n]), n
    # Against the JAX package's own tp 2 state: the moments within 1e-4
    # of each leaf's largest entry; the params within 0.1 x lr, since the
    # first AdamW step moves an entry by lr * g / (|g| + eps), which is
    # ill-conditioned where |g| is near eps (1e-8).
    for got, want, tol in ((st[0].mu, js[0].mu, None),
                           (st[0].nu, js[0].nu, None), (p, jp, 1e-4)):
        g = params_from_flax(host(got), tm.cfg)
        w = params_from_flax(host(want), tm.cfg)
        for n in w:
            err = float((g[n] - w[n]).abs().max())
            if tol is None:
                assert err / max(float(w[n].abs().max()), 1e-30) < 1e-4, n
            else:
                assert err < tol, n
