"""Train-state checkpoints across the two packages (CPU).

``runtime/checkpoint.py``'s ``save_train_state`` / ``restore_train_state``
store the JAX package's layout (the flax params tree and optax's adamw
state, ``opt_state/0/.mu/params/...``; ``models/convert.py`` bridges the
port's names). A train state the JAX package saved after one step resumes
in the port, whose next loss equals the JAX package's next loss (1e-5
relative); one the port saved after one step resumes in the JAX package,
whose next loss equals the port's. Both saves write the same keys, dtypes
and tree structure.
"""

from __future__ import annotations

import json
import types

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


def test_a_sharded_train_state_is_not_saved_as_slices(tmp_path):
    """A mesh rank's train state holds slices; saving it whole is item 8c,
    so ``save_train_state`` refuses before writing anything."""
    rank = types.SimpleNamespace(name="llama_tiny", tp_shard=object())
    mgr = t_ckpt.CheckpointManager(tmp_path)
    with pytest.raises(NotImplementedError, match="8c"):
        t_ckpt.save_train_state(mgr, 1, {}, model=rank)
    assert mgr.steps() == []
