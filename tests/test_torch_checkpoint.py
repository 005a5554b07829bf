"""Weight checkpoints: the port's ``runtime/checkpoint.py`` against the JAX
package's (CPU).

One on-disk format for both packages: a checkpoint the JAX package's
``CheckpointManager`` writes (llama_tiny from ``PRNGKey(123)``) serves in
the port's ``LLMDeployment(checkpoint_dir=)`` greedy tokens identical to
the JAX deployment restored from it, and different from a fresh draw
(the twin of ``tests/test_llm_serving.py:124``). Leaves cross both ways
bit for bit, bfloat16 included (raw ``|V2`` items); manifests are equal;
the two managers keep the same steps, files and metadata under one
sequence of saves, and clear ``.tmp`` / ``.old`` alike. A TP-2 rank's
restore keeps its slice of each sharded leaf, the slice the port's own
shard plan cuts. ``params_to_flax`` inverts ``params_from_flax`` on three
decoder families. ``ModelHost(checkpoint_dir=)`` round-trips.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.models import registry as j_registry  # noqa: F401
from ray_dynamic_batching_tpu.models.base import get_model as j_get_model
from ray_dynamic_batching_tpu.runtime import checkpoint as j_ckpt
from ray_dynamic_batching_tpu.serve import llm as j_llm
from ray_dynamic_batching_tpu.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu.utils.pytree import (
    flatten_with_paths as j_flatten,
)
from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import (
    params_from_flax,
    params_to_flax,
)
from ray_dynamic_batching_tpu_torch.parallel.mesh import Mesh, shard_plan
from ray_dynamic_batching_tpu_torch.runtime import checkpoint as t_ckpt
from ray_dynamic_batching_tpu_torch.serve import llm as t_llm
from ray_dynamic_batching_tpu_torch.serve.controller import (
    DeploymentConfig as TDeploymentConfig,
)
from ray_dynamic_batching_tpu_torch.utils.pytree import flatten_with_paths

torch.set_num_threads(2)

PROMPTS = [[5, 9, 2, 7], [11, 3, 8, 1, 4, 6], [200, 17, 99]]
ENGINE = dict(num_slots=2, max_len=64, prompt_buckets=[8],
              default_max_new_tokens=8, warmup=False)


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as integers (bf16 through a 16-bit view)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.atleast_1d(np.asarray(x)).view(np.uint8)


def _serve(replica, prompts, j_request=None):
    replica.start()
    try:
        cls = j_request or Request
        reqs = [cls(model="llama_tiny", slo_ms=1e7,
                    payload={"tokens": p, "max_new_tokens": 8})
                for p in prompts]
        for r in reqs:
            assert replica.assign(r)
        return [r.future.result(timeout=120).tokens for r in reqs]
    finally:
        replica.stop(timeout_s=5.0, drain=False)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpt")
    model = j_get_model("llama_tiny", dtype=jnp.float32)
    trained = model.init(jax.random.PRNGKey(123))
    j_ckpt.CheckpointManager(str(root)).save(step=7, tree=trained)
    return str(root)


def test_jax_checkpoint_serves_identical_tokens_in_the_port(jax_checkpoint):
    from ray_dynamic_batching_tpu.engine.request import Request as JRequest

    j_dep = j_llm.LLMDeployment("llama_tiny", dtype=jnp.float32,
                                checkpoint_dir=jax_checkpoint, **ENGINE)
    want = _serve(j_dep.make_replica("j", DeploymentConfig(name="llama_tiny")),
                  PROMPTS, JRequest)
    t_dep = t_llm.LLMDeployment("llama_tiny", dtype=torch.float32,
                                device="cpu", checkpoint_dir=jax_checkpoint,
                                **ENGINE)
    got = _serve(t_dep.make_replica("t", TDeploymentConfig(
        name="llama_tiny")), PROMPTS)
    assert got == want and all(len(t) == 8 for t in got)
    fresh = t_llm.LLMDeployment("llama_tiny", dtype=torch.float32,
                                device="cpu", **ENGINE)
    drawn = _serve(fresh.make_replica("f", TDeploymentConfig(
        name="llama_tiny")), PROMPTS)
    assert drawn != got


def test_params_and_checkpoint_dir_refused_together(jax_checkpoint):
    with pytest.raises(ValueError, match="not both"):
        t_llm.LLMDeployment("llama_tiny", device="cpu", params={},
                            checkpoint_dir=jax_checkpoint)


def test_checkpoint_step_picks_the_step(tmp_path):
    """Two steps of different weights: ``checkpoint_step`` chooses, the
    default is the latest; both packages restore the same leaves."""
    model = j_get_model("llama_tiny", dtype=jnp.float32)
    mgr = j_ckpt.CheckpointManager(str(tmp_path))
    trees = {s: model.init(jax.random.PRNGKey(s)) for s in (1, 2)}
    for s, tree in trees.items():
        mgr.save(step=s, tree=tree)
    for step, seed in ((1, 1), (None, 2)):
        dep = t_llm.LLMDeployment("llama_tiny", dtype=torch.float32,
                                  device="cpu", checkpoint_dir=str(tmp_path),
                                  checkpoint_step=step)
        got = flatten_with_paths(params_to_flax(dep._ensure_model()))
        want = j_flatten(trees[seed])
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --- leaves across the two packages -------------------------------------------
def _tree(lib):
    if lib == "jax":
        return {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) * 0.37,
                "nested": {"b": jnp.linspace(-1, 1, 4, dtype=jnp.float32),
                           "n": jnp.int32(7), "i8": jnp.arange(
                               -3, 3, dtype=jnp.int8)},
                "layers": [jnp.full((2,), 1.5, jnp.bfloat16), None]}
    return {"w": (torch.arange(6, dtype=torch.float32).reshape(2, 3)
                  .to(torch.bfloat16) * 0.37),
            "nested": {"b": torch.linspace(-1, 1, 4),
                       "n": torch.tensor(7, dtype=torch.int32),
                       "i8": torch.arange(-3, 3, dtype=torch.int8)},
            "layers": [torch.full((2,), 1.5, dtype=torch.bfloat16), None]}


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    tree = _tree("torch")
    t_ckpt.save_pytree(tmp_path / "ck", tree)
    target = jax.eval_shape(lambda: _tree("jax"))
    back = j_ckpt.restore_pytree(tmp_path / "ck", target)
    assert back["w"].dtype == jnp.bfloat16
    got = j_flatten(back)
    want = flatten_with_paths(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(_bits(np.asarray(got[k])),
                                      _bits(want[k]))


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _tree("jax")
    j_ckpt.save_pytree(tmp_path / "ck", tree)
    back = t_ckpt.restore_pytree(tmp_path / "ck", _tree("torch"))
    assert back["w"].dtype == torch.bfloat16 and back["layers"][1] is None
    got = flatten_with_paths(back)
    want = j_flatten(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(np.asarray(want[k])))


def test_manifests_equal_and_port_roundtrip(tmp_path):
    j_ckpt.save_pytree(tmp_path / "j", _tree("jax"))
    t_ckpt.save_pytree(tmp_path / "t", _tree("torch"))
    mj = json.loads((tmp_path / "j" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert mt == mj
    back = t_ckpt.restore_pytree(tmp_path / "t", _tree("torch"))
    for k, v in flatten_with_paths(_tree("torch")).items():
        assert torch.equal(flatten_with_paths(back)[k], v)


def test_restore_casts_to_the_target_dtype(tmp_path):
    t_ckpt.save_pytree(tmp_path / "ck", {"x": torch.ones(3)})
    back = t_ckpt.restore_pytree(tmp_path / "ck",
                                 {"x": torch.empty(3, dtype=torch.bfloat16)})
    assert back["x"].dtype == torch.bfloat16
    assert torch.equal(back["x"].float(), torch.ones(3))


@pytest.mark.parametrize("lib", ["jax", "torch"])
def test_missing_leaf_errors(tmp_path, lib):
    mod = j_ckpt if lib == "jax" else t_ckpt
    ones = jnp.ones if lib == "jax" else torch.ones
    mod.save_pytree(tmp_path / "ck", {"a": ones(2)})
    with pytest.raises(KeyError, match="missing 1 leaves"):
        mod.restore_pytree(tmp_path / "ck", {"a": ones(2), "extra": ones(3)})


# --- the managers -------------------------------------------------------------
def _manager_run(lib, root):
    mod = j_ckpt if lib == "jax" else t_ckpt
    full = (lambda n, v: jnp.full((n,), v, jnp.float32)) if lib == "jax" \
        else (lambda n, v: torch.full((n,), float(v)))
    mgr = mod.CheckpointManager(root, max_to_keep=2)
    out = {"empty": (mgr.latest_step(), mgr.metadata())}
    for step in (10, 20, 30):
        mgr.save(step, {"x": full(2, step)}, metadata={"loss": step / 10})
    # A crashed save left its .tmp behind; the next save of that step
    # clears it, and re-saving an existing step leaves no .old.
    os.makedirs(os.path.join(root, "step_40.tmp", "junk"))
    mgr.save(40, {"x": full(2, 40)})
    mgr.save(40, {"x": full(2, 41)})
    out["steps"] = mgr.steps()
    out["latest"] = mgr.latest_step()
    out["files"] = sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, files in os.walk(root) for f in files)
    out["dirs"] = sorted(os.listdir(root))
    out["metadata"] = [mgr.metadata(), mgr.metadata(30)]
    tgt = {"x": full(2, 0)}
    out["x"] = [np.asarray(mgr.restore(tgt)["x"]).tolist(),
                np.asarray(mgr.restore(tgt, step=30)["x"]).tolist()]
    mgr.delete(30)
    out["after_delete"] = mgr.steps()
    with pytest.raises(FileNotFoundError):
        mod.CheckpointManager(os.path.join(root, "none")).restore(tgt)
    return out


def test_managers_keep_the_same_steps_and_files(tmp_path):
    j = _manager_run("jax", str(tmp_path / "j"))
    t = _manager_run("torch", str(tmp_path / "t"))
    assert t == j
    assert t["steps"] == [30, 40] and t["x"] == [[41.0, 41.0], [30.0, 30.0]]
    assert "step_40.tmp" not in t["dirs"] and "step_40.old" not in t["dirs"]


def test_train_state_waits_for_training(tmp_path):
    """The train-state pair is no longer a stand-in: a tree saved with it
    restores under one step, with the step in the metadata (the port's
    train states are held against the JAX package in
    ``tests/test_torch_train_checkpoint.py``)."""
    mgr = t_ckpt.CheckpointManager(tmp_path)
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    t_ckpt.save_train_state(mgr, 1, params, {"m": torch.ones(2)}, tag="x")
    got, opt, step = t_ckpt.restore_train_state(
        mgr, {"w": torch.zeros(2, 3)}, {"m": torch.zeros(2)})
    assert step == 1 and mgr.metadata(1) == {"step": 1, "tag": "x"}
    assert torch.equal(got["w"], params["w"])
    assert torch.equal(opt["m"], torch.ones(2))


# --- the decoder tree ------------------------------------------------------
def _small(cfg):
    return dataclasses.replace(cfg, vocab_size=512, d_model=64, num_layers=2,
                               mlp_dim=128, max_seq_len=64)


@pytest.mark.parametrize("cfg_name", ["TINY_LM", "TINY_MOE", "GPT2_DRAFT"])
def test_params_to_flax_inverts_params_from_flax(cfg_name):
    jcfg = getattr(j_lm, cfg_name)
    tcfg = getattr(t_lm, cfg_name)
    if cfg_name == "GPT2_DRAFT":
        jcfg, tcfg = _small(jcfg), _small(tcfg)
    jm = j_lm.CausalLM(jcfg, name="m", dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    tm = t_lm.CausalLM(tcfg, name="m", dtype=torch.float32, device="cpu",
                       seed=None)
    tm.module.load_state_dict(params_from_flax(params, tm.cfg))
    got = flatten_with_paths(params_to_flax(tm))
    want = j_flatten(params)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_tp2_shard_restore_is_the_slice_of_the_whole(tmp_path):
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=5)
    whole = params_to_flax(tm)
    t_ckpt.save_pytree(tmp_path / "ck", whole)
    flat_whole = flatten_with_paths(whole)
    modules = dict(tm.module.named_modules())
    leaves = tm.flax_leaves()
    cut_leaves = 0
    for rank in range(2):
        mesh = Mesh({"tp": 2}, ["cpu", "cpu"], rank=rank)
        shardings = t_ckpt.checkpoint_shardings(mesh, tm)
        part = flatten_with_paths(t_ckpt.restore_pytree(
            tmp_path / "ck", whole, shardings))
        cuts = flatten_with_paths(shardings)
        plan = shard_plan(mesh, tm)
        for name, (path, shape, _dims) in leaves.items():
            key = "params/" + path
            cut = cuts[key]
            want = flat_whole[key]
            if cut.dim is not None:
                n = shape[cut.dim] // cut.parts
                want = want.narrow(cut.dim, rank * n, n)
                cut_leaves += 1
            assert torch.equal(part[key], want), key
            # The port's own plan cuts the same numbers from its weight.
            mod_name, _, leaf = name.rpartition(".")
            port = dict(tm.module.named_parameters())[name]
            mine = plan[name].take(port)
            if leaf == "weight" and hasattr(modules[mod_name], "flax_in"):
                mod = modules[mod_name]
                d_in, d_out = (int(np.prod(mod.flax_in)),
                               int(np.prod(mod.flax_out)))
                # [in, out] once the flax axes are merged; the cut side -1.
                kern = (part[key].reshape(-1, d_out) if plan[name].dim == 1
                        else part[key].reshape(d_in, -1))
                assert torch.equal(kern.T, mine), key
            else:
                assert torch.equal(part[key].reshape(mine.shape), mine), key
    assert cut_leaves > 0


@pytest.mark.parametrize("name", ["vit_tiny", "resnet18_tiny"])
def test_model_host_checkpoint_roundtrip(tmp_path, name):
    src = ModelHost(device="cpu", seed=3, checkpoint_dir=str(tmp_path))
    a = src.acquire(name)
    path = src.save_checkpoint(name)
    assert path == os.path.join(str(tmp_path), name)
    b = ModelHost(device="cpu", seed=9,
                  checkpoint_dir=str(tmp_path)).acquire(name)
    fresh = ModelHost(device="cpu", seed=9).acquire(name)
    sa, sb, sf = a.state_dict(), b.state_dict(), fresh.state_dict()
    assert list(sb) == list(sa)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sf[k]) for k in sa)
