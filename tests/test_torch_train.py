"""The port's training path against the JAX package's (CPU).

- Kernel 1's plain version (``flash_attention_plain``), differentiated by
  autograd, and :class:`FlashAttentionFn` (the kernel's autograd function;
  on CPU tensors its plain forward and backward) against ``jax.vjp`` of
  the JAX package's attention, causal + key mask, at the backward
  kernel's card-test shapes cut to CPU size (head_dims 16, 64, 104 and
  128, GQA 2 and 4, a key tile masked whole): 1e-5 absolute (f32). A
  fully masked row: ``FlashAttentionFn``'s gradients equal autograd's of
  the plain version, zeros included. The bare launch refuses an input
  that requires grad.
- ``parallel/optim.adamw`` against ``optax.adamw(1e-3)`` on identical
  gradients (params, moments and count after each in-place step): 1e-6.
- ``parallel/train.causal_lm_loss`` and its gradients on llama_tiny and
  moe_tiny against ``jax.value_and_grad(train.causal_lm_loss)``: loss
  1e-5 relative, every gradient leaf within 1e-4 of its largest entry.
- Train steps: the port's losses over 3 steps against the JAX package's
  ``make_train_step`` (one device), and on gloo CPU worlds, dp x sp
  (2 x 2: ring attention, batch rows), sp x tp (2 x 2: ring attention,
  TP collectives), moe_tiny over sp x ep (2 x 2: routing over the whole
  sequence), llama_tiny at tp 4 (its kv heads replicate while q is cut)
  and a 6 q / 3 kv head variant at tp 2 (query groups straddle the
  ranks): the one-step loss and the gradients merged from every rank's
  slice against JAX's (1e-4 of each leaf's largest entry), and the
  3-step losses against the JAX step's. Each world is spawned once for
  the module, on first use.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.ops import attention as j_attn
from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
from ray_dynamic_batching_tpu.parallel import train as j_train
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import (
    params_from_flax,
    train_state_from_flax,
)
from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh
from ray_dynamic_batching_tpu_torch.parallel import optim
from ray_dynamic_batching_tpu_torch.parallel import train as t_train

from tests import torch_ranks

torch.set_num_threads(2)

B, T = 4, 32
#: A TINY_LM whose 6 query heads over 3 kv heads straddle a group
#: boundary at tp 2 (each rank's 3 query heads read kv heads 0,0,1 and
#: 1,2,2).
STRADDLE = dict(d_model=96, num_heads=6, num_kv_heads=3)
CFGS = {"llama_tiny": ("TINY_LM", j_lm.TINY_LM),
        "moe_tiny": ("TINY_MOE", j_lm.TINY_MOE),
        "llama_6q3kv": (dataclasses.replace(t_lm.TINY_LM, **STRADDLE),
                        dataclasses.replace(j_lm.TINY_LM, **STRADDLE))}
#: Mesh layouts of test_mesh_step_matches_jax: (model, mesh axes).
MESH_CASES = {
    "dp2_sp2": ("llama_tiny", (("dp", 2), ("sp", 2))),
    "sp2_tp2": ("llama_tiny", (("sp", 2), ("tp", 2))),
    # Routing with capacity over the whole sequence, experts over ep.
    "moe_sp2_ep2": ("moe_tiny", (("sp", 2), ("ep", 2))),
    # The two kv heads replicate while q is cut (kv_window).
    "tp4_kv_window": ("llama_tiny", (("tp", 4),)),
    # Query groups straddle the rank boundary (kv_index).
    "tp2_straddle": ("llama_6q3kv", (("tp", 2),)),
}


def _batch(seed: int = 0, V: int = 512):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 20:] = 0
    mask[3, 9:] = 0
    return tok, mask


@pytest.fixture(scope="module")
def lms():
    out = {}
    for name, (tcfg, cfg) in CFGS.items():
        jm = j_lm.CausalLM(cfg, name=name, dtype=jnp.float32)
        params = jax.tree_util.tree_map(np.asarray,
                                        jm.init(jax.random.PRNGKey(0)))
        tcfg = getattr(t_lm, tcfg) if isinstance(tcfg, str) else tcfg
        tm = t_lm.CausalLM(tcfg, name=name,
                           dtype=torch.float32, device="cpu", seed=None)
        tm.module.load_state_dict(params_from_flax(params, tm.cfg))
        out[name] = (jm, params, tm)
    return out


class _Lazy(dict):
    """A dict whose missing entries ``make(key)`` fills once."""

    def __init__(self, make):
        super().__init__()
        self._make = make

    def __missing__(self, key):
        self[key] = value = self._make(key)
        return value


@pytest.fixture(scope="module")
def jax_steps(lms):
    """The JAX package's one-device results for a model, on first use:
    loss and grads (port names) of the first batch, and the losses of 3
    steps."""
    def run(name):
        jm, params, tm = lms[name]
        tok, mask = _batch()
        loss, grads = jax.value_and_grad(lambda p: j_train.causal_lm_loss(
            jm, p, jnp.asarray(tok), jnp.asarray(mask)))(params)
        mesh = j_mesh.single_device_mesh()
        tx = optax.adamw(1e-3)
        step = j_train.make_train_step(jm, mesh, tx)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        s = tx.init(p)
        losses = []
        for _ in range(3):
            p, s, l = step(p, s, jnp.asarray(tok), jnp.asarray(mask))
            losses.append(float(l))
        return float(loss), params_from_flax(
            jax.tree_util.tree_map(np.asarray, grads), tm.cfg), losses

    return _Lazy(run)


@pytest.fixture(scope="module")
def jax_step(jax_steps):
    return jax_steps["llama_tiny"]


@pytest.fixture(scope="module")
def worlds():
    """A gloo world of CPU ranks per mesh layout, spawned on first use."""
    def build(axes):
        cfg = t_mesh.MeshConfig(**dict(axes))
        return t_mesh.build_mesh(cfg, ["cpu"] * cfg.n_devices)

    built = _Lazy(build)
    try:
        yield built
    finally:
        for mesh in built.values():
            mesh.shutdown()


def _rel(got: dict, want: dict) -> float:
    return max((got[n] - want[n]).abs().max().item()
               / max(want[n].abs().max().item(), 1e-12) for n in want)


def _merge(per_rank, shapes) -> dict:
    """Whole gradients from every rank's slices (``train_grads``; a
    pipeline rank holds its stage's leaves only)."""
    out = {}
    for n, shape in shapes.items():
        full = torch.full(shape, float("nan"))
        for rank in per_rank:
            if n not in rank:
                continue
            g, cuts = rank[n]
            view = full
            for dim, parts, index in cuts:
                m = view.shape[dim] // parts
                view = view.narrow(dim, index * m, m)
            view.copy_(torch.from_numpy(g))
        out[n] = full
    return out


# --- kernel 1's gradient ------------------------------------------------------
def _attn_inputs(seed, B_=2, T_=40, N=4, K=2, H=16, void=None):
    """Seeded q, k, v, dO and a key mask with batch row 1 padded from key
    29; ``void`` (a slice) masks those keys of batch row 0 as well."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B_, T_, N, H)).astype(np.float32)
    k = rng.standard_normal((B_, T_, K, H)).astype(np.float32)
    v = rng.standard_normal((B_, T_, K, H)).astype(np.float32)
    dout = rng.standard_normal((B_, T_, N, H)).astype(np.float32)
    tm = np.ones((B_, T_), bool)
    tm[1, 29:] = False
    if void is not None:
        tm[0, void] = False
    return q, k, v, dout, tm


# The backward kernel's card-test shapes (tests/test_torch_cuda.py), cut
# to CPU size: (T, N, K, H, keys voided in batch row 0).
ATTN_GRAD_SHAPES = {
    "t40_h16": (40, 4, 2, 16, None),
    "gqa4_t80_h64": (80, 8, 2, 64, None),
    "void_tile_t96_h128": (96, 4, 2, 128, slice(64, 96)),
    "h104": (48, 4, 2, 104, None),
}


@pytest.mark.parametrize("shape", list(ATTN_GRAD_SHAPES))
@pytest.mark.parametrize("route", ["plain_autograd", "flash_fn"])
def test_attention_grads_match_jax(route, shape):
    T_, N, K, H, void = ATTN_GRAD_SHAPES[shape]
    q, k, v, dout, tm = _attn_inputs(0, T_=T_, N=N, K=K, H=H, void=void)

    def f(q, k, v):
        return j_attn.self_attention(q, k, v, jnp.asarray(tm), causal=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(out)] + [np.asarray(g)
                                for g in vjp(jnp.asarray(dout))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    mask = torch.from_numpy(tm)[:, None, None, :]
    if route == "plain_autograd":
        o = fl.flash_attention_plain(tq, tk, tv, fl.keep_mask(
            mask, *q.shape[:2], q.shape[1]), causal=True)
    else:
        o = fl.flash_attention(tq, tk, tv, causal=True, mask=mask)
        assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = [o] + list(torch.autograd.grad(o, (tq, tk, tv),
                                         torch.from_numpy(dout)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fn_fully_masked_rows_match_autograd(dtype):
    q, k, v, dout, tm = _attn_inputs(1, T_=48, N=4, K=4)
    tm[0, :3] = False       # rows 0..2 of batch row 0 attend nothing
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True)
                  for x in (q, k, v))
    mask = torch.from_numpy(tm)[:, None, None, :]
    d = torch.from_numpy(dout).to(dtype)
    o = fl.flash_attention(tq, tk, tv, causal=True, mask=mask)
    got = torch.autograd.grad(o, (tq, tk, tv), d)
    o2 = fl.flash_attention_plain(tq, tk, tv, fl.keep_mask(mask, 2, 48, 48),
                                  causal=True)
    want = torch.autograd.grad(o2, (tq, tk, tv), d)
    assert torch.equal(o, o2)
    assert not got[0][0, :3].any() and not want[0][0, :3].any()
    tol = 1e-5 if dtype == torch.float32 else 6e-2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)


def test_bare_launch_refuses_an_input_that_requires_grad():
    q = torch.zeros((1, 16, 2, 16), requires_grad=True)
    k = torch.zeros((1, 16, 2, 16))
    with pytest.raises(RuntimeError, match="requires grad"):
        fl._launch(q, k, k, None, causal=True, scale=0.25)
    with torch.no_grad():   # no graph: nothing to cut
        with pytest.raises(Exception) as e:
            fl._launch(q, k, k, None, causal=True, scale=0.25)
        assert "requires grad" not in str(e.value)


# --- the optimizer --------------------------------------------------------------
def test_adamw_matches_optax_on_identical_gradients():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal((4,)).astype(np.float32)}
    tx = optax.adamw(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = tx.init(jp)
    o = optim.adamw(1e-3)
    assert (o.b1, o.b2, o.eps, o.eps_root, o.weight_decay) == (
        0.9, 0.999, 1e-8, 0.0, 1e-4)
    tp2 = {k: torch.tensor(v) for k, v in p0.items()}
    ts2 = o.init(tp2)
    for i in range(4):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** -i).astype(
            np.float32) for k, v in p0.items()}
        u, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        o.apply_(tp2, {k: torch.tensor(v) for k, v in g.items()}, ts2)
        for k in p0:
            np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6)
            np.testing.assert_allclose(ts2[0].mu[k].numpy(),
                                       np.asarray(js[0].mu[k]), atol=1e-7)
            np.testing.assert_allclose(ts2[0].nu[k].numpy(),
                                       np.asarray(js[0].nu[k]), atol=1e-9)
    assert int(ts2[0].count) == int(js[0].count) == 4


# --- one device ---------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_and_grads_match_jax(lms, name):
    jm, params, tm = lms[name]
    tok, mask = _batch()
    jl, jg = jax.value_and_grad(lambda p: j_train.causal_lm_loss(
        jm, p, jnp.asarray(tok), jnp.asarray(mask)))(params)
    tp, _ = train_state_from_flax(params, None, tm.cfg)
    for p in tp.values():
        p.requires_grad_(True)
    loss = t_train.causal_lm_loss(tm, tp, torch.from_numpy(tok),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss2, grads = t_train.loss_and_grads(tm, None, tp, tok, mask)
    np.testing.assert_allclose(float(loss2), float(jl), rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jg), tm.cfg)
    assert grads.keys() == want.keys()
    assert _rel(grads, want) < 1e-4


def test_three_steps_match_the_jax_step(lms, jax_step):
    _jm, params, tm = lms["llama_tiny"]
    tok, mask = _batch()
    opt = optim.adamw(1e-3)
    tp, ts = t_train.make_sharded_train_state(tm, None, opt, params={
        n: t for n, t in train_state_from_flax(params, None, tm.cfg)[0]
        .items()})
    step = t_train.make_train_step(tm, None, opt)
    losses = []
    for _ in range(3):
        tp, ts, loss = step(tp, ts, tok, mask)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_step[2], rtol=1e-5)
    assert losses[2] < losses[0]


# --- meshes -------------------------------------------------------------------
@pytest.mark.timeout(150)
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_step_matches_jax(lms, jax_steps, worlds, case):
    name, axes = MESH_CASES[case]
    _jm, params, whole = lms[name]
    jax_step = jax_steps[name]
    mesh = worlds[axes]
    tok, mask = _batch()
    tm = t_lm.CausalLM(whole.cfg, name=name, dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(params, tm.cfg))
    opt = optim.adamw(1e-3)
    tp, ts = t_train.make_sharded_train_state(tm, mesh, opt)
    key = t_train._find_key(mesh, tp)
    loss, _ = t_train.loss_and_grads(tm, mesh, tp, tok, mask)
    np.testing.assert_allclose(float(loss), jax_step[0], rtol=1e-5)
    merged = _merge(mesh.world.call(torch_ranks.train_grads, key),
                    {n: tuple(g.shape) for n, g in jax_step[1].items()})
    assert _rel(merged, jax_step[1]) < 1e-4
    step = t_train.make_train_step(tm, mesh, opt)
    losses = []
    for _ in range(3):
        tp, ts, loss = step(tp, ts, tok, mask)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_step[2], rtol=1e-5)


def test_mesh_refusals():
    """What the reference also refuses: a batch whose rows do not split
    over dp, a sequence that does not split over sp (its shardings would
    not divide the arrays)."""
    mesh = t_mesh.Mesh({"dp": 2, "sp": 2}, ["cpu"] * 4, rank=3)
    with pytest.raises(ValueError, match="dp=2"):
        t_mesh.batch_sharding(mesh, 3)
    with pytest.raises(ValueError, match="sp=2"):
        t_mesh.seq_sharding(mesh, 31)
    assert t_mesh.batch_sharding(mesh, 4) == slice(2, 4)
    assert t_mesh.seq_sharding(mesh, 32) == slice(16, 32)
