"""Sharded training step for causal LMs, over torch.distributed ranks.

Port of ``ray_dynamic_batching_tpu/parallel/train.py:34-100``. The
reference jits one optax step over a dp x sp x tp mesh and lets GSPMD
insert the collectives; here every rank of the mesh runs the same step in
lockstep (``parallel/spmd.World.call``) on the same host inputs, and the
collectives are written out:

- **The train state.** Params are f32 tensors keyed by the port's
  parameter names (a rank's slices under the model's TP / EP rules,
  ``parallel/mesh.py::shard_plan``), trainable leaves; the optimizer state
  is ``parallel/optim.py``'s (optax's tree). The forward runs the model's
  own module through ``torch.func.functional_call`` with each param cast
  to that module leaf's dtype: f32 masters, compute in the model's dtype
  (bf16: the reference's ``param_dtype=f32``, ``dtype=bf16``).
- **The data.** A rank takes the batch rows of its ``dp`` index and the
  sequence chunk of its ``sp`` index (``mesh.batch_sharding`` /
  ``seq_sharding``), at global positions; with sp > 1 the attention is
  ring attention over the ``sp`` group (``ops/attention.sequence_parallel``).
- **The loss** (:func:`causal_lm_loss`) is the reference's: next-token
  cross entropy over ``attn_mask[:, 1:]``, divided by the weight count,
  plus ``MOE_AUX_COEF`` times the MoE load-balance loss. On a mesh each
  rank adds its share: the shift crosses sp chunks (a chunk's last
  position predicts the next chunk's first token, read from the whole
  host batch every rank holds), the weight count is the GLOBAL one
  (all-reduced over dp x sp first, so ranks with fewer valid tokens are
  not over-weighted), and the aux loss, a mean over batch rows, counts
  ``1 / dp`` a dp rank and ``1 / sp`` an sp rank (a MoE layer routes the
  whole sequence on every sp rank, ``models/moe.py``). Summing the ranks'
  shares is the reference's loss.
- **The gradients.** ``backward`` runs through the autograd-aware TP/EP
  collectives (``parallel/collective.py``) and, with sp > 1, ring
  attention's backward and the MoE layers' sequence gathers; each
  gradient is then summed over the dp x sp group (``mesh.data``). Where
  the kv heads replicate over tp while q is cut (``kv_window``), a rank's
  gradient of the k/v projections covers only the kv heads its query
  heads read: those are summed over the ``tp`` group first, so every rank
  holds the reference's gradient. AdamW updates each rank's slices in
  place.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_dynamic_batching_tpu_torch.ops import attention as attn_ops

MOE_AUX_COEF = 0.01  # load-balance loss weight (GShard-style)

Params = Dict[str, torch.Tensor]


def _cast(model, params: Params) -> Params:
    """Each param in its module leaf's dtype (a differentiable cast; an f32
    leaf passes as it is)."""
    own = dict(model.module.named_parameters())
    return {n: p if p.dtype == own[n].dtype else p.to(own[n].dtype)
            for n, p in params.items()}


def forward(model, params: Params, tokens: torch.Tensor,
            attn_mask: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """(logits [B, T, V], aux) of ``model``'s module with ``params`` in place
    of its own weights (``positions`` default ``arange(T)``)."""
    if positions is None:
        positions = model._positions(tokens)
    return torch.func.functional_call(
        model.module, _cast(model, params), (tokens, positions, None),
        {"token_mask": attn_mask, "return_aux": True})


def _ce_sum(logits: torch.Tensor, targets: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """Sum of the weighted next-token cross entropies, in f32 (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    V = logits.shape[-1]
    ce = F.cross_entropy(logits.float().reshape(-1, V),
                         targets.reshape(-1).long(), reduction="none")
    return (ce.view_as(weights) * weights).sum()


def causal_lm_loss(model, params: Params, tokens: torch.Tensor,
                   attn_mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy ignoring padding, plus ``MOE_AUX_COEF`` x
    the MoE load-balance loss (reference ``train.py:34-47``), on one
    device."""
    logits, aux = forward(model, params, tokens, attn_mask)
    weights = attn_mask[:, 1:].float()
    ce = _ce_sum(logits[:, :-1], tokens[:, 1:], weights)
    return ce / torch.clamp(weights.sum(), min=1.0) + MOE_AUX_COEF * aux


def _as_tensor(x: Any, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


def rank_loss(model, mesh, params: Params, tokens: torch.Tensor,
              attn_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(this rank's share of the loss, the global loss's weight count):
    its dp rows and sp chunk of the whole host batch (see the module
    docstring). The shares of every rank of the mesh's data group sum to
    :func:`causal_lm_loss` of the whole batch."""
    from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod
    from ray_dynamic_batching_tpu_torch.parallel.collective import (
        pg_allreduce,
    )

    B, T = tokens.shape
    rows = mesh_mod.batch_sharding(mesh, B)
    cols = mesh_mod.seq_sharding(mesh, T)
    tok, am = tokens[rows], attn_mask[rows]
    dev = tok.device
    positions = torch.arange(cols.start, cols.stop, device=dev)[None, :] \
        .expand(tok.shape[0], -1)
    with attn_ops.sequence_parallel(mesh):
        logits, aux = forward(model, params, tok[:, cols], am[:, cols],
                              positions)
    nxt = torch.arange(cols.start + 1, cols.stop + 1, device=dev)
    inside = (nxt < T).float()
    nxt = torch.clamp(nxt, max=T - 1)
    weights = am[:, nxt].float() * inside
    ce = _ce_sum(logits, tok[:, nxt], weights)
    count = weights.sum().detach().clone()
    if mesh.data is not None:
        pg_allreduce(mesh.data.group, count, "sum")
    count = torch.clamp(count, min=1.0)
    share = mesh.shape["dp"] * mesh.shape["sp"]
    return (ce / count + MOE_AUX_COEF * aux / share), count


def rank_grads(model, mesh, params: Params, tokens, attn_mask
               ) -> Tuple[torch.Tensor, Params]:
    """(the global loss, this rank's gradients summed over dp x sp) for
    one batch; ``tokens`` / ``attn_mask`` the whole host batch."""
    from ray_dynamic_batching_tpu_torch.parallel.collective import (
        pg_allreduce,
    )

    dev = next(iter(params.values())).device
    tokens = _as_tensor(tokens, dev)
    attn_mask = _as_tensor(attn_mask, dev)
    for p in params.values():
        p.grad = None
    with torch.enable_grad():
        loss, _ = rank_loss(model, mesh, params, tokens, attn_mask)
        loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    total = loss.detach().clone()
    shard = getattr(model, "tp_shard", None)
    if shard is not None and shard.kv_window:
        for n in _replicated_kv(grads):
            pg_allreduce(mesh.tp.group, grads[n], "sum")
    if mesh.data is not None:
        for g in grads.values():
            pg_allreduce(mesh.data.group, g, "sum")
        pg_allreduce(mesh.data.group, total, "sum")
    return total, grads


def _replicated_kv(grads: Params):
    """The k/v projection leaves (weights and biases) of ``grads``: whole
    on every rank of a ``kv_window`` layout, each rank's gradient partial."""
    return [n for n in grads
            if re.fullmatch(r"layers\.\d+\.[kv]\.(weight|bias)", n)]


# --- the train state ------------------------------------------------------

def _leaves(model) -> Params:
    """The f32 params of a rank's model, from its own weights: an f32 leaf
    is the very tensor, so the module and the state share it."""
    return {n: (p.detach() if p.dtype == torch.float32
                else p.detach().float()).requires_grad_(True)
            for n, p in model.module.named_parameters()}


def _plan(model):
    from ray_dynamic_batching_tpu_torch.parallel.mesh import shard_plan

    return shard_plan(model.tp_shard.mesh, model)


def _slices(model, full: Dict[str, Any], device) -> Params:
    """This rank's f32 slice of each whole leaf of ``full`` (port names)."""
    plan = _plan(model) if getattr(model, "tp_shard", None) else {}
    out = {}
    for n, x in full.items():
        t = _as_tensor(x, "cpu").float()
        if n in plan:
            t = plan[n].take(t)
        out[n] = t.contiguous().to(device)
    return out


def _state_body(ctx, seq, key: str, optimizer, start, moments) -> Tuple:
    """Every rank's half of :func:`make_sharded_train_state`."""
    model = ctx.objects[key]
    ctx.objects[(key, "train")] = _new_state(model, optimizer, start,
                                             ctx.mesh.device, moments)
    return None


def _new_state(model, optimizer, start, device, moments=None):
    if start is None:
        params = _leaves(model)
    else:
        params = {n: t.requires_grad_(True)
                  for n, t in _slices(model, start, device).items()}
    state = optimizer.init(params)
    if moments is not None:
        # A whole optimizer state (a restored checkpoint's): this rank's
        # slice of each moment, cut as its param is.
        count, mu, nu = moments
        adam = state[0]
        adam.count.fill_(int(count))
        for mine, whole in ((adam.mu, mu), (adam.nu, nu)):
            for n, t in _slices(model, whole, device).items():
                mine[n].copy_(t)
    return params, state


def _whole_moments(opt_state) -> Optional[tuple]:
    """(count, mu, nu) of a whole optimizer state as host numbers."""
    if opt_state is None:
        return None
    adam = opt_state[0]
    host = lambda tree: {n: _as_tensor(x, "cpu").detach().float().numpy()
                         for n, x in tree.items()}
    return int(_as_tensor(adam.count, "cpu")), host(adam.mu), host(adam.nu)


def _key_of(model) -> Optional[str]:
    shard = getattr(model, "tp_shard", None)
    return shard.key if shard is not None else None


def make_sharded_train_state(model, mesh, optimizer,
                             params: Optional[Dict[str, Any]] = None,
                             opt_state: Any = None
                             ) -> Tuple[Params, Any]:
    """(params, opt_state) of rank 0; every rank holds its own (reference
    ``train.py:50-62``). ``model`` is rank 0's shard of a model on the mesh
    (``parallel/mesh.py::build_sharded_model`` / ``shard_params``), or an
    unsharded model that is sharded here from rank 0's weights. The params
    start from the model's weights in f32 (the reference's ``rng``: a port
    model draws its weights from its own seed), or from ``params`` (whole
    leaves keyed by port names, e.g.
    ``models/convert.train_state_from_flax``'s or a restored checkpoint's);
    ``opt_state``, a whole AdamW state beside them, is cut the same way
    (else the moments start at zero)."""
    from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod

    moments = _whole_moments(opt_state)
    if mesh is None or mesh.size == 1:
        return _new_state(model, optimizer, params, model.device, moments)
    if _key_of(model) is None:
        model = mesh_mod.shard_params(mesh, model)
    key = _key_of(model)
    start = None if params is None else {
        n: _as_tensor(x, "cpu").detach().float().numpy()
        for n, x in params.items()}
    mesh.world.call(_state_body, key, optimizer, start, moments)
    return mesh.world.ctx.objects[(key, "train")]


def _gather_body(ctx, seq, key: str, moments: bool):
    """Every rank's half of :func:`gather_train_state`. Which ranks hold
    which slice of each leaf follows from every rank's plan (and, on a
    pipeline, from the leaves each rank's state holds, all-gathered once);
    the lowest rank holding each distinct slice sends it to rank 0 (in
    leaf order, on the world's group), which puts it in place along that
    rank's cuts. Replicas (dp, sp, the copies of an uncut leaf) send
    nothing. Returns rank 0's whole trees (host f32) and the step count,
    None elsewhere."""
    from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod
    from ray_dynamic_batching_tpu_torch.parallel.collective import (
        pg_allgather,
        pg_recv,
        pg_send,
    )

    mesh, dev = ctx.mesh, ctx.mesh.device
    stage = mesh.backend == "gloo" and dev.type == "cuda"
    model = ctx.objects[key]
    params, opt_state = ctx.objects[(key, "train")]
    local = dict(model.module.named_parameters())
    whole = dict(mesh_mod._twin(mesh_mod._recipe(model), torch.device("meta"))
                 .module.named_parameters())
    names = sorted(local)
    held = pg_allgather(mesh.group, torch.tensor(
        [n in params for n in names], dtype=torch.int32, device=dev),
        mesh.size).cpu()
    plans = [mesh_mod.shard_plan(mesh_mod.Mesh(mesh.shape, mesh.devices, r),
                                 model) for r in range(mesh.size)]
    trees = [params] + ([opt_state[0].mu, opt_state[0].nu] if moments
                        else [])
    out: list = [{} for _ in trees]
    for i, n in enumerate(names):
        senders: Dict[tuple, int] = {}
        for r in range(mesh.size):
            cuts = tuple((c.dim, c.parts, c.index) for c in plans[r][n].cuts())
            if held[r, i] and cuts not in senders:
                senders[cuts] = r
        if ctx.rank != 0:
            if ctx.rank in senders.values():
                for tree in trees:
                    pg_send(mesh.group, tree[n].detach().float(), 0, stage)
            continue
        fulls = [torch.empty(whole[n].shape, dtype=torch.float32)
                 for _ in trees]
        for cuts, r in senders.items():
            for tree, full in zip(trees, fulls):
                part = (tree[n].detach().float() if r == 0 else pg_recv(
                    mesh.group, torch.empty(local[n].shape,
                                            dtype=torch.float32, device=dev),
                    r, stage))
                view = full
                for dim, parts, index in cuts:
                    m = view.shape[dim] // parts
                    view = view.narrow(dim, index * m, m)
                view.copy_(part)
        for full, dst in zip(fulls, out):
            if senders:
                dst[n] = full
    if ctx.rank != 0:
        return None
    count = int(opt_state[0].count) if moments else None
    return out, count


def gather_train_state(model, params: Params, opt_state: Any = None):
    """(a whole twin of ``model`` on the meta device, whole params,
    whole opt_state or None) of the mesh train state whose rank-0 params
    are ``params``: every leaf gathered from the ranks' slices along the
    axes ``parallel/mesh.py``'s plan cut, the AdamW moments the same way,
    on rank 0's host (f32). What a whole checkpoint of a sharded train
    state saves (``runtime/checkpoint.save_train_state``)."""
    from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod
    from ray_dynamic_batching_tpu_torch.parallel.optim import (
        EmptyState,
        ScaleByAdamState,
    )

    mesh = model.tp_shard.mesh
    key = _find_key(mesh, params)
    trees, count = mesh.world.call(_gather_body, key,
                                   opt_state is not None)[0]
    twin = mesh_mod._twin(mesh_mod._recipe(model), torch.device("meta"))
    state = None
    if opt_state is not None:
        state = (ScaleByAdamState(torch.tensor(count, dtype=torch.int32),
                                  trees[1], trees[2]),
                 EmptyState(), EmptyState())
    return twin, trees[0], state


def _find_key(mesh, params: Params) -> str:
    """The model key whose rank-0 train state holds ``params``."""
    for k, v in mesh.world.ctx.objects.items():
        if isinstance(k, tuple) and k[1:] == ("train",) and v[0] is params:
            return k[0]
    raise ValueError("these params are not a train state of this mesh "
                     "(make_sharded_train_state)")


def _grads_body(ctx, seq, key: str, tokens, attn_mask) -> float:
    model = ctx.objects[key]
    params, _ = ctx.objects[(key, "train")]
    loss, grads = rank_grads(model, ctx.mesh, params, tokens, attn_mask)
    ctx.objects[(key, "grads")] = grads
    return float(loss)


def _step_body(ctx, seq, key: str, optimizer, tokens, attn_mask) -> float:
    params, opt_state = ctx.objects[(key, "train")]
    loss = _grads_body(ctx, seq, key, tokens, attn_mask)
    optimizer.apply_(params, ctx.objects.pop((key, "grads")), opt_state)
    return loss


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def loss_and_grads(model, mesh, params: Params, tokens, attn_mask
                   ) -> Tuple[torch.Tensor, Params]:
    """(global loss, rank 0's gradients) of one batch with no update; on a
    mesh every rank keeps its own gradients under ``(key, "grads")`` for
    rank-side checks."""
    if mesh is None or mesh.size == 1:
        from ray_dynamic_batching_tpu_torch.parallel.mesh import (
            single_device_mesh,
        )

        return rank_grads(model, mesh or single_device_mesh(model.device),
                          params, tokens, attn_mask)
    key = _find_key(mesh, params)
    losses = mesh.world.call(_grads_body, key, _host(tokens),
                             _host(attn_mask))
    return (torch.tensor(losses[0]),
            mesh.world.ctx.objects[(key, "grads")])


def make_train_step(model, mesh, optimizer) -> Callable:
    """``step(params, opt_state, tokens, attn_mask) -> (params, opt_state,
    loss)``, the reference's contract (``train.py:65-97``): gradients,
    their sum over dp x sp, and AdamW in place on every rank's slices.
    ``tokens`` / ``attn_mask`` are the whole host batch [B, T] (B divides
    by dp, T by sp); the loss is the global one (a 0-d tensor)."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import (
        single_device_mesh,
    )

    if mesh is None or mesh.size == 1:
        one = mesh or single_device_mesh(model.device)

        def step(params, opt_state, tokens, attn_mask):
            loss, grads = rank_grads(model, one, params, tokens, attn_mask)
            optimizer.apply_(params, grads, opt_state)
            return params, opt_state, loss

        return step

    def step(params, opt_state, tokens, attn_mask):
        key = _find_key(mesh, params)
        losses = mesh.world.call(_step_body, key, optimizer, _host(tokens),
                                 _host(attn_mask))
        return params, opt_state, torch.tensor(losses[0])

    return step
