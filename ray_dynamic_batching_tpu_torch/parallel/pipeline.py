"""Pipeline parallelism: GPipe microbatched stages over the ``pp`` axis.

Port of ``ray_dynamic_batching_tpu/parallel/pipeline.py:36-305``. The
reference runs one SPMD program whose ``shard_map`` is manual over ``pp``:
every device computes its stage for every tick of the GPipe schedule (M
microbatches, S stages, M + S - 1 ticks, idle ticks on garbage) and the
activations hop with ``ppermute``. Here each rank is a process and the
schedule is written out (:func:`pp_rank_grads`):

- **Stages.** Stage ``s`` (the rank's ``pp`` index) holds layers
  ``[s L / S, (s + 1) L / S)``; the embedding runs on stage 0 and the final
  norm and head on stage S - 1 (the reference keeps them outside the
  stages, replicated; the port computes each where its input is). A rank's
  train state holds its stage's layers and the outer params; within a
  stage the layers keep their tp / ep layout (``parallel/mesh.py``).
- **Forward.** For each microbatch in order, stage 0 embeds, every stage
  runs its layers on what it received from stage s - 1 (a send / receive
  of ``[mb, T, D]`` on the ``pp`` group) and sends the result on; the last
  stage keeps the outputs. Each stage runs only its active ticks: the
  reference's idle ticks change nothing it keeps.
- **Backward, in reverse.** The last stage runs the head and the loss,
  then for microbatch M - 1 .. 0 every stage back-propagates its layers
  from the output gradient it received from stage s + 1 and sends its
  input's gradient to stage s - 1; stage 0 finishes through the
  embedding. The outer params' gradients are summed over ``pp`` (each is
  used on one stage), then every gradient over dp.
- **The aux loss** is the reference's (``:237-250``): each stage's layers'
  MoE load-balance loss of each microbatch it ran, summed over stages and
  divided by M (and a dp rank's share is ``1 / dp`` of the mean).
- :class:`PipelinedCausalLM` keeps the reference's API:
  ``split_params`` / ``merge_params`` in the flax layout (``{"outer":
  ..., "layers": stacked [L, ...]}``, for checkpoints), ``apply`` /
  ``apply_with_aux`` (the logits gathered back to rank 0), and
  :func:`make_pp_train_state` / :func:`make_pp_train_step`.

Collectives and point-to-point ops run on the mesh's groups; gloo stages
CUDA tensors through the host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.parallel import train as train_mod

Params = Dict[str, torch.Tensor]

_OUTER = ("tok_embed.", "pos_embed.", "final_norm.", "lm_head.")


def stage_layers(cfg, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``n_stages`` holds."""
    per = cfg.num_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def _layer_of(name: str) -> Optional[int]:
    if name.startswith("layers."):
        return int(name.split(".")[1])
    return None


def _stage_names(names, cfg, n_stages: int, stage: int) -> List[str]:
    """A stage's params: its layers' and the outer ones."""
    mine = set(stage_layers(cfg, n_stages, stage))
    return [n for n in names
            if n.startswith(_OUTER) or _layer_of(n) in mine]


def _stage(mesh) -> Tuple[int, int]:
    return mesh.shape["pp"], mesh.axis_index("pp")


class _Stages:
    """A rank's side of the schedule: its stage, its pp group, its data
    rows and microbatches."""

    def __init__(self, model, mesh, tokens, attn_mask, n_micro: int):
        from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod

        self.model, self.mesh = model, mesh
        self.S, self.s = _stage(mesh)
        self.M = n_micro
        rows = mesh_mod.batch_sharding(mesh, tokens.shape[0])
        self.tok, self.am = tokens[rows], attn_mask[rows]
        B, T = self.tok.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible into {n_micro} "
                             "microbatches")
        self.mb = B // n_micro
        self.positions = torch.arange(T, device=self.tok.device)[None, :] \
            .expand(self.mb, T)
        self.layers = stage_layers(model.cfg, self.S, self.s)
        self.stage = mesh.backend == "gloo" and self.tok.is_cuda
        self.pp = mesh.pp

    @property
    def first(self) -> bool:
        return self.s == 0

    @property
    def last(self) -> bool:
        return self.s == self.S - 1

    def micro(self, k: int):
        sl = slice(k * self.mb, (k + 1) * self.mb)
        return self.tok[sl], self.am[sl]

    def run(self, x: torch.Tensor, k: int):
        """This stage's layers on microbatch k: (x, summed aux)."""
        from ray_dynamic_batching_tpu_torch.models.decoder import rope_tables
        from ray_dynamic_batching_tpu_torch.ops import attention as attn_ops

        module, cfg = self.model.module, self.model.cfg
        _, tm = self.micro(k)
        rope = (rope_tables(self.positions, cfg.head_dim, cfg.rope_theta)
                if cfg.pos == "rope" else None)
        keep = attn_ops.kernel_mask(tm[:, None, None, :].bool(), *tm.shape)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in self.layers:
            x, a = module.layers[i](x, self.positions, keep, None,
                                    layer_idx=i, rope=rope, token_mask=tm,
                                    return_aux=True)
            if a is not None:
                aux = aux + a
        return x, aux

    def like(self) -> torch.Tensor:
        cfg = self.model.cfg
        return torch.empty((self.mb, self.tok.shape[1], cfg.d_model),
                           dtype=self.model.dtype, device=self.tok.device)

    def send(self, x: torch.Tensor, to: int) -> None:
        from ray_dynamic_batching_tpu_torch.parallel.collective import pg_send

        pg_send(self.pp.group, x, to, self.stage)

    def recv(self, frm: int) -> torch.Tensor:
        from ray_dynamic_batching_tpu_torch.parallel.collective import pg_recv

        return pg_recv(self.pp.group, self.like(), frm, self.stage)

    def forward(self, grad: bool):
        """The schedule's forward: (stage inputs, outputs, aux per
        microbatch, the embedding output on stage 0)."""
        inputs, outputs, auxes = [], [], []
        x_all = None
        if self.first:
            x_all = self.model.module.embed_tokens(
                self.tok, self.positions[:1].expand(self.tok.shape[0], -1))
        for k in range(self.M):
            if self.first:
                x = x_all[k * self.mb:(k + 1) * self.mb]
                if grad:
                    x = x.detach().requires_grad_(True)
            else:
                x = self.recv(self.s - 1)
                if grad:
                    x.requires_grad_(True)
            out, aux = self.run(x, k)
            if not self.last:
                self.send(out, self.s + 1)
            inputs.append(x)
            outputs.append(out)
            auxes.append(aux)
        return inputs, outputs, auxes, x_all


def _reduce(group, t: torch.Tensor) -> None:
    from ray_dynamic_batching_tpu_torch.parallel.collective import (
        pg_allreduce,
    )

    if group is not None:
        pg_allreduce(group.group, t, "sum")


def pp_rank_grads(model, mesh, params: Params, tokens, attn_mask,
                  n_micro: int) -> Tuple[torch.Tensor, Params]:
    """(the global loss, this rank's gradients) of one GPipe step (see the
    module docstring); ``params`` the rank's stage params (f32)."""
    from torch.nn.utils.stateless import _reparametrize_module

    dev = next(iter(params.values())).device
    tokens = train_mod._as_tensor(tokens, dev)
    attn_mask = train_mod._as_tensor(attn_mask, dev)
    aux_w = train_mod.MOE_AUX_COEF / (n_micro * mesh.shape["dp"])
    for p in params.values():
        p.grad = None
    with torch.enable_grad(), _reparametrize_module(
            model.module, train_mod._cast(model, params)):
        st = _Stages(model, mesh, tokens, attn_mask, n_micro)
        inputs, outputs, auxes, x_all = st.forward(grad=True)
        local = torch.zeros((), dtype=torch.float32, device=dev)
        dys: List[Optional[torch.Tensor]] = [None] * n_micro
        if st.last:
            ys = [o.detach().requires_grad_(True) for o in outputs]
            logits = model.module.logits_of(torch.cat(ys))
            weights = st.am[:, 1:].float()
            ce = train_mod._ce_sum(logits[:, :-1], st.tok[:, 1:], weights)
            count = weights.sum().detach().clone()
            _reduce(mesh.dp, count)
            ce = ce / torch.clamp(count, min=1.0)
            ce.backward()
            local = local + ce.detach()
            dys = [y.grad for y in ys]
        for k in reversed(range(n_micro)):
            dy = dys[k] if st.last else st.recv(st.s + 1)
            outs, grads = [outputs[k]], [dy]
            if auxes[k].requires_grad:
                outs.append(auxes[k])
                grads.append(torch.full_like(auxes[k], aux_w))
            torch.autograd.backward(outs, grads)
            if not st.first:
                st.send(inputs[k].grad, st.s - 1)
        if st.first:
            x_all.backward(torch.cat([x.grad for x in inputs]))
    local = local + aux_w * sum(a.detach() for a in auxes)
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    if getattr(model, "tp_shard", None) is not None and \
            model.tp_shard.kv_window:
        for n in train_mod._replicated_kv(grads):
            _reduce(mesh.tp, grads[n])
    for n, g in grads.items():
        if n.startswith(_OUTER):
            _reduce(mesh.pp, g)
        _reduce(mesh.dp, g)
    _reduce(mesh.pp, local)
    _reduce(mesh.dp, local)
    return local, grads


def pp_rank_forward(model, mesh, params: Params, tokens, attn_mask,
                    n_micro: int):
    """(logits of this rank's dp rows, aux) with no gradient: the stages'
    forward; the last stage's logits broadcast over ``pp``."""
    from torch.nn.utils.stateless import _reparametrize_module

    from ray_dynamic_batching_tpu_torch.parallel.collective import (
        pg_broadcast,
    )

    dev = next(iter(params.values())).device
    tokens = train_mod._as_tensor(tokens, dev)
    attn_mask = train_mod._as_tensor(attn_mask, dev)
    with torch.no_grad(), _reparametrize_module(
            model.module, train_mod._cast(model, params)):
        st = _Stages(model, mesh, tokens, attn_mask, n_micro)
        _, outputs, auxes, _ = st.forward(grad=False)
        B, T = st.tok.shape
        V = model.cfg.vocab_size
        if st.last:
            logits = model.module.logits_of(torch.cat(outputs)).float()
        else:
            logits = torch.empty((B, T, V), dtype=torch.float32, device=dev)
        if st.S > 1:
            pg_broadcast(mesh.pp.group, logits, st.S - 1)
        aux = sum(auxes) / n_micro
        _reduce(mesh.pp, aux)
    return logits, aux


class PipelinedCausalLM:
    """A CausalLM split into pipeline stages over the mesh's ``pp`` axis
    (reference ``pipeline.py:36``). ``model`` is rank 0's model on the mesh
    (a shard from ``parallel/mesh.py``, or an unsharded model that
    :func:`make_pp_train_state` shards from rank 0's weights)."""

    def __init__(self, model, mesh, n_microbatches: int = 2):
        cfg = model.cfg
        S = mesh.shape.get("pp", 1)
        if cfg.num_layers % max(S, 1) != 0:
            raise ValueError(
                f"{cfg.num_layers} layers not divisible into {S} stages")
        if mesh.shape.get("sp", 1) != 1:
            raise ValueError("pipeline stages require sp=1 (dense attention)")
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.n_stages = S
        self.n_microbatches = n_microbatches
        self.dtype = model.dtype

    # --- params (the flax layout, for checkpoints) -----------------------
    def split_params(self, full: Dict[str, Any]) -> Dict[str, Any]:
        """Flat flax params -> ``{"outer": ..., "layers": stacked [L]}``."""
        p = dict(full["params"])
        layers = [p.pop(f"layer{i}") for i in range(self.cfg.num_layers)]
        return {"outer": p, "layers": _stack(layers)}

    def merge_params(self, split: Dict[str, Any]) -> Dict[str, Any]:
        """Inverse of :meth:`split_params`."""
        p = dict(split["outer"])
        for i in range(self.cfg.num_layers):
            p[f"layer{i}"] = _index(split["layers"], i)
        return {"params": p}

    # --- forward ---------------------------------------------------------
    def apply(self, params: Params, tokens, attn_mask) -> torch.Tensor:
        return self.apply_with_aux(params, tokens, attn_mask)[0]

    def apply_with_aux(self, params: Params, tokens, attn_mask):
        """Pipelined forward of the whole batch [B, T] -> (logits
        [B, T, V] f32, aux), every rank running its stage; ``params`` is
        rank 0's train state (:func:`make_pp_train_state`)."""
        mesh = self.mesh
        if mesh.size == 1:
            return pp_rank_forward(self.model, mesh, params, tokens,
                                   attn_mask, self.n_microbatches)
        key = train_mod._find_key(mesh, params)
        outs = mesh.world.call(_forward_body, key, self.n_microbatches,
                               train_mod._host(tokens),
                               train_mod._host(attn_mask))
        # Each dp rank's rows, in dp order (rank 0 of each dp line).
        from ray_dynamic_batching_tpu_torch.parallel.spmd import coords_of

        rows = {}
        for r, (logits, aux) in enumerate(outs):
            c = coords_of(r, mesh.shape)
            rows.setdefault(c["dp"], (logits, aux))
        logits = np.concatenate([rows[d][0] for d in sorted(rows)])
        aux = float(np.mean([rows[d][1] for d in sorted(rows)]))
        return torch.from_numpy(logits), torch.tensor(aux)


def _stack(layers: List[Any]) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack([train_mod._as_tensor(l, "cpu") for l in layers])


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _forward_body(ctx, seq, key: str, n_micro: int, tokens, attn_mask):
    params, _ = ctx.objects[(key, "train")]
    logits, aux = pp_rank_forward(ctx.objects[key], ctx.mesh, params,
                                  tokens, attn_mask, n_micro)
    return logits.cpu().numpy(), float(aux)


def _pp_state_body(ctx, seq, key: str, optimizer, start) -> None:
    model = ctx.objects[key]
    params, _ = train_mod._new_state(model, optimizer, start,
                                     ctx.mesh.device)
    S, s = _stage(ctx.mesh)
    keep = _stage_names(list(params), model.cfg, S, s)
    params = {n: params[n] for n in keep}
    ctx.objects[(key, "train")] = (params, optimizer.init(params))


def _pp_grads_body(ctx, seq, key: str, n_micro: int, tokens, attn_mask
                   ) -> float:
    params, _ = ctx.objects[(key, "train")]
    loss, grads = pp_rank_grads(ctx.objects[key], ctx.mesh, params, tokens,
                                attn_mask, n_micro)
    ctx.objects[(key, "grads")] = grads
    return float(loss)


def _pp_step_body(ctx, seq, key: str, optimizer, n_micro: int, tokens,
                  attn_mask) -> float:
    params, opt_state = ctx.objects[(key, "train")]
    loss = _pp_grads_body(ctx, seq, key, n_micro, tokens, attn_mask)
    optimizer.apply_(params, ctx.objects.pop((key, "grads")), opt_state)
    return loss


def make_pp_train_state(pmodel: PipelinedCausalLM, optimizer,
                        params: Optional[Dict[str, Any]] = None):
    """(params, opt_state) of rank 0 (its stage's layers and the outer
    params); every rank holds its own (reference ``pipeline.py:296``)."""
    from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod

    mesh = pmodel.mesh
    if mesh.size == 1:
        return train_mod.make_sharded_train_state(pmodel.model, mesh,
                                                  optimizer, params)
    model = pmodel.model
    if train_mod._key_of(model) is None:
        model = mesh_mod.shard_params(mesh, model)
        pmodel.model = model
    key = train_mod._key_of(model)
    start = None if params is None else {
        n: train_mod._as_tensor(x, "cpu").float().numpy()
        for n, x in params.items()}
    mesh.world.call(_pp_state_body, key, optimizer, start)
    return mesh.world.ctx.objects[(key, "train")]


def pp_loss_and_grads(pmodel: PipelinedCausalLM, params: Params, tokens,
                      attn_mask) -> Tuple[torch.Tensor, Params]:
    """(global loss, rank 0's gradients) of one pipelined batch, no
    update; every rank keeps its gradients under ``(key, "grads")``."""
    mesh = pmodel.mesh
    if mesh.size == 1:
        return pp_rank_grads(pmodel.model, mesh, params, tokens, attn_mask,
                             pmodel.n_microbatches)
    key = train_mod._find_key(mesh, params)
    losses = mesh.world.call(_pp_grads_body, key, pmodel.n_microbatches,
                             train_mod._host(tokens),
                             train_mod._host(attn_mask))
    return (torch.tensor(losses[0]),
            mesh.world.ctx.objects[(key, "grads")])


def make_pp_train_step(pmodel: PipelinedCausalLM, optimizer) -> Callable:
    """``step(params, opt_state, tokens, attn_mask) -> (params, opt_state,
    loss)`` over the pipeline (reference ``pipeline.py:268``)."""
    mesh = pmodel.mesh

    def step(params, opt_state, tokens, attn_mask):
        if mesh.size == 1:
            loss, grads = pp_rank_grads(pmodel.model, mesh, params, tokens,
                                        attn_mask, pmodel.n_microbatches)
            optimizer.apply_(params, grads, opt_state)
            return params, opt_state, loss
        key = train_mod._find_key(mesh, params)
        losses = mesh.world.call(_pp_step_body, key, optimizer,
                                 pmodel.n_microbatches,
                                 train_mod._host(tokens),
                                 train_mod._host(attn_mask))
        return params, opt_state, torch.tensor(losses[0])

    return step
