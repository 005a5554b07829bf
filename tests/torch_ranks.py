"""What the tensor-parallel tests run on every rank of a gloo world.

Each function is ``fn(ctx, seq, *args)`` for
``parallel/spmd.World.call``: the leader and every spawned follower run
it on their own objects and the leader gathers the results. This module
imports the port only (no JAX), so the spawned ranks stay light.
"""

from __future__ import annotations

import numpy as np
import torch


def shard_state(ctx, seq, key):
    """This rank's parameters of sharded model ``key``, as numpy."""
    return {n: p.detach().float().cpu().numpy()
            for n, p in ctx.objects[key].module.named_parameters()}


def sharded_layout(ctx, seq, key):
    """The TP layout a rank applied to model ``key``: per-layer heads and
    kv window, the embedding rows, the head gather, the cache kv heads."""
    model = ctx.objects[key]
    layer = model.module.layers[0]
    return {"heads": layer.heads, "kv_window": layer.kv_window,
            "vocab_rows": model.module.vocab_rows,
            "gather_logits": model.module.gather_logits,
            "kv_heads": model.kv_heads,
            "o_reduce": layer.o.reduce is not None,
            "heads_split": model.tp_shard.heads_split,
            "kv_index": (None if layer.kv_index is None
                         else layer.kv_index.tolist())}


def engine_footprint(ctx, seq, key):
    """Bytes of a rank's engine's parameters and the shapes of its cache
    planes (rank 0's engine is passed in ``ctx.objects`` by the test)."""
    engine = ctx.objects[key]
    params = sum(p.numel() * p.element_size()
                 for p in engine.model.module.parameters())
    cache = {name: tuple(t.shape) for name, t in vars(engine._cache).items()
             if isinstance(t, torch.Tensor)}
    return {"param_bytes": params, "cache": cache, "device": str(
        engine.device)}


def collective_ops(ctx, seq, stacked):
    """Every ``CollectiveGroup`` op of the reference's test cases on this
    rank's chunks of the stacked inputs; results as numpy."""
    from ray_dynamic_batching_tpu_torch.parallel import collective as col

    group = col.CollectiveGroup(ctx.mesh, "tp")
    x = group.device_put(torch.from_numpy(stacked["x"]))
    out = {op: group.allreduce(x, op).numpy()
           for op in ("sum", "max", "min", "mean")}
    multi = col.CollectiveGroup(ctx.mesh, ("dp", "tp"))
    out["multi_sum"] = multi.allreduce(
        multi.device_put(torch.from_numpy(stacked["x"]))).numpy()
    out["broadcast"] = group.broadcast(x, root=2).numpy()
    out["reduce"] = group.reduce(x, root=1).numpy()
    out["allgather"] = group.allgather(x).numpy()
    out["reducescatter"] = group.reducescatter(
        group.device_put(torch.from_numpy(stacked["rs"]))).numpy()
    out["send_recv"] = group.send_recv(x, src=0, dst=3).numpy()
    out["ring"] = group.permute(
        x, [(i, (i + 1) % group.size) for i in range(group.size)]).numpy()
    out["rank_index"] = multi.rank_index().numpy()
    group.barrier()
    # The named-group registry, each rank its own.
    col.init_collective_group(ctx.mesh, "tp", group_name="g2")
    try:
        out["named"] = col.allreduce(x, group_name="g2").numpy()
        out["named_gather"] = col.allgather(x, group_name="g2").numpy()
        col.barrier(group_name="g2")
    finally:
        col.destroy_collective_group("g2")
    return out


def kernel4_rank(ctx, seq, q, k, v, table, lengths, ks, vs, heads_split):
    """This rank's shard of a whole paged call through the dispatcher
    inside ``tensor_parallel`` (the engine's decode read): q heads and kv
    heads cut as the rank holds them; returns the rank's output."""
    from ray_dynamic_batching_tpu_torch.ops import attention

    tp = ctx.mesh.shape["tp"]
    n, kk = q.shape[2] // tp, k.shape[2] // tp
    r = ctx.rank

    def cut(t, m):
        if t is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(
            t[:, :, r * m:(r + 1) * m]))

    args = dict(page_table=torch.from_numpy(table),
                kv_lengths=torch.from_numpy(lengths))
    if ks is not None:
        args.update(k_scale=cut(ks, kk), v_scale=cut(vs, kk))
    with attention.tensor_parallel(ctx.mesh, "tp", heads_split):
        out = attention.dot_product_attention(cut(q, n), cut(k, kk),
                                              cut(v, kk), **args)
    return out.numpy()


def launch_counts(ctx, seq):
    """This rank's kernel launch counts."""
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as da

    return {name: getattr(da, name) for name in (
        "launches", "int8_launches", "paged_launches",
        "paged_int8_launches", "tp_paged_launches",
        "tp_paged_int8_launches")}


def imports_of(ctx, seq):
    """Which of JAX, flax and the JAX package this rank's process has
    loaded (a name blocked with ``None`` in ``sys.modules`` is not)."""
    import sys

    return sorted(m for m in ("jax", "flax", "ray_dynamic_batching_tpu")
                  if sys.modules.get(m) is not None)


def fail_on(ctx, seq, rank):
    """Raise on rank ``rank`` (a follower's failure, for the error path)."""
    if ctx.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return ctx.rank


# --- training (tests/test_torch_train.py, test_torch_pipeline.py) ---------
def train_grads(ctx, seq, key):
    """A rank's gradients from its last ``loss_and_grads`` (as numpy) and
    the cuts of its slice of each leaf, ``[(dim, parts, index), ...]``."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import shard_plan

    model = ctx.objects[key]
    plan = shard_plan(ctx.mesh, model)
    return {n: (g.detach().float().cpu().numpy(),
                [(c.dim, c.parts, c.index) for c in plan[n].cuts()])
            for n, g in ctx.objects[(key, "grads")].items()}


def ring_case(ctx, seq, q, k, v, mask, dout, causal):
    """Ring attention of this rank's sp chunk of whole q/k/v [B, T, *, H]
    (numpy) and its gradients against ``dout``: (out, dq, dk, dv) chunks
    as numpy."""
    from ray_dynamic_batching_tpu_torch.ops.ring_attention import (
        ring_self_attention,
    )
    from ray_dynamic_batching_tpu_torch.parallel.mesh import seq_sharding

    cols = seq_sharding(ctx.mesh, q.shape[1])
    t = {n: torch.from_numpy(np.ascontiguousarray(x[:, cols])).requires_grad_(
        n in "qkv") for n, x in dict(q=q, k=k, v=v).items()}
    out = ring_self_attention(ctx.mesh, t["q"], t["k"], t["v"],
                              torch.from_numpy(mask[:, cols]), causal=causal)
    grads = torch.autograd.grad(
        out, (t["q"], t["k"], t["v"]),
        torch.from_numpy(np.ascontiguousarray(dout[:, cols])))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def draft_layout(ctx, seq, key):
    """A rank's engine ``key``'s draft: whether it is the target itself,
    its shard's key, its first layer's local heads and its cache's kv
    heads (rank 0's engine is passed in ``ctx.objects`` by the test)."""
    engine = ctx.objects[key]
    draft = engine.draft_model
    return {"self": draft is engine.model,
            "key": draft.tp_shard.key,
            "heads": draft.module.layers[0].heads,
            "cache_kv_heads": tuple(engine._dcache.k.shape)[3]}



def kv_gathers(ctx, seq):
    """This rank's count of per-query-head kv gathers."""
    from ray_dynamic_batching_tpu_torch.ops import attention

    return attention.kv_gathers
