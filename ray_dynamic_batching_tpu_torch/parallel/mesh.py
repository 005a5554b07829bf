"""Device meshes over torch.distributed: the port's tensor-parallel substrate.

Port of ``ray_dynamic_batching_tpu/parallel/mesh.py:38-225``. The reference
lays a model out over a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; the port runs one process per rank (``parallel/spmd.py``) and
writes the collectives out in the model (``models/decoder.py``) on the
mesh's ``tp`` process group.

- :class:`MeshConfig` and ``AXIS_ORDER`` are the reference's, ``auto``
  included. Every axis is active: ``tp`` (serving and training), ``dp``
  and ``sp`` (training's batch rows and sequence chunks, with ring
  attention over ``sp``), ``pp`` (``parallel/pipeline.py``'s stages) and
  ``ep`` (``models/moe.py``'s experts).
- A :class:`Mesh` is one rank's view: every rank's device, the axis sizes,
  this rank's index and coordinates (ranks laid out over ``AXIS_ORDER``
  row-major, as the reference reshapes its devices), the world's process
  group and one :class:`AxisGroup` per axis above 1 (``mesh.tp``,
  ``mesh.dp``, ``mesh.sp``, ``mesh.pp``, ``mesh.ep``, and ``mesh.data``
  over ``dp`` x ``sp``: the ranks that hold different data and the same
  weights).
  :func:`build_mesh` of more than one device starts the ranks: the caller
  becomes rank 0 and ``parallel/spmd.World`` spawns the others. The
  backend is the caller's (``nccl`` or ``gloo``); by default NCCL when
  every rank has its own card and gloo on CPU devices. NCCL with a card
  listed twice raises before any process starts, and so does a shared
  card with no backend named: nothing switches to gloo quietly. Gloo may
  put several ranks on one card (it stages CUDA tensors through the host).
- Sharding: the model's rules (``models/base.py``; the llama rules in
  ``models/causal_lm.py``) name, per reference parameter path, the mesh
  axis of each axis of the flax kernel. :func:`_feasible_spec` drops an
  axis that does not divide its dimension (that dimension replicates),
  as the reference does. :func:`shard_params` gives each rank its own
  slice of each weight, in the port's layout; :func:`build_sharded_model`
  draws the weights from a seed on every rank and keeps only the slice,
  so no rank ever holds the whole model.
- :func:`make_sharded_cache` / :func:`make_sharded_paged_cache` allocate
  each rank's KV cache directly at its share of the kv heads;
  :func:`replicate` puts a tree on this rank's device (each rank holds
  the whole of a replicated tree).
- :func:`multihost_init` is the reference's distributed bootstrap on
  ``torch.distributed.init_process_group``.

- :func:`batch_sharding` / :func:`seq_sharding` are the reference's data
  layouts as this rank's share: the contiguous block of batch rows of its
  ``dp`` index and the contiguous sequence chunk of its ``sp`` index.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("mesh")

AXIS_ORDER = ("dp", "pp", "sp", "tp", "ep")

#: A partition spec as plain data: one entry per dimension, an axis name,
#: a tuple of axis names, or None (replicated). ``()`` replicates all.
Spec = Tuple[Any, ...]

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes for the five-way parallelism mesh.

    dp = data/replica, pp = pipeline stages, sp = sequence (ring attention),
    tp = tensor, ep = expert (MoE). Axes default to 1 (inactive)."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    @staticmethod
    def auto(n_devices: int, tp: Optional[int] = None, sp: int = 1) -> "MeshConfig":
        """Pick dp x sp x tp for a device count: prefer TP up to 4,
        data-parallel beyond (reference ``mesh.py:55-70``)."""
        if n_devices % sp != 0:
            raise ValueError(f"sp={sp} does not divide {n_devices} devices")
        if tp is None:
            tp = 1
            for cand in (4, 2):
                if n_devices % (cand * sp) == 0:
                    tp = cand
                    break
        if n_devices % (tp * sp) != 0:
            raise ValueError(
                f"tp={tp} x sp={sp} does not divide {n_devices} devices"
            )
        return MeshConfig(dp=n_devices // (tp * sp), sp=sp, tp=tp)


class AxisGroup:
    """The collectives a sharded model issues on one axis group of its
    mesh (``size`` ranks, this rank at ``index``): the sum of row-parallel
    products, of a vocabulary-sharded embedding and of expert partials,
    the gather of vocabulary-sharded logits and of a MoE layer's sequence
    chunks.

    Serving (no grad) runs them in place on the group. Under autograd
    (grad mode on and the input requiring grad) each is the
    ``torch.autograd.Function`` of ``parallel/collective.py`` with its
    conjugate on the way back: :meth:`all_reduce` sums forward and passes
    the gradient through; :meth:`copy_in` (a column-parallel input) passes
    forward and sums the gradient; :meth:`gather_last` and
    :meth:`gather_dim` gather forward and keep this rank's slice of the
    gradient (summed over the ranks first for :meth:`gather_dim`, whose
    every rank's output reads every rank's input)."""

    def __init__(self, group, size: int, index: int = 0) -> None:
        self.group = group
        self.size = size
        self.index = index

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks; every rank ends with the same values
        (in place when no gradient flows)."""
        from ray_dynamic_batching_tpu_torch.parallel import collective

        if collective.grad_flows(x):
            return collective.SumForward.apply(x, self.group)
        x = x.contiguous()
        collective.pg_allreduce(self.group, x, "sum")
        return x

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is; under autograd its gradient is summed over the
        ranks (the input of a column-parallel product)."""
        from ray_dynamic_batching_tpu_torch.parallel import collective

        if collective.grad_flows(x):
            return collective.SumBackward.apply(x, self.group)
        return x

    def gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in rank order (a
        MoE layer's sequence chunks over ``sp``); under autograd the
        gradient is reduce-scattered back (``collective.GatherDim``)."""
        from ray_dynamic_batching_tpu_torch.parallel import collective

        if collective.grad_flows(x):
            return collective.GatherDim.apply(x, self.group, self.size,
                                              self.index, dim)
        parts = collective.pg_allgather(self.group, x.contiguous(),
                                        self.size)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``x`` along its last dimension, in rank
        order (the logits of a vocabulary-sharded head)."""
        from ray_dynamic_batching_tpu_torch.parallel import collective

        if collective.grad_flows(x):
            return collective.GatherLast.apply(x, self.group, self.size,
                                               self.index)
        parts = collective.pg_allgather(self.group, x.contiguous(),
                                        self.size)
        return torch.cat(list(parts.unbind(0)), dim=-1)


class Mesh:
    """One rank's view of a device mesh (see the module docstring).
    ``shape`` maps every axis of ``AXIS_ORDER`` to its size, as the
    reference's ``Mesh.shape`` does."""

    def __init__(self, shape: Dict[str, int], devices: Sequence[torch.device],
                 rank: int = 0, backend: Optional[str] = None, group=None,
                 world=None, groups: Optional[Dict[tuple, Any]] = None
                 ) -> None:
        from ray_dynamic_batching_tpu_torch.parallel.spmd import coords_of

        self.shape = {ax: int(shape.get(ax, 1)) for ax in AXIS_ORDER}
        self.devices = [torch.device(d) for d in devices]
        self.rank = int(rank)
        self.backend = backend
        self.group = group
        self.world = world
        self.groups = dict(groups or {})
        self.coords = coords_of(self.rank, self.shape)
        for axes, name in ((("dp",), "dp"), (("pp",), "pp"), (("sp",), "sp"),
                           (("tp",), "tp"), (("ep",), "ep"),
                           (("dp", "sp"), "data")):
            setattr(self, name, self.axis_group(axes))

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def group_for(self, axes: Sequence[str]):
        """The process group over ``axes`` (None when they span one rank):
        the world's where they span every rank."""
        axes = tuple(ax for ax in AXIS_ORDER if ax in axes)
        n = 1
        for ax in axes:
            n *= self.shape[ax]
        if n == 1:
            return None
        if n == len(self.devices):
            return self.group
        return self.groups.get(axes)

    def axis_group(self, axes: Sequence[str]) -> Optional[AxisGroup]:
        """An :class:`AxisGroup` over ``axes`` (None when they span one
        rank): this rank's linear index over them, in ``AXIS_ORDER``."""
        axes = tuple(ax for ax in AXIS_ORDER if ax in axes)
        n, index = 1, 0
        for ax in axes:
            n *= self.shape[ax]
            index = index * self.shape[ax] + self.coords[ax]
        if n == 1:
            return None
        return AxisGroup(self.group_for(axes), n, index)

    def shutdown(self) -> None:
        """End the ranks of this mesh (rank 0 only; idempotent)."""
        if self.world is not None:
            self.world.shutdown()

    def __repr__(self) -> str:
        axes = " ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1)
        return (f"Mesh({axes or 'single'}, rank {self.rank}/{self.size}, "
                f"{self.backend or 'no backend'})")


def _torch_device(d: Any) -> torch.device:
    """A placed device (placement's ``CudaDevice``), a ``torch.device``
    or a string as a ``torch.device``; a card without an index is the
    current card (a rank sets its device by index)."""
    dev = getattr(d, "torch_device", None) or torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _default_backend(devices: List[torch.device]) -> str:
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh over {sorted(kinds)} devices: put every "
                         "rank on the CPU or every rank on a card")
    if len({d.index for d in devices}) != len(devices):
        raise ValueError(
            "several ranks share a card: NCCL takes one rank per card; pass "
            "backend='gloo' to time-share the card (no quiet fallback)")
    return "nccl"


def build_mesh(config: MeshConfig,
               devices: Optional[Sequence[Any]] = None,
               backend: Optional[str] = None) -> Mesh:
    """Rank 0's view of a mesh over ``devices`` (default: the visible
    cards). More than one device starts the other ranks' processes (see
    the module docstring); :meth:`Mesh.shutdown` ends them."""
    from ray_dynamic_batching_tpu_torch.parallel import spmd

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_torch_device(d) for d in devices]
    n = config.n_devices
    if len(devices) < n:
        raise ValueError(
            f"mesh needs {n} devices (dp={config.dp} pp={config.pp} "
            f"sp={config.sp} tp={config.tp} ep={config.ep}) but only "
            f"{len(devices)} available"
        )
    devices = devices[:n]
    if n == 1:
        return single_device_mesh(devices[0])
    backend = backend or _default_backend(devices)
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("backend='nccl' needs every rank on a card")
        if len({d.index for d in devices}) != len(devices):
            raise ValueError(
                "backend='nccl' with a card listed twice: NCCL takes one "
                "rank per card (pass backend='gloo' to time-share a card)")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    shape = {ax: getattr(config, ax) for ax in AXIS_ORDER}
    world = spmd.World(devices, shape, backend)
    logger.info("mesh %s over %s (%s)",
                {ax: n for ax, n in shape.items() if n > 1},
                [str(d) for d in devices], backend)
    return world.mesh


def single_device_mesh(device: Any = None) -> Mesh:
    """A 1x1x1x1x1 mesh on ``device`` (default: the first card)."""
    device = _torch_device(device if device is not None else "cuda:0")
    return Mesh({}, [device])


# --- sharding helpers -----------------------------------------------------

def _feasible_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Drop mesh axes that don't divide the corresponding dim (e.g. GQA with
    kv_heads < tp replicates the kv projections instead of erroring)."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if i < len(shape) and shape[i] % size == 0:
            out.append(ax)
        else:
            out.append(None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """How one port parameter is cut: dimension ``dim`` of the port's
    tensor into ``parts`` equal slices, this rank keeping slice
    ``index`` (``dim`` None: the whole tensor); ``then`` a second cut on
    another dimension (a MoE expert tensor over ``ep`` and ``tp``)."""

    dim: Optional[int]
    parts: int = 1
    index: int = 0
    then: Optional["LeafShard"] = None

    def take(self, full: torch.Tensor) -> torch.Tensor:
        out = full
        if self.dim is not None and self.parts > 1:
            n = full.shape[self.dim] // self.parts
            out = full.narrow(self.dim, self.index * n, n)
        return out if self.then is None else self.then.take(out)

    def cuts(self) -> List["LeafShard"]:
        """Every cut of this leaf, as single cuts (outermost first)."""
        out = [] if self.dim is None or self.parts == 1 else [
            LeafShard(self.dim, self.parts, self.index)]
        return out + (self.then.cuts() if self.then is not None else [])


def param_shardings(mesh: Mesh, model: Any) -> Dict[str, Spec]:
    """The feasible spec of every parameter, by port name, in the flax
    kernel's axes (infeasible axes degrade to replication; reference
    ``mesh.py:116-125``)."""
    from ray_dynamic_batching_tpu_torch.models.base import param_path_specs

    return {name: _feasible_spec(spec, shape, mesh)
            for name, (path, spec, shape, _dims)
            in param_path_specs(model).items()}


def shard_plan(mesh: Mesh, model: Any) -> Dict[str, LeafShard]:
    """Each port parameter's :class:`LeafShard` on this rank. A spec's
    sharded flax axis is the major part of the port dimension it maps to
    (``[N, H]`` flattens to ``N*H`` rows), so a contiguous slice of that
    dimension is the rank's shard. The bias of a column-parallel layer is
    cut with its output rows (the reference reshards it under GSPMD); the
    bias of a row-parallel one stays whole and is added after the sum."""
    from ray_dynamic_batching_tpu_torch.models.base import param_path_specs

    plan: Dict[str, LeafShard] = {}
    specs = param_path_specs(model)
    for name, (path, spec, shape, dims) in specs.items():
        feasible = _feasible_spec(spec, shape, mesh)
        cuts = []
        for i, ax in enumerate(feasible):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            parts = 1
            for a in axes:
                parts *= mesh.shape[a]
            if parts > 1:
                index = 0
                for a in axes:
                    index = index * mesh.shape[a] + mesh.axis_index(a)
                cuts.append((dims[i], parts, index))
        shard = LeafShard(None)
        for dim, parts, index in reversed(cuts):
            shard = LeafShard(dim, parts, index,
                              then=shard if shard.dim is not None else None)
        plan[name] = shard
    for name, shard in list(plan.items()):
        if name.endswith(".weight") and shard.dim == 0:
            bias = name[: -len("weight")] + "bias"
            if bias in plan:
                plan[bias] = LeafShard(0, shard.parts, shard.index)
    return plan


def _refuse(model: Any) -> None:
    from ray_dynamic_batching_tpu_torch.models.quant import is_quantized

    if getattr(model, "tp_shard", None) is not None:
        raise ValueError(f"{model.name} is already sharded")
    if is_quantized(model):
        raise ValueError(
            "a weight-only int8 model on a TP mesh is not supported yet: "
            "the sharding rules key on kernel paths, which quantization "
            "rewrites into codes and scales")


def _recipe(model: Any) -> tuple:
    """What a rank needs to build an empty twin of ``model``."""
    return (type(model), model.cfg, model.name, model.dtype,
            getattr(model, "kv_dtype", None))


def _twin(recipe: tuple, device: torch.device):
    cls, cfg, name, dtype, kv_dtype = recipe
    model = cls(cfg, name=name, dtype=dtype, device="meta", seed=None,
                kv_dtype=kv_dtype)
    model.device = device
    return model


def _build_shard(ctx, seq: int, key: str, recipe: tuple, source: tuple):
    """Every rank's half of :func:`shard_params` / :func:`build_sharded_model`:
    an empty twin of the model, each parameter filled with this rank's
    slice of the whole weight — broadcast from rank 0 (``source``
    ``("rank0",)``) or drawn from the seed on every rank (``("seed",
    seed)``, ``models/causal_lm.random_leaves``: the same draws as
    ``init_random``, one whole leaf at a time)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import random_leaves
    from ray_dynamic_batching_tpu_torch.parallel.collective import (
        pg_broadcast,
    )

    mesh = ctx.mesh
    model = _twin(recipe, mesh.device)
    plan = shard_plan(mesh, model)
    params = dict(model.module.named_parameters())
    if source[0] == "seed":
        leaves = random_leaves(model.module, source[1], mesh.device)
    else:
        full_model = ctx.objects.pop(("source", key), None)
        state = (dict(full_model.module.named_parameters())
                 if full_model is not None else None)

        def broadcast():
            for name in sorted(params):
                p = params[name]
                if state is not None:
                    full = state[name].detach().to(mesh.device).contiguous()
                else:
                    full = torch.empty(p.shape, dtype=p.dtype,
                                       device=mesh.device)
                pg_broadcast(mesh.group, full, 0)
                yield name, full

        leaves = broadcast()
    for name, full in leaves:
        local = plan[name].take(full).clone()
        mod_name, _, leaf = name.rpartition(".")
        mod = model.module.get_submodule(mod_name)
        mod._parameters[leaf] = nn.Parameter(local, requires_grad=False)
        del full
    apply_tp(model, mesh, plan, key)
    ctx.objects[key] = model
    return {name: tuple(p.shape) for name, p in
            sorted(model.module.named_parameters())}


def apply_tp(model: Any, mesh: Mesh, plan: Dict[str, LeafShard],
             key: str) -> None:
    """Mark a model whose parameters hold this rank's slices (``plan``):
    each layer's local head counts, its kv-head window where k/v
    replicate but q is cut (and, where the rank's query heads straddle a
    group boundary, each local head's index into that window), a MoE
    layer's ``sp`` group, and the collectives of the row-parallel
    products, of their column-parallel inputs (the gradient sum, in
    training), of the embedding and the head (``models/decoder.py``),
    and a MoE layer's experts over ``ep`` (and their columns over
    ``tp``, ``models/moe.py``)."""
    cfg = model.cfg
    tp = mesh.shape["tp"]
    module = model.module
    q_cut = plan["layers.0.q.weight"].dim is not None
    kv_cut = plan["layers.0.k.weight"].dim is not None
    N = cfg.num_heads // (tp if q_cut else 1)
    K = cfg.num_kv_heads // (tp if kv_cut else 1)
    kv_window = kv_index = None
    G = cfg.num_heads // cfg.num_kv_heads
    if q_cut and not kv_cut:
        first = mesh.axis_index("tp") * N      # global index of local head 0
        lo, hi = first // G, (first + N - 1) // G
        kv_window = (lo, hi - lo + 1)
        if N % G and G % N:
            # The rank's query heads straddle a group boundary: each reads
            # its own kv head of the window (ops/attention.gather_kv_heads).
            kv_index = torch.tensor([(first + n) // G - lo for n in range(N)],
                                    dtype=torch.long, device=mesh.device)
    for i, layer in enumerate(module.layers):
        layer.heads = (N, K)
        layer.kv_window = kv_window
        layer.kv_index = kv_index
        if q_cut or kv_cut:
            layer.attn_in = mesh.tp.copy_in
        for proj in ("o", "mlp_down"):
            dense = getattr(layer, proj, None)
            if dense is not None and plan[f"layers.{i}.{proj}.weight"].dim \
                    is not None:
                dense.reduce = mesh.tp.all_reduce
        if getattr(layer, "mlp_up", None) is not None and \
                plan[f"layers.{i}.mlp_up.weight"].dim is not None:
            layer.mlp_in = mesh.tp.copy_in
        moe = getattr(layer, "moe", None)
        if moe is not None:
            cuts = {c.dim: c for c in plan[f"layers.{i}.moe.wi"].cuts()}
            if 0 in cuts:     # experts over ep
                n = cfg.num_experts // cuts[0].parts
                moe.experts = (cuts[0].index * n, n)
                moe.ep = mesh.ep
            if 2 in cuts:     # expert columns over tp
                moe.tp = mesh.tp
            # Routing with capacity runs over the whole sequence: under sp
            # each layer gathers the chunks and keeps its own.
            moe.sp = mesh.sp
    embed = plan["tok_embed.weight"]
    if embed.dim is not None:
        rows = cfg.vocab_size // embed.parts
        module.vocab_rows = (embed.index * rows, rows)
    head = plan.get("lm_head.weight", embed if cfg.tie_embeddings else None)
    module.tp = mesh.tp
    module.gather_logits = head is not None and head.dim is not None
    model.kv_heads = K
    model.tp_shard = TPShard(mesh, key, kv_cut and q_cut,
                             kv_window is not None)


@dataclasses.dataclass
class TPShard:
    """A model's place on a mesh: the mesh, its name among the world's
    per-rank objects, and whether the kv heads are cut (the paged kernel
    runs per shard; otherwise the heads replicate and the gather path
    runs, as the reference declines)."""

    mesh: Mesh
    key: str
    heads_split: bool
    kv_window: bool = False


def _start_shard(mesh: Mesh, model_or_recipe, source: tuple):
    world = mesh.world
    if world is None:
        raise ValueError(f"{mesh!r} is not rank 0 of a started mesh")
    key = world.new_key("model")
    if source[0] == "rank0":
        world.ctx.objects[("source", key)] = model_or_recipe
        recipe = _recipe(model_or_recipe)
    else:
        recipe = model_or_recipe
    shapes = world.call(_build_shard, key, recipe, source)
    if any(s.keys() != shapes[0].keys() for s in shapes):
        raise RuntimeError("ranks built different parameter sets")
    return world.ctx.objects[key]


def shard_params(mesh: Mesh, model: Any) -> Any:
    """Place ``model``'s weights on the mesh per its rules (TP weights cut
    over the tp axis, everything else replicated): returns rank 0's shard,
    a new model on rank 0's device; every other rank holds its own under
    the same key. Each whole weight is broadcast from rank 0 once and cut
    on every rank. ``model`` itself is left as it is. A mesh of one rank
    returns ``model``; a mesh of several with no cut (dp, sp, pp only)
    still gives every rank its whole twin."""
    if mesh.size == 1:
        return model
    _refuse(model)
    with torch.inference_mode(False), torch.no_grad():
        return _start_shard(mesh, model, ("rank0",))


def build_sharded_model(mesh: Mesh, model_cls, cfg, name: str,
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        kv_dtype: Optional[torch.dtype] = None) -> Any:
    """Rank 0's shard of ``model_cls(cfg, name, dtype, seed=seed,
    kv_dtype=kv_dtype)``, every rank drawing the whole weights from
    ``seed`` one leaf at a time and keeping its slice: the same numbers
    as the unsharded model's, and no rank holds more than its share plus
    one whole leaf."""
    recipe = (model_cls, cfg, name, dtype, kv_dtype)
    probe = _twin(recipe, torch.device("meta"))
    if mesh.size == 1:
        model = model_cls(cfg, name=name, dtype=dtype, device=mesh.device,
                          seed=seed, kv_dtype=kv_dtype)
        return model
    _refuse(probe)
    with torch.inference_mode(False), torch.no_grad():
        return _start_shard(mesh, recipe, ("seed", int(seed)))


def make_sharded_cache(mesh: Mesh, model: Any, num_slots: int,
                       max_len: Optional[int] = None) -> Any:
    """This rank's KV cache at its share of the kv heads (``cache_pspec``;
    allocated at that size, never whole on any rank)."""
    _check_sharded(mesh, model)
    return model.make_cache(num_slots, max_len)


def make_sharded_paged_cache(mesh: Mesh, model: Any, num_slots: int,
                             num_pages: int, page_size: int,
                             max_len: int) -> Any:
    """This rank's paged pool at its share of the kv heads; the page table
    and lengths are whole on every rank (``paged_cache_pspec``: page
    indices are shard-invariant, so the host allocator stays global)."""
    _check_sharded(mesh, model)
    return model.make_paged_cache(num_slots, num_pages, page_size, max_len)


def _check_sharded(mesh: Mesh, model: Any) -> None:
    shard = getattr(model, "tp_shard", None)
    if mesh.shape["tp"] > 1 and (shard is None or shard.mesh is not mesh):
        raise ValueError(f"{model.name} is not sharded over {mesh!r}")


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a ``[B, ...]`` batch split over ``dp`` (the
    reference's ``P("dp", ...)``: contiguous blocks in ``dp`` order)."""
    dp = mesh.shape["dp"]
    if batch % dp:
        raise ValueError(f"batch {batch} does not split over dp={dp}")
    n = batch // dp
    return slice(mesh.axis_index("dp") * n, (mesh.axis_index("dp") + 1) * n)


def seq_sharding(mesh: Mesh, length: int) -> slice:
    """This rank's positions of a ``[B, T, ...]`` sequence split over
    ``sp`` (the reference's ``P("dp", "sp")``: contiguous chunks in
    ``sp`` order; global position = chunk index * T_local + offset)."""
    sp = mesh.shape["sp"]
    if length % sp:
        raise ValueError(f"sequence length {length} not divisible by "
                         f"sp={sp}")
    n = length // sp
    return slice(mesh.axis_index("sp") * n, (mesh.axis_index("sp") + 1) * n)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """``tree`` (tensors, tuples, lists, dicts) on this rank's device: a
    replicated value is whole on every rank."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree


# --- multi-host boot ------------------------------------------------------

def multihost_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    timeout_s: float = 120.0,
) -> Dict[str, int]:
    """Initialize torch.distributed's default group across hosts: the
    coordinator (``host:port``, or the ``MASTER_ADDR``/``MASTER_PORT``
    environment when None) plays the reference's coordinator role. No-op
    when single-process."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return {"process_index": 0, "process_count": 1}
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(
        backend=backend, init_method=init, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
    }

