"""Collective communication API — the ``ray.util.collective`` equivalent.

Port of ``ray_dynamic_batching_tpu/parallel/collective.py:39-304`` on a
mesh's torch.distributed process group (``parallel/mesh.py``). The
reference's ops are ``shard_map`` collectives over one global array whose
leading dimension is the group's: slot ``g`` is rank ``g``'s buffer. Here
each rank is a process and holds its own slot: :meth:`CollectiveGroup.
device_put` cuts a stacked ``[G * c, ...]`` array into this rank's
``[c, ...]`` chunk, and every op takes and returns this rank's chunk, so
rank ``g``'s result is slot ``g`` of the reference's. The reference's
error cases keep their exception types: an unknown axis, a leading
dimension the group does not divide, a 0-d buffer and a rank out of range
raise ``ValueError``; ``reducescatter`` with another op than ``sum`` and
``permute`` over a multi-axis group raise ``NotImplementedError``.

Gloo stages CUDA tensors through the host. The gathers (``allgather``,
``permute`` and the TP model's logits) are the backend's ``allgather``
(gloo's and NCCL's both take CUDA tensors). The module-level named-group API
(``init_collective_group`` ... ``barrier``) keeps one registry per
process: each rank registers its own groups.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Tuple[str, ...]]

_REDUCE_OPS = ("sum", "max", "min", "mean")
_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}


def pg_allreduce(group, x: torch.Tensor, op: str = "sum") -> None:
    """Reduce ``x`` (contiguous) over ``group`` in place; ``mean`` sums
    here and the caller divides."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    group.allreduce([x], opts).wait()


def pg_broadcast(group, x: torch.Tensor, root: int) -> None:
    """Every rank's ``x`` (contiguous) becomes rank ``root``'s, in place."""
    opts = dist.BroadcastOptions()
    opts.rootRank = int(root)
    opts.rootTensor = 0
    group.broadcast([x], opts).wait()


def pg_allgather(group, x: torch.Tensor, size: int) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x`` (contiguous) in rank
    order, on every rank."""
    out = [torch.empty_like(x) for _ in range(size)]
    group.allgather([out], [x]).wait()
    return torch.stack(out)


def pg_exchange(group, send: torch.Tensor, dst: int, recv_like: torch.Tensor,
                src: int, rank: int, stage: bool) -> torch.Tensor:
    """Send ``send`` to group rank ``dst`` while receiving a tensor shaped
    like ``recv_like`` from ``src`` (a ring hop). Even ranks post their send
    first and odd ranks their receive, so a ring of blocking transports
    never waits on itself. ``stage``: gloo moves host memory only, so CUDA
    tensors go through the host."""
    out_dev = recv_like.device
    s = send.detach().contiguous()
    r = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                    device="cpu" if stage else out_dev)
    if stage:
        s = s.cpu()
    ops = [lambda: group.send([s], dst, 0), lambda: group.recv([r], src, 0)]
    works = [op() for op in (ops if rank % 2 == 0 else ops[::-1])]
    for w in works:
        w.wait()
    return r.to(out_dev) if stage else r


def pg_send(group, x: torch.Tensor, dst: int, stage: bool) -> None:
    """Send ``x`` to group rank ``dst`` (through the host when ``stage``)."""
    x = x.detach().contiguous()
    group.send([x.cpu() if stage else x], dst, 0).wait()


def pg_recv(group, like: torch.Tensor, src: int, stage: bool) -> torch.Tensor:
    """A tensor shaped like ``like`` from group rank ``src``."""
    r = torch.empty(like.shape, dtype=like.dtype,
                    device="cpu" if stage else like.device)
    group.recv([r], src, 0).wait()
    return r.to(like.device) if stage else r


def grad_flows(x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` must be autograd-aware: grad mode on
    and ``x`` in a graph. Serving (no grad, inference, graph capture)
    keeps the in-place collectives."""
    return torch.is_grad_enabled() and x.requires_grad


class SumForward(torch.autograd.Function):
    """All-reduce forward, identity backward: after a row-parallel product
    (its partial sums), a vocabulary-sharded embedding or an expert
    partial. Every rank's loss sees the same sum, and each rank's
    gradient of the sum is already whole."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        pg_allreduce(group, y, "sum")
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class SumBackward(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel product, whose gradient each rank holds only for its
    own columns."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        pg_allreduce(ctx.group, g, "sum")
        return g, None


class GatherLast(torch.autograd.Function):
    """Gather along the last dimension forward (vocabulary-sharded
    logits), this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, size: int, index: int):
        ctx.n, ctx.index = x.shape[-1], index
        parts = pg_allgather(group, x.contiguous(), size)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(-1, ctx.index * ctx.n, ctx.n).contiguous(), None,
                None, None)


class GatherDim(torch.autograd.Function):
    """Gather along dimension ``dim`` forward (every rank's chunk in rank
    order: a MoE layer's tokens over ``sp``), and backward the matching
    reduce-scatter: the gradient summed over the ranks, this rank's chunk
    of it kept (each rank's output used only its own chunk's rows)."""

    @staticmethod
    def forward(ctx, x, group, size: int, index: int, dim: int):
        ctx.group, ctx.n, ctx.index, ctx.dim = group, x.shape[dim], index, dim
        parts = pg_allgather(group, x.contiguous(), size)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        pg_allreduce(ctx.group, g, "sum")
        return (g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


class CollectiveGroup:
    """A named collective group over one or more mesh axes, as this rank
    sees it. The group's world size is the product of its axis sizes
    (reference ``collective.py:39-60``)."""

    def __init__(self, mesh, axes: Axes = ("dp",), name: str = "default"):
        self.mesh = mesh
        self.axes: Tuple[str, ...] = (axes,) if isinstance(axes, str) \
            else tuple(axes)
        for ax in self.axes:
            if ax not in mesh.shape:
                raise ValueError(f"mesh has no axis {ax!r}")
        self.name = name

    @property
    def size(self) -> int:
        n = 1
        for ax in self.axes:
            n *= self.mesh.shape[ax]
        return n

    # --- helpers ---------------------------------------------------------
    def _group(self):
        """The process group over this group's axes."""
        return self.mesh.group_for(self.axes)

    def _linear_index(self) -> int:
        idx = 0
        for ax in self.axes:
            idx = idx * self.mesh.shape[ax] + self.mesh.axis_index(ax)
        return idx

    def _check_leading(self, x: torch.Tensor) -> None:
        if x.ndim == 0:
            raise ValueError(
                f"a 0-d buffer has no leading dim to stack over a group of "
                f"size {self.size} (stacked per-rank layout)")

    def _check_rank(self, rank: int, what: str) -> None:
        if not 0 <= rank < self.size:
            raise ValueError(
                f"{what}={rank} out of range for group of size {self.size}"
            )

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.mesh.device).contiguous().clone()

    def _allreduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        out = self._local(x)
        if self.size > 1:
            pg_allreduce(self._group(), out, op)
        if op == "mean":
            out = out / self.size
        return out

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's chunk, in rank order."""
        x = self._local(x)
        if self.size == 1:
            return x[None]
        return pg_allgather(self._group(), x, self.size)

    def device_put(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a stacked ``[G * c, ...]`` array (slot g
        on rank g), on this rank's device."""
        if x.ndim == 0 or x.shape[0] % self.size != 0:
            raise ValueError(
                f"leading dim of {tuple(x.shape)} must be divisible by group "
                f"size {self.size} (stacked per-rank layout)"
            )
        c = x.shape[0] // self.size
        i = self._linear_index()
        return x[i * c:(i + 1) * c].to(self.mesh.device).clone()

    def rank_index(self) -> torch.Tensor:
        """This rank's linear index in the group, as its [1] chunk of the
        reference's stacked [G] array."""
        return torch.tensor([self._linear_index()], dtype=torch.int32,
                            device=self.mesh.device)

    # --- ops (reference: collective.py:103-257) --------------------------
    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Every rank ends with reduce(all ranks' chunks)."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduce op {op!r}; one of {_REDUCE_OPS}")
        self._check_leading(x)
        return self._allreduce(x, op)

    def reduce(self, x: torch.Tensor, root: int = 0,
               op: str = "sum") -> torch.Tensor:
        """Like allreduce but only rank ``root`` keeps the result; the
        others get zeros."""
        self._check_rank(root, "root")
        full = self.allreduce(x, op)
        if self._linear_index() != root:
            full = torch.zeros_like(full)
        return full

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's chunk concatenated in rank order, on every rank
        (the reference's replicated ``[G * c, ...]``)."""
        self._check_leading(x)
        g = self._gather(x)
        return g.reshape((-1,) + tuple(g.shape[2:]))

    def reducescatter(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """This rank's buffer is its ``[1, G * c, ...]`` slot; rank g
        receives the reduction over ranks of chunk g, ``[c, ...]``."""
        if x.ndim < 2 or x.shape[0] != 1 or x.shape[1] % self.size:
            raise ValueError(
                f"reducescatter expects this rank's [1, G*chunk, ...] slot "
                f"with G == {self.size}, got {tuple(x.shape)}"
            )
        if op != "sum":
            raise NotImplementedError("reducescatter supports op='sum'")
        full = self._allreduce(x[0], "sum")
        c = full.shape[0] // self.size
        i = self._linear_index()
        return full[i * c:(i + 1) * c]

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """All ranks end with rank ``root``'s chunk."""
        self._check_rank(root, "root")
        self._check_leading(x)
        out = self._local(x)
        if self.size > 1:
            pg_broadcast(self._group(), out, root)
        return out

    def permute(self, x: torch.Tensor,
                perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Point-to-point: for each (src, dst), dst receives src's chunk
        (the reference's send/recv pair); a rank that is no destination
        receives zeros."""
        self._check_leading(x)
        if len(self.axes) != 1:
            raise NotImplementedError("permute requires a single-axis group")
        for src, dst in perm:
            self._check_rank(src, "src")
            self._check_rank(dst, "dst")
        gathered = self._gather(x)
        me = self._linear_index()
        for src, dst in perm:
            if dst == me:
                return gathered[src].clone()
        return torch.zeros_like(gathered[me])

    def send_recv(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """One send/recv pair: dst gets src's chunk; every other rank gets
        zeros."""
        return self.permute(x, [(src, dst)])

    def barrier(self) -> None:
        """Synchronize the group: a sum every rank must reach (reference
        ``collective.py:243-257``). Blocks until it completes."""
        self._allreduce(torch.zeros((1,), dtype=torch.int32), "sum")


# --- module-level group registry (reference: collective.py:265-304) --------

_GROUPS: Dict[str, CollectiveGroup] = {}
_LOCK = threading.Lock()


def init_collective_group(
    mesh, axes: Axes = ("dp",), group_name: str = "default"
) -> CollectiveGroup:
    """Create and register a named group of this rank."""
    group = CollectiveGroup(mesh, axes, group_name)
    with _LOCK:
        if group_name in _GROUPS:
            raise ValueError(f"collective group {group_name!r} already exists")
        _GROUPS[group_name] = group
    return group


def get_collective_group(group_name: str = "default") -> CollectiveGroup:
    with _LOCK:
        if group_name not in _GROUPS:
            raise KeyError(f"no collective group {group_name!r}")
        return _GROUPS[group_name]


def destroy_collective_group(group_name: str = "default") -> None:
    with _LOCK:
        _GROUPS.pop(group_name, None)


def is_group_initialized(group_name: str = "default") -> bool:
    with _LOCK:
        return group_name in _GROUPS


def allreduce(x, op="sum", group_name="default"):
    return get_collective_group(group_name).allreduce(x, op)


def allgather(x, group_name="default"):
    return get_collective_group(group_name).allgather(x)


def reducescatter(x, op="sum", group_name="default"):
    return get_collective_group(group_name).reducescatter(x, op)


def broadcast(x, root=0, group_name="default"):
    return get_collective_group(group_name).broadcast(x, root)


def send_recv(x, src, dst, group_name="default"):
    return get_collective_group(group_name).send_recv(x, src, dst)


def barrier(group_name="default"):
    get_collective_group(group_name).barrier()
