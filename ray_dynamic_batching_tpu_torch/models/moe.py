"""Mixture-of-experts FFN block, in torch.

Port of ``ray_dynamic_batching_tpu/models/moe.py::MoEBlock``: GShard-style
capacity dispatch as dense one-hot products, every shape static. Top-k
routing (renormalized) in f32 with ``lax.top_k``'s tie rule (the lower
expert index first); per-row capacity ``C = ceil(k * T / E *
capacity_factor)`` over the call's ``T``, so a prefill's padded positions
are routed too and take capacity from real tokens; choice-major priority
(every first choice of a row beats every second choice); overflow falls
through the residual (its dispatch row is all zero). Dispatch and combine
run in f32, the experts' products in the model dtype.

Weights keep the flax layout: ``router`` a :class:`~.decoder.Dense` of
``[E, D]`` (f32, no bias), ``wi`` / ``wg`` ``[E, D, F]`` and ``wo``
``[E, F, D]`` in the model dtype. Weight-only int8
(``models/quant.py::quantize_tree``) stores each expert tensor as codes in
the int8 kernel's ``[E, N, K]`` layout (``wi_codes`` ``[E, F, D]``,
``wo_codes`` ``[E, D, F]``: output features first) with one f32 scale per
index of the flax last axis, shared by every expert (``wi_scale`` [F],
``wo_scale`` [D]); each expert's product is then one
``ops/quant_matmul.int8_linear`` over the rows dispatched to it.

Expert parallelism (``parallel/mesh.py::apply_tp`` on a mesh with ``ep``
above 1): a rank holds experts ``[e0, e0 + n)`` (``experts``), every rank
routes every token (the router replicates), each runs its own experts on
the dispatched tokens, and a sum over the ``ep`` group adds the partial
outputs — the reference's math, whose ``_constrain`` calls are layout
hints only. Under ``tp`` the experts' hidden columns are cut too: ``wo``'s
partial products are summed over ``tp`` before the combine. In training
the sums pass their gradient through, and the expert path's inputs (the
tokens and the combine weights) have theirs summed over ``ep`` and
``tp`` (``AxisGroup.copy_in``), so the router's gradient is whole on
every rank. The load-balance loss (``return_aux=True``) is the
reference's, over the router's statistics, which every rank holds whole;
``parallel/train.py`` adds ``MOE_AUX_COEF`` times it to the loss.

Under sequence parallelism (``sp`` above 1) routing with capacity runs
over the whole sequence, as the reference computes it: each layer
gathers every rank's chunk over the ``sp`` group (``AxisGroup.gather_dim``,
whose backward is the matching reduce-scatter), routes and runs the
experts as on one rank, and keeps its own chunk of the output; every sp
rank then holds the whole sequence's load-balance loss.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.models.decoder import Dense, _param
from ray_dynamic_batching_tpu_torch.ops import quant_matmul

#: The expert tensors, by their flax names.
EXPERTS = ("wi", "wg", "wo")


class MoEBlock(nn.Module):
    def __init__(self, d_model: int, mlp_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 gated: bool = True, dtype=torch.bfloat16,
                 device=torch.device("cpu")):
        super().__init__()
        self.d_model, self.mlp_dim = d_model, mlp_dim
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.gated = gated
        self.dtype = dtype
        E, D, Fd = num_experts, d_model, mlp_dim
        self.router = Dense(D, E, False, torch.float32, device)
        self.wi = _param((E, D, Fd), dtype, device)
        self.wo = _param((E, Fd, D), dtype, device)
        self.wg = _param((E, D, Fd), dtype, device) if gated else None
        for name in EXPERTS:
            self.register_parameter(f"{name}_codes", None)
            self.register_parameter(f"{name}_scale", None)
        self.weight_dtype: Optional[torch.dtype] = None
        # Under a mesh (parallel/mesh.py::apply_tp): this rank's experts
        # (first, count), the ep group over which their outputs sum, and
        # the tp group where their hidden columns are cut.
        self.experts = (0, num_experts)
        self.ep = None
        self.tp = None
        # Under a mesh with sp above 1: the sp group whose sequence chunks
        # the layer gathers before routing.
        self.sp = None

    def expert_names(self):
        return EXPERTS if self.gated else ("wi", "wo")

    def _experts(self, xe: torch.Tensor, name: str) -> torch.Tensor:
        """xe [B, E, C, K] (model dtype) times every expert's ``name``
        weight: [B, E, C, N]."""
        codes = getattr(self, f"{name}_codes")
        if codes is None:
            w = getattr(self, name)
            eq = "becd,edf->becf" if name != "wo" else "becf,efd->becd"
            return torch.einsum(eq, xe, w)
        scale = getattr(self, f"{name}_scale")
        B, E, C, _ = xe.shape
        outs = [quant_matmul.int8_linear(
            xe[:, e].reshape(B * C, -1), codes[e], scale,
            weight_dtype=self.weight_dtype).view(B, C, -1)
            for e in range(E)]
        return torch.stack(outs, dim=1)

    def forward(self, x: torch.Tensor, return_aux: bool = False):
        """x [B, T, D] -> [B, T, D] in x's dtype (and the load-balance
        loss, a 0-d f32 tensor, with ``return_aux``)."""
        chunk = None
        if self.sp is not None:
            # Capacity is over the whole sequence: route every chunk's
            # tokens here, keep this rank's rows of the output below.
            chunk = (self.sp.index * x.shape[1], x.shape[1])
            x = self.sp.gather_dim(x, 1)
        B, T, D = x.shape
        E, k = self.num_experts, self.top_k
        C = max(1, math.ceil(k * T / E * self.capacity_factor))
        dev = x.device

        gates = torch.softmax(self.router(x.float()), dim=-1)     # [B,T,E]
        # top-k, ties to the lower index (a stable descending sort).
        top_gates, top_idx = torch.sort(gates, dim=-1, descending=True,
                                        stable=True)
        top_gates, top_idx = top_gates[..., :k], top_idx[..., :k]
        top_gates = top_gates / torch.clamp(
            top_gates.sum(dim=-1, keepdim=True), min=1e-9)

        # Position of each (token, choice) in its expert's buffer: the
        # running count of earlier assignments, choice-major.
        experts = torch.arange(E, device=dev)
        choice = (top_idx[..., None] == experts).float()          # [B,T,k,E]
        flat = choice.permute(0, 2, 1, 3).reshape(B, k * T, E)
        pos_flat = torch.cumsum(flat, dim=1) - flat
        pos = pos_flat.reshape(B, k, T, E).permute(0, 2, 1, 3)    # [B,T,k,E]
        # Overflow takes index C, whose one-hot row is all zero.
        cap_idx = torch.where(pos < C, pos, torch.full_like(pos, C))
        slots = torch.arange(C, device=dev, dtype=torch.float32)
        cap = (cap_idx[..., None] == slots).float()               # [B,T,k,E,C]
        dispatch = torch.einsum("btke,btkec->btec", choice, cap)
        gate_e = torch.einsum("btke,btk->bte", choice, top_gates)
        combine = dispatch * gate_e[..., None]

        xf = x.float()
        for group in (self.ep, self.tp):
            if group is not None:
                xf = group.copy_in(xf)
        if self.ep is not None:
            combine = self.ep.copy_in(combine)
        e0, n = self.experts
        xe = torch.einsum("btec,btd->becd", dispatch[:, :, e0:e0 + n], xf)
        xe = xe.to(self.dtype)
        h = self._experts(xe, "wi")
        if self.gated:
            h = F.silu(self._experts(xe, "wg")) * h
        else:
            h = F.gelu(h, approximate="tanh")
        ye = self._experts(h, "wo")
        if self.tp is not None:
            ye = self.tp.all_reduce(ye)
        y = torch.einsum("btec,becd->btd", combine[:, :, e0:e0 + n],
                         ye.float())
        if self.ep is not None:
            y = self.ep.all_reduce(y)
        y = y.to(x.dtype)
        if chunk is not None:
            y = y.narrow(1, *chunk)
        if not return_aux:
            return y
        # Load-balance loss (Shazeer / GShard): E * sum_e f_e * p_e.
        density = choice[:, :, 0].mean(dim=1)     # top-1 assignment share
        mean_gate = gates.mean(dim=1)             # [B, E]
        return y, (density * mean_gate).sum(dim=-1).mean() * E
