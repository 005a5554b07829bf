"""Weight-only int8 quantization for serving models, in torch.

Own copy of ``ray_dynamic_batching_tpu/models/quant.py``. Decode streams
the whole weight set for one token per slot, so weight bytes set tokens/s:
symmetric int8 codes with f32 scales halve them against bf16. The JAX
package's tree is a params pytree; the port's "tree" is the model, which
owns its weights, so :func:`quantize_tree` works in place on the model's
modules and returns it.

The rules are the reference's, exactly:

- **Which leaves** (:func:`_wants_quant`, on the leaf's flax path and
  flax shape): at least 2 dims, at least ``_MIN_QUANT_ELEMS`` elements,
  and no ``embed`` in the path — so ``tok_embed`` / ``pos_embed``, norms
  and 1-D biases stay as they are, the untied ``lm_head`` is quantized,
  and so are a q/k/v bias whose flax shape ``[N, H]`` reaches the size
  (GPT-2 medium's) and a router kernel that does.
- **Scales** (:func:`_quantize_leaf`): absmax in f32 over every flax axis
  but the last, ``maximum(absmax, 1e-12) / 127``, then ``w / scale`` (a
  division), round half to even, clip to +-127. So q/k/v (flax ``[D, N,
  H]``) get one scale per head_dim index shared by all heads, ``o`` and
  the MLP one per output feature, MoE experts one per last-axis index
  shared by all experts. Scales are stored flat, ``[flax last axis]``:
  the same elements as the reference's ``[1, ..., 1, last]``, so
  :func:`tree_weight_bytes` counts what the reference counts.
- **Dequant** (``QTensor.dequantize``): ``q.to(dtype) * scale.to(dtype)``
  in the model dtype, as the reference's engine dequantizes with
  ``model.dtype`` — in a bf16 model the f32 ``lm_head`` sees a
  bf16-rounded weight. On the card the product never materializes the
  weight: ``ops/quant_matmul.int8_linear`` reads the codes.

A port model stores its weights in the model dtype, so a bf16 model is
quantized from bf16 weights where the reference quantizes its f32
params; in f32 the codes are bit-identical. A JAX-quantized tree bridged
by ``models/convert.py::params_from_flax`` keeps the JAX codes as they
are (:func:`load_state`). Nothing of the reference module is trimmed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn

from ray_dynamic_batching_tpu_torch.ops.quant_matmul import dequantize_rows

# Kernels with >= this many elements quantize; tiny leaves (norm scales,
# biases) are not worth the metadata.
_MIN_QUANT_ELEMS = 1024


@dataclass
class QTensor:
    """Symmetric int8 weight ``w ~= q * scale``: ``q`` int8 in the port's
    layout, ``scale`` f32 ``[period]`` applied as ``scale[i % period]``
    along ``axis`` (the port axis that carries the flax kernel's last)."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int = 0

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return dequantize_rows(self.q, self.scale, dtype, self.axis)


def _quantize_leaf(w: torch.Tensor, period: int, axis: int = 0) -> QTensor:
    """Quantize ``w`` with one scale per index ``i % period`` along
    ``axis``, the max taken over everything else (the flax rule: every
    axis but the last)."""
    wf = w.float()
    n = wf.shape[axis]
    v = wf.reshape(wf.shape[:axis] + (n // period, period)
                   + wf.shape[axis + 1:])
    dims = [d for d in range(v.dim()) if d != axis + 1]
    absmax = v.abs().amax(dim=dims)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    bshape = [1] * v.dim()
    bshape[axis + 1] = period
    q = torch.clamp(torch.round(v / scale.view(bshape)), -127, 127)
    return QTensor(q.to(torch.int8).reshape(w.shape), scale, axis)


def _wants_quant(path: str, shape: Tuple[int, ...]) -> bool:
    """The reference's selection, on a leaf's flax path and flax shape."""
    if len(shape) < 2:
        return False
    size = 1
    for d in shape:
        size *= d
    if size < _MIN_QUANT_ELEMS:
        return False
    # Embedding tables feed gathers and positional tables are tiny
    # relative to impact — skip both.
    return "embed" not in path.lower()


def flax_path(name: str) -> str:
    """A port module's flax params path: ``layers.3.moe.router`` ->
    ``params/layer3/moe/router``."""
    parts = name.split(".") if name else []
    out = ["params"]
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts):
            out.append(f"layer{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return "/".join(out)


@dataclass(frozen=True)
class _Leaf:
    """One weight as the flax tree holds it: its owner module, the port
    attribute (``weight``, ``bias``, ``wi``...), the port name, the flax
    path and shape, the port axis carrying the flax last axis, and whether
    the codes are the weight transposed to the kernel's ``[E, N, K]``."""

    owner: nn.Module
    attr: str
    name: str
    path: str
    shape: Tuple[int, ...]
    axis: int = 0
    transpose: bool = False

    @property
    def period(self) -> int:
        return self.shape[-1]

    @property
    def quantized(self) -> bool:
        return getattr(self.owner, f"{self.attr}_codes", None) is not None


def _leaves(model: Any) -> Iterator[_Leaf]:
    from ray_dynamic_batching_tpu_torch.models.decoder import Dense
    from ray_dynamic_batching_tpu_torch.models.moe import MoEBlock

    for name, mod in model.module.named_modules():
        pre = f"{name}." if name else ""
        path = flax_path(name)
        if isinstance(mod, Dense):
            yield _Leaf(mod, "weight", pre + "weight", f"{path}/kernel",
                        mod.flax_in + mod.flax_out)
            if mod.bias is not None or mod.bias_codes is not None:
                yield _Leaf(mod, "bias", pre + "bias", f"{path}/bias",
                            mod.flax_out)
        elif isinstance(mod, nn.Embedding):
            yield _Leaf(mod, "weight", pre + "weight", f"{path}/embedding",
                        tuple(mod.weight.shape))
        elif isinstance(mod, MoEBlock):
            E, D, F = mod.num_experts, mod.d_model, mod.mlp_dim
            for w in mod.expert_names():
                shape = (E, F, D) if w == "wo" else (E, D, F)
                yield _Leaf(mod, w, pre + w, f"{path}/{w}", shape, axis=1,
                            transpose=True)


def _install(leaf: _Leaf, codes: torch.Tensor, scale: torch.Tensor,
             dtype: torch.dtype) -> None:
    """The leaf as codes + scales from now on; its weight is freed."""
    owner = leaf.owner
    setattr(owner, f"{leaf.attr}_codes",
            nn.Parameter(codes, requires_grad=False))
    setattr(owner, f"{leaf.attr}_scale",
            nn.Parameter(scale, requires_grad=False))
    setattr(owner, leaf.attr, None)
    owner.weight_dtype = dtype


def is_quantized(model: Any) -> bool:
    """True when the model already holds int8 leaves."""
    return any(leaf.quantized for leaf in _leaves(model))


@torch.no_grad()
def quantize_tree(model: Any) -> Any:
    """Replace every selected weight of ``model`` (a ``CausalLM``) with
    int8 codes and f32 scales, in place, and return it. Idempotent:
    quantized leaves pass through untouched."""
    dtype = model.dtype
    for leaf in list(_leaves(model)):
        if leaf.quantized or not _wants_quant(leaf.path, leaf.shape):
            continue
        w = getattr(leaf.owner, leaf.attr)
        if leaf.transpose:
            w = w.transpose(1, 2)
        qt = _quantize_leaf(w, leaf.period, leaf.axis)
        _install(leaf, qt.q.contiguous(), qt.scale, dtype)
        del w, qt
    return model


@torch.no_grad()
def dequantize_tree(model: Any, dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` with every int8 leaf as its dequantized
    weight (in ``dtype``, default the model's), under its own name and in
    its own layout: a standard state for an unquantized model."""
    dtype = dtype or model.dtype
    sd = dict(model.module.state_dict())
    for leaf in _leaves(model):
        if not leaf.quantized:
            continue
        qt = QTensor(sd.pop(f"{leaf.name}_codes"),
                     sd.pop(f"{leaf.name}_scale"), leaf.axis)
        w = qt.dequantize(dtype)
        sd[leaf.name] = w.transpose(1, 2) if leaf.transpose else w
    return sd


@torch.no_grad()
def load_state(model: Any, sd: Mapping[str, torch.Tensor]) -> Any:
    """``load_state_dict`` for a state that may hold int8 leaves
    (``<name>_codes`` / ``<name>_scale``, as ``params_from_flax`` bridges
    a JAX-quantized tree): those leaves become codes and scales as given,
    with no requantization, the rest loads as usual."""
    dtype = model.dtype
    for leaf in list(_leaves(model)):
        codes = sd.get(f"{leaf.name}_codes")
        if codes is None or leaf.quantized:
            continue
        w = getattr(leaf.owner, leaf.attr)
        _install(leaf, torch.empty(codes.shape, dtype=torch.int8,
                                   device=w.device),
                 torch.empty(sd[f"{leaf.name}_scale"].shape,
                             dtype=torch.float32, device=w.device), dtype)
    model.module.load_state_dict(sd)
    return model


def tree_weight_bytes(model: Any) -> int:
    """Device bytes a (possibly quantized) model's weights keep resident:
    every tensor of its ``state_dict`` (``ServableModel.param_bytes``)."""
    return model.param_bytes()


def quantized_weight_bytes(model: Any) -> int:
    """What :func:`quantize_tree` WOULD leave resident, computed without
    quantizing (planner-side budgeting)."""
    total = tree_weight_bytes(model)
    for leaf in _leaves(model):
        if leaf.quantized or not _wants_quant(leaf.path, leaf.shape):
            continue
        w = getattr(leaf.owner, leaf.attr)
        total += w.numel() + leaf.period * 4 - w.numel() * w.element_size()
    return total
