"""Servable-model interface + registry, in torch.

Port of ``ray_dynamic_batching_tpu/models/base.py``. A servable model here
is an ``nn.Module`` that owns its weights on an explicit ``device``, plus
the metadata the engine, the collator and the profiler need: ``family``,
``example_inputs`` (the canonical zero batch of a bucket, in the
reference's layout), ``input_shapes`` and ``flops_per_sample``. The
reference's ``init``/``apply`` pair becomes the module's own weights and
``forward``. The sharding rules (:meth:`ServableModel.sharding_rules`,
:meth:`~ServableModel.partition_spec_for`, :func:`param_path_specs`) are
the reference's, as plain data: a spec is a tuple of mesh-axis names or
None per axis of the flax kernel (``()`` replicates), keyed by the
reference's parameter path (``layer3/q/kernel``), which
:meth:`ServableModel.flax_leaves` gives for each of the port's parameters.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The port's device rule: the card unless the caller asks for the
    CPU. A CUDA request without CUDA raises — there is no silent CPU
    fallback that would hide a missing card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclass(frozen=True)
class ModelSLO:
    """Per-model serving contract."""

    latency_slo_ms: float


class InputSpec(NamedTuple):
    """Shape and dtype of one model input (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class ServableModel(nn.Module):
    """A model the engine can serve: weights on ``device`` in ``dtype``."""

    #: registry key, e.g. "llama3_8b"
    name: str = "unnamed"
    #: "vision" | "text_classifier" | "causal_lm" | "asr"
    family: str = "unnamed"

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = "cuda"):
        super().__init__()
        self.dtype = dtype
        self.device = resolve_device(device)

    # --- shape contract --------------------------------------------------
    def example_inputs(self, batch_size: int, seq_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
        """Canonical zero inputs for a (batch, seq) bucket, on ``device``."""
        raise NotImplementedError(f"{type(self).__name__} has no batch "
                                  "input contract")

    def input_shapes(self, batch_size: int, seq_len: Optional[int] = None
                     ) -> Tuple[InputSpec, ...]:
        return tuple(InputSpec(tuple(x.shape), x.dtype)
                     for x in self.example_inputs(batch_size, seq_len))

    # --- planning metadata ----------------------------------------------
    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        """Rough forward FLOPs per sample (for roofline sanity checks)."""
        return 0.0

    def param_count(self) -> int:
        """Elements of every weight and statistic (the reference counts
        every leaf of its params tree, BatchNorm statistics included)."""
        return sum(p.numel() for p in self.state_dict().values())

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.state_dict().values())

    # --- distribution ----------------------------------------------------
    def sharding_rules(self) -> List[Tuple[str, Tuple]]:
        """(param-path regex, spec over logical axes) — first match wins
        (reference ``base.py:89-97``). Logical axis names: "tp" (tensor),
        "dp" (data/replica), "sp" (sequence), "ep" (expert). Unmatched
        params replicate."""
        return []

    def partition_spec_for(self, path: str) -> Tuple:
        for pattern, spec in self.sharding_rules():
            if re.search(pattern, path):
                return spec
        return ()

    def flax_leaves(self) -> Dict[str, Tuple[str, Tuple[int, ...],
                                             Tuple[int, ...]]]:
        """Port parameter name -> (the reference's parameter path, the
        flax leaf's shape, the port dimension each flax axis maps to)."""
        raise NotImplementedError(f"{type(self).__name__} has no sharding "
                                  "layout")


def param_path_specs(model: ServableModel
                     ) -> Dict[str, Tuple[str, Tuple, Tuple[int, ...],
                                          Tuple[int, ...]]]:
    """Every parameter's spec via the model's rules (reference
    ``base.py:100-108``): port name -> (reference path, spec, flax shape,
    port dimension of each flax axis)."""
    return {name: (path, model.partition_spec_for(path), shape, dims)
            for name, (path, shape, dims) in model.flax_leaves().items()}


_MODEL_REGISTRY: Dict[str, Callable[..., ServableModel]] = {}
_MODEL_SLOS: Dict[str, ModelSLO] = {}


def register_model(
    name: str, slo: Optional[ModelSLO] = None
) -> Callable[[Callable[..., ServableModel]], Callable[..., ServableModel]]:
    def deco(factory: Callable[..., ServableModel]
             ) -> Callable[..., ServableModel]:
        _MODEL_REGISTRY[name] = factory
        if slo is not None:
            _MODEL_SLOS[name] = slo
        return factory

    return deco


def get_model(name: str, **kwargs: Any) -> ServableModel:
    """Build a registered model; ``device`` defaults to ``"cuda"``."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_MODEL_REGISTRY)}"
        )
    return _MODEL_REGISTRY[name](**kwargs)


def get_slo(name: str) -> Optional[ModelSLO]:
    return _MODEL_SLOS.get(name)


def registered_models() -> List[str]:
    return sorted(_MODEL_REGISTRY)
