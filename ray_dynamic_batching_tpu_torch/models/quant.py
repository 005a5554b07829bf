"""Weight byte accounting for serving models, in torch.

Own copy of ``ray_dynamic_batching_tpu/models/quant.py``, trimmed to
:func:`tree_weight_bytes`, the resident weight count that
``LLMDeployment.auto_num_slots`` subtracts from the memory budget and the
decode profiler adds to every row. Here it counts the bytes of a torch
model's ``state_dict`` (``ServableModel.param_bytes``); on params bridged
from a flax tree (``models/convert.py::params_from_flax``) it equals the
reference's count of that tree.

Trimmed: weight-only int8 (``quantize_tree``, ``QTensor``,
``dequantize_tree``, ``quantized_weight_bytes``), which comes with
``LLMDeployment(quantize_weights=True)`` (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Any


def tree_weight_bytes(model: Any) -> int:
    """Device bytes a model's weights keep resident."""
    return model.param_bytes()
