"""Map the JAX package's decoder params onto the port's weights.

``params_from_flax(tree, cfg)`` takes the flax params as a nested dict of
numpy arrays (``{"params": {...}}`` or the inner dict) and returns a
``state_dict`` for :class:`~.decoder.DecoderModule` (f32 CPU tensors;
``load_state_dict`` casts them to the model's dtype and device). Layouts:

- ``q``/``k``/``v`` kernels ``[D, N, H]`` / ``[D, K, H]`` -> ``[N*H, D]``;
- the ``o`` kernel ``[N, H, D]`` (DenseGeneral over axes (-2, -1)) ->
  ``[D, N*H]``;
- ``mlp_*`` kernels ``[in, out]`` -> ``[out, in]``; biases flattened;
- ``*_norm`` scale/bias as they are;
- ``tok_embed/embedding`` and ``pos_embed/embedding`` ``[rows, D]`` as
  they are; ``lm_head/kernel`` ``[D, V]`` -> ``[V, D]``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.models.decoder import DecoderConfig


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_flax(tree: Mapping[str, Any],
                     cfg: DecoderConfig) -> Dict[str, torch.Tensor]:
    p = tree.get("params", tree)
    D, N, H = cfg.d_model, cfg.num_heads, cfg.head_dim
    sd: Dict[str, torch.Tensor] = {
        "tok_embed.weight": _t(p["tok_embed"]["embedding"]),
    }
    if cfg.pos == "learned":
        sd["pos_embed.weight"] = _t(p["pos_embed"]["embedding"])

    def norm(prefix: str, leaf: Mapping[str, Any]) -> None:
        sd[f"{prefix}.scale"] = _t(leaf["scale"])
        if cfg.norm == "ln":
            sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def dense(prefix: str, leaf: Mapping[str, Any], d_in: int) -> None:
        kernel = np.asarray(leaf["kernel"], dtype=np.float32)
        sd[f"{prefix}.weight"] = _t(kernel.reshape(d_in, -1).T)
        if cfg.use_bias:
            sd[f"{prefix}.bias"] = _t(np.asarray(leaf["bias"]).reshape(-1))

    for i in range(cfg.num_layers):
        layer = p[f"layer{i}"]
        pre = f"layers.{i}"
        norm(f"{pre}.attn_norm", layer["attn_norm"])
        norm(f"{pre}.mlp_norm", layer["mlp_norm"])
        dense(f"{pre}.q", layer["q"], D)
        dense(f"{pre}.k", layer["k"], D)
        dense(f"{pre}.v", layer["v"], D)
        dense(f"{pre}.o", layer["o"], N * H)
        if cfg.gated_mlp:
            dense(f"{pre}.mlp_gate", layer["mlp_gate"], D)
        dense(f"{pre}.mlp_up", layer["mlp_up"], D)
        dense(f"{pre}.mlp_down", layer["mlp_down"], cfg.mlp_dim)
    norm("final_norm", p["final_norm"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _t(
            np.asarray(p["lm_head"]["kernel"], dtype=np.float32).T)
    return sd
