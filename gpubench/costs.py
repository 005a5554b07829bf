"""What a window's work needs, from a configuration's shapes alone.

The operations and bytes here are what the traffic the window served
needs at the precision the configuration states, whatever kernel ran
it: each weight byte read once a forward pass, each cached key and value
byte read once a decoded token, each prompt token's products done once.
A roofline share divides the least time these need on the card by the
time the device spent, so it reads the same work whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

PEAK_BF16_FLOPS = 989e12      # bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12      # HBM3 bytes/s

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Shapes:
    """The sizes of a decoder that the cost functions read."""

    vocab: int
    d_model: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    mlp_dim: int
    gated: bool
    dtype_bytes: int

    @classmethod
    def of(cls, config: Dict) -> "Shapes":
        d = config["decoder"]
        return cls(vocab=int(d["vocab_size"]), d_model=int(d["d_model"]),
                   layers=int(d["num_layers"]), heads=int(d["num_heads"]),
                   kv_heads=int(d["num_kv_heads"]),
                   head_dim=int(d["d_model"]) // int(d["num_heads"]),
                   mlp_dim=int(d["mlp_dim"]), gated=bool(d["gated_mlp"]),
                   dtype_bytes=_DTYPE_BYTES[config["dtype"]])


def layer_weights(s: Shapes) -> int:
    """Weight elements of one layer's products: q, k, v, o and the MLP."""
    attn = s.d_model * s.head_dim * (2 * s.heads + 2 * s.kv_heads)
    mlp = (3 if s.gated else 2) * s.d_model * s.mlp_dim
    return attn + mlp


def body_weights(s: Shapes) -> int:
    """Weight elements of every layer's products (not the head)."""
    return s.layers * layer_weights(s)


def head_weights(s: Shapes) -> int:
    return s.d_model * s.vocab


def kv_bytes_per_position(s: Shapes) -> int:
    """Cached key and value bytes of one position over every layer."""
    return 2 * s.layers * s.kv_heads * s.head_dim * s.dtype_bytes


def attention_flops(s: Shapes, keys: int) -> float:
    """Scores and values of one query token over ``keys`` keys, every
    layer and head."""
    return 4.0 * s.layers * s.heads * s.head_dim * keys


def token_flops(s: Shapes, keys: int, with_head: bool) -> float:
    """One token through the model: the products, its attention over
    ``keys`` keys, and the head where the token needs logits."""
    f = 2.0 * body_weights(s) + attention_flops(s, keys)
    if with_head:
        f += 2.0 * head_weights(s)
    return f


def prompt_flops(s: Shapes, length: int) -> float:
    """A whole prompt: token p attends p + 1 keys; only the last token
    needs logits."""
    keys = length * (length + 1) // 2
    return (2.0 * body_weights(s) * length + attention_flops(s, keys)
            + 2.0 * head_weights(s))


def gemm_least_s(s: Shapes, steps: int, decode_tokens: int,
                 prompt_tokens: int, prompts: int) -> float:
    """Least time of the weight products: each decode step reads the
    weights once (a step's rows are fewer than the card's FLOP-to-byte
    ratio, so the bytes bound it, unless its products bound it), and the
    prompt tokens' products are counted as operations only, as if they
    rode on those reads."""
    w_bytes = (body_weights(s) + head_weights(s)) * s.dtype_bytes
    per_step_tokens = decode_tokens / steps if steps else 0.0
    step_flops = 2.0 * (body_weights(s) + head_weights(s)) * per_step_tokens
    decode_s = steps * max(step_flops / PEAK_BF16_FLOPS,
                           w_bytes / PEAK_HBM_BYTES)
    fill_flops = 2.0 * (body_weights(s) * prompt_tokens
                        + head_weights(s) * prompts)
    return decode_s + fill_flops / PEAK_BF16_FLOPS


def decode_kv_least_s(s: Shapes, keys_read: int) -> float:
    """Least time of decode attention: ``keys_read`` is the sum over the
    decoded tokens of the keys each attends; each byte read once."""
    return keys_read * kv_bytes_per_position(s) / PEAK_HBM_BYTES
