"""Vision Transformer servables, in torch.

Port of ``ray_dynamic_batching_tpu/models/vit.py``: ``vit_b_16``,
``vit_g_14`` and ``vit_tiny``. Attention goes through
:func:`~ray_dynamic_batching_tpu_torch.ops.attention.dot_product_attention`
(q, k and v ``[B, T, N, H]``, non-causal, no mask), which sends ViT-B/16's
197 tokens of head_dim 64 and ViT-G/14's 257 of 104 to the flash kernel;
q, k and v are views of the packed ``qkv`` output, which the kernel reads
in place. Matmuls run in ``dtype`` (bf16 by
default); the LayerNorms (eps 1e-6) and the head run in f32, and the MLP
uses the tanh GELU (flax's ``nn.gelu`` default), as the reference's. The
``qkv`` projection is one ``[3 * N * H, D]`` weight (the reference's
``DenseGeneral`` kernel ``[D, 3, N, H]``), ``proj`` one ``[D, N * H]``
weight (its ``[N, H, D]``).

Trimmed: the reference's tensor-parallel ``sharding_rules`` (the multi-GPU
slice).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.models.base import (
    ModelSLO,
    register_model,
)
from ray_dynamic_batching_tpu_torch.models.layers import (
    Conv,
    Dense,
    VisionModel,
    init_vision_weights,
    nchw,
)
from ray_dynamic_batching_tpu_torch.ops import attention as attn_ops


def make_layer_norm(d: int, device: torch.device) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-6, dtype=torch.float32, device=device)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=f32)``: f32 in, f32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class ViTBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, mlp_dim: int, **kw):
        super().__init__()
        dev = kw["device"]
        self.num_heads = num_heads
        self.ln1 = make_layer_norm(d, dev)
        self.qkv = Dense(d, 3 * d, **kw)
        self.proj = Dense(d, d, **kw)
        self.ln2 = make_layer_norm(d, dev)
        self.mlp_in = Dense(d, mlp_dim, **kw)
        self.mlp_out = Dense(mlp_dim, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        N = self.num_heads
        y = layer_norm(x, self.ln1).to(x.dtype)
        q, k, v = self.qkv(y).view(B, T, 3, N, D // N).unbind(2)
        o = attn_ops.dot_product_attention(q, k, v)
        x = x + self.proj(o.reshape(B, T, D))
        y = layer_norm(x, self.ln2).to(x.dtype)
        y = self.mlp_out(F.gelu(self.mlp_in(y), approximate="tanh"))
        return x + y


class ViT(VisionModel):
    def __init__(
        self,
        image_size: int = 224,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device, None] = "cuda",
        seed: Optional[int] = 0,
        name: str = "vit_b_16",
        patch_size: int = 16,
        hidden_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        num_classes: int = 1000,
    ):
        super().__init__(image_size, dtype, device, name)
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim
        kw = dict(dtype=dtype, device=self.device)
        tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = Conv(3, hidden_dim, patch_size, stride=patch_size,
                                bias=True, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden_dim, **kw))
        self.blocks = nn.ModuleList(
            ViTBlock(hidden_dim, num_heads, mlp_dim, **kw)
            for _ in range(num_layers))
        self.ln_final = make_layer_norm(hidden_dim, self.device)
        self.head = Dense(hidden_dim, num_classes, dtype=torch.float32,
                          device=self.device)
        self.to(memory_format=torch.channels_last)
        if seed is not None:
            init_vision_weights(self, seed, self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = self.patch_embed(nchw(x, self.dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, 1, -1), x], dim=1)
        x = x + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.head(layer_norm(x, self.ln_final)[:, 0])

    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        n_tokens = (self.image_size // self.patch_size) ** 2 + 1
        d = self.hidden_dim
        per_layer = 4 * n_tokens * d * d + 2 * n_tokens * n_tokens * d
        per_layer += 2 * n_tokens * d * self.mlp_dim
        return 2.0 * self.num_layers * per_layer


@register_model("vit_b_16", slo=ModelSLO(latency_slo_ms=4000.0))
def _vit_b16(**kwargs) -> ViT:
    return ViT(name="vit_b_16", **kwargs)


@register_model("vit_g_14")
def _vit_g14(**kwargs) -> ViT:
    return ViT(
        name="vit_g_14",
        patch_size=14,
        hidden_dim=1664,
        num_layers=48,
        num_heads=16,
        mlp_dim=8192,
        **kwargs,
    )


@register_model("vit_tiny")
def _vit_tiny(**kwargs) -> ViT:
    kwargs.setdefault("image_size", 32)
    return ViT(
        name="vit_tiny",
        patch_size=8,
        hidden_dim=64,
        num_layers=2,
        num_heads=4,
        mlp_dim=128,
        num_classes=10,
        **kwargs,
    )
