"""DistilBERT-style text classifier, in torch.

Port of ``ray_dynamic_batching_tpu/models/distilbert.py``
(``EncoderBlock``, ``DistilBertModule``, ``DistilBert``; registry
``distilbert_sst2``, BASELINE.json config 1, and ``distilbert_tiny``): a
post-norm encoder with learned positions and a 2-way head over the first
token. Numerics follow the flax reference:

- the fused ``qkv`` projection is one ``[3 * N * H, D]`` weight (the
  reference's ``DenseGeneral((3, N, H))`` kernel ``[D, 3, N, H]``), and
  ``proj`` one ``[D, N * H]`` weight (its ``[N, H, D]``); Dense layers
  compute in the model dtype;
- each residual sum goes through a LayerNorm in f32 (flax's: eps 1e-6,
  fast variance) and is cast back to the model dtype, as is the
  embeddings' LayerNorm;
- GELU is the tanh form (flax ``nn.gelu``'s default);
- ``pre_head`` runs in the model dtype with a ReLU, the ``head`` in f32.

Attention is non-causal with the key mask ``attn_mask[:, None, None, :]``
(made once per forward as the kernels' int8 keep-mask), through
``ops/attention.dot_product_attention``: T >= 16 takes the flash kernel
(kernel 1) and T <= 8 the slab decode kernel (kernel 2), the reference's
routes. Padding rows of ``engine/collate.collate_text`` keep key 0 valid.

Trimmed: the reference's tensor-parallel ``sharding_rules`` (multi-GPU).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.models.base import (
    ModelSLO,
    ServableModel,
    register_model,
)
from ray_dynamic_batching_tpu_torch.models.decoder import Dense, LayerNorm
from ray_dynamic_batching_tpu_torch.ops import attention as attn_ops


@torch.no_grad()
def init_encoder_weights(module: nn.Module, seed: int,
                         device: torch.device) -> None:
    """Random weights from ``seed`` on ``device`` for a module built of
    :class:`~.decoder.Dense`, :class:`~.decoder.LayerNorm`, embeddings and
    ``Conv1d``: LayerNorm scales 1 and biases 0, other biases 0, every
    other weight N(0, 1/fan_in) (fan_in: all but the first axis)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    norms = {id(p) for m in module.modules() if isinstance(m, LayerNorm)
             for p in m.parameters()}
    for name, p in sorted(module.named_parameters()):
        if id(p) in norms:
            p.fill_(1.0 if name.endswith("scale") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=gen)


class EncoderBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, mlp_dim: int, dtype, device):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Dense(d, 3 * d, True, dtype, device)
        self.proj = Dense(d, d, True, dtype, device)
        self.ln1 = LayerNorm(d, device)
        self.mlp_in = Dense(d, mlp_dim, True, dtype, device)
        self.mlp_out = Dense(mlp_dim, d, True, dtype, device)
        self.ln2 = LayerNorm(d, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        B, T, D = x.shape
        N = self.num_heads
        q, k, v = self.qkv(x).view(B, T, 3, N, D // N).unbind(2)
        o = attn_ops.dot_product_attention(q, k, v, mask=mask)
        o = self.proj(o.reshape(B, T, D))
        x = self.ln1(x + o).to(self.dtype)
        y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return self.ln2(x + y).to(self.dtype)


class DistilBertModule(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_len: int = 512,
                 hidden_dim: int = 768, num_layers: int = 6,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 num_classes: int = 2, dtype=torch.bfloat16,
                 device=torch.device("cpu")):
        super().__init__()
        self.vocab_size, self.max_len = vocab_size, max_len
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.num_heads, self.mlp_dim = num_heads, mlp_dim
        self.num_classes = num_classes
        self.dtype = dtype
        self.tok_embed = nn.Embedding(vocab_size, hidden_dim, dtype=dtype,
                                      device=device)
        self.pos_embed = nn.Embedding(max_len, hidden_dim, dtype=dtype,
                                      device=device)
        for emb in (self.tok_embed, self.pos_embed):
            emb.weight.requires_grad_(False)
        self.embed_ln = LayerNorm(hidden_dim, device)
        self.layers = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, dtype, device)
            for _ in range(num_layers))
        self.pre_head = Dense(hidden_dim, hidden_dim, True, dtype, device)
        self.head = Dense(hidden_dim, num_classes, True, torch.float32,
                          device)

    def forward(self, token_ids: torch.Tensor, attn_mask: torch.Tensor
                ) -> torch.Tensor:
        """token_ids, attn_mask [B, T] -> f32 logits [B, num_classes]."""
        B, T = token_ids.shape
        pos = torch.arange(T, device=token_ids.device)
        x = self.tok_embed(token_ids.long()) + self.pos_embed(pos)[None]
        x = self.embed_ln(x).to(self.dtype)
        # [B, 1, T, T] keep-mask: keys at padding positions are masked.
        mask = attn_ops.kernel_mask(attn_mask[:, None, None, :].bool(), B, T)
        for layer in self.layers:
            x = layer(x, mask)
        h = F.relu(self.pre_head(x[:, 0]))
        return self.head(h)


class DistilBert(ServableModel):
    family = "text_classifier"

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = "cuda",
                 seed: Optional[int] = 0, name: str = "distilbert_sst2",
                 **module_kwargs):
        super().__init__(dtype, device)
        self.name = name
        self.module = DistilBertModule(dtype=dtype, device=self.device,
                                       **module_kwargs)
        if seed is not None:
            self.init_random(seed)

    @torch.no_grad()
    def init_random(self, seed: int) -> None:
        """Random weights from ``seed``, drawn on the model's device:
        matrices and embeddings N(0, 1/fan_in), LayerNorm scales 1,
        biases 0 (flax's default initializers in distribution)."""
        init_encoder_weights(self.module, seed, self.device)

    def forward(self, token_ids: torch.Tensor, attn_mask: torch.Tensor
                ) -> torch.Tensor:
        return self.module(token_ids, attn_mask)

    def example_inputs(self, batch_size: int, seq_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        T = seq_len or 128
        return (torch.zeros((batch_size, T), dtype=torch.int32,
                            device=self.device),
                torch.ones((batch_size, T), dtype=torch.int32,
                           device=self.device))

    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        T = seq_len or 128
        d, m = self.module.hidden_dim, self.module.mlp_dim
        per_layer = 4 * T * d * d + 2 * T * T * d + 2 * T * d * m
        return 2.0 * self.module.num_layers * per_layer


@register_model("distilbert_sst2", slo=ModelSLO(latency_slo_ms=100.0))
def _distilbert(**kwargs) -> DistilBert:
    return DistilBert(**kwargs)


@register_model("distilbert_tiny")
def _distilbert_tiny(**kwargs) -> DistilBert:
    return DistilBert(name="distilbert_tiny", vocab_size=1000, max_len=128,
                      hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128,
                      **kwargs)
