"""Shared causal-decoder transformer with an explicit KV cache, in torch.

Port of ``ray_dynamic_batching_tpu/models/decoder.py`` (the slab cache and
the paged pool): one
config-driven module covers both families — RoPE/RMSNorm/SwiGLU/GQA for
Llama, learned positions/LayerNorm/GeLU/bias/tied embeddings for GPT-2.

Numerics follow the flax reference:

- Dense layers compute in the model dtype (flax ``DenseGeneral(dtype=bf16,
  param_dtype=f32)`` casts input and kernel before the product), so the
  weights are stored in the model dtype — the same numbers at half the
  bytes of the reference's f32 params.
- RMSNorm computes in f32 (eps 1e-5) and casts back; LayerNorm is flax's
  (eps 1e-6, fast variance E[x^2] - E[x]^2, f32 output).
- GeLU is the tanh approximation (flax ``nn.gelu`` default).
- The untied ``lm_head`` is f32; tied logits go through flax
  ``Embed.attend``, which promotes to the embedding dtype.
- RoPE rotates split halves with angles in f32.

Where JAX donated the cache buffers, the port writes the cache in place.
The paged pool keeps one extra SINK page past the ``P`` real ones: the
reference's sentinel-steered ``mode="drop"`` writes land there (an index
of ``P`` would be out of bounds in torch, and clamping a dropped write
onto a real page could race another slot's write to the same cell), and
no read ever names it. Int8 KV and MoE are later slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.ops import attention as attn_ops


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    d_model: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    mlp_dim: int
    max_seq_len: int = 2048
    pos: str = "rope"  # "rope" | "learned"
    norm: str = "rms"  # "rms" | "ln"
    gated_mlp: bool = True  # SwiGLU vs plain GeLU MLP
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclass
class KVCache:
    """Slab cache: k/v [L, B, S, K, H]; lengths [B] int32 = valid prefix."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def zeros(cfg: DecoderConfig, batch_size: int,
              max_len: Optional[int] = None,
              dtype: torch.dtype = torch.bfloat16,
              device: torch.device = torch.device("cpu")) -> "KVCache":
        S = max_len or cfg.max_seq_len
        shape = (cfg.num_layers, batch_size, S, cfg.num_kv_heads,
                 cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch_size,), dtype=torch.int32,
                                device=device),
        )

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


@dataclass
class PagedKVCache:
    """Paged KV pool: k/v [L, P + 1, ps, K, H] — ``P`` real pages plus the
    sink page ``P`` — gathered per slot through ``page_table`` [B, NP]
    int32 (entry j names the physical page backing logical positions
    [j*ps, (j+1)*ps) of that slot; unallocated entries carry the sentinel
    ``P``, so writes through them land in the sink and reads clamp to
    page ``P - 1`` under the length mask); lengths [B] int32."""

    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def zeros(cfg: DecoderConfig, batch_size: int, num_pages: int,
              page_size: int, max_len: int,
              dtype: torch.dtype = torch.bfloat16,
              device: torch.device = torch.device("cpu")) -> "PagedKVCache":
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size} (logical capacity is whole pages)"
            )
        shape = (cfg.num_layers, num_pages + 1, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            page_table=torch.full((batch_size, max_len // page_size),
                                  num_pages, dtype=torch.int32,
                                  device=device),
            lengths=torch.zeros((batch_size,), dtype=torch.int32,
                                device=device),
        )

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        """Real pages (the sink page is not counted)."""
        return self.k.shape[1] - 1

    @property
    def capacity(self) -> int:
        """Per-slot LOGICAL capacity: table width x page size."""
        return self.page_table.shape[1] * self.k.shape[2]


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """(cos, sin) [B, T, 1, H/2] in f32 for ``positions`` [B, T] — computed
    once per forward and shared by every layer's q and k."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exponent)
    angles = positions.to(torch.float32)[..., None] * freqs   # [B, T, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves of x [B, T, N, H] in f32, cast back."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over split halves. x [B, T, N, H], positions [B, T]."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=f32)``: output in f32."""

    def __init__(self, dim: int, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), torch.float32, device)
        self.bias = _param((dim,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.pow(2).mean(-1, keepdim=True) - mean.pow(2),
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean) * mul + self.bias


class Dense(nn.Module):
    """y = x @ W.T (+ b) in the weight dtype; W [out, in]."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device):
        super().__init__()
        self.weight = _param((d_out, d_in), dtype, device)
        self.bias = _param((d_out,), dtype, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


def _norm(cfg: DecoderConfig, device) -> nn.Module:
    if cfg.norm == "rms":
        return RMSNorm(cfg.d_model, device)
    return LayerNorm(cfg.d_model, device)


def decode_write_index(idx: torch.Tensor, capacity: int):
    """(rows, safe, inside) for :func:`write_decode_rows`, computed once
    per decode forward. Rows at idx >= capacity (the reference's
    ``mode="drop"`` scatter) are steered to position capacity - 1 and
    write back what is already there, so no host sync filters them."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    inside = (idx >= 0) & (idx < capacity)
    safe = torch.where(inside, idx, torch.full_like(idx, capacity - 1))
    return rows, safe.long(), inside[:, None, None]


def write_decode_rows(full: torch.Tensor, index, new: torch.Tensor) -> None:
    """In place: full[b, idx[b]] = new[b] for every row inside capacity;
    the others are dropped. full [B, S, K, H], new [B, K, H], ``index``
    from :func:`decode_write_index`."""
    rows, safe, inside = index
    keep = full[rows, safe]
    full[rows, safe] = torch.where(inside, new.to(full.dtype), keep)


def paged_write_index(positions: torch.Tensor, page_table: torch.Tensor,
                      num_pages: int, page_size: int):
    """(page, offset) [B, T] long for writing tokens at ``positions``
    [B, T] through ``page_table`` [B, NP]: the reference's paged write
    rule (``decoder.py:305-314``). Unallocated entries carry the sentinel
    ``num_pages`` and positions past logical capacity are steered to it,
    so those writes land in the sink page — dropped, as ``mode="drop"``
    drops them."""
    n_entries = page_table.shape[1]
    idx = positions.long()
    pidx = torch.clamp(idx // page_size, max=n_entries - 1)
    pid = torch.gather(page_table.long(), 1, pidx)
    pid = torch.where(idx < n_entries * page_size, pid,
                      torch.full_like(pid, num_pages))
    return pid, idx % page_size


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D, N, K, H = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)
        b = cfg.use_bias
        self.attn_norm = _norm(cfg, device)
        self.q = Dense(D, N * H, b, dtype, device)
        self.k = Dense(D, K * H, b, dtype, device)
        self.v = Dense(D, K * H, b, dtype, device)
        self.o = Dense(N * H, D, b, dtype, device)
        self.mlp_norm = _norm(cfg, device)
        if cfg.gated_mlp:
            self.mlp_gate = Dense(D, cfg.mlp_dim, b, dtype, device)
        self.mlp_up = Dense(D, cfg.mlp_dim, b, dtype, device)
        self.mlp_down = Dense(cfg.mlp_dim, D, b, dtype, device)

    def forward(
        self,
        x: torch.Tensor,                 # [B, T, D]
        positions: torch.Tensor,         # [B, T]
        mask: Optional[torch.Tensor],    # [B, 1, T, S] True = attend
        cache: Optional[KVCache] = None,
        layer_idx: int = 0,
        rope=None,          # (cos, sin) from rope_tables (rope models)
        write_index=None,   # decode_write_index / paged_write_index
        page_table: Optional[torch.Tensor] = None,  # [B, NP]: paged pool
        kv_lengths: Optional[torch.Tensor] = None,  # [B] paged bound
    ) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        N, K, H = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        y = self.attn_norm(x).to(self.dtype)
        q = self.q(y).view(B, T, N, H)
        k = self.k(y).view(B, T, K, H)
        v = self.v(y).view(B, T, K, H)
        if cfg.pos == "rope":
            q = rotate(q, *rope)
            k = rotate(k, *rope)
        if cache is not None and page_table is not None:
            # Paged: the cache arrays are page pools [L, P + 1, ps, K, H];
            # each token's position maps through its row's table to a
            # physical (page, offset) — decode (T == 1) and per-row chunk
            # windows alike. Dropped writes land in the sink page P,
            # which the read below never sees.
            pid, off = write_index
            k_pool, v_pool = cache.k[layer_idx], cache.v[layer_idx]
            k_pool[pid, off] = k.to(k_pool.dtype)
            v_pool[pid, off] = v.to(v_pool.dtype)
            P = cache.num_pages
            attn = attn_ops.dot_product_attention(
                q, k_pool[:P], v_pool[:P], page_table=page_table,
                kv_lengths=kv_lengths)
        elif cache is not None:
            # In-place writes into the stacked [L, B, S, K, H] cache (the
            # reference donates the buffer and XLA updates it in place).
            k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
            if T == 1:
                # Decode: this token's k/v at its row position; a full
                # row's write at position S is dropped.
                write_decode_rows(k_full, write_index, k[:, 0])
                write_decode_rows(v_full, write_index, v[:, 0])
            else:
                # Prefill: contiguous write at offset 0.
                k_full[:, :T] = k.to(k_full.dtype)
                v_full[:, :T] = v.to(v_full.dtype)
            attn = attn_ops.dot_product_attention(q, k_full, v_full,
                                                  mask=mask)
        else:
            attn = attn_ops.dot_product_attention(q, k, v, mask=mask)
        x = x + self.o(attn.reshape(B, T, N * H))

        y = self.mlp_norm(x).to(self.dtype)
        if cfg.gated_mlp:
            y = F.silu(self.mlp_gate(y)) * self.mlp_up(y)
        else:
            y = F.gelu(self.mlp_up(y), approximate="tanh")
        return x + self.mlp_down(y)


class DecoderModule(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype=torch.bfloat16,
                 device=torch.device("cpu")):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                      dtype=dtype, device=device)
        self.tok_embed.weight.requires_grad_(False)
        if cfg.pos == "learned":
            self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.d_model,
                                          dtype=dtype, device=device)
            self.pos_embed.weight.requires_grad_(False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device) for _ in range(cfg.num_layers)
        )
        self.final_norm = _norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, False,
                                 torch.float32, device)

    def forward(
        self,
        tokens: torch.Tensor,              # [B, T]
        positions: torch.Tensor,           # [B, T]
        mask: Optional[torch.Tensor],      # [B, 1, T, S]
        cache=None,                        # KVCache or PagedKVCache
        take: Optional[torch.Tensor] = None,  # [B]: only these rows' logits
        page_table: Optional[torch.Tensor] = None,  # [B, NP] (paged)
        kv_lengths: Optional[torch.Tensor] = None,  # [B] (paged)
    ) -> torch.Tensor:
        """Logits [B, T, V] — or [B, V] at row ``take[b]`` of each batch
        row (the head runs only on the rows the caller keeps; per-row the
        numbers are the ones the full [B, T, V] would hold)."""
        x = self.tok_embed(tokens.long())
        if self.cfg.pos == "learned":
            # A row steered past capacity (its write dropped, its output
            # never used) may sit past the table; clamp it in range.
            x = x + self.pos_embed(
                torch.clamp(positions.long(), max=self.cfg.max_seq_len - 1))
        # Per-forward tables shared by every layer (host work once, not
        # once per layer).
        rope = None
        if self.cfg.pos == "rope":
            rope = rope_tables(positions, self.cfg.head_dim,
                               self.cfg.rope_theta)
        write_index = None
        if cache is not None and page_table is not None:
            write_index = paged_write_index(positions, page_table,
                                            cache.num_pages, cache.page_size)
        elif cache is not None and tokens.shape[1] == 1:
            write_index = decode_write_index(positions[:, 0], cache.capacity)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, mask, cache, layer_idx=i, rope=rope,
                      write_index=write_index, page_table=page_table,
                      kv_lengths=kv_lengths)
        x = self.final_norm(x)
        if take is not None:
            x = x[torch.arange(x.shape[0], device=x.device), take.long()]
        if self.cfg.tie_embeddings:
            w = self.tok_embed.weight
            return F.linear(x.to(w.dtype), w)
        return self.lm_head(x.float())


def prefill_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """Causal mask limited to valid tokens. attn_mask [B, T] -> [B, 1, T, T]."""
    T = attn_mask.shape[1]
    causal = torch.ones((T, T), dtype=torch.bool,
                        device=attn_mask.device).tril()
    valid = attn_mask[:, None, None, :].bool()
    return causal[None, None] & valid


def decode_mask(lengths: torch.Tensor, capacity: int) -> torch.Tensor:
    """Attend to positions [0, lengths] inclusive. lengths [B] -> [B,1,1,S]."""
    pos = torch.arange(capacity, device=lengths.device)[None, None, None, :]
    return pos <= lengths[:, None, None, None]


def paged_window_mask(lengths: torch.Tensor, capacity: int,
                      window: int) -> torch.Tensor:
    """STAIRCASE window over the paged logical view: window row t attends
    positions [0, lengths + t] inclusive. lengths [B] -> [B, 1, window,
    capacity]; ``window == 1`` is exactly :func:`decode_mask`."""
    pos = torch.arange(capacity, device=lengths.device)[None, None, None, :]
    bound = lengths[:, None] + torch.arange(window, device=lengths.device)
    return pos <= bound[:, None, :, None]
