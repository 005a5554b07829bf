"""Shared causal-decoder transformer with an explicit KV cache, in torch.

Port of ``ray_dynamic_batching_tpu/models/decoder.py`` (the slab cache,
the paged pool and the int8 KV cache): one
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
no read ever names it. With ``kv_dtype=int8`` both caches hold int8 codes
plus one f32 scale per cached (token, head) row, quantized at every write
(:func:`quantize_kv_rows`). The slab cache's planes keep one sink row
per layer past their last position, where the speculative verify's
per-row window writes drop what falls past capacity
(:func:`window_write_index`).

Weight-only int8 (``models/quant.py::quantize_tree``) turns a
:class:`Dense`'s weight into int8 codes plus f32 scales at the flax
kernel's granularity (``weight_codes`` / ``weight_scale``), routed through
``ops/quant_matmul.int8_linear``. With ``cfg.num_experts > 0`` the MLP is
a mixture of experts (``models/moe.py::MoEBlock``).

With no cache, a ``token_mask`` [B, T] (the reference's no-cache path,
``CausalLM.apply``) builds the causal + padding attention in
``ops/attention.self_attention``; ``return_aux`` also returns the MoE
layers' load-balance losses summed (0 for a dense model), the
reference's ``intermediates`` collection.

Under a tensor-parallel mesh (``parallel/mesh.py::apply_tp``) each rank
holds its slice of the weights, and the collectives GSPMD inserts in the
reference are written out on the mesh's ``tp`` group: q/k/v and gate/up
are column-parallel (a rank computes its heads and its MLP columns), o
and down are row-parallel, each product summed over the ranks before its
bias; the vocabulary-sharded embedding looks up its own rows, writes
zeros elsewhere and sums; the vocabulary-sharded head's logits are
gathered before sampling. Where the kv heads replicate but q is cut
(``kv_window``), a rank's query head reads the kv head of its GLOBAL
index ``n // G``: the attention reads the contiguous window of kv heads
its heads need, and where the rank's heads straddle a group boundary
(``kv_index``) each head's own kv head of it.

In training (``parallel/train.py``) the same collectives are
autograd-aware (``parallel/mesh.py::AxisGroup``): the column-parallel
inputs of q/k/v and of the MLP pass through ``attn_in`` / ``mlp_in``
(identity forward, gradient summed over tp), the row-parallel sums and
the embedding's sum pass the gradient through, and the gathered logits
hand each rank its slice of the gradient. The no-cache path makes the
int8 keep-mask of its token mask once per forward and every layer's
attention takes it; under ``ops/attention.sequence_parallel`` it takes
ring attention over the sequence chunks instead (the model then sees this
rank's chunk and its global positions).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.ops import attention as attn_ops
from ray_dynamic_batching_tpu_torch.ops import quant_matmul


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
    num_experts: int = 0      # > 0 switches the MLP to a MoE block
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _scale_planes(shape, dtype, device, alloc=torch.zeros):
    """(k_scale, v_scale) f32 zeros of ``shape[:-1]`` for an int8 cache
    (made by ``alloc``), else (None, None)."""
    if dtype != torch.int8:
        return None, None
    return (alloc(shape[:-1], dtype=torch.float32, device=device),
            alloc(shape[:-1], dtype=torch.float32, device=device))


def _slab_plane(shape, dtype, device) -> torch.Tensor:
    """A zeroed slab plane ``[L, B, S, ...]`` whose every layer is
    followed in memory by one SINK row (``[...]``, one position's worth):
    each layer's ``[B, S, ...]`` is contiguous, and :func:`sink_rows`
    views it as ``B * S + 1`` rows, the last of which a window write
    steers its dropped positions to (the reference's ``mode="drop"``;
    nothing reads the sink)."""
    L, B, S = shape[:3]
    rest = tuple(shape[3:])
    store = torch.zeros((L, B * S + 1) + rest, dtype=dtype, device=device)
    return store[:, :B * S].view((L, B, S) + rest)


def sink_rows(full: torch.Tensor) -> torch.Tensor:
    """One layer of a slab plane (``full`` [B, S, ...], made by
    :func:`_slab_plane`) as ``B * S + 1`` rows: row ``b * S + p`` is
    position p of slot b, row ``B * S`` the layer's sink."""
    B, S = full.shape[:2]
    row = full[0, 0].numel()
    end = (full.storage_offset() + (B * S + 1) * row) * full.element_size()
    if not full.is_contiguous() or end > full.untyped_storage().nbytes():
        raise ValueError("window write into a slab plane without a sink row")
    return full.as_strided((B * S + 1,) + tuple(full.shape[2:]),
                           (row,) + tuple(full.stride()[2:]),
                           full.storage_offset())


@dataclass
class KVCache:
    """Slab cache: k/v [L, B, S, K, H]; lengths [B] int32 = valid prefix.
    An int8 cache holds codes in k/v and one f32 scale per cached
    (token, head) row in ``k_scale``/``v_scale`` [L, B, S, K]. Each
    plane's layers carry one sink row past their last position
    (:func:`sink_rows`), where a window write drops what falls past
    capacity."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(cfg: DecoderConfig, batch_size: int,
              max_len: Optional[int] = None,
              dtype: torch.dtype = torch.bfloat16,
              device: torch.device = torch.device("cpu"),
              kv_heads: Optional[int] = None) -> "KVCache":
        """``kv_heads``: a rank's share under a mesh (default all)."""
        S = max_len or cfg.max_seq_len
        shape = (cfg.num_layers, batch_size, S,
                 kv_heads or cfg.num_kv_heads, cfg.head_dim)
        k_scale, v_scale = _scale_planes(shape, dtype, device,
                                         alloc=_slab_plane)
        return KVCache(
            k=_slab_plane(shape, dtype, device),
            v=_slab_plane(shape, dtype, device),
            lengths=torch.zeros((batch_size,), dtype=torch.int32,
                                device=device),
            k_scale=k_scale, v_scale=v_scale,
        )

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


@dataclass
class PagedKVCache:
    """Paged KV pool: k/v [L, P + 1, ps, K, H] — ``P`` real pages plus the
    sink page ``P`` — gathered per slot through ``page_table`` [B, NP]
    int32 (entry j names the physical page backing logical positions
    [j*ps, (j+1)*ps) of that slot; unallocated entries carry the sentinel
    ``P``, so writes through them land in the sink and reads clamp to
    page ``P - 1`` under the length mask); lengths [B] int32. An int8
    pool holds codes plus ``k_scale``/``v_scale`` [L, P + 1, ps, K] f32,
    paged by the same table (the sink page takes dropped scale writes
    too)."""

    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(cfg: DecoderConfig, batch_size: int, num_pages: int,
              page_size: int, max_len: int,
              dtype: torch.dtype = torch.bfloat16,
              device: torch.device = torch.device("cpu"),
              kv_heads: Optional[int] = None) -> "PagedKVCache":
        """``kv_heads``: a rank's share under a mesh (default all)."""
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size} (logical capacity is whole pages)"
            )
        shape = (cfg.num_layers, num_pages + 1, page_size,
                 kv_heads or cfg.num_kv_heads, cfg.head_dim)
        k_scale, v_scale = _scale_planes(shape, dtype, device)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            page_table=torch.full((batch_size, max_len // page_size),
                                  num_pages, dtype=torch.int32,
                                  device=device),
            lengths=torch.zeros((batch_size,), dtype=torch.int32,
                                device=device),
            k_scale=k_scale, v_scale=v_scale,
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

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quantization: x [..., H] ->
    (codes int8 [..., H], scale f32 [...]). The reference's rule exactly:
    scale absmax / 127 (1 for an all-zero row), the division (not a
    multiplication by its reciprocal), round half to even, clip to
    +-127 — so equal inputs give bit-identical codes."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """codes int8 [..., H] * scale [...] -> [..., H] in ``dtype``: the one
    dequant rule, used by every attention route that does not read the
    codes itself."""
    return (codes.float() * scale[..., None]).to(dtype)


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
    """y = x @ W.T (+ b) in the layer's ``dtype``; W [out, in].

    ``flax_in`` / ``flax_out`` are the flax kernel's contracted and output
    axes (q: ``(D,)`` / ``(N, H)``, kernel ``[D, N, H]``; o: ``(N, H)`` /
    ``(D,)``); default ``(d_in,)`` / ``(d_out,)``. Weight-only int8 keeps
    one scale per index of the flax kernel's last axis: row r of W takes
    ``scale[r % flax_out[-1]]``. Once quantized (``models/quant.py``) the
    weight is ``weight_codes`` int8 [out, in] + ``weight_scale`` f32
    [flax_out[-1]], dequantized in ``weight_dtype`` (the model's) inside
    ``ops/quant_matmul.int8_linear``; a bias the flax rule quantizes (2-D
    in flax, e.g. q's ``[N, H]``) becomes ``bias_codes`` / ``bias_scale``."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device,
                 flax_in: Optional[Tuple[int, ...]] = None,
                 flax_out: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.dtype = dtype
        self.flax_in = tuple(flax_in or (d_in,))
        self.flax_out = tuple(flax_out or (d_out,))
        self.weight = _param((d_out, d_in), dtype, device)
        self.bias = _param((d_out,), dtype, device) if bias else None
        for name in ("weight_codes", "weight_scale", "bias_codes",
                     "bias_scale"):
            self.register_parameter(name, None)
        self.weight_dtype: Optional[torch.dtype] = None
        # Row-parallel under a mesh: the sum over the ranks of their
        # partial products, taken before the (whole) bias is added.
        self.reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.weight_codes is None:
            if self.reduce is not None:
                y = self.reduce(F.linear(x, self.weight))
                return y if self.bias is None else y + self.bias
            return F.linear(x, self.weight, self.bias)
        bias = self.bias
        if self.bias_codes is not None:
            bias = quant_matmul.dequantize_rows(
                self.bias_codes, self.bias_scale,
                self.weight_dtype).to(self.dtype)
        return quant_matmul.int8_linear(x, self.weight_codes,
                                        self.weight_scale, bias,
                                        weight_dtype=self.weight_dtype)


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
    return rows, safe.long(), inside


def write_decode_rows(full: torch.Tensor, index, new: torch.Tensor) -> None:
    """In place: full[b, idx[b]] = new[b] for every row inside capacity;
    the others are dropped. full [B, S, ...], new [B, ...] (k/v rows
    [B, K, H] or their scales [B, K]), ``index`` from
    :func:`decode_write_index`."""
    rows, safe, inside = index
    keep = full[rows, safe]
    inside = inside.view((-1,) + (1,) * (new.dim() - 1))
    full[rows, safe] = torch.where(inside, new.to(full.dtype), keep)


def window_write_index(positions: torch.Tensor, capacity: int
                       ) -> torch.Tensor:
    """Rows [B, T] long into a slab layer's :func:`sink_rows` for writing
    each row's window at its own ``positions`` [B, T] (the reference's
    per-row ``scatter_writes``): ``b * S + p`` inside capacity, the sink
    row ``B * S`` otherwise — dropped, as ``mode="drop"`` drops them. No
    two kept writes share a row, and nothing reads the sink."""
    B = positions.shape[0]
    idx = positions.long()
    rows = torch.arange(B, device=idx.device)[:, None] * capacity + idx
    inside = (idx >= 0) & (idx < capacity)
    return torch.where(inside, rows, torch.full_like(rows, B * capacity))


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
        # This rank's query and kv heads, and under a mesh where k/v
        # replicate but q is cut, the (first, count) window of kv heads
        # its query heads read (parallel/mesh.py::apply_tp).
        self.heads = (N, K)
        self.kv_window: Optional[Tuple[int, int]] = None
        # Where those query heads straddle a group boundary: each local
        # head's index into the window ([N] long), else None.
        self.kv_index: Optional[torch.Tensor] = None
        # Under a mesh that cuts q/k/v (or the MLP's columns): the input's
        # gradient is summed over tp (AxisGroup.copy_in); None otherwise.
        self.attn_in: Optional[Callable] = None
        self.mlp_in: Optional[Callable] = None
        self.attn_norm = _norm(cfg, device)
        self.q = Dense(D, N * H, b, dtype, device, flax_out=(N, H))
        self.k = Dense(D, K * H, b, dtype, device, flax_out=(K, H))
        self.v = Dense(D, K * H, b, dtype, device, flax_out=(K, H))
        self.o = Dense(N * H, D, b, dtype, device, flax_in=(N, H))
        self.mlp_norm = _norm(cfg, device)
        if cfg.num_experts > 0:
            from ray_dynamic_batching_tpu_torch.models.moe import MoEBlock

            self.moe = MoEBlock(
                D, cfg.mlp_dim, cfg.num_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor,
                gated=cfg.gated_mlp, dtype=dtype, device=device)
            return
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
        write_start: int = 0,  # slab prefill: position of the chunk's row 0
        scatter_writes: bool = False,  # slab: per-row windows (verify)
        token_mask: Optional[torch.Tensor] = None,  # [B, T]: no-cache path
        return_aux: bool = False,  # also the MoE load-balance loss
    ):
        cfg = self.cfg
        B, T, _ = x.shape
        (N, K), H = self.heads, cfg.head_dim
        y = self.attn_norm(x).to(self.dtype)
        if self.attn_in is not None:
            y = self.attn_in(y)
        q = self.q(y).view(B, T, N, H)
        k = self.k(y).view(B, T, K, H)
        v = self.v(y).view(B, T, K, H)
        if cfg.pos == "rope":
            q = rotate(q, *rope)
            k = rotate(k, *rope)
        if cache is not None:
            # An int8 cache stores codes + per-row scales, and every write
            # path writes both with the SAME indices. The read below takes
            # what was written, so a prompt's own keys are attended as
            # their quantized values, in prefill too (as the reference).
            k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
            writes = [(k_full, k), (v_full, v)]
            scales = {}
            if cache.quantized:
                k_w, k_s = quantize_kv_rows(k)
                v_w, v_s = quantize_kv_rows(v)
                scales = {"k_scale": cache.k_scale[layer_idx],
                          "v_scale": cache.v_scale[layer_idx]}
                writes = [(k_full, k_w), (v_full, v_w),
                          (scales["k_scale"], k_s), (scales["v_scale"], v_s)]
        if cache is not None and page_table is not None:
            # Paged: the cache arrays are page pools [L, P + 1, ps, K, ...];
            # each token's position maps through its row's table to a
            # physical (page, offset) — decode (T == 1) and per-row chunk
            # windows alike. Dropped writes land in the sink page P,
            # which the read below never sees.
            pid, off = write_index
            for full, new in writes:
                full[pid, off] = new.to(full.dtype)
            P = cache.num_pages
            win = self._kv_heads
            attn = attn_ops.dot_product_attention(
                q, win(k_full[:P]), win(v_full[:P]), page_table=page_table,
                kv_lengths=kv_lengths,
                **{name: win(t[:P]) for name, t in scales.items()})
        elif cache is not None:
            # In-place writes into the stacked [L, B, S, K, ...] cache (the
            # reference donates the buffer and XLA updates it in place).
            for full, new in writes:
                if scatter_writes:
                    # A window per row at its own positions (the
                    # speculative verify): positions past capacity land
                    # in the layer's sink row.
                    rows = sink_rows(full)
                    rows[write_index] = new.to(full.dtype)
                elif T == 1:
                    # Decode: this token's row at its position; a full
                    # row's write at position S is dropped.
                    write_decode_rows(full, write_index, new[:, 0])
                else:
                    # Prefill: a contiguous write at ``write_start`` (0,
                    # or a long prompt's chunk offset in its row cache).
                    full[:, write_start:write_start + T] = new.to(full.dtype)
            win = self._kv_heads
            attn = attn_ops.dot_product_attention(
                q, win(k_full), win(v_full), mask=mask,
                **{name: win(t) for name, t in scales.items()})
        elif token_mask is not None:
            # Full-sequence self-attention: causal + padding from the
            # token mask (the reference's no-cache path).
            attn = attn_ops.self_attention(q, self._kv_heads(k),
                                           self._kv_heads(v), token_mask,
                                           causal=True, keep=mask)
        else:
            attn = attn_ops.dot_product_attention(
                q, self._kv_heads(k), self._kv_heads(v), mask=mask)
        x = x + self.o(attn.reshape(B, T, N * H))

        y = self.mlp_norm(x).to(self.dtype)
        if self.mlp_in is not None:
            y = self.mlp_in(y)
        if cfg.num_experts > 0:
            if return_aux:
                y, aux = self.moe(y, return_aux=True)
                return x + y, aux
            return x + self.moe(y)
        if cfg.gated_mlp:
            y = F.silu(self.mlp_gate(y)) * self.mlp_up(y)
        else:
            y = F.gelu(self.mlp_up(y), approximate="tanh")
        x = x + self.mlp_down(y)
        if return_aux:
            return x, None
        return x

    def _kv_heads(self, t: torch.Tensor) -> torch.Tensor:
        """The kv heads (axis 2 of k/v and their scales, slab, pool or
        fresh) this rank's query heads read: all of them, or under a mesh
        that cuts q but replicates k/v, the window of their global
        indices; where the heads straddle a group boundary, one kv head
        per query head, gathered from the window (the route then sees
        grouped-query attention of group 1)."""
        if self.kv_window is None:
            return t
        first, count = self.kv_window
        t = t.narrow(2, first, count)
        if self.kv_index is not None:
            t = attn_ops.gather_kv_heads(t, self.kv_index)
        return t


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
        # Under a mesh (parallel/mesh.py::apply_tp): the tp group, this
        # rank's (first, count) rows of a vocabulary-sharded embedding,
        # and whether the head's logits are this rank's vocabulary slice.
        self.tp = None
        self.vocab_rows: Optional[Tuple[int, int]] = None
        self.gather_logits = False

    def forward(
        self,
        tokens: torch.Tensor,              # [B, T]
        positions: torch.Tensor,           # [B, T]
        mask: Optional[torch.Tensor],      # [B, 1, T, S]
        cache=None,                        # KVCache or PagedKVCache
        take: Optional[torch.Tensor] = None,  # [B]: only these rows' logits
        page_table: Optional[torch.Tensor] = None,  # [B, NP] (paged)
        kv_lengths: Optional[torch.Tensor] = None,  # [B] (paged)
        write_start: int = 0,   # slab prefill write offset (long-fill chunks)
        scatter_writes: bool = False,  # slab: per-row windows at positions
        token_mask: Optional[torch.Tensor] = None,  # [B, T] (no-cache path)
        return_aux: bool = False,
    ):
        """Logits [B, T, V] — or [B, V] at row ``take[b]`` of each batch
        row (the head runs only on the rows the caller keeps; per-row the
        numbers are the ones the full [B, T, V] would hold).
        ``scatter_writes`` writes each row's T tokens of a slab cache at
        its own ``positions`` (positions past capacity dropped), the
        speculative verify's window. With no cache and no ``mask``,
        ``token_mask`` makes the attention causal over the valid tokens.
        ``return_aux`` returns (logits, aux): the MoE layers'
        load-balance losses summed, a 0-d f32 tensor (0 for a dense
        model)."""
        x = self.embed_tokens(tokens, positions)
        # Per-forward tables shared by every layer (host work once, not
        # once per layer).
        rope = None
        if self.cfg.pos == "rope":
            rope = rope_tables(positions, self.cfg.head_dim,
                               self.cfg.rope_theta)
        # The int8 keep-mask the attention kernels read, made once here:
        # every layer's kernel takes it as it is (on the no-cache path, the
        # token mask's).
        if mask is None and cache is None and token_mask is not None:
            mask = token_mask[:, None, None, :].bool()
        mask = attn_ops.kernel_mask(mask, *tokens.shape)
        write_index = None
        if cache is not None and page_table is not None:
            write_index = paged_write_index(positions, page_table,
                                            cache.num_pages, cache.page_size)
        elif cache is not None and scatter_writes:
            write_index = window_write_index(positions, cache.capacity)
        elif cache is not None and tokens.shape[1] == 1:
            write_index = decode_write_index(positions[:, 0], cache.capacity)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, mask, cache, layer_idx=i, rope=rope,
                      write_index=write_index, page_table=page_table,
                      kv_lengths=kv_lengths, write_start=write_start,
                      scatter_writes=scatter_writes, token_mask=token_mask,
                      return_aux=return_aux)
            if return_aux:
                x, layer_aux = x
                if layer_aux is not None:
                    aux = aux + layer_aux
        logits = self.logits_of(x, take)
        return (logits, aux) if return_aux else logits

    def embed_tokens(self, tokens: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        """The residual stream's input: token (and learned position)
        embeddings [B, T, D]."""
        x = self._embed(tokens.long())
        if self.cfg.pos == "learned":
            # A row steered past capacity (its write dropped, its output
            # never used) may sit past the table; clamp it in range.
            x = x + self.pos_embed(
                torch.clamp(positions.long(), max=self.cfg.max_seq_len - 1))
        return x

    def logits_of(self, x: torch.Tensor,
                  take: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The final norm and the head over the residual stream x [B, T, D]
        (only rows ``take`` [B] with it), gathered over tp."""
        x = self.final_norm(x)
        if take is not None:
            x = x[torch.arange(x.shape[0], device=x.device), take.long()]
        if self.gather_logits:
            # A vocabulary-sharded head is column-parallel: in training
            # its input's gradient is summed over tp.
            x = self.tp.copy_in(x)
        if self.cfg.tie_embeddings:
            w = self.tok_embed.weight
            logits = F.linear(x.to(w.dtype), w)
        else:
            logits = self.lm_head(x.float())
        if self.gather_logits:
            logits = self.tp.gather_last(logits)
        return logits

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings; a vocabulary-sharded table looks up the ids
        in its own rows, zeros the others, and sums over the ranks (one
        rank holds each row, so the sum is exact)."""
        if self.vocab_rows is None:
            return self.tok_embed(ids)
        first, count = self.vocab_rows
        local = ids - first
        inside = (local >= 0) & (local < count)
        x = self.tok_embed(torch.where(inside, local,
                                       torch.zeros_like(local)))
        x = torch.where(inside[..., None], x, torch.zeros_like(x))
        return self.tp.all_reduce(x)


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
