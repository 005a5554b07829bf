"""Causal-LM servable models (GPT-2 family, Llama family) on the shared decoder.

Port of ``ray_dynamic_batching_tpu/models/causal_lm.py``: the no-cache
forward (``apply`` — also the module's ``forward``, which the profiler
and the batch engine call — ``apply_with_aux``, ``example_inputs`` and
``flops_per_sample``, so ``ModelProfiler`` sweeps a decoder's
(batch, seq) buckets as the reference's does), the slab arm
(``make_cache``, ``prefill``, ``prefill_chunk``, ``decode_step``), the
paged arm (``make_paged_cache``, ``prefill_chunk_paged``,
``decode_step_paged``), the speculative verify on both
(``verify_step``, ``verify_step_paged``), the int8 KV cache
(``kv_dtype=torch.int8``, ``kv_bytes_per_slot``), the configs
``LLAMA3_8B``, ``GPT2_MEDIUM``, ``GPT2_DRAFT``, ``TINY_LM`` and
``TINY_MOE``, and their registry entries (``gpt2_draft``,
``llama_tiny_int8kv`` and ``moe_tiny`` among them). The model
owns its weights on an explicit device; :meth:`CausalLM.init_random`
fills them from a seed on that device (no download), and
``models/convert.py`` maps the JAX package's params onto them.

The llama sharding rules (:meth:`CausalLM.sharding_rules`, reference
``causal_lm.py:360-377``), :meth:`~CausalLM.cache_pspec` and
:meth:`~CausalLM.paged_cache_pspec` are the reference's as plain data;
``parallel/mesh.py`` applies them (the ``tp`` axis; the ``moe/*`` rules
keep their ``ep`` entry). A sharded model's caches hold its share of the
kv heads (:attr:`CausalLM.kv_heads`).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

from ray_dynamic_batching_tpu_torch.models.base import (
    ModelSLO,
    ServableModel,
    register_model,
)
from ray_dynamic_batching_tpu_torch.models.decoder import (
    DecoderConfig,
    DecoderModule,
    Dense,
    KVCache,
    PagedKVCache,
    decode_mask,
    prefill_mask,
)


class CausalLM(ServableModel):
    family = "causal_lm"

    def __init__(
        self,
        cfg: DecoderConfig,
        name: str,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device, None] = "cuda",
        seed: Optional[int] = 0,
        kv_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(dtype, device)
        self.name = name
        self.cfg = cfg
        # KV-cache storage dtype (None = the model dtype). int8 stores
        # codes + one f32 scale per cached (token, head) row, quantized at
        # write (models/decoder.py::quantize_kv_rows): half the bytes.
        self.kv_dtype = kv_dtype
        self.module = DecoderModule(cfg, dtype=dtype, device=self.device)
        # The kv heads of this model's caches: all of them, or under a
        # mesh this rank's share (parallel/mesh.py::apply_tp, which also
        # sets ``tp_shard``).
        self.kv_heads = cfg.num_kv_heads
        self.tp_shard = None
        if seed is not None:
            self.init_random(seed)

    @torch.no_grad()
    def init_random(self, seed: int) -> None:
        """Random weights from ``seed``, drawn on the model's device
        (:func:`random_leaves`)."""
        params = dict(self.module.named_parameters())
        for name, value in random_leaves(self.module, seed, self.device):
            params[name].copy_(value)

    # --- no-cache forward (the profiler's and the batch engine's) --------
    def apply(self, tokens: torch.Tensor, attn_mask: torch.Tensor
              ) -> torch.Tensor:
        """Logits [B, T, V] of a whole sequence with no cache: causal
        attention over the valid tokens of ``attn_mask`` [B, T]."""
        return self.module(tokens, self._positions(tokens), None,
                           token_mask=attn_mask)

    forward = apply

    def apply_with_aux(self, tokens: torch.Tensor, attn_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`apply` plus the MoE load-balance auxiliary loss, summed
        over the layers (a 0-d f32 tensor, 0 for dense models); a training
        loss adds ``aux_coef * aux``."""
        return self.module(tokens, self._positions(tokens), None,
                           token_mask=attn_mask, return_aux=True)

    @staticmethod
    def _positions(tokens: torch.Tensor) -> torch.Tensor:
        T = tokens.shape[1]
        return torch.arange(T, device=tokens.device)[None, :].expand(
            tokens.shape)

    def example_inputs(self, batch_size: int, seq_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero tokens and an all-ones mask [B, T] (T defaults to 128),
        int32 as the reference's."""
        T = seq_len or 128
        return (torch.zeros((batch_size, T), dtype=torch.int32,
                            device=self.device),
                torch.ones((batch_size, T), dtype=torch.int32,
                           device=self.device))

    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        """The reference's estimate: projections and MLP per token, 4 T D
        for scores and values, and the head, times T tokens."""
        T = seq_len or 128
        c = self.cfg
        per_tok = 2 * (
            c.d_model * c.head_dim * (c.num_heads + 2 * c.num_kv_heads)
            + c.num_heads * c.head_dim * c.d_model
            + (3 if c.gated_mlp else 2) * c.d_model * c.mlp_dim
        )
        attn = 4 * T * c.d_model
        return float(c.num_layers * (per_tok + attn) * T
                     + 2 * c.d_model * c.vocab_size * T)

    # --- decode interface (used by engine.decode) -------------------------
    def make_cache(self, batch_size: int,
                   max_len: Optional[int] = None) -> KVCache:
        return KVCache.zeros(self.cfg, batch_size, max_len,
                             dtype=self.kv_dtype or self.dtype,
                             device=self.device, kv_heads=self.kv_heads)

    def prefill(self, tokens: torch.Tensor, attn_mask: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """Run the prompt through the model, filling ``cache`` in place.

        tokens [B, T] right-padded; attn_mask [B, T]. Returns
        last-valid-token logits [B, V] and the cache with ``lengths`` set
        per row. Queries attend the whole capacity: positions past T are
        masked off, as in the reference."""
        B, T = tokens.shape
        S = cache.capacity
        if T > S:
            raise ValueError(
                f"prompt length {T} exceeds KV-cache capacity {S}; "
                "bucket the prompt or allocate a larger cache"
            )
        positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
        lengths = attn_mask.sum(dim=1).to(torch.int32)
        base = prefill_mask(attn_mask)  # [B, 1, T, T]
        if S > T:
            pad = torch.zeros((B, 1, T, S - T), dtype=torch.bool,
                              device=tokens.device)
            mask = torch.cat([base, pad], dim=-1)
        else:
            mask = base
        # lengths - 1 wraps like the reference's take_along_axis index.
        last = self.module(tokens, positions, mask, cache,
                           take=torch.remainder(lengths - 1, T))
        cache.lengths.copy_(lengths)
        return last, cache

    def prefill_chunk(self, tokens: torch.Tensor, attn_mask: torch.Tensor,
                      cache: KVCache, start: int, take_idx: int
                      ) -> Tuple[torch.Tensor, KVCache]:
        """One chunk of a long prompt on a row cache: k/v written at
        [start, start + C), each token at global position p attending
        cache positions [0, p] (earlier chunks are resident; position 0 is
        always visible, so padded query rows keep a sane softmax).
        ``start`` and ``take_idx`` are host ints. Chunks arrive in order,
        all full but the last; padded tail positions write garbage past
        the final length that nothing attends. Returns (logits at row
        ``take_idx`` [B, V], cache with ``lengths`` advanced by the
        chunk's real tokens)."""
        B, C = tokens.shape
        S = cache.capacity
        dev = tokens.device
        positions = start + torch.arange(C, device=dev)[None, :].expand(B, C)
        mask = (torch.arange(S, device=dev)[None, None, None, :]
                <= positions[:, None, :, None])
        take = torch.full((B,), take_idx, dtype=torch.int64, device=dev)
        taken = self.module(tokens, positions, mask, cache, take=take,
                            write_start=start)
        cache.lengths.add_(attn_mask.sum(dim=1).to(torch.int32))
        return taken, cache

    def decode_step(self, tokens: torch.Tensor, cache: KVCache,
                    active: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """One decode step for all slots; returns logits [B, V] and the
        cache (written in place, ``lengths`` advanced for active rows).
        Rows whose cache is full are force-deactivated: their write is
        dropped, their logits are garbage, their length stops at
        capacity."""
        in_bounds = cache.lengths < cache.capacity
        active = active & in_bounds
        positions = cache.lengths[:, None]
        mask = decode_mask(cache.lengths, cache.capacity)
        logits = self.module(tokens, positions, mask, cache)
        cache.lengths.add_(active.to(torch.int32))
        return logits[:, 0], cache

    @staticmethod
    def _window_positions(tokens: torch.Tensor, lengths: torch.Tensor,
                          active: torch.Tensor, capacity: int):
        """Row b's window positions ``lengths[b] + [0, T)`` [B, T], with
        inactive rows and positions past ``capacity`` steered to it (their
        writes drop, their logits are never used)."""
        T = tokens.shape[1]
        positions = lengths[:, None] + torch.arange(T, device=tokens.device)
        keep = active[:, None] & (positions < capacity)
        return torch.where(keep, positions,
                           torch.full_like(positions, capacity))

    def verify_step(self, tokens: torch.Tensor, cache: KVCache,
                    active: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """Score a T-token window per row in ONE forward (the speculative
        verify): row b's window [pending token, proposals] starts at its
        own ``lengths[b]``, its k/v written per row at those positions
        (past capacity dropped into the sink row), and logits[b, j]
        [B, T, V] score the token AFTER window position j. ``lengths``
        are not advanced: the caller accepts a per-row prefix and sets
        them. Inactive rows are steered to capacity."""
        S = cache.capacity
        positions = self._window_positions(tokens, cache.lengths, active, S)
        mask = (torch.arange(S, device=tokens.device)[None, None, None, :]
                <= positions[:, None, :, None])
        logits = self.module(tokens, positions, mask, cache,
                             scatter_writes=True)
        return logits, cache

    def make_paged_cache(self, batch_size: int, num_pages: int,
                         page_size: int, max_len: int) -> PagedKVCache:
        """A paged pool of ``num_pages`` pages (plus the sink page) and a
        ``[batch_size, max_len // page_size]`` all-sentinel page table;
        the engine owns allocation (``engine/paging.py``)."""
        return PagedKVCache.zeros(self.cfg, batch_size, num_pages, page_size,
                                  max_len, dtype=self.kv_dtype or self.dtype,
                                  device=self.device, kv_heads=self.kv_heads)

    def prefill_chunk_paged(
        self,
        tokens: torch.Tensor,     # [B, W] one chunk per row (tail padded)
        attn_mask: torch.Tensor,  # [B, W] 1 = real token
        cache: PagedKVCache,
        tables: torch.Tensor,     # [B, NP] per-row page-table rows
        starts: torch.Tensor,     # [B] global position of tokens[:, 0]
        take_idx: torch.Tensor,   # [B] per-row logits row to return
    ) -> Tuple[torch.Tensor, PagedKVCache]:
        """Pages-direct chunked prefill: row b's chunk occupies positions
        [starts[b], starts[b] + W), its k/v written through ``tables`` into
        the pages the engine granted (positions past logical capacity are
        steered to S and dropped), attention reading the staircase window
        (row t attends positions <= starts + t). Padded tail positions
        write garbage past the final length that nothing attends.
        ``lengths`` and ``page_table`` pass through untouched. Returns
        (logits at ``take_idx`` [B, V], cache); the head runs only on the
        taken rows."""
        B, W = tokens.shape
        S = tables.shape[1] * cache.page_size
        positions = starts[:, None] + torch.arange(W, device=tokens.device)
        positions = torch.where(positions < S, positions,
                                torch.full_like(positions, S))
        taken = self.module(tokens, positions, None, cache, take=take_idx,
                            page_table=tables, kv_lengths=starts)
        return taken, cache

    def decode_step_paged(self, tokens: torch.Tensor, cache: PagedKVCache,
                          active: torch.Tensor
                          ) -> Tuple[torch.Tensor, PagedKVCache]:
        """:meth:`decode_step` over the paged pool: writes and reads go
        through the page table, rows at logical capacity are
        force-deactivated (their write is dropped), ``lengths`` advance
        for active rows."""
        in_bounds = cache.lengths < cache.capacity
        active = active & in_bounds
        positions = cache.lengths[:, None]
        logits = self.module(tokens, positions, None, cache,
                             page_table=cache.page_table,
                             kv_lengths=cache.lengths)
        cache.lengths.add_(active.to(torch.int32))
        return logits[:, 0], cache

    def verify_step_paged(self, tokens: torch.Tensor, cache: PagedKVCache,
                          active: torch.Tensor
                          ) -> Tuple[torch.Tensor, PagedKVCache]:
        """:meth:`verify_step` over the paged pool: row b's window is
        written through the page table into the round's scratch pages
        (steered rows land in the sink page), and attention reads the
        staircase window (row t attends positions <= lengths + t).
        ``lengths`` are not advanced."""
        positions = self._window_positions(tokens, cache.lengths, active,
                                           cache.capacity)
        logits = self.module(tokens, positions, None, cache,
                             page_table=cache.page_table,
                             kv_lengths=cache.lengths)
        return logits, cache

    def kv_bytes_per_slot(self, max_len: Optional[int] = None) -> int:
        """Bytes of k and v for one slot of ``max_len`` positions (an int8
        cache adds one f32 scale per cached (token, head) row)."""
        c = self.cfg
        S = max_len or c.max_seq_len
        kv_dtype = self.kv_dtype or self.dtype
        per_row = c.head_dim * kv_dtype.itemsize
        if kv_dtype == torch.int8:
            per_row += 4
        return 2 * c.num_layers * S * c.num_kv_heads * per_row

    # --- distribution ----------------------------------------------------
    def sharding_rules(self):
        """Megatron-style TP (reference ``causal_lm.py:360-377``): q/k/v
        and the MLP's gate/up split their output heads/columns, o and
        down their input, the embedding and the head the vocabulary."""
        return [
            (r"/q/kernel", (None, "tp", None)),
            (r"/k/kernel", (None, "tp", None)),
            (r"/v/kernel", (None, "tp", None)),
            (r"/o/kernel", ("tp", None, None)),
            (r"mlp_gate/kernel", (None, "tp")),
            (r"mlp_up/kernel", (None, "tp")),
            (r"mlp_down/kernel", ("tp", None)),
            (r"moe/wi", ("ep", None, "tp")),
            (r"moe/wg", ("ep", None, "tp")),
            (r"moe/wo", ("ep", "tp", None)),
            (r"tok_embed/embedding", ("tp", None)),
            (r"lm_head/kernel", (None, "tp")),
        ]

    def cache_pspec(self) -> KVCache:
        """Specs of the slab cache's planes (kv heads over tp; reference
        ``causal_lm.py:379-391``)."""
        scale = (None, None, None, "tp") if self.kv_dtype == torch.int8 \
            else None
        return KVCache(k=(None, None, None, "tp", None),    # type: ignore
                       v=(None, None, None, "tp", None),    # type: ignore
                       lengths=(None,),                     # type: ignore
                       k_scale=scale, v_scale=scale)        # type: ignore

    def paged_cache_pspec(self) -> PagedKVCache:
        """Specs of the paged pool (reference ``causal_lm.py:393-412``):
        pages cut on the kv-head dim like the slab; the page table and
        lengths whole on every rank (page indices are shard-invariant)."""
        scale = (None, None, None, "tp") if self.kv_dtype == torch.int8 \
            else None
        return PagedKVCache(k=(None, None, None, "tp", None),     # type: ignore
                            v=(None, None, None, "tp", None),     # type: ignore
                            page_table=(None, None),              # type: ignore
                            lengths=(None,),                      # type: ignore
                            k_scale=scale, v_scale=scale)         # type: ignore

    def flax_leaves(self) -> Dict[str, Tuple[str, Tuple[int, ...],
                                             Tuple[int, ...]]]:
        """Port parameter -> (reference path, flax leaf shape, port dim
        of each flax axis): a :class:`Dense` kernel is ``flax_in +
        flax_out`` with its inputs on port dim 1 and outputs on dim 0;
        embeddings ``embedding`` [rows, D]; every other leaf as it is."""
        out = {}
        for mod_name, mod in self.module.named_modules():
            path = re.sub(r"^layers\.(\d+)", r"layer\1",
                          mod_name).replace(".", "/")
            for leaf, p in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                if isinstance(mod, Dense) and leaf == "weight":
                    out[name] = (f"{path}/kernel", mod.flax_in + mod.flax_out,
                                 (1,) * len(mod.flax_in)
                                 + (0,) * len(mod.flax_out))
                elif isinstance(mod, Dense) and leaf == "bias":
                    out[name] = (f"{path}/bias", mod.flax_out,
                                 (0,) * len(mod.flax_out))
                elif isinstance(mod, torch.nn.Embedding):
                    out[name] = (f"{path}/embedding", tuple(p.shape), (0, 1))
                else:
                    out[name] = (f"{path}/{leaf}", tuple(p.shape),
                                 tuple(range(p.dim())))
        return out


def random_leaves(module: torch.nn.Module, seed: int, device
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter of ``module`` as :meth:`CausalLM.init_random`
    draws it from ``seed`` on ``device``, one whole leaf at a time in name
    order: matrices and embeddings N(0, 1/fan_in), norm scales 1, biases 0
    (MoE experts ``[E, in, out]``: fan_in is their middle axis). The
    draws depend only on the leaves' shapes and order, so a sharded
    model (``parallel/mesh.py::build_sharded_model``) keeps slices of the
    very numbers an unsharded one holds."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for name, p in sorted(module.named_parameters()):
        value = torch.empty(p.shape, dtype=p.dtype, device=device)
        if name.endswith("scale"):
            value.fill_(1.0)
        elif name.endswith("bias"):
            value.zero_()
        else:
            fan_in = p.shape[1] if name.endswith(("moe.wi", "moe.wg",
                                                  "moe.wo")) else p.shape[-1]
            value.normal_(0.0, fan_in ** -0.5, generator=gen)
        yield name, value


GPT2_MEDIUM = DecoderConfig(
    vocab_size=50257,
    d_model=1024,
    num_layers=24,
    num_heads=16,
    num_kv_heads=16,
    mlp_dim=4096,
    max_seq_len=1024,
    pos="learned",
    norm="ln",
    gated_mlp=False,
    use_bias=True,
    tie_embeddings=True,
)

LLAMA3_8B = DecoderConfig(
    vocab_size=128256,
    d_model=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    mlp_dim=14336,
    max_seq_len=8192,
    pos="rope",
    norm="rms",
    gated_mlp=True,
    use_bias=False,
    rope_theta=500000.0,
)

# Draft companion for gpt2_medium (the reference's speculative pair):
# the same vocab and position style, so its proposals index the target's
# logit space, at about 1/40 of the FLOPs.
GPT2_DRAFT = DecoderConfig(
    vocab_size=50257,
    d_model=256,
    num_layers=4,
    num_heads=4,
    num_kv_heads=4,
    mlp_dim=1024,
    max_seq_len=1024,
    pos="learned",
    norm="ln",
    gated_mlp=False,
    use_bias=True,
    tie_embeddings=True,
)

TINY_LM = DecoderConfig(
    vocab_size=512,
    d_model=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    mlp_dim=128,
    max_seq_len=256,
)

TINY_MOE = DecoderConfig(
    vocab_size=512,
    d_model=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    mlp_dim=128,
    max_seq_len=256,
    num_experts=4,
    moe_top_k=2,
)


@register_model("gpt2_medium", slo=ModelSLO(latency_slo_ms=500.0))
def _gpt2_medium(**kwargs) -> CausalLM:
    return CausalLM(GPT2_MEDIUM, name="gpt2_medium", **kwargs)


@register_model("llama3_8b", slo=ModelSLO(latency_slo_ms=150.0))
def _llama3_8b(**kwargs) -> CausalLM:
    return CausalLM(LLAMA3_8B, name="llama3_8b", **kwargs)


@register_model("gpt2_draft")
def _gpt2_draft(**kwargs) -> CausalLM:
    return CausalLM(GPT2_DRAFT, name="gpt2_draft", **kwargs)


@register_model("llama_tiny")
def _llama_tiny(**kwargs) -> CausalLM:
    return CausalLM(TINY_LM, name="llama_tiny", **kwargs)


@register_model("llama_tiny_int8kv")
def _llama_tiny_int8kv(**kwargs) -> CausalLM:
    """llama_tiny with the int8 KV cache, under its own registry name."""
    kwargs.setdefault("kv_dtype", torch.int8)
    return CausalLM(TINY_LM, name="llama_tiny_int8kv", **kwargs)


@register_model("moe_tiny")
def _moe_tiny(**kwargs) -> CausalLM:
    return CausalLM(TINY_MOE, name="moe_tiny", **kwargs)
