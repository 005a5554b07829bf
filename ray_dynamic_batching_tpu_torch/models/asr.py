"""Whisper-style streaming ASR — encoder-decoder with ragged audio batching,
in torch.

Port of ``ray_dynamic_batching_tpu/models/asr.py``: ``ASRConfig``,
``sinusoids``, ``EncoderLayer``, ``AudioEncoder``, ``CrossDecoderLayer``,
``TextDecoder``, ``ASRCache``, ``AUDIO_BUCKETS``, ``bucket_frames``,
``collate_audio``, ``ASRModel``, ``StreamingASR`` and the registry's
``whisper_large_v3`` (BASELINE.json config 5) and ``whisper_tiny_test``.
The config is the reference's as it stands (80 mel bins; the published
v3 has 128). Numerics follow the flax reference:

- the two convolutions (kernel 3, padding 1; the second stride 2, so
  ``T2 = ceil(T / 2)``) are ``Conv1d`` weights ``[out, in, 3]`` (flax's
  NWC kernel ``[3, in, out]``) in the model dtype, each followed by the
  tanh GELU; the encoder's state mask is ``frame_mask[:, ::2][:, :T2]``;
- pre-norm blocks, LayerNorms in f32 (flax's: eps 1e-6, fast variance)
  cast back to the model dtype, Dense layers with biases in the model
  dtype, the MLP's GELU in tanh form;
- the tied head is flax ``Embed.attend`` of the f32 final norm, which
  promotes both operands to the model dtype: in bf16 the logits are a
  bf16 product, and they are here.

Attention goes through ``ops/attention``: the encoder's bidirectional
self-attention over valid frames (``self_attention``, flash at T2 >= 16),
the decoder's masked self-attention over its cache (flash for a prefill
of T >= 16, the slab decode kernel for a step) and its cross-attention
over the encoder states (the same two routes). The decode step writes its
k/v row with the reference's ``mode="drop"`` rule: a row at capacity
writes nothing (``models/decoder.py::decode_write_index``).

Cross K/V: the reference's decoder projects ``cross_k``/``cross_v`` from
the encoder states in every call, while its docstring says they are made
once per utterance (XLA hoists the loop-invariant product out of the
transcribe scan). Here :meth:`ASRModel.prefill` projects them once, keeps
them in the :class:`ASRCache`, and every :meth:`ASRModel.decode_step`
reads them: the same values, computed once.

:class:`StreamingASR` runs its encode, prefill and step eagerly (each
stream makes a fresh cache sized by its prefix's text bucket and its own
cross K/V, so a captured graph would bake in one stream's buffers); the
reason is recorded in ``ops/jit_model.ASR_PROGRAMS``.

Trimmed: the reference's tensor-parallel ``sharding_rules`` (multi-GPU).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.models.base import (
    ModelSLO,
    ServableModel,
    register_model,
)
from ray_dynamic_batching_tpu_torch.models.decoder import (
    Dense,
    LayerNorm,
    _param,
    decode_write_index,
    write_decode_rows,
)
from ray_dynamic_batching_tpu_torch.models.distilbert import (
    init_encoder_weights,
)
from ray_dynamic_batching_tpu_torch.ops import attention as attn_ops


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    vocab_size: int = 51866          # whisper-large-v3 vocab
    n_mels: int = 80
    d_model: int = 1280
    enc_layers: int = 32
    dec_layers: int = 32
    num_heads: int = 20
    mlp_dim: int = 5120
    max_audio_frames: int = 3000     # 30 s of 10 ms mel frames
    max_text_len: int = 448
    sot_token: int = 50258           # start-of-transcript
    eot_token: int = 50257           # end-of-transcript

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def sinusoids(length: int, channels: int,
              device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Fixed sinusoidal positions [length, channels] in f32 (whisper-style
    encoder embedding)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class _Heads(Dense):
    """A ``DenseGeneral((N, H))`` projection: [.., D] -> [.., N, H]."""

    def __init__(self, cfg: ASRConfig, dtype, device):
        super().__init__(cfg.d_model, cfg.d_model, True, dtype, device)
        self.heads = (cfg.num_heads, cfg.head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).view(x.shape[:-1] + self.heads)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ASRConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.dtype = dtype
        self.attn_norm = LayerNorm(D, device)
        self.q = _Heads(cfg, dtype, device)
        self.k = _Heads(cfg, dtype, device)
        self.v = _Heads(cfg, dtype, device)
        self.o = Dense(D, D, True, dtype, device)
        self.mlp_norm = LayerNorm(D, device)
        self.mlp_up = Dense(D, cfg.mlp_dim, True, dtype, device)
        self.mlp_down = Dense(cfg.mlp_dim, D, True, dtype, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, T, D]; mask: the encoder's keep-mask over valid frames
        (the reference's ``self_attention(.., frame_mask, causal=False)``,
        made once per forward)."""
        B, T, D = x.shape
        y = self.attn_norm(x).to(self.dtype)
        attn = attn_ops.dot_product_attention(self.q(y), self.k(y),
                                              self.v(y), mask=mask)
        x = x + self.o(attn.reshape(B, T, D))
        y = self.mlp_norm(x).to(self.dtype)
        return x + self.mlp_down(_gelu(self.mlp_up(y)))


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over NWC with an int ``padding`` (symmetric), in
    the model dtype; weight ``[out, in, k]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 padding: int, dtype, device):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = _param((cout, cin, k), dtype, device)
        self.bias = _param((cout,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T] -> [B, C', T']."""
        return F.conv1d(x, self.weight, self.bias, self.stride,
                        self.padding)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: ASRConfig, dtype, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.conv1 = Conv1d(cfg.n_mels, cfg.d_model, 3, 1, 1, dtype, device)
        self.conv2 = Conv1d(cfg.d_model, cfg.d_model, 3, 2, 1, dtype, device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.enc_layers))
        self.final_norm = LayerNorm(cfg.d_model, device)

    def forward(self, mel: torch.Tensor, frame_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel [B, T, n_mels], frame_mask [B, T] -> (states [B, T2, D],
        state_mask [B, T2]), T2 = ceil(T / 2)."""
        x = _gelu(self.conv1(mel.to(self.dtype).transpose(1, 2)))
        x = _gelu(self.conv2(x)).transpose(1, 2)
        B, T2, D = x.shape
        x = x + sinusoids(T2, D, x.device).to(self.dtype)[None]
        state_mask = frame_mask[:, ::2][:, :T2]
        mask = attn_ops.kernel_mask(state_mask[:, None, None, :].bool(), B,
                                    T2)
        for layer in self.layers:
            x = layer(x, mask)
        return self.final_norm(x).to(self.dtype), state_mask


class CrossDecoderLayer(nn.Module):
    """Causal self-attention (with the cache) then cross-attention over the
    encoder states, as in whisper's text decoder."""

    def __init__(self, cfg: ASRConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.dtype = dtype
        self.self_norm = LayerNorm(D, device)
        self.self_q = _Heads(cfg, dtype, device)
        self.self_k = _Heads(cfg, dtype, device)
        self.self_v = _Heads(cfg, dtype, device)
        self.self_o = Dense(D, D, True, dtype, device)
        self.cross_norm = LayerNorm(D, device)
        self.cross_q = _Heads(cfg, dtype, device)
        self.cross_k = _Heads(cfg, dtype, device)
        self.cross_v = _Heads(cfg, dtype, device)
        self.cross_o = Dense(D, D, True, dtype, device)
        self.mlp_norm = LayerNorm(D, device)
        self.mlp_up = Dense(D, cfg.mlp_dim, True, dtype, device)
        self.mlp_down = Dense(cfg.mlp_dim, D, True, dtype, device)

    def cross_kv(self, enc_states: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This layer's cross K/V [B, Te, N, H] of the encoder states."""
        return self.cross_k(enc_states), self.cross_v(enc_states)

    def forward(self, x, self_mask, cross, cross_mask, layer_cache=None,
                write_index=None) -> torch.Tensor:
        """x [B, T, D]; self_mask / cross_mask keep-masks; ``cross`` this
        layer's (K, V); ``layer_cache`` its (k, v) [B, S, N, H] slab,
        written in place (a step's row through ``write_index``, a
        prefill's tokens at offset 0)."""
        B, T, D = x.shape
        y = self.self_norm(x).to(self.dtype)
        q, k, v = self.self_q(y), self.self_k(y), self.self_v(y)
        if layer_cache is not None:
            k_cache, v_cache = layer_cache
            if T == 1:
                write_decode_rows(k_cache, write_index, k[:, 0])
                write_decode_rows(v_cache, write_index, v[:, 0])
            else:
                k_cache[:, :T] = k
                v_cache[:, :T] = v
            k, v = k_cache, v_cache
        attn = attn_ops.dot_product_attention(q, k, v, mask=self_mask)
        x = x + self.self_o(attn.reshape(B, T, D))

        y = self.cross_norm(x).to(self.dtype)
        cattn = attn_ops.dot_product_attention(self.cross_q(y), *cross,
                                               mask=cross_mask)
        x = x + self.cross_o(cattn.reshape(B, T, D))

        y = self.mlp_norm(x).to(self.dtype)
        return x + self.mlp_down(_gelu(self.mlp_up(y)))


class TextDecoder(nn.Module):
    def __init__(self, cfg: ASRConfig, dtype, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                      dtype=dtype, device=device)
        self.pos_embed = nn.Embedding(cfg.max_text_len, cfg.d_model,
                                      dtype=dtype, device=device)
        for emb in (self.tok_embed, self.pos_embed):
            emb.weight.requires_grad_(False)
        self.layers = nn.ModuleList(CrossDecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.dec_layers))
        self.final_norm = LayerNorm(cfg.d_model, device)

    def cross_kv(self, enc_states: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every layer's cross K/V, stacked [L, B, Te, N, H]."""
        kv = [layer.cross_kv(enc_states) for layer in self.layers]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def forward(self, tokens, positions, self_mask, cross_k, cross_v,
                enc_mask, cache: Optional["ASRCache"] = None
                ) -> torch.Tensor:
        """tokens, positions [B, T]; self_mask [B, 1, T, S] (True =
        attend); cross_k/cross_v [L, B, Te, N, H]; enc_mask [B, Te].
        Returns f32-normed, tied-head logits [B, T, V] in the model
        dtype."""
        B, T = tokens.shape
        x = self.tok_embed(tokens.long()) + self.pos_embed(
            torch.clamp(positions.long(), max=self.cfg.max_text_len - 1))
        self_mask = attn_ops.kernel_mask(self_mask, B, T)
        cross_mask = attn_ops.kernel_mask(
            enc_mask[:, None, None, :].bool(), B, T)
        write_index = None
        if cache is not None and T == 1:
            write_index = decode_write_index(positions[:, 0],
                                             cache.capacity)
        for i, layer in enumerate(self.layers):
            x = layer(x, self_mask, (cross_k[i], cross_v[i]), cross_mask,
                      None if cache is None else (cache.k[i], cache.v[i]),
                      write_index)
        x = self.final_norm(x)
        w = self.tok_embed.weight
        return F.linear(x.to(w.dtype), w)   # tied head (whisper)


@dataclass
class ASRCache:
    """The decoder's self-attention slab ``k``/``v`` [L, B, S, N, H] and
    per-row ``lengths`` [B], plus the utterance's cross K/V
    [L, B, Te, N, H] once :meth:`ASRModel.prefill` has made them. Written
    in place."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(cfg: ASRConfig, batch_size: int, max_len: Optional[int] = None,
              dtype=torch.bfloat16, device=torch.device("cpu")
              ) -> "ASRCache":
        S = max_len or cfg.max_text_len
        shape = (cfg.dec_layers, batch_size, S, cfg.num_heads, cfg.head_dim)
        return ASRCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch_size,), dtype=torch.int32,
                                device=device))

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


# --- ragged audio bucketing -------------------------------------------------

AUDIO_BUCKETS = (200, 500, 1000, 1500, 3000)  # mel frames (2s..30s @10ms)


def bucket_frames(n_frames: int,
                  buckets: Tuple[int, ...] = AUDIO_BUCKETS) -> int:
    """Smallest bucket holding n_frames (ragged lengths -> a few shapes)."""
    for b in buckets:
        if n_frames <= b:
            return b
    return buckets[-1]


def collate_audio(
    mels: List[np.ndarray], batch_bucket: int,
    buckets: Tuple[int, ...] = AUDIO_BUCKETS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged [T_i, n_mels] list -> (mel [B, Tb, n_mels] f32, mask [B, Tb]
    int32); Tb = the duration bucket of the longest clip, B = the batch
    bucket (clips past the largest bucket are cut to it)."""
    if not mels:
        raise ValueError("empty batch")
    if len(mels) > batch_bucket:
        raise ValueError(
            f"{len(mels)} clips exceed batch bucket {batch_bucket}; "
            "silently dropping audio is never acceptable"
        )
    n_mels = mels[0].shape[1]
    Tb = bucket_frames(max(m.shape[0] for m in mels), buckets)
    mel = np.zeros((batch_bucket, Tb, n_mels), np.float32)
    mask = np.zeros((batch_bucket, Tb), np.int32)
    for i, m_i in enumerate(mels):
        t = min(m_i.shape[0], Tb)
        mel[i, :t] = m_i[:t]
        mask[i, :t] = 1
    return mel, mask


def _causal_mask(token_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] -> causal and valid [B, 1, T, T]."""
    T = token_mask.shape[1]
    causal = torch.ones((T, T), dtype=torch.bool,
                        device=token_mask.device).tril()
    return causal[None, None] & token_mask[:, None, None, :].bool()


# --- servable model ---------------------------------------------------------

class ASRModel(ServableModel):
    family = "asr"

    def __init__(self, cfg: ASRConfig, name: str,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = "cuda",
                 seed: Optional[int] = 0):
        super().__init__(dtype, device)
        self.name = name
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg, dtype, self.device)
        self.decoder = TextDecoder(cfg, dtype, self.device)
        if seed is not None:
            init_encoder_weights(self, seed, self.device)

    # --- teacher-forced pass (profiling and the batch engine) -------------
    def apply(self, mel: torch.Tensor, mel_mask: torch.Tensor,
              tokens: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, T_text, V]."""
        enc_states, enc_mask = self.encoder(mel, mel_mask)
        cross_k, cross_v = self.decoder.cross_kv(enc_states)
        return self.decoder(tokens, self._positions(tokens),
                            _causal_mask(text_mask), cross_k, cross_v,
                            enc_mask)

    forward = apply

    @staticmethod
    def _positions(tokens: torch.Tensor) -> torch.Tensor:
        T = tokens.shape[1]
        return torch.arange(T, device=tokens.device)[None, :].expand(
            tokens.shape)

    def example_inputs(self, batch_size: int, seq_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
        T_text = seq_len or 16
        T_audio = AUDIO_BUCKETS[0]
        dev = self.device
        return (
            torch.zeros((batch_size, T_audio, self.cfg.n_mels),
                        dtype=torch.float32, device=dev),
            torch.ones((batch_size, T_audio), dtype=torch.int32, device=dev),
            torch.zeros((batch_size, T_text), dtype=torch.int32, device=dev),
            torch.ones((batch_size, T_text), dtype=torch.int32, device=dev),
        )

    # --- encode / decode (serving path) -----------------------------------
    def encode(self, mel: torch.Tensor, mel_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(states [B, T2, D], state_mask [B, T2])."""
        return self.encoder(mel, mel_mask)

    def make_cache(self, batch_size: int, max_len: Optional[int] = None
                   ) -> ASRCache:
        return ASRCache.zeros(self.cfg, batch_size, max_len,
                              dtype=self.dtype, device=self.device)

    def prefill(self, tokens: torch.Tensor, text_mask: torch.Tensor,
                enc_states: torch.Tensor, enc_mask: torch.Tensor,
                cache: ASRCache) -> Tuple[torch.Tensor, ASRCache]:
        """The prompt through the decoder, filling ``cache`` in place
        (its cross K/V made here, once per utterance). tokens, text_mask
        [B, T] right-padded. Returns the last valid token's logits [B, V]
        and the cache with ``lengths`` set."""
        B, T = tokens.shape
        S = cache.capacity
        if T > S:
            raise ValueError(f"prompt length {T} exceeds the cache's {S}")
        lengths = text_mask.sum(dim=1).to(torch.int32)
        mask = _causal_mask(text_mask)
        if S > T:
            mask = torch.cat([mask, torch.zeros((B, 1, T, S - T),
                                                dtype=torch.bool,
                                                device=mask.device)], -1)
        cache.cross_k, cache.cross_v = self.decoder.cross_kv(enc_states)
        logits = self.decoder(tokens, self._positions(tokens), mask,
                              cache.cross_k, cache.cross_v, enc_mask, cache)
        # lengths - 1 wraps like the reference's take_along_axis index.
        last = logits[torch.arange(B, device=logits.device),
                      torch.remainder(lengths - 1, T).long()]
        cache.lengths.copy_(lengths)
        return last, cache

    def decode_step(self, tokens: torch.Tensor, enc_states: torch.Tensor,
                    enc_mask: torch.Tensor, cache: ASRCache,
                    active: torch.Tensor) -> Tuple[torch.Tensor, ASRCache]:
        """One step for every row: logits [B, V]; the token's k/v written at
        each row's length (a row at capacity writes nothing and stops
        advancing); ``lengths`` advance for active rows. Reads the cache's
        cross K/V (made from ``enc_states`` if the cache has none yet)."""
        if cache.cross_k is None:
            cache.cross_k, cache.cross_v = self.decoder.cross_kv(enc_states)
        active = active & (cache.lengths < cache.capacity)
        positions = cache.lengths[:, None]
        pos = torch.arange(cache.capacity, device=tokens.device)
        mask = pos[None, None, None, :] <= cache.lengths[:, None, None, None]
        logits = self.decoder(tokens, positions, mask, cache.cross_k,
                              cache.cross_v, enc_mask, cache)
        cache.lengths.add_(active.to(torch.int32))
        return logits[:, 0], cache

    # --- planning ----------------------------------------------------------
    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        c = self.cfg
        Ta = (seq_len or AUDIO_BUCKETS[0]) // 2
        Tt = 32
        enc = c.enc_layers * Ta * (8 * c.d_model ** 2 + 4 * Ta * c.d_model)
        dec = c.dec_layers * Tt * (
            12 * c.d_model ** 2 + 4 * Tt * c.d_model + 4 * Ta * c.d_model
        )
        return float(enc + dec)


# --- streaming -------------------------------------------------------------

class StreamingASR:
    """Chunked streaming transcription: feed audio incrementally; each
    flush encodes what is buffered (one duration bucket) and greedily
    decodes, carrying the transcript prefix forward. The model owns its
    weights (the reference passes params beside it)."""

    def __init__(self, model: ASRModel, chunk_frames: int = 200,
                 max_new_tokens: int = 32):
        self.model = model
        self.chunk_frames = chunk_frames
        self.max_new_tokens = max_new_tokens
        self._buffer: List[np.ndarray] = []
        self._tokens: List[int] = [model.cfg.sot_token]

    def reset(self) -> None:
        """Start a fresh stream, keeping what was built (a serving replica
        reuses one StreamingASR across requests)."""
        self._buffer = []
        self._tokens = [self.model.cfg.sot_token]

    def feed(self, mel_frames: np.ndarray) -> Optional[List[int]]:
        """Append [T, n_mels] frames; when a full chunk accumulates,
        transcribe it and return the new token ids (else None)."""
        self._buffer.append(np.asarray(mel_frames, np.float32))
        total = sum(b.shape[0] for b in self._buffer)
        if total < self.chunk_frames:
            return None
        return self.flush()

    def flush(self) -> List[int]:
        """Transcribe everything buffered; returns newly emitted tokens."""
        if not self._buffer:
            return []
        audio = np.concatenate(self._buffer, axis=0)
        self._buffer = []
        mel, mask = collate_audio([audio], batch_bucket=1)
        dev = self.model.device
        with torch.inference_mode():
            enc_states, enc_mask = self.model.encode(
                torch.from_numpy(mel).to(dev), torch.from_numpy(mask).to(dev))
            cfg = self.model.cfg
            prefix = self._tokens[-cfg.max_text_len // 2:]
            new = self._greedy(enc_states, enc_mask, prefix)
        self._tokens.extend(new)
        return new

    def _greedy(self, enc_states, enc_mask, prefix: List[int]) -> List[int]:
        cfg = self.model.cfg
        dev = self.model.device
        T = 16
        while T < len(prefix):
            T *= 2
        tokens = np.zeros((1, T), np.int32)
        tokens[0, :len(prefix)] = prefix
        text_mask = np.zeros((1, T), np.int32)
        text_mask[0, :len(prefix)] = 1
        # Capped at max_text_len: positions past the pos_embed table do
        # not exist; decode_step deactivates rows at cache capacity, so
        # generation stops at the model's limit.
        cache = self.model.make_cache(
            1, max_len=min(T + self.max_new_tokens, cfg.max_text_len))
        logits, cache = self.model.prefill(
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(text_mask).to(dev), enc_states, enc_mask, cache)
        out: List[int] = []
        active = torch.ones((1,), dtype=torch.bool, device=dev)
        step = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        for _ in range(self.max_new_tokens):
            nxt = int(torch.argmax(logits[0].float()))
            if nxt == cfg.eot_token:
                break
            out.append(nxt)
            step.fill_(nxt)
            logits, cache = self.model.decode_step(step, enc_states,
                                                   enc_mask, cache, active)
        return out

    @property
    def transcript(self) -> List[int]:
        return list(self._tokens)


WHISPER_LARGE_V3 = ASRConfig()

WHISPER_TINY_TEST = ASRConfig(
    vocab_size=256,
    n_mels=16,
    d_model=64,
    enc_layers=2,
    dec_layers=2,
    num_heads=4,
    mlp_dim=128,
    max_audio_frames=400,
    max_text_len=64,
    sot_token=254,
    eot_token=255,
)


@register_model("whisper_large_v3", slo=ModelSLO(latency_slo_ms=4000.0))
def _whisper_large(**kwargs) -> ASRModel:
    return ASRModel(WHISPER_LARGE_V3, name="whisper_large_v3", **kwargs)


@register_model("whisper_tiny_test")
def _whisper_tiny(**kwargs) -> ASRModel:
    return ASRModel(WHISPER_TINY_TEST, name="whisper_tiny_test", **kwargs)
