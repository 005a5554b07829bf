"""Attention dispatch: the decode kernel, the flash kernel, or the plain
reference — decided by shape before launch.

Port of ``ray_dynamic_batching_tpu/ops/attention.py::dot_product_attention``
(its Pallas branch, lines 154-186):

- non-causal with 1 <= Tq <= 8 (and a window mask broadcastable to
  [B, 1, Tq, S]) -> the slab decode kernel (``ops/decode_attention.py``);
- otherwise Tq >= 16 -> the flash kernel (``ops/flash_attention.py``);
- everything else the reference sends to XLA (causal Tq <= 15, non-causal
  Tq 9..15, per-head masks) -> :func:`reference_attention`, the
  counterpart of ``_xla_attention``, counted apart in
  :data:`plain_launches`.

The reference's TPU-only declines — its VMEM budget, (8, 128) tile
alignment and the Mosaic workarounds in ``flash_attention`` /
``_pick_sb`` — have no counterpart on the H100 and are not mirrored. On
CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

from ray_dynamic_batching_tpu_torch.ops import decode_attention as _decode
from ray_dynamic_batching_tpu_torch.ops import flash_attention as _flash

#: Calls routed to :func:`reference_attention` since the last reset.
plain_launches = 0

_PLAIN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "plain_attention", default=False
)


@contextlib.contextmanager
def plain_attention():
    """Inside this context the kernel routes run the kernels' plain
    versions even on CUDA tensors: for holding a model's kernel path
    against its plain path on the card. The serving path never enters it."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def reset_counts() -> None:
    """Zero the launch counts of both kernels and of the plain route."""
    global plain_launches
    plain_launches = 0
    _flash.launches = 0
    _decode.launches = 0


def route(q_shape: Sequence[int], k_shape: Sequence[int], *,
          causal: bool, mask_shape: Optional[Sequence[int]] = None) -> str:
    """The route for these shapes — "decode", "flash" or "plain" — by
    the reference's Pallas-branch rule (see the module docstring)."""
    B, Tq, N, _ = q_shape
    S, K = k_shape[1], k_shape[2]
    heads_ok = K > 0 and N % K == 0
    if not causal and heads_ok and 1 <= Tq <= _decode.MAX_WINDOW_FOR_KERNEL:
        if mask_shape is None or _window_broadcastable(mask_shape, B, Tq, S):
            return "decode"
    if Tq >= _flash.MIN_QUERY_FOR_KERNEL and heads_ok:
        return "flash"
    return "plain"


def _window_broadcastable(shape: Sequence[int], B: int, Tq: int,
                          S: int) -> bool:
    target = (B, 1, Tq, S)
    if len(shape) > 4 or shape[-1] != S:
        return False
    for have, want in zip(reversed(tuple(shape)), reversed(target)):
        if have not in (1, want):
            return False
    return True


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention. q [B, Tq, N, H], k/v [B, Tk, K, H] with K
    dividing N (grouped-query attention); mask broadcastable to
    [B, 1, Tq, Tk], True = attend."""
    global plain_launches
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV-cache attention (k_scale/v_scale) is not ported yet"
        )
    which = route(q.shape, k.shape, causal=causal,
                  mask_shape=None if mask is None else mask.shape)
    if which != "plain" and _PLAIN.get():
        B, Tq, _, _ = q.shape
        Tk = k.shape[1]
        if which == "decode":
            return _decode.decode_attention_plain(
                q, k, v, _flash.keep_mask(mask, B, Tq, Tk), scale=scale)
        return _flash.flash_attention_plain(
            q, k, v, _flash.keep_mask(mask, B, Tq, Tk), causal=causal,
            scale=scale)
    if which == "decode":
        return _decode.decode_attention(q, k, v, mask=mask, scale=scale)
    if which == "flash":
        return _flash.flash_attention(q, k, v, causal=causal, mask=mask,
                                      scale=scale)
    plain_launches += 1
    return reference_attention(q, k, v, causal=causal, mask=mask,
                               scale=scale)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The counterpart of ``_xla_attention``: GQA by repeat, f32 logits,
    masked logits filled with -1e30 (so a fully masked row averages V),
    probabilities cast to the input dtype before the PV product."""
    B, Tq, N, H = q.shape
    _, Tk, K, _ = k.shape
    if K != N:
        if N % K != 0:
            raise ValueError(f"query heads {N} not divisible by kv heads {K}")
        k = k.repeat_interleave(N // K, dim=2)
        v = v.repeat_interleave(N // K, dim=2)
    scale = H ** -0.5 if scale is None else scale
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        logits = logits.masked_fill(~keep, -1e30)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs.float(),
                        v.float()).to(q.dtype)
