"""Attention dispatch: the decode kernels, the flash kernel, or the plain
reference — decided by shape before launch.

Port of ``ray_dynamic_batching_tpu/ops/attention.py::dot_product_attention``
(its Pallas branch, lines 149-251):

- a ``page_table`` (the paged pool) -> :func:`_paged_attention`: the
  paged decode kernel for 1 <= Tq <= 8 (route ``"paged_decode"``);
  otherwise the logical view is gathered through the clamped table and
  re-enters this dispatch with ``paged_window_mask`` — flash for W >= 16,
  the plain route for W 9..15;
- non-causal with 1 <= Tq <= 8, a head dim the decode kernels take (a
  multiple of 16 up to 128, ``decode_attention.head_dim_ok``; a shape
  rule decided before launch, where the reference has none) and a window
  mask broadcastable to [B, 1, Tq, S] -> the slab decode kernel
  (``ops/decode_attention.py``); the paged decode kernel takes the same
  head dims;
- otherwise Tq >= 16 -> the flash kernel (``ops/flash_attention.py``);
- everything else the reference sends to XLA (causal Tq <= 15, non-causal
  Tq 9..15, per-head masks), and small windows of a head dim the decode
  kernels refuse -> :func:`reference_attention`, the counterpart of
  ``_xla_attention``, counted apart in :data:`plain_launches`.

:func:`self_attention` is the reference's no-cache entry point: it builds
the padding mask from a ``[B, T]`` token mask (or takes the int8 keep-mask
a model made once for all its layers) and dispatches as above. Under an
active :func:`sequence_parallel` whose mesh has ``sp`` above 1 it takes
the ring branch instead (``ops/ring_attention.py``): q/k/v and the token
mask are then this rank's sequence chunk.

:func:`tensor_parallel` is the reference's TP context (``attention.py:
57-75``, ``:214-222``): while a mesh engine's paged decode step runs inside
it, the paged kernel route passes the mesh to
``decode_attention.paged_decode_attention``, which launches kernel 3 on
this rank's shard of the kv heads (kernel 4's per-shard body). Where the
model's kv heads replicate under the mesh (they do not divide), the
route declines as the reference's does and the gather path runs. Where
a rank's query heads straddle a group boundary (6 q over 3 kv heads at
tp 2), the model first gathers one kv head per query head
(:func:`gather_kv_heads`, counted in :data:`kv_gathers`): each route then
sees grouped-query attention of group 1 over the rank's heads.

With ``k_scale``/``v_scale`` (the int8 KV cache: k/v hold codes) the
routes stay the same: the two decode kernels read the codes and apply the
scales inside their products; every other route dequantizes first
(``models/decoder.py::dequantize_kv``, to the query dtype) and proceeds
as without scales — on the paged read after gathering codes and scales
through the clamped table.

The reference's TPU-only declines — its VMEM budget, (8, 128) tile
alignment and the Mosaic workarounds in ``flash_attention`` /
``_pick_sb`` — have no counterpart on the H100 and are not mirrored: ViT-G/14's
257 tokens of head_dim 104, which the reference declines to XLA (its
degenerate-tiling rule, reference ``ops/flash_attention.py:282-285``), take
the flash route on the card, as ViT-B/16's 197 of 64 do. On CPU tensors
the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

from ray_dynamic_batching_tpu_torch.ops import decode_attention as _decode
from ray_dynamic_batching_tpu_torch.ops import flash_attention as _flash
from ray_dynamic_batching_tpu_torch.ops import graphs
from ray_dynamic_batching_tpu_torch.ops import quant_matmul as _quant

#: Calls routed to :func:`reference_attention` since the last reset.
plain_launches = 0
#: kv-head gathers of :func:`gather_kv_heads` since the last reset.
kv_gathers = 0

_PLAIN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "plain_attention", default=False
)
# (mesh, axis) while a sequence-parallel train step runs (the reference's
# _SP_CTX).
_SP_CTX: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "sequence_parallel_ctx", default=None
)
# (mesh, axis, heads_split) while a TP engine's paged decode step runs.
# A ContextVar, as in the reference: two engines on two threads never
# see each other's mesh.
_TP_CTX: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "tensor_parallel_ctx", default=None
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


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "sp"):
    """While active, :func:`self_attention` routes through ring attention
    over the mesh's ``axis`` when that axis has more than one rank
    (reference ``attention.py:46-55``); the train step enters it."""
    token = _SP_CTX.set((mesh, axis))
    try:
        yield
    finally:
        _SP_CTX.reset(token)


@contextlib.contextmanager
def tensor_parallel(mesh, axis: str = "tp", heads_split: bool = True):
    """While active, the PAGED decode read of a mesh rank routes the
    kernel through its per-shard form (``paged_decode_attention``'s
    ``mesh``): q and the pools are this rank's kv-head shard, the page
    table and lengths whole. ``heads_split`` False (the model's kv heads
    replicate under the mesh) makes the kernel route decline to the
    gather path, as the reference's wrapper declines when ``K % tp`` or
    ``N % tp`` is not 0. The engine enters it around its paged step."""
    token = _TP_CTX.set((mesh, axis, bool(heads_split)))
    try:
        yield
    finally:
        _TP_CTX.reset(token)


def reset_counts() -> None:
    """Zero the launch counts of every kernel (the int8-weight product's
    among them, and each kernel's launches by body) and of the plain
    route."""
    global plain_launches, kv_gathers
    plain_launches = 0
    kv_gathers = 0
    _quant.reset_counts()
    _flash.launches = 0
    _flash.bwd_launches = 0
    for counts in (_flash.launches_by_body, _decode.launches_by_body):
        for body in counts:
            counts[body] = 0
    _decode.launches = 0
    _decode.int8_launches = 0
    _decode.paged_launches = 0
    _decode.paged_int8_launches = 0
    _decode.tp_paged_launches = 0
    _decode.tp_paged_int8_launches = 0


def gather_kv_heads(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t`` (k/v or their scales, kv heads on axis 2) with one kv head per
    query head, ``index`` [N] naming each: a TP rank whose query heads
    straddle a group boundary (``models/decoder.py`` ``kv_index``). The
    kernel routes assume that each group of G query heads reads one kv
    head of a contiguous window; after this gather they see group 1,
    which every route takes. Counted in :data:`kv_gathers`."""
    graphs.count_launch(globals(), "kv_gathers")
    return t.index_select(2, index)


def kernel_mask(mask: Optional[torch.Tensor], B: int, Tq: int
                ) -> Optional[torch.Tensor]:
    """A mask broadcastable to [B, 1, Tq, S] (True = attend) -> the int8
    [B, 1, Tq, S] keep-mask view the kernels read
    (``flash_attention.keep_mask``: one zero-padded key row of row stride
    0 when the mask does not vary over the rows, else rows padded to 16
    bytes), which their wrappers take as it is (no cast, no copy). A model
    makes it once per forward for all its layers; a boolean mask would be
    cast again in each."""
    if mask is None:
        return None
    return _flash.keep_mask(mask, B, Tq, mask.shape[-1]).unsqueeze(1)


def route(q_shape: Sequence[int], k_shape: Sequence[int], *,
          causal: bool, mask_shape: Optional[Sequence[int]] = None,
          page_table_shape: Optional[Sequence[int]] = None,
          lengths_shape: Optional[Sequence[int]] = None) -> str:
    """The route for these shapes — "paged_decode", "decode", "flash" or
    "plain" — by the reference's Pallas-branch rule (see the module
    docstring). With ``page_table_shape`` k_shape is a page pool
    [P, ps, K, H]."""
    if page_table_shape is not None:
        if _decode.paged_eligible(q_shape, k_shape, k_shape,
                                  page_table_shape, lengths_shape):
            return "paged_decode"
        B, Tq = q_shape[0], q_shape[1]
        S = page_table_shape[1] * k_shape[1]
        return route(q_shape, (B, S) + tuple(k_shape[2:]), causal=False,
                     mask_shape=(B, 1, Tq, S))
    B, Tq, N, _ = q_shape
    S, K = k_shape[1], k_shape[2]
    heads_ok = K > 0 and N % K == 0
    if (not causal and heads_ok and 1 <= Tq <= _decode.MAX_WINDOW_FOR_KERNEL
            and _decode.head_dim_ok(q_shape[3])):
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
    page_table: Optional[torch.Tensor] = None,
    kv_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention. q [B, Tq, N, H], k/v [B, Tk, K, H] with K
    dividing N (grouped-query attention); mask broadcastable to
    [B, 1, Tq, Tk], True = attend.

    The mask may be boolean or the int8 keep-mask of :func:`kernel_mask`
    (1 = attend), which the kernel routes take without a cast.

    ``k_scale``/``v_scale`` [B, Tk, K] f32: k/v are int8 KV-cache codes
    (``models/decoder.py::KVCache``); both or neither.

    ``page_table`` [B, NP] + ``kv_lengths`` [B] switch to the paged read:
    k/v are page pools [P, ps, K, H] shared by all slots (scales
    [P, ps, K]), and window row t attends logical positions
    <= kv_lengths + t."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 KV attention needs both k_scale and v_scale")
    if page_table is not None:
        return _paged_attention(q, k, v, page_table, kv_lengths, mask=mask,
                                scale=scale, k_scale=k_scale,
                                v_scale=v_scale)
    which = route(q.shape, k.shape, causal=causal,
                  mask_shape=None if mask is None else mask.shape)
    if k_scale is not None and which != "decode":
        # Deferred import (the decoder imports this module): the dequant
        # rule has one definition, beside the quantizer it inverts.
        from ray_dynamic_batching_tpu_torch.models.decoder import (
            dequantize_kv,
        )

        k = dequantize_kv(k, k_scale, q.dtype)
        v = dequantize_kv(v, v_scale, q.dtype)
        k_scale = v_scale = None
    if which != "plain" and _PLAIN.get():
        B, Tq, _, _ = q.shape
        Tk = k.shape[1]
        if which == "decode":
            return _decode.decode_attention_plain(
                q, k, v, _flash.keep_mask(mask, B, Tq, Tk), scale=scale,
                k_scale=k_scale, v_scale=v_scale)
        return _flash.flash_attention_plain(
            q, k, v, _flash.keep_mask(mask, B, Tq, Tk), causal=causal,
            scale=scale)
    if which == "decode":
        return _decode.decode_attention(q, k, v, mask=mask, scale=scale,
                                        k_scale=k_scale, v_scale=v_scale)
    if which == "flash":
        return _flash.flash_attention(q, k, v, causal=causal, mask=mask,
                                      scale=scale)
    graphs.count_launch(globals(), "plain_launches")
    return reference_attention(q, k, v, causal=causal, mask=mask,
                               scale=scale)


def self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    token_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention over a full (un-cached) sequence (reference
    ``attention.py:76-105``); q/k/v [B, T, *, H], token_mask [B, T]
    nonzero = valid. Under an active :func:`sequence_parallel` with sp > 1
    this rank's chunk through ring attention; otherwise dense attention
    with the causal flag and the padding mask ``token_mask[:, None, None,
    :]`` (or ``keep``, that mask as the int8 keep-mask [B, 1, T, T] a
    model makes once per forward), through :func:`dot_product_attention`
    (so T >= 16 takes the flash kernel)."""
    ctx = _SP_CTX.get()
    if ctx is not None and ctx[0].shape.get(ctx[1], 1) > 1:
        from ray_dynamic_batching_tpu_torch.ops.ring_attention import (
            ring_self_attention,
        )

        return ring_self_attention(ctx[0], q, k, v, token_mask,
                                   causal=causal, scale=scale, axis=ctx[1])
    mask = keep
    if mask is None and token_mask is not None:
        mask = token_mask[:, None, None, :].bool()
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 scale=scale)


def _paged_attention(q, k, v, page_table, kv_lengths, *, mask, scale,
                     k_scale, v_scale) -> torch.Tensor:
    """Paged read (reference ``attention.py:189-251``): the paged decode
    kernel for small windows; otherwise gather the logical view (codes and
    scales alike) through the clamped table and re-enter
    :func:`dot_product_attention` with the staircase window mask."""
    if mask is not None:
        raise ValueError(
            "paged attention derives its window from kv_lengths; an "
            "explicit mask on this path means a caller mixed the slab "
            "and paged conventions"
        )
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        paged_window_mask,
    )

    scales = dict(k_scale=k_scale, v_scale=v_scale)
    tp = _TP_CTX.get()
    mesh_kwargs = {}
    if tp is not None and tp[0].shape.get(tp[1], 1) > 1:
        mesh_kwargs = {"mesh": tp[0], "mesh_axis": tp[1]}
    if (not mesh_kwargs or tp[2]) and route(
            q.shape, k.shape, causal=False,
            page_table_shape=page_table.shape,
            lengths_shape=kv_lengths.shape) == "paged_decode":
        if _PLAIN.get():
            return _decode.paged_decode_attention_plain(
                q, k, v, page_table, kv_lengths, scale=scale, **scales)
        return _decode.paged_decode_attention(q, k, v, page_table,
                                              kv_lengths, scale=scale,
                                              **scales, **mesh_kwargs)
    k_g = _decode.logical_view(k, page_table)
    v_g = _decode.logical_view(v, page_table)
    if k_scale is not None:
        scales = {name: _decode.logical_view(t, page_table)
                  for name, t in scales.items()}
    win = paged_window_mask(kv_lengths, k_g.shape[1], q.shape[1])
    return dot_product_attention(q, k_g, v_g, mask=win, scale=scale,
                                 **scales)


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
    probabilities cast to the input dtype before the PV product. The mask
    is boolean or an int8 keep-mask (nonzero = attend)."""
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
        logits = torch.where(mask.bool(), logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs.float(),
                        v.float()).to(q.dtype)
