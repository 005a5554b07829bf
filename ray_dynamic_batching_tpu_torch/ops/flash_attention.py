"""Flash prefill attention: the CUDA kernel, its plain version, its count.

Replaces ``ray_dynamic_batching_tpu/ops/flash_attention.py::_flash_attention``
(Pallas body ``_attn_kernel``). The kernel is ``csrc/flash_attention.cu``:
FlashAttention-2 forward, online softmax in f32, the int8 keep-mask and the
causal iota rule, KV head ``n // (N // K)``, and a row with no attended key
giving 0. Head dims: any multiple of 8 up to 128 (64 and 128 natively; 104,
ViT-G/14's, on the 128 tiles with zero-filled columns).

Which body takes which shape (decided in the launcher, by shape alone):

- bf16 with a mask or causal, or with one head's K/V too large for shared
  memory (the LLM shapes: 64-row chunks over a 512-position row cache):
  one block per (batch row, query head, 64-row tile); each block reads its
  rows of the mask first and walks only the 64-key tiles some row attends
  (exact: a wholly masked tile changes nothing under the flash rule), with
  both products on the tensor cores (``mma.sync``) and K/V staged bf16 by
  ``cp.async`` into a double buffer. What bounds it: the K/V bytes of the
  live tiles.
- bf16, no mask, not causal, one (batch row, KV head)'s K and V resident in
  shared memory (the vision shapes: ViT-B/16's 197 x 64, ViT-G/14's 257 x
  104): one block per (query head, batch row) that loads K/V once and whose
  warps walk the 16-row query slabs over every key. What bounds it: q, k,
  v and out, each moved once.
- f32 (parity runs): an FMA body, one block per 64-row tile (TF32 would
  miss the f32 tolerance).

q, k and v go in with their own batch and token strides (heads ``H`` apart,
the last dim contiguous), so the views of a packed qkv projection
(``models/vit.py``) are read in place; a tensor laid out otherwise, or with
a stride that breaks 16-byte chunks, is copied first. The output is a fresh
contiguous ``[B, Tq, N, H]``. The kernel reads the mask in 16-byte loads, so
an int8 mask that is not 16-byte aligned is copied first.

On a CUDA tensor :func:`flash_attention` launches the kernel or raises;
on a CPU tensor it runs :func:`flash_attention_plain`, the same function
written in PyTorch, which the tests hold against the JAX kernel.

Training: the kernel's output from a ctypes launch has no ``grad_fn``, so
when grad mode is on and q, k or v requires grad, :func:`flash_attention`
goes through :class:`FlashAttentionFn` (port-own; the JAX package
differentiates its attention with XLA's autodiff). Its forward is the same
kernel launch with the LSE pointer set: body A (or the f32 body) also
writes each row's log-sum-exp of the scaled scores, ``[B, N, Tq]`` f32,
and never takes the vision body. Its backward is
``csrc/flash_attention_bwd.cu``, counted in :data:`bwd_launches`:
FlashAttention-2's backward with P recomputed from the LSE, after a
preprocess for ``D = rowsum(dO o O)``. In bf16 (training) one launch runs
two roles on the tensor cores (``mma.sync``, bf16 tiles staged by
``cp.async`` into double buffers, the tiles the mask and the causal rule
void skipped): dK/dV blocks that each keep a 64-key tile of K and V and
walk the query tiles of every query head of its group (GQA's sum stays in
registers), then dQ blocks that walk the key tiles. No atomics, so the
gradients are the same bits on every call. What bounds it is the
products' issue rate at two warps a scheduler (255 registers a thread)
and the heaviest dK/dV blocks: 0.283 ms at llama3_8b's training shape on
an H100 (700 W; forward + backward 0.426, SDPA's 0.331). The f32 route
(model-parity runs, tolerance 1e-4) keeps FMA kernels: TF32 would miss
it. On CPU tensors the same function runs
:func:`flash_attention_fwd_plain` and :func:`flash_attention_bwd_plain`.
The bare launch refuses an input that requires grad while grad mode is on,
so a cut gradient cannot come back silently.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_dynamic_batching_tpu_torch.ops import graphs

NEG_INF = -1e30

# Query windows below this go to the decode kernel or the plain version
# (the JAX package's MIN_QUERY_FOR_PALLAS).
MIN_QUERY_FOR_KERNEL = 16

#: Kernel launches since the last reset (plain-version calls do not count;
#: a graph replay adds the launches its capture recorded).
launches = 0
#: Backward-kernel launches (one per FlashAttentionFn backward on the card).
bwd_launches = 0


def keep_mask(mask: Optional[torch.Tensor], B: int, Tq: int, Tk: int
              ) -> Optional[torch.Tensor]:
    """A mask broadcastable to [B, 1, Tq, Tk] (True = attend) -> the dense
    contiguous int8 [B, Tq, Tk] both kernels read (raises on another
    pattern, e.g. a per-head mask)."""
    if mask is None:
        return None
    return mask.expand(B, 1, Tq, Tk).reshape(B, Tq, Tk).to(
        torch.int8).contiguous()


def _scores(q, k, mask, causal, scale):
    """(scaled f32 scores [B, K, G, Tq, Tk] with masked keys at NEG_INF,
    the attended mask broadcastable to them)."""
    B, Tq, N, H = q.shape
    _, Tk, K, _ = k.shape
    qg = q.reshape(B, Tq, K, N // K, H).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    valid = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        valid = kpos <= qpos + (Tk - Tq)
    valid = valid[None, None, None]
    if mask is not None:
        valid = valid & (mask != 0)[:, None, None]
    return torch.where(valid, s, torch.full_like(s, NEG_INF)), valid


def flash_attention_fwd_plain(q, k, v, mask=None, *, causal: bool = False,
                              scale: Optional[float] = None):
    """(out, lse): :func:`flash_attention_plain`'s output and each row's
    log-sum-exp of the scaled scores, ``[B, N, Tq]`` f32 (0 for a row with
    no attended key), what the kernel writes through its LSE pointer."""
    B, Tq, N, H = q.shape
    scale = H ** -0.5 if scale is None else scale
    s, valid = _scores(q, k, mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v.float())
    out = pv / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l == 0.0, torch.zeros_like(l),
                      m + torch.log(torch.where(l == 0.0, torch.ones_like(l),
                                                l)))
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Tq, N, H).to(q.dtype),
            lse.reshape(B, N, Tq))


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """What the kernel computes, in PyTorch. q [B, Tq, N, H], k/v
    [B, Tk, K, H] (any strides), mask int8 [B, Tq, Tk] (1 = attend) or
    None. Scores and the softmax in f32; probabilities rounded to the
    input type before the PV product; a row with no attended key gives 0.
    Differentiable by autograd: the reference the backward kernel is held
    to."""
    return flash_attention_fwd_plain(q, k, v, mask, causal=causal,
                                     scale=scale)[0]


def flash_attention_bwd_plain(q, k, v, out, dout, lse, mask=None, *,
                              causal: bool = False,
                              scale: Optional[float] = None):
    """What the backward kernel computes, in PyTorch: (dq, dk, dv) in the
    inputs' dtypes from the saved ``out`` and ``lse`` (P recomputed as
    ``exp(s - lse)`` on attended keys, ``D = rowsum(dout o out)``, ``dS =
    P o (dP - D)``); GQA's query heads summed into their kv head."""
    B, Tq, N, H = q.shape
    _, Tk, K, _ = k.shape
    G = N // K
    scale = H ** -0.5 if scale is None else scale
    s, valid = _scores(q, k, mask, causal, scale)
    p = torch.where(valid, torch.exp(s - lse.reshape(B, K, G, Tq, 1)),
                    torch.zeros_like(s))
    do = dout.reshape(B, Tq, K, G, H).float()
    d = (do * out.reshape(B, Tq, K, G, H).float()).sum(-1)   # [B,Tq,K,G]
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh",
                      ds, q.reshape(B, Tq, K, G, H).float()) * scale
    return (dq.reshape(B, Tq, N, H).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, T, heads, H] as the kernel reads it: the last dim
    contiguous, heads ``H`` apart, batch and token strides whole 16-byte
    chunks (a size-1 dim's stride is never used). Anything else is copied;
    the packed qkv views pass as they are."""
    unit = 16 // t.element_size()
    B, T, heads, H = t.shape
    ok = (t.stride(3) == 1 and (heads == 1 or t.stride(2) == H)
          and (B == 1 or t.stride(0) % unit == 0)
          and (T == 1 or t.stride(1) % unit == 0))
    return t if ok else t.contiguous()


def _launch(q, k, v, mask_i8, *, causal: bool, scale: float,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One kernel-1 launch; ``lse`` ([B, N, Tq] f32) also takes each row's
    log-sum-exp (training's forward)."""
    from ray_dynamic_batching_tpu_torch.ops import _build

    if lse is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash kernel: an input requires grad and the bare launch has no "
            "backward; call flash_attention (FlashAttentionFn) instead")
    B, Tq, N, H = q.shape
    _, Tk, K, _ = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel: unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernel: q, k and v must share one dtype")
    if H % 8 or not 0 < H <= 128:
        raise ValueError(f"flash kernel: head_dim {H} is not a multiple of 8 "
                         "up to 128")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != H:
        raise ValueError(f"flash kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    for t in (q, k, v):
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError("flash kernel: inputs must be 16-byte aligned "
                             "tensors on one device")
        if t.stride(1) * t.shape[1] >= 2 ** 31:
            raise ValueError("flash kernel: a token stride times the length "
                             "must fit 32 bits")
    if mask_i8 is not None and (mask_i8.device != q.device
                                or tuple(mask_i8.shape) != (B, Tq, Tk)):
        raise ValueError(f"flash kernel: mask must be int8 [{B}, {Tq}, {Tk}]")
    if mask_i8 is not None and mask_i8.data_ptr() % 16:
        mask_i8 = mask_i8.clone()     # the kernel reads it in 16-byte loads
    out = torch.empty((B, Tq, N, H), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    with _build.launch_lock:
        rc = lib.rdb_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_i8.data_ptr() if mask_i8 is not None else None,
            out.data_ptr(), B, Tq, Tk, N, K, H,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale), int(causal),
            0 if q.dtype == torch.float32 else 1,
            lse.data_ptr() if lse is not None else None,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "flash_attention")
    graphs.count_launch(globals(), "launches")
    return out


def _launch_bwd(q, k, v, out, dout, lse, mask_i8, *, causal: bool,
                scale: float):
    """(dq, dk, dv) from ``csrc/flash_attention_bwd.cu``."""
    from ray_dynamic_batching_tpu_torch.ops import _build

    B, Tq, N, H = q.shape
    _, Tk, K, _ = k.shape
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    if mask_i8 is not None:
        mask_i8 = mask_i8.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty((B, N, Tq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd")
    with _build.launch_lock:
        rc = lib.rdb_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            mask_i8.data_ptr() if mask_i8 is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            B, Tq, Tk, N, K, H, float(scale), int(causal),
            0 if q.dtype == torch.float32 else 1,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "flash_attention_bwd")
    graphs.count_launch(globals(), "bwd_launches")
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Kernel 1 with a backward (see the module docstring). Inputs: q, k,
    v, the int8 keep-mask [B, Tq, Tk] or None (saved by reference, never
    differentiated), causal, scale."""

    @staticmethod
    def forward(ctx, q, k, v, mask_i8, causal: bool, scale: float):
        if q.is_cuda:
            B, Tq, N, _ = q.shape
            lse = torch.empty((B, N, Tq), dtype=torch.float32,
                              device=q.device)
            out = _launch(q, k, v, mask_i8, causal=causal, scale=scale,
                          lse=lse)
        else:
            out, lse = flash_attention_fwd_plain(q, k, v, mask_i8,
                                                 causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, mask_i8)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask_i8 = ctx.saved_tensors
        if dout.is_cuda:
            dq, dk, dv = _launch_bwd(q, k, v, out, dout, lse, mask_i8,
                                     causal=ctx.causal, scale=ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, dout, lse, mask_i8, causal=ctx.causal,
                scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention. q [B, Tq, N, H], k/v [B, Tk, K, H] (K divides N;
    strided views welcome, see the module docstring), mask broadcastable
    to [B, 1, Tq, Tk] (True = attend). CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    B, Tq, N, H = q.shape
    _, Tk, K, _ = k.shape
    if K == 0 or N % K != 0:
        raise ValueError(f"query heads {N} not divisible by kv heads {K}")
    scale = H ** -0.5 if scale is None else float(scale)
    mask_i8 = keep_mask(mask, B, Tq, Tk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, mask_i8, causal, scale)
    if q.is_cuda:
        return _launch(q, k, v, mask_i8, causal=causal, scale=scale)
    return flash_attention_plain(q, k, v, mask_i8, causal=causal, scale=scale)
