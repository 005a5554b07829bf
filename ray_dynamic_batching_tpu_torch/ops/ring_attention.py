"""Ring attention: sequence-parallel exact attention over the ``sp`` mesh axis.

Port of ``ray_dynamic_batching_tpu/ops/ring_attention.py:32-167``. The
sequence is cut into contiguous chunks, one a rank of the mesh's ``sp``
group (``parallel/mesh.py::seq_sharding``); each rank keeps its query chunk
resident and the key/value chunks rotate one hop around the ring per step
(rank ``j`` sends to ``j + 1``), accumulating exact attention online:

- the reference's online softmax: the finite ``-1e30`` sentinel, masked
  probabilities zeroed explicitly (with the sentinel, ``exp(logits -
  m_new)`` would be 1 for a row whose running max is still the sentinel),
  scores and sums in f32, the output ``acc / max(l, 1e-30)`` cast to q's
  dtype;
- GQA expanded after the hop, so the ring ships only the K kv heads;
- global positions ``chunk_index * T_local + offset`` for the causal rule,
  and the reference's skip of wholly-future blocks (``src * Tk > idx * Tq
  + Tq - 1``), which still rotates so the ring never deadlocks.

The reference runs inside ``shard_map`` and JAX differentiates its
``ppermute`` by reversing it; torch's point-to-point ops are not
autograd-aware, so the ring is :class:`RingAttentionFn`. Its forward saves
the per-row log-sum-exp; its backward re-runs the ring: P is recomputed
from the LSE, dQ accumulates at home, and each block's dK/dV partials
travel with their block, landing home after a full cycle (``sp`` hops).

The per-block math is plain torch, as the reference's is plain ``jnp``.
Each hop is one exchange of one packed f32 buffer (k, v, the key mask; and
in the backward dk, dv) with ``parallel/collective.pg_exchange``; gloo
stages CUDA tensors through the host.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite sentinel: keeps the online softmax NaN-free


class _Ring:
    """A rank's place in the ring: its group, size, index, and whether the
    backend needs CUDA tensors staged through the host."""

    def __init__(self, group, size: int, index: int, stage: bool) -> None:
        self.group, self.size, self.index, self.stage = (group, size, index,
                                                         stage)

    def hop(self, parts):
        """Send ``parts`` (tensors) to the next rank and return the
        previous rank's, same shapes and dtypes."""
        from ray_dynamic_batching_tpu_torch.parallel.collective import (
            pg_exchange,
        )

        flat = torch.cat([p.reshape(-1).float() for p in parts])
        got = pg_exchange(self.group, flat, (self.index + 1) % self.size,
                          flat, (self.index - 1) % self.size, self.index,
                          self.stage)
        out, at = [], 0
        for p in parts:
            out.append(got[at:at + p.numel()].view(p.shape).to(p.dtype))
            at += p.numel()
        return out


def _valid(mask_blk, q_pos, k_pos, causal: bool) -> torch.Tensor:
    """[B, 1, Tq, Tk]: the block's key mask and, causal, key <= query."""
    valid = mask_blk[:, None, None, :]
    if causal:
        valid = valid & (k_pos[None, None, None, :]
                         <= q_pos[None, None, :, None])
    return valid


def _expand(t: torch.Tensor, G: int) -> torch.Tensor:
    return t if G == 1 else t.repeat_interleave(G, dim=2)


def _skipped(causal: bool, step: int, src: int, idx: int, Tq: int,
             Tk: int) -> bool:
    """The reference's skip: a block wholly in the future of every local
    query (its compute only; the ring still rotates)."""
    return causal and step > 0 and src * Tk > idx * Tq + (Tq - 1)


class RingAttentionFn(torch.autograd.Function):
    """Exact attention over the ring (see the module docstring). q
    [B, Tq, N, H], k/v [B, Tk, K, H] (this rank's chunks), kv_mask
    [B, Tk] bool (True = valid key)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, ring: _Ring, causal: bool,
                scale: float):
        B, Tq, N, H = q.shape
        _, Tk, K, _ = k.shape
        G = N // K
        idx, size = ring.index, ring.size
        dev = q.device
        q_pos = idx * Tq + torch.arange(Tq, device=dev)
        m = torch.full((B, N, Tq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, N, Tq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Tq, N, H), dtype=torch.float32, device=dev)
        qf = q.float()
        blk = (k, v, kv_mask)
        for step in range(size):
            src = (idx - step) % size
            if not _skipped(causal, step, src, idx, Tq, Tk):
                k_blk, v_blk, mask_blk = blk
                k_pos = src * Tk + torch.arange(Tk, device=dev)
                logits = torch.einsum("bqnh,bknh->bnqk", qf,
                                      _expand(k_blk, G).float()) * scale
                valid = _valid(mask_blk, q_pos, k_pos, causal)
                logits = torch.where(valid, logits,
                                     torch.full_like(logits, NEG_INF))
                m_new = torch.maximum(m, logits.amax(dim=-1))
                p = torch.where(valid, torch.exp(logits - m_new[..., None]),
                                torch.zeros_like(logits))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
                    "bnqk,bknh->bqnh", p, _expand(blk[1], G).float())
                m = m_new
            if step != size - 1:
                blk = tuple(ring.hop(blk))
        lsafe = torch.clamp(l, min=1e-30)
        out32 = acc / lsafe.transpose(1, 2)[..., None]
        lse = m + torch.log(lsafe)
        ctx.save_for_backward(q, k, v, kv_mask, out32, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out32, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        B, Tq, N, H = q.shape
        _, Tk, K, _ = k.shape
        G = N // K
        idx, size = ring.index, ring.size
        dev = q.device
        q_pos = idx * Tq + torch.arange(Tq, device=dev)
        qf = q.float()
        do = dout.float()
        D = (do * out32).sum(-1).transpose(1, 2)            # [B, N, Tq]
        dq = torch.zeros_like(qf)
        blk = (k, v, kv_mask,
               torch.zeros((B, Tk, K, H), dtype=torch.float32, device=dev),
               torch.zeros((B, Tk, K, H), dtype=torch.float32, device=dev))
        for step in range(size):
            src = (idx - step) % size
            if not _skipped(causal, step, src, idx, Tq, Tk):
                k_blk, v_blk, mask_blk, dk_blk, dv_blk = blk
                k_pos = src * Tk + torch.arange(Tk, device=dev)
                kf = _expand(k_blk, G).float()
                vf = _expand(v_blk, G).float()
                logits = torch.einsum("bqnh,bknh->bnqk", qf, kf) * scale
                valid = _valid(mask_blk, q_pos, k_pos, causal)
                p = torch.where(valid, torch.exp(logits - lse[..., None]),
                                torch.zeros_like(logits))
                dv_e = torch.einsum("bnqk,bqnh->bknh", p, do)
                dp = torch.einsum("bqnh,bknh->bnqk", do, vf)
                ds = p * (dp - D[..., None])
                dq = dq + torch.einsum("bnqk,bknh->bqnh", ds, kf) * scale
                dk_e = torch.einsum("bnqk,bqnh->bknh", ds, qf) * scale
                blk = (k_blk, v_blk, mask_blk,
                       dk_blk + dk_e.reshape(B, Tk, K, G, H).sum(3),
                       dv_blk + dv_e.reshape(B, Tk, K, G, H).sum(3))
            if step != size - 1:
                blk = tuple(ring.hop(blk))
        # One more hop sends each block's partials to its owner.
        dk, dv = ring.hop(blk[3:]) if size > 1 else blk[3:]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, size: int, index: int, stage: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence cut into ``size`` contiguous chunks,
    this rank holding chunk ``index`` (reference ``ring_attention``).
    Shapes per rank: q [B, Tq, N, H]; k/v [B, Tk, K, H] with K dividing N;
    kv_mask [B, Tk] True = valid key. Padding queries give values the
    caller's loss masks."""
    B, Tq, N, H = q.shape
    K = k.shape[2]
    if K == 0 or N % K != 0:
        raise ValueError(f"query heads {N} not divisible by kv heads {K}")
    scale = H ** -0.5 if scale is None else float(scale)
    if kv_mask is None:
        kv_mask = torch.ones((B, k.shape[1]), dtype=torch.bool,
                             device=q.device)
    ring = _Ring(group, size, index, stage)
    return RingAttentionFn.apply(q, k, v, kv_mask.bool(), ring, causal,
                                 scale)


def ring_self_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor,
                        token_mask: Optional[torch.Tensor] = None, *,
                        causal: bool = True, scale: Optional[float] = None,
                        axis: str = "sp") -> torch.Tensor:
    """This rank's chunk of self-attention over the mesh's ``axis`` ring
    (reference ``ring_self_attention``; here q/k/v and ``token_mask`` are
    already the rank's chunks, as ``parallel/train.py`` cuts them)."""
    group = mesh.axis_group((axis,))
    stage = mesh.backend == "gloo" and q.is_cuda
    return ring_attention(q, k, v, group=group.group, size=group.size,
                          index=group.index, stage=stage,
                          kv_mask=token_mask, causal=causal, scale=scale)
