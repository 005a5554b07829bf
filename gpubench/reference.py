"""Plain PyTorch reference of the two decoder families, and the weights.

Written from the published equations, in float32 (TF32 off), with no
kernel, cache or batching: a whole sequence at a time, one layer's
weights cast at a time.

- ``rope`` / ``rms`` / ``swiglu`` (Mistral): x = E[t]; each layer adds
  o(attn(RoPE(q), RoPE(k), v)) of RMSNorm(x), then
  down(silu(gate(h)) * up(h)) of RMSNorm(x); logits = head(RMSNorm(x)).
  RoPE rotates split halves (``rotate_half``) with inverse frequencies
  theta^(-2i/d); grouped-query heads read kv head n // (N / K).
- ``learned`` / ``ln`` / ``gelu`` (GPT-2): x = E[t] + P[p]; LayerNorm
  with a bias, biased q/k/v/o and MLP, GELU's tanh form; logits = x E^T
  (tied).

Attention is causal with scale head_dim^-0.5. ``low=True`` is the
check's control: every product from float8 e4m3 inputs and weights, the
precision below the configurations' bf16. This module imports
nothing of the program: the benchmark makes the weights
(:func:`make_weights`) and hands the same tensors to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def leaf_shapes(decoder: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight. Kinds: ``matrix`` (bf16,
    N(0, 1/fan_in)), ``embed`` (bf16, N(0, 1/d_model)), ``bias`` (bf16,
    N(0, 0.02^2)), ``scale`` (f32, 1 + N(0, 0.1^2)), ``norm_bias`` (f32,
    N(0, 0.02^2)), ``head`` (f32, N(0, 1/d_model))."""
    D, L = int(decoder["d_model"]), int(decoder["num_layers"])
    N, K = int(decoder["num_heads"]), int(decoder["num_kv_heads"])
    H, Fd, V = D // N, int(decoder["mlp_dim"]), int(decoder["vocab_size"])
    gpt2 = decoder["norm"] == "ln"
    out = [("embed", (V, D), "embed")]
    if decoder["pos"] == "learned":
        out.append(("pos_embed", (int(decoder["max_seq_len"]), D), "embed"))

    def norm(name):
        out.append((f"{name}.scale", (D,), "scale"))
        if gpt2:
            out.append((f"{name}.bias", (D,), "norm_bias"))

    def dense(name, d_out, d_in):
        out.append((f"{name}.weight", (d_out, d_in), "matrix"))
        if decoder["use_bias"]:
            out.append((f"{name}.bias", (d_out,), "bias"))

    for i in range(L):
        p = f"layers.{i}"
        norm(f"{p}.attn_norm")
        dense(f"{p}.q", N * H, D)
        dense(f"{p}.k", K * H, D)
        dense(f"{p}.v", K * H, D)
        dense(f"{p}.o", D, N * H)
        norm(f"{p}.mlp_norm")
        if decoder["gated_mlp"]:
            dense(f"{p}.gate", Fd, D)
        dense(f"{p}.up", Fd, D)
        dense(f"{p}.down", D, Fd)
    norm("final_norm")
    if not decoder["tie_embeddings"]:
        out.append(("head", (V, D), "head"))
    return out


@torch.no_grad()
def make_weights(decoder: Dict, seed: int, device) -> Weights:
    """Every weight from ``seed`` on ``device``, in the type it is served
    in: one normal draw per storage type (bf16 and f32) over one flat
    buffer, then each leaf scaled in place. Leaves are views of the two
    buffers."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = leaf_shapes(decoder)
    f32_kinds = ("scale", "norm_bias", "head")
    sizes = {False: 0, True: 0}
    for _, shape, kind in leaves:
        sizes[kind in f32_kinds] += math.prod(shape)
    flat = {
        False: torch.empty(sizes[False], dtype=torch.bfloat16, device=device),
        True: torch.empty(sizes[True], dtype=torch.float32, device=device),
    }
    for buf in flat.values():
        buf.normal_(0.0, 1.0, generator=gen)
    D = int(decoder["d_model"])
    out: Weights = {}
    at = {False: 0, True: 0}
    for name, shape, kind in leaves:
        f32 = kind in f32_kinds
        n = math.prod(shape)
        w = flat[f32][at[f32]:at[f32] + n].view(shape)
        at[f32] += n
        if kind == "matrix":
            w.mul_(shape[1] ** -0.5)
        elif kind in ("embed", "head"):
            w.mul_(D ** -0.5)
        elif kind in ("bias", "norm_bias"):
            w.mul_(0.02)
        elif kind == "scale":
            w.mul_(0.1).add_(1.0)
        out[name] = w
    return out


def _norm(x: torch.Tensor, w: Weights, name: str, decoder: Dict
          ) -> torch.Tensor:
    eps = float(decoder["norm_eps"])
    scale = w[f"{name}.scale"].float()
    if decoder["norm"] == "rms":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale \
        + w[f"{name}.bias"].float()


FP8_MAX = 448.0    # the largest float8 e4m3 number


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to float8 e4m3 with one scale a row (its last
    axis's largest magnitude maps to the format's largest number)."""
    scale = t.abs().amax(-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _dense(x: torch.Tensor, w: Weights, name: str,
           low: bool = False) -> torch.Tensor:
    bias = w.get(f"{name}.bias")
    weight = w[f"{name}.weight"].float()
    if low:
        x, weight = fp8(x), fp8(weight)
    return F.linear(x, weight, None if bias is None else bias.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, N, H]: rotate split halves by position."""
    T, _, H = x.shape
    half = H // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (torch.arange(T, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


@torch.no_grad()
def logits(w: Weights, decoder: Dict, tokens: torch.Tensor,
           rows: slice, low: bool = False) -> torch.Tensor:
    """f32 logits [len(rows), V] of a causal pass over ``tokens`` [T]
    (long, on the weights' device), at the positions ``rows``. ``low``
    computes every product (the head's too) from float8 e4m3 inputs and
    weights, a scale a row: the check's control, a precision below the
    configuration's bf16."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(w, decoder, tokens, rows, low)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits(w, decoder, tokens, rows, low):
    T = tokens.shape[0]
    N, K = int(decoder["num_heads"]), int(decoder["num_kv_heads"])
    H = int(decoder["d_model"]) // N
    x = w["embed"][tokens].float()
    if decoder["pos"] == "learned":
        x = x + w["pos_embed"][:T].float()
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    for i in range(int(decoder["num_layers"])):
        p = f"layers.{i}"
        h = _norm(x, w, f"{p}.attn_norm", decoder)
        q = _dense(h, w, f"{p}.q", low).view(T, N, H)
        k = _dense(h, w, f"{p}.k", low).view(T, K, H)
        v = _dense(h, w, f"{p}.v", low).view(T, K, H)
        if decoder["pos"] == "rope":
            q = _rope(q, float(decoder["rope_theta"]))
            k = _rope(k, float(decoder["rope_theta"]))
        k = k.repeat_interleave(N // K, dim=1)
        v = v.repeat_interleave(N // K, dim=1)
        s = torch.einsum("qnh,knh->nqk", q, k) * H ** -0.5
        s = s.masked_fill(~causal, float("-inf"))
        a = torch.einsum("nqk,knh->qnh", torch.softmax(s, dim=-1), v)
        x = x + _dense(a.reshape(T, N * H), w, f"{p}.o", low)
        h = _norm(x, w, f"{p}.mlp_norm", decoder)
        if decoder["gated_mlp"]:
            m = F.silu(_dense(h, w, f"{p}.gate", low)) \
                * _dense(h, w, f"{p}.up", low)
        else:
            m = F.gelu(_dense(h, w, f"{p}.up", low), approximate="tanh")
        x = x + _dense(m, w, f"{p}.down", low)
    h = _norm(x[rows], w, "final_norm", decoder)
    head = (w["embed"] if decoder["tie_embeddings"] else w["head"]).float()
    if low:
        h, head = fp8(h), fp8(head)
    return F.linear(h, head)


def gaps(w: Weights, decoder: Dict, prompt: torch.Tensor,
         served: torch.Tensor, control: bool = False):
    """At each served token's position, how far the served token's
    reference logit lies below the reference's best ([n] f32, >= 0); with
    ``control``, also how far the token that the float8 pass puts first
    at that position lies below it (the check's control), else None."""
    seq = torch.cat([prompt, served[:-1]])
    P, n = prompt.shape[0], served.shape[0]
    rows = slice(P - 1, P - 1 + n)
    lg = logits(w, decoder, seq, rows)
    best = lg.max(dim=-1).values
    own = best - lg.gather(1, served[:, None])[:, 0]
    if not control:
        return own, None
    pick = logits(w, decoder, seq, rows, low=True).argmax(dim=-1)
    return own, best - lg.gather(1, pick[:, None])[:, 0]
