"""The exactness arguments of the port's CUDA kernels, on the CPU.

The CUDA kernels cannot run here, so the two rules their redesign rests on
are modelled in PyTorch, step for step as the kernels take them, and held
against the JAX kernels run as the JAX package's own tests run them (Pallas
in interpret mode), on the same numpy inputs:

- **Split-S decode** (``csrc/common.cuh`` ``DecodeScan``, kernels 2 and 3):
  the logical positions of a slot are cut into splits; each split scans its
  live 64-key tiles with the reference's online softmax (masked scores
  NEG_INF, p not zeroed, l from the unrounded p) and leaves (m, l, acc); the
  live splits are merged with weights exp(m_s - M), M the largest m_s. A
  tile or split that no window row attends is not read, unless some row
  attends no key at all, when everything is scanned.
- **Flash live-tile skipping** (``csrc/flash_attention.cu``, kernel 1): a
  block of 64 query rows walks only the 64-key tiles where some row attends
  some key under the mask and the causal rule. Each tile's keys are split
  in two halves of 32, each with its own running (l, acc), both holding
  the running max over the whole tile: p is rounded to v's type against
  that max, where the reference rounds it; the halves are summed at the end.

- **Flash body C** (``csrc/flash_attention.cu`` ``bodyc``, kernel 1 at
  Tq >= 128, head_dim <= 64): 128-row blocks walk the live 64-key tiles;
  each row's running max covers the whole tile (no key halves), where p
  is rounded to v's type; the keep-mask is read through its layout (a
  key row of stride 0 stands for every row, its liveness taken at the
  block's last row under the causal rule).
- **The single-row scan** (``csrc/common.cuh`` ``RowScan``, kernels 2 and
  3 at R = Tq * G = 1): splits of ``row_split_tiles(B * K, S)`` tiles
  (``RowScan::split_tiles``; the card tests hold the kernels' rule to
  this one's values);
  four warps each take 16 keys of every live tile with their own online
  softmax (the reference's decode rule: masked scores NEG_INF, p not
  zeroed), merged in warp order, then the splits merged in split order.

Each model is also run without skipping: the outputs must be bit-identical
(skipping is exact, not merely close). Tolerance against JAX: atol 1e-5 —
the same math summed in another order. The flash model is also held to
the JAX kernel with bf16 K/V and an f32 query of bf16 values, so that the
output stays f32 and shows where p was rounded: at 1e-5 this tells the
shared tile max from each half's own max, which the test checks too.
Body C's model is held so with XLA's exp (the JAX kernel's), so that p
has the same f32 bits before it is rounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.ops import decode_attention as j_decode
from ray_dynamic_batching_tpu.ops import flash_attention as j_flash
from ray_dynamic_batching_tpu_torch.ops import flash_attention as t_flash

torch.set_num_threads(2)

ATOL = 1e-5
NEG_INF = -1e30
TILE = 64


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def split_scan_model(q, k, v, mask, split: int, skip: bool = True):
    """Kernel 2's rule in PyTorch, f32. q [B, Tq, N, H], k/v [B, S, K, H],
    mask bool [B, Tq, S]. Returns [B, Tq, N, H]."""
    B, Tq, N, H = q.shape
    S, K = k.shape[1], k.shape[2]
    G = N // K
    ntiles = -(-S // TILE)
    nsplit = -(-S // split)
    out = torch.empty_like(q)
    for b in range(B):
        tile_live = [bool(mask[b, :, t * TILE:(t + 1) * TILE].any())
                     for t in range(ntiles)]
        if not skip or not bool(mask[b].any(dim=-1).all()):
            tile_live = [True] * ntiles    # a row attends nothing: scan all
        valid = mask[b].repeat_interleave(G, dim=0)          # [R, S], (t, g)
        for kvh in range(K):
            qr = q[b, :, kvh * G:(kvh + 1) * G].reshape(Tq * G, H)
            parts = []
            for s in range(nsplit):
                tiles = [t for t in range(s * split // TILE,
                                          min(ntiles, (s + 1) * split // TILE))
                         if tile_live[t]]
                if not tiles:
                    continue                 # void split: never read
                m = torch.full((Tq * G,), NEG_INF)
                l = torch.zeros(Tq * G)
                acc = torch.zeros(Tq * G, H)
                for t in tiles:
                    kt = k[b, t * TILE:(t + 1) * TILE, kvh]
                    vt = v[b, t * TILE:(t + 1) * TILE, kvh]
                    sc = (qr @ kt.T) * H ** -0.5
                    sc = torch.where(valid[:, t * TILE:(t + 1) * TILE], sc,
                                     torch.full_like(sc, NEG_INF))
                    m_cur = torch.maximum(m, sc.amax(dim=1))
                    alpha = torch.exp(m - m_cur)
                    p = torch.exp(sc - m_cur[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vt
                    m = m_cur
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            L = torch.zeros_like(M)
            A = torch.zeros_like(parts[0][2])
            for m, l, acc in parts:
                w = torch.exp(m - M)
                L = L + w * l
                A = A + w[:, None] * acc
            res = A / torch.where(L == 0, torch.ones_like(L), L)[:, None]
            out[b, :, kvh * G:(kvh + 1) * G] = res.reshape(Tq, G, H)
    return out


def live_tile_flash_model(q, k, v, mask, causal: bool, skip: bool = True,
                          shared_max: bool = True):
    """Kernel 1's rule in PyTorch: 64-row query blocks walk the 64-key
    tiles that some row of the block attends; each tile's two key halves
    keep their own (l, acc) and, with ``shared_max``, the running max over
    the whole tile (without it, each half's own: a departure the tests
    must see). Scores and sums in f32, p rounded to v's type before PV.
    mask bool [B, Tq, Tk] or None. Returns f32 [B, Tq, N, H]."""
    B, Tq, N, H = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = N // K
    valid = torch.ones((B, Tq, Tk), dtype=torch.bool)
    if causal:
        valid &= (torch.arange(Tk)[None, :]
                  <= torch.arange(Tq)[:, None] + (Tk - Tq))[None]
    if mask is not None:
        valid &= mask
    out = torch.empty(q.shape, dtype=torch.float32)
    for b in range(B):
        for q0 in range(0, Tq, 64):
            vb = valid[b, q0:q0 + 64]
            tiles = [t for t in range(-(-Tk // TILE))
                     if not skip or bool(vb[:, t * TILE:(t + 1) * TILE].any())]
            for n in range(N):
                qb = q[b, q0:q0 + 64, n].float()
                R = qb.shape[0]
                m = [torch.full((R,), NEG_INF) for _ in range(2)]
                l = [torch.zeros(R) for _ in range(2)]
                acc = [torch.zeros(R, H) for _ in range(2)]
                for t in tiles:
                    halves = []
                    for h in range(2):
                        lo = t * TILE + 32 * h
                        hi = min(lo + 32, Tk)
                        if lo >= hi:
                            continue           # ragged tail: no keys here
                        ok = vb[:, lo:hi]
                        sc = torch.where(
                            ok, (qb @ k[b, lo:hi, n // G].float().T) * H ** -0.5,
                            torch.full((R, hi - lo), NEG_INF))
                        halves.append((h, lo, hi, ok, sc))
                    tile_max = torch.stack(
                        [sc.amax(dim=1) for *_, sc in halves]).amax(dim=0)
                    for h, lo, hi, ok, sc in halves:
                        mx = tile_max if shared_max else sc.amax(dim=1)
                        m_new = torch.maximum(m[h], mx)
                        p = torch.where(ok, torch.exp(sc - m_new[:, None]),
                                        torch.zeros_like(sc))
                        corr = torch.exp(m[h] - m_new)
                        vt = v[b, lo:hi, n // G]
                        l[h] = l[h] * corr + p.sum(dim=1)
                        acc[h] = (acc[h] * corr[:, None]
                                  + p.to(vt.dtype).float() @ vt.float())
                        m[h] = m_new
                M = torch.maximum(m[0], m[1])
                w = [torch.exp(m[h] - M) for h in range(2)]
                L = w[0] * l[0] + w[1] * l[1]
                A = w[0][:, None] * acc[0] + w[1][:, None] * acc[1]
                out[b, q0:q0 + 64, n] = A / torch.where(
                    L == 0, torch.ones_like(L), L)[:, None]
    return out


def _qkv(rng, B, Tq, S, N, K, H):
    return (rng.standard_normal((B, Tq, N, H)).astype(np.float32),
            rng.standard_normal((B, S, K, H)).astype(np.float32),
            rng.standard_normal((B, S, K, H)).astype(np.float32))


def _staircase(lengths, Tq, S):
    """Window row t of slot b attends positions <= lengths[b] + t."""
    return (np.arange(S)[None, None, :]
            <= (np.asarray(lengths)[:, None] + np.arange(Tq))[:, :, None])


# case -> (Tq, S, lengths or a mask builder)
DECODE_CASES = {
    # Slot 0 ends in split 0, slot 1 in the middle of the capacity: whole
    # splits (and, at split 256, tiles inside a live split) are void.
    "void_splits": (1, 512, [5, 200, 511 - 1]),
    # Slot 1's window row attends nothing: every tile is scanned for it,
    # and it averages V, beside normal slots.
    "fully_masked_row": (1, 384, None),
    # Tq = 8 staircases crossing split and tile boundaries.
    "tq8_staircase": (8, 512, [0, 120, 250, 504]),
}


@pytest.mark.parametrize("split", [64, 128, 256])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_scan_matches_the_jax_decode_kernel(case, split):
    Tq, S, lengths = DECODE_CASES[case]
    rng = np.random.default_rng(split + len(case))
    B = 3 if lengths is None else len(lengths)
    N, K, H = 8, 2, 32
    q, k, v = _qkv(rng, B, Tq, S, N, K, H)
    if lengths is None:
        mask = _staircase([37, 0, 300], Tq, S)
        mask[1] = False
    else:
        mask = _staircase(lengths, Tq, S)
    want = np.asarray(j_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask[:, None]), block_k=128, interpret=True))
    got = split_scan_model(_t(q), _t(k), _t(v), _t(mask), split)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # Skipping is exact: the same splits and tiles scanned without it.
    assert torch.equal(got, split_scan_model(_t(q), _t(k), _t(v), _t(mask),
                                             split, skip=False))
    if case == "fully_masked_row":
        mean_v = v[1].mean(axis=0)                   # [K, H]
        np.testing.assert_allclose(
            got.numpy()[1, 0].reshape(K, N // K, H),
            np.broadcast_to(mean_v[:, None], (K, N // K, H)), atol=ATOL)


def _flash_case(case, rng):
    """(q, k, v, mask [B, Tq, Tk] or None, causal)."""
    if case == "void_middle_tile_causal_mask":
        # Rows attend tiles 0 and 2 (and, causally, nothing past the
        # diagonal); tile 1 is void for the whole block.
        B, Tq, Tk = 2, 64, 256
        q, k, v = _qkv(rng, B, Tq, Tk, 4, 2, 32)
        mask = rng.random((B, Tq, Tk)) < 0.7
        mask[:, :, 64:128] = False
        mask[:, :, 192:] = False
        return q, k, v, mask, True
    if case == "all_zero_batch_row":
        B, Tq, Tk = 2, 64, 192
        q, k, v = _qkv(rng, B, Tq, Tk, 4, 4, 32)
        mask = rng.random((B, Tq, Tk)) < 0.5
        mask[1] = False                              # no live tile: 0 rows
        return q, k, v, mask, False
    # Two query blocks over a wider cache, causal with a diagonal offset.
    B, Tq, Tk = 1, 96, 320
    q, k, v = _qkv(rng, B, Tq, Tk, 4, 1, 32)
    return q, k, v, None, True


@pytest.mark.parametrize("case", ["void_middle_tile_causal_mask",
                                  "all_zero_batch_row",
                                  "causal_offset_two_blocks"])
def test_live_tile_skip_matches_the_jax_flash_kernel(case):
    rng = np.random.default_rng(len(case))
    q, k, v, mask, causal = _flash_case(case, rng)
    want = np.asarray(j_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask[:, None]),
        block_q=64, block_k=64, interpret=True))
    m = None if mask is None else _t(mask)
    got = live_tile_flash_model(_t(q), _t(k), _t(v), m, causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert torch.equal(got, live_tile_flash_model(_t(q), _t(k), _t(v), m,
                                                  causal, skip=False))
    if case == "all_zero_batch_row":
        assert got[1].abs().max().item() == 0.0


@pytest.mark.parametrize("case", ["void_middle_tile_causal_mask",
                                  "all_zero_batch_row",
                                  "causal_offset_two_blocks"])
def test_live_tile_skip_rounds_p_where_the_jax_flash_kernel_does(case):
    """bf16 K/V: p is rounded to bf16 before PV against the running max
    over the whole 64-key tile, in both key halves. The query is f32 (of
    bf16 values), so the JAX kernel's output stays f32 and the rounding
    point shows at 1e-5; rounding against each half's own max does not
    meet it."""
    rng = np.random.default_rng(len(case))
    q, k, v, mask, causal = _flash_case(case, rng)
    q = _t(q).bfloat16().float()
    k, v = _t(k).bfloat16(), _t(v).bfloat16()
    want = np.asarray(j_flash.flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.float().numpy(), jnp.bfloat16),
        jnp.asarray(v.float().numpy(), jnp.bfloat16), causal=causal,
        mask=None if mask is None else jnp.asarray(mask[:, None]),
        block_q=64, block_k=64, interpret=True))
    assert want.dtype == np.float32
    m = None if mask is None else _t(mask)
    got = live_tile_flash_model(q, k, v, m, causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    own = live_tile_flash_model(q, k, v, m, causal, shared_max=False)
    assert np.abs(own.numpy() - want).max() > 10 * ATOL


def long_row_flash_model(q, k, v, keep, causal: bool, skip: bool = True,
                         exp=torch.exp, round_p: bool = True):
    """Body C's rule in PyTorch: 128-row query blocks walk the 64-key tiles
    that some row of the block attends; one running (m, l, acc) a row over
    the whole tile. ``keep``: the int8 keep-mask view [B, Tq, Tk]
    (``keep_mask``'s layout) or None; a key row (row stride 0) marks the
    live tiles from its one row at the block's last query row, as the
    kernel's prepass does. ``exp`` computes p from the shifted scores;
    ``round_p`` False keeps p in f32 for PV (a departure the tests must
    see). Returns f32 [B, Tq, N, H]."""
    B, Tq, N, H = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = N // K
    off = Tk - Tq
    key = torch.arange(Tk)
    valid = torch.ones((B, Tq, Tk), dtype=torch.bool)
    if causal:
        valid &= (key[None, :] <= torch.arange(Tq)[:, None] + off)[None]
    if keep is not None:
        valid &= keep != 0
    krow = keep is not None and Tq > 1 and keep.stride(1) == 0
    out = torch.empty(q.shape, dtype=torch.float32)
    for b in range(B):
        for q0 in range(0, Tq, 128):
            rows = min(128, Tq - q0)
            vb = valid[b, q0:q0 + rows]
            if krow:
                hit = keep[b, 0] != 0
                if causal:
                    hit &= key <= q0 + rows - 1 + off
            else:
                hit = vb.any(dim=0)
            tiles = [t for t in range(-(-Tk // TILE))
                     if not skip or bool(hit[t * TILE:(t + 1) * TILE].any())]
            for n in range(N):
                qb = q[b, q0:q0 + rows, n].float()
                m = torch.full((rows,), NEG_INF)
                l = torch.zeros(rows)
                acc = torch.zeros(rows, H)
                for t in tiles:
                    lo, hi = t * TILE, min((t + 1) * TILE, Tk)
                    ok = vb[:, lo:hi]
                    sc = torch.where(
                        ok, (qb @ k[b, lo:hi, n // G].float().T) * H ** -0.5,
                        torch.full((rows, hi - lo), NEG_INF))
                    m_new = torch.maximum(m, sc.amax(dim=1))
                    p = torch.where(ok, exp(sc - m_new[:, None]),
                                    torch.zeros_like(sc))
                    corr = torch.exp(m - m_new)
                    vt = v[b, lo:hi, n // G]
                    l = l * corr + p.sum(dim=1)
                    pv = p.to(vt.dtype).float() if round_p else p
                    acc = acc * corr[:, None] + pv @ vt.float()
                    m = m_new
                out[b, q0:q0 + rows, n] = acc / torch.where(
                    l == 0, torch.ones_like(l), l)[:, None]
    return out


def _body_c_case(case, rng):
    """(q, k, v, bool mask [B, 1, Tq, Tk] or None, causal)."""
    if case == "key_row_tk150_causal":
        # Tq != Tk, keys ragged at 150: a key row per batch row.
        B, Tq, Tk = 2, 130, 150
        q, k, v = _qkv(rng, B, Tq, Tk, 4, 2, 32)
        mask = (np.arange(Tk)[None, :] < np.array([150, 90])[:, None])
        return q, k, v, mask[:, None, None], True
    if case == "dense_tk200_void_tile":
        B, Tq, Tk = 2, 128, 200
        q, k, v = _qkv(rng, B, Tq, Tk, 2, 2, 32)
        mask = rng.random((B, 1, Tq, Tk)) < 0.6
        mask[..., 64:128] = False                   # a void middle tile
        mask[0, 0, 7] = False                       # a row with no key: 0
        return q, k, v, mask, False
    if case == "key_row_all_masked_batch_row":
        B, Tq, Tk = 2, 128, 192
        q, k, v = _qkv(rng, B, Tq, Tk, 4, 4, 32)
        mask = np.ones((B, Tk), bool)
        mask[0, 100:] = False
        mask[1] = False                             # no live tile: 0 rows
        return q, k, v, mask[:, None, None], False
    # Two 128-row blocks, causal with a diagonal offset, no mask.
    B, Tq, Tk = 1, 256, 320
    q, k, v = _qkv(rng, B, Tq, Tk, 2, 1, 32)
    return q, k, v, None, True


BODY_C_CASES = ["key_row_tk150_causal", "dense_tk200_void_tile",
                "key_row_all_masked_batch_row", "causal_two_blocks"]


@pytest.mark.parametrize("case", BODY_C_CASES)
def test_body_c_rule_matches_the_jax_flash_kernel(case):
    rng = np.random.default_rng(len(case) + 7)
    q, k, v, mask, causal = _body_c_case(case, rng)
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    want = np.asarray(j_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask),
        block_q=128, block_k=64, interpret=True))
    keep = None if mask is None else t_flash.keep_mask(_t(mask), B, Tq, Tk)
    if mask is not None and mask.shape[2] == 1:
        assert keep.stride(1) == 0                  # the key-row layout
    got = long_row_flash_model(_t(q), _t(k), _t(v), keep, causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert torch.equal(got, long_row_flash_model(_t(q), _t(k), _t(v), keep,
                                                 causal, skip=False))
    if case == "key_row_all_masked_batch_row":
        assert got[1].abs().max().item() == 0.0
    if case == "dense_tk200_void_tile":
        assert got[0, 7].abs().max().item() == 0.0


def _xla_exp(x):
    """exp as the JAX kernel computes it on the CPU (XLA's f32 exp, which
    differs from torch's in the last bit of some values)."""
    return torch.from_numpy(np.asarray(jnp.exp(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("case", ["key_row_all_masked_batch_row",
                                  "causal_two_blocks"])
def test_body_c_rounds_p_where_the_jax_flash_kernel_does(case):
    """bf16 K/V, Tk a multiple of 64: p is rounded to bf16 against the
    running max over the whole 64-key tile, as the JAX kernel rounds it;
    the f32 query (of bf16 values) keeps the output f32, so the rounding
    point shows at 1e-5. The model takes XLA's exp so that p holds the
    same f32 bits on both sides: with torch's exp, one last-bit
    difference moves p across a bf16 rounding boundary in 23 of the
    16384 outputs of ``causal_two_blocks`` (9e-5 off). Without the
    rounding the model misses by more than 10 x the tolerance."""
    rng = np.random.default_rng(len(case) + 7)
    q, k, v, mask, causal = _body_c_case(case, rng)
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    assert Tk % TILE == 0
    q = _t(q).bfloat16().float()
    k, v = _t(k).bfloat16(), _t(v).bfloat16()
    want = np.asarray(j_flash.flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.float().numpy(), jnp.bfloat16),
        jnp.asarray(v.float().numpy(), jnp.bfloat16), causal=causal,
        mask=None if mask is None else jnp.asarray(mask),
        block_q=128, block_k=64, interpret=True))
    assert want.dtype == np.float32
    keep = None if mask is None else t_flash.keep_mask(_t(mask), B, Tq, Tk)
    got = long_row_flash_model(q, k, v, keep, causal, exp=_xla_exp)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    unrounded = long_row_flash_model(q, k, v, keep, causal, exp=_xla_exp,
                                     round_p=False)
    assert np.abs(unrounded.numpy() - want).max() > 10 * ATOL


#: Blocks the single-row scan's splits aim at (``RowScan::TARGET_BLOCKS``:
#: four blocks an SM of an H100's 132).
ROW_TARGET_BLOCKS = 4 * 132


def row_split_tiles(BK: int, S: int) -> int:
    """The split rule of the single-row scan (``RowScan::split_tiles``):
    64-key tiles a split for B * K = ``BK`` (slot, KV head)s over S
    positions — as many splits as keep B * K * splits within
    :data:`ROW_TARGET_BLOCKS`, at least two tiles a split."""
    ntiles = -(-S // TILE)
    want = max(1, ROW_TARGET_BLOCKS // BK)
    return max(2, -(-ntiles // want))


def row_scan_model(q, k, v, mask, skip: bool = True, warps: int = 4):
    """Kernel 2's single-row rule in PyTorch, f32. q [B, 1, N, H], k/v
    [B, S, N, H] (G = 1), mask bool [B, 1, S]. Returns [B, 1, N, H]."""
    B, _, N, H = q.shape
    S, K = k.shape[1], k.shape[2]
    assert N == K
    lt = row_split_tiles(B * K, S)
    ntiles = -(-S // TILE)
    nsplit = -(-ntiles // lt)
    kpw = TILE // warps
    out = torch.empty_like(q)
    for b in range(B):
        row = mask[b, 0]
        live = [bool(row[t * TILE:(t + 1) * TILE].any())
                for t in range(ntiles)]
        if not skip or not bool(row.any()):
            live = [True] * ntiles           # the row attends nothing
        for kvh in range(K):
            qv = q[b, 0, kvh]
            parts = []
            for s in range(nsplit):
                tiles = [t for t in range(s * lt, min(ntiles, (s + 1) * lt))
                         if live[t]]
                if not tiles:
                    continue                 # void split: never read
                m = [torch.tensor(NEG_INF)] * warps
                l = [torch.tensor(0.0)] * warps
                acc = [torch.zeros(H)] * warps
                for t in tiles:
                    for w in range(warps):
                        j = t * TILE + w * kpw + torch.arange(kpw)
                        real = j < S
                        jj = torch.clamp(j, max=S - 1)
                        sc = (k[b, jj, kvh] @ qv) * H ** -0.5
                        sc = torch.where(row[jj], sc,
                                         torch.full_like(sc, NEG_INF))
                        sc = torch.where(real, sc,
                                         torch.full_like(sc, -float("inf")))
                        m_new = torch.maximum(m[w], sc.max())
                        alpha = torch.exp(m[w] - m_new)
                        p = torch.exp(sc - m_new)
                        vt = torch.where(real[:, None], v[b, jj, kvh],
                                         torch.zeros(kpw, H))
                        l[w] = l[w] * alpha + p.sum()
                        acc[w] = acc[w] * alpha + p @ vt
                        m[w] = m_new
                M = torch.stack(m).max()
                wt = [torch.exp(x - M) for x in m]
                parts.append((M, sum(a * b for a, b in zip(wt, l)),
                              sum(a * b for a, b in zip(wt, acc))))
            Mx = torch.stack([x for x, _, _ in parts]).max()
            L = sum(torch.exp(x - Mx) * y for x, y, _ in parts)
            A = sum(torch.exp(x - Mx) * z for x, _, z in parts)
            out[b, 0, kvh] = A / (L if L != 0 else 1.0)
    return out


# case -> (B, S, K, H, lengths of each slot's key prefix, or None: slot 1
# attends nothing)
ROW_CASES = {
    # Unaligned S, few (slot, head)s: splits of 2 tiles, void splits.
    "key_rows_s300": (3, 300, 2, 32, [300, 150, 37]),
    # Slot 1's row attends nothing: every tile is scanned, V averaged.
    "fully_masked_row": (3, 384, 2, 32, None),
    # B * K = 300 (past the target): one split of every tile.
    "one_split": (100, 150, 3, 16, None),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_row_split_rule_matches_the_jax_decode_kernel(case):
    B, S, K, H, lengths = ROW_CASES[case]
    rng = np.random.default_rng(S + K)
    q, k, v = _qkv(rng, B, 1, S, K, K, H)
    if lengths is None:
        n = rng.integers(1, S + 1, B)
        n[1] = 0
    else:
        n = np.asarray(lengths)
    mask = np.arange(S)[None, None, :] < n[:, None, None]       # [B, 1, S]
    want = np.asarray(j_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask[:, None]), interpret=True))
    got = row_scan_model(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert torch.equal(got, row_scan_model(_t(q), _t(k), _t(v), _t(mask),
                                           skip=False))
    if lengths is None:
        np.testing.assert_allclose(got.numpy()[1, 0], v[1].mean(axis=0),
                                   atol=ATOL)
    if case == "one_split":
        assert row_split_tiles(B * K, S) >= -(-S // TILE)


# (B * K, S) -> tiles a split, at the shapes the single-row scan serves;
# ``tests/test_torch_cuda.py`` holds the kernels' rule to the same table.
ROW_SPLITS = {(8 * 20, 1500): 8,     # Whisper's cross read: 3 splits
              (64 * 16, 256): 4,     # gpt2_medium's step: one split
              (8 * 20, 40): 2,       # Whisper's step
              (1, 32768): 2}         # never more splits than 2 tiles'


def test_row_split_tiles_at_the_servables_shapes():
    """Splits of the single-row scan at the shapes it serves."""
    for (BK, S), lt in ROW_SPLITS.items():
        assert row_split_tiles(BK, S) == lt
