"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card each test skips (decided inside the
test, never at import). Shapes cover what ``chip_smoke.py`` does not:
ragged KV tails, causal prefill with a diagonal offset, head_dim 64,
ViT-B/16's attention (197 tokens, 12 heads of 64, no mask) and ViT-G/14's
(257 tokens, 16 heads of 104), both also as views of a packed qkv (read
in place: the call allocates its output and nothing else), head_dim 104
masked and causal, unmasked shapes whose K/V is or is not resident in
shared memory,
wide decode windows, and for the paged kernel ragged lengths, sentinel
tails, Tq 1..8 staircases and shuffled pools — and the int8-KV branch of
both decode kernels at the same shapes (int8 codes, f32 scales, q in f32
and bf16); for the live-tile skip and the split-S merge: a void KV tile
between live ones, an all-zero mask row, a window row that attends
nothing beside normal slots, whole void splits, a ragged last split, and
slab/paged bit-identity at split boundaries; a slab train's chunk over its
row cache of 576 positions; and that a decode step on the card with a
span exporter installed reads device values back no more often than one
without. This file imports no JAX, so
it runs on a machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: f32 1e-4 (the same math summed in another order), bf16 2e-2
(a couple of bf16 ulps at |x| < 4).
"""

import pytest
import torch

from ray_dynamic_batching_tpu_torch.models.decoder import (
    paged_window_mask,
    quantize_kv_rows,
)
from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,N,K,H,causal,masked", [
    (2, 70, 70, 4, 4, 64, True, False),     # ragged query and KV tiles
    (1, 33, 100, 8, 2, 128, True, False),   # causal, Tq < Tk
    (2, 48, 200, 16, 16, 64, False, True),  # gpt2 width, random mask
    (1, 16, 64, 4, 1, 128, False, True),    # one KV head, masked rows
    (4, 197, 197, 12, 12, 64, False, False),  # ViT-B/16: ragged last tile
    (4, 257, 257, 16, 16, 104, False, False),  # ViT-G/14: head_dim 104
    (2, 70, 130, 8, 2, 104, True, False),   # head_dim 104, causal, GQA
    (2, 48, 200, 16, 16, 104, False, True),  # head_dim 104, random mask
    (2, 20, 77, 4, 4, 128, False, False),   # fewer slabs than warps
    (2, 100, 600, 8, 4, 64, False, False),  # 10 resident tiles, GQA
    (1, 40, 1000, 4, 2, 64, False, False),  # K/V not resident: 64-row tiles
    (1, 64, 1024, 4, 4, 128, False, False),  # the same at head_dim 128
])
def test_flash_kernel_matches_plain(card, dtype, B, Tq, Tk, N, K, H, causal,
                                    masked):
    gen = torch.Generator(device=card).manual_seed(Tq + Tk)
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k = _rand(gen, (B, Tk, K, H), dtype, card)
    v = _rand(gen, (B, Tk, K, H), dtype, card)
    mask = None
    if masked:
        mask = torch.rand((B, 1, Tq, Tk), generator=gen, device=card) < 0.5
        mask[:, :, 0] = False          # a fully masked row gives 0
    before = fl.launches
    out = fl.flash_attention(q, k, v, causal=causal, mask=mask)
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    ref = fl.flash_attention_plain(q, k, v, fl.keep_mask(mask, B, Tq, Tk),
                                   causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    if masked:
        assert out[:, 0].float().abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,S,N,K,H", [
    (3, 1, 100, 16, 16, 64),    # gpt2 geometry, ragged S tail
    (2, 8, 256, 32, 8, 128),    # widest window: 32 rows per KV head
    (4, 5, 130, 8, 2, 128),
])
def test_decode_kernel_matches_plain(card, dtype, B, Tq, S, N, K, H):
    gen = torch.Generator(device=card).manual_seed(S + Tq)
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k = _rand(gen, (B, S, K, H), dtype, card)
    v = _rand(gen, (B, S, K, H), dtype, card)
    lengths = torch.randint(0, S - Tq, (B,), generator=gen, device=card)
    pos = torch.arange(S, device=card)
    mask = (pos[None, None, None, :]
            <= (lengths[:, None] + torch.arange(Tq, device=card))[:, None, :,
                                                                  None])
    before = dec.launches
    out = dec.decode_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    ref = dec.decode_attention_plain(q, k, v, fl.keep_mask(mask, B, Tq, S))
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def _paged(gen, B, Tq, N, K, H, P, ps, NP, dtype, dev):
    """Pools of P pages, a table of shuffled distinct pages covering each
    slot's positions <= length + Tq - 1 and the sentinel P past them."""
    q = _rand(gen, (B, Tq, N, H), dtype, dev)
    k = _rand(gen, (P, ps, K, H), dtype, dev)
    v = _rand(gen, (P, ps, K, H), dtype, dev)
    lengths = torch.randint(0, NP * ps - Tq + 1, (B,), generator=gen,
                            device=dev)
    lengths[0] = 0                            # a slot on its first page
    perm = torch.randperm(P, generator=gen, device=dev)
    table = torch.full((B, NP), P, dtype=torch.int32, device=dev)
    used = 0
    for b in range(B):
        n = -(-(int(lengths[b]) + Tq) // ps)
        table[b, :n] = perm[used: used + n].to(torch.int32)
        used += n
    return q, k, v, table, lengths.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,N,K,H,ps,NP", [
    (4, 1, 32, 8, 128, 128, 4),     # llama3_8b geometry, decode
    (3, 8, 32, 8, 128, 128, 3),     # widest window: 32 rows per KV head
    (5, 3, 16, 16, 64, 256, 2),     # MHA, head_dim 64, 256-token pages
    (2, 5, 8, 2, 64, 128, 5),
])
def test_paged_kernel_matches_plain(card, dtype, B, Tq, N, K, H, ps, NP):
    gen = torch.Generator(device=card).manual_seed(B * 100 + Tq)
    P = B * NP + 3
    q, k, v, table, lengths = _paged(gen, B, Tq, N, K, H, P, ps, NP, dtype,
                                     card)
    before = dec.paged_launches
    out = dec.paged_decode_attention(q, k, v, table, lengths)
    torch.cuda.synchronize()
    assert dec.paged_launches == before + 1
    ref = dec.paged_decode_attention_plain(q, k, v, table, lengths)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("Tq", [1, 2, 4, 6, 7, 8])
def test_paged_kernel_staircase_windows(card, Tq):
    gen = torch.Generator(device=card).manual_seed(Tq)
    q, k, v, table, lengths = _paged(gen, 6, Tq, 32, 8, 128, 30, 128, 4,
                                     torch.float32, card)
    out = dec.paged_decode_attention(q, k, v, table, lengths)
    ref = dec.paged_decode_attention_plain(q, k, v, table, lengths)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


def test_slab_and_paged_kernels_agree_on_one_run(card):
    """The shared tile body: a slab cache cut into pages in shuffled order
    gives the paged kernel the slab kernel's numbers for the same
    staircase."""
    gen = torch.Generator(device=card).manual_seed(7)
    B, Tq, S, N, K, H, ps = 3, 4, 512, 32, 8, 128, 128
    q = _rand(gen, (B, Tq, N, H), torch.bfloat16, card)
    k = _rand(gen, (B, S, K, H), torch.bfloat16, card)
    v = _rand(gen, (B, S, K, H), torch.bfloat16, card)
    lengths = torch.tensor([0, 200, S - Tq], dtype=torch.int32, device=card)
    perm = torch.randperm(B * S // ps, generator=gen, device=card)
    table = perm.reshape(B, S // ps).to(torch.int32)
    k_pool = torch.empty((B * S // ps, ps, K, H), dtype=k.dtype, device=card)
    v_pool = torch.empty_like(k_pool)
    k_pool[table.long().reshape(-1)] = k.reshape(-1, ps, K, H)
    v_pool[table.long().reshape(-1)] = v.reshape(-1, ps, K, H)
    paged = dec.paged_decode_attention(q, k_pool, v_pool, table, lengths)
    slab = dec.decode_attention(q, k, v,
                                mask=paged_window_mask(lengths, S, Tq))
    assert torch.equal(paged, slab)


def _int8(gen, shape, dev):
    """int8 codes and f32 scales of random rows (the cache's write rule)."""
    return quantize_kv_rows(torch.randn(shape, generator=gen, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,S,N,K,H", [
    (3, 1, 100, 16, 16, 64),    # gpt2 geometry, ragged S tail
    (2, 8, 256, 32, 8, 128),    # widest window: 32 rows per KV head
    (4, 5, 130, 8, 2, 128),
])
def test_decode_kernel_int8_matches_plain(card, dtype, B, Tq, S, N, K, H):
    gen = torch.Generator(device=card).manual_seed(S + Tq + 1)
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k, ks = _int8(gen, (B, S, K, H), card)
    v, vs = _int8(gen, (B, S, K, H), card)
    lengths = torch.randint(0, S - Tq, (B,), generator=gen, device=card)
    pos = torch.arange(S, device=card)
    mask = (pos[None, None, None, :]
            <= (lengths[:, None] + torch.arange(Tq, device=card))[:, None, :,
                                                                  None])
    mask[0] = False                     # no attended key: averages scaled V
    before = dec.int8_launches, dec.launches
    out = dec.decode_attention(q, k, v, mask=mask, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (dec.int8_launches, dec.launches) == (before[0] + 1, before[1])
    ref = dec.decode_attention_plain(q, k, v, fl.keep_mask(mask, B, Tq, S),
                                     k_scale=ks, v_scale=vs)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def _paged_int8(gen, B, Tq, N, K, H, P, ps, NP, dtype, dev):
    q, k, v, table, lengths = _paged(gen, B, Tq, N, K, H, P, ps, NP, dtype,
                                     dev)
    k, ks = quantize_kv_rows(k.float())
    v, vs = quantize_kv_rows(v.float())
    return q, k, v, ks, vs, table, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,N,K,H,ps,NP", [
    (4, 1, 32, 8, 128, 128, 4),     # llama3_8b geometry, decode
    (3, 8, 32, 8, 128, 128, 3),     # widest window: 32 rows per KV head
    (5, 3, 16, 16, 64, 256, 2),     # MHA, head_dim 64, 256-token pages
    (2, 5, 8, 2, 64, 128, 5),
])
def test_paged_kernel_int8_matches_plain(card, dtype, B, Tq, N, K, H, ps,
                                         NP):
    gen = torch.Generator(device=card).manual_seed(B * 100 + Tq + 1)
    q, k, v, ks, vs, table, lengths = _paged_int8(
        gen, B, Tq, N, K, H, B * NP + 3, ps, NP, dtype, card)
    before = dec.paged_int8_launches, dec.paged_launches
    out = dec.paged_decode_attention(q, k, v, table, lengths, k_scale=ks,
                                     v_scale=vs)
    torch.cuda.synchronize()
    assert (dec.paged_int8_launches, dec.paged_launches) == (
        before[0] + 1, before[1])
    ref = dec.paged_decode_attention_plain(q, k, v, table, lengths,
                                           k_scale=ks, v_scale=vs)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_slab_and_paged_int8_kernels_agree_on_one_run(card):
    """The shared tile body with int8 codes: a slab cache and its scales
    cut into shuffled pages give bit-identical outputs through both
    kernels."""
    gen = torch.Generator(device=card).manual_seed(8)
    B, Tq, S, N, K, H, ps = 3, 4, 512, 32, 8, 128, 128
    q = _rand(gen, (B, Tq, N, H), torch.bfloat16, card)
    k, ks = _int8(gen, (B, S, K, H), card)
    v, vs = _int8(gen, (B, S, K, H), card)
    lengths = torch.tensor([0, 200, S - Tq], dtype=torch.int32, device=card)
    perm = torch.randperm(B * S // ps, generator=gen, device=card)
    table = perm.reshape(B, S // ps).to(torch.int32)
    flat = table.long().reshape(-1)

    def pages(x):
        out = torch.empty((B * S // ps, ps) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=card)
        out[flat] = x.reshape((-1, ps) + tuple(x.shape[2:]))
        return out

    paged = dec.paged_decode_attention(q, pages(k), pages(v), table, lengths,
                                       k_scale=pages(ks), v_scale=pages(vs))
    slab = dec.decode_attention(q, k, v,
                                mask=paged_window_mask(lengths, S, Tq),
                                k_scale=ks, v_scale=vs)
    assert torch.equal(paged, slab)


def test_kernels_refuse_what_they_do_not_take(card):
    for H in (100, 136):    # not a multiple of 8; past 128
        q = torch.zeros((1, 16, 4, H), device=card)
        with pytest.raises(ValueError, match="head_dim"):
            fl.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        h = torch.zeros((1, 1, 4, 64), device=card, dtype=torch.float16)
        dec.decode_attention(h, h, h)
    pool = torch.zeros((4, 128, 2, 64), device=card)
    table = torch.zeros((1, 2), dtype=torch.int32, device=card)
    lens = torch.zeros((1,), dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="dtype"):
        dec.paged_decode_attention(h, pool.half(), pool.half(), table, lens)
    # int8 codes without scales, and scales on another device.
    q1 = torch.zeros((1, 1, 4, 64), device=card)
    codes = pool.to(torch.int8)
    with pytest.raises(TypeError, match="int8 codes with scales"):
        dec.paged_decode_attention(q1, codes, codes, table, lens)
    scales = torch.ones((4, 128, 2))
    with pytest.raises(ValueError, match="another device"):
        dec.paged_decode_attention(q1, codes, codes, table, lens,
                                   k_scale=scales, v_scale=scales)


def test_decode_kernels_refuse_a_small_merge_workspace(card):
    """The launch checks the split merge's workspace and counters against
    the split length it was built with: too small is refused, never
    written past; the exact size launches."""
    from ray_dynamic_batching_tpu_torch.ops import _build

    B, Tq, S, N, K, H = 1, 1, 256, 4, 2, 64
    q = torch.zeros((B, Tq, N, H), device=card)
    k = torch.zeros((B, S, K, H), device=card)
    pool = torch.zeros((2, 128, K, H), device=card)
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=card)
    lens = torch.tensor([200], dtype=torch.int32, device=card)
    out = torch.empty_like(q)
    need = B * K * (S // dec.SPLIT) * Tq * (N // K) * (H + 2)
    cnt = torch.zeros((B * K,), dtype=torch.int32, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    slab = _build.load("decode_attention")
    paged = _build.load("paged_decode_attention")
    for n_ws, n_cnt, ok in [(need - 1, B * K, False), (need, B * K - 1, False),
                            (need, B * K, True)]:
        ws = torch.zeros((need,), device=card)
        rc = slab.rdb_decode_attention(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), None, None, None,
            out.data_ptr(), B, Tq, S, N, K, H, 0.125, 0, 0, ws.data_ptr(),
            n_ws, cnt.data_ptr(), n_cnt, stream)
        assert (rc == 0) == ok
        rc = paged.rdb_paged_decode_attention(
            q.data_ptr(), pool.data_ptr(), pool.data_ptr(), None, None,
            table.data_ptr(), lens.data_ptr(), out.data_ptr(), B, Tq, N, K,
            H, 2, 128, 2, 0.125, 0, 0, ws.data_ptr(), n_ws, cnt.data_ptr(),
            n_cnt, stream)
        assert (rc == 0) == ok
    torch.cuda.synchronize()
    assert int(cnt.abs().sum().item()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,N,H", [(4, 197, 12, 64), (4, 257, 16, 104)])
def test_flash_kernel_reads_packed_qkv_views(card, dtype, B, T, N, H):
    """q/k/v as ``models/vit.py`` makes them (views of one [B, T, 3 N H]
    projection) give the plain version's result and the kernel's own
    result on contiguous copies, and the call allocates only its output:
    no copy of q, k or v, not even a transient one."""
    gen = torch.Generator(device=card).manual_seed(T + H)
    qkv = _rand(gen, (B, T, 3 * N * H), dtype, card)
    q, k, v = qkv.view(B, T, 3, N, H).unbind(2)
    fl.flash_attention(q, k, v)          # the build and the first launch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    out = fl.flash_attention(q, k, v)
    torch.cuda.synchronize()
    nbytes = out.numel() * out.element_size()
    assert torch.cuda.memory_allocated(card) - base == nbytes
    assert torch.cuda.max_memory_allocated(card) - base == nbytes
    assert out.is_contiguous() and out.shape == (B, T, N, H)
    ref = fl.flash_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    same = fl.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, same)


# --- the redesigned kernels: live-tile skipping and split-S ----------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_skips_void_tiles_exactly(card, dtype):
    """A void KV tile between live ones (the block walks tiles 0 and 2 of
    4) and a batch row whose mask is all zero (no live tile: 0 rows)."""
    gen = torch.Generator(device=card).manual_seed(41)
    B, Tq, Tk, N, K, H = 2, 64, 256, 8, 2, 128
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k = _rand(gen, (B, Tk, K, H), dtype, card)
    v = _rand(gen, (B, Tk, K, H), dtype, card)
    mask = torch.rand((B, 1, Tq, Tk), generator=gen, device=card) < 0.6
    mask[..., 64:128] = False
    mask[..., 192:] = False
    mask[1] = False
    out = fl.flash_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    ref = fl.flash_attention_plain(q, k, v, fl.keep_mask(mask, B, Tq, Tk))
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert out[1].float().abs().max().item() == 0.0


def _slab_window(lengths, Tq, S, dev):
    pos = torch.arange(S, device=dev)
    return (pos[None, None, None, :]
            <= (lengths[:, None] + torch.arange(Tq, device=dev))[:, None, :,
                                                                 None])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [1, 8])
def test_decode_kernel_row_with_no_key_beside_normal_slots(card, Tq, dtype,
                                                           int8):
    """One slot's window attends nothing (its rows average V, so every
    tile of that slot is read) beside slots whose later splits are void."""
    gen = torch.Generator(device=card).manual_seed(Tq + 2 * int8)
    B, S, N, K, H = 4, 512, 32, 8, 128
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    if int8:
        k, ks = _int8(gen, (B, S, K, H), card)
        v, vs = _int8(gen, (B, S, K, H), card)
    else:
        k = _rand(gen, (B, S, K, H), dtype, card)
        v = _rand(gen, (B, S, K, H), dtype, card)
        ks = vs = None
    lengths = torch.tensor([3, 140, 0, 300], device=card)
    mask = _slab_window(lengths, Tq, S, card)
    mask[2] = False
    out = dec.decode_attention(q, k, v, mask=mask, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ref = dec.decode_attention_plain(q, k, v, fl.keep_mask(mask, B, Tq, S),
                                     k_scale=ks, v_scale=vs)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lengths", [
    (512, [0, 5, 127, 128]),      # all but the first split void
    (200, [150, 199 - 3, 60, 10]),  # S past the last full split, ragged tile
    (300, [290, 256, 100, 3]),    # three splits, the last of 44 positions
])
def test_decode_kernel_void_and_ragged_splits(card, dtype, S, lengths):
    gen = torch.Generator(device=card).manual_seed(S)
    B, Tq, N, K, H = 4, 4, 32, 8, 128
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k = _rand(gen, (B, S, K, H), dtype, card)
    v = _rand(gen, (B, S, K, H), dtype, card)
    lens = torch.tensor(lengths, device=card).clamp(max=S - Tq)
    mask = _slab_window(lens, Tq, S, card)
    before = dec.launches
    out = dec.decode_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    ref = dec.decode_attention_plain(q, k, v, fl.keep_mask(mask, B, Tq, S))
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    # The merge leaves its arrival counters at zero for the next launch.
    _, counters = dec._workspaces[q.device.index]
    assert int(counters.abs().sum().item()) == 0


@pytest.mark.parametrize("int8", [False, True])
def test_slab_and_paged_agree_at_split_boundaries(card, int8):
    """Bit-identity of kernels 2 and 3 where windows end on, just before
    and just after a split boundary (128 positions) and a tile boundary."""
    gen = torch.Generator(device=card).manual_seed(9 + int8)
    B, Tq, S, N, K, H, ps = 6, 4, 512, 32, 8, 128, 128
    q = _rand(gen, (B, Tq, N, H), torch.bfloat16, card)
    if int8:
        k, ks = _int8(gen, (B, S, K, H), card)
        v, vs = _int8(gen, (B, S, K, H), card)
    else:
        k = _rand(gen, (B, S, K, H), torch.bfloat16, card)
        v = _rand(gen, (B, S, K, H), torch.bfloat16, card)
        ks = vs = None
    # Last attended positions 127, 128, 124 + 3, 255, 63 + 3, 383 + 3.
    lengths = torch.tensor([124, 125, 121, 252, 60, 380], dtype=torch.int32,
                           device=card)
    perm = torch.randperm(B * S // ps, generator=gen, device=card)
    table = perm.reshape(B, S // ps).to(torch.int32)
    flat = table.long().reshape(-1)

    def pages(x):
        out = torch.empty((B * S // ps, ps) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=card)
        out[flat] = x.reshape((-1, ps) + tuple(x.shape[2:]))
        return out

    paged = dec.paged_decode_attention(
        q, pages(k), pages(v), table, lengths,
        k_scale=None if ks is None else pages(ks),
        v_scale=None if vs is None else pages(vs))
    slab = dec.decode_attention(q, k, v,
                                mask=paged_window_mask(lengths, S, Tq),
                                k_scale=ks, v_scale=vs)
    assert torch.equal(paged, slab)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start", [0, 64, 192, 448])
def test_flash_kernel_on_a_slab_train_chunk(card, dtype, start):
    """A slab train's chunk as the model calls flash: q [1, 64, 32, 128]
    over its row cache of ``_long_row_cap(64)`` = 576 positions (max_len
    512 in whole chunks plus a spare one), each row at global position p
    attending [0, p] — the live tiles grow with ``start``, the tail past
    the chunk is void."""
    gen = torch.Generator(device=card).manual_seed(start)
    C, S = 64, 576
    q = _rand(gen, (1, C, 32, 128), dtype, card)
    k = _rand(gen, (1, S, 8, 128), dtype, card)
    v = _rand(gen, (1, S, 8, 128), dtype, card)
    positions = start + torch.arange(C, device=card)
    mask = (torch.arange(S, device=card)[None, None, None, :]
            <= positions[None, None, :, None])
    keep = fl.keep_mask(mask, 1, C, S)
    before = fl.launches
    out = fl.flash_attention(q, k, v, mask=keep[:, None])
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    ref = fl.flash_attention_plain(q, k, v, keep)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_kernels_launch_from_two_threads_at_different_shapes(card):
    """Two engines of different KV capacities (two length buckets, each
    on its own thread) launch the same kernels at shapes that need
    different shared-memory limits: no launch is refused and every
    result equals the plain version's."""
    import threading

    dtype = torch.bfloat16
    inputs = {}
    for S in (256, 512):
        gen = torch.Generator(device=card).manual_seed(S)
        q = _rand(gen, (16, 1, 32, 128), dtype, card)
        k = _rand(gen, (16, S, 8, 128), dtype, card)
        v = _rand(gen, (16, S, 8, 128), dtype, card)
        mask = torch.rand((16, 1, 1, S), generator=gen, device=card) < 0.9
        qf = _rand(gen, (2, 64, 32, 128), dtype, card)
        kf = _rand(gen, (2, S, 8, 128), dtype, card)
        vf = _rand(gen, (2, S, 8, 128), dtype, card)
        # The vision body at head_dim 104: 257 tokens (the 256 thread) or
        # 130 (the 512 one) need different shared-memory limits too.
        T = 257 if S == 256 else 130
        qkv = _rand(gen, (2, T, 3 * 16 * 104), dtype, card)
        inputs[S] = (q, k, v, mask, qf, kf, vf,
                     qkv.view(2, T, 3, 16, 104).unbind(2))
    errors, worst = [], {}

    def run(S):
        q, k, v, mask, qf, kf, vf, qkv = inputs[S]
        try:
            for _ in range(200):
                out = dec.decode_attention(q, k, v, mask=mask)
                out_f = fl.flash_attention(qf, kf, vf, causal=True)
                out_v = fl.flash_attention(*qkv)
            torch.cuda.synchronize()
            ref = dec.decode_attention_plain(q, k, v,
                                             fl.keep_mask(mask, 16, 1, S))
            ref_f = fl.flash_attention_plain(qf, kf, vf, None, causal=True)
            ref_v = fl.flash_attention_plain(*qkv)
            worst[S] = max((out.float() - ref.float()).abs().max().item(),
                           (out_f.float() - ref_f.float()).abs().max().item(),
                           (out_v.float() - ref_v.float()).abs().max().item())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"S={S}: {e}")

    threads = [threading.Thread(target=run, args=(S,)) for S in inputs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert all(w <= TOL[dtype] for w in worst.values()), worst


_HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
               "__float__")


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_traced_decode_step_adds_no_host_fetch(card, paged, monkeypatch):
    """The engine's spans are retroactive: a decode step on the card with
    an exporter installed reads device values to the host exactly as one
    without does (each tensor method that brings a value back counted),
    and records one ``decode.turn``."""
    import dataclasses

    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        TINY_LM,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    # llama_tiny widened to heads of 64, a width the decode kernels take.
    cfg = dataclasses.replace(TINY_LM, d_model=256)
    model = CausalLM(cfg, name="llama_tiny", dtype=torch.bfloat16,
                     device=card, seed=0)
    assert cfg.head_dim == 64
    q = RequestQueue("t")
    engine = DecodeEngine(model, q, num_slots=4, max_len=128,
                          prompt_buckets=[16], device=card, paged=paged)
    for i in range(3):
        q.add_request(Request(model="t", slo_ms=6e4, trace_ctx={
            "trace_id": f"{i + 1:032x}", "parent_span_id": i + 1},
            payload={"tokens": list(range(1, 10 + i)),
                     "max_new_tokens": 40}))
    engine._admit()
    engine._drain_prefill()
    engine._step(horizon=2)            # builds and warms the kernels

    def reads():
        calls = []
        for name in _HOST_READS:
            orig = getattr(torch.Tensor, name)

            def wrapped(self, *a, _orig=orig, _name=name, **kw):
                calls.append(_name)
                return _orig(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, wrapped)
        try:
            engine._step(horizon=2)
        finally:
            monkeypatch.undo()
        return calls

    plain = reads()
    collector = ChromeTraceCollector()
    tracer().set_exporter(collector.export)
    try:
        traced = reads()
    finally:
        tracer().reset()
    assert traced == plain == ["cpu", "numpy"]
    assert [s.name for s in collector.spans] == ["decode.turn"]
    assert collector.spans[0].attributes["active"] == 3
