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
without; and the captured programs (``ops/graphs.py``): graphed and
eager engines serving identical tokens with equal launch counts on every
arm, a failed capture raising, the merge scratch refusing to grow under
capture, a graph replaying after other shapes moved the kernel's
shared-memory limit, and a released engine giving its pool back; a
two-shard front door admitting within its bound in front of a 2-layer
llama3_8b deployment; and KV reuse's new inputs: flash on a paged chunk
past a borrowed prefix and on a session chunk from an unaligned base,
the paged kernel over tables sharing their head pages, and a spill
reload and a parcel import writing the pool in place; the serving
surface: a bf16 checkpoint round trip on the card, `/v1/completions` on
llama_tiny through kernels 1 and 2 against the handle, and the native
library built by g++ on the card machine; training: kernel 1's backward
(``csrc/flash_attention_bwd.cu`` behind ``FlashAttentionFn``) against
autograd of the plain version at llama3_8b's training shape, GQA (G 4
and 8), Tq < Tk (a 64-row chunk over 576 keys), a fully masked row, a
key tile voided mid-row, head_dims 16 and 104, and bit-identical
gradients from two calls; the bare launch refusing an input that
requires grad, and a 2-layer llama3_8b train step's loss and gradients,
kernel route against plain route; tensor parallelism on gloo ranks
sharing the card: a tp-2 engine's tokens (and with a divergent draft, its
acceptance) against the one-card engine's, kernels 2 and 4 launched,
and a parcel scattered into a tp-2 pool and gathered back
bit-identical to the one-card export; kernel 1's body C (TMA + wgmma)
at the servables' long rows and at Tk 1500, 257 and 150 on key-row and
padded dense masks (a fully masked row gives 0), the body each shape
lands on (and the launch rules kernels 1-3's libraries export), kernels
2-3's single-row scan against the plain version and
bit-identical slab vs paged at G = 1 over 1500 positions, and the
16-row scan on the strided mask layouts. This file imports no JAX, so
it runs on a machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: f32 1e-4 (the same math summed in another order), bf16 2e-2
(a couple of bf16 ulps at |x| < 4).
"""

import ctypes

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


#: Head dims the decode kernels take besides 64 and 128: every multiple
#: of 16 up to 128 (16 is every tiny decoder's, and Whisper-tiny's and
#: DistilBERT-tiny's), riding the 64- and 128-wide bodies zero-padded.
NEW_HEAD_DIMS = [16, 32, 48, 80, 96, 112]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", NEW_HEAD_DIMS)
def test_decode_kernels_at_every_head_dim(card, H, dtype, int8):
    """Kernels 2 and 3 at a padded head dim against their plain versions
    (two splits, a ragged tail, a row attending nothing, GQA 4:2), and
    kernel 3 on the slab cut into shuffled pages bit-identical to
    kernel 2 on the same staircase."""
    gen = torch.Generator(device=card).manual_seed(H + 2 * int8)
    B, Tq, S, N, K, ps = 3, 3, 256, 4, 2, 128
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    if int8:
        k, ks = _int8(gen, (B, S, K, H), card)
        v, vs = _int8(gen, (B, S, K, H), card)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k = _rand(gen, (B, S, K, H), dtype, card)
        v = _rand(gen, (B, S, K, H), dtype, card)
        scales = {}
    lengths = torch.tensor([0, 150, S - Tq], dtype=torch.int32, device=card)
    mask = paged_window_mask(lengths, S, Tq).clone()
    mask[0, :, 1] = False               # window row 1 of slot 0: no key
    slab = dec.decode_attention(q, k, v, mask=mask, **scales)
    ref = dec.decode_attention_plain(q, k, v, fl.keep_mask(mask, B, Tq, S),
                                     **scales)
    assert (slab.float() - ref.float()).abs().max().item() <= TOL[dtype]

    perm = torch.randperm(B * S // ps, generator=gen, device=card)
    table = perm.reshape(B, S // ps).to(torch.int32)

    def pages(x):
        out = torch.empty((B * S // ps, ps) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=card)
        out[table.long().reshape(-1)] = x.reshape((-1, ps)
                                                  + tuple(x.shape[2:]))
        return out

    pscales = {n: pages(t) for n, t in scales.items()}
    before = (dec.paged_int8_launches if int8 else dec.paged_launches)
    paged = dec.paged_decode_attention(q, pages(k), pages(v), table,
                                       lengths, **pscales)
    torch.cuda.synchronize()
    assert (dec.paged_int8_launches if int8
            else dec.paged_launches) == before + 1
    pref = dec.paged_decode_attention_plain(q, pages(k), pages(v), table,
                                            lengths, **pscales)
    assert (paged.float() - pref.float()).abs().max().item() <= TOL[dtype]
    same = dec.decode_attention(q, k, v,
                                mask=paged_window_mask(lengths, S, Tq),
                                **scales)
    assert torch.equal(paged, same)


def test_decode_kernels_refuse_other_head_dims(card):
    """Head dims off the rule raise in the wrapper (and the route sends
    them to the plain version before launch)."""
    from ray_dynamic_batching_tpu_torch.ops import attention as att

    for H in (8, 24, 136):
        q = torch.zeros((1, 1, 4, H), device=card)
        with pytest.raises(ValueError, match="head_dim"):
            dec.decode_attention(q, q, q)
        assert att.route(q.shape, q.shape, causal=False) == "plain"
        before = att.plain_launches
        out = att.dot_product_attention(q, q, q)
        assert att.plain_launches == before + 1 and out.shape == q.shape


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
        body = ctypes.c_int(-1)
        rc = slab.rdb_decode_attention(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), None, None, None, 0, 0,
            out.data_ptr(), B, Tq, S, N, K, H, 0.125, 0, 0, ws.data_ptr(),
            n_ws, cnt.data_ptr(), n_cnt, stream, ctypes.byref(body))
        assert (rc == 0) == ok
        rc = paged.rdb_paged_decode_attention(
            q.data_ptr(), pool.data_ptr(), pool.data_ptr(), None, None,
            table.data_ptr(), lens.data_ptr(), out.data_ptr(), B, Tq, N, K,
            H, 2, 128, 2, 0.125, 0, 0, ws.data_ptr(), n_ws, cnt.data_ptr(),
            n_cnt, stream, ctypes.byref(body))
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


# --- captured programs (ops/graphs.py) --------------------------------------
def _tiny_lm(card, kv_dtype=None):
    """llama_tiny widened to heads of 64 (a width the decode kernels
    take), f32, 2 layers."""
    import dataclasses

    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        TINY_LM,
        CausalLM,
    )

    cfg = dataclasses.replace(TINY_LM, d_model=256)
    return CausalLM(cfg, name="llama_tiny", dtype=torch.float32,
                    device=card, seed=0, kv_dtype=kv_dtype)


# The five engine arms: (kv dtype, engine knobs).
_ARMS = {
    "slab": (None, {}),
    "paged": (None, {"paged": True}),
    "int8": (torch.int8, {}),
    "int8_paged": (torch.int8, {"paged": True}),
    "slab_chunked": (None, {"chunked_prefill": True}),
}


def _serve_arm(model, knobs, eager: bool):
    """Warm an engine and serve six greedy prompts (two past the largest
    bucket: the long fill or multi-chunk trains) and one penalised one;
    returns (token streams, launch counts while serving, engine)."""
    import contextlib

    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import attention, graphs

    ctx = graphs.disable_capture() if eager else contextlib.nullcontext()
    with ctx:
        q = RequestQueue("t")
        engine = DecodeEngine(model, q, num_slots=4, max_len=256,
                              prompt_buckets=[16, 32], decode_horizon=4,
                              default_max_new_tokens=12, device=model.device,
                              **knobs)
        engine.warmup()
    gen = torch.Generator().manual_seed(7)
    reqs = []
    for i, n in enumerate([5, 12, 30, 70, 17, 100, 9]):
        payload = {"tokens": torch.randint(1, 512, (n,), generator=gen
                                           ).tolist()}
        if i == 6:
            payload.update(presence_penalty=0.5, frequency_penalty=0.3)
        reqs.append(Request(model="t", payload=payload, slo_ms=6e4))
        q.add_request(reqs[-1])
    attention.reset_counts()
    engine.run_until_idle(timeout_s=120)
    torch.cuda.synchronize()
    counts = (fl.launches, dec.launches, dec.int8_launches,
              dec.paged_launches, dec.paged_int8_launches,
              attention.plain_launches)
    return [r.future.result(5).tokens for r in reqs], counts, engine


@pytest.mark.parametrize("arm", list(_ARMS))
def test_graphed_engine_equals_eager(card, arm):
    """Each arm serves the same requests with its programs replayed as
    CUDA graphs and run eagerly: identical greedy tokens (f32), the same
    launch counts, and the graphed engine captured every program it
    dispatched during warmup (nothing after it)."""
    kv_dtype, knobs = _ARMS[arm]
    model = _tiny_lm(card, kv_dtype)
    eager, eager_counts, e_eng = _serve_arm(model, knobs, eager=True)
    graphed, graphed_counts, g_eng = _serve_arm(model, knobs, eager=False)
    assert graphed == eager
    assert graphed_counts == eager_counts
    assert e_eng.capture_stats()["captures"] == 0
    stats = g_eng.capture_stats()
    assert stats["captures"] == sum(stats["graphs"].values()) > 0
    assert set(stats["graphs"]) >= {"decode_step", "zero_counts"}


def test_failed_capture_raises_without_fallback(card):
    """A program whose body cannot be captured (it reads a device value
    on the host) raises CaptureError, on its first call and again on the
    next, as does every other program of its set: nothing runs it eagerly
    instead. A sealed set raises on a key it never captured."""
    from ray_dynamic_batching_tpu_torch.ops import graphs

    gs = graphs.GraphSet(card)
    prog = gs.program("bad", lambda x: x * float(x.sum().item()))
    x = torch.ones((4,), device=card)
    with pytest.raises(graphs.CaptureError, match="capture of key"):
        prog(x)
    with pytest.raises(graphs.CaptureError, match="earlier capture"):
        prog(x)
    with pytest.raises(graphs.CaptureError, match="earlier capture"):
        gs.program("other", lambda x: x + 1)(x)
    fresh = graphs.GraphSet(card)
    good = fresh.program("good", lambda x: x * 2)
    assert good(x).tolist() == [2.0] * 4        # eager first call
    assert good(x + 1).tolist() == [4.0] * 4    # a replay
    fresh.seal()
    with pytest.raises(graphs.CaptureError, match="after warmup"):
        good(torch.ones((8,), device=card))


def test_reserved_workspace_refuses_a_larger_launch_under_capture(card):
    """reserve() sizes the merge scratch; a launch under capture that
    needs more raises instead of reallocating memory the graph would
    bake in. Outside capture the same launch grows the scratch."""
    card = torch.device("cuda", torch.cuda.current_device())
    saved = dec._workspaces.pop(card.index, None)
    try:
        ws, cnt = dec.reserve(card, B=1, K=2, S=128, R=2, H=64)
        gen = torch.Generator(device=card).manual_seed(3)
        q = _rand(gen, (2, 1, 4, 64), torch.float32, card)
        k = _rand(gen, (2, 512, 2, 64), torch.float32, card)
        dec.decode_attention(q[:1], k[:1, :128], k[:1, :128])  # fits
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(card)
        stream.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                with pytest.raises(RuntimeError, match="reserve"):
                    dec.decode_attention(q, k, k)
            finally:
                graph.capture_end()
        assert dec._workspaces[card.index][0] is ws     # not reallocated
        out = dec.decode_attention(q, k, k)             # eager: grows
        ref = dec.decode_attention_plain(q, k, k)
        assert (out - ref).abs().max().item() <= TOL[torch.float32]
        assert dec._workspaces[card.index][0].numel() > ws.numel()
    finally:
        if saved is not None:
            dec._workspaces[card.index] = saved


def test_graph_replays_after_other_shapes_set_the_smem_limit(card):
    """A decode launch captured at one shape replays correctly after
    another thread launched the same kernel at a shape needing more
    shared memory and then at one needing less (the limit a launch sets
    is never lowered)."""
    import threading

    from ray_dynamic_batching_tpu_torch.ops import graphs

    gen = torch.Generator(device=card).manual_seed(5)
    dtype = torch.bfloat16

    def inputs(B, Tq, S, N):
        q = _rand(gen, (B, Tq, N, 128), dtype, card)
        k = _rand(gen, (B, S, 8, 128), dtype, card)
        v = _rand(gen, (B, S, 8, 128), dtype, card)
        return q, k, v

    mid = inputs(4, 4, 512, 32)      # 16 window rows a KV head
    gs = graphs.GraphSet(card)
    prog = gs.program("decode", lambda q, k, v: dec.decode_attention(
        q, k, v))
    prog(*mid)                       # eager, then captured
    others = [inputs(2, 8, 256, 32), inputs(2, 1, 256, 8)]  # 32, 1 rows

    def launch_others():
        for x in others:
            dec.decode_attention(*x)
        torch.cuda.synchronize()

    t = threading.Thread(target=launch_others)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    out = prog(*mid).clone()         # a replay
    ref = dec.decode_attention_plain(*mid)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_released_engine_returns_its_pool(card):
    """An engine's graphs live in its own pool; release_buffers() drops
    them with the cache, and the card's allocated memory returns to its
    value before the engine was built."""
    import gc

    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue

    def held() -> int:
        # cuBLAS keeps a workspace per (handle, stream) it ran a GEMM on,
        # the engines' capture streams among them: dropped first.
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(card)

    model = _tiny_lm(card)
    DecodeEngine(model, RequestQueue("w"), num_slots=4, max_len=256,
                 prompt_buckets=[16, 32], device=card).warmup()  # builds
    before = held()
    engine = DecodeEngine(model, RequestQueue("t"), num_slots=4, max_len=256,
                          prompt_buckets=[16, 32], device=card)
    engine.warmup()
    assert engine.capture_stats()["captures"] > 0
    assert held() > before
    engine.release_buffers()
    del engine
    assert held() == before


# --- the sharded front door (serve/frontdoor.py) ----------------------------
def test_front_door_shards_admit_within_the_bound(card):
    """Two ``HTTPProxy``s, each with one shard of one ``FrontDoor(n_shards=
    2)`` as its admission, in front of a 2-layer llama3_8b slab deployment
    (bf16, graphed): 48 requests over 2 s, alternating proxies, against a
    global budget of 6 rps with a burst of 6. Every admitted request is
    answered 200 with its tokens, every reject is a 429 with
    ``Retry-After``; the fleet admits no more than ``rate T + burst +
    (N - 1) rate staleness + N`` with the staleness two gossip intervals;
    ``stop()`` ends the gossip thread."""
    import dataclasses
    import http.client
    import json
    import threading
    import time

    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.frontdoor import FrontDoor
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.serve.proxy import (
        HTTPProxy,
        ProxyRouter,
    )
    from ray_dynamic_batching_tpu_torch.serve.router import Router

    model = CausalLM(dataclasses.replace(LLAMA3_8B, num_layers=2),
                     "llama3_8b", dtype=torch.bfloat16, device=card, seed=0)
    dep = LLMDeployment("llama3_8b", model=model, num_slots=8, max_len=128,
                        prompt_buckets=[32], default_max_new_tokens=8,
                        device=card)
    replica = dep.make_replica("llama3_8b#fd", DeploymentConfig(
        name="llama3_8b", max_ongoing_requests=4096))
    rate, burst, n, gap_s = 6.0, 6.0, 48, 2.0 / 48
    fd = FrontDoor(n_shards=2, gossip_interval_s=0.2)
    fd.configure("llama3_8b", rate_rps=rate, burst=burst)
    routes = ProxyRouter()
    proxies, router = [], None
    results = [None] * n
    gen = torch.Generator().manual_seed(3)
    bodies = [{"tokens": torch.randint(1, 1000, (20,), generator=gen
                                       ).tolist(), "max_new_tokens": 8}
              for _ in range(n)]

    def send(i, proxy):
        body = bodies[i]
        conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=300)
        try:
            conn.request("POST", "/api/llama3_8b", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            results[i] = (resp.status, resp.getheader("Retry-After"),
                          resp.read().decode())
        finally:
            conn.close()

    senders = []
    try:
        replica.start()
        router = Router("llama3_8b", replicas=[replica],
                        max_assign_timeout_s=30.0)
        routes.set_route("/api/llama3_8b",
                         DeploymentHandle(router, default_slo_ms=300_000.0))
        proxies = [HTTPProxy(routes, port=0, admission=fd.shards[sid],
                             shard_id=sid).start()
                   for sid in sorted(fd.shards)]
        fd.start()
        for i in range(n):
            senders.append(threading.Thread(
                target=send, args=(i, proxies[i % 2]), daemon=True))
            senders[-1].start()
            time.sleep(gap_s)
        for t in senders:
            t.join(300)
        horizon_s = time.monotonic() - fd.budget("llama3_8b").t0
    finally:
        fd.stop()
        for p in proxies:
            p.stop()
        if router is not None:
            router.close()
        replica.stop(drain=False)
    assert fd._thread is None
    assert not [t for t in threading.enumerate()
                if t.name == "frontdoor-gossip" and t.is_alive()]
    codes = [r[0] for r in results]
    admitted = fd.true_admitted("llama3_8b")
    assert set(codes) == {200, 429}
    assert codes.count(200) == admitted
    for code, retry_after, body in results:
        if code == 200:
            assert len(json.loads(body)["result"]["tokens"]) == 8
        else:
            assert retry_after
    assert admitted <= rate * horizon_s + burst + rate * 0.2 * 2 + 2
    assert {s.admitted for s in fd.shards.values()} != {0}


# --- KV reuse: the kernels' new inputs and in-place page writes --------------
def _shared_head_tables(gen, B, n_shared, lengths, ps, NP, P, dev):
    """Page tables whose first ``n_shared`` entries are the same pages
    for every slot (a borrowed prefix), private pages past them as each
    length needs, the sentinel P after."""
    perm = torch.randperm(P, generator=gen, device=dev).tolist()
    head, rest = perm[:n_shared], perm[n_shared:]
    table = torch.full((B, NP), P, dtype=torch.int32, device=dev)
    used = 0
    for b in range(B):
        need = -(-(int(lengths[b]) + 1) // ps)
        table[b, :n_shared] = torch.tensor(head, device=dev)
        n = max(0, need - n_shared)
        table[b, n_shared:n_shared + n] = torch.tensor(
            rest[used:used + n], dtype=torch.int32, device=dev)
        used += n
    return table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_shared", [1, 3])
def test_flash_kernel_on_a_paged_chunk_past_a_borrowed_prefix(card, dtype,
                                                              n_shared):
    """A chunk train's first chunk after a prefix borrow, as the paged route
    calls flash: q [2, 64, 32, 128] over the logical views two slots gather
    through tables sharing their first ``n_shared`` pages, the staircase
    starting at the borrowed length."""
    gen = torch.Generator(device=card).manual_seed(n_shared)
    ps, NP, P, C = 128, 4, 12, 64
    k = _rand(gen, (P + 1, ps, 8, 128), dtype, card)
    v = _rand(gen, (P + 1, ps, 8, 128), dtype, card)
    base = n_shared * ps
    table = _shared_head_tables(gen, 2, n_shared, [base + C] * 2, ps, NP, P,
                                card)
    q = _rand(gen, (2, C, 32, 128), dtype, card)
    k_g, v_g = dec.logical_view(k, table), dec.logical_view(v, table)
    mask = paged_window_mask(torch.full((2,), base, device=card), NP * ps, C)
    keep = fl.keep_mask(mask, 2, C, NP * ps)
    before = fl.launches
    out = fl.flash_attention(q, k_g, v_g, mask=keep[:, None])
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    ref = fl.flash_attention_plain(q, k_g, v_g, keep)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start", [77, 131, 383, 449])
def test_flash_kernel_on_a_session_chunk_from_an_unaligned_base(card, dtype,
                                                                start):
    """A session continuation's tail chunk on the slab: it starts at the
    stored length, not a multiple of the 64-key tile, over the 576-position
    row cache — the tile holding the base is live for every row."""
    gen = torch.Generator(device=card).manual_seed(start)
    C, S = 64, 576
    q = _rand(gen, (1, C, 32, 128), dtype, card)
    k = _rand(gen, (1, S, 8, 128), dtype, card)
    v = _rand(gen, (1, S, 8, 128), dtype, card)
    positions = start + torch.arange(C, device=card)
    mask = (torch.arange(S, device=card)[None, None, None, :]
            <= positions[None, None, :, None])
    keep = fl.keep_mask(mask, 1, C, S)
    out = fl.flash_attention(q, k, v, mask=keep[:, None])
    torch.cuda.synchronize()
    ref = fl.flash_attention_plain(q, k, v, keep)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_over_shared_head_pages(card, dtype, int8):
    """Sixteen slots whose tables begin with the same three pages (a
    prefix borrowed by every slot), private pages after, ragged lengths
    past the prefix."""
    gen = torch.Generator(device=card).manual_seed(16 + int8)
    B, ps, NP, P = 16, 128, 4, 64
    lengths = [min(384 + 7 * b, NP * ps - 1) for b in range(B)]
    table = _shared_head_tables(gen, B, 3, lengths, ps, NP, P, card)
    q = _rand(gen, (B, 1, 32, 128), dtype, card)
    k = _rand(gen, (P + 1, ps, 8, 128), dtype, card)
    v = _rand(gen, (P + 1, ps, 8, 128), dtype, card)
    scales = {}
    if int8:
        k, ks = quantize_kv_rows(k)
        v, vs = quantize_kv_rows(v)
        scales = dict(k_scale=ks, v_scale=vs)
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    out = dec.paged_decode_attention(q, k, v, table, lens, **scales)
    torch.cuda.synchronize()
    ref = dec.paged_decode_attention_plain(q, k, v, table, lens, **scales)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_reload_and_import_write_the_pool_in_place(card):
    """A spill reload and a parcel import write the existing pool (the
    captured programs hold its address): the pool tensors keep their
    ``data_ptr()``, the reloaded prompt's tokens equal the in-memory
    hit's, and the migrated stream's equal its straight run's."""
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request

    model = _tiny_lm(card, torch.int8)
    knobs = dict(num_slots=4, max_len=256, prompt_buckets=[16, 32],
                 decode_horizon=4, default_max_new_tokens=12,
                 device=card, paged=True, page_size=128)

    def engine(**kw):
        q = RequestQueue("t")
        e = DecodeEngine(model, q, **knobs, **kw)
        e.warmup()
        return e, q

    def ptrs(e):
        c = e._cache
        return [t.data_ptr() for t in (c.k, c.v, c.k_scale, c.v_scale,
                                       c.page_table, c.lengths)]

    def serve(e, q, tokens, max_new=12):
        r = Request(model="t", payload={"tokens": tokens,
                                        "max_new_tokens": max_new},
                    slo_ms=6e4)
        q.add_request(r)
        e.run_until_idle(timeout_s=120)
        return r.future.result(5).tokens

    gen = torch.Generator().manual_seed(3)
    head = torch.randint(1, 512, (140,), generator=gen).tolist()
    x = head + [7, 8, 9]
    a, qa = engine(prefix_cache_size=4, host_spill_pages=8)
    at_build = ptrs(a)
    serve(a, qa, head + [1, 2])
    in_memory = serve(a, qa, x)
    while len(a.paged_prefix):
        a._reclaim_cache_pins()
    reloaded = serve(a, qa, x)
    assert a.host_spill.reloads == 1
    assert reloaded == in_memory
    assert ptrs(a) == at_build
    b, qb = engine()
    b_ptrs = ptrs(b)
    straight = serve(b, qb, x, max_new=40)
    req = Request(model="t", payload={"tokens": x, "max_new_tokens": 40},
                  slo_ms=6e4)
    qa.add_request(req)
    while not a.live_stream_ids():
        a._admit()
        a._pump_prefill()
        if a._active_mask.any():
            a._step()
    assert a.request_migration(req.request_id, b.accept_parcel)
    a._service_fabric()
    b.run_until_idle(timeout_s=120)
    assert (a.migrated_out, b.migrated_in) == (1, 1)
    assert req.future.result(5).tokens == straight
    assert ptrs(b) == b_ptrs
    for e in (a, b):
        e._allocator.check()


# --- speculative decoding: the verify window on the card -------------------
def _draft_of(card):
    """A second module of ``_tiny_lm``'s shape from another seed: a
    divergent draft (partial acceptance)."""
    import dataclasses

    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        TINY_LM,
        CausalLM,
    )

    return CausalLM(dataclasses.replace(TINY_LM, d_model=256),
                    name="llama_tiny_draft", dtype=torch.float32,
                    device=card, seed=1)


def _noisy_draft_of(card):
    """``_tiny_lm``'s weights, each leaf plus seeded noise of 0.1 of its
    mean |w| (``tests/test_torch_tp_spec.py``'s recipe): a divergent
    draft whose proposals are partly accepted, so they reach the output."""
    import numpy as np

    draft = _tiny_lm(card)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for _n, p in sorted(draft.module.named_parameters()):
            noise = rng.standard_normal(tuple(p.shape)).astype(np.float32)
            p.add_(0.1 * p.abs().mean() * torch.from_numpy(noise).to(card))
    return draft


@pytest.mark.parametrize("arm", list(_ARMS))
def test_spec_engine_graphed_equals_eager(card, arm):
    """A speculative engine (divergent draft, three proposals a round) on
    each arm, its programs replayed as CUDA graphs and run eagerly:
    identical greedy tokens (f32), the same launch counts, the verify and
    catch-up captured, no capture after warmup, and the tokens those of
    the same engine without a draft."""
    kv_dtype, knobs = _ARMS[arm]
    model = _tiny_lm(card, kv_dtype)
    spec = dict(knobs, draft_model=_draft_of(card), spec_tokens=3)
    eager, eager_counts, e_eng = _serve_arm(model, spec, eager=True)
    graphed, graphed_counts, g_eng = _serve_arm(model, spec, eager=False)
    plain, _counts, _eng = _serve_arm(model, knobs, eager=False)
    assert graphed == eager
    assert graphed[:6] == plain[:6]          # the greedy requests
    assert graphed_counts == eager_counts
    assert g_eng.spec_rounds == e_eng.spec_rounds > 0
    stats = g_eng.capture_stats()
    assert set(stats["graphs"]) >= {"spec_verify", "draft_catchup"}
    assert e_eng.capture_stats()["captures"] == 0


def test_draft_cache_keeps_its_addresses(card):
    """The draft cache is state the captured programs read: its planes
    and lengths keep their ``data_ptr()`` from construction through
    warmup (which resets the draft lengths in place) and serving."""
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request

    q = RequestQueue("t")
    engine = DecodeEngine(_tiny_lm(card), q, num_slots=4, max_len=256,
                          prompt_buckets=[16, 32], device=card, paged=True,
                          draft_model=_draft_of(card), spec_tokens=3)
    dc = engine._dcache

    def ptrs():
        return [t.data_ptr() for t in (dc.k, dc.v, dc.lengths)]

    at_build = ptrs()
    engine.warmup()
    assert ptrs() == at_build and engine._dcache is dc
    assert dc.lengths.sum().item() == 0
    reqs = [Request(model="t", payload={"tokens": list(range(1, n)),
                                        "max_new_tokens": 20}, slo_ms=6e4)
            for n in (5, 40, 90)]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=120)
    assert [len(r.future.result(5).tokens) for r in reqs] == [20] * 3
    assert engine.spec_rounds > 0 and engine._dcache is dc
    assert ptrs() == at_build


def test_slab_window_write_past_capacity(card):
    """A verify window from ``lengths = S - 2`` writes S - 2 and S - 1 and
    drops three positions past capacity through the sink row (no
    duplicate writes onto S - 1): on the card, 50 times over, the cache
    and the logits of the landed rows equal the CPU run's, and nothing
    below S - 2 moves."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import CausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    model = _tiny_lm(card)
    cpu = CausalLM(model.cfg, name="llama_tiny", dtype=torch.float32,
                   device="cpu", seed=None)
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                model.module.state_dict().items()})
    S, T = 32, 5
    gen = torch.Generator().manual_seed(5)
    for trial in range(50):
        tokens = torch.randint(1, 512, (3, T), generator=gen,
                               dtype=torch.int32)
        lengths = torch.tensor([S - 2, 7, S - 1], dtype=torch.int32)
        active = torch.tensor([True, trial % 2 == 0, True])
        caches, logits = [], []
        for m, dev in ((model, card), (cpu, torch.device("cpu"))):
            c = m.make_cache(3, S)
            with torch.inference_mode():
                c.k.copy_(torch.randn(c.k.shape, generator=torch.Generator(
                    ).manual_seed(trial)).to(dev))
                c.v.copy_(-c.k)
                c.lengths.copy_(lengths.to(dev))
                out, c = m.verify_step(tokens.to(dev), c, active.to(dev))
            caches.append(c)
            logits.append(out.cpu())
        torch.cuda.synchronize()
        g, h = caches
        for a, b in ((g.k, h.k), (g.v, h.v)):
            assert (a.cpu() - b).abs().max().item() <= 1e-4
        assert torch.equal(g.k[:, 0, : S - 2].cpu(), h.k[:, 0, : S - 2])
        assert (logits[0][0, :2] - logits[1][0, :2]).abs().max() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,N,K,H", [
    (16, 512, 32, 8, 128),   # llama3_8b: 20 window rows a KV head
    (64, 256, 16, 16, 64),   # gpt2_medium: 5
])
def test_decode_kernel_at_the_verify_window(card, dtype, B, S, N, K, H):
    """Kernel 2 at the slab verify's shape (Tq = 5, the staircase mask
    ``pos <= lengths + t``, lengths up to S - 5) against its plain
    version."""
    gen = torch.Generator(device=card).manual_seed(B + S)
    q = _rand(gen, (B, 5, N, H), dtype, card)
    k = _rand(gen, (B, S, K, H), dtype, card)
    v = _rand(gen, (B, S, K, H), dtype, card)
    lengths = torch.randint(40, S - 5 + 1, (B,), generator=gen, device=card)
    mask = _slab_window(lengths, 5, S, card)
    before = dec.launches
    out = dec.decode_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    ref = dec.decode_attention_plain(q, k, v, fl.keep_mask(mask, B, 5, S))
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_the_verify_window(card, dtype, int8):
    """Kernel 3 at the paged verify's shape: q [16, 5, 32, 128] over a
    64-page pool of 128-token pages, each slot's table ending in a
    scratch page that its window alone reaches (lengths just below a
    page boundary), against its plain version."""
    gen = torch.Generator(device=card).manual_seed(11)
    B, P, ps, NP = 16, 64, 128, 4
    q = _rand(gen, (B, 5, 32, 128), dtype, card)
    if int8:
        k, ks = _int8(gen, (P, ps, 8, 128), card)
        v, vs = _int8(gen, (P, ps, 8, 128), card)
    else:
        k = _rand(gen, (P, ps, 8, 128), dtype, card)
        v = _rand(gen, (P, ps, 8, 128), dtype, card)
        ks = vs = None
    pages = torch.randint(1, NP, (B,), generator=gen, device=card)
    lengths = (pages * ps - torch.randint(1, 5, (B,), generator=gen,
                                          device=card)).to(torch.int32)
    perm = torch.randperm(P, generator=gen, device=card).to(torch.int32)
    table = torch.full((B, NP), P, dtype=torch.int32, device=card)
    used = 0
    for b in range(B):
        n = int(pages[b]) + 1               # the owned run + one scratch
        table[b, :n] = perm[used: used + n]
        used += n
    launched = dec.paged_int8_launches if int8 else dec.paged_launches
    out = dec.paged_decode_attention(q, k, v, table, lengths, k_scale=ks,
                                     v_scale=vs)
    torch.cuda.synchronize()
    after = dec.paged_int8_launches if int8 else dec.paged_launches
    assert after == launched + 1
    ref = dec.paged_decode_attention_plain(q, k, v, table, lengths,
                                           k_scale=ks, v_scale=vs)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


# --- the int8-weight GEMM (ops/quant_matmul.py) ----------------------------------
def _int8_case(card, M, N, K, period, act, w_dtype, bias=False, seed=0):
    """x [M, K] ~ N(0, 1) in ``act``, codes uniform in [-127, 127], scales
    that keep |y| below ~2 (so bf16 outputs round at 2^-8 .. 2^-7)."""
    from ray_dynamic_batching_tpu_torch.ops import quant_matmul

    gen = torch.Generator(device=card).manual_seed(seed + M + N + K)
    x = torch.randn((M, K), generator=gen, device=card).to(act)
    codes = torch.randint(-127, 128, (N, K), generator=gen, device=card,
                          dtype=torch.int8)
    scale = (torch.rand((period,), generator=gen, device=card) + 0.5) \
        * (0.5 / (127 * K ** 0.5))
    b = (torch.randn((N,), generator=gen, device=card).to(act)
         if bias else None)
    return quant_matmul, x, codes, scale, b


_INT8_ACTS = [(torch.bfloat16, torch.bfloat16, "bf16"),
               (torch.float32, torch.bfloat16, "f32_head"),
               (torch.float32, torch.float32, "f32")]
_INT8_SHAPES = [
    (16, 4096, 4096, 128, False),    # llama3_8b q at decode: scale per h
    (16, 1024, 4096, 128, False),    # k / v: split K 8 ways
    (16, 14336, 4096, 14336, False),  # mlp_up
    (16, 4096, 14336, 4096, False),  # mlp_down
    (256, 4096, 4096, 4096, False),  # o at a prefill group of 4 x 64
    (80, 1024, 4096, 128, False),    # a verify window of 16 x 5
    (4, 5000, 4096, 5000, False),    # the head's take rows (narrowed)
    (1, 77, 80, 77, True),           # odd N, K not a multiple of 64
    (17, 1000, 208, 8, True),        # odd M, period below N
    (3, 64, 16, 64, True),           # one 16-deep step
    (160, 128, 64, 128, False),      # moe_tiny's experts at a prefill
]
# Every bf16 product chip_smoke.py's phase 18 launches (its _w8_cases):
# llama3_8b's q, k/v, o, gate/up and down at 16-256 rows, and the MoE
# experts' gate/up and down at 40-160 rows.
_W8_PROJ = (("q", 4096, 4096, 128), ("kv", 1024, 4096, 128),
            ("o", 4096, 4096, 4096), ("gate_up", 14336, 4096, 14336),
            ("down", 4096, 14336, 4096))
_W8_BF16 = ([(f"{r}-{M}", M, N, K, p) for r, N, K, p in _W8_PROJ
             for M in (16, 64, 128, 192, 256)]
            + [(f"expert_{r}-{M}", M, N, K, p) for r, N, K, p in _W8_PROJ[3:]
               for M in (40, 80, 120, 160)])
_INT8_CASES = (
    [pytest.param(act, wd, *shape,
                  id="-".join(str(v) for v in shape) + f"-{tag}")
     for act, wd, tag in _INT8_ACTS for shape in _INT8_SHAPES]
    + [pytest.param(torch.bfloat16, torch.bfloat16, M, N, K, p, False,
                    id=f"w8-{name}-bf16")
       for name, M, N, K, p in _W8_BF16])


@pytest.mark.parametrize("act,w_dtype,M,N,K,period,bias", _INT8_CASES)
def test_int8_weight_kernel_matches_plain(card, act, w_dtype, M, N, K,
                                          period, bias):
    qm, x, codes, scale, b = _int8_case(card, M, N, K, period, act, w_dtype,
                                        bias)
    before = qm.launches
    got = qm.int8_linear(x, codes, scale, b, weight_dtype=w_dtype)
    torch.cuda.synchronize()
    assert qm.launches == before + 1
    want = qm.int8_linear_plain(x, codes, scale, b, weight_dtype=w_dtype)
    assert got.dtype == act and got.shape == (M, N)
    assert torch.isfinite(got.float()).all()
    tol = TOL[act] if act == torch.float32 else TOL[torch.bfloat16]
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_int8_weight_kernel_is_deterministic_and_replays(card):
    """A shape whose K the decode body splits over a cluster of 8 (k/v at
    decode): two eager calls give identical bits (the partials are summed
    in rank order), and a CUDA graph of the call replays to the same bits
    on new inputs copied in place, adding one launch a replay."""
    from ray_dynamic_batching_tpu_torch.ops import graphs

    qm, x, codes, scale, _ = _int8_case(card, 16, 1024, 4096, 128,
                                        torch.bfloat16, torch.bfloat16)
    first = qm.int8_linear(x, codes, scale, weight_dtype=torch.bfloat16)
    assert torch.equal(first, qm.int8_linear(x, codes, scale,
                                             weight_dtype=torch.bfloat16))
    gs = graphs.GraphSet(card)
    prog = gs.program("int8_linear", lambda a: qm.int8_linear(
        a, codes, scale, weight_dtype=torch.bfloat16))
    prog(x)                                   # eager first call
    x2 = torch.randn_like(x.float()).to(x.dtype)
    want = qm.int8_linear(x2, codes, scale, weight_dtype=torch.bfloat16)
    before = qm.launches
    decode = qm.launches_by_body["decode"]
    got = prog(x2).clone()                    # a replay
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert qm.launches == before + 1
    assert qm.launches_by_body["decode"] == decode + 1
    assert torch.equal(prog(x).clone(), first)


@pytest.mark.parametrize("M,act,w_dtype,body", [
    (16, torch.bfloat16, torch.bfloat16, "decode"),
    (17, torch.bfloat16, torch.bfloat16, "prefill"),
    (256, torch.bfloat16, torch.bfloat16, "prefill"),
    (16, torch.float32, torch.bfloat16, "split3"),
    (16, torch.float32, torch.float32, "fma"),
])
def test_int8_weight_kernel_routes_each_shape_to_its_body(card, M, act,
                                                          w_dtype, body):
    """One launch on each side of the M = 16 boundary, and at a prefill
    group's 256 rows, goes through the body meant for it (the entry
    point reports the body it launched)."""
    qm, x, codes, scale, _ = _int8_case(card, M, 1024, 4096, 128, act,
                                        w_dtype)
    before = dict(qm.launches_by_body)
    qm.int8_linear(x, codes, scale, weight_dtype=w_dtype)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in qm.launches_by_body.items()
             if v != before[k]}
    assert moved == {body: 1}


def test_int8_weight_kernel_refuses_what_it_cannot_take(card):
    qm, x, codes, scale, _ = _int8_case(card, 4, 64, 32, 64, torch.float32,
                                        torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.int8_linear(x[:, :24].contiguous(), codes[:, :24].contiguous(),
                       scale, weight_dtype=torch.float32)
    with pytest.raises(ValueError, match="device"):
        qm.int8_linear(x, codes.cpu(), scale, weight_dtype=torch.float32)
    with pytest.raises(TypeError, match="bf16 weights"):
        qm.int8_linear(x.bfloat16(), codes, scale,
                       weight_dtype=torch.float32)


@pytest.mark.parametrize("arm", list(_ARMS))
def test_quantized_engine_graphed_equals_eager(card, arm):
    """Weight-only int8 on every arm: the graphed and eager engines serve
    identical greedy tokens (f32) with every product on the int8 kernel,
    whose launches are the same in both."""
    from ray_dynamic_batching_tpu_torch.models.quant import quantize_tree
    from ray_dynamic_batching_tpu_torch.ops import quant_matmul

    kv_dtype, knobs = _ARMS[arm]
    model = quantize_tree(_tiny_lm(card, kv_dtype))
    runs = []
    for eager in (True, False):
        tokens, counts, engine = _serve_arm(model, knobs, eager=eager)
        runs.append((tokens, counts, quant_matmul.launches))
        assert engine.quantized
    assert runs[0] == runs[1]
    assert runs[1][2] > 0


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_int8kv",
                                  "moe_tiny"])
def test_tiny_decoders_serve_on_the_decode_kernels(card, name, paged):
    """The registry's tiny decoders (head_dim 16) served through
    ``LLMDeployment`` on the card: the decode kernels launch, and the
    greedy tokens (f32) equal an eager deployment's on the plain route."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import attention as att
    from ray_dynamic_batching_tpu_torch.ops import graphs
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 500, (n,), generator=gen).tolist()
               for n in (3, 7, 12, 5)]

    def serve():
        dep = LLMDeployment(name, num_slots=4, max_len=256 if paged else 64,
                            prompt_buckets=[8, 16], default_max_new_tokens=6,
                            dtype=torch.float32, device=card, seed=0,
                            paged=paged)
        replica = dep.make_replica("t", DeploymentConfig(name=name))
        reqs = [Request(model=name, payload={"tokens": p}, slo_ms=1e7)
                for p in prompts]
        for r in reqs:
            replica.engine.queue.add_request(r)
        replica.engine.run_until_idle(timeout_s=300)
        return [r.future.result(timeout=5).tokens for r in reqs]

    att.reset_counts()
    got = serve()
    kernel = (dec.paged_launches + dec.paged_int8_launches if paged
              else dec.launches + dec.int8_launches)
    assert kernel > 0
    with att.plain_attention(), graphs.disable_capture():
        want = serve()
    assert got == want


# --- kernel 4: kernel 3 per kv-head shard (tensor parallelism) ---------------
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp,B,Tq,N,K,H", [
    (2, 4, 1, 32, 8, 128, ),      # llama3_8b geometry: 4 kv heads a shard
    (4, 3, 5, 32, 8, 128),        # 2 a shard, a verify window
    (8, 2, 1, 32, 8, 128),        # 1 kv head a shard
    (2, 5, 3, 8, 2, 64),          # head_dim 64, 1 kv head a shard
])
def test_tp_shards_bit_identical_to_one_launch(card, tp, B, Tq, N, K, H,
                                               dtype, int8):
    """The tp shards' launches (each q / pool cut as a mesh rank holds
    it), concatenated, equal one unsharded launch bit for bit, and count
    as kernel 4's launches, not kernel 3's."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import Mesh

    gen = torch.Generator(device=card).manual_seed(tp * 10 + Tq)
    NP, ps = 3, 128
    P = B * NP + 2
    if int8:
        q, k, v, ks, vs, table, lengths = _paged_int8(
            gen, B, Tq, N, K, H, P, ps, NP, dtype, card)
    else:
        q, k, v, table, lengths = _paged(gen, B, Tq, N, K, H, P, ps, NP,
                                         dtype, card)
        ks = vs = None
    whole = dec.paged_decode_attention(q, k, v, table, lengths, k_scale=ks,
                                       v_scale=vs)
    counter = "tp_paged_int8_launches" if int8 else "tp_paged_launches"
    plain = "paged_int8_launches" if int8 else "paged_launches"
    before = getattr(dec, counter), getattr(dec, plain)
    out = dec.paged_decode_attention_tp(q, k, v, table, lengths, tp=tp,
                                        k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(out, whole)
    assert (getattr(dec, counter), getattr(dec, plain)) == (
        before[0] + tp, before[1])
    # One rank's call through the mesh argument: the same launch.
    n, kk = N // tp, K // tp
    shard = dec.paged_decode_attention(
        q[:, :, :n].contiguous(), k[:, :, :kk].contiguous(),
        v[:, :, :kk].contiguous(), table, lengths,
        k_scale=None if ks is None else ks[:, :, :kk].contiguous(),
        v_scale=None if vs is None else vs[:, :, :kk].contiguous(),
        mesh=Mesh({"tp": tp}, [card] * tp))
    assert torch.equal(shard, whole[:, :, :n])


def test_tp_engine_on_gloo_ranks_sharing_the_card(card):
    """A tp-2 engine over a gloo world whose two ranks share this card
    (NCCL takes one rank a card) serves llama_tiny's greedy tokens equal
    to the single-card engine's, on the slab and the pool, kernels 2 and
    4 launched on both ranks; its rank ends with the mesh."""
    import numpy as np

    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.models import registry
    from ray_dynamic_batching_tpu_torch.ops import graphs
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm

    model = registry.get_model("llama_tiny", dtype=torch.float32,
                               device=card, seed=0)
    rng = np.random.default_rng(3)
    payloads = [{"tokens": rng.integers(1, 500, n).tolist(),
                 "max_new_tokens": 6} for n in (5, 12, 30, 40)]
    knobs = dict(num_slots=4, max_len=128, prompt_buckets=[16],
                 decode_horizon=4)

    def serve(m, mesh, **kw):
        q = RequestQueue("t", max_len=64)
        with graphs.disable_capture():
            engine = DecodeEngine(m, q, device=card, mesh=mesh,
                                  **{**knobs, **kw})
        reqs = [Request(model="t", payload=p, slo_ms=6e4) for p in payloads]
        for r in reqs:
            q.add_request(r)
        engine.run_until_idle(timeout_s=120)
        out = [r.future.result(timeout=10).tokens for r in reqs]
        engine.release_buffers()
        return out

    mesh = pm.build_mesh(pm.MeshConfig(tp=2), [card, card], backend="gloo")
    procs = list(mesh.world._procs)
    try:
        shard = pm.shard_params(mesh, model)
        for kw in ({}, {"paged": True, "page_size": 128}):
            assert serve(shard, mesh, **kw) == serve(model, None, **kw)
        assert not mesh.world.failed
    finally:
        mesh.shutdown()
    assert not any(p.is_alive() for p in procs)


def test_tp_spec_engine_on_gloo_ranks_sharing_the_card(card):
    """A tp-2 slab engine speculating with a divergent draft (the target
    plus seeded noise; each rank holds its shard of both) serves the
    one-card spec engine's greedy tokens at its acceptance rate, which
    lies strictly between 0 and 1; kernel 2 launched on rank 0's shard
    (every rank's count: ``chip_smoke.py`` 20c)."""
    import numpy as np

    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import attention, graphs
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm

    model, draft = _tiny_lm(card), _noisy_draft_of(card)
    rng = np.random.default_rng(4)
    payloads = [{"tokens": rng.integers(1, 500, n).tolist(),
                 "max_new_tokens": 8} for n in (5, 12, 30, 40)]

    def serve(m, d, mesh):
        q = RequestQueue("t", max_len=64)
        with graphs.disable_capture():
            engine = DecodeEngine(m, q, device=card, mesh=mesh, num_slots=4,
                                  max_len=128, prompt_buckets=[16],
                                  decode_horizon=4, draft_model=d,
                                  spec_tokens=3)
        reqs = [Request(model="t", payload=p, slo_ms=6e4) for p in payloads]
        for r in reqs:
            q.add_request(r)
        engine.run_until_idle(timeout_s=120)
        out = ([r.future.result(timeout=10).tokens for r in reqs],
               engine.spec_acceptance(), engine.spec_rounds)
        engine.release_buffers()
        return out

    want = serve(model, draft, None)
    assert 0.0 < want[1] < 1.0
    mesh = pm.build_mesh(pm.MeshConfig(tp=2), [card, card], backend="gloo")
    procs = list(mesh.world._procs)
    try:
        shard = pm.shard_params(mesh, model)
        attention.reset_counts()
        got = serve(shard, pm.shard_params(mesh, draft), mesh)
        assert got == want and got[2] > 0
        assert dec.launches > 0      # kernel 2 on this rank's shard
        assert not mesh.world.failed
    finally:
        mesh.shutdown()
    assert not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_tp_parcel_scatter_and_gather_bit_identical(card, kv_dtype):
    """Pages a one-card paged engine filled, exported as a parcel (every
    kv head), written into a tp-2 engine's pool (each rank keeps its
    kv-head shard) and exported from it again (the shards gathered over
    the tp group): bit-identical to the one-card export."""
    import numpy as np

    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import graphs
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm

    model = _tiny_lm(card, kv_dtype)
    knobs = dict(num_slots=2, max_len=384, prompt_buckets=[128],
                 paged=True, page_size=128, prefix_cache_size=4)
    with graphs.disable_capture():
        one = DecodeEngine(model, RequestQueue("o", max_len=512),
                           device=card, **knobs)
    rng = np.random.default_rng(5)
    req = Request(model="o", payload={"tokens": rng.integers(
        1, 500, 300).tolist(), "max_new_tokens": 2}, slo_ms=6e4)
    one.queue.add_request(req)
    one.run_until_idle(timeout_s=120)
    req.future.result(timeout=10)
    # The prompt's published pages (the prefix cache pins them).
    pages = list(max(one.paged_prefix._entries.values(), key=len))
    want = one._read_pages(pages)
    one.release_buffers()
    assert len(pages) == 2 and want["k"].shape[3] == model.cfg.num_kv_heads
    assert want["k"].float().abs().sum() > 0
    mesh = pm.build_mesh(pm.MeshConfig(tp=2), [card, card], backend="gloo")
    procs = list(mesh.world._procs)
    try:
        shard = pm.shard_params(mesh, model)
        with graphs.disable_capture():
            tp = DecodeEngine(shard, RequestQueue("t", max_len=512),
                              device=card, mesh=mesh, **knobs)
        assert tp._cache.k.shape[3] * 2 == model.cfg.num_kv_heads
        tp._write_pages(pages, want)
        got = tp._read_pages(pages)
        tp.release_buffers()
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), name
        assert not mesh.world.failed
    finally:
        mesh.shutdown()
    assert not any(p.is_alive() for p in procs)


# --- the serving surface: checkpoints, /v1/completions, the native library ---
def test_bf16_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A bf16 llama_tiny on the card saved with ``CheckpointManager`` and
    restored into a fresh deployment on the card: every leaf bit for bit
    in its own dtype (bf16 as raw two-byte items, never through numpy
    floats), on the card."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        TINY_LM,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.models.convert import params_to_flax
    from ray_dynamic_batching_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.pytree import (
        flatten_with_paths,
    )

    src = CausalLM(TINY_LM, "llama_tiny", dtype=torch.bfloat16, device=card,
                   seed=3)
    CheckpointManager(tmp_path).save(1, params_to_flax(src))
    dep = LLMDeployment("llama_tiny", dtype=torch.bfloat16, device=card,
                        checkpoint_dir=str(tmp_path))
    got = flatten_with_paths(params_to_flax(dep._ensure_model()))
    want = flatten_with_paths(params_to_flax(src))
    assert list(got) == list(want)
    assert any(w.dtype == torch.bfloat16 for w in want.values())
    for k, w in want.items():
        g = got[k]
        # bf16 weights; the norms' scales and the head stay f32.
        assert g.device.type == "cuda" and g.dtype == w.dtype, k
        if w.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w), k


def test_completions_route_on_the_kernels_equals_the_handle(card):
    """``/v1/completions`` on llama_tiny served on the card: kernels 1 and
    2 launch, and the completions' tokens equal the handle's on the same
    payloads."""
    import http.client
    import json

    from ray_dynamic_batching_tpu_torch.ops import attention as att
    from ray_dynamic_batching_tpu_torch.serve import CompletionsHandle
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.serve.proxy import (
        HTTPProxy,
        ProxyRouter,
    )
    from ray_dynamic_batching_tpu_torch.serve.router import Router

    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, 500, (n,), generator=gen).tolist()
               for n in (3, 7, 12)]
    dep = LLMDeployment("llama_tiny", num_slots=4, max_len=64,
                        prompt_buckets=[16], default_max_new_tokens=6,
                        dtype=torch.float32, device=card, seed=0)
    replica = dep.make_replica("t", DeploymentConfig(name="llama_tiny"))
    replica.start()
    router = Router("llama_tiny", replicas=[replica],
                    max_assign_timeout_s=30.0)
    handle = DeploymentHandle(router, default_slo_ms=1e7)
    routes = ProxyRouter()
    routes.set_route("/v1/completions", CompletionsHandle(handle,
                                                          "llama_tiny"))
    proxy = HTTPProxy(routes, host="127.0.0.1", port=0).start()
    try:
        att.reset_counts()
        want = [handle.remote({"tokens": p, "max_new_tokens": 6}
                              ).result(timeout=120).tokens for p in prompts]
        got = []
        for p in prompts:
            conn = http.client.HTTPConnection("127.0.0.1", proxy.port,
                                              timeout=120)
            conn.request("POST", "/v1/completions",
                         body=json.dumps({"prompt": p, "max_tokens": 6}))
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 200
            assert body["result"]["usage"]["completion_tokens"] == 6
            got.append(body["result"]["choices"][0]["tokens"])
        assert fl.launches > 0 and dec.launches > 0
        assert got == want
    finally:
        proxy.stop()
        router.close()
        replica.stop(timeout_s=5.0, drain=False)


def test_native_library_builds_with_gxx_on_this_machine(tmp_path,
                                                        monkeypatch):
    """The native runtime library built by ``g++`` from ``native/src``
    here, into a fresh directory, and a queue and store working through
    it."""
    import os
    import uuid

    from ray_dynamic_batching_tpu_torch.runtime import native

    if not torch.cuda.is_available():
        pytest.skip("runs on the card machine")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_LIB", None)
    path = native.build_native()
    assert path.parent == tmp_path / "native" and path.exists()
    name = f"/rdbcuda_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    q = native.NativeQueue(name + ".q", capacity=4, item_size=32)
    s = native.ObjectStore(name + ".s", capacity_bytes=1 << 16)
    try:
        assert q.push(b"x") and q.pop_batch(2, timeout_ms=100) == [b"x"]
        assert s.put(1, b"y") and s.get(1) == b"y"
    finally:
        q.close()
        s.close()


# --- training: kernel 1's backward -------------------------------------------
def _bwd_case(card, B, Tq, Tk, N, K, H, dtype, causal, pattern):
    """Seeded q, k, v, dO and a key mask with the last batch row's final
    quarter padding; ``pattern`` True also voids batch row 0's first keys
    (its query rows 0..2 attend nothing under causal), "void_tile" voids
    keys 64..127 of batch row 0 (a whole key tile mid-row)."""
    gen = torch.Generator(device=card).manual_seed(Tq * 7 + N)
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k = _rand(gen, (B, Tk, K, H), dtype, card)
    v = _rand(gen, (B, Tk, K, H), dtype, card)
    dout = _rand(gen, (B, Tq, N, H), dtype, card)
    tm = torch.ones((B, Tk), dtype=torch.bool, device=card)
    tm[-1, 3 * Tk // 4:] = False
    if pattern == "void_tile":
        tm[0, 64:128] = False
    elif pattern:
        tm[0, :Tk - Tq + 3] = False      # query rows 0..2 of row 0: nothing
    keep = tm[:, None, :].expand(B, Tq, Tk).to(torch.int8).contiguous()
    return q, k, v, dout, keep


def _flash_grads(q, k, v, dout, keep, causal):
    """(out, dq, dk, dv) through FlashAttentionFn."""
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fl.flash_attention(*xs, causal=causal, mask=keep[:, None])
    return [out] + list(torch.autograd.grad(out, xs, dout))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,N,K,H,causal,pattern", [
    (4, 512, 512, 32, 8, 128, True, False),   # llama3_8b's training shape
    (2, 80, 80, 8, 2, 64, True, False),       # small GQA, ragged tiles
    (2, 96, 96, 4, 4, 128, True, True),       # fully masked rows
    (2, 40, 100, 4, 2, 64, True, False),      # Tq < Tk: the diagonal offset
    (1, 70, 70, 4, 1, 16, False, False),      # head_dim 16, not causal
    (2, 80, 80, 8, 2, 104, True, False),      # head_dim 104 on HP-128 tiles
    (1, 96, 96, 32, 4, 128, True, False),     # G = 8 query heads a kv head
    (2, 200, 200, 4, 2, 128, False, "void_tile"),  # a void key tile mid-row
    (2, 200, 200, 4, 2, 64, True, "void_tile"),    # ... causal, HP 64
    (1, 64, 576, 32, 8, 128, True, False),    # a 64-row chunk over 576 keys
])
def test_flash_backward_matches_plain_autograd(card, B, Tq, Tk, N, K, H,
                                               dtype, causal, pattern):
    q, k, v, dout, keep = _bwd_case(card, B, Tq, Tk, N, K, H, dtype, causal,
                                    pattern)
    fl.bwd_launches = 0
    got = _flash_grads(q, k, v, dout, keep, causal)
    assert fl.bwd_launches == 1
    ys = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ref = fl.flash_attention_plain(*ys, keep, causal=causal)
    want = [ref] + list(torch.autograd.grad(ref, ys, dout))
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= \
            TOL[dtype] * max(scale, 1.0)
    if pattern is True:
        assert not got[1][0, :3].any()


@pytest.mark.parametrize("B,Tq,Tk,N,K,H,causal,pattern", [
    (4, 512, 512, 32, 8, 128, True, False),   # llama3_8b's training shape
    (2, 200, 200, 4, 2, 64, True, "void_tile"),
])
def test_flash_backward_is_deterministic(card, B, Tq, Tk, N, K, H, causal,
                                         pattern):
    """Every gradient element is written by one block, with no atomics:
    two backward calls on the same bf16 inputs give the same bits."""
    case = _bwd_case(card, B, Tq, Tk, N, K, H, torch.bfloat16, causal,
                     pattern)
    first = _flash_grads(*case, causal)
    second = _flash_grads(*case, causal)
    for a, b in zip(first[1:], second[1:]):
        assert torch.equal(a, b)


def test_bare_flash_launch_refuses_grad_inputs(card):
    q = torch.randn((1, 32, 2, 64), device=card, dtype=torch.bfloat16)
    k = torch.randn((1, 32, 2, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        fl._launch(q.requires_grad_(True), k, k, None, causal=True,
                   scale=0.125)
    out = fl.flash_attention(q, k, k, causal=True)   # through the Function
    assert out.grad_fn is not None


def test_two_layer_train_step_kernel_vs_plain(card):
    """llama3_8b at full width, 2 layers, f32: one step's loss and
    gradients through kernel 1 and its backward against the plain
    route."""
    import dataclasses

    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.parallel import optim, train

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model = CausalLM(cfg, name="llama3_8b", dtype=torch.float32,
                     device=card, seed=0)
    params, _ = train.make_sharded_train_state(model, None,
                                               optim.adamw(1e-3))
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    mask = torch.ones((2, 64), dtype=torch.int32)
    mask[1, 40:] = 0
    attention.reset_counts()
    loss, grads = train.loss_and_grads(model, None, params, tok, mask)
    grads = {n: g.clone() for n, g in grads.items()}
    assert fl.launches == 2 and fl.bwd_launches == 2
    with attention.plain_attention():
        loss_p, grads_p = train.loss_and_grads(model, None, params, tok,
                                               mask)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for n in grads:
        scale = grads_p[n].abs().max().item()
        assert (grads[n] - grads_p[n]).abs().max().item() <= \
            1e-4 * max(scale, 1e-30), n


# --- body C (kernel 1's long rows) and the single-row scan (kernels 2, 3) ---
def _key_rows(gen, B, Tk, dev, lo=None):
    """[B, 1, 1, Tk] bool: each batch row's keys a prefix of lo .. Tk."""
    lo = max(1, 3 * Tk // 4) if lo is None else lo
    n = torch.randint(lo, Tk + 1, (B,), generator=gen, device=dev)
    return (torch.arange(Tk, device=dev)[None, :] < n[:, None])[:, None, None]


def _body_delta(by_body, before):
    return {b: by_body[b] - before[b] for b in by_body if by_body[b] != before[b]}


@pytest.mark.parametrize("B,Tq,Tk,N,K,H,mask_kind,causal", [
    (32, 128, 128, 12, 12, 64, "key", False),     # DistilBERT T 128
    (32, 256, 256, 12, 12, 64, "key", False),     # DistilBERT T 256
    (8, 1500, 1500, 20, 20, 64, "key", False),    # Whisper's encoder
    (8, 128, 128, 16, 16, 64, "key", True),       # gpt2_medium no-cache T 128
    (8, 256, 256, 16, 16, 64, "key", True),       # ... T 256
    (2, 300, 257, 8, 2, 64, "dense", False),      # Tk 257, GQA, a dense mask
    (2, 130, 150, 4, 4, 64, "key", True),         # Tk 150, causal, Tq != Tk
    (2, 200, 150, 4, 2, 64, "dense", True),       # dense + causal, Tq > Tk
    (1, 128, 1500, 4, 4, 32, "none", True),       # head_dim 32, no mask
    (2, 140, 200, 4, 4, 64, "masked_row", False),  # a row with no key: 0
])
def test_flash_body_c_matches_plain(card, B, Tq, Tk, N, K, H, mask_kind,
                                    causal):
    """Body C (bf16, head_dim <= 64, Tq >= 128) against the plain version
    at the servables' shapes and at unaligned Tk, on the keep-mask layouts
    the models hand over: a key row (row stride 0) and dense rows padded
    to 16 bytes."""
    gen = torch.Generator(device=card).manual_seed(Tq * 7 + Tk)
    dtype = torch.bfloat16
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k = _rand(gen, (B, Tk, K, H), dtype, card)
    v = _rand(gen, (B, Tk, K, H), dtype, card)
    mask = None
    if mask_kind == "key":
        mask = _key_rows(gen, B, Tk, card)
    elif mask_kind in ("dense", "masked_row"):
        mask = torch.rand((B, 1, Tq, Tk), generator=gen, device=card) < 0.7
        if mask_kind == "masked_row":
            mask[0, 0, 5] = False
    keep = fl.keep_mask(mask, B, Tq, Tk)
    if mask_kind == "key":
        assert keep.stride(1) == 0
    elif keep is not None:
        assert keep.stride(1) % 16 == 0 and keep.stride(1) >= Tk
    before = dict(fl.launches_by_body)
    out = fl.flash_attention(q, k, v, causal=causal,
                             mask=None if keep is None else keep[:, None])
    torch.cuda.synchronize()
    assert _body_delta(fl.launches_by_body, before) == {"C": 1}
    ref = fl.flash_attention_plain(q, k, v, keep, causal=causal)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    if mask_kind == "masked_row":
        assert out[0, 5].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype,Tq,Tk,H,masked,causal,lse,want", [
    (torch.bfloat16, 1500, 1500, 64, True, False, False, "C"),  # Whisper
    (torch.bfloat16, 128, 128, 64, True, False, False, "C"),    # BERT 128
    (torch.bfloat16, 256, 256, 64, True, True, False, "C"),     # gpt2 256
    (torch.bfloat16, 64, 64, 64, True, False, False, "A"),      # BERT 64
    (torch.bfloat16, 64, 512, 128, True, False, False, "A"),    # LLM chunk
    (torch.bfloat16, 512, 512, 128, True, True, True, "A"),     # training
    (torch.bfloat16, 256, 256, 64, True, True, True, "A"),      # an LSE
    (torch.bfloat16, 197, 197, 64, False, False, False, "B"),   # ViT-B/16
    (torch.bfloat16, 257, 257, 104, False, False, False, "B"),  # ViT-G/14
    (torch.bfloat16, 1000, 4000, 64, False, False, False, "C"),
    (torch.float32, 1500, 1500, 64, True, False, False, "fma"),
])
def test_flash_body_rule(card, dtype, Tq, Tk, H, masked, causal, lse, want):
    """The body kernel 1's library names for a shape
    (``flash_attention.body_for``, ``rdb_flash_body``)."""
    assert fl.body_for(dtype, Tq, Tk, H, masked=masked, causal=causal,
                       lse=lse) == want


@pytest.mark.parametrize("dtype,Tq,Tk,H,mask_kind,causal,lse,want", [
    (torch.bfloat16, 1500, 1500, 64, "key", False, False, "C"),
    (torch.bfloat16, 256, 256, 64, "key", True, False, "C"),
    (torch.bfloat16, 128, 128, 48, "none", True, False, "C"),
    (torch.bfloat16, 64, 256, 64, "key", False, False, "A"),    # Tq < 128
    (torch.bfloat16, 256, 256, 128, "key", True, False, "A"),   # head_dim 128
    (torch.bfloat16, 256, 256, 64, "key", True, True, "A"),     # an LSE
    (torch.bfloat16, 197, 197, 64, "none", False, False, "B"),  # vision
    (torch.bfloat16, 1000, 4000, 64, "none", False, False, "C"),  # K/V > B's
    (torch.float32, 256, 256, 64, "key", False, False, "fma"),
])
def test_flash_route_lands_on_its_body(card, dtype, Tq, Tk, H, mask_kind,
                                       causal, lse, want):
    """Each shape launches the body named here, the one
    ``flash_attention.body_for`` names."""
    gen = torch.Generator(device=card).manual_seed(Tq + H)
    B, N = 1, 2
    q = _rand(gen, (B, Tq, N, H), dtype, card)
    k = _rand(gen, (B, Tk, N, H), dtype, card)
    v = _rand(gen, (B, Tk, N, H), dtype, card)
    keep = fl.keep_mask(_key_rows(gen, B, Tk, card), B, Tq, Tk) \
        if mask_kind == "key" else None
    assert fl.body_for(dtype, Tq, Tk, H, masked=keep is not None,
                       causal=causal, lse=lse) == want
    before = dict(fl.launches_by_body)
    if lse:
        lse_buf = torch.empty((B, N, Tq), dtype=torch.float32, device=card)
        fl._launch(q, k, v, keep, causal=causal, scale=H ** -0.5, lse=lse_buf)
    else:
        fl.flash_attention(q, k, v, causal=causal,
                           mask=None if keep is None else keep[:, None])
    torch.cuda.synchronize()
    assert _body_delta(fl.launches_by_body, before) == {want: 1}


# (B * K, S) -> tiles a split of the single-row scan, as
# ``tests/test_torch_kernel_rules.py`` models the rule (``ROW_SPLITS``).
ROW_SPLITS = {(8 * 20, 1500): 8, (64 * 16, 256): 4, (8 * 20, 40): 2,
              (1, 32768): 2}


def test_row_split_tiles_rule(card):
    """Kernels 2-3's split rule (``rdb_row_split_tiles``) at the servables'
    shapes, and its bounds over a sweep: at least two tiles a split, and
    no more splits than keep B * K * splits within 4 x 132 blocks (or one
    split a slot)."""
    for (BK, S), lt in ROW_SPLITS.items():
        assert dec.row_split_tiles(BK, S) == lt
    for BK in (1, 7, 160, 528, 529, 4096):
        for S in (1, 64, 65, 1500, 8192):
            lt = dec.row_split_tiles(BK, S)
            nsplit = -(-(-(-S // 64)) // lt)
            assert lt >= 2 and BK * nsplit <= max(BK, 4 * 132)


def _row_case(gen, B, S, N, H, dtype, card, int8=False):
    q = _rand(gen, (B, 1, N, H), dtype, card)
    if int8:
        k, ks = _int8(gen, (B, S, N, H), card)
        v, vs = _int8(gen, (B, S, N, H), card)
        return q, k, v, ks, vs
    return (q, _rand(gen, (B, S, N, H), dtype, card),
            _rand(gen, (B, S, N, H), dtype, card), None, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,N,H,int8,kind", [
    (8, 1500, 20, 64, False, "key"),      # Whisper's cross read
    (8, 40, 20, 64, False, "stair"),      # Whisper's step
    (64, 256, 16, 64, False, "stair"),    # gpt2_medium's step
    (16, 64, 4, 16, False, "stair"),      # head_dim 16
    (4, 700, 8, 128, True, "key"),        # int8 codes, head_dim 128
    (3, 384, 12, 64, False, "none_row"),  # a slot that attends nothing
])
def test_row_scan_matches_plain(card, dtype, B, S, N, H, int8, kind):
    """Kernel 2 at R = Tq * G = 1 takes the single-row scan and gives the
    plain version's result (a row that attends nothing: the mean of V)."""
    gen = torch.Generator(device=card).manual_seed(S + H + int8)
    q, k, v, ks, vs = _row_case(gen, B, S, N, H, dtype, card, int8)
    if kind == "key":
        mask = _key_rows(gen, B, S, card)
    else:
        lens = torch.randint(0, S, (B,), generator=gen, device=card)
        mask = _slab_window(lens, 1, S, card)
        if kind == "none_row":
            mask[1] = False
    before = dict(dec.launches_by_body)
    out = dec.decode_attention(q, k, v, mask=mask, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert _body_delta(dec.launches_by_body, before) == {"row": 1}
    ref = dec.decode_attention_plain(q, k, v, fl.keep_mask(mask, B, 1, S),
                                     k_scale=ks, v_scale=vs)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    _, counters = dec._workspaces[q.device.index]
    assert int(counters.abs().sum().item()) == 0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_scan_slab_and_paged_bit_identical(card, dtype, int8):
    """Kernels 2 and 3 at G = 1 over 1500 positions (the slab) and the same
    positions cut into 128-position pages (12 pages: 1536 positions): the
    same splits, tiles and merge, so the same bits."""
    gen = torch.Generator(device=card).manual_seed(1500 + int8)
    B, S, N, H, ps, NP = 8, 1500, 20, 64, 128, 12
    q, k, v, ks, vs = _row_case(gen, B, S, N, H, dtype, card, int8)
    lengths = torch.tensor([1499, 1200, 1152, 1151, 383, 384, 64, 0],
                           dtype=torch.int32, device=card)
    perm = torch.randperm(B * NP, generator=gen, device=card)
    table = perm.reshape(B, NP).to(torch.int32)
    flat = table.long().reshape(-1)

    def pages(x):
        full = torch.zeros((B, NP * ps) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=card)
        full[:, :S] = x
        out = torch.empty((B * NP, ps) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=card)
        out[flat] = full.reshape((-1, ps) + tuple(x.shape[2:]))
        return out

    before = dict(dec.launches_by_body)
    paged = dec.paged_decode_attention(
        q, pages(k), pages(v), table, lengths,
        k_scale=None if ks is None else pages(ks),
        v_scale=None if vs is None else pages(vs))
    slab = dec.decode_attention(q, k, v,
                                mask=paged_window_mask(lengths, S, 1),
                                k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert _body_delta(dec.launches_by_body, before) == {"row": 2}
    assert torch.equal(paged, slab)


@pytest.mark.parametrize("Tq", [2, 8])
def test_decode_scan_reads_key_rows_and_padded_rows(card, Tq):
    """Kernel 2's DecodeScan body (R >= 2) on the keep-mask layouts at an
    unaligned S: a key row (row stride 0) and dense rows padded to 16."""
    gen = torch.Generator(device=card).manual_seed(Tq)
    B, S, N, K, H = 4, 1500, 8, 8, 64
    q = _rand(gen, (B, Tq, N, H), torch.bfloat16, card)
    k = _rand(gen, (B, S, K, H), torch.bfloat16, card)
    v = _rand(gen, (B, S, K, H), torch.bfloat16, card)
    for mask in (_key_rows(gen, B, S, card),
                 torch.rand((B, 1, Tq, S), generator=gen, device=card) < 0.5):
        keep = fl.keep_mask(mask, B, Tq, S)
        out = dec.decode_attention(q, k, v, mask=keep[:, None])
        torch.cuda.synchronize()
        ref = dec.decode_attention_plain(q, k, v, keep)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
