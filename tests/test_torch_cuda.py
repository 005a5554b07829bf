"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card each test skips (decided inside the
test, never at import). Shapes cover what ``chip_smoke.py`` does not:
ragged KV tails, causal prefill with a diagonal offset, head_dim 64,
wide decode windows. This file imports no JAX, so it runs on a machine
without it::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: f32 1e-4 (the same math summed in another order), bf16 2e-2
(a couple of bf16 ulps at |x| < 4).
"""

import pytest
import torch

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


def test_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((1, 16, 4, 96), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fl.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        h = torch.zeros((1, 1, 4, 64), device=card, dtype=torch.float16)
        dec.decode_attention(h, h, h)
