"""The cost functions against shapes worked by hand."""

import json
from pathlib import Path

import pytest

from gpubench import costs

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def shapes(name):
    return costs.Shapes.of(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_mistral_parameters_and_pool():
    s = shapes("mistral-7b-v0.3")
    # q, o: 4096 x 4096; k, v: 4096 x 1024; gate, up, down: 4096 x 14336.
    assert costs.layer_weights(s) == 2 * 4096 * 4096 + 2 * 4096 * 1024 \
        + 3 * 4096 * 14336 == 218_103_808
    # 32 layers + the head + the embedding: the published 7.25 B.
    total = costs.body_weights(s) + 2 * costs.head_weights(s)
    assert total == 7_247_757_312
    # k and v, 32 layers, 8 kv heads of 128, bf16: 128 KiB a position;
    # the pool's 2048 pages of 128 positions hold 34.4 GB.
    assert costs.kv_bytes_per_position(s) == 131_072
    assert 2048 * 128 * costs.kv_bytes_per_position(s) == 34_359_738_368


def test_gpt2_medium_parameters_and_pool():
    s = shapes("gpt2-medium")
    assert s.head_dim == 64 and not s.gated
    assert costs.layer_weights(s) == 4 * 1024 * 1024 + 2 * 1024 * 4096
    assert costs.kv_bytes_per_position(s) == 2 * 24 * 16 * 64 * 2
    assert 2048 * 128 * costs.kv_bytes_per_position(s) == 25_769_803_776


def test_decode_step_is_bound_by_the_weights():
    s = shapes("mistral-7b-v0.3")
    w_bytes = (costs.body_weights(s) + costs.head_weights(s)) * 2
    # One step of 128 rows: 2 x 7.11 G x 128 FLOPs (1.8 ms at the peak)
    # against 14.2 GB of weights (4.2 ms at 3.35 TB/s): bytes bound.
    one = costs.gemm_least_s(s, steps=1, decode_tokens=128, prompt_tokens=0,
                             prompts=0)
    assert one == pytest.approx(w_bytes / costs.PEAK_HBM_BYTES)
    assert 4.2e-3 < one < 4.3e-3
    # Prompt tokens add their operations only.
    more = costs.gemm_least_s(s, steps=1, decode_tokens=128,
                              prompt_tokens=1000, prompts=2)
    extra = (2.0 * costs.body_weights(s) * 1000
             + 2.0 * costs.head_weights(s) * 2) / costs.PEAK_BF16_FLOPS
    assert more - one == pytest.approx(extra)


def test_wide_steps_are_bound_by_operations():
    s = shapes("gpt2-medium")
    rows = 4096    # past the card's 295 FLOPs a byte at 2 bytes a weight
    w = costs.body_weights(s) + costs.head_weights(s)
    got = costs.gemm_least_s(s, steps=2, decode_tokens=2 * rows,
                             prompt_tokens=0, prompts=0)
    assert got == pytest.approx(2 * 2.0 * w * rows / costs.PEAK_BF16_FLOPS)


def test_token_and_prompt_flops_by_hand():
    s = costs.Shapes(vocab=10, d_model=4, layers=1, heads=2, kv_heads=1,
                     head_dim=2, mlp_dim=3, gated=True, dtype_bytes=2)
    # q 4x4, k 4x2, v 4x2, o 4x4 = 48; gate, up, down 3 x 12 = 36.
    assert costs.layer_weights(s) == 84
    # A token over 5 keys: 2 x 84 + 4 x 1 x 2 x 2 x 5, + 2 x 40 head.
    assert costs.token_flops(s, 5, with_head=False) == 168 + 80
    assert costs.token_flops(s, 5, with_head=True) == 168 + 80 + 80
    # A prompt of 3: 3 tokens' products, 1 + 2 + 3 keys, one head row.
    assert costs.prompt_flops(s, 3) == 3 * 168 + 16 * 6 + 80
    # Decode attention: each key's k and v over every layer, read once.
    assert costs.decode_kv_least_s(s, 1000) == pytest.approx(
        1000 * (2 * 1 * 1 * 2 * 2) / costs.PEAK_HBM_BYTES)
