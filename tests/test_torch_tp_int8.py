"""Tensor-parallel serving from the int8 KV cache (CPU, f32 weights).

The int8-KV arms of ``tests/test_torch_tp_decode.py`` (its fixtures and
checks, its own gloo worlds of 2 and 4 CPU ranks): a TP engine over
llama_tiny with ``kv_dtype=int8`` — codes and scale planes cut on the kv
heads together — gives greedy streams identical to the JAX package's
single-device int8-KV engine on the slab, slab-train, paged chunked and
paged monolithic arms, at tp 2 and 4. And every rank really holds its
share: 1/tp of each cut weight and of the pool's kv heads (whole at tp 4,
where the 2 kv heads replicate), the page table and lengths whole.
"""

from __future__ import annotations

import pytest

from tests.test_torch_tp_decode import (  # noqa: F401 — fixtures
    ARMS,
    check_tp_streams,
    jax_tokens,
    models,
    params_and_caches_are_cut,
    sharded,
    worlds,
)


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_int8_kv_streams_identical_to_jax_single_device(
        sharded, worlds, jax_tokens, tp, arm):
    check_tp_streams(sharded, worlds, jax_tokens, tp, arm, "int8")


@pytest.mark.parametrize("tp", [2, 4])
def test_params_and_caches_are_cut_on_every_rank(models, sharded, worlds,
                                                 tp):
    params_and_caches_are_cut(models, sharded, worlds, tp)
