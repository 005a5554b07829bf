"""The port's ring attention against the JAX package's dense attention (CPU).

``ops/ring_attention.py`` ports the reference's ring (a query chunk stays
resident, K/V chunks rotate over the ``sp`` group) as an autograd
function whose backward re-runs the ring. Each case mirrors one of
``tests/test_ring_attention.py``: the same numpy inputs go through the
JAX package's ``dot_product_attention`` (XLA on the CPU) and its
``jax.vjp``, and through the port's ring on gloo CPU ranks, each rank
holding its contiguous sequence chunk. Forward within 2e-5 and gradients
within 2e-4 absolute (f32), the reference test's tolerances. The worlds
(sp 2 and sp 4) are spawned once for the module.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.ops import attention as j_attn
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh

from tests import torch_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds():
    built = {}
    try:
        for sp in (2, 4):
            built[sp] = t_mesh.build_mesh(t_mesh.MeshConfig(sp=sp),
                                          ["cpu"] * sp)
        yield built
    finally:
        for mesh in built.values():
            mesh.shutdown()


def _dense_vjp(q, k, v, token_mask, dout, causal):
    def f(q, k, v):
        return j_attn.dot_product_attention(
            q, k, v, causal=causal,
            mask=jnp.asarray(token_mask)[:, None, None, :].astype(bool))

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _ring(mesh, q, k, v, token_mask, dout, causal):
    """Every rank's chunk of (out, dq, dk, dv), concatenated over sp."""
    per = mesh.world.call(torch_ranks.ring_case, q, k, v, token_mask, dout,
                          causal)
    return [np.concatenate([r[i] for r in per], axis=1) for i in range(4)]


CASES = {
    # (sp, B, T, N, K, H, lengths or None, causal): the reference's cases.
    "causal_sp4": (4, 2, 32, 4, 4, 8, None, True),
    "causal_sp2": (2, 2, 32, 4, 4, 8, None, True),
    "gqa_padding_sp4": (4, 2, 24, 8, 2, 16, (17, 9), True),
    "non_causal_sp4": (4, 1, 16, 2, 2, 8, None, False),
    "gqa_padding_sp2": (2, 2, 24, 8, 2, 16, (17, 9), True),
}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_matches_dense(worlds, case):
    sp, B, T, N, K, H, lengths, causal = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = rng.standard_normal((B, T, N, H)).astype(np.float32)
    k = rng.standard_normal((B, T, K, H)).astype(np.float32)
    v = rng.standard_normal((B, T, K, H)).astype(np.float32)
    dout = rng.standard_normal((B, T, N, H)).astype(np.float32)
    mask = np.ones((B, T), bool)
    if lengths is not None:
        mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    want = _dense_vjp(q, k, v, mask, dout, causal)
    got = _ring(worlds[sp], q, k, v, mask, dout, causal)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=2e-4)
