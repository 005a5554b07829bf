"""Kernel 4 — the paged decode kernel per kv-head shard — against the JAX
package's ``shard_map`` wrapper (CPU).

The reference's ``_paged_decode_attention_tp`` runs kernel 3 on each
shard of the kv heads under ``shard_map`` (q rows and pools split on the
heads, the page table and lengths replicated). The port runs it per rank:
``paged_decode_attention(..., mesh=)`` on the rank's shard, reached through
the dispatcher inside ``tensor_parallel``; ``paged_decode_attention_tp``
runs the ``tp`` shards of a whole call in one process. On the CPU each
shard takes kernel 3's plain version. Both forms, concatenated over the
shards, must equal JAX's ``paged_decode_attention(mesh=)`` in interpret
mode within ``2e-6 * max(1, max|out|)`` (f32 and int8 pools, tp 2 and 4,
plain decode and a 5-row verify window), and decline where it declines
(the reference's cases, ``tests/test_tp_paged_decode.py:122-180``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.ops import decode_attention as j_da
from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
from ray_dynamic_batching_tpu_torch.ops import attention as t_attn
from ray_dynamic_batching_tpu_torch.ops import decode_attention as t_da
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh

from tests import torch_ranks

B, N, K, H, P, PS = 3, 8, 4, 32, 10, 128
TABLE = np.asarray([[3, 7], [1, P], [5, 0]], np.int32)
LENGTHS = np.asarray([200, 100, 37], np.int32)


def _pool(kind: str, tq: int, seed: int = 0):
    """q [B, tq, N, H] over pools [P, ps, K, H] (int8 codes with scales,
    or f32): slot 1 has one page (sentinel tail), slot 2 a short run."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, tq, N, H)).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-127, 127, (P, PS, K, H)).astype(np.int8)
        v = rng.integers(-127, 127, (P, PS, K, H)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (P, PS, K)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (P, PS, K)).astype(np.float32)
    else:
        k = rng.standard_normal((P, PS, K, H)).astype(np.float32)
        v = rng.standard_normal((P, PS, K, H)).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs


def _jax(x, tp):
    q, k, v, ks, vs = x
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=tp), jax.devices()[:tp])
    opt = (lambda a: None if a is None else jnp.asarray(a))
    out = j_da.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(TABLE),
        jnp.asarray(LENGTHS), k_scale=opt(ks), v_scale=opt(vs),
        interpret=True, mesh=jmesh)
    return None if out is None else np.asarray(out)


def _port_tp(x, tp):
    q, k, v, ks, vs = x
    opt = (lambda a: None if a is None else torch.from_numpy(a))
    out = t_da.paged_decode_attention_tp(
        opt(q), opt(k), opt(v), opt(TABLE), opt(LENGTHS), tp=tp,
        k_scale=opt(ks), v_scale=opt(vs))
    return None if out is None else out.numpy()


def _close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=2e-6 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def world():
    mesh = t_mesh.build_mesh(t_mesh.MeshConfig(tp=2), ["cpu"] * 2)
    try:
        yield mesh
    finally:
        mesh.shutdown()


@pytest.mark.parametrize("tq", [1, 5], ids=["decode", "verify"])
@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_concatenated_equal_jax_shard_map(kind, tp, tq):
    """The tp shards' launches in one process, concatenated on the heads,
    equal the JAX TP kernel; and (per-head numerics) the unsharded
    port kernel exactly."""
    x = _pool(kind, tq)
    want = _jax(x, tp)
    got = _port_tp(x, tp)
    assert want is not None and got is not None
    _close(got, want)
    np.testing.assert_array_equal(got, _port_tp(x, 1))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_each_rank_launches_its_shard_through_the_dispatcher(world, kind):
    """Each rank of a tp-2 gloo world holds its kv-head shard and reads it
    through ``dot_product_attention(page_table=...)`` inside
    ``tensor_parallel`` (the TP engine's decode read): the ranks' outputs,
    concatenated, equal the JAX TP kernel. With the heads marked
    replicated the route declines to the gather path, same numbers."""
    x = _pool(kind, 1, seed=3)
    want = _jax(x, 2)
    for split in (True, False):
        outs = world.world.call(torch_ranks.kernel4_rank, *x[:3], TABLE,
                                LENGTHS, *x[3:], split)
        _close(np.concatenate(outs, axis=2), want)


def test_declines_on_indivisible_heads_as_jax_does():
    """K = 4 kv heads (N = 8) under tp 8: the JAX wrapper declines, and so
    does the port's; a shape outside the pattern declines too."""
    x = _pool("f32", 1)
    assert _jax(x, 8) is None
    assert _port_tp(x, 8) is None
    q, k, v, _, _ = x
    wide = np.zeros((B, 9, N, H), np.float32)
    assert _port_tp((wide, k, v, None, None), 2) is None
    assert j_da.paged_decode_attention(
        jnp.asarray(wide), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(TABLE), jnp.asarray(LENGTHS), interpret=True) is None


def test_tp_launch_counts_apart_and_context_is_scoped(world):
    """On the CPU no kernel launches, so no count moves; the TP context is
    a ContextVar, gone outside its ``with``."""
    t_attn.reset_counts()
    world.world.call(torch_ranks.kernel4_rank, *_pool("f32", 1)[:3], TABLE,
                     LENGTHS, None, None, True)
    counts = world.world.call(torch_ranks.launch_counts)
    assert all(v == 0 for c in counts for v in c.values())
    assert t_attn._TP_CTX.get() is None
    with t_attn.tensor_parallel(world, "tp"):
        assert t_attn._TP_CTX.get() == (world, "tp", True)
    assert t_attn._TP_CTX.get() is None
