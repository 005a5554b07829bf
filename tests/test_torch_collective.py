"""The port's collective API on a gloo world of 4 against the JAX package's.

``parallel/collective.py`` ports ``CollectiveGroup`` and the named-group
API onto one process per rank: rank g holds slot g of the reference's
stacked arrays. Every op of the reference's cases
(``tests/test_collective.py``) runs on the four ranks of one spawned gloo
world and the ranks' results, stacked, must equal the JAX group's on the
same inputs over four fake CPU devices: exactly, or within 1e-6 where a
sum's order may differ (the sums, mean, reduce, reducescatter). The error
cases keep the reference's exception types.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.parallel import collective as j_col
from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
from ray_dynamic_batching_tpu_torch.parallel import collective as t_col
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh

from tests import torch_ranks

G = 4


@pytest.fixture(scope="module")
def world():
    mesh = t_mesh.build_mesh(t_mesh.MeshConfig(tp=G), ["cpu"] * G)
    try:
        yield mesh
    finally:
        mesh.shutdown()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((G, 3)).astype(np.float32),
            "rs": rng.standard_normal((G, G, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(world, inputs):
    """Every op's result on each rank, gathered by rank 0."""
    return world.world.call(torch_ranks.collective_ops, inputs)


@pytest.fixture(scope="module")
def jax_group():
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=G), jax.devices()[:G])
    return (j_col.CollectiveGroup(jmesh, "tp"),
            j_col.CollectiveGroup(jmesh, ("dp", "tp")))


def _stacked(ranks, op):
    return np.concatenate([r[op] for r in ranks], axis=0)


@pytest.fixture(scope="module")
def jax_ops(jax_group, inputs):
    """The JAX group's stacked result of every op."""
    group, multi = jax_group
    x = group.device_put(jnp.asarray(inputs["x"]))
    out = {op: group.allreduce(x, op) for op in ("sum", "max", "min", "mean")}
    out["multi_sum"] = multi.allreduce(multi.device_put(jnp.asarray(
        inputs["x"])))
    out["broadcast"] = group.broadcast(x, root=2)
    out["reduce"] = group.reduce(x, root=1)
    out["reducescatter"] = group.reducescatter(
        group.device_put(jnp.asarray(inputs["rs"])))
    out["send_recv"] = group.send_recv(x, src=0, dst=3)
    out["ring"] = group.permute(x, [(i, (i + 1) % G) for i in range(G)])
    out["rank_index"] = multi.rank_index()
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("op", [
    "sum", "max", "min", "mean", "multi_sum", "broadcast", "reduce",
    "reducescatter", "send_recv", "ring", "rank_index",
])
def test_op_equals_the_jax_group(ranks, jax_ops, op):
    want = jax_ops[op]
    got = _stacked(ranks, op)
    if op in ("sum", "mean", "multi_sum", "reducescatter", "reduce"):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_allgather_replicates_on_every_rank(ranks, jax_group, inputs):
    group, _ = jax_group
    want = np.asarray(group.allgather(group.device_put(
        jnp.asarray(inputs["x"]))))
    for r in range(G):
        np.testing.assert_array_equal(ranks[r]["allgather"], want)
        np.testing.assert_array_equal(ranks[r]["named_gather"], want)


def test_named_group_on_every_rank(ranks, inputs):
    for r in range(G):
        np.testing.assert_allclose(ranks[r]["named"], inputs["x"].sum(0,
                                   keepdims=True), atol=1e-6, rtol=0)
    assert not t_col.is_group_initialized("g2")


def test_group_lifecycle_and_errors_match_jax(world):
    """Registry lifecycle and the reference's error types, on rank 0."""
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=G), jax.devices()[:G])
    for col, mesh in ((j_col, jmesh), (t_col, world)):
        assert not col.is_group_initialized("g3")
        col.init_collective_group(mesh, "tp", group_name="g3")
        try:
            assert col.is_group_initialized("g3")
            with pytest.raises(ValueError):
                col.init_collective_group(mesh, "tp", group_name="g3")
        finally:
            col.destroy_collective_group("g3")
        assert not col.is_group_initialized("g3")
        with pytest.raises(KeyError):
            col.get_collective_group("g3")
        with pytest.raises(ValueError):
            col.CollectiveGroup(mesh, "nope")
    group = t_col.CollectiveGroup(world, "tp")
    assert group.size == G
    for bad in (torch.zeros((3, 2)), torch.zeros(())):
        with pytest.raises(ValueError):
            group.device_put(bad)
    with pytest.raises(ValueError):
        group.allreduce(torch.zeros(()))
    with pytest.raises(ValueError):
        group.allreduce(torch.zeros((1,)), op="prod")
    with pytest.raises(ValueError):
        group.reduce(torch.zeros((1,)), root=G)
    with pytest.raises(ValueError):
        group.send_recv(torch.zeros((1,)), src=0, dst=G)
    with pytest.raises(ValueError):
        group.reducescatter(torch.zeros((1, 3)))
    with pytest.raises(NotImplementedError):
        group.reducescatter(torch.zeros((1, G)), op="max")
    with pytest.raises(NotImplementedError):
        t_col.CollectiveGroup(world, ("dp", "tp")).permute(
            torch.zeros((1,)), [(0, 1)])
