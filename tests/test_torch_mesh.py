"""The port's meshes and sharding against the JAX package's (CPU).

``parallel/mesh.py`` ports the reference's ``MeshConfig``, ``build_mesh``,
``_feasible_spec``, ``param_shardings`` / ``shard_params`` and the sharded
cache allocators onto one process per rank (gloo on CPU devices). Each
rank's slice of ``llama_tiny`` must equal the matching
``addressable_shards`` entry of the JAX package's ``shard_params`` on the
fake CPU devices ``tests/conftest.py`` sets up, in the port's layout, at
tp 2 (every head axis cut) and tp 4 (the 2 kv heads replicate while q
stays cut). Each gloo world is spawned once for the module.
"""

from __future__ import annotations

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.parallel import mesh as j_mesh
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.parallel import mesh as t_mesh

from tests import torch_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lm():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def worlds():
    built = {}
    try:
        for tp in (2, 4):
            built[tp] = t_mesh.build_mesh(t_mesh.MeshConfig(tp=tp),
                                          ["cpu"] * tp)
        yield built
    finally:
        for mesh in built.values():
            mesh.shutdown()


# --- MeshConfig and build_mesh, over the reference's cases -------------------
@pytest.mark.parametrize("args", [
    (8,), (4, None, 2), (8, 2, 2), (3,), (1,), (16, 2),
])
def test_mesh_config_auto_matches_jax(args):
    assert vars(t_mesh.MeshConfig.auto(*args)) == vars(
        j_mesh.MeshConfig.auto(*args))
    assert t_mesh.AXIS_ORDER == j_mesh.AXIS_ORDER


@pytest.mark.parametrize("args", [(7, None, 2), (8, 3)])
def test_mesh_config_auto_refusals_match_jax(args):
    with pytest.raises(ValueError):
        j_mesh.MeshConfig.auto(*args)
    with pytest.raises(ValueError):
        t_mesh.MeshConfig.auto(*args)


def test_build_mesh_refusals_start_no_process():
    """Too few devices is the reference's ValueError (on any axis: dp,
    sp, pp and ep are active now); NCCL on a card listed twice, a shared
    card with no backend named, CPU devices under NCCL and an unknown
    backend raise before any process starts."""
    before = len(multiprocessing.active_children())
    with pytest.raises(ValueError, match="devices"):
        j_mesh.build_mesh(j_mesh.MeshConfig(dp=1000))
    with pytest.raises(ValueError, match="devices"):
        t_mesh.build_mesh(t_mesh.MeshConfig(dp=1000), ["cpu"] * 2)
    with pytest.raises(ValueError, match="devices"):
        t_mesh.build_mesh(t_mesh.MeshConfig(dp=2, sp=2), ["cpu"] * 2)
    card = [torch.device("cuda", 0)] * 4
    with pytest.raises(ValueError, match="NCCL"):
        t_mesh.build_mesh(t_mesh.MeshConfig(tp=4), card, backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        t_mesh.build_mesh(t_mesh.MeshConfig(tp=4), card)
    with pytest.raises(ValueError, match="nccl"):
        t_mesh.build_mesh(t_mesh.MeshConfig(tp=2), ["cpu"] * 2,
                          backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        t_mesh.build_mesh(t_mesh.MeshConfig(tp=2), ["cpu"] * 2,
                          backend="mpi")
    assert len(multiprocessing.active_children()) == before


def test_single_device_meshes():
    mesh = t_mesh.single_device_mesh("cpu")
    assert mesh.shape == {"dp": 1, "pp": 1, "sp": 1, "tp": 1, "ep": 1}
    assert mesh.device == torch.device("cpu") and mesh.world is None
    one = t_mesh.build_mesh(t_mesh.MeshConfig(), ["cpu"])
    assert one.size == 1 and one.tp is None
    assert t_mesh.replicate(mesh, {"a": (torch.ones(2),)})["a"][0].tolist() \
        == [1.0, 1.0]
    assert t_mesh.multihost_init() == j_mesh.multihost_init() == {
        "process_index": 0, "process_count": 1}


@pytest.mark.parametrize("spec,shape,tp", [
    ((None, "tp", None), (64, 4, 16), 2),
    ((None, "tp", None), (64, 2, 16), 4),
    (("tp", None), (512, 64), 4),
    ((None, ("dp", "tp")), (64, 128), 2),
    ((None, "tp"), (64, 6), 4),
])
def test_feasible_spec_matches_jax(spec, shape, tp, eight_devices):
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=tp), eight_devices[:tp])
    want = j_mesh._feasible_spec(P(*spec), shape, jmesh)
    tmesh = t_mesh.Mesh({"tp": tp}, ["cpu"] * tp)
    assert t_mesh._feasible_spec(spec, shape, tmesh) == tuple(want)


# --- shards of llama_tiny ----------------------------------------------------
def _leaf(tree, path):
    node = tree["params"]
    for part in path.split("/"):
        node = node[part]
    return node


def _port_layout(path: str, x: np.ndarray) -> np.ndarray:
    """A flax leaf (or shard) in the port's layout."""
    if path.endswith(("/q/kernel", "/k/kernel", "/v/kernel")):
        return x.reshape(x.shape[0], -1).T
    if path.endswith("/o/kernel"):
        return x.reshape(-1, x.shape[-1]).T
    if path.endswith("/kernel"):
        return x.T
    return x


def _jax_shards(params, jm, tp, devices):
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=tp), devices[:tp])
    sharded = j_mesh.shard_params(jmesh, jm, params)
    return jmesh, sharded


@pytest.mark.parametrize("tp", [2, 4])
def test_param_shardings_match_jax(lm, tp, eight_devices):
    jm, params, tm = lm
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=tp), eight_devices[:tp])
    jspecs = j_mesh.param_shardings(jmesh, jm, params)
    tmesh = t_mesh.Mesh({"tp": tp}, ["cpu"] * tp)
    tspecs = t_mesh.param_shardings(tmesh, tm)
    for name, (path, *_rest) in tm.flax_leaves().items():
        want = _leaf(jspecs, path).spec
        got = tspecs[name]
        assert tuple(got) + (None,) * (len(want) - len(got)) == \
            tuple(want) + (None,) * (len(got) - len(want)), name


@pytest.mark.parametrize("tp", [2, 4])
def test_each_rank_holds_the_jax_addressable_shard(lm, worlds, tp,
                                                   eight_devices):
    """Rank r's every parameter equals the JAX shard on device r, in the
    port's layout (q/k/v/o cut by heads, gate/up/down by MLP columns,
    embedding and head by vocabulary rows; at tp 4 the 2 kv heads and
    their projections replicate)."""
    jm, params, tm = lm
    mesh = worlds[tp]
    shard = t_mesh.shard_params(mesh, tm)
    try:
        states = mesh.world.call(torch_ranks.shard_state,
                                 shard.tp_shard.key)
        layouts = mesh.world.call(torch_ranks.sharded_layout,
                                  shard.tp_shard.key)
    finally:
        t_mesh_drop(mesh, shard)
    jmesh, sharded = _jax_shards(params, jm, tp, eight_devices)
    devices = list(jmesh.devices.reshape(-1))
    for name, (path, *_rest) in tm.flax_leaves().items():
        leaf = _leaf(sharded, path)
        by_device = {s.device: np.asarray(s.data)
                     for s in leaf.addressable_shards}
        for r in range(tp):
            want = _port_layout(path, by_device[devices[r]])
            np.testing.assert_array_equal(states[r][name], want,
                                          err_msg=f"{name} rank {r}")
    kv_cut = tp == 2
    for r, layout in enumerate(layouts):
        assert layout["heads"] == (4 // tp, 2 // tp if kv_cut else 2)
        assert layout["heads_split"] == kv_cut
        assert layout["kv_window"] == (None if kv_cut else (r // 2, 1))
        assert layout["vocab_rows"] == (r * 512 // tp, 512 // tp)
        assert layout["gather_logits"] and layout["o_reduce"]
        assert layout["kv_heads"] == (1 if kv_cut else 2)


def t_mesh_drop(mesh, shard):
    from ray_dynamic_batching_tpu_torch.parallel import spmd

    spmd.drop_objects(mesh.world, shard.tp_shard.key)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_sharded_caches_match_jax_shard_shapes(lm, worlds, tp, kv,
                                               eight_devices):
    """Each rank's slab cache and paged pool (scale planes included on an
    int8 cache) have the shapes of the JAX shards; lengths and the page
    table are whole on every rank."""
    jm, params, tm = lm
    name = "llama_tiny" if kv == "f32" else "llama_tiny_int8kv"
    jdtype = None if kv == "f32" else jnp.int8
    jmodel = j_lm.CausalLM(j_lm.TINY_LM, name=name, dtype=jnp.float32,
                           kv_dtype=jdtype)
    tmodel = t_lm.CausalLM(t_lm.TINY_LM, name=name, dtype=torch.float32,
                           device="cpu", seed=0,
                           kv_dtype=None if kv == "f32" else torch.int8)
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tp=tp), eight_devices[:tp])
    mesh = worlds[tp]
    shard = t_mesh.shard_params(mesh, tmodel)
    try:
        slab = t_mesh.make_sharded_cache(mesh, shard, 3, 64)
        pool = t_mesh.make_sharded_paged_cache(mesh, shard, 3, 5, 128, 256)
        jslab = j_mesh.make_sharded_cache(jmesh, jmodel, 3, 64)
        jpool = j_mesh.make_sharded_paged_cache(jmesh, jmodel, 3, 5, 128, 256)
        for mine, theirs, sink in ((slab, jslab, False), (pool, jpool, True)):
            for field in ("k", "v", "k_scale", "v_scale", "lengths",
                          "page_table"):
                if not hasattr(theirs, field):
                    continue
                t, j = getattr(mine, field), getattr(theirs, field)
                assert (t is None) == (j is None), field
                if t is None:
                    continue
                want = list(j.sharding.shard_shape(j.shape))
                if sink and field in ("k", "v", "k_scale", "v_scale"):
                    want[1] += 1   # the port's pool keeps a sink page
                assert list(t.shape) == want, (field, t.shape, want)
        with pytest.raises(ValueError, match="not sharded"):
            t_mesh.make_sharded_cache(mesh, tmodel, 3, 64)
    finally:
        t_mesh_drop(mesh, shard)


def test_seeded_shards_are_slices_of_the_seeded_model(worlds):
    """``build_sharded_model`` draws the weights from the seed on every
    rank and keeps each rank's slice: the numbers of the unsharded model
    built from the same seed, cut as ``shard_params`` cuts them."""
    mesh = worlds[2]
    whole = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny",
                          dtype=torch.float32, device="cpu", seed=3)
    seeded = t_mesh.build_sharded_model(
        mesh, t_lm.CausalLM, t_lm.TINY_LM, "llama_tiny",
        dtype=torch.float32, seed=3)
    cut = t_mesh.shard_params(mesh, whole)
    try:
        a = mesh.world.call(torch_ranks.shard_state, seeded.tp_shard.key)
        b = mesh.world.call(torch_ranks.shard_state, cut.tp_shard.key)
    finally:
        t_mesh_drop(mesh, seeded)
        t_mesh_drop(mesh, cut)
    for r in range(2):
        assert a[r].keys() == b[r].keys()
        for name in a[r]:
            np.testing.assert_array_equal(a[r][name], b[r][name])


def test_unsupported_models_refuse_before_any_rank_works(worlds):
    from ray_dynamic_batching_tpu_torch.models.quant import quantize_tree

    mesh = worlds[2]
    seq = mesh.world._seq
    q = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                      device="cpu", seed=0)
    quantize_tree(q)
    with pytest.raises(ValueError, match="int8"):
        t_mesh.shard_params(mesh, q)
    assert mesh.world._seq == seq


def test_pin_slice_builds_the_slice_mesh_from_its_bundle():
    """``pin_slice`` of a 2-chip shape reserves one gang bundle and builds
    its TP mesh from exactly those devices (reference
    ``placement.py:70-98``); a 1-chip shape returns no mesh; releasing
    the group and ending the mesh leave the manager whole and no rank."""
    from ray_dynamic_batching_tpu_torch.parallel import placement as t_pl

    class Placed:
        process_index = 0
        platform = "cpu"
        torch_device = torch.device("cpu")

        def __init__(self, id):
            self.id = id

    mgr = t_pl.PlacementManager([Placed(i) for i in range(3)])
    pg, mesh = t_pl.pin_slice(mgr, "1x2")
    procs = list(mesh.world._procs)
    try:
        assert pg.total_chips == 2 and mgr.free_chips() == {0: 1}
        assert mesh.shape["tp"] == 2 and mesh.backend == "gloo"
        assert mesh.devices == [torch.device("cpu")] * 2
        one, no_mesh = t_pl.pin_slice(mgr, "1x1")
        assert no_mesh is None and mgr.free_chips() == {0: 0}
        mgr.remove(one)
    finally:
        mesh.shutdown()
        mgr.remove(pg)
    assert mgr.free_chips() == {0: 3}
    assert not any(p.is_alive() for p in procs)


def test_a_failing_rank_fails_the_world_loudly():
    """A follower that raises makes the call raise ``WorldError`` with its
    traceback; the world refuses further work, and shutting it down still
    ends every rank."""
    from ray_dynamic_batching_tpu_torch.parallel import spmd

    mesh = t_mesh.build_mesh(t_mesh.MeshConfig(tp=2), ["cpu"] * 2)
    procs = list(mesh.world._procs)
    try:
        assert mesh.world.call(torch_ranks.fail_on, 5) == [0, 1]
        with pytest.raises(spmd.WorldError, match="fails on purpose"):
            mesh.world.call(torch_ranks.fail_on, 1)
        assert mesh.world.failed
        with pytest.raises(spmd.WorldError, match="failed earlier"):
            mesh.world.call(torch_ranks.fail_on, 5)
    finally:
        mesh.shutdown()
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(spmd.WorldError, match="shut down"):
        mesh.world.call(torch_ranks.fail_on, 5)
