"""The port's DistilBERT (``models/distilbert.py``) against the JAX
package's, on the CPU in f32.

- ``distilbert_tiny`` from flax params (``init(PRNGKey(0))``) converted by
  ``models/convert.distilbert_params_from_flax``, fed numpy token ids and
  ragged masks from a seed (padding rows keep key 0, as
  ``collate_text`` pads): logits within atol 1e-5 of the JAX model's (the
  same f32 math summed in another order) and the same argmax, at T = 16
  (the flash route), T = 8 (the decode route) and T = 12 (the plain
  route), the routes the reference takes.
- A batch collated by both packages' ``collate_text`` gives those logits
  too; ``ModelProfiler`` sweeps (batch, seq) rows of the tiny model.
- At full width (``distilbert_sst2``; shapes only, from ``jax.eval_shape``
  and torch's meta device): parameter counts, output shapes,
  ``example_inputs`` and ``flops_per_sample`` equal.
- A ``ReplicaEngine`` under the vision ``LiveScheduler`` serves the tiny
  model's requests at a seq bucket, each request's logits equal to the
  JAX model's on the same padded row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine import collate as j_collate
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import registry as j_reg
from ray_dynamic_batching_tpu_torch.engine import collate as t_collate
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import convert
from ray_dynamic_batching_tpu_torch.models import registry as t_reg
from ray_dynamic_batching_tpu_torch.ops import attention
from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler

torch.set_num_threads(2)

ATOL = 1e-5   # f32 logits: the same math in another summation order


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its numpy params, the port model with those weights)."""
    jm = j_reg.get_model("distilbert_tiny", dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = t_reg.get_model("distilbert_tiny", dtype=torch.float32,
                         device="cpu", seed=None)
    tm.module.load_state_dict(convert.distilbert_params_from_flax(params))
    return jm, params, tm.eval()


def _batch(rng, B, T):
    ids = rng.integers(0, 1000, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, T // 2:] = 0            # a ragged row
    mask[2, 1:] = 0                 # a padding row: key 0 only
    return ids, mask


@pytest.mark.parametrize("T,route", [(16, "flash"), (8, "decode"),
                                     (12, "plain")])
def test_tiny_logits_match_jax(pair, T, route):
    jm, params, tm = pair
    ids, mask = _batch(np.random.default_rng(T), 4, T)
    want = np.asarray(jm.apply(params, ids, mask))
    N, H = 4, 16
    assert attention.route((4, T, N, H), (4, T, N, H), causal=False,
                           mask_shape=(4, 1, T, T)) == route
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (4, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_converter_fills_every_weight(pair):
    jm, params, tm = pair
    sd = convert.distilbert_params_from_flax(params)
    assert set(sd) == set(tm.module.state_dict())
    assert tm.param_count() == jm.param_count(params)


def test_collated_batch_matches_jax(pair):
    """Ragged token ids through both packages' ``collate_text`` (padding
    rows keep key 0 valid) and both models."""
    jm, params, tm = pair
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 1000, n).astype(np.int32)
                for n in (5, 16, 11)]
    (jt, jmask), _ = j_collate.collate_text(
        None, [JRequest("m", p, slo_ms=1e4) for p in payloads], 4, 16)
    (tt, tmask), n = t_collate.collate_text(
        tm, [Request(model="m", payload=p, slo_ms=1e4) for p in payloads],
        4, 16)
    assert n == 3
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    want = np.asarray(jm.apply(params, jt, jmask))
    with torch.inference_mode():
        got = tm(tt, tmask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seq", [64, 128, 256])
def test_full_width_counts_shapes_and_flops(seq):
    jm = j_reg.get_model("distilbert_sst2")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    j_count = sum(int(np.prod(leaf.shape))
                  for leaf in jax.tree_util.tree_leaves(shapes))
    tm = t_reg.get_model("distilbert_sst2", device="meta", seed=None)
    assert tm.param_count() == j_count
    j_in = jm.example_inputs(2, seq)
    t_in = tm.example_inputs(2, seq)
    assert [tuple(x.shape) for x in t_in] == [x.shape for x in j_in]
    assert all(t.dtype == torch.int32 for t in t_in)
    with torch.inference_mode():
        out = tm(*t_in)
    assert tuple(out.shape) == (2, 2) and out.dtype == torch.float32
    assert tm.flops_per_sample(seq) == jm.flops_per_sample(seq)
    assert tm.family == jm.family == "text_classifier"
    assert (t_reg.get_slo("distilbert_sst2").latency_slo_ms
            == j_reg.get_slo("distilbert_sst2").latency_slo_ms == 100.0)


def test_seeded_weights_are_reproducible_and_finite():
    a = t_reg.get_model("distilbert_tiny", device="cpu", seed=5)
    b = t_reg.get_model("distilbert_tiny", device="cpu", seed=5)
    ids, mask = _batch(np.random.default_rng(1), 4, 16)
    with torch.inference_mode():
        la = a(torch.from_numpy(ids), torch.from_numpy(mask))
        lb = b(torch.from_numpy(ids), torch.from_numpy(mask))
    assert la.dtype == torch.float32 and torch.isfinite(la).all()
    assert torch.equal(la, lb)


def test_model_profiler_sweeps_seq_buckets(pair):
    _, _, tm = pair
    prof = ModelProfiler(tm, timing_iters=2, warmup_iters=1).sweep(
        batch_buckets=[1, 2], seq_buckets=[16, 32])
    assert [(r.batch_size, r.seq_len) for r in prof.rows] == [
        (1, 16), (2, 16), (1, 32), (2, 32)]
    assert all(r.latency_ms > 0 and r.hbm_bytes >= tm.param_bytes()
               for r in prof.rows)


def test_replica_engine_serves_the_classifier(pair):
    """The batch engine at seq bucket 16: each request's logits are the
    JAX model's on its padded row."""
    from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
    from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
    from ray_dynamic_batching_tpu_torch.engine.worker import ReplicaEngine
    from ray_dynamic_batching_tpu_torch.models.convert import (
        distilbert_params_from_flax,
    )
    from ray_dynamic_batching_tpu_torch.scheduler.control import (
        LiveScheduler,
    )
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        SquishyBinPacker,
    )

    jm, params, tm = pair
    host = ModelHost(device="cpu", model_kwargs={
        "distilbert_tiny": {"dtype": torch.float32}})
    model = host.acquire("distilbert_tiny")
    model.module.load_state_dict(distilbert_params_from_flax(params))
    prof = ModelProfiler(model, timing_iters=2, warmup_iters=1).sweep(
        batch_buckets=[1, 2, 4], seq_buckets=[16])
    queues = QueueManager()
    engine = ReplicaEngine("d0", queues, host)
    sched = LiveScheduler(SquishyBinPacker({"distilbert_tiny": prof}),
                          [engine], queues=queues)
    sched.register_model("distilbert_tiny", slo_ms=10_000.0, seq_len=16)
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 1000, n).astype(np.int32)
                for n in (3, 16, 9, 12)]
    engine.start()
    try:
        sched.rebalance(rates={"distilbert_tiny": 5.0})
        reqs = [Request(model="distilbert_tiny", payload=p, slo_ms=1e7)
                for p in payloads]
        for r in reqs:
            assert sched.submit_request(r)
        got = np.stack([r.future.result(timeout=60) for r in reqs])
    finally:
        engine.stop()
        host.release("distilbert_tiny")
    ids = np.zeros((4, 16), np.int32)
    mask = np.zeros((4, 16), np.int32)
    for i, p in enumerate(payloads):
        ids[i, :len(p)] = p
        mask[i, :len(p)] = 1
    want = np.asarray(jm.apply(params, ids, mask))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
