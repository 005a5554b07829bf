"""The cross-process shm serving bridge, on the port's modules (CPU).

The cases of ``tests/test_shm_bridge.py`` against the port's
``engine/shm_bridge.py``: the payload codec (and its bytes equal to the
JAX package's), an in-process roundtrip through a port ``Replica``, a
replica error carried back to the frontend, one batch pop draining a
burst, a frontend in a spawned process, and the ring's wait counted
against the SLO. Beside them: llama_tiny served by the port through the
bridge gives the JAX engine's greedy tokens. Names carry the pid and a
uuid; every bridge, frontend and replica is closed in a ``finally``.
"""

import multiprocessing as mp
import os
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine import shm_bridge as j_bridge
from ray_dynamic_batching_tpu_torch.engine.request import now_ms
from ray_dynamic_batching_tpu_torch.engine.shm_bridge import (
    ShmBridge,
    ShmFrontend,
    _decode_value,
    _encode_value,
)
from ray_dynamic_batching_tpu_torch.serve import Replica

torch.set_num_threads(2)
STORE = 16 << 20   # well inside a container's default /dev/shm


def _name(tag):
    return f"/rdbtb_{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def double_batch(payloads):
    return [np.asarray(p) * 2 for p in payloads]


def _pair(name, submit, **kw):
    bridge = ShmBridge(name, submit=submit, store_bytes=STORE, **kw)
    return bridge, ShmFrontend(name, store_bytes=STORE)


VALUES = [np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32),
          np.arange(6, dtype=np.int64).reshape(2, 3),
          {"a": [1, 2, 3], "b": "text"}, [1.5, None], 7]


class TestCodec:
    @pytest.mark.parametrize("value", VALUES, ids=[f"v{i}" for i in
                                                   range(len(VALUES))])
    def test_roundtrip_and_bytes_equal_the_jax_codec(self, value):
        data = _encode_value(value)
        assert data == j_bridge._encode_value(value)
        back = _decode_value(data)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(back, value)
            assert back.dtype == value.dtype
        else:
            assert back == value

    def test_unknown_tag(self):
        with pytest.raises(ValueError):
            _decode_value(b"XXXXjunk")


class TestInProcess:
    def test_roundtrip_through_replica(self):
        rep = Replica("r0", "doubler", double_batch, max_batch_size=8,
                      batch_wait_timeout_s=0.005)
        rep.start()
        name = _name("inproc")
        bridge, fe = _pair(name, rep.assign)
        bridge.start()
        try:
            x = np.arange(6, dtype=np.float32).reshape(2, 3)
            oid = fe.submit("doubler", x, slo_ms=5000)
            np.testing.assert_array_equal(fe.get_result(oid, timeout_s=10),
                                          x * 2)
            assert bridge.pumped == 1
        finally:
            fe.close(unlink=False)
            bridge.stop()
            rep.stop()

    def test_error_propagates(self):
        def boom(payloads):
            raise RuntimeError("model exploded")

        rep = Replica("r0", "boom", boom, max_batch_size=4,
                      batch_wait_timeout_s=0.005)
        rep.start()
        bridge, fe = _pair(_name("err"), rep.assign)
        bridge.start()
        try:
            oid = fe.submit("boom", [1.0], slo_ms=5000)
            with pytest.raises(RuntimeError, match="model exploded"):
                fe.get_result(oid, timeout_s=10)
        finally:
            fe.close(unlink=False)
            bridge.stop()
            rep.stop()

    def test_batch_pop_drains_many_in_one_sweep(self):
        got = []
        bridge, fe = _pair(_name("batch"), lambda r: got.append(r) or True)
        try:
            for i in range(20):
                fe.submit("m", float(i), slo_ms=1000)
            assert bridge.pump_once(timeout_ms=100) == 20
            assert sorted(r.payload for r in got) == [float(i)
                                                      for i in range(20)]
        finally:
            fe.close(unlink=False)
            bridge.stop()

    def test_rejected_request_reports_back(self):
        bridge, fe = _pair(_name("rej"), lambda r: False)
        try:
            oid = fe.submit("m", 1.0, slo_ms=1000)
            assert bridge.pump_once(timeout_ms=100) == 0
            assert bridge.errors == 1
            with pytest.raises(RuntimeError, match="engine rejected"):
                fe.get_result(oid, timeout_s=5)
        finally:
            fe.close(unlink=False)
            bridge.stop()


def _frontend_proc(name: str, n: int, ok_queue):
    import numpy as np

    from ray_dynamic_batching_tpu_torch.engine.shm_bridge import ShmFrontend

    fe = ShmFrontend(name, store_bytes=16 << 20)
    try:
        oids = [fe.submit("doubler", np.full((3,), i, np.float32), 5000.0)
                for i in range(n)]
        ok_queue.put(sum(
            np.array_equal(fe.get_result(oid, timeout_s=30),
                           np.full((3,), 2 * i, np.float32))
            for i, oid in enumerate(oids)))
    finally:
        fe.close(unlink=False)


class TestCrossProcess:
    def test_frontend_in_separate_process(self):
        name = _name("xproc")
        rep = Replica("r0", "doubler", double_batch, max_batch_size=8,
                      batch_wait_timeout_s=0.005)
        rep.start()
        bridge = ShmBridge(name, submit=rep.assign,
                           store_bytes=STORE).start()
        ctx = mp.get_context("spawn")
        p = None
        try:
            ok_queue = ctx.Queue()
            p = ctx.Process(target=_frontend_proc, args=(name, 8, ok_queue))
            p.start()
            p.join(timeout=90)
            assert p.exitcode == 0
            assert ok_queue.get(timeout=5) == 8
        finally:
            if p is not None and p.is_alive():
                p.kill()
                p.join(5)
            bridge.stop()
            rep.stop()


class TestArrivalPreserved:
    def test_queue_wait_counts_against_slo(self):
        got = []
        bridge, fe = _pair(_name("age"), lambda r: got.append(r) or True)
        try:
            before = now_ms()
            fe.submit("m", 1.0, slo_ms=1000)
            time.sleep(0.2)
            bridge.pump_once(timeout_ms=100)
            assert len(got) == 1
            assert got[0].arrival_ms == pytest.approx(before, abs=50)
            assert got[0].queue_delay_ms() >= 200 - 50
        finally:
            fe.close(unlink=False)
            bridge.stop()


def test_llm_through_the_bridge_gives_the_jax_engines_tokens():
    """llama_tiny in the port, fed by a frontend over shm into the
    replica's ``assign``: the greedy tokens of the JAX package's
    deployment with the same weights."""
    from ray_dynamic_batching_tpu.engine.request import Request as JRequest
    from ray_dynamic_batching_tpu.models import causal_lm as j_lm
    from ray_dynamic_batching_tpu.serve import llm as j_llm
    from ray_dynamic_batching_tpu.serve.controller import DeploymentConfig
    from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
    from ray_dynamic_batching_tpu_torch.models.convert import (
        params_from_flax,
    )
    from ray_dynamic_batching_tpu_torch.serve import llm as t_llm
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig as TDeploymentConfig,
    )

    knobs = dict(num_slots=2, max_len=64, prompt_buckets=[8],
                 default_max_new_tokens=5, warmup=False)
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    prompts = [[5, 9, 2, 7], [11, 3, 8], [1, 2, 3, 4, 5, 6]]
    jrep = j_llm.LLMDeployment("llama_tiny", model=jm, params=params,
                               dtype=jnp.float32, **knobs).make_replica(
        "j", DeploymentConfig(name="llama_tiny"))
    jrep.start()
    try:
        reqs = [JRequest(model="llama_tiny", slo_ms=1e7,
                         payload={"tokens": p}) for p in prompts]
        for r in reqs:
            assert jrep.assign(r)
        want = [r.future.result(timeout=120).tokens for r in reqs]
    finally:
        jrep.stop(timeout_s=5.0, drain=False)
    trep = t_llm.LLMDeployment("llama_tiny", model=tm, device="cpu",
                               **knobs).make_replica(
        "t", TDeploymentConfig(name="llama_tiny"))
    trep.start()
    bridge, fe = _pair(_name("llm"), trep.assign)
    bridge.start()
    try:
        oids = [fe.submit("llama_tiny", {"tokens": p}, slo_ms=1e7)
                for p in prompts]
        got = [fe.get_result(o, timeout_s=120)["tokens"] for o in oids]
    finally:
        fe.close(unlink=False)
        bridge.stop()
        trep.stop(timeout_s=5.0, drain=False)
    assert got == want and all(len(t) == 5 for t in got)
