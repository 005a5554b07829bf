"""The port's request queue vs the JAX package's, driven identically.

Same requests (ids, classes, arrivals, SLOs) and the same operations go
to both queues; pops, sheds, stale discards and counters must agree.
"""

import numpy as np
import pytest

from ray_dynamic_batching_tpu.engine import queue as j_queue
from ray_dynamic_batching_tpu.engine import request as j_request
from ray_dynamic_batching_tpu_torch.engine import queue as t_queue
from ray_dynamic_batching_tpu_torch.engine import request as t_request

CLASSES = ("interactive", "standard", "best_effort")


def _pair(i, qos, arrival_ms, slo_ms):
    kw = dict(model="m", payload=None, slo_ms=slo_ms,
              request_id=f"r{i}", arrival_ms=arrival_ms, qos_class=qos)
    return j_request.Request(**kw), t_request.Request(**kw)


def _outcome(req):
    if not req.future.done():
        return "pending"
    exc = req.future.exception()
    return type(exc).__name__ if exc is not None else "ok"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_operations_same_results(seed):
    rng = np.random.default_rng(seed)
    now = j_request.now_ms()
    jq, tq = j_queue.RequestQueue("m", max_len=12), t_queue.RequestQueue(
        "m", max_len=12)
    pairs = []
    for i in range(40):
        qos = CLASSES[int(rng.integers(0, 3))]
        # Some requests are already past due (stale at pop), some not;
        # every deadline sits >= 400 ms from the staleness threshold, so
        # the microseconds between the two queues' pops cannot matter.
        arrival = now - 1000.0 * float(rng.integers(0, 3))
        slo = 1000.0 * float(rng.integers(0, 5)) + 500.0
        pairs.append(_pair(i, qos, arrival, slo))
    popped = []
    for i, (jr, tr) in enumerate(pairs):
        assert jq.add_request(jr) == tq.add_request(tr)
        if i % 5 == 4:
            jb = jq.get_batch(3, expected_latency_ms=100.0)
            tb = tq.get_batch(3, expected_latency_ms=100.0)
            popped.append(([r.request_id for r in jb],
                           [r.request_id for r in tb]))
    for jids, tids in popped:
        assert jids == tids
    assert [_outcome(j) for j, _ in pairs] == [_outcome(t) for _, t in pairs]
    js, ts = jq.stats(), tq.stats()
    for key in ("depth", "enqueued", "dropped", "stale"):
        assert js[key] == ts[key], key
    assert jq.class_stats() == tq.class_stats()


def test_anti_starvation_stride_matches():
    now = j_request.now_ms()
    jq, tq = j_queue.RequestQueue("m"), t_queue.RequestQueue("m")
    for i in range(30):
        qos = "interactive" if i < 20 else "best_effort"
        jr, tr = _pair(i, qos, now + i, 1e7)
        jq.add_request(jr)
        tq.add_request(tr)
    order_j = [r.request_id for r in jq.get_batch(30)]
    order_t = [r.request_id for r in tq.get_batch(30)]
    assert order_j == order_t
    assert order_t.index("r20") == j_queue.ANTI_STARVATION_STRIDE


def test_closed_queue_and_completion_accounting():
    tq = t_queue.RequestQueue("m")
    now = t_request.now_ms()
    done = t_request.Request(model="m", payload=None, slo_ms=50.0,
                             arrival_ms=now - 100.0)
    assert tq.record_batch_completion([done], completed_at_ms=now) == 1
    assert tq.slo_compliance() == 0.0
    tq.close()
    late = t_request.Request(model="m", payload=None, slo_ms=1e6)
    assert not tq.add_request(late)
    assert _outcome(late) == "RequestDropped"
    assert not tq.wait_for_requests(0.01)
    with pytest.raises(t_request.BadRequest):
        t_request.Request(model="m", payload=None, slo_ms=1.0,
                          qos_class="interactve")
