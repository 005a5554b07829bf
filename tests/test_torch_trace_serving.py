"""One trace across the port's serving path, against the JAX package.

Twins of ``tests/test_tracing_e2e.py::TestServePathE2E`` (proxy -> handle
-> router -> replica batch with a real HTTP hop: one trace id from the
client's ``traceparent``, batch <-> request links both ways, hop
durations inside the measured latency, Chrome lanes and matched flow
arrows) and of ``tests/test_llm_serving.py::TestTracePropagation`` (a
handle request to an LLM deployment: ``decode.sequence`` joins the
caller's trace under its ``handle.remote`` span), each run on both
packages with the structural outcome compared; and, port only, an LLM
request through the proxy whose ledger splits into the decode hops and
conserves, and the engine's families on ``GET /metrics``. llama_tiny in
f32, the same weights on both sides. Every test resets its tracer and
stops its proxy, router and replicas.
"""

import http.client
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.serve import controller as j_controller
from ray_dynamic_batching_tpu.serve import handle as j_handle
from ray_dynamic_batching_tpu.serve import llm as j_llm
from ray_dynamic_batching_tpu.serve import proxy as j_proxy
from ray_dynamic_batching_tpu.serve import replica as j_replica
from ray_dynamic_batching_tpu.serve import router as j_router
from ray_dynamic_batching_tpu.utils import hops as j_hops
from ray_dynamic_batching_tpu.utils import metrics as j_metrics
from ray_dynamic_batching_tpu.utils import trace_export as j_export
from ray_dynamic_batching_tpu.utils import tracing as j_tracing
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.serve import controller as t_controller
from ray_dynamic_batching_tpu_torch.serve import handle as t_handle
from ray_dynamic_batching_tpu_torch.serve import llm as t_llm
from ray_dynamic_batching_tpu_torch.serve import proxy as t_proxy
from ray_dynamic_batching_tpu_torch.serve import replica as t_replica
from ray_dynamic_batching_tpu_torch.serve import router as t_router
from ray_dynamic_batching_tpu_torch.utils import hops as t_hops
from ray_dynamic_batching_tpu_torch.utils import metrics as t_metrics
from ray_dynamic_batching_tpu_torch.utils import trace_export as t_export
from ray_dynamic_batching_tpu_torch.utils import tracing as t_tracing

torch.set_num_threads(2)

_MODS = ("controller", "handle", "llm", "proxy", "replica", "router", "hops",
         "metrics", "export", "tracing")
PKGS = {
    name: types.SimpleNamespace(
        name=name, **{m: globals()[f"{name[0]}_{m}"] for m in _MODS})
    for name in ("jax", "torch")
}
CLIENT_TRACEPARENT = "00-" + "ab" * 16 + "-" + "12" * 8 + "-01"
CLIENT_TRACE = "ab" * 16


@pytest.fixture(autouse=True)
def _tracers_reset():
    yield
    for pkg in PKGS.values():
        pkg.tracing.tracer().reset()


@pytest.fixture(scope="module")
def tiny():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


def _deployment(pkg, tiny, **kw):
    jm, params, tm = tiny
    knobs = dict(num_slots=4, max_len=64, prompt_buckets=[8, 16],
                 default_max_new_tokens=8, decode_horizon=4, **kw)
    if pkg.name == "jax":
        return j_llm.LLMDeployment("llama_tiny", model=jm, params=params,
                                   dtype=jnp.float32, **knobs)
    return t_llm.LLMDeployment("llama_tiny", model=tm, device="cpu", **knobs)


def _wait_for(collector, names, timeout_s=5.0):
    """Spans from replica and engine threads land asynchronously."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if set(names) <= {s.name for s in collector.spans}:
            return
        time.sleep(0.01)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _post(port, path, payload, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    t0 = time.monotonic()
    conn.request("POST", path, json.dumps(payload), headers=headers or {})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body, (time.monotonic() - t0) * 1000.0


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


# --- proxy -> handle -> router -> replica batch ------------------------------

def _doubler_path(pkg):
    """The reference test's stack on ``pkg``: one POST with the client's
    traceparent. Returns the structural outcome."""
    def fn(payloads):
        time.sleep(0.002)  # a visible batch-execution duration
        return [p * 2 for p in payloads]

    collector = pkg.export.ChromeTraceCollector()
    pkg.tracing.tracer().set_exporter(collector.export)
    replica = pkg.replica.Replica("r0", "doubler", fn, max_batch_size=4,
                                  batch_wait_timeout_s=0.005)
    replica.start()
    router = pkg.router.Router("doubler", [replica])
    routes = pkg.proxy.ProxyRouter()
    routes.set_route("/api/doubler", pkg.handle.DeploymentHandle(router))
    proxy = pkg.proxy.HTTPProxy(routes, port=0, request_timeout_s=10.0)
    proxy.start()
    try:
        status, body, e2e_ms = _post(proxy.port, "/api/doubler", 21,
                                     {"traceparent": CLIENT_TRACEPARENT})
        want = {"proxy.request", "handle.remote", "router.assign",
                "queue.wait", "replica.batch", "replica.execute"}
        _wait_for(collector, want)
    finally:
        proxy.stop()
        router.close()
        replica.stop()
        pkg.tracing.tracer().reset()
    by = _by_name(collector.spans)
    batch, handle_span = by["replica.batch"][0], by["handle.remote"][0]
    execute, queue_wait = by["replica.execute"][0], by["queue.wait"][0]
    proxy_span = by["proxy.request"][0]
    doc = json.loads(json.dumps(collector.chrome_trace()))
    events = doc["traceEvents"]
    starts = sorted(e["id"] for e in events if e["ph"] == "s")
    ledgers, _skipped = pkg.hops.request_ledgers(collector.spans)
    return dict(
        status=status, result=body["result"],
        hops_seen=sorted(want & set(by)),
        one_trace=[by[n][0].trace_id == CLIENT_TRACE for n in (
            "proxy.request", "handle.remote", "router.assign", "queue.wait",
            "replica.execute")],
        batch_links_request={"trace_id": CLIENT_TRACE,
                             "span_id": handle_span.span_id} in batch.links,
        execute_links_batch={"trace_id": batch.trace_id,
                             "span_id": batch.span_id} in execute.links,
        nested=(queue_wait.duration_ms() + batch.duration_ms()
                <= e2e_ms + 1.0
                and proxy_span.duration_ms() <= e2e_ms + 1.0
                and proxy_span.start_ms <= queue_wait.end_ms
                and batch.end_ms <= proxy_span.end_ms + 1.0),
        processes=sorted(
            {"proxy", "handle", "router", "queue", "replica"}
            & {e["args"]["name"] for e in events
               if e["ph"] == "M" and e["name"] == "process_name"}),
        r0_lane="r0" in {e["args"]["name"] for e in events
                         if e["ph"] == "M" and e["name"] == "thread_name"},
        flows_matched=bool(starts) and starts == sorted(
            e["id"] for e in events if e["ph"] == "f"),
        durations_ok=all(e["dur"] >= 0 for e in events if e["ph"] == "X"),
        ledger=[(l.root, sorted(l.hops)) for l in ledgers],
        exemplar=f'# {{trace_id="{CLIENT_TRACE}"}}'
        in pkg.metrics.default_registry().openmetrics_text(),
    )


def test_one_trace_spans_the_serve_path_as_in_the_reference():
    outcome = {name: _doubler_path(pkg) for name, pkg in PKGS.items()}
    assert outcome["torch"] == outcome["jax"]
    got = outcome["torch"]
    assert got["status"] == 200 and got["result"] == 42
    assert len(got["hops_seen"]) == 6 and all(got["one_trace"])
    assert got["batch_links_request"] and got["execute_links_batch"]
    assert got["nested"] and got["durations_ok"] and got["flows_matched"]
    assert got["processes"] == ["handle", "proxy", "queue", "replica",
                                "router"]
    assert got["r0_lane"] and got["exemplar"]
    assert got["ledger"][0][0] == "proxy.request"


# --- handle -> LLM replica -> decode engine ----------------------------------

def _llm_handle_path(pkg, tiny):
    """The reference's ``TestTracePropagation`` on ``pkg``: a controller
    serving llama_tiny, one ``handle.remote``."""
    controller = pkg.controller.ServeController(control_interval_s=0.1)
    router = controller.deploy(
        pkg.controller.DeploymentConfig(name="llama_tiny", num_replicas=1),
        factory=_deployment(pkg, tiny))
    controller.start()
    collector = pkg.export.ChromeTraceCollector()
    pkg.tracing.tracer().set_exporter(collector.export)
    try:
        fut = pkg.handle.DeploymentHandle(router).remote(
            {"tokens": [1, 2, 3], "max_new_tokens": 3})
        tokens = fut.result(timeout=60).tokens
        _wait_for(collector, {"handle.remote", "decode.sequence"})
    finally:
        pkg.tracing.tracer().reset()
        controller.shutdown()
    by = _by_name(collector.spans)
    client, seq = by["handle.remote"][0], by["decode.sequence"][0]
    prefill = by["decode.prefill"][0]
    turns = by.get("decode.turn", [])
    return dict(
        tokens=tokens,
        joined=(seq.trace_id == client.trace_id
                and seq.parent_id == client.span_id
                and prefill.trace_id == client.trace_id
                and prefill.parent_id == client.span_id),
        seq=(seq.attributes["tokens"], seq.attributes["finish_reason"]),
        turns_link_the_request=bool(turns) and all(
            {"trace_id": client.trace_id, "span_id": client.span_id}
            in t.links for t in turns),
        turn_steps=sum(t.attributes["horizon"] for t in turns),
    )


def test_decode_spans_join_the_caller_trace_as_in_the_reference(tiny):
    outcome = {name: _llm_handle_path(pkg, tiny)
               for name, pkg in PKGS.items()}
    assert outcome["torch"] == outcome["jax"]
    got = outcome["torch"]
    assert len(got["tokens"]) == 3 and got["joined"]
    assert got["seq"] == (3, "length")
    assert got["turns_link_the_request"] and got["turn_steps"] >= 2


def test_proxied_llm_request_ledger_splits_into_decode_hops(tiny):
    """An LLM request through the port's proxy: the proxy roots the
    trace, so the ledger's window is the request's whole latency and
    splits into the front door, the queue, the prefill and the decode
    turns, conserving; the engine's families answer ``GET /metrics``."""
    pkg = PKGS["torch"]
    dep = _deployment(pkg, tiny, warmup=False)
    replica = dep.make_replica("A", t_controller.DeploymentConfig(
        name="llama_tiny", max_ongoing_requests=64))
    replica.start()
    router = t_router.Router("llama_tiny", replicas=[replica])
    routes = t_proxy.ProxyRouter()
    routes.set_route("/api/llama_tiny", t_handle.DeploymentHandle(router))
    proxy = t_proxy.HTTPProxy(routes, port=0, request_timeout_s=60.0)
    proxy.start()
    collector = t_export.ChromeTraceCollector()
    t_tracing.tracer().set_exporter(collector.export)
    try:
        status, body, e2e_ms = _post(
            proxy.port, "/api/llama_tiny",
            {"tokens": [5, 6, 7, 8], "max_new_tokens": 6},
            {"traceparent": CLIENT_TRACEPARENT})
        _wait_for(collector, {"proxy.request", "decode.sequence"})
        code, metrics_text = _get(proxy.port, "/metrics")
    finally:
        t_tracing.tracer().reset()
        proxy.stop()
        router.close()
        replica.stop(timeout_s=5.0, drain=False)
    assert status == 200 and len(body["result"]["tokens"]) == 6
    ledgers, _skipped = t_hops.request_ledgers(collector.spans)
    (ledger,) = [l for l in ledgers if l.trace_id == CLIENT_TRACE]
    assert ledger.root == "proxy.request" and t_hops.is_served(ledger)
    assert {"handle.remote", "router.assign", "queue.wait", "decode.prefill",
            "decode.turn"} <= set(ledger.hops)
    assert sum(ledger.hops.values()) + ledger.unattributed_ms == \
        pytest.approx(ledger.end_to_end_ms, abs=1e-6)
    assert ledger.end_to_end_ms <= e2e_ms + 1.0
    assert code == 200
    for family in ("rdb_decode_tokens_total", "rdb_decode_steps_total",
                   "rdb_decode_prefills_total", "rdb_decode_ttft_ms_bucket",
                   "rdb_decode_ttft_queue_ms_bucket",
                   "rdb_decode_ttft_prefill_ms_bucket"):
        assert f'{family}{{model="llama_tiny"' in metrics_text, family
