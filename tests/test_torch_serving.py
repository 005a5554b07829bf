"""The serving front door: DeploymentHandle -> pow-2 Router -> LLMReplica,
the HTTP proxy and the workload driver, port against the JAX package.

Host-only behaviour runs as one scenario on both packages and the outputs
are compared: pow-2 choice sequences over scripted queue lengths (the
module-level ``random`` seeded, the router's queue-length cache cleared
before every choice), the circuit breaker on an injected clock, the
router's rejection reasons, the quarantine fence, the failure
dispositions and the arrival offsets. End to end, llama_tiny in f32 is
served by both stacks built as ``bench.py`` builds them (``make_replica``
-> ``Router(max_assign_timeout_s=30)`` -> ``DeploymentHandle``) with the
same weights: identical greedy tokens. The port's HTTP proxy answers the
twins of ``tests/test_llm_serving.py``'s proxy tests. Every fixture stops
its replicas, closes its router and stops its proxy; every wait has a
timeout.
"""

import json
import random
import socket
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.engine import request as j_request
from ray_dynamic_batching_tpu.engine import workload as j_workload
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.serve import failover as j_failover
from ray_dynamic_batching_tpu.serve import handle as j_handle
from ray_dynamic_batching_tpu.serve import llm as j_llm
from ray_dynamic_batching_tpu.serve import quarantine as j_quarantine
from ray_dynamic_batching_tpu.serve import admission as j_admission
from ray_dynamic_batching_tpu.serve import fabric as j_fabric
from ray_dynamic_batching_tpu.serve import router as j_router
from ray_dynamic_batching_tpu.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu.utils import chaos as j_chaos
from ray_dynamic_batching_tpu_torch.engine import request as t_request
from ray_dynamic_batching_tpu_torch.engine import workload as t_workload
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.serve import failover as t_failover
from ray_dynamic_batching_tpu_torch.serve import handle as t_handle
from ray_dynamic_batching_tpu_torch.serve import llm as t_llm
from ray_dynamic_batching_tpu_torch.serve import quarantine as t_quarantine
from ray_dynamic_batching_tpu_torch.serve import admission as t_admission
from ray_dynamic_batching_tpu_torch.serve import fabric as t_fabric
from ray_dynamic_batching_tpu_torch.serve import router as t_router
from ray_dynamic_batching_tpu_torch.serve.controller import (
    DeploymentConfig as TDeploymentConfig,
)
from ray_dynamic_batching_tpu_torch.serve.proxy import HTTPProxy, ProxyRouter
from ray_dynamic_batching_tpu_torch.utils import chaos as t_chaos

torch.set_num_threads(2)

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", request=j_request, router=j_router, failover=j_failover,
        quarantine=j_quarantine, workload=j_workload, chaos=j_chaos,
        admission=j_admission, fabric=j_fabric),
    "torch": types.SimpleNamespace(
        name="torch", request=t_request, router=t_router, failover=t_failover,
        quarantine=t_quarantine, workload=t_workload, chaos=t_chaos,
        admission=t_admission, fabric=t_fabric),
}


@pytest.fixture(autouse=True)
def _no_chaos():
    """No injected faults from the environment in either package."""
    for pkg in PKGS.values():
        pkg.chaos.reset_chaos("")
    yield
    for pkg in PKGS.values():
        pkg.chaos.reset_chaos("")


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; the outputs must
    agree. Returns the port's."""
    out = {name: scenario(pkg, *args) for name, pkg in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


class _FakeReplica:
    """Router-facing surface with a scripted queue length."""

    def __init__(self, rid, lens, accept=True):
        self.replica_id = rid
        self.lens = lens          # queue length per step
        self.step = 0
        self.accept = accept
        self.assigned = []

    def queue_len(self):
        return self.lens[self.step % len(self.lens)]

    def accepting(self):
        return self.accept

    def assign(self, request):
        if not self.accept:
            return False
        self.assigned.append(request.request_id)
        return True


def _request(pkg, i, payload=None):
    return pkg.request.Request(model="m", payload=payload or {"i": i},
                               slo_ms=1e7, request_id=f"r{i}")


# --- pow-2 choices ------------------------------------------------------------
def _pow2_scenario(pkg, seed, n_replicas):
    rng = np.random.default_rng(seed)
    fakes = [_FakeReplica(f"rep{k}", rng.integers(0, 6, 40).tolist())
             for k in range(n_replicas)]
    router = pkg.router.Router("m", replicas=fakes, max_assign_timeout_s=1.0)
    random.seed(seed)
    chosen = []
    try:
        for i in range(40):
            for f in fakes:
                f.step = i
            router._len_cache.clear()
            assert router.assign_request(_request(pkg, i))
            chosen.append(next(f.replica_id for f in fakes
                               if f.assigned and f.assigned[-1] == f"r{i}"))
    finally:
        router.close()
    return chosen, router.total_routed


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n_replicas", [2, 3, 5])
def test_pow2_choice_sequences_match(seed, n_replicas):
    chosen, routed = _both(_pow2_scenario, seed, n_replicas)
    assert routed == 40 and len(set(chosen)) > 1


# --- circuit breaker ----------------------------------------------------------
def _breaker_scenario(pkg, threshold):
    now = [0.0]
    br = pkg.router.CircuitBreaker(threshold=threshold, cooldown_s=1.0,
                                   clock=lambda: now[0])
    trace = []
    for _ in range(threshold):
        trace.append(("fail", br.record_failure(), br.state, br.eligible()))
    now[0] = 0.5
    trace.append(("early", br.eligible(), br.acquire()))
    now[0] = 1.2
    trace.append(("probe", br.eligible(), br.acquire(), br.state,
                  br.acquire()))
    trace.append(("probe_fails", br.record_failure(), br.state))
    now[0] = 2.3
    trace.append(("probe2", br.acquire(), br.record_success(), br.state))
    trace.append(("slow", [br.record_slow() for _ in range(5)], br.state))
    trace.append(("snapshot", br.snapshot()))
    return trace


@pytest.mark.parametrize("threshold", [1, 3])
def test_circuit_breaker_trips_and_recovers_alike(threshold):
    trace = _both(_breaker_scenario, threshold)
    assert trace[threshold - 1][2] == "open"           # tripped at threshold
    assert trace[threshold + 1][3] == "half_open"      # one probe after cooldown
    assert trace[threshold + 3][3] == "closed"         # probe success closes


# --- rejection reasons --------------------------------------------------------
def _reject_scenario(pkg, case):
    fakes = [_FakeReplica("a", [0], accept=(case == "breaker_open")),
             _FakeReplica("b", [0], accept=(case == "breaker_open"))]
    router = pkg.router.Router("m", replicas=fakes, max_assign_timeout_s=0.02,
                               breaker_threshold=1, breaker_cooldown_s=60.0)
    try:
        if case == "breaker_open":
            for f in fakes:
                router.record_replica_failure(f.replica_id)
        req = _request(pkg, 0)
        ok = router.assign_request(req)
        exc = req.future.exception(timeout=5)
    finally:
        router.close()
    disp = pkg.failover.reject_disposition(exc)
    return (ok, type(exc).__name__, exc.reason, disp.kind, disp.http_status,
            [f.assigned for f in fakes])


@pytest.mark.parametrize("case", ["backoff_exhausted", "breaker_open"])
def test_rejection_reason_matches(case):
    ok, name, reason, kind, status, assigned = _both(_reject_scenario, case)
    assert not ok and name == "RequestDropped" and reason == case
    assert status == (429 if case == "backoff_exhausted" else 503)
    assert assigned == [[], []]


# --- quarantine fence ---------------------------------------------------------
def _quarantine_scenario(pkg):
    fake = _FakeReplica("a", [0])
    router = pkg.router.Router("m", replicas=[fake])
    poison = {"tokens": [9, 9, 9]}
    fp = pkg.quarantine.poison_fingerprint("m", poison)
    router.quarantine.add(fp, "m", stage="isolated")
    try:
        bad = _request(pkg, 0, dict(poison))
        good = _request(pkg, 1, {"tokens": [1, 2]})
        out = (router.assign_request(bad), router.assign_request(good))
        exc = bad.future.exception(timeout=5)
    finally:
        router.close()
    disp = pkg.failover.reject_disposition(exc)
    return (fp, out, type(exc).__name__, exc.fingerprint, disp.http_status,
            fake.assigned)


def test_quarantine_fence_matches():
    fp, out, name, exc_fp, status, assigned = _both(_quarantine_scenario)
    assert out == (False, True) and name == "PoisonRequest"
    assert exc_fp == fp and status == 400 and assigned == ["r1"]


# --- dispositions -------------------------------------------------------------
def _exceptions(pkg):
    f, r = pkg.failover, pkg.request
    dropped = r.RequestDropped("full")
    dropped.retry_after_s = 2.5
    breaker = r.RequestDropped("no replica")
    breaker.reason = "breaker_open"
    return {
        "bad_request": r.BadRequest("x"),
        "poison": f.PoisonRequest("x", fingerprint="ab"),
        "budget": f.RetryBudgetExhausted("x", retry_after_s=3.0),
        "breaker_open": breaker,
        "dropped": dropped,
        "stale": r.RequestStale("x"),
        "retries_exhausted": f.RetriesExhausted("x"),
        "replica_dead": f.ReplicaDeadError("x"),
        "drain_evicted": f.DrainEvicted("x"),
        "chaos": pkg.chaos.ChaosInjected("x"),
        "admission_rejected": pkg.admission.AdmissionRejected(
            "x", retry_after_s=0.75),
        "fabric_unreachable": pkg.fabric.FabricUnreachable(
            "x", edge="store.append", src="ctl", dst="log"),
        "bug": RuntimeError("x"),
    }


def _disposition_scenario(pkg, name):
    exc = _exceptions(pkg)[name]
    d = pkg.failover.reject_disposition(exc)
    return (d.kind, d.http_status, d.grpc_code, d.retry_after_s,
            pkg.failover.retry_after_header(d),
            pkg.failover.is_retryable(exc), pkg.failover.is_shed(exc))


@pytest.mark.parametrize("name", sorted(_exceptions(PKGS["torch"])))
def test_reject_disposition_matches(name):
    _both(_disposition_scenario, name)


# --- arrivals -----------------------------------------------------------------
def _arrivals_scenario(pkg, kind, poisson, seed):
    pattern = pkg.workload.RatePattern(kind, base_rps=40.0, amplitude=20.0,
                                       period_s=2.0, step_at_s=1.0)
    return list(pkg.workload.arrival_times(pattern, 3.0, poisson=poisson,
                                           seed=seed))


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("poisson", [False, True], ids=["uniform", "poisson"])
@pytest.mark.parametrize("kind", ["constant", "sinusoidal", "step"])
def test_arrival_offsets_match(kind, poisson, seed):
    offsets = _both(_arrivals_scenario, kind, poisson, seed)
    assert offsets and all(0.0 < t < 3.0 for t in offsets)


def test_workload_driver_submits_every_arrival():
    got = []
    driver = t_workload.WorkloadDriver(
        lambda model, t: got.append((model, t)), "m",
        t_workload.RatePattern("constant", base_rps=200.0),
        duration_s=0.2, poisson=True, seed=7)
    driver.start()
    driver.join(10.0)
    want = list(t_workload.arrival_times(
        t_workload.RatePattern("constant", base_rps=200.0), 0.2,
        poisson=True, seed=7))
    assert [t for _m, t in got] == pytest.approx(want)


# --- a replica holding a pending chunk train ----------------------------------
ENGINE = dict(num_slots=2, max_len=64, prompt_buckets=[16],
              default_max_new_tokens=4, decode_horizon=4)


@pytest.fixture(scope="module")
def tiny():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


def _deployment(name, tiny, **kw):
    jm, params, tm = tiny
    if name == "jax":
        return j_llm.LLMDeployment("llama_tiny", model=jm, params=params,
                                   dtype=jnp.float32, **kw)
    return t_llm.LLMDeployment("llama_tiny", model=tm, device="cpu", **kw)


def _config(name):
    cls = DeploymentConfig if name == "jax" else TDeploymentConfig
    return cls(name="llama_tiny", max_ongoing_requests=64)


def _train_scenario(pkg, tiny, seed):
    """Replica A holds one pending chunk train (dequeued, not yet
    prefilled), replica B one queued request; neither engine runs. The
    routers choose on that state."""
    name = pkg.name
    dep = _deployment(name, tiny, warmup=False, paged=True,
                      chunked_prefill=True, **ENGINE)
    a = dep.make_replica("A", _config(name))
    b = dep.make_replica("B", _config(name))
    router = pkg.router.Router("llama_tiny", replicas=[a, b])
    try:
        a.assign(_request(pkg, 100, {"tokens": list(range(1, 40))}))
        a.engine._admit()
        b.assign(_request(pkg, 101, {"tokens": [1, 2, 3]}))
        state = (len(a.engine._trains), a.queue_len(), b.queue_len())
        random.seed(seed)
        picks = []
        for i in range(6):
            router._len_cache.clear()
            req = _request(pkg, i, {"tokens": [4, 5]})
            assert router.assign_request(req)
            picks.append(req._assigned_replica)
    finally:
        router.close()
        for r in (a, b):
            r.stop(timeout_s=1.0, drain=False)
    return state, picks


@pytest.mark.parametrize("seed", [0, 1])
def test_pending_train_routes_alike(tiny, seed):
    """The router-facing count leaves pending trains out, as the
    reference's does, so both routers fill A (0 < 1) first."""
    (trains, len_a, len_b), picks = _both(_train_scenario, tiny, seed)
    assert (trains, len_a, len_b) == (1, 0, 1)
    assert picks[0] == "A"


def _reconfigure_scenario(pkg, tiny):
    """A redeploy's concurrency bound on an unstarted llama_tiny replica:
    every bucket queue's ``max_len`` and what the replica then admits."""
    dep = _deployment(pkg.name, tiny, warmup=False, **ENGINE)
    replica = dep.make_replica("A", _config(pkg.name))
    try:
        before = [q.max_len for q in replica._queues.values()]
        replica.reconfigure(max_batch_size=2, batch_wait_timeout_s=0.01,
                            max_ongoing_requests=3,
                            user_config={"note": "redeploy"})
        after = [q.max_len for q in replica._queues.values()]
        admitted = [replica.assign(_request(pkg, i, {"tokens": [1, 2]}))
                    for i in range(5)]
    finally:
        replica.stop(timeout_s=1.0, drain=False)
    return before, replica.max_ongoing_requests, after, admitted


def test_reconfigure_reaches_every_bucket_queue(tiny):
    """``LLMReplica.reconfigure`` applies ``max_ongoing_requests`` to the
    bucket queues that hold the requests, as the reference's does."""
    before, cap, after, admitted = _both(_reconfigure_scenario, tiny)
    assert before == [64] and cap == 3 and after == [3]
    assert admitted == [True, True, True, False, False]


def test_draining_stop_waits_for_a_pending_train(tiny):
    dep = _deployment("torch", tiny, warmup=False, paged=True,
                      chunked_prefill=True, **ENGINE)
    replica = dep.make_replica("A", _config("torch"))
    req = _request(PKGS["torch"], 0, {"tokens": list(range(1, 40))})
    replica.assign(req)
    replica.engine._admit()
    assert replica.queue_len() == 0 and replica._unfinished() == 1
    replica.start()
    replica.stop(timeout_s=60.0, drain=True)   # the train completes first
    assert len(req.future.result(timeout=5).tokens) == 4


# --- end to end: the bench.py stack on both packages --------------------------
PAYLOADS = [{"tokens": list(np.random.default_rng(i).integers(1, 500, n)),
             "max_new_tokens": 6}
            for i, n in enumerate((5, 11, 14, 3, 9, 16))]
PAYLOADS = [{**p, "tokens": [int(t) for t in p["tokens"]]} for p in PAYLOADS]


def _stack(name, tiny):
    """``bench.py:207-214``: make_replica -> start -> Router(30 s) ->
    DeploymentHandle(300 s SLO)."""
    pkg = PKGS[name]
    dep = _deployment(name, tiny, warmup=False, max_admissions_per_step=2,
                      **ENGINE)
    replica = dep.make_replica("llama_tiny#bench",
                               _config(name))
    replica.start()
    router = pkg.router.Router("llama_tiny", replicas=[replica],
                               max_assign_timeout_s=30.0)
    hmod = j_handle if name == "jax" else t_handle
    handle = hmod.DeploymentHandle(router, default_slo_ms=300_000.0)
    return replica, router, handle


@pytest.fixture(scope="module")
def stacks(tiny):
    built = {name: _stack(name, tiny) for name in PKGS}
    yield built
    for replica, router, _handle in built.values():
        router.close()
        replica.stop(timeout_s=5.0, drain=False)


def _concurrent(handle, payloads):
    with ThreadPoolExecutor(len(payloads)) as pool:
        futs = list(pool.map(handle.remote, payloads))
    return [f.result(timeout=120).tokens for f in futs]


def test_handle_tokens_identical_to_jax_stack(stacks):
    """The same payloads through both stacks' ``handle.remote`` (one at a
    time, then all at once): identical greedy tokens; the concurrent
    burst shares the port's one engine."""
    j_tokens = [stacks["jax"][2].remote(p).result(timeout=120).tokens
                for p in PAYLOADS]
    replica, router, handle = stacks["torch"]
    t_tokens = [handle.remote(p).result(timeout=120).tokens
                for p in PAYLOADS]
    assert t_tokens == j_tokens
    steps0, routed0 = replica.engine.steps, router.total_routed
    assert _concurrent(handle, PAYLOADS) == j_tokens
    assert router.total_routed - routed0 == len(PAYLOADS)
    assert replica.engine.completed == 2 * len(PAYLOADS)
    # Served one by one the burst would take 6 x 5 decode steps.
    assert replica.engine.steps - steps0 < 5 * len(PAYLOADS)


def test_remote_stream_chunks_equal_the_result(stacks):
    _replica, _router, handle = stacks["torch"]
    stream, fut = handle.remote_stream(PAYLOADS[1])
    chunks = stream.drain(timeout_s=60)
    assert chunks == fut.result(timeout=60).tokens and len(chunks) == 6


def test_handle_options_and_reset_ttft_window(stacks):
    replica, _router, handle = stacks["torch"]
    fast = handle.options(slo_ms=1e6, qos_class="interactive")
    assert fast.default_slo_ms == 1e6 and fast.router is handle.router
    fast.remote(PAYLOADS[0]).result(timeout=60)
    assert replica.engine.ttft_breakdown()["n"] > 0
    replica.engine.reset_ttft_window()
    assert replica.engine.ttft_breakdown() == {"n": 0}
    assert 0.0 <= replica.engine.kv_occupancy() <= 1.0


# --- HTTP ---------------------------------------------------------------------
def _http(addr, method, path, body=None, raw=None, timeout=60.0):
    """Minimal HTTP/1.1 client: (code, headers, body bytes). The proxy
    keeps connections alive, so the body ends at its Content-Length or
    at the chunked terminator."""
    host, port = addr
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else b"")
    req = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
           f"Content-Length: {len(data)}\r\n\r\n").encode() + data
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(req)
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(65536)
        head, rest = buf.split(b"\r\n\r\n", 1)
        lines = head.decode().split("\r\n")
        headers = {k.strip().lower(): v.strip()
                   for k, v in (l.split(":", 1) for l in lines[1:]
                                if ":" in l)}
        if "content-length" in headers:
            while len(rest) < int(headers["content-length"]):
                rest += s.recv(65536)
        else:
            while not rest.endswith(b"0\r\n\r\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                rest += chunk
    return int(lines[0].split(" ")[1]), headers, rest


def _dechunk(raw: bytes) -> bytes:
    out = b""
    while raw and b"\r\n" in raw:
        size_line, raw = raw.split(b"\r\n", 1)
        size = int(size_line, 16)
        if size == 0:
            break
        out += raw[:size]
        raw = raw[size + 2:]
    return out


@pytest.fixture(scope="module")
def proxy(stacks):
    routes = ProxyRouter()
    routes.set_route("/api/llama_tiny", stacks["torch"][2])
    server = HTTPProxy(routes, host="127.0.0.1", port=0).start()
    yield (server.host, server.port)
    server.stop()


def test_http_buffered_request(proxy, stacks):
    code, _headers, body = _http(proxy, "POST", "/api/llama_tiny",
                                 PAYLOADS[2])
    assert code == 200
    tokens = json.loads(body)["result"]["tokens"]
    want = stacks["torch"][2].remote(PAYLOADS[2]).result(timeout=60).tokens
    assert tokens == want and len(tokens) == 6


def test_http_streaming_request(proxy, stacks):
    code, headers, raw = _http(proxy, "POST", "/api/llama_tiny",
                               {**PAYLOADS[3], "stream": True})
    assert code == 200 and headers["transfer-encoding"] == "chunked"
    lines = [json.loads(l) for l in _dechunk(raw).decode().splitlines() if l]
    chunks = [l["chunk"] for l in lines if "chunk" in l]
    finals = [l["result"] for l in lines if "result" in l]
    assert len(finals) == 1 and chunks == finals[0]["tokens"]
    want = stacks["torch"][2].remote(PAYLOADS[3]).result(timeout=60).tokens
    assert chunks == want and len(chunks) == 6


@pytest.mark.parametrize("method,path,raw,code", [
    ("POST", "/api/nope", b"{}", 404),
    ("POST", "/api/llama_tiny", b"{not json", 400),
    ("GET", "/api/llama_tiny", b"", 400),
    ("POST", "/api/llama_tiny", b'{"tokens": [1], "qos_class": "vip"}', 400),
])
def test_http_errors(proxy, method, path, raw, code):
    got, _headers, body = _http(proxy, method, path, raw=raw)
    assert got == code and "error" in json.loads(body)


def test_http_healthz_and_metrics(proxy):
    code, _h, body = _http(proxy, "GET", "/-/healthz")
    assert code == 200 and json.loads(body) == {"status": "ok"}
    code, headers, body = _http(proxy, "GET", "/metrics")
    assert code == 200 and headers["content-type"].startswith("text/plain")
    assert b"rdb_router_routed_total" in body
    assert b"rdb_proxy_requests_total" in body
