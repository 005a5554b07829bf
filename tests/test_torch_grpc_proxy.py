"""The gRPC door, the port against the JAX package (CPU, grpcio).

Each package's ``GRPCProxy`` serves its own equivalent deployments (an
echo batch replica, a failing one, llama_tiny with the same weights)
behind one route table: ``Healthz``, ``Predict`` and ``PredictStream``
answer with the same results, status codes and messages, token streams
included. With ``HAVE_GRPC`` False the proxy and the client refuse to be
built while the module stays importable (the import without grpcio at
all is ``tests/test_torch_imports.py``'s). Every server, channel, router
and replica is stopped in a ``finally``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")

from ray_dynamic_batching_tpu.models import causal_lm as j_lm  # noqa: E402
from ray_dynamic_batching_tpu.serve import grpc_proxy as j_grpc  # noqa: E402
from ray_dynamic_batching_tpu.serve import handle as j_handle  # noqa: E402
from ray_dynamic_batching_tpu.serve import llm as j_llm  # noqa: E402
from ray_dynamic_batching_tpu.serve import proxy as j_proxy  # noqa: E402
from ray_dynamic_batching_tpu.serve import replica as j_replica  # noqa: E402
from ray_dynamic_batching_tpu.serve import router as j_router  # noqa: E402
from ray_dynamic_batching_tpu.serve.controller import (  # noqa: E402
    DeploymentConfig,
)
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm  # noqa: E402
from ray_dynamic_batching_tpu_torch.models.convert import (  # noqa: E402
    params_from_flax,
)
from ray_dynamic_batching_tpu_torch.serve import grpc_proxy as t_grpc  # noqa: E402
from ray_dynamic_batching_tpu_torch.serve import handle as t_handle  # noqa: E402
from ray_dynamic_batching_tpu_torch.serve import llm as t_llm  # noqa: E402
from ray_dynamic_batching_tpu_torch.serve import proxy as t_proxy  # noqa: E402
from ray_dynamic_batching_tpu_torch.serve import replica as t_replica  # noqa: E402
from ray_dynamic_batching_tpu_torch.serve import router as t_router  # noqa: E402
from ray_dynamic_batching_tpu_torch.serve.controller import (  # noqa: E402
    DeploymentConfig as TDeploymentConfig,
)

torch.set_num_threads(2)

PKGS = {
    "jax": types.SimpleNamespace(grpc=j_grpc, handle=j_handle, llm=j_llm,
                                 proxy=j_proxy, replica=j_replica,
                                 router=j_router, config=DeploymentConfig),
    "torch": types.SimpleNamespace(grpc=t_grpc, handle=t_handle, llm=t_llm,
                                   proxy=t_proxy, replica=t_replica,
                                   router=t_router,
                                   config=TDeploymentConfig),
}
ENGINE = dict(num_slots=2, max_len=32, prompt_buckets=[8],
              default_max_new_tokens=4, warmup=False)


def _boom(payloads):
    raise RuntimeError("model exploded")


def _serve(lib, pkg, weights):
    """(proxy, client, things to stop) for one package."""
    jm, params, tm = weights
    stop = []
    routes = pkg.proxy.ProxyRouter()
    for name, fn in (("echo", lambda ps: ps), ("boom", _boom)):
        rep = pkg.replica.Replica(f"{name}#0", name, fn, max_batch_size=4,
                                  batch_wait_timeout_s=0.005)
        rep.start()
        router = pkg.router.Router(name, replicas=[rep])
        stop += [router.close, rep.stop]
        routes.set_route(f"/api/{name}", pkg.handle.DeploymentHandle(
            router, default_slo_ms=60_000.0))
    if lib == "jax":
        dep = pkg.llm.LLMDeployment("llama_tiny", model=jm, params=params,
                                    dtype=jnp.float32, **ENGINE)
    else:
        dep = pkg.llm.LLMDeployment("llama_tiny", model=tm, device="cpu",
                                    **ENGINE)
    rep = dep.make_replica("lm#0", pkg.config(name="lm"))
    rep.start()
    router = pkg.router.Router("lm", replicas=[rep],
                               max_assign_timeout_s=30.0)
    stop += [router.close, lambda: rep.stop(timeout_s=5.0, drain=False)]
    routes.set_route("/api/lm", pkg.handle.DeploymentHandle(
        router, default_slo_ms=300_000.0))
    proxy = pkg.grpc.GRPCProxy(routes, port=0).start()
    stop.append(proxy.stop)
    client = pkg.grpc.GRPCIngressClient(proxy.host, proxy.port)
    stop.append(client.close)
    return client, stop


@pytest.fixture(scope="module")
def clients():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    built, stops = {}, []
    try:
        for lib, pkg in PKGS.items():
            client, stop = _serve(lib, pkg, (jm, params, tm))
            built[lib] = client
            stops += stop
        yield built
    finally:
        for fn in reversed(stops):
            fn()


def _untimed(value):
    """A result with its clock readings (``ttft_ms``, ``total_ms``) out."""
    if isinstance(value, dict):
        return {k: _untimed(v) for k, v in value.items()
                if not k.endswith("_ms")}
    if isinstance(value, list):
        return [_untimed(v) for v in value]
    return value


def _call(fn):
    """A call's outcome: ("ok", value without its clock readings) or
    (status code name, details)."""
    try:
        out = fn()
        return ("ok", _untimed(list(out) if isinstance(
            out, types.GeneratorType) else out))
    except grpc.RpcError as e:
        return (e.code().name, e.details())


CALLS = {
    "healthz": lambda c: c.healthz(),
    "echo": lambda c: c.predict("echo", {"a": [1, 2]}),
    "not_found": lambda c: c.predict("nope", 1),
    "replica_error": lambda c: c.predict("boom", 1),
    "bad_qos": lambda c: c.predict("echo", 1, qos_class="vip"),
    "llm_unary": lambda c: c.predict(
        "lm", {"tokens": [1, 2, 3], "max_new_tokens": 4}, timeout_s=60),
    "llm_stream": lambda c: c.predict_stream(
        "lm", {"tokens": [7, 5, 3, 1], "max_new_tokens": 4}, timeout_s=60),
    "stream_not_found": lambda c: c.predict_stream("nope", 1),
    "stream_error": lambda c: c.predict_stream("boom", 1),
}


def _bad_json(client):
    return client._predict(b"{nope", timeout=10)


@pytest.mark.parametrize("name", list(CALLS) + ["bad_json"])
def test_methods_answer_as_the_jax_proxy(clients, name):
    fn = CALLS.get(name, _bad_json)
    got = _call(lambda: fn(clients["torch"]))
    want = _call(lambda: fn(clients["jax"]))
    assert got == want
    if name == "llm_unary":
        assert len(got[1]["tokens"]) == 4
    if name == "llm_stream":
        chunks = [m["chunk"] for m in got[1] if "chunk" in m]
        finals = [m["result"] for m in got[1] if "result" in m]
        assert len(finals) == 1 and chunks == finals[0]["tokens"]
        assert len(chunks) == 4
    if name in ("not_found", "bad_json", "replica_error", "bad_qos"):
        assert got[0] in ("NOT_FOUND", "INVALID_ARGUMENT", "INTERNAL",
                          "UNAVAILABLE")


def test_without_grpc_the_door_refuses_to_build(monkeypatch):
    monkeypatch.setattr(t_grpc, "HAVE_GRPC", False)
    with pytest.raises(RuntimeError, match="grpcio is not installed"):
        t_grpc.GRPCProxy(t_proxy.ProxyRouter())
    with pytest.raises(RuntimeError, match="grpcio is not installed"):
        t_grpc.GRPCIngressClient("127.0.0.1", 1)
