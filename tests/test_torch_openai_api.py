"""The OpenAI-shaped completions surface, the port against the JAX package
(CPU).

``translate_request`` over one table of bodies, valid and malformed: the
same payload dict, or the same error type and text, from both packages.
``translate_response`` wraps one result into the same envelope (``id``
and ``created`` aside, which are random and a clock). End to end, the
port's ``HTTPProxy`` with ``/v1/completions -> CompletionsHandle`` over a
llama_tiny stack answers with the tokens the JAX stack's handle gives for
the same weights, with ``usage`` and ``finish_reason`` filled, and a
malformed body gets a 400. Every fixture stops its proxy, router and
replica.
"""

import json
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.serve import handle as j_handle
from ray_dynamic_batching_tpu.serve import llm as j_llm
from ray_dynamic_batching_tpu.serve import openai_api as j_api
from ray_dynamic_batching_tpu.serve import router as j_router
from ray_dynamic_batching_tpu.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.serve import CompletionsHandle
from ray_dynamic_batching_tpu_torch.serve import handle as t_handle
from ray_dynamic_batching_tpu_torch.serve import llm as t_llm
from ray_dynamic_batching_tpu_torch.serve import openai_api as t_api
from ray_dynamic_batching_tpu_torch.serve import router as t_router
from ray_dynamic_batching_tpu_torch.serve.controller import (
    DeploymentConfig as TDeploymentConfig,
)
from ray_dynamic_batching_tpu_torch.serve.proxy import HTTPProxy, ProxyRouter

torch.set_num_threads(2)

BODIES = [
    {"prompt": [1, 2, 3], "max_tokens": 9, "temperature": 0.5, "top_k": 40,
     "seed": 11, "stop": [7], "logit_bias": {"4": -5}, "session_id": "u1"},
    {"prompt": [1], "user": "alice"},
    {"prompt": [1], "user": "alice", "session_id": "s9"},
    {"prompt": [4, 5], "top_p": 0.9, "presence_penalty": 0.1,
     "frequency_penalty": 0.2, "stop": 3},
    {"prompt": [4], "tenant": "acme", "qos_class": "interactive"},
    {"prompt": [4], "n": 1, "stream": False},
    "not a dict",
    {"prompt": "a string"},
    {"prompt": []},
    {"prompt": [1, "x"]},
    {"prompt": [1], "n": 2},
    {"prompt": [1], "stream": True},
    {"prompt": [1], "max_tokens": None},
    {"prompt": [1], "temperature": "hot"},
    {"prompt": [1], "logit_bias": [1, 2]},
    {"prompt": [1], "stop": ["x"]},
    {"prompt": [1], "qos_class": "vip"},
]


def _outcome(api, body):
    try:
        return ("ok", api.translate_request(body, default_max_tokens=16))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("body", BODIES, ids=[f"body{i}" for i in
                                               range(len(BODIES))])
def test_translate_request_matches_jax(body):
    assert _outcome(t_api, body) == _outcome(j_api, body)


@pytest.mark.parametrize("finish", ["eos", "length", "capacity", "other"])
def test_translate_response_matches_jax(finish):
    result = types.SimpleNamespace(tokens=[3, 1, 4], finish_reason=finish,
                                   ttft_ms=12.345)
    got = t_api.translate_response("m", 5, result)
    want = j_api.translate_response("m", 5, result)
    for env in (got, want):
        assert env.pop("id").startswith("cmpl-")
        assert isinstance(env.pop("created"), int)
    assert got == want


# --- over HTTP -----------------------------------------------------------------
ENGINE = dict(num_slots=2, max_len=64, prompt_buckets=[16],
              default_max_new_tokens=6, decode_horizon=4, warmup=False)
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(1, 500, n)]
           for i, n in enumerate((5, 11, 3))]


def _stack(lib, jm, params, tm):
    if lib == "jax":
        dep = j_llm.LLMDeployment("llama_tiny", model=jm, params=params,
                                  dtype=jnp.float32, **ENGINE)
        replica = dep.make_replica("j", DeploymentConfig(name="llama_tiny"))
        rmod, hmod = j_router, j_handle
    else:
        dep = t_llm.LLMDeployment("llama_tiny", model=tm, device="cpu",
                                  **ENGINE)
        replica = dep.make_replica("t", TDeploymentConfig(name="llama_tiny"))
        rmod, hmod = t_router, t_handle
    replica.start()
    router = rmod.Router("llama_tiny", replicas=[replica],
                         max_assign_timeout_s=30.0)
    return replica, router, hmod.DeploymentHandle(
        router, default_slo_ms=300_000.0)


@pytest.fixture(scope="module")
def stacks():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    built = {lib: _stack(lib, jm, params, tm) for lib in ("jax", "torch")}
    routes = ProxyRouter()
    routes.set_route("/v1/completions",
                     CompletionsHandle(built["torch"][2], model="llama_tiny"))
    proxy = HTTPProxy(routes, host="127.0.0.1", port=0).start()
    try:
        yield built, proxy
    finally:
        proxy.stop()
        for replica, router, _h in built.values():
            router.close()
            replica.stop(timeout_s=5.0, drain=False)


def _post(proxy, body) -> tuple:
    raw = json.dumps(body).encode()
    req = (b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Length: "
           + str(len(raw)).encode() + b"\r\n\r\n" + raw)
    with socket.create_connection(("127.0.0.1", proxy.port),
                                  timeout=60) as s:
        s.settimeout(60)
        s.sendall(req)
        data = b""
        while b"\r\n\r\n" not in data:
            data += s.recv(4096)
        head, body_bytes = data.split(b"\r\n\r\n", 1)
        n = next(int(line.split(b":", 1)[1]) for line in head.split(b"\r\n")
                 if line.lower().startswith(b"content-length"))
        while len(body_bytes) < n:
            body_bytes += s.recv(4096)
    return int(data.split(b" ", 2)[1]), json.loads(body_bytes)


def test_completions_give_the_jax_stacks_tokens(stacks):
    built, proxy = stacks
    j_handle_ = built["jax"][2]
    for prompt in PROMPTS:
        want = j_handle_.remote({"tokens": prompt, "max_new_tokens": 5}
                                ).result(timeout=120).tokens
        code, resp = _post(proxy, {"prompt": prompt, "max_tokens": 5})
        assert code == 200
        body = resp["result"]
        assert body["object"] == "text_completion"
        assert body["model"] == "llama_tiny"
        assert body["choices"][0]["tokens"] == want
        assert body["choices"][0]["finish_reason"] == "length"
        assert body["usage"] == {"prompt_tokens": len(prompt),
                                 "completion_tokens": 5,
                                 "total_tokens": len(prompt) + 5}


def test_stop_token_maps_to_finish_stop(stacks):
    _built, proxy = stacks
    _, resp = _post(proxy, {"prompt": PROMPTS[0], "max_tokens": 6})
    first = resp["result"]["choices"][0]["tokens"][0]
    code, resp = _post(proxy, {"prompt": PROMPTS[0], "max_tokens": 6,
                               "stop": [first]})
    assert code == 200
    assert resp["result"]["choices"][0]["finish_reason"] == "stop"


@pytest.mark.parametrize("body,needle", [
    ({"prompt": "text prompts unsupported"}, "token ids"),
    ({"prompt": [1, 2], "stream": True}, "stream"),
    ({"prompt": [1], "temperature": "hot"}, "malformed field"),
])
def test_malformed_bodies_are_client_errors(stacks, body, needle):
    _built, proxy = stacks
    code, resp = _post(proxy, body)
    assert code == 400 and needle in resp["error"]
