"""Socket ingress (newline-delimited JSON over TCP), the port against the
JAX package (CPU).

The twins of ``tests/test_ingress.py``'s socket cases run on each
package's ``SocketIngress`` and ``IngressClient``, and one scripted
conversation (replies, fire-and-forget, rejections, malformed lines, a
chaos drop at ``ingress.handle``, a replica error) gets the same replies
from both. Into a real port replica, the replies carry its results.
Every server and client is closed in a ``finally``.
"""

import json
import time
import types

import pytest

from ray_dynamic_batching_tpu.engine import ingress as j_ingress
from ray_dynamic_batching_tpu.engine import request as j_request
from ray_dynamic_batching_tpu.utils import chaos as j_chaos
from ray_dynamic_batching_tpu_torch.engine import ingress as t_ingress
from ray_dynamic_batching_tpu_torch.engine import request as t_request
from ray_dynamic_batching_tpu_torch.serve.replica import Replica
from ray_dynamic_batching_tpu_torch.utils import chaos as t_chaos

PKGS = {
    "jax": types.SimpleNamespace(ingress=j_ingress, request=j_request,
                                 chaos=j_chaos),
    "torch": types.SimpleNamespace(ingress=t_ingress, request=t_request,
                                   chaos=t_chaos),
}


@pytest.fixture(autouse=True)
def _no_chaos():
    for pkg in PKGS.values():
        pkg.chaos.reset_chaos("")
    yield
    for pkg in PKGS.values():
        pkg.chaos.reset_chaos("")


@pytest.mark.parametrize("lib", list(PKGS))
def test_roundtrip_and_fire_and_forget(lib):
    ing = PKGS[lib].ingress
    served = []

    def submit(req) -> bool:
        served.append(req)
        req.fulfill(req.payload * 2)
        return True

    server = ing.SocketIngress(submit, port=0).start()
    client = None
    try:
        client = ing.IngressClient("127.0.0.1", server.port)
        out = client.send("m", 21, slo_ms=500.0, request_id="r1")
        assert out == {"request_id": "r1", "result": 42}
        assert client.send("m", 1, reply=False) is None
        deadline = time.monotonic() + 5
        while len(served) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(served) == 2
        assert served[0].slo_ms == 500.0 and served[0].model == "m"
    finally:
        if client is not None:
            client.close()
        server.stop()


@pytest.mark.parametrize("lib", list(PKGS))
def test_bad_request_and_rejection(lib):
    ing = PKGS[lib].ingress
    server = ing.SocketIngress(lambda req: False, port=0).start()
    client = None
    try:
        client = ing.IngressClient("127.0.0.1", server.port)
        out = client.send("m", 1, request_id="rX")
        assert out == {"request_id": "rX", "error": "rejected"}
        client._file.write(b"not json\n")
        client._file.flush()
        assert "bad request" in json.loads(client._file.readline())["error"]
    finally:
        if client is not None:
            client.close()
        server.stop()


def _conversation(pkg) -> list:
    """One scripted line sequence through ``pkg``'s ingress: every reply
    line, in order."""
    ing = pkg.ingress

    def submit(req) -> bool:
        if req.payload == "reject":
            return False
        if req.payload == "fail":
            req.reject(RuntimeError("replica blew up"))
        else:
            req.fulfill({"echo": req.payload, "model": req.model})
        return True

    server = ing.SocketIngress(submit, port=0, reply_timeout_s=10).start()
    client = None
    lines = [
        {"model_name": "m", "payload": [1, 2], "request_id": "a"},
        {"model_name": "m", "payload": "reject", "request_id": "b"},
        {"model_name": "m", "payload": "fail", "request_id": "c"},
        {"model_name": "m", "payload": 1, "reply": False},
        {"payload": 1, "request_id": "no-model"},
        {"model_name": "m", "payload": 1, "SLO": "soon"},
        "CHAOS",
        {"model_name": "n", "payload": {"k": 1.5}, "SLO": 50,
         "request_id": "e"},
    ]
    out = []
    try:
        client = ing.IngressClient("127.0.0.1", server.port)
        for msg in lines:
            if msg == "CHAOS":
                pkg.chaos.reset_chaos("ingress.handle=1")
                msg = {"model_name": "m", "payload": 9, "request_id": "d"}
            raw = json.dumps(msg).encode() + b"\n"
            client._file.write(raw)
            client._file.flush()
            if msg.get("reply", True):
                out.append(json.loads(client._file.readline()))
        client._file.write(b"{broken\n\n")
        client._file.flush()
        out.append(json.loads(client._file.readline()))
    finally:
        pkg.chaos.reset_chaos("")
        if client is not None:
            client.close()
        server.stop()
    return out


def test_conversation_matches_the_jax_ingress():
    got = _conversation(PKGS["torch"])
    assert got == _conversation(PKGS["jax"])
    assert got[0] == {"request_id": "a",
                      "result": {"echo": [1, 2], "model": "m"}}
    assert got[1]["error"] == "rejected" and "replica blew up" in got[2]["error"]
    assert "chaos injected" in got[5]["error"]


def test_ingress_into_a_port_replica():
    rep = Replica("r0", "doubler", lambda ps: [p * 2 for p in ps],
                  max_batch_size=8, batch_wait_timeout_s=0.005)
    rep.start()
    server = t_ingress.SocketIngress(rep.assign, port=0).start()
    client = None
    try:
        client = t_ingress.IngressClient("127.0.0.1", server.port)
        outs = [client.send("doubler", i, slo_ms=5000.0, request_id=str(i))
                for i in range(4)]
        assert outs == [{"request_id": str(i), "result": 2 * i}
                        for i in range(4)]
    finally:
        if client is not None:
            client.close()
        server.stop()
        rep.stop()
