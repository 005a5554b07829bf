"""Worker nodes as spawned processes behind the shm bridge, on the port's
modules (CPU).

The cases of ``tests/test_cluster.py`` against the port's
``runtime/cluster.py``: a cross-process roundtrip through one
``ProcessReplica``, a killed node detected by its heartbeat, the
controller's unchanged heal path replacing a SIGKILLed node while the
deployment keeps serving, and HTTP -> proxy -> router -> shm -> worker ->
back. Beside them: a node never sees a card (its factory reports
``CUDA_VISIBLE_DEVICES`` and ``torch.cuda.is_initialized()``). Every node,
controller and proxy is stopped in a ``finally``; every wait has a
timeout.
"""

import json
import socket
import time

import pytest

from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.runtime.cluster import (
    ProcessDeployment,
    ProcessReplica,
)
from ray_dynamic_batching_tpu_torch.serve.controller import (
    DeploymentConfig,
    ServeController,
)
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle

ECHO = "ray_dynamic_batching_tpu_torch.runtime.cluster:demo_echo_factory"
DOUBLE = "ray_dynamic_batching_tpu_torch.runtime.cluster:demo_double_factory"
PROBE = "tests.test_torch_cluster:device_probe_factory"


def device_probe_factory():
    """A node's batch function that reports what the node can see."""
    import os

    import torch

    def probe(payloads):
        return [{"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                 "initialized": torch.cuda.is_initialized()}
                for _ in payloads]

    return probe


@pytest.mark.timeout(120)
class TestProcessNode:
    def test_cross_process_roundtrip(self, tmp_path):
        replica = ProcessReplica("node#0", "echo", ECHO, str(tmp_path))
        try:
            assert replica.wait_ready(60)
            req = Request(model="echo", payload=[1, 2, 3], slo_ms=30_000.0)
            assert replica.assign(req)
            assert req.future.result(timeout=30) == [1, 2, 3]
            assert replica.healthy()
            assert replica.stats()["alive"] == 1.0
        finally:
            replica.stop(timeout_s=2.0)
        assert not replica.healthy()

    def test_killed_node_detected(self, tmp_path):
        replica = ProcessReplica("node#1", "echo", ECHO, str(tmp_path),
                                 heartbeat_stale_s=0.5)
        try:
            assert replica.wait_ready(60)
            assert replica.healthy()
            replica.process.kill()
            deadline = time.monotonic() + 10
            while replica.healthy() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not replica.healthy()
        finally:
            replica.stop(timeout_s=1.0)

    def test_node_never_sees_a_card(self, tmp_path):
        replica = ProcessReplica("node#2", "probe", PROBE, str(tmp_path))
        try:
            assert replica.wait_ready(60)
            req = Request(model="probe", payload=0, slo_ms=30_000.0)
            assert replica.assign(req)
            assert req.future.result(timeout=30) == {"visible": "",
                                                     "initialized": False}
        finally:
            replica.stop(timeout_s=2.0)


@pytest.mark.timeout(180)
class TestTwoHostServing:
    def test_controller_serves_and_fails_over_across_processes(
            self, tmp_path):
        controller = ServeController(control_interval_s=0.1)
        try:
            dep = ProcessDeployment(DOUBLE, str(tmp_path),
                                    heartbeat_stale_s=0.5,
                                    result_timeout_s=20.0)
            router = controller.deploy(
                DeploymentConfig(name="double", num_replicas=2,
                                 max_restarts=3), factory=dep)
            controller.start()
            handle = DeploymentHandle(router, default_slo_ms=30_000.0)
            for r in controller._deployments["double"].replicas:
                assert r.wait_ready(60)
            futs = [handle.remote(i) for i in range(8)]
            assert [f.result(timeout=30) for f in futs] == [
                i * 2 for i in range(8)]
            victims = list(controller._deployments["double"].replicas)
            pids_before = {v.process.pid for v in victims}
            victims[0].process.kill()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                status = controller.status()["double"]
                live = controller._deployments["double"].replicas
                if (status["running_replicas"] == 2
                        and all(r.healthy() for r in live)
                        and {r.process.pid for r in live} != pids_before):
                    break
                time.sleep(0.1)
            else:
                pytest.fail("controller did not replace the killed node")
            for r in controller._deployments["double"].replicas:
                assert r.wait_ready(60)
            futs = [handle.remote(i) for i in range(8)]
            assert [f.result(timeout=30) for f in futs] == [
                i * 2 for i in range(8)]
        finally:
            controller.shutdown()

    def test_http_ingress_to_remote_node(self, tmp_path):
        from ray_dynamic_batching_tpu_torch.serve.proxy import (
            HTTPProxy,
            ProxyRouter,
        )

        controller = ServeController(control_interval_s=0.2)
        proxy = None
        try:
            dep = ProcessDeployment(ECHO, str(tmp_path),
                                    result_timeout_s=20.0)
            router = controller.deploy(
                DeploymentConfig(name="echo", num_replicas=1), factory=dep)
            prouter = ProxyRouter()
            prouter.set_route("/api/echo", DeploymentHandle(router))
            proxy = HTTPProxy(prouter, port=0).start()
            for r in controller._deployments["echo"].replicas:
                assert r.wait_ready(60)
            body = json.dumps({"x": [1, 2]}).encode()
            req = (f"POST /api/echo HTTP/1.1\r\nHost: h\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body
            with socket.create_connection((proxy.host, proxy.port),
                                          timeout=30) as s:
                s.sendall(req)
                s.settimeout(30)
                buf = b""
                while b"\r\n\r\n" not in buf:
                    buf += s.recv(65536)
                head, rest = buf.split(b"\r\n\r\n", 1)
                want = int([line for line in head.decode().split("\r\n")
                            if line.lower().startswith("content-length")][0]
                           .split(":")[1])
                while len(rest) < want:
                    rest += s.recv(65536)
            assert json.loads(rest[:want])["result"] == {"x": [1, 2]}
        finally:
            if proxy is not None:
                proxy.stop()
            controller.shutdown()
