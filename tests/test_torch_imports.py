"""The port imports neither JAX, flax nor the JAX package.

An AST scan of every module of ``ray_dynamic_batching_tpu_torch`` and of
the card scripts (``chip_smoke.py``, ``flash_variants.py``,
``replan_rules.py``) matches whole module names (``ray_dynamic_batching_tpu``
is a prefix of ``ray_dynamic_batching_tpu_torch`` as a string, not as a
module); a subprocess with those modules blocked imports the port (the profiles
package, the packers, the colocation executor and the live scheduler
among it), profiles and packs a tiny model, serves it on the CPU, and
deploys it through the port's controller and handle; then profiles a
tiny vision model with ``ModelProfiler`` and serves it through a
``ReplicaEngine`` under the vision ``LiveScheduler``. A second probe,
with the same modules blocked, captures a handle request's flight record
(the hop ledger, the trace export, the sim's drift report).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ray_dynamic_batching_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_dynamic_batching_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / name
        for name in ("chip_smoke.py", "flash_variants.py", "replan_rules.py")]


def test_whole_name_matching():
    assert _forbidden("jax.numpy") and _forbidden("ray_dynamic_batching_tpu")
    assert _forbidden("ray_dynamic_batching_tpu.ops.attention")
    assert not _forbidden("ray_dynamic_batching_tpu_torch.ops.attention")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_PROBE = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import torch
torch.set_num_threads(2)
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.serve.controller import (
    DeploymentConfig,
    ServeController,
)
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
dep = LLMDeployment("llama_tiny", num_slots=2, max_len=32,
                    prompt_buckets=[8], default_max_new_tokens=3,
                    dtype=torch.float32, device="cpu", seed=0)
replica = dep.make_replica("probe", DeploymentConfig(name="llama_tiny"))
engine = replica.engine
from ray_dynamic_batching_tpu_torch import state
from ray_dynamic_batching_tpu_torch.engine.colocate import (
    ColocatedLLMEngines,
)
from ray_dynamic_batching_tpu_torch.models.quant import tree_weight_bytes
from ray_dynamic_batching_tpu_torch.profiles.decode_profiler import (
    DecodeProfiler,
)
from ray_dynamic_batching_tpu_torch.profiles.profiler import _is_oom
from ray_dynamic_batching_tpu_torch.scheduler.llm_control import (
    LLMLiveScheduler,
    deployment_engine_factory,
)
from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
    LLMSession,
    pack_llm_engines,
)
row = DecodeProfiler(engine.model, timing_iters=2,
                     warmup_iters=1).profile_decode_config(2, 32)
assert row.latency_ms > 0 and row.hbm_bytes > tree_weight_bytes(engine.model)
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
chips = pack_llm_engines([LLMSession("m", 10.0, 1e4)],
                         {{"m": BatchProfile("m_decode", [row])}})
assert chips[0][0].num_slots == 2
req = Request(model="llama_tiny", payload={{"tokens": [1, 2, 3]}},
              slo_ms=1e7)
engine.queue.add_request(req)
engine.run_until_idle(timeout_s=60)
print(len(req.future.result(timeout=5).tokens))
import numpy as np
from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
from ray_dynamic_batching_tpu_torch.engine.worker import ReplicaEngine
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler
from ray_dynamic_batching_tpu_torch.scheduler.control import LiveScheduler
from ray_dynamic_batching_tpu_torch.scheduler.nexus import SquishyBinPacker
vhost = ModelHost(device="cpu")
vprof = ModelProfiler(vhost.acquire("vit_tiny"), timing_iters=2,
                      warmup_iters=1).sweep([1, 2])
vhost.release("vit_tiny")
vq = QueueManager()
veng = ReplicaEngine("v0", vq, vhost)
vsched = LiveScheduler(SquishyBinPacker({{"vit_tiny": vprof}}), [veng],
                       queues=vq)
vsched.register_model("vit_tiny", slo_ms=10000.0)
veng.start()
try:
    vsched.rebalance(rates={{"vit_tiny": 5.0}})
    vreq = Request(model="vit_tiny", payload=np.zeros((32, 32, 3),
                                                      np.float32), slo_ms=1e7)
    assert vsched.submit_request(vreq)
    assert vreq.future.result(timeout=60).shape == (10,)
finally:
    veng.stop()
ctl = ServeController(control_interval_s=0.1)
try:
    router = ctl.deploy(DeploymentConfig(name="llama_tiny"), factory=dep)
    ctl.start()
    out = DeploymentHandle(router).remote({{"tokens": [4, 5]}})
    print(len(out.result(timeout=60).tokens),
          ctl.status()["llama_tiny"]["running_replicas"])
finally:
    ctl.shutdown()
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-2:] == ["3", "3 1"]


_TRACE_PROBE = """
import sys
import time
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import torch
torch.set_num_threads(2)
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
from ray_dynamic_batching_tpu_torch.serve.router import Router
from ray_dynamic_batching_tpu_torch.sim.report import hop_drift_report
from ray_dynamic_batching_tpu_torch.utils.hops import (
    hop_sketches,
    request_ledgers,
)
from ray_dynamic_batching_tpu_torch.utils.trace_export import (
    ChromeTraceCollector,
)
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer
dep = LLMDeployment("llama_tiny", num_slots=2, max_len=32,
                    prompt_buckets=[8], default_max_new_tokens=3,
                    dtype=torch.float32, device="cpu", seed=0, warmup=False)
replica = dep.make_replica("probe", DeploymentConfig(name="llama_tiny"))
replica.start()
router = Router("llama_tiny", replicas=[replica])
collector = ChromeTraceCollector()
tracer().set_exporter(collector.export)
try:
    out = DeploymentHandle(router).remote({{"tokens": [4, 5]}})
    print(len(out.result(timeout=60).tokens))
    # decode.sequence is recorded just after the future resolves.
    deadline = time.monotonic() + 10
    while (not any(s.name == "decode.sequence" for s in collector.spans)
           and time.monotonic() < deadline):
        time.sleep(0.01)
finally:
    tracer().reset()
    router.close()
    replica.stop(timeout_s=5.0, drain=False)
ledgers, _skipped = request_ledgers(collector.spans)
ledgers[0].check()
print(sorted(ledgers[0].hops))
print(sorted({{s.name for s in collector.spans
               if s.trace_id == ledgers[0].trace_id}}))
sketches = hop_sketches(ledgers)
print(hop_drift_report(sketches, sketches, min_count=1)["ok"])
"""


def test_flight_recorder_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _TRACE_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    n, hops, names, ok = out.stdout.strip().splitlines()[-4:]
    assert n == "3" and ok == "True"
    # The handle.remote root closes once the request is routed: its
    # ledger holds the routing and the queue; the decode spans join the
    # same trace past it.
    assert {"router.assign", "queue.wait"} <= set(json.loads(
        hops.replace("'", '"')))
    assert {"handle.remote", "decode.prefill", "decode.sequence"} <= set(
        json.loads(names.replace("'", '"')))
