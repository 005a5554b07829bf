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
(the hop ledger, the trace export, the sim's drift report). A third
runs the simulator's smoke, a partition and a migration twin, and a
live sharded front door. Another profiles DistilBERT, collates and
transcribes a clip through the ASR model and reads moe_tiny's aux loss.
The serving surface's probe imports every door, the native binding, the
worker nodes, the job manager and the state API, restores a checkpoint
into a deployment and answers one ``/v1/completions`` request; a last
one blocks grpcio as well and imports the ``serve`` package and the gRPC
door's module. The training probe (optax blocked too) takes train steps on
one device, on a dp x sp gloo world (ring attention) and through a pp x
ep pipeline of moe_tiny, and round-trips a train-state checkpoint.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_dynamic_batching_tpu")


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


# The captured-program layer: the graph runner, the hot-program registry
# and the capture ledger.
GRAPH_MODULES = ("ops/graphs.py", "ops/jit_model.py",
                 "utils/compile_ledger.py")

_GRAPH_PROBE = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import torch
from ray_dynamic_batching_tpu_torch.ops import graphs, jit_model
from ray_dynamic_batching_tpu_torch.utils.compile_ledger import get_ledger
ledger = get_ledger()
prog = ledger.instrument("toy", graphs.GraphSet(torch.device("cpu")).program(
    "toy", lambda x: x + 1))
ledger.begin_warmup()
prog(torch.zeros(3))
ledger.end_warmup()
prog(torch.zeros(3))
ledger.check_steady()
print(ledger.counts(), len(jit_model.required_for(True, True, False)))
"""


def test_captured_program_modules_import_no_jax():
    """The three modules exist, the AST scan above covers them, and with
    JAX and the JAX package blocked they import and record a warmed
    program's episode (once) on the CPU."""
    scanned = {p.relative_to(PORT).as_posix() for p in _sources()
               if PORT in p.parents}
    assert set(GRAPH_MODULES) <= scanned
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _GRAPH_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "{'toy': 1} 3"


# The simulator and the sharded front door.
SIM_MODULES = tuple(f"sim/{n}.py" for n in (
    "__init__", "__main__", "clock", "queue", "workload", "engine",
    "control", "simulator", "kvfabric", "frontdoor", "scenarios",
    "report")) + ("serve/frontdoor.py",)

_SIM_PROBE = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import json
import logging
logging.disable(logging.WARNING)
from ray_dynamic_batching_tpu_torch.serve import FrontDoor
from ray_dynamic_batching_tpu_torch.sim.__main__ import main
from ray_dynamic_batching_tpu_torch.sim.frontdoor import run_partition_sim
from ray_dynamic_batching_tpu_torch.sim.kvfabric import (
    MigrationScenario,
    run_migration_sim,
)
from ray_dynamic_batching_tpu_torch.sim.scenarios import partition_scenario
rc = main(["--smoke"])
part = run_partition_sim(partition_scenario("gossip_only"))
mig = run_migration_sim(MigrationScenario(), "migrate")
fd = FrontDoor(n_shards=2, gossip_interval_s=0.01).start()
fd.configure("m", rate_rps=10.0)
ok = fd.admit("m", payload={{"session_id": "a"}})[1]
fd.stop()
print(rc, part["reconverged"], mig["dropped"], ok, fd._thread is None)
"""


def test_sim_and_front_door_run_with_jax_blocked():
    """The simulator's modules and ``serve/frontdoor.py`` are under the
    AST scan, and with JAX and the JAX package blocked the CLI's smoke
    passes, a partition and a migration twin run, and a live front door
    admits and stops its gossip thread."""
    scanned = {p.relative_to(PORT).as_posix() for p in _sources()
               if PORT in p.parents}
    assert set(SIM_MODULES) <= scanned
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _SIM_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 True 0 True True"


_SERVABLES_PROBE = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import numpy as np
import torch
torch.set_num_threads(2)
from ray_dynamic_batching_tpu_torch.engine.collate import collate
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.models.asr import StreamingASR
from ray_dynamic_batching_tpu_torch.ops.jit_model import ASR_PROGRAMS
from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler
rng = np.random.default_rng(0)
bert = registry.get_model("distilbert_tiny", dtype=torch.float32,
                          device="cpu", seed=0)
rows = ModelProfiler(bert, timing_iters=2, warmup_iters=1).sweep(
    [1, 2], seq_buckets=[16]).rows
asr = registry.get_model("whisper_tiny_test", dtype=torch.float32,
                         device="cpu", seed=0)
(batch, n) = collate(asr, [Request(model="w", slo_ms=1e4,
                                   payload=rng.standard_normal((90, 16)))], 2)
with torch.inference_mode():
    logits = asr(*batch)
stream = StreamingASR(asr, chunk_frames=50, max_new_tokens=3)
stream.feed(rng.standard_normal((60, 16)).astype(np.float32))
lm = registry.get_model("moe_tiny", dtype=torch.float32, device="cpu",
                        seed=0)
with torch.inference_mode():
    _, aux = lm.apply_with_aux(*lm.example_inputs(2, 16))
print(len(rows), n, tuple(logits.shape), stream.transcript[0],
      float(aux) > 0, all(not p.captured for p in ASR_PROGRAMS))
"""


def test_new_servables_run_with_jax_blocked():
    """``models/distilbert.py``, ``models/asr.py`` (its own
    ``collate_audio``), ``collate_asr`` and ``CausalLM``'s no-cache
    forward with JAX and the JAX package blocked: DistilBERT profiled, a
    clip collated and transcribed, moe_tiny's aux loss."""
    scanned = {p.relative_to(PORT).as_posix() for p in _sources()
               if PORT in p.parents}
    assert {"models/distilbert.py", "models/asr.py"} <= scanned
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _SERVABLES_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == \
        "2 1 (2, 8, 256) 254 True True"


_W8_PROBE = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import torch
torch.set_num_threads(2)
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models.quant import (
    is_quantized,
    quantized_weight_bytes,
    tree_weight_bytes,
)
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.profiles.decode_profiler import (
    DecodeProfiler,
)
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
full = registry.get_model("moe_tiny", dtype=torch.float32, device="cpu",
                          seed=0)
planned = quantized_weight_bytes(full)
dep = LLMDeployment("moe_tiny", num_slots=2, max_len=32, prompt_buckets=[8],
                    default_max_new_tokens=3, dtype=torch.float32,
                    device="cpu", seed=0, quantize_weights=True)
replica = dep.make_replica("probe", DeploymentConfig(name="moe_tiny"))
model = replica.engine.model
assert is_quantized(model) and tree_weight_bytes(model) == planned
row = DecodeProfiler(model, timing_iters=2,
                     warmup_iters=1).profile_decode_config(2, 32)
full_row = DecodeProfiler(full, timing_iters=2,
                          warmup_iters=1).profile_decode_config(2, 32)
# The rows differ by exactly the weights' bytes: the int8 ones are counted.
assert full_row.hbm_bytes - row.hbm_bytes == \
    tree_weight_bytes(full) - planned > 0
req = Request(model="moe_tiny", payload={{"tokens": [1, 2, 3]}}, slo_ms=1e7)
replica.engine.queue.add_request(req)
replica.engine.run_until_idle(timeout_s=60)
print(len(req.future.result(timeout=5).tokens))
"""


def test_int8_weights_and_moe_run_with_jax_blocked():
    """``models/quant.py``, ``models/moe.py`` and ``ops/quant_matmul.py``
    with JAX blocked: moe_tiny quantized once by ``LLMDeployment``, its
    resident bytes the planner's estimate, a decode-profiler row that
    counts them (it differs from the full-precision model's row by the
    weights' bytes alone), and three greedy tokens served on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _W8_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "3"


_TP_PROBE = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import torch
torch.set_num_threads(2)
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
from tests import torch_ranks
dep = LLMDeployment("llama_tiny", num_slots=2, max_len=32, prompt_buckets=[8],
                    default_max_new_tokens=3, dtype=torch.float32,
                    device="cpu", seed=0)
replica = dep.make_replica("probe", DeploymentConfig(name="llama_tiny"),
                           devices=["cpu", "cpu"])
try:
    assert replica.engine.mesh.shape["tp"] == 2
    req = Request(model="llama_tiny", payload={{"tokens": [1, 2, 3]}},
                  slo_ms=1e7)
    replica.engine.queue.add_request(req)
    replica.engine.run_until_idle(timeout_s=60)
    ranks = replica.mesh.world.call(torch_ranks.imports_of)
    print(len(req.future.result(timeout=5).tokens), ranks)
finally:
    replica.stop(timeout_s=5.0)
"""


def test_tensor_parallel_replica_runs_with_jax_blocked():
    """``parallel/{mesh,spmd,collective}.py`` and the engine's mesh arm with
    JAX blocked: a two-device ``make_replica`` spawns its gloo rank,
    answers one request with three tokens, and no rank's process —
    the spawned one imports the port as well — has JAX, flax or the JAX
    package loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _TP_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "3 [[], []]"


_SURFACE_PROBE = """
import sys
import tempfile
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import http.client
import json
import torch
torch.set_num_threads(2)
import ray_dynamic_batching_tpu_torch.engine.ingress
import ray_dynamic_batching_tpu_torch.engine.shm_bridge
import ray_dynamic_batching_tpu_torch.runtime.cluster
import ray_dynamic_batching_tpu_torch.runtime.jobs
import ray_dynamic_batching_tpu_torch.runtime.native
import ray_dynamic_batching_tpu_torch.serve.dashboard
import ray_dynamic_batching_tpu_torch.serve.grpc_proxy
import ray_dynamic_batching_tpu_torch.state
import ray_dynamic_batching_tpu_torch.utils.compile_cache
from ray_dynamic_batching_tpu_torch.models import causal_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_to_flax
from ray_dynamic_batching_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
)
from ray_dynamic_batching_tpu_torch.serve import CompletionsHandle
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
from ray_dynamic_batching_tpu_torch.serve.proxy import HTTPProxy, ProxyRouter
from ray_dynamic_batching_tpu_torch.serve.router import Router
root = tempfile.mkdtemp()
src = causal_lm.CausalLM(causal_lm.TINY_LM, name="llama_tiny",
                         dtype=torch.float32, device="cpu", seed=7)
CheckpointManager(root).save(3, params_to_flax(src))
dep = LLMDeployment("llama_tiny", num_slots=2, max_len=32,
                    prompt_buckets=[8], default_max_new_tokens=3,
                    dtype=torch.float32, device="cpu", checkpoint_dir=root,
                    warmup=False)
replica = dep.make_replica("probe", DeploymentConfig(name="llama_tiny"))
assert torch.equal(replica.engine.model.module.final_norm.scale,
                   src.module.final_norm.scale)
replica.start()
router = Router("llama_tiny", replicas=[replica], max_assign_timeout_s=30.0)
routes = ProxyRouter()
routes.set_route("/v1/completions", CompletionsHandle(
    DeploymentHandle(router, default_slo_ms=1e7), model="llama_tiny"))
proxy = HTTPProxy(routes, host="127.0.0.1", port=0).start()
try:
    conn = http.client.HTTPConnection("127.0.0.1", proxy.port, timeout=60)
    conn.request("POST", "/v1/completions",
                 body=json.dumps({{"prompt": [1, 2, 3], "max_tokens": 3}}))
    body = json.loads(conn.getresponse().read())
    conn.close()
    print(body["result"]["usage"]["completion_tokens"],
          body["result"]["choices"][0]["finish_reason"])
finally:
    proxy.stop()
    router.close()
    replica.stop(timeout_s=5.0, drain=False)
"""


def test_serving_surface_runs_with_jax_blocked():
    """Every module of the serving surface imports with JAX, flax and the
    JAX package blocked; a checkpoint the port wrote restores into an
    ``LLMDeployment(checkpoint_dir=)`` that answers one
    ``/v1/completions`` request on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _SURFACE_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "3 length"


_NO_GRPC_PROBE = """
import sys
for name in {forbidden!r} + ("grpc",):
    sys.modules[name] = None      # any import of them now raises
import ray_dynamic_batching_tpu_torch.serve as serve
from ray_dynamic_batching_tpu_torch.serve import grpc_proxy
assert serve.CompletionsHandle is not None
assert grpc_proxy.HAVE_GRPC is False and grpc_proxy.grpc is None
try:
    grpc_proxy.GRPCProxy(serve.ProxyRouter())
except RuntimeError as e:
    print(e)
"""


def test_serve_imports_without_grpc():
    """With grpcio blocked too, the ``serve`` package and the gRPC door's
    module import; building the door raises and says why."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _NO_GRPC_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "grpcio is not installed"


_TRAIN_PROBE = """
import sys, tempfile
for name in {forbidden!r}:
    sys.modules[name] = None      # any import of them now raises
import numpy as np
import torch
torch.set_num_threads(2)
from ray_dynamic_batching_tpu_torch.models import causal_lm
from ray_dynamic_batching_tpu_torch.ops import ring_attention  # noqa: F401
from ray_dynamic_batching_tpu_torch.parallel import mesh, optim, pipeline
from ray_dynamic_batching_tpu_torch.parallel import train
from ray_dynamic_batching_tpu_torch.runtime import checkpoint
from tests import torch_ranks
rng = np.random.default_rng(0)
tok = rng.integers(0, 512, (4, 16)).astype(np.int32)
msk = np.ones((4, 16), np.int32)
opt = optim.adamw(1e-3)
lm = causal_lm.CausalLM(causal_lm.TINY_LM, name="llama_tiny",
                        dtype=torch.float32, device="cpu", seed=0)
p, s = train.make_sharded_train_state(lm, None, opt)
step = train.make_train_step(lm, None, opt)
losses = [float(step(p, s, tok, msk)[2]) for _ in range(2)]
with tempfile.TemporaryDirectory() as d:
    m = checkpoint.CheckpointManager(d)
    checkpoint.save_train_state(m, 2, p, s, model=lm)
    p2, s2, at = checkpoint.restore_train_state(m, p, s, model=lm)
    assert at == 2 and all(torch.equal(p[n], p2[n]) for n in p)
worlds = []
try:
    dpsp = mesh.build_mesh(mesh.MeshConfig(dp=2, sp=2), ["cpu"] * 4)
    worlds.append(dpsp)
    q, o = train.make_sharded_train_state(lm, dpsp, opt)
    losses.append(float(train.make_train_step(lm, dpsp, opt)(q, o, tok, msk)[2]))
    ranks = dpsp.world.call(torch_ranks.imports_of)
    ppep = mesh.build_mesh(mesh.MeshConfig(pp=2, ep=2), ["cpu"] * 4)
    worlds.append(ppep)
    moe = causal_lm.CausalLM(causal_lm.TINY_MOE, name="moe_tiny",
                             dtype=torch.float32, device="cpu", seed=0)
    pm = pipeline.PipelinedCausalLM(moe, ppep)
    q, o = pipeline.make_pp_train_state(pm, opt)
    losses.append(float(pipeline.make_pp_train_step(pm, opt)(q, o, tok, msk)[2]))
    ranks += ppep.world.call(torch_ranks.imports_of)
finally:
    for w in worlds:
        w.shutdown()
print(all(np.isfinite(losses)), losses[1] < losses[0], ranks)
"""


def test_training_runs_with_jax_blocked():
    """``parallel/{train,pipeline,optim}.py``, ``ops/ring_attention.py`` and
    the train-state checkpoint with JAX, flax, optax and the JAX package
    blocked, on the leader and on every spawned rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _TRAIN_PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=150, cwd=str(ROOT), env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == (
        "True True " + str([[]] * 8))
