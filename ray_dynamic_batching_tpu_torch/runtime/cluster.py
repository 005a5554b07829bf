"""Multi-process cluster — worker "nodes" as local processes.

Re-creates the reference's multi-node-without-a-cluster strategy
(``python/ray/cluster_utils.py:135`` — multiple raylets as local processes
in one machine): a worker node here is a spawned process running a replica
loop behind the C++ shm substrate, and the head process keeps the
controller/router and reaches it through a :class:`ProcessReplica` adapter
that speaks the standard replica surface. The division of labor mirrors the
reference's two-node serving split:

- head: controller + router + (optionally) HTTP ingress;
- worker: execution loop, fed request metadata over the shm MPMC ring and
  payloads/results over the shm object store (``engine/shm_bridge.py`` —
  the gRPC+plasma pairing of the reference, SURVEY.md §2.2).

Failure detection rides per-node heartbeat files (the GCS health-check
role, ``gcs_health_check_manager.h:39``): a killed worker stops beating,
``ProcessReplica.healthy()`` goes false, and the controller's UNCHANGED
heal path replaces the node — cross-process replica failover without any
cluster-specific control-plane code.

Own copy of ``ray_dynamic_batching_tpu/runtime/cluster.py`` with its
import paths rewritten. Worker nodes are host-side executors by the
reference's design (its ``:70-74``: "keep them off the accelerator so N
nodes don't fight over one chip"): a node's factory runs host code, and
the port keeps the rule by hiding every card from the child
(``CUDA_VISIBLE_DEVICES`` empty, set before anything in it can touch
CUDA), so the child never initializes CUDA. This is that design, not a
fallback: a replica that computes on the card runs in the head process
(``LLMDeployment``) or gets its own card through placement. Nodes are
started with the ``spawn`` context, never forked: the head has
initialized CUDA, and a forked child would inherit its context. The
reference calls ``record_multiplexed_model_locked`` without importing it
(a multiplexed request would raise ``NameError`` there); the port imports
it from ``serve/replica.py``.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_dynamic_batching_tpu_torch.engine.request import Request, RequestDropped
from ray_dynamic_batching_tpu_torch.serve.replica import (
    record_multiplexed_model_locked,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster")

HEARTBEAT_INTERVAL_S = 0.1
READY_TIMEOUT_S = 30.0


# --- worker process --------------------------------------------------------

def demo_echo_factory() -> Callable[[List[Any]], List[Any]]:
    """Batch identity — the cross-process smoke deployment."""
    return lambda payloads: list(payloads)


def demo_double_factory() -> Callable[[List[Any]], List[Any]]:
    return lambda payloads: [p * 2 for p in payloads]


def _resolve_factory(spec: str) -> Callable:
    """'pkg.module:callable' → the callable, imported in THIS process (the
    reference re-imports deployment code on each node the same way)."""
    mod_name, _, fn_name = spec.partition(":")
    return getattr(importlib.import_module(mod_name), fn_name)


def _worker_main(
    shm_name: str,
    hb_path: str,
    deployment: str,
    replica_id: str,
    factory_spec: str,
    replica_options: Dict[str, Any],
) -> None:
    """Entry point of a worker node process."""
    # Worker nodes are host-side executors; keep them off the card so N
    # nodes don't fight over one device (compute-on-card replicas run in
    # the head process or get their own card via placement groups). Set
    # before any CUDA call in this process: CUDA reads it when it starts.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""

    from ray_dynamic_batching_tpu_torch.engine.shm_bridge import ShmBridge
    from ray_dynamic_batching_tpu_torch.serve.replica import Replica

    fn = _resolve_factory(factory_spec)()
    replica = Replica(
        replica_id=replica_id,
        deployment=deployment,
        fn=fn,
        **replica_options,
    )
    replica.start()
    bridge = ShmBridge(shm_name, submit=replica.assign, create=True)
    bridge.start()
    # First beat doubles as the readiness signal: the shm ring exists now,
    # so the head may attach.
    while True:
        tmp = hb_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, hb_path)
        time.sleep(HEARTBEAT_INTERVAL_S)


# --- head-side adapter -----------------------------------------------------

class ProcessReplica:
    """A worker-node process behind the standard replica surface.

    Duck-typed to what the router, autoscaler, and controller state machine
    consume (``queue_len``/``accepting``/``assign``/``healthy``/``stop``/
    ``stats``), so a process node plugs into the existing control plane
    exactly like an in-process replica.

    Startup is LAZY: ``__init__`` only spawns the process (milliseconds),
    so the controller's lock hold stays bounded; the node reports
    ``accepting() == False`` until the worker's first heartbeat lands and
    the shm frontend attaches, and ``healthy()`` grants a startup grace of
    ``READY_TIMEOUT_S`` so the heal path doesn't replace a node that is
    still importing torch.

    One poller thread multiplexes every in-flight request (non-blocking
    ``try_result`` sweep) — no thread-per-request, and ``stop`` joins the
    poller BEFORE closing the shm handles (the use-after-free hazard
    ``shm_bridge.py`` documents).
    """

    def __init__(
        self,
        replica_id: str,
        deployment: str,
        factory_spec: str,
        workdir: str,
        max_ongoing_requests: int = 256,
        heartbeat_stale_s: float = 1.0,
        replica_options: Optional[Dict[str, Any]] = None,
        result_timeout_s: float = 30.0,
    ) -> None:
        self.replica_id = replica_id
        self.deployment = deployment
        self.max_ongoing_requests = max_ongoing_requests
        self.heartbeat_stale_s = heartbeat_stale_s
        self.result_timeout_s = result_timeout_s
        self.shm_name = f"rdbnode-{uuid.uuid4().hex[:10]}"
        os.makedirs(workdir, exist_ok=True)
        self.hb_path = os.path.join(
            workdir, replica_id.replace("#", "_") + ".hb"
        )
        if os.path.exists(self.hb_path):
            os.unlink(self.hb_path)

        self.frontend = None  # attaches on first heartbeat
        self._started_at = time.monotonic()
        # oid -> (request, deadline)
        self._pending: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._poller: Optional[threading.Thread] = None
        self.loaded_models: List[str] = []
        self.max_multiplexed_models = 8

        ctx = mp.get_context("spawn")  # never fork a CUDA-initialized head
        self.process = ctx.Process(
            target=_worker_main,
            args=(
                self.shm_name,
                self.hb_path,
                deployment,
                replica_id,
                factory_spec,
                dict(replica_options or {}),
            ),
            daemon=True,
            name=f"node-{replica_id}",
        )
        self.process.start()
        logger.info(
            "node %s spawning (pid %d, shm %s)",
            replica_id, self.process.pid, self.shm_name,
        )

    # --- readiness ---------------------------------------------------------
    def _try_attach(self) -> bool:
        """Attach the shm frontend once the worker's first beat confirms
        the ring exists. Cheap when already attached."""
        if self.frontend is not None:
            return True
        if not os.path.exists(self.hb_path):
            return False
        with self._lock:
            if self.frontend is None and not self._closed:
                from ray_dynamic_batching_tpu_torch.engine.shm_bridge import (
                    ShmFrontend,
                )

                self.frontend = ShmFrontend(self.shm_name, create=False)
                logger.info("node %s ready", self.replica_id)
        return self.frontend is not None

    def wait_ready(self, timeout_s: float = READY_TIMEOUT_S) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._try_attach():
                return True
            if not self.process.is_alive():
                return False
            time.sleep(0.01)
        return False

    # --- router-facing surface -------------------------------------------
    def queue_len(self) -> int:
        with self._lock:
            return len(self._pending)

    def accepting(self) -> bool:
        return (
            not self._closed
            and self.process.is_alive()
            and self._try_attach()
            and self.queue_len() < self.max_ongoing_requests
        )

    def assign(self, request: Request) -> bool:
        if not self.accepting():
            return False
        deadline = time.monotonic() + min(
            self.result_timeout_s, request.slo_ms / 1000.0
        )
        with self._lock:
            if self._closed or self.frontend is None:
                return False
            try:
                oid = self.frontend.submit(
                    request.model, request.payload, request.slo_ms,
                    request_id=request.request_id,
                )
            except RuntimeError:
                return False  # ring/store full: retryable, router backs off
            self._pending[oid] = (request, deadline)
            if self._poller is None:
                self._poller = threading.Thread(
                    target=self._poll_loop,
                    name=f"poll-{self.replica_id}",
                    daemon=True,
                )
                self._poller.start()
            if request.multiplexed_model_id:
                record_multiplexed_model_locked(
                    self.loaded_models,
                    request.multiplexed_model_id,
                    self.max_multiplexed_models,
                )
        return True

    def record_multiplexed_model(self, model_id: str) -> None:
        with self._lock:
            record_multiplexed_model_locked(
                self.loaded_models, model_id, self.max_multiplexed_models
            )

    def _poll_loop(self) -> None:
        """Sweep every outstanding oid with non-blocking probes; one thread
        serves all in-flight requests of this node."""
        while not self._closed:
            now = time.monotonic()
            with self._lock:
                items = list(self._pending.items())
            if not items:
                time.sleep(0.005)
                continue
            for oid, (request, deadline) in items:
                outcome = None  # (kind, value)
                try:
                    found, value = self.frontend.try_result(oid)
                    if found:
                        outcome = ("ok", value)
                    elif now > deadline:
                        outcome = ("err", TimeoutError(
                            f"{self.replica_id}: no result for "
                            f"{request.request_id}"
                        ))
                except Exception as e:  # noqa: BLE001 — worker-side error
                    outcome = ("err", e)
                if outcome is None:
                    continue
                with self._lock:
                    self._pending.pop(oid, None)
                kind, value = outcome
                if kind == "ok":
                    request.fulfill(value)
                else:
                    request.reject(value)
            time.sleep(0.002)

    # --- controller-facing lifecycle --------------------------------------
    def start(self) -> None:
        pass  # the process spawned in __init__; readiness is lazy

    def healthy(self, stall_timeout_s: float = 60.0) -> bool:
        if self._closed or not self.process.is_alive():
            return False
        try:
            with open(self.hb_path) as f:
                last = float(f.read().strip() or 0)
        except (OSError, ValueError):
            # No first beat yet: healthy within the startup grace window.
            return (time.monotonic() - self._started_at) < READY_TIMEOUT_S
        return (time.time() - last) < max(
            self.heartbeat_stale_s, 3 * HEARTBEAT_INTERVAL_S
        )

    def drain_queue(self) -> List[Request]:
        return []  # queued work lives in the worker process

    def stop(self, timeout_s: float = 5.0, drain: bool = True) -> None:
        if self._closed:
            return
        if drain:
            deadline = time.monotonic() + timeout_s
            while self.queue_len() > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        self._closed = True
        self.process.terminate()
        self.process.join(timeout_s)
        if self.process.is_alive():
            self.process.kill()
            self.process.join(1.0)
        # The poller must be OUT of the C shm calls before close() frees
        # the mappings (shm_bridge.py:240 documents the segfault); leak
        # rather than close under a live thread.
        with self._lock:
            poller = self._poller
        if poller is not None:
            poller.join(2.0)
        exc = RequestDropped(f"{self.replica_id} stopped")
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
        for request, _deadline in leftovers:
            request.reject(exc)
        if poller is not None and poller.is_alive():
            logger.error(
                "node %s poller did not exit; leaking shm handles",
                self.replica_id,
            )
        elif self.frontend is not None:
            try:
                self.frontend.close(unlink=True)
            except Exception:  # noqa: BLE001 — shm may already be gone
                pass
        try:
            os.unlink(self.hb_path)
        except OSError:
            pass
        logger.info("node %s stopped", self.replica_id)

    def reconfigure(self, **kwargs) -> None:
        mor = kwargs.get("max_ongoing_requests")
        if mor is not None:
            self.max_ongoing_requests = mor

    def stats(self) -> dict:
        return {
            "ongoing": float(self.queue_len()),
            "pid": float(self.process.pid or -1),
            "alive": float(self.process.is_alive()),
        }


class ProcessDeployment:
    """Controller factory: every replica of the deployment is its own
    worker-node process (``make_replica`` protocol, like LLMDeployment)."""

    def __init__(
        self,
        factory_spec: str,
        workdir: str,
        heartbeat_stale_s: float = 1.0,
        replica_options: Optional[Dict[str, Any]] = None,
        result_timeout_s: float = 30.0,
    ) -> None:
        self.factory_spec = factory_spec
        self.workdir = workdir
        self.heartbeat_stale_s = heartbeat_stale_s
        self.replica_options = replica_options or {}
        self.result_timeout_s = result_timeout_s

    def make_replica(
        self, replica_id: str, config: Any, devices: Any = None,
    ) -> ProcessReplica:
        return ProcessReplica(
            replica_id=replica_id,
            deployment=config.name,
            factory_spec=self.factory_spec,
            workdir=self.workdir,
            max_ongoing_requests=config.max_ongoing_requests,
            heartbeat_stale_s=self.heartbeat_stale_s,
            replica_options=self.replica_options,
            result_timeout_s=self.result_timeout_s,
        )
