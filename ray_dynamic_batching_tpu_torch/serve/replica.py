"""Serve replica — one worker executing a deployment's callable with
opportunistic batching.

Own copy of ``ray_dynamic_batching_tpu/serve/replica.py``, whole, with
its import paths rewritten.

Re-creates Ray Serve's ``ReplicaActor``
(``python/ray/serve/_private/replica.py:233``: ``handle_request`` :515-544,
``UserCallableWrapper`` :810, per-replica metrics :92) fused with
``@serve.batch`` (``python/ray/serve/batching.py:530``): the replica's loop
pulls size-or-timeout batches from its own queue and invokes the user
callable once per batch.

TPU-first notes: for model deployments the callable typically closes over a
pre-compiled bucket executor (see ``engine.worker``/``engine.decode``); the
replica layer itself is model-agnostic — it owns queueing, concurrency
control, health, and stats, mirroring how Serve wraps arbitrary callables.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from contextlib import ExitStack

from ray_dynamic_batching_tpu_torch.engine.batching import OpportunisticBatch
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request, RequestDropped
from ray_dynamic_batching_tpu_torch.serve.failover import PoisonRequest, is_retryable
from ray_dynamic_batching_tpu_torch.serve.quarantine import poison_fingerprint
from ray_dynamic_batching_tpu_torch.utils.chaos import chaos
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.tracing import link_to, tracer

logger = get_logger("replica")

REPLICA_REQUESTS = m.Counter(
    "rdb_replica_requests_total", "Requests processed",
    tag_keys=("deployment", "replica"),
)
REPLICA_BATCHES = m.Counter(
    "rdb_replica_batches_total", "Batches processed",
    tag_keys=("deployment", "replica"),
)
REPLICA_ERRORS = m.Counter(
    "rdb_replica_errors_total", "Callable errors",
    tag_keys=("deployment", "replica"),
)


# Replica executing on the current thread (set around user-callable
# execution): lets in-callable framework code — e.g. the @multiplexed
# loader cache — report ground-truth model residency back to the replica
# the router reads, without threading a handle through the user's code.
_current = threading.local()


def current_replica() -> Optional["Replica"]:
    return getattr(_current, "replica", None)


def record_multiplexed_model_locked(
    models: List[str], model_id: str, cap: int
) -> None:
    """Shared multiplex-LRU update (caller holds its own lock): refresh
    recency, evict the coldest past ``cap`` — the ref replica unloading its
    LRU model. Used by in-process replicas and process nodes alike so the
    policy cannot diverge."""
    if model_id in models:
        models.remove(model_id)
    models.append(model_id)
    while len(models) > cap:
        models.pop(0)


class Replica:
    """One deployment replica: queue + batching loop around a user callable.

    ``fn`` maps a list of payloads to a list of results (the ``@serve.batch``
    contract). ``max_ongoing_requests`` bounds queued+running work — the
    router's pow-2 scheduler reads :meth:`queue_len` and respects this cap
    (ref replica_scheduler/replica_wrapper.py queue-length protocol).
    """

    def __init__(
        self,
        replica_id: str,
        deployment: str,
        fn: Callable[[List[Any]], Sequence[Any]],
        max_batch_size: int = 8,
        batch_wait_timeout_s: float = 0.005,
        max_ongoing_requests: int = 256,
    ) -> None:
        self.replica_id = replica_id
        self.deployment = deployment
        self.fn = fn
        self.max_ongoing_requests = max_ongoing_requests
        self.queue = RequestQueue(deployment, max_len=max_ongoing_requests)
        self.policy = OpportunisticBatch(
            max_batch_size=max_batch_size,
            batch_wait_timeout_s=batch_wait_timeout_s,
        )
        self._ongoing = 0
        self._ongoing_lock = threading.Lock()
        # Multiplexed models resident on this replica, most-recent last
        # (ref replica multiplex LRU surfaced to the pow-2 scheduler).
        self.loaded_models: List[str] = []
        self.max_multiplexed_models = 8
        # Config version this replica was built from (stamped by the
        # controller; rolling updates retire mismatched stamps).
        self.version = ""
        self._stopped = False
        self._run = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Drained after each batch completes: lets in-callable framework
        # code (e.g. the @multiplexed cache) defer resource release until
        # no request in the current batch can still be using it.
        self._post_batch_hooks: List[Callable[[], None]] = []
        self._hooks_lock = threading.Lock()
        self.last_heartbeat = time.monotonic()
        self.started_at = time.monotonic()
        self._batch_started_at: Optional[float] = None
        # Failover sink (serve/failover.FailoverManager), wired by the
        # router on registration: retryable system failures hand their
        # batch here for re-dispatch instead of poisoning the futures.
        # None (bare replicas in tests / engine tier) = reject as before.
        self.failure_sink = None
        # Quarantine registry (serve/quarantine.QuarantineRegistry), wired
        # by the router on registration: a non-retryable BATCH failure on a
        # wired replica triggers query-of-death bisection instead of
        # rejecting every co-batched innocent. None = legacy reject-all.
        self.quarantine = None
        self.bisect_probes = 0
        self.rescue_batches = 0
        self.poison_isolated = 0

    # --- router-facing surface -------------------------------------------
    def queue_len(self) -> int:
        """Queued + in-flight, the pow-2 routing signal."""
        with self._ongoing_lock:
            return len(self.queue) + self._ongoing

    def accepting(self) -> bool:
        """Not-yet-started replicas accept (they drain once started);
        stopped replicas never do."""
        return not self._stopped and self.queue_len() < self.max_ongoing_requests

    def assign(self, request: Request) -> bool:
        """Enqueue, declining when saturated (ref
        ``handle_request_with_rejection``, replica.py:544). A declined
        request stays retryable — the router owns terminal rejection."""
        if not self.accepting():
            return False
        ok = self.queue.add_request(request, reject_on_full=False)
        if ok and request.multiplexed_model_id:
            self.record_multiplexed_model(request.multiplexed_model_id)
        return ok

    def record_multiplexed_model(self, model_id: str) -> None:
        """Mark a multiplexed model resident here. Locked: concurrent
        assigns of the same id race check-then-remove."""
        with self._ongoing_lock:
            record_multiplexed_model_locked(
                self.loaded_models, model_id, self.max_multiplexed_models
            )

    def remove_multiplexed_model(self, model_id: str) -> None:
        """Drop a model from the advertised residency set (the loader cache
        evicted it): the router must stop steering its traffic here."""
        with self._ongoing_lock:
            if model_id in self.loaded_models:
                self.loaded_models.remove(model_id)

    def add_post_batch_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` once the in-flight batch finishes (or immediately
        if called outside batch execution, from the drain in finally)."""
        with self._hooks_lock:
            self._post_batch_hooks.append(hook)

    def _drain_post_batch_hooks(self) -> None:
        with self._hooks_lock:
            hooks, self._post_batch_hooks = self._post_batch_hooks, []
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — a hook must not kill the loop
                logger.exception("%s: post-batch hook failed", self.replica_id)

    # --- loop -------------------------------------------------------------
    def _stream_generator_batch(
        self, batch: List[Request], gen: Any, stream: bool = True
    ) -> List[Any]:
        """Generator batching (ref ``serve/batching.py:209-276``): the
        callable yields, per step, a list of one chunk per request; each
        chunk streams to its request immediately, and the per-request chunk
        lists become the final results. A ``StopIteration``-style sentinel
        of ``None`` skips a request for that step (ref's semantics for
        unequal-length generator outputs). ``stream=False`` collects
        without emitting (bisection probes: a probe that later FAILS must
        not have leaked tokens to innocents, or their rescue re-execution
        would double-emit)."""
        collected: List[List[Any]] = [[] for _ in batch]
        for step in gen:
            if len(step) != len(batch):
                raise ValueError(
                    f"generator yielded {len(step)} chunks for "
                    f"{len(batch)} requests"
                )
            for i, (req, chunk) in enumerate(zip(batch, step)):
                if chunk is None:
                    continue
                collected[i].append(chunk)
                if stream:
                    req.stream_put(chunk)
        return collected

    def _execute_batch(
        self, batch: List[Request], defer_stream: bool = False
    ) -> List[Any]:
        """One execution of the user callable over ``batch`` — the unit
        the bisection re-runs. The chaos poison hook fires here so armed
        query-of-death markers fail every probe that contains them (the
        property isolation depends on). ``defer_stream`` holds generator
        chunks until the whole generator completes, then replays them —
        token-exact streams even when earlier probes of the same requests
        failed partway."""
        chaos().maybe_poison(
            "replica.process_batch", [r.payload for r in batch]
        )
        results = self.fn([r.payload for r in batch])
        if inspect.isgenerator(results):
            results = self._stream_generator_batch(
                batch, results, stream=not defer_stream
            )
            if defer_stream:
                for req, chunks in zip(batch, results):
                    for chunk in chunks:
                        req.stream_put(chunk)
        if len(results) != len(batch):
            raise ValueError(
                f"callable returned {len(results)} results for "
                f"{len(batch)} requests"
            )
        return results

    def _bisect_poison(self, batch: List[Request], exc: Exception) -> None:
        """Query-of-death isolation: a non-retryable failure on a batch of
        N is presumed to be ONE request's content. Binary-search it in
        exactly ``ceil(log2 N)`` re-executions — each round probes the
        first half of the suspect set; a raise implicates that half (the
        other half parks as pending innocents), success fulfills it and
        implicates the other half. The survivor is rejected terminally
        (``PoisonRequest``, 4xx, never retried), fingerprinted into the
        quarantine registry so every front door refuses repeats, and the
        parked innocents get one rescue execution (re-bisected if it
        fails again — multi-poison batches resolve recursively).

        Never raises: isolation is the replica's last line before
        reject-all, so its own failures degrade to rejection, not a dead
        loop."""
        suspects = list(batch)
        deferred: List[Request] = []  # parked innocents, rescued at the end
        probes = 0
        while len(suspects) > 1:
            mid = (len(suspects) + 1) // 2
            lo, hi = suspects[:mid], suspects[mid:]
            probes += 1
            self.bisect_probes += 1
            try:
                results = self._execute_batch(lo, defer_stream=True)
            except Exception as probe_exc:  # noqa: BLE001 — verdict, not crash
                exc = probe_exc
                deferred.extend(hi)
                suspects = lo
            else:
                for req, res in zip(lo, results):
                    req.fulfill(res)
                self.queue.record_batch_completion(lo)
                suspects = hi
        poison = suspects[0]
        fp = poison_fingerprint(self.deployment, poison.payload)
        self.poison_isolated += 1
        if self.quarantine is not None:
            self.quarantine.add(fp, self.deployment, stage="isolated")
        poison.reject(PoisonRequest(
            f"{poison.request_id}: query of death isolated by batch "
            f"bisection ({probes} probes over batch of {len(batch)}): "
            f"{exc}",
            cause=exc, fingerprint=fp,
        ))
        logger.warning(
            "%s: quarantined poison request %s (fingerprint %s, %d probes)",
            self.replica_id, poison.request_id, fp, probes,
        )
        if not deferred:
            return
        # Rescue pass: innocents whose half was implicated then cleared by
        # a deeper probe were never executed — run them once, token-exact.
        self.rescue_batches += 1
        try:
            results = self._execute_batch(deferred, defer_stream=True)
        except Exception as rescue_exc:  # noqa: BLE001 — may be 2nd poison
            if is_retryable(rescue_exc) and self.failure_sink is not None:
                # System fault during rescue: these requests are innocent
                # and retryable — failover re-dispatches them.
                self.failure_sink.on_batch_failure(
                    self, deferred, rescue_exc
                )
            else:
                # A SECOND poison in the same batch: recurse (a singleton
                # skips the loop above and is condemned directly).
                self._bisect_poison(deferred, rescue_exc)
        else:
            for req, res in zip(deferred, results):
                req.fulfill(res)
            self.queue.record_batch_completion(deferred)

    def _process_batch(self, batch: List[Request]) -> None:
        with self._ongoing_lock:
            self._ongoing += len(batch)
        self._batch_started_at = time.monotonic()
        _current.replica = self  # visible to in-callable framework hooks
        try:
            chaos().maybe_fail("replica.process_batch")
            # Gray-failure injection: a seeded slowdown verdict
            # makes THIS batch degrade — stall before any output, run a
            # latency multiple, or withhold EOS — without erroring, which
            # is exactly the failure class the breaker used to miss.
            slowdown = chaos().slowdown(
                "replica.process_batch", instance=self.replica_id
            )
            if (slowdown is not None
                    and slowdown.mode == "stall_before_first_token"):
                time.sleep(slowdown.ms / 1000.0)  # rdb-lint: disable=event-loop-blocking (chaos-injected stall on the replica's own worker thread; no event loop involved)
            exec_started = time.monotonic()
            with ExitStack() as spans:
                if tracer().enabled:
                    # One span for the BATCH execution, linked to every
                    # member request's span (dynamic batching's fan-in:
                    # parent/child cannot express N callers -> one step),
                    # then one execution span per request joined to its
                    # caller's trace via the propagated context (ref spans
                    # around every actor call, tracing_helper.py:293) and
                    # linked BACK to the batch span.
                    batch_span = spans.enter_context(
                        tracer().span(
                            "replica.batch",
                            links=[link_to(r.trace_ctx) for r in batch],
                            deployment=self.deployment,
                            replica=self.replica_id,
                            lane=self.replica_id,
                            size=len(batch),
                        )
                    )
                    for r in batch:
                        spans.enter_context(
                            tracer().attach_context(
                                r.trace_ctx, "replica.execute",
                                links=[link_to(batch_span)],
                                replica=self.replica_id,
                                lane=self.replica_id,
                            )
                        )
                results = self._execute_batch(batch)
            if slowdown is not None:
                if slowdown.mode == "latency_multiplier":
                    # The batch "runs" factor x as long as it measured —
                    # chunks (if any) already streamed, completion drags.
                    extra_s = max(0.0, (slowdown.factor - 1.0)
                                  * (time.monotonic() - exec_started))
                    time.sleep(extra_s)  # rdb-lint: disable=event-loop-blocking (chaos-injected slowdown on the replica's own worker thread; no event loop involved)
                elif slowdown.mode == "stuck_stream":
                    # Output exists, EOS never arrives: the stream stays
                    # open for ms of dead air before fulfill closes it.
                    time.sleep(slowdown.ms / 1000.0)  # rdb-lint: disable=event-loop-blocking (chaos-injected stuck stream on the replica's own worker thread; no event loop involved)
            for req, res in zip(batch, results):
                req.fulfill(res)
            self.queue.record_batch_completion(batch)
            sink = self.failure_sink
            if sink is not None:
                sink.on_batch_success(self)  # closes a half-open breaker
            REPLICA_BATCHES.inc(
                tags={"deployment": self.deployment, "replica": self.replica_id}
            )
            REPLICA_REQUESTS.inc(
                len(batch),
                tags={"deployment": self.deployment, "replica": self.replica_id},
            )
        except Exception as e:  # noqa: BLE001 — user errors flow to futures
            sink = self.failure_sink
            if sink is not None and is_retryable(e):
                # System failure (chaos, replica death, drain eviction):
                # the failover layer re-dispatches to a different replica
                # under the admission deadline; user errors below stay
                # terminal — retrying a bad payload just fails again.
                sink.on_batch_failure(self, batch, e)
            else:
                if self.quarantine is not None and len(batch) > 1:
                    # Router-wired replica, multi-request batch: presume
                    # query of death and bisect — innocents complete, the
                    # poison alone is condemned + quarantined. Bare
                    # replicas and singleton batches keep the legacy
                    # reject-with-original-exception contract.
                    self._bisect_poison(batch, e)
                else:
                    for req in batch:
                        req.reject(e)
                if sink is not None:
                    # A user error is terminal for the REQUEST but proof
                    # of life for the REPLICA (it executed the callable):
                    # it must close a half-open breaker, not wedge it.
                    sink.on_batch_success(self)
            REPLICA_ERRORS.inc(
                tags={"deployment": self.deployment, "replica": self.replica_id}
            )
            logger.warning("%s: batch failed: %s", self.replica_id, e)
        finally:
            _current.replica = None
            self._batch_started_at = None
            with self._ongoing_lock:
                self._ongoing -= len(batch)
            self._drain_post_batch_hooks()

    def _loop(self) -> None:
        while self._run.is_set():
            self.last_heartbeat = time.monotonic()
            # chaos: an injected loop failure kills this replica's thread,
            # simulating a worker crash the controller must detect + replace
            chaos().maybe_fail("replica.loop")
            batch = self.policy.next_batch(self.queue)
            if batch:
                self._process_batch(batch)

    # --- lifecycle (ref deployment_state replica start/stop) --------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._run.set()
        self._thread = threading.Thread(
            target=self._loop, name=f"replica-{self.replica_id}", daemon=True
        )
        self._thread.start()

    def drain_queue(self) -> List[Request]:
        """Stop accepting and pop everything still queued (the controller's
        heal path salvages these onto a replacement replica instead of
        rejecting work a live replica could serve)."""
        self._stopped = True
        out: List[Request] = []
        while len(self.queue) > 0:
            out.extend(
                self.queue.get_batch(self.max_ongoing_requests,
                                     discard_stale=False)
            )
        return out

    def stop(self, timeout_s: float = 5.0, drain: bool = True) -> None:
        """Graceful: stop accepting, drain the queue, then join."""
        self._stopped = True
        if drain and self._thread is not None:
            deadline = time.monotonic() + timeout_s
            while self.queue_len() > 0 and time.monotonic() < deadline:
                time.sleep(0.01)  # rdb-lint: disable=event-loop-blocking (control-plane stop() drain poll on the controller's thread; no event loop involved)
        self._run.clear()
        self.queue.close()  # releases the loop's condition wait permanently
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
        # Reject everything left, however much reconfigure() shrank max_len
        # — counted as drops so shed accounting conserves through teardown.
        for req in self.drain_queue():
            self.queue.count_external_drop(req, reason="closed")
            req.reject(RequestDropped(f"{self.replica_id} stopped"))

    def healthy(self, stall_timeout_s: float = 60.0) -> bool:
        """Liveness check (ref deployment_state health checks): the loop
        thread must be alive, and any in-flight batch must not have been
        running longer than ``stall_timeout_s`` (a wedged user callable —
        e.g. deadlocked on an external resource — is the stall we detect;
        set the timeout above the worst legitimate batch, XLA warmup
        compiles included)."""
        if not self._run.is_set():
            return False
        if self._thread is None or not self._thread.is_alive():
            return False
        started = self._batch_started_at
        return started is None or (time.monotonic() - started) < stall_timeout_s

    def reconfigure(
        self,
        max_batch_size: Optional[int] = None,
        batch_wait_timeout_s: Optional[float] = None,
        max_ongoing_requests: Optional[int] = None,
        user_config: Optional[dict] = None,
    ) -> None:
        """Apply new batching/concurrency knobs to a RUNNING replica (the
        runtime-tunable contract of ``@serve.batch``, batching.py:369-386).
        ``user_config`` flows to the USER callable's own ``reconfigure``
        hook when it has one (ref: replicas call the user class's
        reconfigure on deploy-time user_config updates, replica.py:810
        UserCallableWrapper) — looked up on the callable, then on the
        bound instance behind it."""
        if max_batch_size is not None:
            self.policy.set_max_batch_size(max_batch_size)
        if batch_wait_timeout_s is not None:
            self.policy.set_batch_wait_timeout_s(batch_wait_timeout_s)
        if max_ongoing_requests is not None:
            self.max_ongoing_requests = max_ongoing_requests
            self.queue.max_len = max_ongoing_requests
        if user_config is not None:
            hook = getattr(self.fn, "reconfigure", None)
            if hook is None:
                target = getattr(self.fn, "__self__", None)
                hook = getattr(target, "reconfigure", None)
            if callable(hook):
                hook(user_config)

    def slo_compliance(self) -> float:
        """Recent-completion SLO compliance — the governor's degrade
        signal. Subclasses whose traffic bypasses the base queue
        (LLMReplica's per-bucket queues) override to read the queues
        that actually carry requests."""
        return self.queue.slo_compliance()

    def latency_observation(self) -> tuple:
        """``(p50_ms, p95_ms, n)`` over this replica's recent batch
        completions — the gray detector's per-tick observation and the
        hedge bar's p95 source share this one accessor. Subclasses whose
        traffic bypasses the base queue (LLMReplica) override it, for
        the same reason as :meth:`slo_compliance`: the closed base
        queue's empty sketch would leave the replica permanently
        ungraded and the hedge bar at its floor."""
        win = self.queue.latency_window
        return (win.percentile(0.5), win.percentile(0.95), len(win))

    def stats(self) -> dict:
        s = self.queue.stats()
        s["ongoing"] = float(self.queue_len())
        if self.poison_isolated or self.bisect_probes:
            s["bisect_probes"] = float(self.bisect_probes)
            s["rescue_batches"] = float(self.rescue_batches)
            s["poison_isolated"] = float(self.poison_isolated)
        return s
