"""Developer-facing serve API: ``@deployment`` / ``bind`` / ``run`` /
``@batch`` — the reference's headline surface
(``python/ray/serve/api.py:463`` ``serve.run``, ``@serve.deployment``,
``@serve.batch`` at ``serve/batching.py:530``), re-created over the
TPU-native controller/router/replica stack.

Own copy of ``ray_dynamic_batching_tpu/serve/api.py``, whole, with its
import paths rewritten.

Semantics kept from the reference:

- ``@deployment`` wraps a class or function into a :class:`Deployment`;
  ``.options(**overrides)`` returns a modified copy (ref
  ``Deployment.options``); ``.bind(*args, **kwargs)`` captures init args
  into an :class:`Application` for :func:`run`.
- User callables are PER-REQUEST by default — one payload in, one result
  out. Opting into batch execution is explicit via ``@batch`` (ref: Serve
  replicas call the user method per request unless ``@serve.batch``
  aggregates them), and the batch wrapper may be a generator that yields
  per-wave results for streaming (ref ``batching.py:209-276``).
- ``run`` deploys onto a module-level controller (created on first use —
  the singleton role of Serve's controller actor), returns a
  :class:`DeploymentHandle`, and optionally publishes an HTTP route when
  given a proxy (ref ``serve.run(..., route_prefix=...)``).

Differences, by TPU-first design: deployments are threads + compiled XLA
programs in one process (or process workers via ``runtime.cluster``), not
Ray actors, so ``bind`` does not build a multi-node DAG — it captures
constructor state for replica factories.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_dynamic_batching_tpu_torch.serve.controller import (
    DeploymentConfig,
    ServeController,
)
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
from ray_dynamic_batching_tpu_torch.serve.proxy import HTTPProxy
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.api")

_BATCH_ATTR = "_rdb_batch_options"


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.005,
) -> Callable:
    """Mark a callable as batch-executing (ref ``@serve.batch``,
    ``serve/batching.py:530``): the replica hands it the whole collected
    wave as a list and it returns one result per element (or yields lists
    incrementally — generator batching). The size/timeout knobs become the
    deployment's batching config, runtime-tunable exactly like the
    reference's ``set_max_batch_size`` (``batching.py:369-386``) through
    ``Replica.reconfigure``."""

    def wrap(fn: Callable) -> Callable:
        setattr(fn, _BATCH_ATTR, {
            "max_batch_size": int(max_batch_size),
            "batch_wait_timeout_s": float(batch_wait_timeout_s),
        })
        return fn

    return wrap if _fn is None else wrap(_fn)


class _MultiplexedMethod:
    """Descriptor produced by :func:`multiplexed`: a per-instance (= per
    replica, since the factory constructs the user class once per replica)
    LRU of loaded models, keyed by model id (ref
    ``serve/multiplex.py`` ``_ModelMultiplexWrapper``: bounded LRU, evicted
    models get their release hook called before being dropped)."""

    def __init__(self, fn: Callable, max_models: int,
                 unload: Optional[Callable[[Any], None]]):
        self._fn = fn
        self._max_models = max(1, int(max_models))
        self._unload = unload
        functools.update_wrapper(self, fn, updated=())

    def __get__(self, instance: Any, owner: Any = None) -> Callable:
        if instance is None:
            return self
        state_key = f"_rdb_mux_{self._fn.__name__}"
        state = instance.__dict__.get(state_key)
        if state is None:
            # setdefault is atomic under the GIL: concurrent first accesses
            # must converge on ONE state dict or each would load its own
            # duplicate model into an orphaned cache.
            state = instance.__dict__.setdefault(state_key, {
                "cache": {}, "order": [], "lock": threading.Lock(),
                # model_id -> Event; presence = a load is in flight, so
                # concurrent misses wait instead of loading a duplicate
                # (a duplicate is a full model's HBM leaked until GC).
                "inflight": {},
            })

        def get_model(model_id: str) -> Any:
            from ray_dynamic_batching_tpu_torch.serve.replica import current_replica

            while True:
                with state["lock"]:
                    if model_id in state["cache"]:
                        state["order"].remove(model_id)
                        state["order"].append(model_id)
                        return state["cache"][model_id]
                    waiter = state["inflight"].get(model_id)
                    if waiter is None:
                        state["inflight"][model_id] = threading.Event()
                        break  # this thread is the loader
                waiter.wait()  # loader finished (or failed) -> re-check

            # Load OUTSIDE the lock: weight upload + XLA warmup can take
            # tens of seconds and must not block cache hits.
            evicted = None
            try:
                model = self._fn(instance, model_id)
                with state["lock"]:
                    state["cache"][model_id] = model
                    state["order"].append(model_id)
                    if len(state["order"]) > self._max_models:
                        victim = state["order"].pop(0)
                        evicted = (victim, state["cache"].pop(victim))
            finally:
                with state["lock"]:
                    state["inflight"].pop(model_id).set()
            # Ground-truth residency for the pow-2 router: advertise the
            # load and retract the eviction on the replica running this
            # callable (assign-time recording alone would keep steering
            # traffic to replicas that already evicted the model).
            replica = current_replica()
            if replica is not None:
                replica.record_multiplexed_model(model_id)
                if evicted is not None:
                    replica.remove_multiplexed_model(evicted[0])
            if evicted is not None:
                victim = evicted[1]
                if replica is not None:
                    # Replica batches are serialized on one thread, so any
                    # request still USING the victim belongs to the current
                    # batch — release only after it completes, never under
                    # a live forward pass.
                    replica.add_post_batch_hook(
                        lambda v=victim: self._release(v)
                    )
                else:
                    self._release(victim)
            return model

        get_model.loaded_model_ids = lambda: list(state["order"])
        return get_model

    def _release(self, model: Any) -> None:
        try:
            if self._unload is not None:
                self._unload(model)
            elif hasattr(model, "unload"):
                model.unload()
            # else: dropping the last reference frees device buffers on GC
        except Exception:  # noqa: BLE001 — eviction must not kill serving
            logger.exception("multiplexed model release hook failed")


def multiplexed(
    _fn: Optional[Callable] = None,
    *,
    max_num_models_per_replica: int = 4,
    unload: Optional[Callable[[Any], None]] = None,
) -> Callable:
    """``@serve.multiplexed`` equivalent (ref ``serve/multiplex.py``):
    decorate a loader METHOD ``def get_model(self, model_id)`` of a
    deployment class; calls become per-replica LRU-cached loads, bounded at
    ``max_num_models_per_replica``, with evicted models released through
    ``unload`` (or their own ``.unload()``). Pair with
    ``handle.remote(..., multiplexed_model_id=...)`` so the pow-2 router
    steers requests toward replicas already holding the model."""

    def wrap(fn: Callable) -> _MultiplexedMethod:
        return _MultiplexedMethod(fn, max_num_models_per_replica, unload)

    return wrap if _fn is None else wrap(_fn)


class Application:
    """A deployment bound to its constructor arguments (ref
    ``Deployment.bind`` building an app graph node)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    @property
    def name(self) -> str:
        return self.deployment.name


class Deployment:
    """A user callable plus its deployment options (ref serve.Deployment)."""

    def __init__(self, target: Callable, config: DeploymentConfig,
                 explicit: Optional[frozenset] = None):
        self._target = target
        self._config = config
        # Field names the user set via options(): an explicit override must
        # beat the @batch decorator's defaults in run().
        self._explicit = explicit or frozenset()
        functools.update_wrapper(self, target, updated=())

    @property
    def name(self) -> str:
        return self._config.name

    def options(self, **overrides: Any) -> "Deployment":
        """Copy with config overrides (ref Deployment.options)."""
        cfg_fields = {f for f in DeploymentConfig.__dataclass_fields__}
        bad = set(overrides) - cfg_fields
        if bad:
            raise TypeError(f"unknown deployment options: {sorted(bad)}")
        merged = DeploymentConfig.from_json(
            {**self._config.to_json(), **{
                k: v for k, v in overrides.items() if k != "autoscaling"
            }}
        )
        if "autoscaling" in overrides:
            merged.autoscaling = overrides["autoscaling"]
        return Deployment(
            self._target, merged, self._explicit | frozenset(overrides)
        )

    def bind(self, *args: Any, **kwargs: Any) -> Application:
        return Application(self, args, kwargs)

    def _make_factory(
        self, args: tuple, kwargs: dict
    ) -> Callable[[], Callable[[List[Any]], Sequence[Any]]]:
        """Replica factory: constructs the user callable per replica, then
        adapts per-request callables to the replica's batch contract."""
        target = self._target
        raw = target.__call__ if inspect.isclass(target) else target
        marked = getattr(raw, _BATCH_ATTR, None)
        # unwrap: a logging/timing decorator with functools.wraps hides the
        # generator-ness of the underlying callable.
        if marked is None and inspect.isgeneratorfunction(inspect.unwrap(raw)):
            # The replica's generator contract is batch-shaped (yield one
            # chunk list per wave); silently promoting an unmarked
            # per-request generator would hand it a payload LIST and
            # misread its yields. Fail at deploy time, not mid-request.
            raise TypeError(
                f"{self.name}: generator callables stream whole batches "
                "and must opt in with @serve.batch"
            )

        def factory() -> Callable[[List[Any]], Sequence[Any]]:
            if inspect.isclass(target):
                instance = target(*args, **kwargs)
                call = instance.__call__
            elif args or kwargs:
                call = functools.partial(target, *args, **kwargs)
            else:
                call = target

            if marked is not None:
                return call  # already list -> list (or generator)

            def per_request(payloads: List[Any]) -> List[Any]:
                return [call(p) for p in payloads]

            # The replica's user_config hook looks for `reconfigure` on
            # the callable; surface the instance's through the wrapper.
            instance_hook = getattr(
                getattr(call, "__self__", None), "reconfigure", None
            )
            if callable(instance_hook):
                per_request.reconfigure = instance_hook
            return per_request

        return factory

    def batch_options(self) -> Optional[Dict[str, float]]:
        target = self._target
        if inspect.isclass(target):
            return getattr(target.__call__, _BATCH_ATTR, None)
        return getattr(target, _BATCH_ATTR, None)


def deployment(
    _target: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_ongoing_requests: int = 256,
    max_restarts: int = 3,
    autoscaling: Any = None,
    user_config: Optional[Dict[str, Any]] = None,
    chips_per_replica: int = 0,
    placement_strategy: str = "PACK",
) -> Callable:
    """``@serve.deployment`` equivalent: turn a class or function into a
    deployable unit. Batching is per-request unless the callable opts in
    with ``@batch``."""

    def wrap(target: Callable) -> Deployment:
        cfg = DeploymentConfig(
            name=name or target.__name__,
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_restarts=max_restarts,
            autoscaling=autoscaling,
            user_config=dict(user_config or {}),
            chips_per_replica=chips_per_replica,
            placement_strategy=placement_strategy,
        )
        return Deployment(target, cfg)

    return wrap if _target is None else wrap(_target)


# --- module-level controller (the singleton controller-actor role) ---------

_state_lock = threading.Lock()
_controller: Optional[ServeController] = None
_proxy: Optional[HTTPProxy] = None


def _get_controller() -> ServeController:
    global _controller
    with _state_lock:
        if _controller is None:
            _controller = ServeController()
            _controller.start()
        return _controller


def run(
    app: Application,
    *,
    route_prefix: Optional[str] = None,
    controller: Optional[ServeController] = None,
    default_slo_ms: float = 30_000.0,
) -> DeploymentHandle:
    """Deploy an application and return its handle (ref serve.run,
    ``api.py:463``). With ``route_prefix`` the deployment is also published
    on the module HTTP proxy (started on first use)."""
    if not isinstance(app, Application):
        raise TypeError(
            "run() takes Deployment.bind(...); got "
            f"{type(app).__name__} — decorate with @deployment and bind"
        )
    ctl = controller or _get_controller()
    dep = app.deployment
    cfg = dep._config
    # getattr resolves each name through the MRO, so a subclass override
    # shadows its base's descriptor — only ACTIVE loaders count (an
    # inactive base bound would under-advertise the cache size).
    mux_bounds = [
        v._max_models
        for v in (getattr(dep._target, n, None) for n in dir(dep._target))
        if isinstance(v, _MultiplexedMethod)
    ] if inspect.isclass(dep._target) else []
    if mux_bounds and "max_multiplexed_models" not in dep._explicit:
        # Advertised residency must match the tightest real cache bound,
        # or the router steers traffic to replicas that already evicted
        # the model.
        cfg = DeploymentConfig.from_json(cfg.to_json())
        cfg.max_multiplexed_models = min(mux_bounds)
    bopts = dep.batch_options()
    if bopts is not None:
        # @batch values are defaults; options() overrides win (both knobs
        # are plain DeploymentConfig fields the user may have set).
        cfg = DeploymentConfig.from_json(cfg.to_json())
        if "max_batch_size" not in dep._explicit:
            cfg.max_batch_size = int(bopts["max_batch_size"])
        if "batch_wait_timeout_s" not in dep._explicit:
            cfg.batch_wait_timeout_s = float(bopts["batch_wait_timeout_s"])
    router = ctl.deploy(cfg, factory=dep._make_factory(app.args, app.kwargs))
    handle = DeploymentHandle(router, default_slo_ms=default_slo_ms,
                              default_qos_class=cfg.default_qos_class)
    if route_prefix is not None:
        proxy = _get_proxy()
        # The proxy's admission checks must grade against THIS
        # controller's policy table/governor state (one shared instance,
        # so the control loop's degrade decisions bind the front door).
        proxy.admission = ctl.admission
        proxy.router.set_route(route_prefix, handle)
    return handle


def _get_proxy() -> HTTPProxy:
    global _proxy
    with _state_lock:
        if _proxy is None:
            from ray_dynamic_batching_tpu_torch.serve.proxy import ProxyRouter

            _proxy = HTTPProxy(ProxyRouter(), port=0)
            _proxy.start()
        return _proxy


def get_proxy() -> Optional[HTTPProxy]:
    """The module proxy, if any route was published."""
    return _proxy


def get_deployment_handle(
    name: str, default_slo_ms: float = 30_000.0
) -> DeploymentHandle:
    """Handle to an already-running deployment (ref
    ``serve.get_deployment_handle``)."""
    ctl = _get_controller()
    return DeploymentHandle(
        ctl.get_router(name), default_slo_ms=default_slo_ms
    )


def status() -> Dict[str, Any]:
    """Deployment/replica state of the module controller (ref
    ``serve.status`` / the status CLI). Empty when nothing is running —
    asking must not START a controller as a side effect."""
    with _state_lock:
        ctl = _controller
    return ctl.status() if ctl is not None else {}


def delete(name: str) -> None:
    """Tear down one deployment (ref serve.delete)."""
    _get_controller().delete_deployment(name)


def shutdown() -> None:
    """Stop the module controller and proxy (ref serve.shutdown)."""
    global _controller, _proxy
    with _state_lock:
        ctl, proxy = _controller, _proxy
        _controller = None
        _proxy = None
    if proxy is not None:
        proxy.stop()
    if ctl is not None:
        ctl.shutdown()
