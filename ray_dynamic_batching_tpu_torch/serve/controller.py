"""Serve controller — deployment reconciliation, autoscaling, recovery.

Own copy of ``ray_dynamic_batching_tpu/serve/controller.py``, whole, with
its import paths rewritten.

Re-creates Ray Serve's control plane: the singleton ``ServeController``
(``python/ray/serve/_private/controller.py``) reconciling deployment target
state, checkpointing to the GCS KV store under a checkpoint key
(``controller.py:79-80``, save at ``:545``;
``application_state.py:65,1096-1110``) so a restarted controller resumes
where it left off; the deployment state machine scaling replicas up/down and
replacing unhealthy ones (``deployment_state.py``); replica-set changes
pushed to routers over long poll (SURVEY.md §2.3).

Control-plane scale-out: all controller-owned mutable state is
written through the :mod:`~ray_dynamic_batching_tpu_torch.serve.store`
transaction API — the GCS move. With the default :class:`InMemoryStore`
nothing changes operationally; with a :class:`ReplicatedStore` every
transaction lands in a shared epoch-fenced log, a standby controller
replays it and takes over when the leader's lease lapses, and the deposed
leader's next write raises :class:`StaleEpochError` instead of corrupting
state it no longer owns. Live data-plane objects (replicas, routers)
survive the failover through a :class:`ReplicaCatalog`; clients' handles
keep routing throughout because the ROUTER they hold is adopted, never
replaced. The ``store-discipline`` lint rule (tools/lint/store.py) holds
this file to the transaction API.

TPU-first note: replica startup can imply weight upload + XLA warmup, so the
state machine starts replicas *before* registering them with the router and
drains before stopping — the same rollout discipline Serve uses for slow
torch model loads, with compile time in place of load time.
"""

from __future__ import annotations

import collections
import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_dynamic_batching_tpu_torch.parallel.placement import (
    PlacementError,
    PlacementManager,
)
from ray_dynamic_batching_tpu_torch.engine.rates import RateRegistry
from ray_dynamic_batching_tpu_torch.runtime.kv import KVStore
from ray_dynamic_batching_tpu_torch.scheduler.audit import AuditLog
from ray_dynamic_batching_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.autoscaling import (
    AutoscalingConfig,
    AutoscalingPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.fabric import (
    ControlFabric,
    FabricUnreachable,
    default_fabric,
)
from ray_dynamic_batching_tpu_torch.serve.kv_fabric import KVPageFabric
from ray_dynamic_batching_tpu_torch.serve.long_poll import LongPollHost
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.serve.observatory import SLOObservatory
from ray_dynamic_batching_tpu_torch.serve.replica import Replica
from ray_dynamic_batching_tpu_torch.serve.router import Router
from ray_dynamic_batching_tpu_torch.serve.store import (
    ControllerStore,
    InMemoryStore,
    ReplicaCatalog,
    ReplicatedStore,
    StaleEpochError,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch

logger = get_logger("controller")

CHECKPOINT_KEY = "serve:controller:checkpoint"  # ref controller.py:79-80
REPLICA_SET_KEY = "serve:replicas:{deployment}"
PREFIX_DIGEST_KEY = "serve:prefix_digests:{deployment}"
QUARANTINE_KEY = "serve:quarantine:{deployment}"
STORE_QUARANTINE_KEY = "serve:quarantine/{deployment}"
# Controller-store keys (the replicated state the standby replays).
STORE_CONFIG_KEY = "serve:deployments/{deployment}/config"
STORE_REGISTRY_KEY = "serve:deployments/{deployment}/replicas"
STORE_GOVERNOR_KEY = "serve:governor/{deployment}"
STORE_GRAY_KEY = "serve:gray/{deployment}"


@dataclass
class DeploymentConfig:
    """Deployment contract (ref @serve.deployment options + config.py).

    ``chips_per_replica > 0`` makes every replica acquire its chips through
    a placement group before starting (ref: Serve's deployment scheduler
    places replica actors via PGs — ``_private/deployment_scheduler.py``,
    ``gcs_placement_group_scheduler.cc``); ``placement_strategy`` is one of
    PACK/SPREAD/STRICT_PACK/STRICT_SPREAD.
    """

    name: str
    num_replicas: int = 1
    max_batch_size: int = 8
    batch_wait_timeout_s: float = 0.005
    max_ongoing_requests: int = 256
    max_restarts: int = 3
    autoscaling: Optional[AutoscalingConfig] = None
    user_config: Dict[str, Any] = field(default_factory=dict)
    chips_per_replica: int = 0          # 0 = no chip reservation
    placement_strategy: str = "PACK"
    # Code/config version for ROLLING updates (ref deployment_state.py
    # rollout: redeploying a new version gradually replaces replicas with
    # both versions serving and bounded unavailability). "" = unversioned:
    # redeploys reconfigure in place, never roll.
    version: str = ""
    # Fraction of num_replicas that may be down at once mid-rollout (ref
    # Serve's 20% rollout rate); at least one replica always rolls.
    rolling_max_unavailable_fraction: float = 0.2
    # Advertised multiplex-LRU size per replica; serve.run syncs this to a
    # @multiplexed loader's bound so the router never steers traffic to a
    # replica whose cache already evicted the model.
    max_multiplexed_models: int = 8
    # --- multi-tenant QoS (serve/admission.py) ---
    # Service tier for requests that declare none (interactive | standard
    # | best_effort) — the deployment's contract, stamped by the handle.
    default_qos_class: str = "standard"
    # Per-(tenant, class) token-bucket admission rate consulted by the
    # proxies BEFORE queueing; 0 = no admission control (admit all).
    admission_rate_rps: float = 0.0
    admission_burst: float = 0.0       # 0 -> defaults to the rate
    # --- gray-failure defense (serve/grayhealth.py) ---
    # Hedged dispatch for interactive-class requests ("The Tail at
    # Scale"): when a primary dispatch exceeds the deployment's profiled
    # p95 with no output, re-dispatch to a different replica and let the
    # first winner cancel the loser. Per-deployment opt-in — the extra
    # dispatches are the wrong trade under queue-bound overload.
    hedge_interactive: bool = False
    # Probation ticks of sustained slowness before a straggler replica
    # is EJECTED (replaced like a dead one, chip reclaimed). 0 = detect
    # and probation only, never auto-eject.
    gray_eject_after: int = 0
    # --- metastable-failure defense (serve/retrybudget.py) ---
    # Re-dispatches (failover retries + hedges) allowed per recent
    # first-attempt dispatch; None = track without enforcing. The
    # governor's `congested` verdict zeroes the budget in either mode.
    retry_budget_fraction: Optional[float] = None
    retry_budget_window: int = 512

    def to_json(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "num_replicas": self.num_replicas,
            "max_batch_size": self.max_batch_size,
            "batch_wait_timeout_s": self.batch_wait_timeout_s,
            "max_ongoing_requests": self.max_ongoing_requests,
            "max_restarts": self.max_restarts,
            "user_config": self.user_config,
            "chips_per_replica": self.chips_per_replica,
            "placement_strategy": self.placement_strategy,
            "max_multiplexed_models": self.max_multiplexed_models,
            "version": self.version,
            "rolling_max_unavailable_fraction":
                self.rolling_max_unavailable_fraction,
            "default_qos_class": self.default_qos_class,
            "admission_rate_rps": self.admission_rate_rps,
            "admission_burst": self.admission_burst,
            "hedge_interactive": self.hedge_interactive,
            "gray_eject_after": self.gray_eject_after,
            "retry_budget_fraction": self.retry_budget_fraction,
            "retry_budget_window": self.retry_budget_window,
        }
        if self.autoscaling is not None:
            d["autoscaling"] = vars(self.autoscaling)
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "DeploymentConfig":
        auto = d.pop("autoscaling", None)
        cfg = DeploymentConfig(**d)
        if auto is not None:
            cfg.autoscaling = AutoscalingConfig(**auto)
        return cfg


@dataclass
class _DeploymentState:
    """Live state for one deployment (ref DeploymentState)."""

    config: DeploymentConfig
    factory: Callable[[], Callable[[List[Any]], Sequence[Any]]]
    replicas: List[Replica] = field(default_factory=list)
    router: Optional[Router] = None
    policy: Optional[AutoscalingPolicy] = None
    restarts: int = 0
    next_replica_ordinal: int = 0
    unhealthy: bool = False  # restart budget spent; held until redeploy
    # replica_id -> its placement group (only when chips_per_replica > 0)
    pgroups: Dict[str, Any] = field(default_factory=dict)


class ServeController:
    """Singleton control loop owning deployments, routers, and scaling.

    ``store`` is the transactional home of every piece of mutable
    controller state (GCS move); ``catalog`` registers the live
    data-plane objects so a failover successor adopts them instead of
    cold-starting the world.
    """

    def __init__(
        self,
        kv: Optional[KVStore] = None,
        long_poll: Optional[LongPollHost] = None,
        control_interval_s: float = 0.5,
        placement: Optional[PlacementManager] = None,
        store: Optional[ControllerStore] = None,
        catalog: Optional[ReplicaCatalog] = None,
        fabric: Optional[ControlFabric] = None,
    ) -> None:
        self.kv = kv or KVStore()
        self.long_poll = long_poll or LongPollHost()
        self.placement = placement
        self.control_interval_s = control_interval_s
        self.store = store or InMemoryStore()
        self.catalog = catalog
        # The control-plane message seam: controller→router pushes
        # (long-poll notifies, digest publications) route through it so
        # the partition soak can cut the controller off from its data
        # plane. Unconfigured it is the zero-overhead passthrough.
        self.fabric = fabric if fabric is not None else default_fabric()
        # KV page fabric transfer plane: live-stream couriers
        # for zero-drop drains + the prefix push-replication tick. Rides
        # the same ControlFabric, so partition windows cut couriers too.
        self.kv_fabric = KVPageFabric(fabric=self.fabric)
        self._deployments: Dict[str, _DeploymentState] = {}
        self._factories: Dict[str, Callable] = {}
        self._lock = OrderedLock("controller", reentrant=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_checkpoint: Optional[str] = None
        # True once this controller was deposed (lease lost / stale-epoch
        # write rejected): it must stop acting as leader, permanently.
        self._fenced = False
        # Structured decision ring (scheduler/audit.py): deploys, scale
        # moves, heals, rollouts — surfaced per deployment in status().
        self.audit = AuditLog("serve")
        # The store's split-brain defense (store_unreachable self-
        # demotion) files into the SAME ring as fences and heals.
        if isinstance(self.store, ReplicatedStore) \
                and self.store.audit is None:
            self.store.audit = self.audit
        # Token-bucket admission + overload governor (serve/admission.py):
        # the proxies consult it pre-queue; this control loop feeds it
        # queue-depth/compliance signals each step, and its governor
        # transitions land in the SAME audit ring as heals and replans.
        self.admission = AdmissionController()
        self.admission.audit = self.audit
        # SLO observatory (serve/observatory.py — the SAME classes the
        # sim ticks on its virtual clock): burn-rate alerts graded from
        # the replicas' per-class queue counters, arrival forecasts
        # scored against the demand the control loop itself aggregates,
        # and sim-fidelity drift replayed every few steps. Demand is
        # observed as per-step enqueued-counter DELTAS — no hot-path
        # instrumentation; integer-second rate buckets make control-
        # tick granularity exact.
        self.rates = RateRegistry()
        self.observatory = SLOObservatory("serve")
        self.observatory.audit = self.audit
        self._observed_enqueued: Dict[str, float] = {}
        # Last-published quarantine fingerprint set per deployment: the
        # gossip tick fans out only on membership change (hit counters
        # mutate constantly and must not re-trigger pushes).
        self._quarantine_published: Dict[str, frozenset] = {}

    # --- deploy API (ref serve.run / deploy) ------------------------------
    def register_factory(
        self,
        name: str,
        factory: Callable[[], Callable[[List[Any]], Sequence[Any]]],
    ) -> None:
        """Factories are code, not state: after a controller restart the
        checkpoint restores *configs* and factories must be re-registered
        (the reference re-imports deployment code the same way)."""
        self._factories[name] = factory

    def _apply_router_policies(self, router: Router,
                               config: DeploymentConfig) -> None:
        """Re-derive the router's gray/hedge policy objects from the
        deployment config. These are data-plane POLICY, not store-owned
        state: a failover successor rebuilds them from the persisted
        config, so bare writes here are correct by construction."""
        from ray_dynamic_batching_tpu_torch.serve.failover import (
            HedgeManager,
            HedgePolicy,
        )
        from ray_dynamic_batching_tpu_torch.serve.grayhealth import GrayHealthPolicy
        from ray_dynamic_batching_tpu_torch.serve.retrybudget import (
            RetryBudgetPolicy,
        )

        if config.gray_eject_after != router.gray.policy.eject_after:
            router.gray.policy = GrayHealthPolicy(
                eject_after=config.gray_eject_after
            )
        if config.hedge_interactive and router.hedge is None:
            router.hedge = HedgeManager(router, HedgePolicy())
        elif not config.hedge_interactive and router.hedge is not None:
            router.hedge.close()
            router.hedge = None
        budget = getattr(router, "retry_budget", None)
        if budget is not None and (
            budget.policy.fraction != config.retry_budget_fraction
            or budget.policy.window != config.retry_budget_window
        ):
            # Reprice keeps the ledger: recent first-attempt volume stays
            # honest across a knob change.
            budget.reconfigure(RetryBudgetPolicy(
                fraction=config.retry_budget_fraction,
                window=config.retry_budget_window,
            ))

    def deploy(
        self,
        config: DeploymentConfig,
        factory: Optional[Callable] = None,
        _recovered: bool = False,
    ) -> Router:
        """``_recovered`` marks the deploy that immediately follows a
        failover adoption: it re-binds the SAME config, so the restart
        budget / unhealthy verdict restored by ``_adopt`` must survive
        (only a genuinely fresh user deploy resets them)."""
        with self._lock:
            if factory is not None:
                self.register_factory(config.name, factory)
            if config.name not in self._factories:
                raise KeyError(f"no factory registered for {config.name!r}")
            from ray_dynamic_batching_tpu_torch.serve.failover import HedgePolicy
            from ray_dynamic_batching_tpu_torch.serve.grayhealth import (
                GrayHealthPolicy,
            )
            from ray_dynamic_batching_tpu_torch.serve.retrybudget import (
                RetryBudgetPolicy,
            )

            state = self._deployments.get(config.name)
            with self.store.txn() as txn:
                if state is None:
                    router = (self.catalog.router(config.name)
                              if self.catalog is not None else None)
                    if router is None:
                        router = Router(
                            config.name,
                            gray_policy=GrayHealthPolicy(
                                eject_after=config.gray_eject_after
                            ),
                            hedge_policy=(HedgePolicy()
                                          if config.hedge_interactive
                                          else None),
                            retry_budget_policy=RetryBudgetPolicy(
                                fraction=config.retry_budget_fraction,
                                window=config.retry_budget_window,
                            ),
                        )
                    else:
                        # Adopted (failover): reprice its policies from
                        # THIS config — the live object may carry the old
                        # leader's knobs.
                        self._apply_router_policies(router, config)
                    state = _DeploymentState(
                        config=config,
                        factory=self._factories[config.name],
                        router=router,
                    )
                    # Breaker trip/recover events are control-plane
                    # decisions: they share the controller's audit ring
                    # with heals and scale moves (one timeline per
                    # deployment).
                    state.router.audit = self.audit
                    self._deployments[config.name] = state
                    if self.catalog is not None:
                        self.catalog.register_router(config.name,
                                                     state.router)
                else:
                    # Deliver user_config only when it CHANGED (including a
                    # change TO {} — clearing must reach the hook): the
                    # user's reconfigure can be expensive (weight reloads)
                    # and must not re-run because an unrelated knob moved.
                    prev_user = state.config.user_config
                    prev_version = state.config.version
                    state.config = config
                    # Gray/hedge knobs live on the ROUTER, not the
                    # replicas: a redeploy must reprice them here or
                    # status() reports the new config while the router
                    # keeps enforcing the old policy until the next
                    # controller restart.
                    self._apply_router_policies(state.router, config)
                    # A redeploy may carry NEW code: future replica starts
                    # (rollout replacements included) must build from the
                    # freshly registered factory, not the one captured at
                    # first deploy.
                    state.factory = self._factories[config.name]
                    if not _recovered:
                        # a fresh deploy resets the budget
                        state.restarts = 0
                        state.unhealthy = False
                    if config.version and config.version != prev_version:
                        # Version change -> ROLLING update: old-version
                        # replicas keep serving as-is until _reconcile
                        # retires them in bounded batches (pushing the new
                        # config into doomed replicas would run expensive
                        # reconfigures twice and blur which version
                        # produced a response).
                        logger.info(
                            "%s: rolling update %r -> %r over %d replicas",
                            config.name, prev_version, config.version,
                            len(state.replicas),
                        )
                    else:
                        # Push changed batching/concurrency knobs to
                        # RUNNING replicas (otherwise re-deploys silently
                        # produce a mixed-config replica set).
                        for r in state.replicas:
                            r.reconfigure(
                                max_batch_size=config.max_batch_size,
                                batch_wait_timeout_s=(
                                    config.batch_wait_timeout_s
                                ),
                                max_ongoing_requests=(
                                    config.max_ongoing_requests
                                ),
                                user_config=(
                                    config.user_config
                                    if config.user_config != prev_user
                                    else None
                                ),
                            )
                if config.autoscaling is not None:
                    state.policy = AutoscalingPolicy(
                        config.autoscaling, interval_s=self.control_interval_s
                    )
                else:
                    # autoscaling removed -> pin num_replicas
                    state.policy = None
                self._persist(txn, state)
            self.admission.configure(
                config.name,
                AdmissionPolicy(rate_rps=config.admission_rate_rps,
                                burst=config.admission_burst)
                if config.admission_rate_rps > 0 else None,
            )
            self.audit.record(
                "deploy",
                key=config.name,
                before={"replicas": len(state.replicas)},
                after={"replicas": config.num_replicas,
                       "version": config.version},
                diff={"target_replicas": config.num_replicas,
                      "version": config.version},
            )
            deferred = self._reconcile(state)
            self._checkpoint()
        for action in deferred:  # blocking stops run outside the lock
            action()
        return state.router

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            with self.store.txn() as txn:
                state = self._deployments.pop(name, None)
                if state is None:
                    return
                txn.delete(STORE_CONFIG_KEY.format(deployment=name))
                txn.delete(STORE_REGISTRY_KEY.format(deployment=name))
                txn.delete(STORE_GOVERNOR_KEY.format(deployment=name))
                txn.delete(STORE_GRAY_KEY.format(deployment=name))
                victims = state.replicas
                state.replicas = []
            if self.catalog is not None:
                # A redeploy must never adopt this CLOSED router.
                self.catalog.unregister_router(name)
            self.admission.configure(name, None)
            self._publish(state)
            state.router.close()
            self._checkpoint()
            self.audit.record(
                "delete",
                key=name,
                before={"replicas": len(victims)},
                after={"replicas": 0},
                diff={"stopped": [r.replica_id for r in victims]},
            )
        for r in victims:  # blocking drains outside the lock
            r.stop()
            self._release_chips(state, r)

    def get_router(self, name: str) -> Router:
        with self._lock:
            return self._deployments[name].router

    def deployments(self) -> List[str]:
        with self._lock:
            return sorted(self._deployments)

    # --- durable mirror (store transactions) ------------------------------
    def _persist(self, txn, state: _DeploymentState) -> None:
        """Write one deployment's durable mirror into the open
        transaction. Canonical JSON + the txn's no-op elision keep the
        steady-state control loop from appending anything to the log."""
        cfg = state.config
        txn.put_json(STORE_CONFIG_KEY.format(deployment=cfg.name),
                     cfg.to_json())
        txn.put_json(STORE_REGISTRY_KEY.format(deployment=cfg.name), {
            "ids": [r.replica_id for r in state.replicas],
            "versions": {r.replica_id: getattr(r, "version", "")
                         for r in state.replicas},
            "ordinal": state.next_replica_ordinal,
            "restarts": state.restarts,
            "unhealthy": state.unhealthy,
            "reserved_chips": sorted(state.pgroups),
        })

    # --- state machine (ref deployment_state.py scale/heal) ---------------
    def _start_replica(self, state: _DeploymentState) -> Replica:
        cfg = state.config
        with self.store.txn() as txn:
            rid = f"{cfg.name}#{state.next_replica_ordinal}"
            state.next_replica_ordinal += 1
            # The ordinal is durable: a failover successor must never
            # mint a replica id the old leader already used.
            self._persist(txn, state)
        # Gang-acquire chips BEFORE building the replica (ref: the
        # deployment scheduler waits on the PG, then places the actor in it
        # — deployment_scheduler.py / gcs_placement_group_scheduler.cc).
        pg = None
        devices = None
        if cfg.chips_per_replica > 0:
            if self.placement is None:
                raise RuntimeError(
                    f"{cfg.name}: chips_per_replica={cfg.chips_per_replica} "
                    "requires a PlacementManager on the controller"
                )
            from ray_dynamic_batching_tpu_torch.parallel.placement import Bundle

            pg = self.placement.create(
                [Bundle(chips=cfg.chips_per_replica)],
                strategy=cfg.placement_strategy,
            )
            devices = pg.bundle_devices(0)
        try:
            factory = state.factory
            if hasattr(factory, "make_replica"):
                # Deployment owns its replica class (e.g. serve.llm.LLMReplica
                # wrapping a decode engine) — mirror of the reference where
                # deployment target state carries the replica actor definition.
                if devices is not None:
                    replica = factory.make_replica(rid, cfg, devices=devices)
                else:
                    replica = factory.make_replica(rid, cfg)
            else:
                replica = Replica(
                    replica_id=rid,
                    deployment=cfg.name,
                    fn=factory(),
                    max_batch_size=cfg.max_batch_size,
                    batch_wait_timeout_s=cfg.batch_wait_timeout_s,
                    max_ongoing_requests=cfg.max_ongoing_requests,
                )
                replica.max_multiplexed_models = cfg.max_multiplexed_models
                if devices is not None:
                    replica.devices = devices
            if cfg.user_config:
                # Initial user_config applies BEFORE serving, for every
                # replica kind (ref: reconfigure runs before the replica
                # serves) — not just the plain-Replica branch.
                replica.reconfigure(user_config=cfg.user_config)
            replica.start()
        except Exception:
            if pg is not None:  # failed start must not leak reserved chips
                self.placement.remove(pg)
            raise
        if pg is not None:
            with self.store.txn() as txn:
                state.pgroups[rid] = pg
                self._persist(txn, state)
            if self.catalog is not None:
                # The reservation survives controller death WITH its
                # replica: a failover successor re-binds it in _adopt so
                # retiring the adopted replica still frees the chips.
                self.catalog.register_pgroup(rid, pg)
        # Stamp the config version the replica was BUILT from: the rollout
        # stage retires replicas whose stamp differs from the target.
        replica.version = cfg.version
        if self.catalog is not None:
            self.catalog.register_replica(rid, replica)
        logger.info(
            "started replica %s%s%s", rid,
            f" (version {cfg.version!r})" if cfg.version else "",
            f" on chips {[str(d) for d in devices]}" if devices else "",
        )
        return replica

    def _release_chips(self, state: _DeploymentState, replica: Replica) -> None:
        pg = state.pgroups.pop(replica.replica_id, None)
        if pg is not None and self.placement is not None:
            self.placement.remove(pg)
        if self.catalog is not None:
            self.catalog.unregister_replica(replica.replica_id)
            self.catalog.unregister_pgroup(replica.replica_id)

    def _redeliver(
        self,
        router: Router,
        requests: List[Any],
        victim_id: str,
        dead: bool = False,
    ) -> None:
        """Salvage a retired replica's queued requests through the
        failover path: deadline-budgeted re-dispatch to a different
        replica, shed accounting when hopeless (terminal rejection
        belongs to the failover layer, not the heal path). ``dead``
        marks a crashed/wedged victim (heal) vs a planned rollout."""
        router.requeue_drained(requests, victim_id, dead=dead)  # rdb-lint: disable=retry-amplification (heal-path salvage of a dead replica's queue — relocation of admitted work, not client-visible retry amplification)

    def _migrate_live_streams(
        self, victim: Replica, state: _DeploymentState,
    ) -> None:
        """Deferred pre-stop directive: migrate the victim's live decode
        streams to surviving replicas through the page fabric (zero-drop
        rolling update / scale-down). Runs OUTSIDE the controller lock —
        it polls the drain for seconds. Peers resolve HERE, at run time,
        so replacements started in the same reconcile pass are already
        in ``state.replicas``. Replica kinds without a fabric surface
        (batch replicas, slab engines) fall through to the stop()'s own
        drain window — exactly the pre-fabric behavior. The heal path
        never routes here: a dead engine cannot export its pages, so
        salvage/requeue remains its only honest option."""
        if not hasattr(victim, "live_stream_ids"):
            return
        peers = [r for r in state.replicas
                 if r is not victim and not getattr(r, "_stopped", False)]
        if not peers:
            return
        stats = self.kv_fabric.drain_streams(victim, peers, timeout_s=20.0)
        if stats["requested"] or stats["remaining"]:
            self.audit.record(
                "live_migration",
                key=state.config.name,
                observed=stats,
                diff={"migrated_from": victim.replica_id},
            )

    def _reconcile(
        self,
        state: _DeploymentState,
        deferred: Optional[List[Callable[[], None]]] = None,
    ) -> List[Callable[[], None]]:
        """Drive actual replica count to target; replace unhealthy.

        Collects deferred (blocking) stop actions into ``deferred`` (the
        caller's list when given) and returns it — callers run them AFTER
        releasing the controller lock, so a slow drain or a wedged
        callable can't freeze the whole control plane. Collecting into
        the CALLER'S list matters on the fencing path: a StaleEpochError
        from a mid-reconcile commit propagates, but the stop/release
        actions already collected must still run (their victims are
        already out of the routing set — leaking their threads and chips
        helps nobody, least of all the successor). The whole pass is one
        store transaction: the durable mirror commits exactly once per
        reconcile, and only when something changed."""
        cfg = state.config
        if deferred is None:
            deferred = []
        with self.store.txn() as txn:
            # Heal: replace dead replicas up to max_restarts
            # (ref gcs_actor_manager.cc:1361-1393 restart budget). A replica
            # the gray-health monitor EJECTED (sustained straggling through
            # its whole probation) rides the same path: replaced like a dead
            # one, so the planner reclaims the chip from gray failures too.
            alive: List[Replica] = []
            for r in state.replicas:
                ejected = state.router.gray.state(r.replica_id) == "ejected"
                if r.healthy() and not ejected:
                    alive.append(r)
                    continue
                logger.warning(
                    "replica %s %s; replacing", r.replica_id,
                    "gray-ejected (straggler)" if ejected else "unhealthy",
                )
                # Salvage queued work, then stop the victim INLINE (its
                # loop is dead or wedged, so the join is bounded) — the
                # replacement may land on the same chips, which must be
                # genuinely free: chip reservation released AND, for
                # engines, HBM buffers dropped (LLMReplica.stop releases
                # them once the loop has exited).
                salvaged = r.drain_queue()
                r.stop(timeout_s=2.0, drain=False)
                self._release_chips(state, r)
                replacement: Optional[Replica] = None
                if state.restarts < cfg.max_restarts:
                    state.restarts += 1
                    try:
                        replacement = self._start_replica(state)
                        alive.append(replacement)
                    except StaleEpochError:
                        # A fenced write means this controller was
                        # deposed: it must STOP mutating, not log-and-
                        # continue — re-raise past the broad handler so
                        # _on_fenced runs (the split-brain guard).
                        raise
                    except PlacementError as e:
                        # Transient chip shortage is not a crash: hand the
                        # restart back and let a later control step retry
                        # via the scale-up loop below.
                        state.restarts -= 1
                        logger.warning(
                            "%s: replacement blocked: %s", cfg.name, e
                        )
                    except Exception:  # noqa: BLE001 — a failing start must
                        # not abort the control step (deferred redeliveries
                        # of other replicas would be dropped); the burned
                        # restart counts, so a crash-looping factory still
                        # exhausts its budget.
                        logger.exception(
                            "%s: replacement start failed", cfg.name
                        )
                else:
                    state.unhealthy = True
                    logger.error(
                        "%s: restart budget (%d) exhausted; deployment "
                        "unhealthy until redeployed",
                        cfg.name, cfg.max_restarts,
                    )
                if salvaged:
                    deferred.append(
                        lambda reqs=salvaged, rt=state.router,
                        vid=r.replica_id: (
                            self._redeliver(rt, reqs, vid, dead=True)
                        )
                    )
                self.audit.record(
                    "heal",
                    key=cfg.name,
                    observed={"unhealthy": r.replica_id,
                              "gray_ejected": ejected,
                              "salvaged_requests": len(salvaged)},
                    diff={
                        "replaced": r.replica_id,
                        "replacement": (replacement.replica_id
                                        if replacement is not None else None),
                    },
                    note=("" if replacement is not None
                          else "restart budget exhausted or start failed"),
                )
            state.replicas = alive
            # Rolling update (ref deployment_state.py rollout): while
            # replicas with a DIFFERENT version stamp exist, retire them in
            # batches of at most
            # ceil(rolling_max_unavailable_fraction * target) — and only as
            # many as keep the serving set at or above target - batch, so
            # both versions serve through the rollout and unavailability
            # stays bounded. Retired replicas drain in the deferred stop
            # (graceful: in-flight work finishes); the scale-up loop below
            # starts their new-version replacements this same pass.
            if cfg.version and not state.unhealthy:
                outdated = [
                    r for r in state.replicas
                    if getattr(r, "version", "") != cfg.version
                ]
                if outdated:
                    batch = max(
                        1, math.ceil(
                            cfg.rolling_max_unavailable_fraction
                            * cfg.num_replicas
                        ),
                    )
                    floor = cfg.num_replicas - batch
                    can_stop = max(0, len(state.replicas) - floor)
                    for victim in outdated[: min(batch, can_stop)]:
                        state.replicas.remove(victim)
                        logger.info(
                            "rolling out replica %s (version %r -> %r)",
                            victim.replica_id,
                            getattr(victim, "version", ""), cfg.version,
                        )
                        self.audit.record(
                            "rolling_update",
                            key=cfg.name,
                            before={"version": getattr(victim, "version", "")},
                            after={"version": cfg.version},
                            diff={"retired": victim.replica_id},
                        )
                        victim._stopped = True  # stale handles stop assigning
                        # Same salvage discipline as the heal path: queued
                        # (unstarted) requests move to surviving/new replicas
                        # immediately instead of gambling on the victim's
                        # drain window; only the in-flight batch finishes on
                        # the victim, with a rollout-sized timeout (a busy
                        # LLM replica's batch can legitimately run tens of
                        # seconds — the default 5 s drain would reject it).
                        salvaged = victim.drain_queue()
                        if salvaged:
                            deferred.append(
                                lambda reqs=salvaged, rt=state.router,
                                vid=victim.replica_id: (
                                    self._redeliver(rt, reqs, vid)
                                )
                            )
                        # Migration directive BEFORE the stop: live
                        # streams move to the surviving set (peers
                        # resolved at run time, after this pass's
                        # scale-up started the replacements) — rolling
                        # updates are zero-drop by construction, the
                        # stop's drain window is the fallback.
                        deferred.append(
                            lambda v=victim, st=state: (
                                self._migrate_live_streams(v, st)
                            )
                        )
                        deferred.append(
                            lambda v=victim, st=state: (
                                v.stop(timeout_s=60.0),
                                self._release_chips(st, v),
                            )
                        )
            # Scale to target — but an exhausted restart budget stops the
            # crash-loop: no replacements until a fresh deploy() resets it
            # (ref gcs_actor_manager.cc:1361-1393 — actors stay DEAD once
            # max_restarts is spent).
            n_before_scale = len(state.replicas)
            while len(state.replicas) < cfg.num_replicas \
                    and not state.unhealthy:
                try:
                    state.replicas.append(self._start_replica(state))
                except StaleEpochError:
                    raise  # deposed: stop mutating (see heal path note)
                except PlacementError as e:
                    # Not enough chips: hold at the current count and retry
                    # on later control steps (ref: the PG stays pending).
                    logger.warning("%s: scale-up blocked: %s", cfg.name, e)
                    break
                except Exception:  # noqa: BLE001 — hold and retry next step
                    logger.exception("%s: replica start failed", cfg.name)
                    break
            while len(state.replicas) > cfg.num_replicas:
                victim = state.replicas.pop()  # newest first, ref compact
                victim._stopped = True  # stale handles stop assigning
                # Zero-drop shrink: same migration-before-stop directive
                # as the rolling update above.
                deferred.append(
                    lambda v=victim, st=state: (
                        self._migrate_live_streams(v, st)
                    )
                )
                deferred.append(
                    lambda v=victim, st=state: (
                        v.stop(),
                        self._release_chips(st, v),
                    )
                )
            if len(state.replicas) != n_before_scale:
                self.audit.record(
                    "scale",
                    key=cfg.name,
                    observed={"target": cfg.num_replicas},
                    before={"replicas": n_before_scale},
                    after={"replicas": len(state.replicas)},
                    diff={"delta": len(state.replicas) - n_before_scale},
                )
            # Publish only on membership change: every publish clears the
            # router's queue-len cache, so steady-state reconciles must be
            # quiet.
            if [r.replica_id for r in state.replicas] != [
                r.replica_id for r in state.router.replicas()
            ]:
                self._publish(state)  # routing stops before deferred drains
            self._persist(txn, state)
        return deferred

    def _publish(self, state: _DeploymentState) -> None:
        """Push the replica set to routers via long poll (ref long_poll).
        The in-process router object updates directly (it is the live
        data plane the catalog adopts across failovers); the long-poll
        NOTIFY — the out-of-process push edge — rides the fabric, so a
        partitioned observer simply keeps its last snapshot and catches
        up on heal (snapshot ids are monotone)."""
        state.router.update_replicas(state.replicas)
        self.fabric.cast(
            "controller.push", self.long_poll.notify_changed,
            REPLICA_SET_KEY.format(deployment=state.config.name),
            [r.replica_id for r in state.replicas],
            src="controller", dst="router",
        )

    # --- control loop -----------------------------------------------------
    def _observe_gray(self, state: "_DeploymentState") -> None:
        """Tick the deployment's gray-health monitor with per-replica
        recent-latency sketches (the RollingSketch — recency-bounded,
        so the consensus describes the replica NOW). The monitor grades
        only replicas with enough samples and enough graded peers; the
        state machine's hysteresis does the rest."""
        obs = {}
        for r in state.replicas:
            try:
                obs[r.replica_id] = r.latency_observation()
            except Exception:  # noqa: BLE001 — stats must not stop control
                continue
        if len(obs) >= 2:
            state.router.gray.tick(obs)

    def _observe_admission(self, state: "_DeploymentState") -> None:
        """Feed the overload governor this deployment's congestion
        signals: worst replica queue-fill fraction + worst recent SLO
        compliance. Hysteresis and the degrade/recover decision live in
        the AdmissionController; every transition is audited."""
        if self.admission.policy(state.config.name) is None:
            return
        depth_frac = 0.0
        compliance = 1.0
        for r in state.replicas:
            cap = max(1, getattr(r, "max_ongoing_requests", 1))
            try:
                depth_frac = max(depth_frac, r.queue_len() / cap)
                compliance = min(compliance, r.slo_compliance())
            except Exception:  # noqa: BLE001 — stats must not stop control
                continue
        self.admission.observe(state.config.name, depth_frac, compliance)

    def _observe_slo(
        self, state: "_DeploymentState"
    ) -> Tuple[Dict[str, Dict[str, float]], Dict[str, Any]]:
        """One deployment's observatory inputs for this step: the
        replicas' per-class queue counters summed (the SAME cumulative
        ``class_stats()`` slices the sim grades burn from), plus the
        merged per-hop latency sketches (queue.wait from the delay
        windows, engine.step from the service windows). Demand is
        derived here too — the enqueued-counter delta since the last
        step feeds the rate registry and the fidelity replay ring, so
        the hot path carries zero new instrumentation."""
        name = state.config.name
        counters: Dict[str, Dict[str, float]] = {}
        delay_views = []
        service_views = []
        for r in state.replicas:
            try:
                for qos, c in r.queue.class_stats().items():
                    agg = counters.setdefault(qos, {})
                    for k, v in c.items():
                        agg[k] = agg.get(k, 0.0) + v
                delay_views.append(r.queue.queue_delay_window.view())
                service_views.append(r.queue.service_window.view())
            except Exception:  # noqa: BLE001 — stats must not stop control
                continue
        enqueued = sum(c.get("enqueued", 0.0) for c in counters.values())
        delta = enqueued - self._observed_enqueued.get(name, 0.0)
        self._observed_enqueued[name] = enqueued
        if delta > 0:
            self.rates.record(name, int(delta))
            self.observatory.note_arrivals(name, int(delta))
        hops = {
            "queue.wait": QuantileSketch.merged(delay_views),
            "engine.step": QuantileSketch.merged(service_views),
        }
        return counters, hops

    def _publish_prefix_digests(self, state: "_DeploymentState") -> None:
        """Collect each replica's bounded prefix-page digest chains and
        push them to the router's digest directory (+ the long-poll
        channel, so out-of-process routers ride the same mechanism as
        replica-set changes). Cluster-wide prefix routing:
        the router scores candidates by longest matching digest chain
        before the pow-2 pick."""
        directory = getattr(state.router, "digests", None)
        if directory is None:
            return
        changed = False
        for r in state.replicas:
            fn = getattr(r, "prefix_digests", None)
            if fn is None:
                continue
            try:
                pub = fn()
            except Exception:  # noqa: BLE001 — stats must not stop control
                continue
            if not pub:
                continue
            try:
                # Digest pushes ride the fabric: a controller partitioned
                # from its routers leaves the directory on its LAST
                # published set (stale steering hints degrade hit rate,
                # never correctness — the replica-level cache still
                # validates) and the next reachable tick republishes.
                if self.fabric.call(
                    "controller.digest_push", directory.publish,
                    r.replica_id, pub["page_size"], pub["digests"],
                    src="controller", dst="router",
                ):
                    changed = True
                if pub.get("reloaded"):
                    # Spill round-trip fix: a reload moved an entry
                    # between that replica's tiers WITHOUT changing its
                    # advertised union, so replacement-expiry reports
                    # "unchanged" — force the long-poll push anyway or
                    # out-of-process routers never reconverge on where
                    # the entry now lives.
                    changed = True
            except FabricUnreachable:
                continue
        if changed:
            self.fabric.cast(
                "controller.push", self.long_poll.notify_changed,
                PREFIX_DIGEST_KEY.format(deployment=state.config.name),
                directory.snapshot(),
                src="controller", dst="router",
            )

    def _publish_quarantine(self, state: "_DeploymentState") -> None:
        """Gossip the deployment's query-of-death fingerprints the same
        way prefix digests travel: durable mirror first (a failover
        successor keeps fencing known poison), then a long-poll push so
        every out-of-process front door merges the set and rejects
        repeats at admission. Fans out only when MEMBERSHIP changed —
        hit counters mutate on every front-door block and must not
        re-trigger pushes. Lost pushes are safe: a missed entry costs
        one more bisection on its next appearance, never correctness."""
        name = state.config.name
        registry = getattr(state.router, "quarantine", None)
        if registry is None:
            return
        snap = registry.snapshot()
        fps = frozenset(snap)
        if fps == self._quarantine_published.get(name, frozenset()):
            return
        with self.store.txn() as txn:
            txn.put_json(STORE_QUARANTINE_KEY.format(deployment=name),
                         snap)
        if not self.fabric.cast(
            "controller.push", self.long_poll.notify_changed,
            QUARANTINE_KEY.format(deployment=name), snap,
            src="controller", dst="router",
        ):
            return  # dropped: republished on the next tick
        self._quarantine_published[name] = fps

    def _renew_leadership(self) -> bool:
        """Heartbeat the store lease. A lapsed-but-UNCLAIMED lease (a
        long reconcile outran the renew cadence, nobody took over) is
        re-acquired by the same owner — same epoch, no fence, the
        control plane must not self-destruct with no successor. Only a
        lease another owner actually TOOK fences this controller
        permanently."""
        if self._fenced:
            return False
        if isinstance(self.store, ReplicatedStore):
            try:
                if not self.store.renew():
                    if self.store.acquire_leadership() is None:
                        self._on_fenced(None)
                        return False
                    logger.warning(
                        "lease lapsed unclaimed; re-acquired at epoch %d",
                        self.store.epoch,
                    )
            except FabricUnreachable as e:
                # Partitioned from the lease or the log: NOT fenced —
                # nobody provably took over. Skip the step and retry
                # next tick; on heal the same owner re-acquires (same
                # epoch) if no standby claimed the lapsed lease, or the
                # acquire returns None and fences us properly.
                logger.warning("leadership heartbeat unreachable "
                               "(%s); skipping control step", e)
                return False
        return True

    def _on_fenced(self, exc: Optional[StaleEpochError]) -> None:
        self._fenced = True
        self._stop.set()
        epoch = getattr(self.store, "epoch", 0)
        fence = getattr(getattr(self.store, "log", None), "fence_epoch",
                        epoch)
        logger.error(
            "controller fenced at epoch %d (log fence %d): a standby took "
            "over; this instance stops leading%s",
            epoch, fence, f" ({exc})" if exc is not None else "",
        )
        self.audit.record(
            "store_fenced",
            observed={"epoch": epoch, "fence": fence},
            note="lease lost or stale-epoch write rejected; control loop "
                 "stopped",
        )

    def _control_step(self) -> None:
        if not self._renew_leadership():
            return
        # Deferred stop/release actions run even if the step is fenced
        # mid-way: their victims are already unpublished and (where a
        # txn committed) out of the durable registry, so skipping them
        # would leak replica threads, HBM, and chip reservations that no
        # successor will ever reclaim.
        deferred: List[Callable[[], None]] = []
        try:
            with self._lock:
                slo_counters: Dict[str, Dict[str, Dict[str, float]]] = {}
                slo_hops: Dict[str, Dict[str, Any]] = {}
                for state in list(self._deployments.values()):
                    self._observe_gray(state)
                    self._observe_admission(state)
                    try:
                        counters, hops = self._observe_slo(state)
                        if counters:
                            slo_counters[state.config.name] = counters
                        slo_hops[state.config.name] = hops
                    except Exception:  # noqa: BLE001 — stats must not
                        pass           # stop control
                    self._publish_prefix_digests(state)
                    self._publish_quarantine(state)
                    # Governor -> budget coupling: while this deployment
                    # is congested (first-attempt attainment under
                    # floor), its retry/hedge budget is held at zero so
                    # recovery is monotone — amplification stops first.
                    budget = getattr(state.router, "retry_budget", None)
                    if budget is not None:
                        budget.set_congested(
                            self.admission.congested(state.config.name)
                        )
                    try:
                        # Prefix push-replication tick: hot entries move
                        # toward least-loaded peers ahead of demand.
                        # Only the directives are enqueued here (cheap);
                        # parcel delivery happens on the engines'
                        # threads at their next service points.
                        self.kv_fabric.push_hot_prefixes(
                            state.config.name, state.replicas,
                            getattr(state.router, "digests", None),
                        )
                    except Exception:  # noqa: BLE001 — pushes are
                        pass           # optimizations, never control-fatal
                    if state.policy is not None:
                        metrics = state.router.demand_metrics()
                        target = state.policy.step(
                            metrics["total_ongoing"], len(state.replicas)
                        )
                        if target is not None \
                                and target != state.config.num_replicas:
                            logger.info(
                                "%s: autoscale %d -> %d (ongoing=%.0f)",
                                state.config.name,
                                state.config.num_replicas,
                                target, metrics["total_ongoing"],
                            )
                            with self.store.txn() as txn:
                                state.config.num_replicas = target
                                self._persist(txn, state)
                    with self.store.txn() as txn:
                        # Durable governor/gray mirrors (elided unless a
                        # state actually changed). The governor mirror is
                        # READ BACK by recover(): a failover successor
                        # keeps enforcing the degraded-mode contract
                        # instead of re-admitting the flood. The gray
                        # mirror is observability — live verdicts ride
                        # the ADOPTED router's monitor object; this is
                        # the durable record of what was declared.
                        txn.put_json(
                            STORE_GOVERNOR_KEY.format(
                                deployment=state.config.name
                            ),
                            {"state": ("degraded" if self.admission.degraded(
                                state.config.name) else "normal"),
                             "congested": self.admission.congested(
                                state.config.name)},
                        )
                        txn.put_json(
                            STORE_GRAY_KEY.format(
                                deployment=state.config.name
                            ),
                            state.router.gray.states(),
                        )
                    try:
                        self._reconcile(state, deferred)
                    except StaleEpochError:
                        # The fence outranks per-deployment isolation: a
                        # deposed leader must stop the WHOLE step, not
                        # shrug one deployment off and mutate the next —
                        # re-raise to the fencing handler below.
                        raise
                    except Exception:  # noqa: BLE001 — one deployment's
                        # failure must not drop other deployments' deferred
                        # actions
                        logger.exception(
                            "%s: reconcile failed", state.config.name
                        )
                try:
                    # One observatory tick per control step — the same
                    # cumulative counters + hop sketches the sim twin
                    # feeds its instance of the SAME classes.
                    self.observatory.tick(slo_counters, self.rates,
                                          slo_hops)
                except Exception:  # noqa: BLE001 — observability must
                    # not stop control
                    logger.exception("observatory tick failed")
                self._checkpoint()
        except StaleEpochError as e:
            self._on_fenced(e)  # falls through: deferred still runs
        except FabricUnreachable as e:
            # A partition opened MID-step (appends unreachable). The
            # store's own bounded-window defense decides demotion; the
            # controller just stops mutating this tick and retries — on
            # a healed partition it resumes, on a lost lease the next
            # _renew_leadership fences it. Deferred stops still run:
            # their victims are already out of the routing set.
            logger.warning("control step partitioned from the store "
                           "(%s); retrying next tick", e)
        for action in deferred:  # blocking stops run outside the lock
            action()

    def _loop(self) -> None:
        while not self._stop.wait(self.control_interval_s):
            try:
                self._control_step()
            except Exception:  # noqa: BLE001
                logger.exception("control step failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-controller", daemon=True
        )
        self._thread.start()

    def crash(self) -> None:
        """Chaos/test harness: kill the control loop WITHOUT draining the
        data plane — the in-process analogue of controller death.
        Replicas, routers and in-flight requests keep running; the lease
        simply stops being renewed, so a standby (sharing the replicated
        store's log + lease) takes over when it lapses."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            victims: List[Tuple[_DeploymentState, Replica]] = []
            try:
                with self.store.txn() as txn:
                    for state in self._deployments.values():
                        victims.extend((state, r) for r in state.replicas)
                        state.replicas = []
                        state.router.close()
                        self._persist(txn, state)
            except StaleEpochError:
                # A deposed controller still tears down its local
                # references; the durable mirror belongs to the NEW
                # leader now (its registry is the truth).
                logger.warning(
                    "shutdown on a deposed controller: durable mirror "
                    "left to the current leader"
                )
        for state, r in victims:
            r.stop()
            self._release_chips(state, r)

    # --- checkpoint / recovery (ref controller.py:545, app_state:1096) ----
    def _checkpoint(self) -> None:
        # Snapshot configs under the (reentrant) lock: an API-thread
        # deploy() resizing _deployments mid-walk raises "dictionary
        # changed size during iteration" in this comprehension — the
        # registry race on the control plane.
        with self._lock:
            configs = {
                name: state.config.to_json()
                for name, state in self._deployments.items()
            }
        payload = json.dumps(configs, sort_keys=True)
        # Checkpoint-on-change: steady-state control steps must not rewrite
        # the KV file twice a second. (Legacy mirror — the store's
        # per-deployment keys are the authoritative durable state now;
        # this kv blob keeps pre-store restart flows working.)
        if payload != self._last_checkpoint:
            self.kv.put(CHECKPOINT_KEY, payload)
            self._last_checkpoint = payload

    def _adopt(self, name: str, cfg: DeploymentConfig) -> None:
        """Failover adoption: re-bind the live router and the surviving
        replicas recorded in the store instead of cold-starting the
        world. Only replicas recorded but missing (or unhealthy) get
        restarted — by the deploy/reconcile pass that follows."""
        registry = self.store.get_json(
            STORE_REGISTRY_KEY.format(deployment=name)
        ) or {}
        router = self.catalog.router(name) if self.catalog else None
        if router is None:
            return  # nothing live to adopt: deploy() cold-starts
        with self._lock:
            with self.store.txn() as txn:
                state = _DeploymentState(
                    config=cfg, factory=self._factories[name], router=router,
                )
                state.next_replica_ordinal = int(registry.get("ordinal", 0))
                # The health ledger survives the failover: a deployment
                # the old leader declared unhealthy (restart budget
                # spent) must NOT resume crash-looping on the successor
                # — "actors stay DEAD once max_restarts is spent" holds
                # across leaders.
                state.restarts = int(registry.get("restarts", 0))
                state.unhealthy = bool(registry.get("unhealthy", False))
                adopted: List[Replica] = []
                for rid in registry.get("ids", []):
                    r = self.catalog.replica(rid)
                    if r is None:
                        continue  # died with the old leader: reconcile
                        # restarts it from the registry count
                    # Adopt healthy AND unhealthy survivors: the heal
                    # pass retires unhealthy ones through its normal
                    # salvage/stop/release path (dropping them here
                    # would orphan their queues and chip reservations).
                    adopted.append(r)
                    pg = self.catalog.pgroup(rid)
                    if pg is not None:
                        state.pgroups[rid] = pg
                state.replicas = adopted
                state.router.audit = self.audit
                self._deployments[name] = state
                self._persist(txn, state)
        if adopted:
            self.audit.record(
                "failover_adopt",
                key=name,
                observed={"epoch": getattr(self.store, "epoch", 0)},
                diff={"adopted": [r.replica_id for r in adopted]},
                note="live data plane re-bound after controller failover",
            )

    def recover(self) -> List[str]:
        """Restore deployments from the store (factories must already be
        re-registered); falls back to the legacy kv checkpoint when the
        store is empty. With a catalog, live replicas/routers recorded in
        the store are ADOPTED — a controller failover re-binds the
        running data plane instead of restarting it. Returns recovered
        deployment names."""
        if isinstance(self.store, ReplicatedStore):
            self.store.catch_up()
        prefix = "serve:deployments/"
        names = sorted({
            k[len(prefix):].split("/")[0]
            for k in self.store.keys(prefix)
            if k.endswith("/config")
        })
        recovered = []
        if names:
            for name in names:
                if name not in self._factories:
                    logger.warning(
                        "stored deployment %r has no factory; skipping", name
                    )
                    continue
                cfg = DeploymentConfig.from_json(self.store.get_json(
                    STORE_CONFIG_KEY.format(deployment=name)
                ))
                adopted = False
                with self._lock:
                    absent = self.catalog is not None and \
                        name not in self._deployments
                if absent:
                    self._adopt(name, cfg)
                    with self._lock:
                        adopted = name in self._deployments
                self.deploy(cfg, _recovered=adopted)
                governor = self.store.get_json(
                    STORE_GOVERNOR_KEY.format(deployment=name)
                )
                if governor is not None:
                    # Keep enforcing the old leader's degraded-mode
                    # declaration; recovery still exits through the
                    # normal hysteresis once the flood actually ebbs.
                    # `congested` rides the same mirror (absent in
                    # pre-budget mirrors -> None leaves it untouched);
                    # the first control step pushes it back into the
                    # router's retry budget.
                    self.admission.force_state(
                        name, governor.get("state") == "degraded",
                        congested=governor.get("congested"),
                    )
                quarantined = self.store.get_json(
                    STORE_QUARANTINE_KEY.format(deployment=name)
                )
                if quarantined:
                    # Known queries of death stay fenced across the
                    # failover: merge the durable mirror into the adopted
                    # router's registry before traffic resumes.
                    with self._lock:
                        st = self._deployments.get(name)
                    if st is not None and getattr(
                            st.router, "quarantine", None) is not None:
                        st.router.quarantine.merge(quarantined)
                recovered.append(name)
            return recovered
        raw = self.kv.get(CHECKPOINT_KEY)
        if raw is None:
            return []
        for name, cfg_json in json.loads(raw).items():
            if name not in self._factories:
                logger.warning(
                    "checkpointed deployment %r has no factory; skipping", name
                )
                continue
            self.deploy(DeploymentConfig.from_json(cfg_json))
            recovered.append(name)
        return recovered

    def store_status(self) -> Dict[str, Any]:
        """The replicated-store view: version watermark, leadership epoch,
        fencing. Separate from the by-name deployment map in status()
        so dashboard consumers never see a phantom deployment."""
        out: Dict[str, Any] = {
            "kind": type(self.store).__name__,
            "version": self.store.version,
            "fenced": self._fenced,
        }
        if isinstance(self.store, ReplicatedStore):
            out.update(
                epoch=self.store.epoch,
                leader=self.store.is_leader(),
                log_records=len(self.store.log),
                rejected_appends=self.store.log.rejected_appends,
            )
        return out

    def status(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                name: {
                    "target_replicas": state.config.num_replicas,
                    "running_replicas": len(state.replicas),
                    "replicas": {
                        r.replica_id: r.stats() for r in state.replicas
                    },
                    "restarts": state.restarts,
                    "healthy": not state.unhealthy,
                    # Per-replica circuit-breaker state + the failover
                    # layer's retry/shed accounting (serve/failover.py) —
                    # the observable half of request-level fault tolerance.
                    "breakers": state.router.breaker_states(),
                    "failover": state.router.failover.stats(),
                    # Gray-health verdicts + hedge accounting:
                    # the straggler-defense half of fault tolerance.
                    "gray": state.router.gray.snapshot(),
                    "hedge": (state.router.hedge.stats()
                              if state.router.hedge is not None else None),
                    # Anti-amplification budget + query-of-death fence:
                    # the metastable-failure defense pair.
                    "retry_budget": state.router.retry_budget.stats(),
                    "quarantine": state.router.quarantine.stats(),
                    # Admission governor state (serve/admission.py):
                    # normal vs degraded + whether a policy is installed.
                    "admission": self.admission.snapshot(name),
                    # SLO observatory (serve/observatory.py): burn-rate
                    # alert states/transitions filtered to this
                    # deployment, plus forecast-error and fidelity-drift
                    # instruments (per-model — shared across the app).
                    "observatory": self.observatory.snapshot(key=name),
                    # Per-version replica counts: mid-rollout both the old
                    # and the new version appear here (ref deployment_state
                    # rollout status).
                    "target_version": state.config.version,
                    "versions": dict(collections.Counter(
                        getattr(r, "version", "") for r in state.replicas
                    )),
                    # Recent control-plane decisions about THIS deployment
                    # (deploys, scale moves, heals, rollouts) from the
                    # structured audit ring — filtered BEFORE slicing so a
                    # busy co-deployed app cannot evict this one's view.
                    "audit": self.audit.to_dicts(key=name, last=10),
                }
                for name, state in self._deployments.items()
            }
        return out

    def resources(self) -> Dict[str, Any]:
        """Cluster resource snapshot (separate from the by-name deployment
        map so state/dashboard consumers never see a phantom deployment)."""
        if self.placement is None:
            return {"nodes": {}, "reservations": []}
        return self.placement.resource_view()
