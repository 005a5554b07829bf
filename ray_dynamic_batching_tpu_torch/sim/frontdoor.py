"""Sim twin of the distributed control plane.

The million-user scenarios only run here: this module drives the REAL
control-plane classes — ``serve/frontdoor.FrontDoor`` (shard ring +
gossip ledgers), ``serve/store.ReplicatedStore`` / ``StoreLog`` /
``LeaderLease`` (epoch-fenced failover), and
``serve/router.PrefixDigestDirectory`` (cluster-wide prefix routing) — on
the virtual clock, so shard gossip, store failover, and digest routing
are deterministic events and two same-seed runs render byte-identical
reports.

One run plays THREE sub-twins over one seeded flood:

- **gossip budget**: arrivals admit through the sharded front door while
  gossip rounds fire on the virtual clock; the report carries the drift
  audit (fleet admissions vs the central oracle, bounded by
  ``(N-1) * rate * staleness``).
- **store failover**: a leader controller heartbeats transactions into
  the shared log until it is killed mid-flood; the standby acquires the
  lease when it lapses (epoch bump, log fence) and the deposed leader's
  next write is REJECTED — the report pins the epoch numbers and the
  :class:`StaleEpochError`.
- **digest routing**: admitted requests route over model replicas whose
  prefix caches publish digest chains into a real
  ``PrefixDigestDirectory``; the same workload replays with digest
  routing OFF (pure pow-2) as the per-replica baseline arm, so the
  cluster-hit-rate-beats-baseline claim is measured, not assumed.

The reference's gate (``tools/run_frontdoor_soak.py --sim``) asserts determinism,
accounting conservation, budget conservation within the staleness
bound, the epoch-fenced failover, and the hit-rate win.

Own copy of ``ray_dynamic_batching_tpu/sim/frontdoor.py``, whole, with
its import paths rewritten: it drives the port's ``serve/frontdoor.py``,
``serve/store.py`` and ``serve/router.PrefixDigestDirectory``.
"""

from __future__ import annotations

import collections
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_dynamic_batching_tpu_torch.scheduler.audit import AuditLog
from ray_dynamic_batching_tpu_torch.serve.fabric import (
    ControlFabric,
    FabricUnreachable,
)
from ray_dynamic_batching_tpu_torch.serve.frontdoor import FrontDoor
from ray_dynamic_batching_tpu_torch.serve.router import PrefixDigestDirectory
from ray_dynamic_batching_tpu_torch.serve.store import (
    LeaderLease,
    ReplicatedStore,
    StaleEpochError,
    StoreLog,
)
from ray_dynamic_batching_tpu_torch.sim.clock import EventLoop, VirtualClock

DEPLOYMENT = "llm"


@dataclass
class FrontDoorScenario:
    """Deterministic control-plane flood: parameters shared by the CI
    smoke (tools/frontdoor_smoke.json canon) and ad-hoc what-ifs."""

    seed: int = 0
    duration_s: float = 30.0
    # Front door: 4 shards, global budget 200 rps under a 400 rps flood
    # (2x over-subscribed — the budget must bind).
    n_shards: int = 4
    rate_rps: float = 200.0
    burst: float = 200.0
    offered_rps: float = 400.0
    gossip_interval_s: float = 0.5
    # Store failover: leader killed mid-flood; standby takes over when
    # the lease lapses.
    control_interval_s: float = 0.5
    lease_duration_s: float = 2.0
    kill_leader_at_s: float = 12.0
    # Digest routing: model replicas with bounded prefix caches serving
    # a prompt-family mix (a few hot system prompts + cold tails).
    n_replicas: int = 3
    n_families: int = 6
    family_chain_pages: int = 3
    replica_cache_entries: int = 4
    n_sessions: int = 40
    hot_family_bias: float = 0.7  # fraction of traffic on 2 hot families


class _ModelReplica:
    """Digest-routing model replica: a bounded LRU of digest-chain keys
    standing in for the paged prefix cache, plus a busy counter standing
    in for queue depth."""

    def __init__(self, rid: str, cache_entries: int) -> None:
        self.rid = rid
        self.cache: "collections.OrderedDict" = collections.OrderedDict()
        self.cache_entries = cache_entries
        self.busy = 0
        self.completed = 0
        self.hits = 0
        self.misses = 0

    def digests(self) -> Dict[str, int]:
        return {key: level for key, level in self.cache.items()}

    def serve(self, chain: List[str]) -> bool:
        """True on a prefix hit (deepest chain key cached)."""
        hit = any(key in self.cache for key in reversed(chain))
        if hit:
            self.hits += 1
            deepest = next(k for k in reversed(chain) if k in self.cache)
            self.cache.move_to_end(deepest)
        else:
            self.misses += 1
        # Serving publishes the full chain (the admission inserts every
        # full-page prefix, exactly like PagedPrefixCache.insert).
        for level, key in enumerate(chain, start=1):
            if key not in self.cache:
                self.cache[key] = level
        while len(self.cache) > self.cache_entries:
            self.cache.popitem(last=False)
        return hit


def _family_chain(family: int, pages: int) -> List[str]:
    """Synthetic digest chain for a prompt family — stable strings play
    the role of the blake2b level keys (the directory treats keys as
    opaque)."""
    return [f"fam{family}:{level}" for level in range(1, pages + 1)]


def _run_arm(sc: FrontDoorScenario, digest_routing: bool) -> Dict[str, Any]:
    """One full deterministic run; the baseline arm re-runs the same
    seed with digest routing disabled."""
    clock = VirtualClock()
    loop = EventLoop(clock)
    rng = random.Random(sc.seed)

    # --- front door (real classes, virtual clock) -----------------------
    fd = FrontDoor(n_shards=sc.n_shards, clock=clock.now_s,
                   gossip_interval_s=sc.gossip_interval_s)
    fd.configure(DEPLOYMENT, sc.rate_rps, sc.burst)

    # --- replicated store (real classes, virtual clock) -----------------
    log = StoreLog(clock=clock.now_s)
    lease = LeaderLease(sc.lease_duration_s, clock=clock.now_s)
    leader = ReplicatedStore(log, lease, "ctl-A")
    assert leader.acquire_leadership() == 1
    standby = ReplicatedStore(log, lease, "ctl-B")
    store_state: Dict[str, Any] = {
        "leader": "ctl-A", "epoch": 1, "failover_at_s": None,
        "stale_write_rejected": False, "stale_error": "",
        "heartbeats": {"ctl-A": 0, "ctl-B": 0},
        "completions_while_leaderless": 0,
    }

    # --- digest-routing data plane --------------------------------------
    replicas = {f"r{i}": _ModelReplica(f"r{i}", sc.replica_cache_entries)
                for i in range(sc.n_replicas)}
    directory = PrefixDigestDirectory()
    counts = {"arrivals": 0, "admitted": 0, "rejected": 0, "completed": 0,
              "errors": 0}

    def route(chain: List[str]) -> _ModelReplica:
        ids = sorted(replicas)
        if digest_routing and chain:
            depth, holders = directory.best(chain, ids)
            if depth > 0:
                ids = sorted(holders)
        if len(ids) == 1:
            return replicas[ids[0]]
        a, b = rng.sample(ids, 2)
        return replicas[a if replicas[a].busy <= replicas[b].busy else b]

    def service_time(hit: bool, chain: List[str]) -> float:
        # Prefill dominates cold admissions; a prefix hit skips it.
        return 0.01 + (0.0 if hit else 0.01 * len(chain))

    def arrival(session: int, family: int) -> None:
        counts["arrivals"] += 1
        payload = {"session_id": f"s{session}"}
        _, ok, _retry = fd.admit(DEPLOYMENT, payload=payload,
                                 tenant=f"t{session % 4}")
        if not ok:
            counts["rejected"] += 1
            return
        counts["admitted"] += 1
        chain = _family_chain(family, sc.family_chain_pages)
        replica = route(chain)
        hit = replica.serve(chain)
        replica.busy += 1

        def complete(r=replica) -> None:
            r.busy -= 1
            r.completed += 1
            counts["completed"] += 1
            if store_state["leader"] is None:
                store_state["completions_while_leaderless"] += 1

        loop.schedule_in(service_time(hit, chain) * 1000.0, complete)

    # Seeded arrival schedule (exponential gaps), fixed up front so both
    # arms replay the identical offered load.
    t_ms = 0.0
    horizon_ms = sc.duration_s * 1000.0
    hot = (0, 1)
    while True:
        t_ms += rng.expovariate(sc.offered_rps) * 1000.0
        if t_ms >= horizon_ms:
            break
        session = rng.randrange(sc.n_sessions)
        if rng.random() < sc.hot_family_bias:
            family = hot[rng.randrange(len(hot))]
        else:
            family = 2 + rng.randrange(sc.n_families - 2)
        loop.schedule_at(t_ms, lambda s=session, f=family: arrival(s, f))

    # Gossip rounds on the virtual clock.
    def gossip() -> None:
        fd.gossip_round()
        if clock.now_ms() + sc.gossip_interval_s * 1000.0 < horizon_ms:
            loop.schedule_in(sc.gossip_interval_s * 1000.0, gossip)

    loop.schedule_in(sc.gossip_interval_s * 1000.0, gossip)

    # Control ticks: the live leader heartbeats a transaction; the
    # standby replays the log and takes over once the lease lapses.
    # Digest publications ride the control tick, like the live
    # controller's _publish_prefix_digests.
    def control_tick() -> None:
        now_s = clock.now_s()
        if store_state["leader"] == "ctl-A" \
                and now_s >= sc.kill_leader_at_s:
            store_state["leader"] = None  # killed: stops renewing
        active = {"ctl-A": leader, "ctl-B": standby}.get(
            store_state["leader"] or ""
        )
        if active is not None and active.renew():
            with active.txn() as txn:
                txn.put_json("serve:heartbeat", {
                    "owner": active.owner,
                    "tick": store_state["heartbeats"][active.owner] + 1,
                })
            store_state["heartbeats"][active.owner] += 1
        elif store_state["leader"] is None:
            epoch = standby.acquire_leadership()
            if epoch is not None:
                store_state["leader"] = "ctl-B"
                store_state["epoch"] = epoch
                store_state["failover_at_s"] = round(now_s, 3)
                # The deposed leader wakes up and tries to finish a
                # half-done write: the fence must reject it.
                try:
                    with leader.txn() as txn:
                        txn.put_json("serve:heartbeat",
                                     {"owner": "ctl-A", "tick": -1})
                except StaleEpochError as e:
                    store_state["stale_write_rejected"] = True
                    store_state["stale_error"] = str(e)
        for rid in sorted(replicas):
            directory.publish(rid, 128, replicas[rid].digests())
        if clock.now_ms() + sc.control_interval_s * 1000.0 < horizon_ms:
            loop.schedule_in(sc.control_interval_s * 1000.0, control_tick)

    loop.schedule_in(sc.control_interval_s * 1000.0, control_tick)

    # Drift audited AT the flood horizon (the allowance line keeps
    # growing while arrivals have stopped — auditing later would read
    # artificially under-admitted), then drain so in-flight completions
    # land.
    loop.run_until(horizon_ms)
    drift = fd.drift_audit(DEPLOYMENT)
    loop.run_until(horizon_ms + 5_000.0)
    hits = sum(r.hits for r in replicas.values())
    misses = sum(r.misses for r in replicas.values())
    return {
        "digest_routing": digest_routing,
        "counts": counts,
        "drift": drift,
        "frontdoor": fd.stats(),
        "store": {
            **{k: v for k, v in store_state.items()
               if k != "stale_error"},
            "stale_error": store_state["stale_error"][:80],
            "log_records": len(log),
            "rejected_appends": log.rejected_appends,
            "fence_epoch": log.fence_epoch,
        },
        "routing": {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / max(1, hits + misses), 4),
            "per_replica": {
                rid: {"completed": r.completed, "hits": r.hits,
                      "misses": r.misses}
                for rid, r in sorted(replicas.items())
            },
            "directory_publishes": directory.snapshot()["publishes"],
        },
    }


def run_frontdoor_sim(
    scenario: Optional[FrontDoorScenario] = None,
) -> Dict[str, Any]:
    """Both arms (digest routing on / off) over the identical seeded
    flood; the gate compares their hit rates and checks every
    conservation invariant on the routed arm."""
    sc = scenario or FrontDoorScenario()
    return {
        "scenario": vars(sc),
        "routed": _run_arm(sc, digest_routing=True),
        "baseline": _run_arm(sc, digest_routing=False),
    }


# --- partition defense -------------------------------------------


def run_partition_sim(scenario: Any) -> Dict[str, Any]:
    """One partition-matrix arm (sim/scenarios.PartitionScenario) on the
    virtual clock, riding the REAL classes end to end: a ControlFabric
    with the scenario's partition windows (delays are events on the
    event loop — byte-deterministic), a sharded FrontDoor with the
    fail-closed staleness bound armed, and a ReplicatedStore leader +
    COLD standby with snapshot compaction.

    The story the gate grades: the flood admits under the global
    budget; the partition opens mid-run; the leader either self-demotes
    (appends unreachable — the asymmetric case) or demotes on lease
    loss; the standby takes over by snapshot + tail replay (O(tail));
    the deposed epoch's post-heal write is REJECTED at the fence (zero
    split-brain commits); gossip-partitioned ledgers degrade fail-closed
    within the audited bound and re-converge to exact global counts on
    heal; the data plane never surfaces a system error."""
    sc = scenario
    clock = VirtualClock()
    loop = EventLoop(clock)
    rng = random.Random(sc.seed)

    fabric = ControlFabric(
        clock=clock.now_s,
        scheduler=lambda delay_ms, fn: loop.schedule_in(delay_ms, fn),
        seed=sc.seed,
        partition_spec=sc.partition_spec,
        edge_spec=sc.edge_spec,
    )

    # --- sharded front door, fail-closed bound armed ---------------------
    fd = FrontDoor(n_shards=sc.n_shards, clock=clock.now_s,
                   gossip_interval_s=sc.gossip_interval_s,
                   fabric=fabric, staleness_bound_s=sc.staleness_bound_s)
    fd.configure(DEPLOYMENT, sc.rate_rps, sc.burst)

    # --- replicated store: leader + cold standby -------------------------
    log = StoreLog(clock=clock.now_s)
    lease = LeaderLease(sc.lease_duration_s, clock=clock.now_s)
    leader = ReplicatedStore(log, lease, "ctl-A", fabric=fabric,
                             clock=clock.now_s,
                             snapshot_every=sc.snapshot_every)
    standby = ReplicatedStore(log, lease, "ctl-B", fabric=fabric,
                              clock=clock.now_s,
                              snapshot_every=sc.snapshot_every)
    store_audit = AuditLog("store", now=clock.now_s)
    leader.audit = store_audit
    standby.audit = store_audit
    assert leader.acquire_leadership() == 1

    # Synthetic uptime: a long committed history BEFORE the flood, so
    # the failover replay cost is judged against real log length (the
    # O(tail) ratchet — without compaction this would all replay).
    for i in range(sc.preload_txns):
        with leader.txn() as txn:
            txn.put_json("serve:preload", {"i": i})

    # No "errors" key: the sim data plane (admit → fixed-latency
    # completion) has no error path by construction, so an error count
    # would gate nothing — the zero-system-errors invariant is the LIVE
    # arm's to prove; the sim arms prove completed == admitted.
    counts = {"arrivals": 0, "admitted": 0, "rejected": 0,
              "completed": 0}
    story: Dict[str, Any] = {
        "leader": "ctl-A", "epoch": 1, "first_epoch": 1,
        "failovers": [], "heartbeats": {"ctl-A": 0, "ctl-B": 0},
        "stale_write_rejected": False, "stale_error": "",
        "split_brain_commits": 0, "max_over_admitted": 0.0,
    }
    had_led = {"ctl-A": True, "ctl-B": False}
    fenced = {"ctl-A": False, "ctl-B": False}

    # --- data plane (unaffected by control partitions by design) ---------
    def arrival(session: int, tenant: int) -> None:
        counts["arrivals"] += 1
        _, ok, _retry = fd.admit(
            DEPLOYMENT, payload={"session_id": f"s{session}"},
            tenant=f"t{tenant}",
        )
        if not ok:
            counts["rejected"] += 1
            return
        counts["admitted"] += 1
        loop.schedule_in(20.0, lambda: counts.__setitem__(
            "completed", counts["completed"] + 1))

    t_ms = 0.0
    horizon_ms = sc.duration_s * 1000.0
    end_ms = horizon_ms + sc.drain_s * 1000.0
    while True:
        t_ms += rng.expovariate(sc.offered_rps) * 1000.0
        if t_ms >= horizon_ms:
            break
        session = rng.randrange(sc.n_sessions)
        tenant = rng.randrange(sc.n_tenants)
        loop.schedule_at(t_ms, lambda s=session, t=tenant: arrival(s, t))

    # --- gossip (fabric-routed absorbs), through the drain ---------------
    def gossip() -> None:
        fd.gossip_round()
        if clock.now_ms() + sc.gossip_interval_s * 1000.0 <= end_ms:
            loop.schedule_in(sc.gossip_interval_s * 1000.0, gossip)

    loop.schedule_in(sc.gossip_interval_s * 1000.0, gossip)

    # --- control ticks ----------------------------------------------------
    def control_tick() -> None:
        now_s = clock.now_s()
        # 1. The instance that believes it leads heartbeats a txn; a
        #    failing renew demotes it, unreachable appends feed the
        #    bounded self-demotion window.
        active = next((s for s in (leader, standby) if s.is_leader()),
                      None)
        if active is not None and active.renew():
            try:
                with active.txn() as txn:
                    txn.put_json("serve:heartbeat", {
                        "owner": active.owner,
                        "tick": story["heartbeats"][active.owner] + 1,
                    })
                story["heartbeats"][active.owner] += 1
            except FabricUnreachable:
                pass  # the store tracked it (self-demotion window)
            except StaleEpochError:
                fenced[active.owner] = True
        # 2. Non-leaders run for the lease (standby first — it is the
        #    one on the log's side of every partition in the matrix).
        for cand in (standby, leader):
            if fenced[cand.owner] or cand.is_leader():
                continue
            try:
                epoch = cand.acquire_leadership()
            except FabricUnreachable:
                continue  # cut off from the log: no candidacy
            if epoch is None:
                # Another owner's lease is live. For an instance that
                # HAS led, that is the fence (a successor exists); a
                # standby that never led just keeps waiting.
                if had_led[cand.owner] and not cand.is_leader():
                    fenced[cand.owner] = True
                continue
            had_led[cand.owner] = True
            if cand.owner != story["leader"] or epoch != story["epoch"]:
                story["failovers"].append({
                    "at_s": round(now_s, 3), "owner": cand.owner,
                    "epoch": epoch,
                    "snapshot_index":
                        cand.last_recovery["snapshot_index"],
                    "tail_replayed":
                        cand.last_recovery["tail_replayed"],
                })
            story["leader"] = cand.owner
            story["epoch"] = epoch
        # 3. Zero-split-brain probe: once a successor leads and the
        #    partition healed, the deposed epoch wakes up and tries to
        #    finish a half-done write — it MUST bounce off the fence.
        if (story["leader"] != "ctl-A"
                and not story["stale_write_rejected"]
                and not fabric.partition_active()):
            try:
                fabric.call(
                    "store.append", log.append, story["first_epoch"],
                    [("put", "serve:half-done", "stale")],
                    src="ctl-A", dst="log",
                )
                story["split_brain_commits"] += 1
            except StaleEpochError as e:
                story["stale_write_rejected"] = True
                story["stale_error"] = str(e)[:80]
            except FabricUnreachable:
                pass
        # 4. Over-admission time series against the central oracle.
        budget = fd.budget(DEPLOYMENT)
        if budget is not None:
            over = fd.true_admitted(DEPLOYMENT) - budget.allowed(now_s)
            story["max_over_admitted"] = max(story["max_over_admitted"],
                                             round(over, 3))
        if clock.now_ms() + sc.control_interval_s * 1000.0 <= end_ms:
            loop.schedule_in(sc.control_interval_s * 1000.0, control_tick)

    loop.schedule_in(sc.control_interval_s * 1000.0, control_tick)

    # Drift audited AT the flood horizon (the allowance line keeps
    # growing after arrivals stop), then the drain window lets
    # completions land, post-heal gossip re-converge, and the fence
    # probe fire.
    loop.run_until(horizon_ms)
    drift = fd.drift_audit(DEPLOYMENT)
    loop.run_until(end_ms)

    # --- end-state convergence check --------------------------------------
    true_admitted = fd.true_admitted(DEPLOYMENT)
    now_s = clock.now_s()
    ledgers: Dict[str, Any] = {}
    reconverged = True
    for sid in sorted(fd.shards):
        ledger = fd.shards[sid].ledger(DEPLOYMENT)
        ledger.check(now_s)  # refresh the degraded flag post-heal
        ledgers[sid] = {
            "own": ledger.own_count,
            "merged": ledger.merged_count(),
            "degraded_entries": ledger.degraded_entries,
            "stale_at_end": ledger.stale(now_s),
        }
        if ledger.merged_count() != true_admitted or ledger.stale(now_s):
            reconverged = False

    demote_audits = [a for a in store_audit.to_dicts()
                     if a["trigger"] == "store_unreachable"]
    return {
        "scenario": {k: v for k, v in vars(sc).items()},
        "counts": counts,
        "drift": drift,
        "max_over_admitted": story["max_over_admitted"],
        "degrade_bound": round(
            (sc.n_shards - 1) * sc.rate_rps * sc.staleness_bound_s
            + sc.n_shards, 3),
        "frontdoor": fd.stats(),
        "store": {
            "leader": story["leader"],
            "epoch": story["epoch"],
            "failovers": story["failovers"],
            "heartbeats": story["heartbeats"],
            "self_demotions": {"ctl-A": leader.self_demotions,
                               "ctl-B": standby.self_demotions},
            "demote_audits": len(demote_audits),
            "stale_write_rejected": story["stale_write_rejected"],
            "stale_error": story["stale_error"],
            "split_brain_commits": story["split_brain_commits"],
            "rejected_appends": log.rejected_appends,
            "fence_epoch": log.fence_epoch,
            "appended_total": log.appended_total,
            "log_tail_records": len(log),
            "max_tail_replayed": max(leader.max_tail_replayed,
                                     standby.max_tail_replayed),
            "snapshots_taken": (leader.snapshots_taken
                                + standby.snapshots_taken),
        },
        "ledgers": ledgers,
        "reconverged": reconverged,
        "true_admitted": true_admitted,
        "fabric": fabric.stats(),
    }
