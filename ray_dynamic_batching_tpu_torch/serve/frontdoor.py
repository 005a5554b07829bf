"""Sharded front door — N stateless proxy shards, one global budget.

One proxy + one admission table is a single-process ceiling no matter how
fast the engines are (PAPER.md's Serve router tier; ROADMAP item 5). This
module scales the front door OUT while keeping the admission contract
GLOBAL:

- :class:`HashRing` — consistent hashing with virtual nodes. Requests
  route to shards by **affinity key** (session id, else tenant, else the
  request id): a session's turns always land on the same shard (whose
  local state — admission history, keep-alive connection — stays warm),
  and a membership change moves only ~1/N of the key space.
- :class:`GlobalAdmissionLedger` — each shard's admissions land in its
  own :class:`~ray_dynamic_batching_tpu_torch.utils.sketch.QuantileSketch` (the
  mergeable-state primitive: per-shard sketches are disjoint, so the
  fleet view is an EXACT merge); shards gossip their serialized sketch
  states and keep peers' latest by replacement (a delta-state CRDT — a
  re-delivered or reordered gossip message cannot double-count). The
  admission decision compares the merged fleet count against the global
  budget line ``burst + rate * elapsed``.
- :class:`FrontDoorShard` — exposes exactly the ``admit(deployment,
  tenant, qos) -> (ok, retry_after_s)`` surface the HTTP/gRPC proxies
  already consult, so a shard drops into ``HTTPProxy(admission=shard)``
  unchanged. Optionally CHAINS a local
  :class:`~ray_dynamic_batching_tpu_torch.serve.admission.AdmissionController`
  so per-(tenant, class) fairness and the overload governor keep working
  per shard under the global cap.
- :class:`FrontDoor` — owns the ring + shards + budgets, runs gossip
  (a deterministic ``gossip_round()`` the simulator drives on virtual
  time; a daemon thread in live mode), and AUDITS the price of
  distribution: :meth:`drift_audit` compares the true fleet admission
  count against the central-oracle allowance and records the
  over/under-admission drift next to every other control-plane decision.

Staleness bound (the contract the soak gate checks): between gossip
rounds each shard is blind to what the other ``N-1`` shards admitted in
the window, so fleet over-admission versus the oracle is bounded by
``(N - 1) * rate * staleness`` (+ one request per shard of rounding) —
tighten the gossip interval and the front door converges on the central
bucket it replaces. That bound only holds while gossip FLOWS: a
partitioned shard's staleness grows without limit, and with it the
over-admission. The ledger therefore enforces its own staleness
contract (opt-in via ``staleness_bound_s``): when any
expected peer's newest state is older than the bound, the ledger DEGRADES
fail-closed to a conservative local-fraction budget — own admissions
against ``allowed / N`` — so a gossip-partitioned fleet in aggregate
never exceeds the global allowance, at the price of under-admission
until heal. The transition is audited (``ledger_degraded``), counted
(``rdb_frontdoor_ledger_degraded_total``) and gauged; when gossip
resumes the ledger re-converges to the exact merged fleet count and
exits degraded mode.

Partition seam: peer-state absorption (the partitionable shard↔shard
edge) routes through the control fabric (``serve/fabric.py``), so the
partition soak drops/delays/duplicates gossip with the same seeded
policy the store and the long-poll channel ride.

Clock-injected throughout: the sim twin (sim/frontdoor.py) runs shards,
gossip, and budget math on the virtual clock, byte-deterministically.

Own copy of ``ray_dynamic_batching_tpu/serve/frontdoor.py``, whole, with
its import paths rewritten, over the port's ``serve/fabric.py``,
``scheduler/audit.py`` and metrics registry. ``FrontDoor.stop()`` joins
the gossip thread.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.scheduler.audit import AuditLog
from ray_dynamic_batching_tpu_torch.serve.fabric import ControlFabric, default_fabric
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch

logger = get_logger("frontdoor")

FRONTDOOR_ADMISSION = m.Counter(
    "rdb_frontdoor_admission_total",
    "Front-door global-budget decisions (outcome: admit | reject)",
    tag_keys=("deployment", "shard", "outcome"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)
FRONTDOOR_GOSSIP = m.Counter(
    "rdb_frontdoor_gossip_total", "Gossip exchanges completed",
    tag_keys=("shard",),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)
FRONTDOOR_DRIFT = m.Gauge(
    "rdb_frontdoor_budget_drift",
    "Fleet admitted minus central-oracle allowance (positive = "
    "over-admission within the gossip staleness bound)",
    tag_keys=("deployment",),
)
FRONTDOOR_LEDGER_DEGRADED = m.Counter(
    "rdb_frontdoor_ledger_degraded_total",
    "Ledger transitions into fail-closed degraded mode (peer gossip "
    "staler than the bound: admit against the local fraction of the "
    "global budget until heal)",
    tag_keys=("deployment", "shard"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)
FRONTDOOR_LEDGER_DEGRADED_GAUGE = m.Gauge(
    "rdb_frontdoor_ledger_degraded",
    "1 while the shard's ledger for the deployment is in fail-closed "
    "degraded mode, else 0",
    tag_keys=("deployment", "shard"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)


def _hash64(key: str) -> int:
    """Deterministic 64-bit ring position (blake2b — NOT Python's
    ``hash``, whose per-process seed would re-deal the ring every
    restart and void session affinity)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``vnodes`` points per shard smooth the key-space split (64 gives
    <~15% imbalance across 2-32 shards); removal of a shard hands only
    its arcs to the survivors — the ~1/N movement bound session
    affinity relies on."""

    def __init__(self, shard_ids: List[str], vnodes: int = 64) -> None:
        if vnodes <= 0:
            raise ValueError(f"vnodes must be positive, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []
        self._shards: List[str] = []
        for sid in shard_ids:
            self.add(sid)

    def add(self, shard_id: str) -> None:
        if shard_id in self._shards:
            return
        self._shards.append(shard_id)
        for v in range(self.vnodes):
            self._points.append((_hash64(f"{shard_id}#{v}"), shard_id))
        self._points.sort()

    def remove(self, shard_id: str) -> None:
        if shard_id not in self._shards:
            return
        self._shards.remove(shard_id)
        self._points = [(h, s) for h, s in self._points if s != shard_id]

    def shards(self) -> List[str]:
        return list(self._shards)

    def shard_for(self, key: str) -> str:
        if not self._points:
            raise ValueError("ring has no shards")
        h = _hash64(key)
        i = bisect.bisect_right(self._points, (h, "￿"))
        if i == len(self._points):
            i = 0
        return self._points[i][1]


def affinity_key(payload: Any = None, tenant: Optional[str] = None,
                 request_id: Optional[str] = None) -> str:
    """The ring key: session id wins (a conversation's turns must reuse
    one shard's warm state), then tenant (a tenant's requests share one
    shard's bucket locality), then the request id (stateless spread)."""
    if isinstance(payload, dict) and payload.get("session_id") is not None:
        return f"session:{payload['session_id']}"
    if tenant:
        return f"tenant:{tenant}"
    return f"request:{request_id or ''}"


@dataclass
class GlobalBudget:
    """A deployment's cluster-wide admission contract: the fleet may
    admit at most ``burst + rate_rps * elapsed`` requests in total,
    enforced across every shard through gossip. ``t0`` anchors the
    allowance line; every shard uses the same anchor."""

    rate_rps: float
    burst: float
    t0: float

    def allowed(self, now: float) -> float:
        return self.burst + self.rate_rps * max(0.0, now - self.t0)


class GlobalAdmissionLedger:
    """One shard's view of one deployment's fleet-wide admissions.

    Own admissions are observed into a :class:`QuantileSketch` (value =
    seconds since the budget anchor, so the merged fleet sketch also
    carries the admission-time distribution for the drift audit); peer
    states arrive as serialized sketches and are kept BY REPLACEMENT
    keyed on shard id — merging happens at read time over own + latest
    peers, which makes gossip idempotent (delta-state CRDT) where naive
    fold-on-receive would double-count every re-delivery.

    Staleness contract (fail-closed, opt-in via ``staleness_bound_s``
    > 0 with ``n_shards`` > 1): every absorb stamps arrival time; when
    ANY expected peer's newest state is older than the bound — the
    stalest peer governs, so a PARTIAL partition (same-side gossip
    still fresh, the far side frozen) degrades exactly like a full one;
    a peer never heard from counts from the budget anchor —
    :meth:`check` degrades to own admissions against
    ``allowed / n_shards``. All shards degrading independently still
    sum to at most the global allowance — the partition can only
    UNDER-admit, never over-admit unboundedly. Fresh gossip from every
    peer clears the degradation and the merged count resumes
    (re-convergence is automatic: the CRDT replacement needs no repair
    pass). Departed shards are RETIRED (:meth:`retire_peer`): their
    final history keeps counting but never goes stale, and the live
    fleet width shrinks with them."""

    def __init__(self, shard_id: str, budget: GlobalBudget,
                 n_shards: int = 1,
                 staleness_bound_s: float = 0.0) -> None:
        self.shard_id = shard_id
        self.budget = budget
        self.n_shards = max(1, int(n_shards))
        self.staleness_bound_s = float(staleness_bound_s)
        self._own = QuantileSketch(relative_accuracy=0.01)
        self._peers: Dict[str, Dict[str, Any]] = {}
        self._peer_seen_at: Dict[str, float] = {}
        self._static_peers: set = set()   # departed: final history, exempt
        self.degraded = False
        self.degraded_entries = 0    # transitions INTO degraded mode

    @property
    def own_count(self) -> int:
        return self._own.count

    def peer_count(self) -> int:
        return sum(int(s.get("count", 0)) for s in self._peers.values())

    def merged_count(self) -> int:
        return self._own.count + self.peer_count()

    def merged_sketch(self) -> QuantileSketch:
        """The fleet view, via the sketch merge primitive: per-shard
        sketches are disjoint observation sets, so bucket adds are exact
        and the merged count is the true fleet total as of each shard's
        last publication."""
        peers = [QuantileSketch.from_dict(s) for s in self._peers.values()]
        out = QuantileSketch(relative_accuracy=self._own.relative_accuracy)
        out.merge(self._own)
        for p in peers:
            out.merge(p)
        return out

    def peer_staleness_s(self, now: float) -> float:
        """Age of the STALEST live peer's newest state (the budget
        anchor stands in for peers never heard from). The stalest peer
        governs because any invisible slice of the fleet voids the
        merged count — a partial partition must fail closed exactly
        like a full one."""
        live = {sid: t for sid, t in self._peer_seen_at.items()
                if sid not in self._static_peers}
        ages = [now - t for t in live.values()]
        if len(live) < self.n_shards - 1:
            ages.append(now - self.budget.t0)
        return max(0.0, max(ages)) if ages else 0.0

    def stale(self, now: float) -> bool:
        return (self.n_shards > 1
                and self.staleness_bound_s > 0.0
                and self.peer_staleness_s(now) > self.staleness_bound_s)

    def refresh(self, now: float) -> None:
        """Re-evaluate the degraded flag from the staleness contract
        alone (no admission decision): gossip progress and the passage
        of time must move the flag — and the gauge/audit riding it —
        even for a deployment nobody is admitting through."""
        self.degraded = self.stale(now)

    def retire_peer(self, shard_id: str) -> None:
        """A peer left the ring for good: its (final-flushed) history
        keeps counting in the merged view but is exempt from the
        staleness contract, and the live fleet width shrinks — the
        degraded local fraction is a share of the SURVIVORS."""
        self._static_peers.add(shard_id)
        self._peer_seen_at.pop(shard_id, None)
        self.n_shards = max(1, self.n_shards - 1)

    def check(self, now: float) -> Tuple[bool, float]:
        """(would_admit, retry_after_s) against the GLOBAL allowance as
        this shard currently sees it — read-only, so a later local-layer
        reject never burns a global token. The retry hint is when the
        allowance line reaches the known count — exact once gossip
        catches up, conservative before.

        When peer gossip is staler than the bound, the decision
        DEGRADES fail-closed: own admissions against the local fraction
        ``allowed / n_shards`` (flagged on ``self.degraded``; the shard
        audits and meters the transition)."""
        if self.stale(now):
            self.degraded = True
            allowed = self.budget.allowed(now) / self.n_shards
            count = self._own.count
            rate = self.budget.rate_rps / self.n_shards
        else:
            self.degraded = False
            allowed = self.budget.allowed(now)
            count = self.merged_count()
            rate = self.budget.rate_rps
        if count < allowed:
            return True, 0.0
        if rate <= 0.0:
            return False, 60.0  # administratively closed: poll slowly
        return False, (count - allowed + 1.0) / rate

    def commit(self, now: float) -> None:
        """Record one admission (after every layer passed)."""
        self._own.observe(max(0.0, now - self.budget.t0))

    def admit(self, now: float) -> Tuple[bool, float]:
        """check + commit in one step (single-layer callers)."""
        ok, retry_after_s = self.check(now)
        if ok:
            self.commit(now)
        return ok, retry_after_s

    def state(self) -> Dict[str, Any]:
        """This shard's serialized contribution (gossip payload)."""
        return self._own.to_dict()

    def absorb(self, shard_id: str, state: Dict[str, Any],
               now: Optional[float] = None) -> None:
        """Keep ``shard_id``'s latest state by replacement; ``now``
        stamps the arrival for the staleness contract. Idempotent and
        reorder-safe by construction — a duplicated or late gossip
        delivery replaces with the same (or an older) state, never
        double-counts."""
        if shard_id == self.shard_id:
            return
        prev_state = self._peers.get(shard_id)
        # A peer's own-admission count is monotone, so it doubles as the
        # CRDT version: a reordered (late) delivery carrying an OLDER
        # state must not rewind the newer one already absorbed.
        if (prev_state is None
                or int(state.get("count", 0))
                >= int(prev_state.get("count", 0))):
            self._peers[shard_id] = state
        if now is not None:
            prev = self._peer_seen_at.get(shard_id)
            # The freshness stamp is monotone per peer too: a straggler
            # delivery cannot rewind the staleness the contract judges.
            if prev is None or now >= prev:
                self._peer_seen_at[shard_id] = now

    def forget(self, shard_id: str) -> None:
        self._peers.pop(shard_id, None)
        self._peer_seen_at.pop(shard_id, None)


class GossipBus:
    """In-process gossip board: each shard publishes its latest ledger
    states; collectors read every other shard's latest. Deterministic
    (sorted iteration, versioned payloads) so the sim twin's rounds are
    replayable; the live FrontDoor drives it from a daemon thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # shard_id -> (version, {deployment: state})
        self._board: Dict[str, Tuple[int, Dict[str, Dict[str, Any]]]] = {}
        self._version = 0

    def publish(self, shard_id: str,
                states: Dict[str, Dict[str, Any]]) -> int:
        with self._lock:
            self._version += 1
            self._board[shard_id] = (self._version, states)
            return self._version

    def collect(self, reader_shard_id: str
                ) -> List[Tuple[str, Dict[str, Dict[str, Any]]]]:
        with self._lock:
            return [
                (sid, states)
                for sid, (_, states) in sorted(self._board.items())
                if sid != reader_shard_id
            ]

    def drop(self, shard_id: str) -> None:
        with self._lock:
            self._board.pop(shard_id, None)


class FrontDoorShard:
    """One stateless front-door shard: global-budget ledgers + optional
    local per-(tenant, class) admission. Exposes the proxies' admission
    surface — ``HTTPProxy(admission=shard, shard_id=shard.shard_id)``
    wires a real HTTP door to it unchanged."""

    def __init__(
        self,
        shard_id: str,
        clock: Callable[[], float] = time.monotonic,
        local: Optional[Any] = None,
        n_shards: int = 1,
        staleness_bound_s: float = 0.0,
    ) -> None:
        self.shard_id = str(shard_id)
        self._clock = clock
        # Optional serve.admission.AdmissionController: per-tenant
        # fairness + overload governor, local to this shard, under the
        # global cap (checked first — the global budget is the outer
        # contract).
        self.local = local
        # Fail-closed staleness contract knobs (0 disables — legacy
        # fail-open); the FrontDoor sets them fleet-wide.
        self.n_shards = max(1, int(n_shards))
        self.staleness_bound_s = float(staleness_bound_s)
        # Audit sink for ledger_degraded transitions (the FrontDoor
        # shares its ring so degradations land next to drift audits).
        self.audit: Optional[AuditLog] = None
        self._lock = threading.Lock()
        self._ledgers: Dict[str, GlobalAdmissionLedger] = {}
        self._was_degraded: Dict[str, bool] = {}
        self.admitted = 0
        self.rejected = 0
        self.degraded_rejects = 0

    def configure(self, deployment: str,
                  budget: Optional[GlobalBudget]) -> None:
        with self._lock:
            if budget is None:
                self._ledgers.pop(deployment, None)
                self._was_degraded.pop(deployment, None)
            else:
                self._ledgers[deployment] = GlobalAdmissionLedger(
                    self.shard_id, budget,
                    n_shards=self.n_shards,
                    staleness_bound_s=self.staleness_bound_s,
                )

    def _note_degradation_edge(self, deployment: str,
                               ledger: GlobalAdmissionLedger,
                               now: float) -> None:
        """Audit + meter the degraded-mode EDGES (called with the shard
        lock held; transitions are rare, the steady state is one dict
        probe + compare)."""
        was = self._was_degraded.get(deployment, False)
        if ledger.degraded == was:
            return
        self._was_degraded[deployment] = ledger.degraded
        tags = {"deployment": deployment, "shard": self.shard_id}
        if ledger.degraded:
            ledger.degraded_entries += 1
            FRONTDOOR_LEDGER_DEGRADED.inc(tags=tags)
            FRONTDOOR_LEDGER_DEGRADED_GAUGE.set(1.0, tags=tags)
            if self.audit is not None:
                self.audit.record(
                    "ledger_degraded",
                    key=deployment,
                    observed={
                        "shard": self.shard_id,
                        "peer_staleness_s": round(
                            ledger.peer_staleness_s(now), 3),
                        "bound_s": ledger.staleness_bound_s,
                        "own_count": ledger.own_count,
                        "local_fraction_allowance": round(
                            ledger.budget.allowed(now) / ledger.n_shards,
                            3),
                    },
                    note="peer gossip staler than the bound: fail-closed "
                         "to the local-fraction budget until heal",
                )
        else:
            FRONTDOOR_LEDGER_DEGRADED_GAUGE.set(0.0, tags=tags)
            if self.audit is not None:
                self.audit.record(
                    "ledger_reconverged",
                    key=deployment,
                    observed={"shard": self.shard_id,
                              "merged_count": ledger.merged_count()},
                    note="gossip resumed inside the bound: merged fleet "
                         "view restored",
                )

    def admit(self, deployment: str, tenant: str = "",
              qos_class: str = "standard") -> Tuple[bool, float]:
        """(admitted, retry_after_s) — global ledger CHECK (read-only),
        then the shard-local controller (which debits its own bucket),
        then the global COMMIT, all under ONE shard lock: a reject at
        either layer burns no global token, and two concurrent requests
        can never both pass the check before either commits (the
        intra-shard TOCTOU would over-admit past the documented
        staleness bound). The local layer is a leaf lock with
        microsecond bucket math, so serializing a shard's admissions
        through it is the cheap, correct trade — shards scale OUT, not
        by intra-shard admission concurrency."""
        with self._lock:
            ledger = self._ledgers.get(deployment)
            if ledger is not None:
                now = self._clock()
                ok, retry_after_s = ledger.check(now)
                self._note_degradation_edge(deployment, ledger, now)
                if not ok:
                    self.rejected += 1
                    if ledger.degraded:
                        self.degraded_rejects += 1
                    outcome = "reject"
                else:
                    outcome = None
            else:
                outcome = None
            if outcome is None and self.local is not None:
                ok, retry_after_s = self.local.admit(deployment, tenant,
                                                     qos_class)
                if not ok:
                    self.rejected += 1
                    outcome = "reject"
            if outcome is None:
                if ledger is not None:
                    ledger.commit(self._clock())
                self.admitted += 1
                ok, retry_after_s = True, 0.0
                outcome = "admit"
        FRONTDOOR_ADMISSION.inc(tags={
            "deployment": deployment, "shard": self.shard_id,
            "outcome": outcome,
        })
        return ok, retry_after_s

    def gossip_states(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {dep: lg.state() for dep, lg in self._ledgers.items()}

    def absorb_states(self, shard_id: str,
                      states: Dict[str, Dict[str, Any]]) -> None:
        """Absorb one peer's ledger states, stamped at DELIVERY time —
        a fabric-delayed absorb arrives late and the staleness contract
        must judge what this shard actually knew, not what was sent."""
        with self._lock:
            now = self._clock()
            for dep, state in states.items():
                ledger = self._ledgers.get(dep)
                if ledger is not None:
                    ledger.absorb(shard_id, state, now=now)

    def ledger(self, deployment: str) -> Optional[GlobalAdmissionLedger]:
        with self._lock:
            return self._ledgers.get(deployment)

    def refresh_degradation(self) -> None:
        """Sweep every ledger's degraded flag from the staleness
        contract and account the edges. Driven by the gossip round, so
        an IDLE deployment still degrades when its peers go silent and
        — critically — re-converges (gauge back to 0, audited) on heal
        instead of standing as a false alarm until the next admission
        happens to arrive."""
        with self._lock:
            now = self._clock()
            for dep, ledger in self._ledgers.items():
                ledger.refresh(now)
                self._note_degradation_edge(dep, ledger, now)

    def ledger_snapshot(self) -> Dict[str, Any]:
        """Degradation view for stats(): transition count + which
        deployments are currently fail-closed."""
        with self._lock:
            return {
                "degraded_entries": sum(lg.degraded_entries
                                        for lg in self._ledgers.values()),
                "degraded_now": sorted(dep for dep, lg in
                                       self._ledgers.items()
                                       if lg.degraded),
            }


class FrontDoor:
    """The sharded front door: ring + shards + budgets + gossip + audit.

    ``clock`` injects the time source (sim: virtual seconds).
    ``local_admission_factory`` builds each shard's optional local
    AdmissionController (per-tenant fairness under the global cap)."""

    def __init__(
        self,
        n_shards: int = 2,
        clock: Callable[[], float] = time.monotonic,
        gossip_interval_s: float = 0.2,
        vnodes: int = 64,
        local_admission_factory: Optional[Callable[[], Any]] = None,
        fabric: Optional[ControlFabric] = None,
        staleness_bound_s: float = 0.0,
    ) -> None:
        if n_shards <= 0:
            raise ValueError(f"n_shards must be positive, got {n_shards}")
        self._clock = clock
        self.gossip_interval_s = float(gossip_interval_s)
        # The shard↔shard absorb edge routes through the fabric so a
        # partition/chaos policy applies to gossip; unconfigured it is
        # the zero-overhead passthrough.
        self.fabric = fabric if fabric is not None else default_fabric()
        # Fail-closed staleness bound per ledger (0 = disabled). A sane
        # arming is a few gossip intervals: missing one round is jitter,
        # missing several is a partition.
        self.staleness_bound_s = float(staleness_bound_s)
        self.bus = GossipBus()
        self.shards: Dict[str, FrontDoorShard] = {}
        ids = [f"fd-{i}" for i in range(n_shards)]
        for sid in ids:
            self.shards[sid] = FrontDoorShard(
                sid, clock=clock,
                local=(local_admission_factory()
                       if local_admission_factory is not None else None),
                n_shards=n_shards,
                staleness_bound_s=self.staleness_bound_s,
            )
        self.ring = HashRing(ids, vnodes=vnodes)
        self._budgets: Dict[str, GlobalBudget] = {}
        # deployment -> admissions by shards REMOVED from the ring:
        # their history must keep counting in the oracle (admissions
        # that happened, happened) or drift_audit under-reports.
        self._departed_admitted: Dict[str, int] = {}
        # Drift audits land next to heals/replans/governor flips — the
        # front door is a control plane and owes the same paper trail.
        # Shards share the ring so ledger_degraded transitions file into
        # the same timeline as the drift they bound.
        self.audit = AuditLog("frontdoor", now=clock)
        for shard in self.shards.values():
            shard.audit = self.audit
        self.gossip_rounds = 0
        self._last_gossip_at = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- configuration ----------------------------------------------------
    def configure(self, deployment: str, rate_rps: float,
                  burst: float = 0.0) -> None:
        """Install (rate <= 0 removes) a deployment's global budget on
        every shard, anchored at one shared t0."""
        if rate_rps <= 0:
            self._budgets.pop(deployment, None)
            for shard in self.shards.values():
                shard.configure(deployment, None)
            return
        budget = GlobalBudget(
            rate_rps=float(rate_rps),
            burst=float(burst) if burst > 0 else float(rate_rps),
            t0=self._clock(),
        )
        self._budgets[deployment] = budget
        for shard in self.shards.values():
            shard.configure(deployment, budget)

    def budget(self, deployment: str) -> Optional[GlobalBudget]:
        return self._budgets.get(deployment)

    # --- routing + admission ----------------------------------------------
    def shard_for(self, key: str) -> FrontDoorShard:
        return self.shards[self.ring.shard_for(key)]

    def admit(self, deployment: str, payload: Any = None,
              tenant: str = "", qos_class: str = "standard",
              request_id: Optional[str] = None
              ) -> Tuple[str, bool, float]:
        """Route by affinity key, then admit on the owning shard:
        ``(shard_id, admitted, retry_after_s)``."""
        shard = self.shard_for(affinity_key(payload, tenant, request_id))
        ok, retry_after_s = shard.admit(deployment, tenant, qos_class)
        return shard.shard_id, ok, retry_after_s

    # --- gossip -----------------------------------------------------------
    def gossip_round(self) -> None:
        """One full exchange: every shard publishes, every shard absorbs
        every peer's latest. Deterministic (sorted shard order) — the
        sim twin calls this on virtual-time ticks; live mode calls it
        from the gossip thread.

        The PARTITIONABLE edge is peer→shard absorption, routed through
        the fabric with the peer as ``src`` and the reader as ``dst``:
        a node-group partition drops exactly the cross-side exchanges
        while same-side gossip keeps flowing — the asymmetry the
        fail-closed staleness contract is tested against. The board
        publish/collect itself is a process-local snapshot (each shard
        logically owns its slice), so those stay direct."""
        for sid in sorted(self.shards):
            self.bus.publish(sid, self.shards[sid].gossip_states())  # rdb-lint: disable=fabric-discipline (publish lands on the shard's own board slice — the network edge is the peer→shard absorb below)
        for sid in sorted(self.shards):
            shard = self.shards[sid]
            for peer_id, states in self.bus.collect(sid):  # rdb-lint: disable=fabric-discipline (collect reads the local board snapshot; delivery to the reader is the fabric-routed absorb)
                self.fabric.cast(
                    "frontdoor.gossip", shard.absorb_states, peer_id,
                    states, src=peer_id, dst=sid,
                )
            # Degradation edges move with GOSSIP progress, not only
            # admission traffic: an idle deployment's gauge must clear
            # on heal and set on silence all the same.
            shard.refresh_degradation()
            FRONTDOOR_GOSSIP.inc(tags={"shard": sid})
        self.gossip_rounds += 1
        self._last_gossip_at = self._clock()

    def staleness_s(self) -> float:
        return max(0.0, self._clock() - self._last_gossip_at)

    # --- membership -------------------------------------------------------
    def remove_shard(self, shard_id: str) -> None:
        """Take a shard out of the ring (crash or drain): its keys move
        to the survivors (~1/N of the space), its ledger contributions
        REMAIN in peers' views (admissions that happened, happened), and
        it stops receiving traffic."""
        if shard_id not in self.shards:
            return
        self.ring.remove(shard_id)
        departed = self.shards.pop(shard_id)
        # Nobody will ever refresh the departed shard's gauge series
        # again: clear it now or a shard removed mid-degradation stands
        # as a false alarm forever.
        for dep in self._budgets:
            FRONTDOOR_LEDGER_DEGRADED_GAUGE.set(
                0.0, tags={"deployment": dep, "shard": shard_id})
        # Final flush: peers must account the departed shard's full
        # history or the fleet view under-counts forever.
        self.bus.publish(shard_id, departed.gossip_states())  # rdb-lint: disable=fabric-discipline (membership admin runs where the board lives; a shard leaves the ring exactly once, not over a partitionable edge)
        # And the ORACLE must too: true_admitted sums live shards' own
        # counts, so the departed shard's history moves to a baseline.
        for dep in self._budgets:
            ledger = departed.ledger(dep)
            if ledger is not None:
                self._departed_admitted[dep] = (
                    self._departed_admitted.get(dep, 0) + ledger.own_count
                )
        for sid in sorted(self.shards):
            for peer_id, states in self.bus.collect(sid):  # rdb-lint: disable=fabric-discipline (same admin pass: survivors adopt the departed history synchronously so the oracle never under-counts)
                self.shards[sid].absorb_states(peer_id, states)  # rdb-lint: disable=fabric-discipline (membership flush must be atomic with the ring change — deferring it through chaos would double- or zero-count the departed shard)
            # The departed shard's history is final: exempt it from the
            # staleness contract and shrink the live fleet width, or the
            # survivors would degrade fail-closed forever on a peer that
            # can never gossip again.
            for dep in self._budgets:
                ledger = self.shards[sid].ledger(dep)
                if ledger is not None:
                    ledger.retire_peer(shard_id)
            # Ledgers configured AFTER this removal must be born at the
            # surviving fleet width too — a new deployment sized for the
            # old N would wait forever on a peer that no longer exists
            # and degrade fail-closed permanently.
            self.shards[sid].n_shards = len(self.shards)
        self.audit.record(
            "shard_removed",
            observed={"shard": shard_id,
                      "remaining": sorted(self.shards)},
            note="ring re-dealt ~1/N of the key space to survivors",
        )

    # --- drift audit ------------------------------------------------------
    def true_admitted(self, deployment: str) -> int:
        """The oracle count: every shard's OWN admissions plus departed
        shards' history, read directly (no gossip lag) — what a central
        bucket would have counted."""
        total = self._departed_admitted.get(deployment, 0)
        for shard in self.shards.values():
            ledger = shard.ledger(deployment)
            if ledger is not None:
                total += ledger.own_count
        return total

    def drift_bound(self, deployment: str) -> float:
        """The analytic staleness bound: (N-1) * rate * staleness plus
        one request per shard of rounding."""
        budget = self._budgets.get(deployment)
        if budget is None:
            return 0.0
        n = len(self.shards)
        return ((n - 1) * budget.rate_rps
                * max(self.staleness_s(), self.gossip_interval_s)
                + n)

    def drift_audit(self, deployment: str) -> Dict[str, float]:
        """Over/under-admission versus the central oracle, recorded in
        the audit ring and the drift gauge. ``over_admitted`` > 0 is the
        price of distribution and must stay within ``bound``; the soak
        gate pins exactly that."""
        budget = self._budgets.get(deployment)
        if budget is None:
            return {}
        now = self._clock()
        admitted = self.true_admitted(deployment)
        allowed = budget.allowed(now)
        drift = admitted - allowed
        out = {
            "admitted": float(admitted),
            "allowed": round(allowed, 3),
            "over_admitted": round(max(0.0, drift), 3),
            "bound": round(self.drift_bound(deployment), 3),
            "staleness_s": round(self.staleness_s(), 6),
            "shards": float(len(self.shards)),
        }
        FRONTDOOR_DRIFT.set(drift, tags={"deployment": deployment})
        self.audit.record(
            "admission_drift",
            key=deployment,
            observed=out,
            note="fleet admissions vs central-oracle allowance "
                 "(bounded by (N-1)*rate*staleness)",
        )
        return out

    # --- live gossip thread -----------------------------------------------
    def start(self) -> "FrontDoor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._gossip_loop, name="frontdoor-gossip", daemon=True
        )
        self._thread.start()
        return self

    def _gossip_loop(self) -> None:
        while not self._stop.wait(self.gossip_interval_s):
            try:
                self.gossip_round()
            except Exception:  # noqa: BLE001 — gossip must not die quietly
                logger.exception("gossip round failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        return {
            "shards": {
                sid: {"admitted": s.admitted, "rejected": s.rejected,
                      "degraded_rejects": s.degraded_rejects,
                      **s.ledger_snapshot()}
                for sid, s in sorted(self.shards.items())
            },
            "gossip_rounds": self.gossip_rounds,
            "staleness_s": round(self.staleness_s(), 6),
        }
