"""Control fabric — the injectable message seam under the control plane.

Own copy of ``ray_dynamic_batching_tpu/serve/fabric.py``, whole, with its
import paths rewritten; the ``RDB_TESTING_FABRIC`` and
``RDB_TESTING_PARTITION`` variable names are the reference's, so one
environment arms both packages.

Every control-plane exchange in the shipped tree used to be a direct
in-process call over a perfect network: ``ReplicatedStore`` appends to
``StoreLog``, ``LeaderLease`` renews, ``FrontDoor`` shards absorb each
other's gossip, the controller pushes long-poll digests — and nothing
could be dropped, delayed, duplicated, reordered, or partitioned. The
single biggest untested correlated failure was a network partition of
the control plane itself (ROADMAP item 4's "rates far above live
capacity" demands it; the reference's GCS/raft lineage is DEFINED by how
it behaves under exactly this).

This module is the seam. All cross-component control traffic routes
through a :class:`ControlFabric`:

- :meth:`ControlFabric.call` — request/response edges (log appends and
  reads, lease acquire/renew). A partitioned or chaos-dropped call
  raises :class:`FabricUnreachable`; the caller owns the degraded mode
  (the store self-demotes, the controller skips the step and retries).
- :meth:`ControlFabric.cast` — one-way messages (gossip state exchange,
  long-poll pushes). Drops are silent (counted), delays defer delivery
  through an injectable scheduler (the sim twin passes the virtual
  event loop, so delays are EVENTS and replay byte-identically; live
  mode uses daemon timers), duplicates deliver twice — the consumers
  are delta-state CRDTs / snapshot-id channels precisely so re-delivery
  and reordering are harmless, and the chaos policy is what proves it.

The default fabric is a zero-overhead passthrough: unconfigured, every
message is one attribute check plus the direct call — live canon is
unchanged. Chaos arms it, the same way the slowdown spec arms gray
failures:

    RDB_TESTING_PARTITION="ctl-A|log@t=10:heal=8"
    RDB_TESTING_PARTITION="ctl-A+fd-0+fd-1|ctl-B+log+lease+fd-2+fd-3@t=5"
    RDB_TESTING_FABRIC="frontdoor.gossip=-1:drop:p0.5,controller.push=3:delay5-20"

A partition splits NODES (or node groups registered via :meth:`assign`)
into two sides from ``t`` seconds after the fabric's epoch, healing
after ``heal`` seconds (omitted = never). Messages whose ``src`` and
``dst`` land on opposite sides are unreachable; same-side and unnamed
endpoints are untouched — which is what makes the ASYMMETRIC cases
expressible (a leader that can renew its lease but not reach the log:
partition ``ctl-A|log``, leave ``lease`` unnamed or on ctl-A's side).

Edge chaos grammar (per edge, seeded like utils/chaos.py so a schedule
replays byte-identically): ``edge=BUDGET:MODE[:pP]`` with modes ``drop``,
``delay<MS>[-<MS>]`` (uniform draw in the range), ``dup``; BUDGET -1 is
unlimited; ``:pP`` makes each opportunity fire with probability P.

Observability: ``rdb_fabric_messages_total{edge,outcome}`` counts every
message through an ACTIVE fabric (delivered | dropped | delayed |
duplicated; both tags bounded) and ``rdb_fabric_partition_active`` holds
1 while any configured partition window is open.
"""

from __future__ import annotations

import os
import random
import threading
import time  # live-mode default clock only; the sim twin injects VirtualClock
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock, assert_owner
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m

logger = get_logger("fabric")

PARTITION_ENV_VAR = "RDB_TESTING_PARTITION"
FABRIC_ENV_VAR = "RDB_TESTING_FABRIC"

# Edge names are code-controlled (the canonical set below), but bounded
# anyway so a typo'd or runaway edge label cannot mint unbounded series.
FABRIC_MESSAGES = m.Counter(
    "rdb_fabric_messages_total",
    "Control-fabric messages by edge and outcome "
    "(delivered | dropped | delayed | duplicated)",
    tag_keys=("edge", "outcome"),
    bounded_tags={"edge": 12},
)
FABRIC_PARTITION = m.Gauge(
    "rdb_fabric_partition_active",
    "1 while a configured fabric partition window is open, else 0",
)

# Canonical edge names (the fabric treats them as opaque; listed here so
# specs, dashboards, and the fabric-discipline lint rule agree):
#   store.append      ReplicatedStore -> StoreLog commit
#   store.read        ReplicatedStore -> StoreLog replay
#   store.fence       ReplicatedStore -> StoreLog fence raise
#   store.snapshot    ReplicatedStore -> StoreLog snapshot install/fetch
#   lease.acquire     ReplicatedStore -> LeaderLease takeover
#   lease.renew       ReplicatedStore -> LeaderLease heartbeat
#   frontdoor.gossip  shard -> shard ledger-state absorb
#   controller.push   controller -> router long-poll notify
#   controller.digest_push  controller -> router digest directory
#   long_poll.listen  router/handle -> controller long-poll listen
#   courier.migrate   KVPageFabric -> replica live-stream parcel delivery
#   courier.push      KVPageFabric -> replica prefix-push parcel delivery


class FabricUnreachable(RuntimeError):
    """A request/response control message could not be delivered: the
    edge crossed an active partition or drew a chaos drop. The caller —
    not the fabric — owns the degraded mode: a leader whose appends are
    unreachable self-demotes; a controller whose lease is unreachable
    skips the step and retries; a long-poll listen re-arms."""

    def __init__(self, message: str, edge: str = "", src: str = "",
                 dst: str = "") -> None:
        super().__init__(message)
        self.edge = edge
        self.src = src
        self.dst = dst


@dataclass(frozen=True)
class Partition:
    """One partition window: sides ``a``/``b`` (node or group names),
    open from ``at_s`` after the fabric epoch, healing after ``heal_s``
    more seconds (``heal_s <= 0`` = never heals)."""

    a: frozenset
    b: frozenset
    at_s: float
    heal_s: float = 0.0

    def open_at(self, t_s: float) -> bool:
        if t_s < self.at_s:
            return False
        return self.heal_s <= 0 or t_s < self.at_s + self.heal_s


def parse_partition_spec(spec: str) -> List[Partition]:
    """Parse ``sideA|sideB@t=N[:heal=M][;...]`` — nodes within a side
    joined by ``+``. Parses fully before returning, so an invalid spec
    configures nothing (the all-or-nothing discipline of
    utils/chaos.py)."""
    out: List[Partition] = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        if "@" not in part or "|" not in part:
            raise ValueError(
                f"bad partition spec entry {part!r} "
                "(want sideA|sideB@t=N[:heal=M])"
            )
        sides, when = part.split("@", 1)
        a_raw, b_raw = sides.split("|", 1)
        a = frozenset(filter(None, (n.strip() for n in a_raw.split("+"))))
        b = frozenset(filter(None, (n.strip() for n in b_raw.split("+"))))
        if not a or not b:
            raise ValueError(f"partition entry {part!r} has an empty side")
        if a & b:
            raise ValueError(
                f"partition entry {part!r} puts {sorted(a & b)} on both sides"
            )
        at_s = heal_s = None
        for token in filter(None, (t.strip() for t in when.split(":"))):
            if token.startswith("t="):
                at_s = float(token[2:])
            elif token.startswith("heal="):
                heal_s = float(token[5:])
            else:
                raise ValueError(
                    f"bad partition window token {token!r} in {part!r} "
                    "(want t=N[:heal=M])"
                )
        if at_s is None:
            raise ValueError(f"partition entry {part!r} has no t=N window")
        out.append(Partition(a=a, b=b, at_s=at_s, heal_s=heal_s or 0.0))
    return out


@dataclass(frozen=True)
class EdgeChaos:
    """One edge's chaos verdict kind: HOW messages on it misbehave."""

    mode: str                          # "drop" | "delay" | "dup"
    delay_ms: Tuple[float, float] = (0.0, 0.0)


def _parse_edge_mode(token: str) -> EdgeChaos:
    if token == "drop":
        return EdgeChaos("drop")
    if token == "dup":
        return EdgeChaos("dup")
    if token.startswith("delay"):
        rng = token[5:]
        if "-" in rng:
            lo, hi = rng.split("-", 1)
        else:
            lo = hi = rng
        lo_f, hi_f = float(lo), float(hi)
        if lo_f < 0 or hi_f < lo_f:
            raise ValueError(f"bad delay range {rng!r} (want MS or MS-MS)")
        return EdgeChaos("delay", delay_ms=(lo_f, hi_f))
    raise ValueError(
        f"bad fabric mode {token!r} (want drop|delay<MS>[-<MS>]|dup)"
    )


def parse_fabric_spec(spec: str) -> Dict[str, Tuple[int, float, EdgeChaos]]:
    """Parse ``edge=BUDGET:MODE[:pP],...`` into
    ``{edge: (budget, prob, EdgeChaos)}`` — the utils/chaos.py grammar
    with fabric modes."""
    table: Dict[str, Tuple[int, float, EdgeChaos]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"bad fabric spec entry {part!r}")
        edge, rhs = part.split("=", 1)
        tokens = rhs.split(":")
        if len(tokens) < 2:
            raise ValueError(
                f"fabric entry {part!r} needs a mode "
                "(edge=N:drop|delay<MS>[-<MS>]|dup[:pP])"
            )
        prob = 1.0
        if len(tokens) > 2:
            if not tokens[2].startswith("p"):
                raise ValueError(
                    f"bad fabric suffix {tokens[2]!r} (want p<float>)"
                )
            prob = float(tokens[2][1:])
        table[edge.strip()] = (int(tokens[0]), prob,
                               _parse_edge_mode(tokens[1]))
    return table


class ControlFabric:
    """The message seam. One instance per control plane; components hold
    a reference and route every cross-component message through it.

    ``clock`` is THE control-plane clock (shared with ``StoreLog`` and
    ``LeaderLease`` — the PR's clock-unification contract); partition
    windows are measured from the clock value at construction/configure.
    ``scheduler(delay_ms, fn)`` defers delayed cast deliveries — the sim
    twin passes ``EventLoop.schedule_in`` so delays are virtual-time
    events; live mode defaults to daemon timers. A fabric with no
    partitions and no edge chaos is a passthrough: one attribute read
    per message, no accounting, no behavior change."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        scheduler: Optional[Callable[[float, Callable[[], None]], None]] = None,
        seed: Optional[int] = None,
        partition_spec: Optional[str] = None,
        edge_spec: Optional[str] = None,
    ) -> None:
        self._clock = clock
        self._scheduler = scheduler
        self._lock = OrderedLock("fabric")
        self._groups: Dict[str, str] = {}
        self._seed = seed if seed is not None else self._config_seed()
        self._rng = random.Random(self._seed)
        self._partitions: List[Partition] = []
        self._edges: Dict[str, Tuple[int, float, EdgeChaos]] = {}
        self._stats: Dict[Tuple[str, str], int] = {}
        self._t0 = clock()
        self._active = False
        self._partition_gauge = 0
        self.configure(
            partition_spec if partition_spec is not None
            else os.environ.get(PARTITION_ENV_VAR, ""),
            edge_spec if edge_spec is not None
            else os.environ.get(FABRIC_ENV_VAR, ""),
        )

    @staticmethod
    def _config_seed() -> int:
        from ray_dynamic_batching_tpu_torch.utils.config import get_config

        return get_config().chaos_seed

    # --- configuration ----------------------------------------------------
    def configure(self, partition_spec: str = "", edge_spec: str = "",
                  seed: Optional[int] = None) -> None:
        """(Re)arm the chaos policy; parses fully before swapping state
        and reseeds the draw RNG, so same spec + same seed replays the
        same schedule. Re-anchors the partition epoch at the current
        clock value."""
        partitions = parse_partition_spec(partition_spec)
        edges = parse_fabric_spec(edge_spec)
        with self._lock:
            self._partitions = partitions
            self._edges = edges
            self._stats = {}
            if seed is not None:
                self._seed = seed
            self._rng = random.Random(self._seed)
            self._t0 = self._clock()
            self._active = bool(partitions or edges)
            self._partition_gauge = 0
        # Reflect the (re)configured state immediately: disarming must
        # clear the exported gauge — a passthrough fabric never touches
        # it again, so a stale 1.0 would stand as a false alarm forever.
        FABRIC_PARTITION.set(0.0)

    def assign(self, node: str, group: str) -> None:
        """Map a node name onto a partition group (so a spec can say
        ``routers`` instead of enumerating every shard)."""
        with self._lock:
            self._groups[node] = group

    @property
    def active(self) -> bool:
        return self._active  # rdb-lint: disable=lock-discipline (arming flag flipped in quiesced configure(); one-op staleness on the passthrough fast path is benign and locking would serialize every edge)

    # --- partition evaluation ---------------------------------------------
    def _side(self, name: str) -> str:
        assert_owner(self._lock)  # callers hold it (_crosses)
        return self._groups.get(name, name)

    def _refresh_gauge_locked(self, open_now: bool) -> None:
        """Edge-triggered gauge refresh; caller holds ``_lock`` so two
        concurrent evaluations cannot interleave the compare and the
        write (a lost update would freeze the exported gauge wrong)."""
        assert_owner(self._lock)
        val = 1 if open_now else 0
        if val != self._partition_gauge:
            self._partition_gauge = val
            FABRIC_PARTITION.set(float(val))

    def partition_active(self, now: Optional[float] = None) -> bool:
        """True while ANY configured partition window is open (whether or
        not a given edge crosses it); refreshes the gauge on edges."""
        with self._lock:
            if not self._partitions:
                return False
            t = (self._clock() if now is None else now) - self._t0
            open_now = any(p.open_at(t) for p in self._partitions)
            self._refresh_gauge_locked(open_now)
            return open_now

    def _crosses(self, src: str, dst: str) -> bool:
        with self._lock:
            if not self._partitions or not src or not dst:
                # Unnamed endpoints cannot be placed on a side: untouched
                # — but still refresh the gauge on this edge visit.
                if self._partitions:
                    t = self._clock() - self._t0
                    self._refresh_gauge_locked(
                        any(p.open_at(t) for p in self._partitions))
                return False
            t = self._clock() - self._t0
            sa, sb = self._side(src), self._side(dst)
            crossing = False
            open_now = False
            for p in self._partitions:
                if not p.open_at(t):
                    continue
                open_now = True
                if (sa in p.a and sb in p.b) or (sa in p.b and sb in p.a):
                    crossing = True
            self._refresh_gauge_locked(open_now)
            return crossing

    def _edge_verdict(self, edge: str) -> Optional[EdgeChaos]:
        """Consume one unit of the edge's chaos budget, or None."""
        with self._lock:
            entry = self._edges.get(edge)
            if entry is None:
                return None
            budget, prob, verdict = entry
            if budget == 0:
                return None
            if prob < 1.0 and self._rng.random() >= prob:
                return None
            if budget > 0:
                self._edges[edge] = (budget - 1, prob, verdict)
            return verdict

    def _draw_delay_ms(self, verdict: EdgeChaos) -> float:
        lo, hi = verdict.delay_ms
        if hi <= lo:
            return lo
        with self._lock:
            return self._rng.uniform(lo, hi)

    def _count(self, edge: str, outcome: str) -> None:
        with self._lock:
            key = (edge, outcome)
            self._stats[key] = self._stats.get(key, 0) + 1
        FABRIC_MESSAGES.inc(tags={"edge": edge, "outcome": outcome})

    # --- the seam ----------------------------------------------------------
    def call(self, edge: str, fn: Callable[..., Any], *args: Any,
             src: str = "", dst: str = "", **kwargs: Any) -> Any:
        """Request/response edge: deliver ``fn(*args, **kwargs)`` and
        return its result, or raise :class:`FabricUnreachable` when the
        edge is partitioned / drew a drop. A delay verdict on a call
        edge is counted (``delayed``) and delivered — synchronous
        transports model latency at the caller, not here; drops and
        partitions are the failure modes that matter for appends and
        renews."""
        if not self._active:  # rdb-lint: disable=lock-discipline (passthrough fast path: arming flips in quiesced configure(); a one-call-stale read only delays chaos onset by one edge)
            return fn(*args, **kwargs)
        if self._crosses(src, dst):
            self._count(edge, "dropped")
            raise FabricUnreachable(
                f"{edge}: {src or '?'} cannot reach {dst or '?'} across an "
                "active partition", edge=edge, src=src, dst=dst,
            )
        verdict = self._edge_verdict(edge)
        if verdict is not None and verdict.mode == "drop":
            self._count(edge, "dropped")
            raise FabricUnreachable(
                f"{edge}: message dropped by chaos policy",
                edge=edge, src=src, dst=dst,
            )
        if verdict is not None and verdict.mode == "delay":
            self._count(edge, "delayed")
        else:
            self._count(edge, "delivered")
        return fn(*args, **kwargs)

    def cast(self, edge: str, deliver: Callable[..., Any], *args: Any,
             src: str = "", dst: str = "") -> bool:
        """One-way edge: deliver (possibly late, possibly twice) or drop
        silently. Returns False when the message was dropped, True when
        it was (or will be) delivered — callers treat False as "the
        network ate it", never an error. Delayed deliveries go through
        the scheduler; with none configured (live default) a daemon
        timer fires them, so a delayed gossip absorb can land out of
        order with a later round — exactly the reordering the
        delta-state CRDT consumers must (and do) tolerate."""
        if not self._active:  # rdb-lint: disable=lock-discipline (passthrough fast path: arming flips in quiesced configure(); a one-call-stale read only delays chaos onset by one edge)
            deliver(*args)
            return True
        if self._crosses(src, dst):
            self._count(edge, "dropped")
            return False
        verdict = self._edge_verdict(edge)
        if verdict is None:
            self._count(edge, "delivered")
            deliver(*args)
            return True
        if verdict.mode == "drop":
            self._count(edge, "dropped")
            return False
        if verdict.mode == "dup":
            self._count(edge, "duplicated")
            self._count(edge, "delivered")
            deliver(*args)
            deliver(*args)
            return True
        # delay
        self._count(edge, "delayed")
        delay_ms = self._draw_delay_ms(verdict)
        self._schedule(delay_ms, lambda: deliver(*args))
        return True

    def _schedule(self, delay_ms: float, fn: Callable[[], None]) -> None:
        if self._scheduler is not None:
            self._scheduler(delay_ms, fn)
            return
        t = threading.Timer(delay_ms / 1000.0, fn)
        t.daemon = True
        t.start()

    # --- observability -----------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Deterministic per-edge outcome counts (``edge.outcome: n``) —
        the partition sim's report reads this; empty for a passthrough."""
        with self._lock:
            return {f"{edge}.{outcome}": n
                    for (edge, outcome), n in sorted(self._stats.items())}


_DEFAULT: Optional[ControlFabric] = None
_DEFAULT_LOCK = threading.Lock()


def default_fabric() -> ControlFabric:
    """Process-global fabric, configured from the environment on first
    use (mirrors utils/chaos.py). Unconfigured, it is the zero-overhead
    passthrough every component defaults to."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = ControlFabric()
    return _DEFAULT


def reset_fabric(partition_spec: str = "", edge_spec: str = "",
                 seed: Optional[int] = None) -> ControlFabric:
    """Re-configure (and optionally reseed) the global fabric — test and
    soak harnesses arm/disarm partitions through this, exactly like
    ``utils.chaos.reset_chaos``."""
    fab = default_fabric()
    fab.configure(partition_spec, edge_spec, seed=seed)
    return fab
