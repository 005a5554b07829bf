"""Replicated controller store — the control plane's GCS move.

Own copy of ``ray_dynamic_batching_tpu/serve/store.py``, whole, with its
import paths rewritten.

Re-creates the role Ray's GCS plays for Serve's controller
(``gcs_server`` owning actor/placement/KV state, Serve checkpointing
through it so a controller restart is a recovery, not an outage): every
piece of ``ServeController`` mutable state lives behind a small
versioned key-value store written through TRANSACTIONS, with two
implementations:

- :class:`InMemoryStore` — single-process, the default; transactions
  are atomic batches against a dict (the reference's
  ``in_memory_store_client``).
- :class:`ReplicatedStore` — the same surface over a shared append-only
  :class:`StoreLog` plus a :class:`LeaderLease`. Every transaction
  commits as one log record stamped with the writer's **epoch**; a
  standby replays the log to reconstruct the leader's exact state and
  takes over by acquiring the lease, which BUMPS the epoch and fences
  the log — the old leader's next commit raises
  :class:`StaleEpochError` instead of corrupting state it no longer
  owns (the classic GCS/raft fencing rule: a deposed leader must fail
  loudly, never write quietly).

Why epoch fencing and not just a lock: the failure mode is a leader
that is *slow*, not dead — it wakes up after the standby took over and
tries to finish a half-done reconcile. A lock it still believes it
holds cannot stop it; a monotone epoch checked at the single append
point can, atomically, for every key at once.

The transaction API is deliberately tiny (``get``/``put``/``delete``
staged, committed atomically on context exit, no-op writes elided so a
steady-state control loop appends nothing) because the lint rule
``store-discipline`` (tools/lint/store.py) holds the controller to it:
any bare attribute write to controller-owned state outside a
``with store.txn() as t:`` block is a finding. The discipline is what
keeps "replicated store" from rotting back into "a dict plus hope".

Partition defense:

- **One clock.** ``StoreLog`` record stamps, ``LeaderLease`` expiry, and
  the control fabric all read ONE injected clock (live default:
  ``time.monotonic``; sim: the virtual clock). The lease judges expiry
  on ITS OWN clock — the grantor's — so a renewer with a skewed clock
  can never extend real leadership beyond ``duration_s`` of grantor
  time.
- **The fabric seam.** Every cross-component exchange — append, read,
  fence, snapshot, lease acquire/renew — routes through a
  :class:`~ray_dynamic_batching_tpu_torch.serve.fabric.ControlFabric`
  (``fabric-discipline`` lint rule), so a partition or chaos policy
  applies to the store exactly like to gossip.
- **Split-brain self-demotion.** Lease and log are ONE failure domain:
  a leader whose appends fail REACHABILITY (not just epoch) for a
  bounded window self-demotes (``store_unreachable`` audit) and stops
  renewing, instead of serving stale state until the fence finally
  catches it. On heal, the same owner may re-acquire (same epoch, no
  fence) if nobody took over meanwhile.
- **Snapshots + log compaction.** The leader takes an epoch-consistent
  :class:`StoreSnapshot` at the commit point every ``snapshot_every``
  records and truncates the log behind it; standby recovery is
  snapshot + tail replay, so failover time is O(tail), not O(uptime).
  ``read_from`` of a compacted index raises :class:`CompactedLogError`
  loudly — never a silent gap.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.serve.fabric import (
    ControlFabric,
    FabricUnreachable,
    default_fabric,
)
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("store")


class StaleEpochError(RuntimeError):
    """A write carried an epoch older than the log's fence: the writer
    was deposed (its lease expired and a standby acquired leadership).
    The only correct reaction is to stop acting as leader — retrying
    would re-submit a decision the new leader may have already
    contradicted."""

    def __init__(self, message: str, epoch: int, fence: int) -> None:
        super().__init__(message)
        self.epoch = epoch
        self.fence = fence


class CompactedLogError(RuntimeError):
    """A read asked for records the log already truncated behind a
    snapshot. Failing LOUDLY here is the contract: silently returning
    the surviving suffix would hand a standby a state with an invisible
    gap — the most dangerous kind of divergence. The reader must
    restore the latest snapshot, then re-read from its index."""

    def __init__(self, message: str, index: int, first_index: int,
                 snapshot_index: int) -> None:
        super().__init__(message)
        self.index = index
        self.first_index = first_index
        self.snapshot_index = snapshot_index


@dataclass
class LogRecord:
    """One committed transaction: the unit of replication."""

    index: int                  # position in the log, 0-based, dense
    epoch: int                  # writer's leadership epoch
    ops: List[Tuple[str, str, Optional[str]]]  # ("put", k, v) | ("delete", k, None)
    wall_time: float = 0.0      # control-plane clock stamp (shared clock)

    def to_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "epoch": self.epoch,
                "ops": [list(op) for op in self.ops],
                "wall_time": self.wall_time}


@dataclass(frozen=True)
class StoreSnapshot:
    """An epoch-consistent image of the store at a commit point.

    ``index`` is the NEXT log index after the last transaction the
    snapshot includes (== the taker's applied_index at the commit
    point); replaying the log from ``index`` on top of ``data`` is
    exactly equivalent to replaying the whole log — even when the tail
    carries a LATER epoch's records (a takeover between snapshot and
    restore): restore sets the reader's cursor to ``index``, so the
    newer-epoch tail replays exactly once, never double-applies."""

    index: int
    epoch: int
    version: int                 # committed-txn watermark at the point
    data: Dict[str, str]


class StoreLog:
    """Shared append-only replication substrate with an epoch fence.

    The log is the ONE serialization point between a live leader and a
    recovering standby: ``append`` atomically checks the writer's epoch
    against the fence and either commits or raises
    :class:`StaleEpochError`. ``fence_to`` only ever raises the fence
    (monotone), so a deposed leader can never re-open its own window.

    Compaction: :meth:`install_snapshot` records the latest snapshot and
    truncates every record below its index — and ONLY below it, so a
    suffix the snapshot does not cover can never be orphaned. ``clock``
    is the shared control-plane clock (the same instance the lease and
    the fabric read)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._records: List[LogRecord] = []
        self._first_index = 0          # index of _records[0] (post-compaction)
        self._snapshot: Optional[StoreSnapshot] = None
        self._fence_epoch = 0
        self._lock = OrderedLock("store_log")
        self._clock = clock
        self.rejected_appends = 0
        self.appended_total = 0        # survives compaction (uptime proxy)

    @property
    def fence_epoch(self) -> int:
        with self._lock:
            return self._fence_epoch

    @property
    def first_index(self) -> int:
        with self._lock:
            return self._first_index

    def __len__(self) -> int:
        """Records currently RETAINED (the replayable tail)."""
        with self._lock:
            return len(self._records)

    def next_index(self) -> int:
        with self._lock:
            return self._first_index + len(self._records)

    def fence_to(self, epoch: int) -> None:
        """Raise the fence (monotone): appends below ``epoch`` now fail."""
        with self._lock:
            self._fence_epoch = max(self._fence_epoch, int(epoch))

    def append(self, epoch: int,
               ops: List[Tuple[str, str, Optional[str]]]) -> int:
        """Commit one transaction's ops at ``epoch``; returns the new
        record's index. Stale epochs are REJECTED atomically under the
        same lock that orders commits — there is no window where a
        deposed leader's record lands between the fence check and the
        append."""
        with self._lock:
            if epoch < self._fence_epoch:
                self.rejected_appends += 1
                raise StaleEpochError(
                    f"append at epoch {epoch} rejected: log fenced at "
                    f"epoch {self._fence_epoch} (a standby took over; "
                    "this writer was deposed)",
                    epoch=epoch, fence=self._fence_epoch,
                )
            rec = LogRecord(
                index=self._first_index + len(self._records), epoch=epoch,
                ops=list(ops), wall_time=self._clock(),
            )
            self._records.append(rec)
            self.appended_total += 1
            return rec.index

    def read_from(self, index: int) -> List[LogRecord]:
        """Records at ``index`` and after. Asking below the compaction
        horizon raises :class:`CompactedLogError` — restore the latest
        snapshot and re-read from its index instead."""
        with self._lock:
            if index < self._first_index:
                raise CompactedLogError(
                    f"read_from({index}) below the compaction horizon "
                    f"(first retained index {self._first_index}): the "
                    "records were truncated behind a snapshot — restore "
                    "it, then replay the tail",
                    index=index, first_index=self._first_index,
                    snapshot_index=(self._snapshot.index
                                    if self._snapshot is not None else -1),
                )
            return list(self._records[index - self._first_index:])

    # --- snapshot + compaction --------------------------------------------
    def install_snapshot(self, snap: StoreSnapshot) -> None:
        """Record ``snap`` as the latest snapshot and truncate the log
        strictly BEHIND it. A snapshot claiming records that were never
        committed (index beyond the log head) or regressing behind the
        current horizon is rejected — truncation can never orphan an
        un-snapshotted suffix because only this method truncates, and
        only up to an index the snapshot provably covers."""
        with self._lock:
            head = self._first_index + len(self._records)
            if snap.index > head:
                raise ValueError(
                    f"snapshot at index {snap.index} claims records the "
                    f"log never committed (head {head}) — refusing to "
                    "truncate an un-snapshotted suffix"
                )
            if snap.index < self._first_index:
                raise ValueError(
                    f"snapshot at index {snap.index} regresses behind the "
                    f"compaction horizon ({self._first_index})"
                )
            self._snapshot = snap
            self._records = self._records[snap.index - self._first_index:]
            self._first_index = snap.index

    def latest_snapshot(self) -> Optional[StoreSnapshot]:
        with self._lock:
            return self._snapshot


class LeaderLease:
    """Time-bounded leadership with a monotone epoch.

    ``acquire(owner)`` succeeds when the lease is free, expired, or
    already held by ``owner``; a NEW holder bumps the epoch. ``renew``
    extends the current holder's window. The clock is injected so the
    simulator drives lease expiry on virtual time and the failover test
    can expire a lease deterministically instead of sleeping.

    Clock-skew contract: expiry is judged on THIS lease's injected
    clock — the grantor's — at the moment of each call. ``renew`` takes
    no timestamp from the renewer, so a renewer whose own clock runs
    fast or slow can never stretch real leadership beyond ``duration_s``
    of grantor time per renewal (pinned by the skew test)."""

    def __init__(self, duration_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.duration_s = float(duration_s)
        self.clock = clock
        self._clock = clock  # internal alias (one source, read everywhere)
        self._lock = OrderedLock("lease")
        self._holder: Optional[str] = None
        self._epoch = 0
        self._expires_at = 0.0

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def holder(self) -> Optional[str]:
        with self._lock:
            if self._holder is not None and self._clock() >= self._expires_at:
                return None  # expired: readable as vacant
            return self._holder

    def expired(self) -> bool:
        with self._lock:
            return self._holder is None or self._clock() >= self._expires_at

    def acquire(self, owner: str) -> Optional[int]:
        """Try to take (or keep) the lease; returns the epoch on success
        (bumped for a NEW holder), None while another holder's lease is
        live. Acquisition by a new holder is the takeover edge."""
        with self._lock:
            now = self._clock()
            if (self._holder is not None and self._holder != owner
                    and now < self._expires_at):
                return None
            if self._holder != owner:
                self._epoch += 1
            self._holder = owner
            self._expires_at = now + self.duration_s
            return self._epoch

    def renew(self, owner: str) -> bool:
        """Extend the holder's window; False when ``owner`` no longer
        holds the lease (it must stop acting as leader)."""
        with self._lock:
            if self._holder != owner or self._clock() >= self._expires_at:
                return False
            self._expires_at = self._clock() + self.duration_s
            return True

    def revoke(self) -> None:
        """Administratively vacate (the chaos harness's controller-kill:
        a crashed leader stops renewing; revoke models the expiry
        without waiting out the wall clock)."""
        with self._lock:
            self._expires_at = 0.0


class _Txn:
    """Staged write set committed atomically on context exit.

    Reads see staged writes (read-your-writes inside the txn); no-op
    puts (value unchanged vs the committed state) are ELIDED so a
    control loop that re-derives the same state every tick appends
    nothing to the log. An exception inside the block discards the
    stage — half a reconcile never commits."""

    def __init__(self, store: "ControllerStore") -> None:
        self._store = store
        self._stage: Dict[str, Optional[str]] = {}  # None = delete

    def get(self, key: str) -> Optional[str]:
        if key in self._stage:
            return self._stage[key]
        return self._store.get(key)

    def put(self, key: str, value: str) -> None:
        if not isinstance(value, str):
            raise TypeError(
                f"store values are strings (JSON); got {type(value).__name__}"
            )
        if self._store.get(key) == value:
            self._stage.pop(key, None)  # no-op write: elide
            return
        self._stage[key] = value

    def put_json(self, key: str, value: Any) -> None:
        """Canonical JSON put — sort_keys so an identical dict is a
        byte-identical (and therefore elided) write."""
        self.put(key, json.dumps(value, sort_keys=True))

    def delete(self, key: str) -> None:
        if self._store.get(key) is not None:
            self._stage[key] = None

    def ops(self) -> List[Tuple[str, str, Optional[str]]]:
        return [
            ("delete", k, None) if v is None else ("put", k, v)
            for k, v in sorted(self._stage.items())
        ]

    def __enter__(self) -> "_Txn":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None and self._stage:
            self._store._commit(self.ops())
        return False


class ControllerStore:
    """Versioned KV surface the controller writes through transactions.

    ``version`` counts committed transactions — a cheap "did anything
    change" watermark for observers (status/dashboard)."""

    def __init__(self) -> None:
        self._data: Dict[str, str] = {}
        self._lock = OrderedLock("store")
        self._version = 0

    # --- read side --------------------------------------------------------
    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._data.get(key)

    def get_json(self, key: str) -> Optional[Any]:
        raw = self.get(key)
        return None if raw is None else json.loads(raw)

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._data)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # --- write side -------------------------------------------------------
    def txn(self) -> _Txn:
        """The ONLY write path (store-discipline contract)."""
        return _Txn(self)

    def _apply(self, ops: List[Tuple[str, str, Optional[str]]]) -> None:
        with self._lock:
            for kind, key, value in ops:
                if kind == "put":
                    self._data[key] = value  # type: ignore[assignment]
                elif kind == "delete":
                    self._data.pop(key, None)
                else:
                    raise ValueError(f"unknown store op kind {kind!r}")
            self._version += 1

    def _commit(self, ops: List[Tuple[str, str, Optional[str]]]) -> None:
        self._apply(ops)


class InMemoryStore(ControllerStore):
    """Single-process store: transactions apply atomically, no log."""


@dataclass
class _ReplicaState:
    applied_index: int = 0
    epoch: int = 0
    is_leader: bool = False


class ReplicatedStore(ControllerStore):
    """Log-replicated store with leader lease + epoch fencing.

    Many instances may share one :class:`StoreLog`/:class:`LeaderLease`
    pair (live: one per would-be controller; sim: leaders and standbys
    on the virtual clock). Exactly one is leader at a time; only the
    leader's transactions commit. A standby calls :meth:`catch_up` to
    replay new records and :meth:`acquire_leadership` to take over when
    the lease lapses.

    Partition defense: every log/lease exchange routes through
    ``fabric`` (the message seam), and lease + log are treated as ONE
    failure domain — a leader whose appends are UNREACHABLE for
    ``unreachable_demote_after_s`` self-demotes (audited
    ``store_unreachable``) and stops renewing, so the standby on the
    log's side of the partition takes over within one lease window
    instead of the old leader serving stale state until fenced.
    ``snapshot_every > 0`` arms log compaction: an epoch-consistent
    snapshot at the commit point every N records, recovery = snapshot +
    tail replay (O(tail), not O(uptime))."""

    def __init__(self, log: StoreLog, lease: LeaderLease, owner: str,
                 fabric: Optional[ControlFabric] = None,
                 clock: Optional[Callable[[], float]] = None,
                 snapshot_every: int = 0,
                 unreachable_demote_after_s: Optional[float] = None) -> None:
        super().__init__()
        self.log = log
        self.lease = lease
        self.owner = owner
        self.fabric = fabric if fabric is not None else default_fabric()
        # ONE control-plane clock: default to the lease's (the grantor's)
        # so log stamps, lease expiry, and the demotion window agree.
        self._clock = clock if clock is not None else lease.clock
        self.snapshot_every = int(snapshot_every)
        # Demote well inside one lease window: the standby must find the
        # lease lapsed at most one duration after the leader went blind.
        self.unreachable_demote_after_s = (
            float(unreachable_demote_after_s)
            if unreachable_demote_after_s is not None
            else lease.duration_s / 2.0
        )
        self._unreachable_since: Optional[float] = None
        self._repl = _ReplicaState()
        self.self_demotions = 0
        self.snapshots_taken = 0
        # How the last catch_up reconstructed state (the failover-time
        # ratchet reads this): records replayed, and whether a snapshot
        # seeded the replay.
        self.last_recovery: Dict[str, int] = {
            "snapshot_index": -1, "tail_replayed": 0,
        }
        # Worst single replay any catch_up ever did: the O(tail) ratchet
        # pins this against snapshot_every — with compaction armed it
        # stays bounded no matter how long the log's total history is.
        self.max_tail_replayed = 0
        # Optional structured audit ring (scheduler/audit.py); the
        # controller shares its own so store_unreachable lands next to
        # heals and fences.
        self.audit: Optional[Any] = None

    # --- leadership -------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._repl.epoch

    def is_leader(self) -> bool:
        return self._repl.is_leader and self.lease.holder() == self.owner

    def acquire_leadership(self) -> Optional[int]:
        """Take the lease (if free/expired), replay the whole log, and
        fence out the previous epoch. Returns the new epoch, or None
        while another leader's lease is live; raises
        :class:`FabricUnreachable` when the log cannot be reached —
        leadership is NOT assumed on a partial acquire (a lease without
        a replayed, fenced log is exactly the split-brain this layer
        exists to prevent). Replay BEFORE fencing would race the old
        leader's final commits; fencing first means everything replayed
        is everything that will ever exist below this epoch."""
        # Probe the log BEFORE touching the lease: same-holder acquire
        # EXTENDS the lease window, so a self-demoted leader that is
        # partitioned from the log but not the lease would otherwise
        # keep re-extending its own lease on every retry and lock the
        # reachable standby out forever — the quiet split-brain this
        # whole layer exists to prevent. No log, no candidacy.
        self.catch_up()  # raises FabricUnreachable when the log is cut off
        epoch = self.fabric.call(
            "lease.acquire", self.lease.acquire, self.owner,
            src=self.owner, dst="lease",
        )
        if epoch is None:
            return None
        self.fabric.call("store.fence", self.log.fence_to, epoch,
                         src=self.owner, dst="log")
        self.catch_up()
        self._unreachable_since = None
        self._repl.epoch = epoch
        self._repl.is_leader = True
        logger.info("%s: leadership acquired at epoch %d (log index %d)",
                    self.owner, epoch, self._repl.applied_index)
        return epoch

    def renew(self) -> bool:
        """Heartbeat; False demotes this instance (stop leading). A
        self-demoted instance (appends unreachable) returns False
        WITHOUT renewing: deliberately letting the lease lapse is what
        hands leadership to a standby that can still reach the log —
        renewing a lease you cannot write under IS the split-brain.

        Lease and log are ONE failure domain: a successful lease renew
        also PROBES the log — a tail read carried on the ``store.append``
        edge, the same channel commits use — so the bounded
        self-demotion window runs even while the control loop is
        quiescent (elided steady-state transactions append nothing, and
        without the probe an idle leader would happily renew through a
        partition it could never write across)."""
        if not self._repl.is_leader:
            return False
        try:
            ok = self.fabric.call("lease.renew", self.lease.renew,
                                  self.owner, src=self.owner, dst="lease")
        except FabricUnreachable:
            ok = False
        if not ok and self._repl.is_leader:
            self._repl.is_leader = False
            logger.warning("%s: lease lost (epoch %d); demoted",
                           self.owner, self._repl.epoch)
            return False
        if ok:
            try:
                # The probe rides the APPEND edge (it is a heartbeat-
                # append in spirit): a fault that eats only appends must
                # open — and keep open — the same unreachability window
                # real commits do. Probing a different edge would let a
                # healthy read channel mask a dead write channel and
                # the leader would renew forever over a log it can
                # never write to.
                self.fabric.call(
                    "store.append", self.log.read_from,
                    self._repl.applied_index, src=self.owner, dst="log",
                )
                self._unreachable_since = None
            except FabricUnreachable:
                self._note_unreachable()  # may self-demote (bounded)
                return self._repl.is_leader
        return ok

    def catch_up(self) -> int:
        """Apply records this instance has not seen; returns how many.
        Standbys call this on their watch loop; a fresh leader calls it
        inside :meth:`acquire_leadership`. When the cursor has fallen
        behind the compaction horizon, restore the latest snapshot and
        replay only the tail — the O(tail) failover path. The snapshot
        may be an OLDER epoch's than the tail (takeover raced the
        snapshot): restore moves the cursor to the snapshot index, so
        the newer-epoch tail applies exactly once."""
        restored_index = -1
        while True:
            try:
                new = self.fabric.call(
                    "store.read", self.log.read_from,
                    self._repl.applied_index, src=self.owner, dst="log",
                )
                break
            except CompactedLogError:
                # The leader may compact AGAIN between our restore and
                # the tail read (it keeps committing while we recover);
                # each retry restores a strictly newer snapshot — the
                # cursor only moves forward — so the loop terminates.
                snap = self.fabric.call(
                    "store.snapshot", self.log.latest_snapshot,
                    src=self.owner, dst="log",
                )
                if snap is None or snap.index <= self._repl.applied_index:
                    # Compacted with no (or a non-advancing) snapshot:
                    # impossible by install_snapshot's construction —
                    # fail loud rather than spin.
                    raise
                self._restore(snap)
                restored_index = snap.index
        for rec in new:
            self._apply(rec.ops)
            self._repl.applied_index = rec.index + 1
        if restored_index >= 0 or new:
            # A no-op poll leaves the stats alone so the LAST real
            # recovery (the failover's snapshot + tail replay — what the
            # O(tail) ratchet grades) stays readable.
            self.last_recovery = {"snapshot_index": restored_index,
                                  "tail_replayed": len(new)}
            self.max_tail_replayed = max(self.max_tail_replayed, len(new))
        return len(new)

    def _restore(self, snap: StoreSnapshot) -> None:
        """Replace local state wholesale with the snapshot image and move
        the replay cursor to its index (never double-apply: everything
        below the index is IN the image, everything at/after it replays
        from the tail)."""
        with self._lock:
            self._data = dict(snap.data)
            self._version = snap.version
        self._repl.applied_index = snap.index
        logger.info("%s: restored snapshot at index %d (epoch %d)",
                    self.owner, snap.index, snap.epoch)

    # --- split-brain defense ----------------------------------------------
    def _note_unreachable(self) -> None:
        now = self._clock()
        if self._unreachable_since is None:
            self._unreachable_since = now
            return
        window = now - self._unreachable_since
        if window >= self.unreachable_demote_after_s and self._repl.is_leader:
            self._repl.is_leader = False
            self.self_demotions += 1
            logger.error(
                "%s: log unreachable for %.3fs (bound %.3fs) at epoch %d — "
                "self-demoting; the lease will lapse and a standby that can "
                "reach the log takes over",
                self.owner, window, self.unreachable_demote_after_s,
                self._repl.epoch,
            )
            if self.audit is not None:
                self.audit.record(
                    "store_unreachable",
                    observed={"owner": self.owner,
                              "epoch": self._repl.epoch,
                              "unreachable_s": round(window, 3),
                              "bound_s": self.unreachable_demote_after_s},
                    note="appends failed reachability for the bounded "
                         "window; self-demoted instead of serving stale "
                         "state until fenced",
                )

    # --- snapshots ---------------------------------------------------------
    def _maybe_snapshot(self) -> None:
        """At the commit point (just appended + applied): if the
        replayable tail outgrew ``snapshot_every``, publish an
        epoch-consistent snapshot and compact the log behind it. A
        snapshot that cannot reach the log is skipped — it is an
        optimization, never a correctness dependency."""
        if self.snapshot_every <= 0:
            return
        if self._repl.applied_index - self.log.first_index \
                < self.snapshot_every:
            return
        snap = StoreSnapshot(
            index=self._repl.applied_index,
            epoch=self._repl.epoch,
            version=self.version,
            data=self.snapshot(),
        )
        try:
            self.fabric.call("store.snapshot", self.log.install_snapshot,
                             snap, src=self.owner, dst="log")
        except FabricUnreachable:
            return
        self.snapshots_taken += 1

    # --- write side (fenced) ----------------------------------------------
    def _commit(self, ops: List[Tuple[str, str, Optional[str]]]) -> None:
        if not self._repl.is_leader:
            raise StaleEpochError(
                f"{self.owner}: commit refused — not the leader "
                f"(epoch {self._repl.epoch}, fence {self.log.fence_epoch})",
                epoch=self._repl.epoch, fence=self.log.fence_epoch,
            )
        try:
            index = self.fabric.call(
                "store.append", self.log.append, self._repl.epoch, ops,
                src=self.owner, dst="log",
            )  # raises StaleEpochError when fenced
        except FabricUnreachable:
            self._note_unreachable()
            raise
        self._unreachable_since = None
        self._apply(ops)
        self._repl.applied_index = index + 1
        self._maybe_snapshot()


class ReplicaCatalog:
    """Process-local registry of LIVE data-plane objects (replicas and
    routers) that survive a controller death.

    In the reference, replica actors and router processes outlive the
    controller; a recovering controller re-syncs with them instead of
    restarting the world. In this in-process re-creation the catalog IS
    that survival: controllers register the objects they start, a
    failover successor adopts whatever is still alive and healthy, and
    only replicas recorded in the store but missing (or dead) here get
    restarted. Clients' handles keep working through a failover because
    the ROUTER object they hold is adopted, not replaced."""

    def __init__(self) -> None:
        self._replicas: Dict[str, Any] = {}
        self._routers: Dict[str, Any] = {}
        # replica_id -> live placement group: chip reservations outlive
        # the controller exactly like the replicas holding them, so a
        # failover successor can release them when it later retires an
        # adopted replica (otherwise the chips leak forever).
        self._pgroups: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def register_replica(self, replica_id: str, replica: Any) -> None:
        with self._lock:
            self._replicas[replica_id] = replica

    def unregister_replica(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.pop(replica_id, None)

    def replica(self, replica_id: str) -> Optional[Any]:
        with self._lock:
            return self._replicas.get(replica_id)

    def register_router(self, deployment: str, router: Any) -> None:
        with self._lock:
            self._routers[deployment] = router

    def unregister_router(self, deployment: str) -> None:
        """Drop a deleted deployment's router: a later redeploy must
        build fresh, never adopt the CLOSED router (whose failover and
        hedge workers are gone for good)."""
        with self._lock:
            self._routers.pop(deployment, None)

    def router(self, deployment: str) -> Optional[Any]:
        with self._lock:
            return self._routers.get(deployment)

    def register_pgroup(self, replica_id: str, pg: Any) -> None:
        with self._lock:
            self._pgroups[replica_id] = pg

    def unregister_pgroup(self, replica_id: str) -> None:
        with self._lock:
            self._pgroups.pop(replica_id, None)

    def pgroup(self, replica_id: str) -> Optional[Any]:
        with self._lock:
            return self._pgroups.get(replica_id)

    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)
