"""KV page fabric transfer plane — couriers for live-stream and prefix
parcels between replicas.

Own copy of ``ray_dynamic_batching_tpu/serve/kv_fabric.py``, whole, with
its import paths rewritten. The port's ``LLMReplica`` exposes the live
streams of its paged engines (``live_stream_ids``, ``request_migration``,
``accept_parcel``) and its hot prefixes (``hot_prefixes``,
``request_prefix_push``), so the controller's courier moves streams and
pushes prefixes between replicas as the reference's does.

The engine half (``engine/pagefabric.py``) freezes and splices parcels;
this module is the plane that MOVES them. Every delivery crosses the
ControlFabric seam on one of two canonical edges:

- ``courier.migrate`` — a live stream's page set + cursor, source
  replica -> destination replica. Source-side commit happens only on an
  acknowledged True from the destination's ``accept_parcel``, so a
  courier death, a partition window opening mid-parcel, or a
  destination refusal all degrade the same way: the source slot keeps
  decoding as if the directive never arrived, and the drain loop
  retries on its next pass.
- ``courier.push`` — a hot prefix entry pushed speculatively to a peer
  that does not hold it. Pushes are pure optimizations: every failure
  mode is "skip", bounded per destination by a push budget so a flash
  crowd's replication never floods a loaded replica.

Pricing lives with the replanner (``scheduler/replan.py``:
``COURIER_MS_PER_MB``) so migrations compete in the same objective as
resharding; this module only reports parcel bytes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from ray_dynamic_batching_tpu_torch.serve.fabric import (
    ControlFabric,
    FabricUnreachable,
    default_fabric,
)
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m

logger = get_logger("kv_fabric")

# Parcel deliveries by courier edge and outcome. Edge values are the two
# canonical courier edges; bounded anyway (fabric.py discipline) so a
# mislabeled caller cannot mint series.
PARCELS = m.Counter(
    "rdb_fabric_parcels_total",
    "KV page parcels by courier edge and outcome "
    "(shipped | refused | failed)",
    tag_keys=("edge", "outcome"),
    bounded_tags={"edge": 8},
)
PREFIX_PUSHES = m.Counter(
    "rdb_prefix_pushes_total",
    "Hot prefix entries pushed to peer replicas ahead of demand",
    tag_keys=("deployment",),
    bounded_tags={"deployment": 8},
)


class KVPageFabric:
    """Courier endpoints + the two control-plane moves built on them:
    zero-drop stream drains and budgeted prefix push replication.

    Replica objects are in-process here (the single-host posture every
    serve seam in this repo takes); the ControlFabric call is the
    network seam a multi-host courier would cross, which is exactly
    where the chaos/partition harness injects failure.
    """

    def __init__(self, fabric: Optional[ControlFabric] = None,
                 push_budget: int = 2) -> None:
        self.fabric = fabric or default_fabric()
        # Per-destination cap on prefix parcels per push tick: push
        # replication must warm peers, not stampede them.
        self.push_budget = int(push_budget)
        self._lock = OrderedLock("metrics")
        self.parcels_shipped = 0
        self.parcels_refused = 0
        self.parcels_failed = 0
        self.prefix_pushed = 0

    def _count(self, edge: str, outcome: str) -> None:
        PARCELS.inc(tags={"edge": edge, "outcome": outcome})
        with self._lock:
            if outcome == "shipped":
                self.parcels_shipped += 1
            elif outcome == "refused":
                self.parcels_refused += 1
            else:
                self.parcels_failed += 1

    # --- courier edges -----------------------------------------------------
    def _deliver(self, edge: str, dst: Any, src_id: str) -> Any:
        """Build the deliver callback the source engine invokes with the
        frozen parcel (ON the source engine's thread). Returns True only
        when the destination ACCEPTED — the source's commit gate."""
        def deliver(parcel: Any) -> bool:
            try:
                ok = bool(self.fabric.call(
                    edge, dst.accept_parcel, parcel,
                    src=src_id, dst=dst.replica_id,
                ))
            except FabricUnreachable:
                # Partition/chaos mid-parcel: the stream was never torn
                # down at the source (commit requires this True), so the
                # failure costs one retry, zero tokens.
                self._count(edge, "failed")
                return False
            self._count(edge, "shipped" if ok else "refused")
            return ok
        return deliver

    def migrate(self, src: Any, dst: Any, request_id: str) -> bool:
        """Direct a single live stream from ``src`` to ``dst``. Returns
        whether the source enqueued the directive (delivery and commit
        happen on the source engine's thread at its next service
        point)."""
        return src.request_migration(
            request_id, self._deliver("courier.migrate", dst, src.replica_id)
        )

    # --- zero-drop drain ---------------------------------------------------
    def drain_streams(self, src: Any, peers: Sequence[Any],
                      timeout_s: float = 30.0,
                      poll_s: float = 0.02) -> Dict[str, int]:
        """Migrate every live stream off ``src`` to the least-loaded
        peer — the zero-drop replacement for the drain-evict-requeue a
        rolling update or scale-down used to cost. Re-requests remaining
        streams each pass (directives are idempotent: a stream that
        finished or already moved is skipped at service time) until the
        replica reports none left or the deadline passes; streams still
        live at timeout fall back to the old stop() semantics, so the
        worst case equals the status quo, never worse."""
        stats = {"requested": 0, "remaining": 0}
        if not peers or not hasattr(src, "live_stream_ids"):
            stats["remaining"] = len(getattr(
                src, "live_stream_ids", lambda: [])())
            return stats
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            live = src.live_stream_ids()
            if not live:
                break
            ranked = sorted(peers, key=lambda r: r.queue_len())
            for i, rid in enumerate(live):
                dst = ranked[i % len(ranked)]
                if self.migrate(src, dst, rid):
                    stats["requested"] += 1
            time.sleep(poll_s)  # rdb-lint: disable=event-loop-blocking (control-plane drain poll on the controller's deferred-action path; no event loop involved)
        stats["remaining"] = len(src.live_stream_ids())
        if stats["remaining"]:
            logger.warning(
                "%s: %d stream(s) still live after %.1fs drain window — "
                "falling back to stop() drain semantics",
                src.replica_id, stats["remaining"], timeout_s,
            )
        return stats

    # --- prefix push replication ------------------------------------------
    def push_hot_prefixes(self, deployment: str, replicas: Sequence[Any],
                          directory: Any = None,
                          limit: int = 8) -> int:
        """One push tick: rank each replica's hot resident prefixes and
        push entries to the least-loaded peers that do not already hold
        them (holder set from the router directory snapshot when given),
        at most ``push_budget`` parcels per destination per tick."""
        live = [r for r in replicas
                if hasattr(r, "hot_prefixes") and not getattr(
                    r, "_stopped", False)]
        if len(live) < 2:
            return 0
        holders: Dict[str, set] = {}
        if directory is not None:
            snap = directory.snapshot()
            for rid, digests in snap.get("replicas", {}).items():
                for hexkey in digests:
                    holders.setdefault(hexkey, set()).add(rid)
        budget = {r.replica_id: self.push_budget for r in live}
        pushed = 0
        for src in live:
            for hexkey, _pages, _hits in src.hot_prefixes(limit):
                have = holders.setdefault(hexkey, set())
                have.add(src.replica_id)
                targets = sorted(
                    (r for r in live
                     if r.replica_id not in have
                     and budget[r.replica_id] > 0),
                    key=lambda r: r.queue_len(),
                )
                if not targets:
                    continue
                dst = targets[0]
                ok = src.request_prefix_push(
                    hexkey,
                    self._deliver("courier.push", dst, src.replica_id),
                )
                if ok:
                    budget[dst.replica_id] -= 1
                    # Optimistic holder mark: the push is in flight; a
                    # failed delivery just means one redundant retry in
                    # a later tick once the directory catches up.
                    have.add(dst.replica_id)
                    pushed += 1
                    PREFIX_PUSHES.inc(tags={"deployment": deployment})
        if pushed:
            with self._lock:
                self.prefix_pushed += pushed
        return pushed

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "parcels_shipped": self.parcels_shipped,
                "parcels_refused": self.parcels_refused,
                "parcels_failed": self.parcels_failed,
                "prefix_pushed": self.prefix_pushed,
            }
