"""Long-poll push channel: controller → routers/handles.

Own copy of ``ray_dynamic_batching_tpu/serve/long_poll.py``, whole, with
its import paths rewritten.

Re-creates Ray Serve's long-poll mechanism
(``python/ray/serve/_private/long_poll.py``): the host keeps a
``(snapshot_id, object)`` per key; ``listen_for_change`` blocks until any
listened key's snapshot advances past the id the client last saw (ref
``:177`` host, ``:242`` blocking wait, ``:64`` client re-arm loop). Config
and replica-set changes reach the data plane through this channel, never via
per-request control traffic (SURVEY.md §3.5 note).

In-process design: a condition variable replaces the RPC long poll; the
client is a daemon thread re-arming the listen, same contract.

Partition seam: the client's listen — the router/handle →
controller edge — routes through the control fabric
(``long_poll.listen``). A partitioned listen raises
:class:`~ray_dynamic_batching_tpu_torch.serve.fabric.FabricUnreachable`; the
client treats it exactly like a timed-out poll and re-arms, so a router
cut off from the controller keeps serving its LAST pushed state (stale
but consistent — the reference's long-poll clients behave the same) and
reconverges on heal because snapshot ids are monotone: every re-armed
listen asks for "anything newer than what I have", which makes missed
pushes self-healing and duplicated pushes no-ops.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from ray_dynamic_batching_tpu_torch.serve.fabric import (
    ControlFabric,
    FabricUnreachable,
    default_fabric,
)
from ray_dynamic_batching_tpu_torch.utils.concurrency import assert_owner
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("long_poll")


class LongPollHost:
    """Holds latest (snapshot_id, value) per key; wakes blocked listeners."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._snapshots: Dict[str, Tuple[int, Any]] = {}
        self._next_id = 1

    def notify_changed(self, key: str, value: Any) -> int:
        """Publish a new value for ``key``; returns its snapshot id."""
        with self._cond:
            sid = self._next_id
            self._next_id += 1
            self._snapshots[key] = (sid, value)
            self._cond.notify_all()
            return sid

    def listen_for_change(
        self,
        keys_to_ids: Dict[str, int],
        timeout_s: Optional[float] = None,
    ) -> Dict[str, Tuple[int, Any]]:
        """Block until any listened key's snapshot id exceeds the given id;
        returns {key: (snapshot_id, value)} for every advanced key (empty on
        timeout — the client simply re-arms, ref long_poll.py:242)."""
        with self._cond:
            out = self._updates_locked(keys_to_ids)
            if out:
                return out
            self._cond.wait(timeout_s)
            return self._updates_locked(keys_to_ids)

    def _updates_locked(
        self, keys_to_ids: Dict[str, int]
    ) -> Dict[str, Tuple[int, Any]]:
        assert_owner(self._cond)  # callers hold it (listen_for_change)
        return {
            k: snap
            for k, last_id in keys_to_ids.items()
            if (snap := self._snapshots.get(k)) is not None
            and snap[0] > last_id
        }

    def snapshot_ids(self) -> Dict[str, int]:
        with self._lock:
            return {k: sid for k, (sid, _) in self._snapshots.items()}


class LongPollClient:
    """Daemon thread that re-arms listens and fires callbacks on change
    (ref LongPollClient, long_poll.py:64)."""

    def __init__(
        self,
        host: LongPollHost,
        callbacks: Dict[str, Callable[[Any], None]],
        poll_timeout_s: float = 1.0,
        fabric: Optional[ControlFabric] = None,
        node: str = "router",
    ) -> None:
        self.host = host
        self.callbacks = dict(callbacks)
        self.poll_timeout_s = poll_timeout_s
        self.fabric = fabric if fabric is not None else default_fabric()
        self.node = node
        self.unreachable_polls = 0
        self._ids: Dict[str, int] = {k: -1 for k in callbacks}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="long-poll-client", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                updates = self.fabric.call(
                    "long_poll.listen", self.host.listen_for_change,
                    dict(self._ids), timeout_s=self.poll_timeout_s,
                    src=self.node, dst="controller",
                )
                for key, (sid, value) in updates.items():
                    self._ids[key] = sid
                    try:
                        self.callbacks[key](value)
                    except Exception:  # noqa: BLE001 — bad callback must not kill poller
                        logger.exception("long-poll callback for %r failed", key)
            except FabricUnreachable:
                # Partitioned from the controller: behave like a timeout
                # — keep last-known state, back off one window, re-arm.
                # Snapshot ids are monotone, so the first post-heal
                # listen returns everything missed in one response.
                self.unreachable_polls += 1
                self._stop.wait(self.poll_timeout_s)
            except Exception:  # noqa: BLE001
                logger.exception("long-poll listen failed")
                self._stop.wait(self.poll_timeout_s)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
