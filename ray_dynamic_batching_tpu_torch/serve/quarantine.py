"""Query-of-death quarantine — fingerprint and fence poison requests.

Own copy of ``ray_dynamic_batching_tpu/serve/quarantine.py``, whole,
with its import paths rewritten.

A "query of death" (Barroso et al., *The Datacenter as a Computer*) is a
request whose *content* crashes execution: re-dispatching it is not
recovery, it is replication of the fault into every replica that will
take it. Once the replica's batch bisection (serve/replica.py) isolates
one, the request is rejected terminally (``PoisonRequest``, 4xx, never
retried) and its *fingerprint* — a digest of model + payload shape and
content — lands here so every front door can refuse the identical query
at admission, before it reaches a replica.

:class:`QuarantineRegistry` follows the ``PrefixDigestDirectory``
gossip discipline (serve/router.py): bounded, merge-by-union with FIFO
eviction, a ``snapshot()`` the controller pushes to peers over the
ControlFabric + long-poll channel, and a ``changed`` bool so unchanged
ticks cost no fan-out. Entries are *hints with teeth*: a lost entry
only means one more bisection on its next appearance — correctness
never depends on the gossip converging.

Every verdict is priced in the shared planes: ``rdb_poison_total
{model,stage}`` counts isolations/front-door rejects/gossip merges, and
the registry writes ``poison_quarantine`` records into whatever audit
ring the router shares with it.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import numpy as np

from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.utils import metrics as m

POISON_TOTAL = m.Counter(
    "rdb_poison_total",
    "Query-of-death verdicts by stage (isolated / front_door / merged)",
    tag_keys=("model", "stage"),
)

# Registry bound — same order as the digest directory's per-replica cap:
# a poison *campaign* larger than this rotates through FIFO eviction and
# pays one bisection per reappearance instead of unbounded memory.
DEFAULT_MAX_ENTRIES = 256


def _feed(h: "hashlib._Hash", obj: Any) -> None:
    """Canonical content walk: type-tagged so ``[1]`` and ``(1,)`` and
    ``"1"`` cannot collide, sorted dict order so wire-order noise cannot
    split one poison into many fingerprints."""
    if isinstance(obj, dict):
        h.update(b"d")
        for k in sorted(obj, key=str):
            _feed(h, str(k))
            _feed(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(b"l%d:" % len(obj))
        for v in obj:
            _feed(h, v)
    elif isinstance(obj, np.ndarray):
        h.update(b"a" + str(obj.dtype).encode()
                 + str(obj.shape).encode() + obj.tobytes())
    elif isinstance(obj, bytes):
        h.update(b"b" + obj)
    elif isinstance(obj, bool):
        h.update(b"t" if obj else b"f")
    elif isinstance(obj, (int, float, str)) or obj is None:
        h.update(repr(obj).encode())
    else:
        # Arbitrary user objects: repr is the best stable proxy we have;
        # an unstable repr only weakens dedup, never correctness.
        h.update(b"o" + repr(obj).encode())


def poison_fingerprint(model: str, payload: Any) -> str:
    """Stable digest of (model, payload shape + content). The model is
    part of the identity: the same prompt may be poison to one decoder
    build and benign to another."""
    h = hashlib.blake2b(digest_size=16)
    _feed(h, model)
    _feed(h, payload)
    return h.hexdigest()


class QuarantineRegistry:
    """Bounded, gossipable set of poison fingerprints.

    Mirrors ``PrefixDigestDirectory``: mutators return ``changed`` so
    the controller's publish tick only fans out real deltas; ``merge``
    is a commutative union (last-writer metadata, FIFO eviction) so
    shards converge regardless of push order.
    """

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES) -> None:
        self.max_entries = max_entries
        # Rank: consulted under router_pool (front-door check) and from
        # replica execution threads; leaf-adjacent like the sketches.
        self._lock = OrderedLock("sketch")
        # fp -> {"model": str, "hits": int} — insertion-ordered for FIFO
        # eviction (Python dicts preserve insertion order).
        self._entries: Dict[str, Dict[str, Any]] = {}
        self.audit = None  # shared ring, wired by the router/controller
        self.evicted = 0

    # --- mutation ----------------------------------------------------------
    def add(self, fingerprint: str, model: str,
            stage: str = "isolated", note: str = "") -> bool:
        """Record a bisection verdict. Returns True when the fingerprint
        is new to this registry (callers gossip only on change)."""
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is not None:
                entry["hits"] += 1
                return False
            self._entries[fingerprint] = {"model": model, "hits": 1}
            self._evict_locked()
        POISON_TOTAL.inc(tags={"model": model, "stage": stage})
        if self.audit is not None:
            self.audit.record(
                "poison_quarantine",
                key=model,
                observed={"fingerprint": fingerprint, "stage": stage},
                after={"quarantined": True},
                note=note or "query-of-death isolated by batch bisection",
            )
        return True

    def merge(self, entries: Dict[str, Dict[str, Any]]) -> bool:
        """Gossip union: absorb a peer snapshot. Hit counts take the max
        (summing would double-count a fingerprint gossiped both ways;
        max loses least information without double counting). Returns
        True when anything changed."""
        changed = False
        merged_models = []
        with self._lock:
            for fp, entry in entries.items():
                model = str(entry.get("model", ""))
                hits = int(entry.get("hits", 1))
                mine = self._entries.get(fp)
                if mine is None:
                    self._entries[fp] = {"model": model, "hits": hits}
                    merged_models.append(model)
                    changed = True
                elif hits > mine["hits"]:
                    mine["hits"] = hits
            if changed:
                self._evict_locked()
        for model in merged_models:
            POISON_TOTAL.inc(tags={"model": model, "stage": "merged"})
        return changed

    def _evict_locked(self) -> None:
        while len(self._entries) > self.max_entries:  # rdb-lint: disable=lock-discipline (_locked-suffix contract: both callers, add() and merge(), hold _lock; re-acquiring the non-reentrant lock here would self-deadlock)
            self._entries.pop(next(iter(self._entries)))  # rdb-lint: disable=lock-discipline (insertion-order FIFO eviction under the caller's _lock — see the _locked-suffix contract above)
            self.evicted += 1

    # --- query -------------------------------------------------------------
    def contains(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._entries

    def check(self, model: str, payload: Any) -> Optional[str]:
        """Front-door gate: returns the fingerprint when (model, payload)
        is quarantined, else None. Free when the registry is empty — the
        common case pays one len() check, no hashing."""
        with self._lock:
            if not self._entries:
                return None
        fp = poison_fingerprint(model, payload)
        with self._lock:
            entry = self._entries.get(fp)
            if entry is None:
                return None
            entry["hits"] += 1
        POISON_TOTAL.inc(tags={"model": model, "stage": "front_door"})
        return fp

    # --- observability / gossip --------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {fp: dict(e) for fp, e in self._entries.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "evicted": self.evicted,
                "hits": sum(e["hits"] for e in self._entries.values()),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
