"""Declared lock hierarchy + order-enforcing lock wrappers.

Own copy of ``ray_dynamic_batching_tpu/utils/concurrency.py``, whole,
with the same rank table: :data:`LOCK_RANKS` names every lock family and
fixes the order they may nest (lower rank = acquired first / outermost).
The reference's ``lock-ordering`` lint rule reads its own copy; nothing
lints this one, so the runtime check below is the port's guard.

- :class:`OrderedLock` wraps a ``threading.Lock`` (or ``RLock`` with
  ``reentrant=True``) and, when ``RDB_TESTING_LOCKORDER`` is armed,
  raises :class:`LockOrderError` the moment a thread acquires a rank
  less than or equal to one it already holds — a potential deadlock is
  reported on the FIRST inverted acquisition, deterministic, without
  needing the interleaving that would actually deadlock. Unarmed (the
  production default) the wrapper is one attribute check over the bare
  lock.
- :func:`assert_owner` asserts the calling thread holds a lock; a
  method that opens with ``assert_owner(self._lock)`` declares its
  whole body runs under that lock (callers must hold it).

Stdlib only.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

LOCKORDER_ENV_VAR = "RDB_TESTING_LOCKORDER"

# The declared hierarchy: rank name -> level. A thread may only acquire
# STRICTLY INCREASING levels (outermost control plane first, leaf
# instrumentation last). Gaps of 10 leave room for new families without
# renumbering. Ownership rationale lives in ARCHITECTURE.md ("Lock
# hierarchy"); the short form:
#
#   controller     ServeController's control-step RLock — outermost: a
#                  control step calls into store, router, observatory.
#   store          ControllerStore/ReplicatedStore txn lock — commits
#                  fan out to lease probes and log appends.
#   lease          LeaderLease grant state — probed on the commit path.
#   store_log      StoreLog append/read — innermost durability lock.
#   router_pool    Router pow-2 pool + breakers — assignment enqueues
#                  into replica queues.
#   failover       FailoverManager retry heap/stats — its worker
#                  re-dispatches into queues (never holding the cond).
#   observatory    burn/forecast/fidelity monitors — ticks read queue
#                  windows and write gauges.
#   request_queue  RequestQueue buckets/counters/cond — completion
#                  paths touch token streams and metrics.
#   token_stream   Request future + TokenStream chunk cond — leaf of
#                  the request path (callbacks run outside it).
#   allocator      PageAllocator free-list — single-owner (engine step
#                  thread) today; the rank reserves its slot below the
#                  queue for the disagg/live-migration work.
#   fabric         ControlFabric chaos/stats — never held across a
#                  delivery; near-leaf by design.
#   sketch         RollingSketch epoch state — read under queue /
#                  observatory locks.
#   compile_ledger CompileLedger episode/violation state — updated by
#                  the graph runner (ops/graphs.py) during dispatch; bumps the
#                  rdb_jit_compiles_total counter while held, so it must
#                  sit ABOVE every dispatcher lock and BELOW metrics.
#   metrics        Metric/registry state — THE innermost: counters are
#                  bumped under every other lock in the stack.
LOCK_RANKS: Dict[str, int] = {
    "controller": 10,
    "store": 20,
    "lease": 30,
    "store_log": 40,
    "router_pool": 50,
    "failover": 60,
    "observatory": 70,
    "request_queue": 80,
    "token_stream": 90,
    "allocator": 100,
    "fabric": 110,
    "sketch": 120,
    "compile_ledger": 125,
    "metrics": 130,
}


def lockorder_armed() -> bool:
    """True when ``RDB_TESTING_LOCKORDER`` is set to a truthy value.
    Read at :class:`OrderedLock` construction (locks are built at
    component construction, which is when tests/soaks arm the env)."""
    return os.environ.get(LOCKORDER_ENV_VAR, "") not in ("", "0", "false")


class LockOrderError(RuntimeError):
    """A thread acquired lock ranks out of hierarchy order (potential
    deadlock), released a lock it does not own, or failed an
    :func:`assert_owner` check."""


_tls = threading.local()


def _held_stack() -> List[Tuple[int, str, int]]:
    """Per-thread stack of (level, rank_name, lock_id) held ARMED locks.
    The strict-increase invariant keeps it sorted; the top is the max."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def held_ranks() -> List[str]:
    """Rank names the calling thread currently holds (outermost first);
    empty when unarmed — only armed locks register themselves."""
    return [name for _, name, _ in _held_stack()]


class OrderedLock:
    """A ``threading.Lock``/``RLock`` that knows its place.

    ``rank`` must name an entry of :data:`LOCK_RANKS`. Context-manager
    and ``acquire``/``release``/``locked`` surfaces match the stdlib
    lock, and ``threading.Condition(OrderedLock(...))`` works (the
    wrapper provides ``_is_owned`` so the condition never try-acquires
    to probe ownership). When armed, acquisition order is checked
    BEFORE blocking, so an inversion is reported even on interleavings
    that would not have deadlocked this run.
    """

    def __init__(self, rank: str, *, reentrant: bool = False,
                 armed: Optional[bool] = None) -> None:
        if rank not in LOCK_RANKS:
            raise ValueError(
                f"unknown lock rank '{rank}' — declare it in "
                f"LOCK_RANKS (known: {', '.join(sorted(LOCK_RANKS))})"
            )
        self.rank_name = rank
        self.level = LOCK_RANKS[rank]
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._armed = lockorder_armed() if armed is None else armed
        self._owner: Optional[int] = None  # thread ident, armed only
        self._depth = 0

    # --- stdlib lock surface ----------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._armed:
            me = threading.get_ident()
            if not (self.reentrant and self._owner == me):
                stack = _held_stack()
                if stack and self.level <= stack[-1][0]:
                    top_level, top_name, _ = stack[-1]
                    raise LockOrderError(
                        f"lock-order violation: acquiring "
                        f"'{self.rank_name}' (rank {self.level}) while "
                        f"holding '{top_name}' (rank {top_level}) — "
                        f"ranks must strictly increase; held: "
                        f"{' -> '.join(held_ranks())}"
                    )
        got = self._inner.acquire(blocking, timeout)
        if got and self._armed:
            me = threading.get_ident()
            if self._owner == me:
                self._depth += 1
            else:
                self._owner = me
                self._depth = 1
                _held_stack().append((self.level, self.rank_name, id(self)))
        return got

    def release(self) -> None:
        if self._armed:
            me = threading.get_ident()
            if self._owner != me:
                raise LockOrderError(
                    f"'{self.rank_name}' released by a thread that does "
                    "not own it"
                )
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                stack = _held_stack()
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][2] == id(self):
                        del stack[i]
                        break
        self._inner.release()

    def locked(self) -> bool:
        if self.reentrant:
            # RLock has no .locked(); armed tracking answers instead.
            return self._owner is not None if self._armed \
                else self._inner._is_owned()  # type: ignore[attr-defined]
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # --- ownership (Condition compat + assert_owner) ----------------------
    def held_by_me(self) -> Optional[bool]:
        """True/False when armed (ownership is tracked); None unarmed —
        a bare ``threading.Lock`` cannot name its owner."""
        if not self._armed:
            return None
        return self._owner == threading.get_ident()

    def _is_owned(self) -> bool:
        """``threading.Condition`` probes this instead of try-acquiring
        (a try-acquire under arming would trip the order check against
        the very lock the condition wraps)."""
        if self._armed:
            return self._owner == threading.get_ident()
        if self.reentrant:
            return self._inner._is_owned()  # type: ignore[attr-defined]
        # Stdlib fallback for a plain lock: owned iff not acquirable.
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def assert_owner(lock) -> None:
    """Assert the calling thread holds ``lock``.

    Doubles as the ``lock-discipline`` rule's guarded-context marker: a
    method whose body calls ``assert_owner(self._lock)`` is analyzed as
    running entirely under that lock — the callers are the ones that
    must hold it. At runtime the check is real only for an ARMED
    :class:`OrderedLock` (a bare ``threading.Lock`` cannot name its
    owner); unarmed or untracked locks pass silently, keeping the
    marker free on production paths.
    """
    held = getattr(lock, "held_by_me", None)
    if held is None:
        return
    owned = held()
    if owned is False:
        raise LockOrderError(
            f"assert_owner: calling thread does not hold "
            f"'{getattr(lock, 'rank_name', '?')}' (held: "
            f"{' -> '.join(held_ranks()) or 'nothing'})"
        )
