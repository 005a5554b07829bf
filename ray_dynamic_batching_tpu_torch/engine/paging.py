"""Paged-KV bookkeeping: the free-list page allocator and the
copy-on-write stores, host side.

Port of ``ray_dynamic_batching_tpu/engine/paging.py`` plus ``pages_for``
and ``spec_scratch_pages`` from ``ops/tile_math.py`` (own copies: the
port imports nothing of the JAX package). The DEVICE half is the page pool of
``models/decoder.py::PagedKVCache`` (k/v ``[L, P + 1, ps, K, H]``)
gathered through per-slot page tables; this module owns which pages
belong to whom:

- :class:`PageAllocator` — a FIFO free list with refcounts. A page is
  either free (refcount 0, on the list) or held by 1+ owners; ``decref``
  returns it to the list only when the last owner lets go; allocation is
  all-or-nothing; a double free raises. ``check()`` asserts conservation
  (``free + allocated == num_pages``) at any point.
- :class:`PageEventJournal` — a bounded ring of allocator events.
- :func:`digest_chain` — the chained page digests that name a prompt
  prefix everywhere (prefix cache, spill tier, the router's directory).
- :class:`PagedPrefixCache` — every full page of an admitted prompt
  published under its chain digest; a lookup returns the longest shared
  page-prefix, borrowed by reference (copy-on-write).
- :class:`PagedSessionCache` — a finished turn's pages pinned under its
  session id (an incref, no row copy).
- :class:`HostSpillTier` — shed prefix entries' page contents kept in
  host memory and reloaded into fresh pages on the next match; the
  engine binds its page IO to pinned host tensors.
- :func:`table_array` — a slot's page list as a fixed-width table row,
  unallocated entries carrying the sentinel ``P``.

Numpy only, like the reference.
"""

from __future__ import annotations

import collections
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def pages_for(length: int, page_size: int) -> int:
    """Pages needed to hold ``length`` cached positions (ceil division)."""
    if length <= 0:
        return 0
    return -(-int(length) // int(page_size))


def spec_scratch_pages(length: int, spec_window: int,
                       page_size: int, capacity: int) -> int:
    """Pages a speculative verify round needs a slot's table to cover: the
    round writes the ``spec_window`` (= spec_tokens + 1) positions
    ``[length, length + spec_window)``, clamped to the slot's logical
    ``capacity``. The one rule of the engine's per-round scratch
    reservation and of its admission headroom, so the two never disagree
    about a round's page demand."""
    return pages_for(min(int(length) + int(spec_window), int(capacity)),
                     page_size)


def digest_chain(prompt: np.ndarray, page_size: int,
                 max_n: Optional[int] = None) -> List[bytes]:
    """Chained page-digest keys for ``prompt``: ``keys[j-1]`` covers
    pages ``[0, j)`` and is ``blake2b(page_j_tokens + keys[j-2])`` — one
    O(L) pass over the prompt bytes, 16 bytes retained per level.

    This is THE prefix identity of the whole stack: the per-engine
    :class:`PagedPrefixCache` keys its entries with it, the host-RAM
    spill tier keys spilled page runs with it, and the router's digest
    directory matches request prompts against replica publications with
    it — one function, so the three can never disagree on what "same
    prefix" means."""
    if max_n is None:
        max_n = int(prompt.size) // int(page_size)
    keys: List[bytes] = []
    prev = b""
    ps = int(page_size)
    for n in range(1, max_n + 1):
        page = np.ascontiguousarray(prompt[(n - 1) * ps: n * ps]).tobytes()
        prev = hashlib.blake2b(page + prev, digest_size=16).digest()
        keys.append(prev)
    return keys


class OutOfPages(Exception):
    """The pool cannot supply the requested pages (over-subscribed KV
    pool under load)."""


class PageEventJournal:
    """Bounded ring of allocator events (alloc, free, eviction, ...),
    each stamped with the monotonic clock in ms. ``total`` counts every
    event ever recorded, so ``total - len(ring)`` rotated out."""

    KINDS = ("alloc", "free", "cow_copy", "cache_reclaim", "eviction",
             "spill", "reload", "spec_commit", "spec_reject",
             "migrate_out", "migrate_in", "push_out", "push_in")

    def __init__(self, capacity: int = 4096) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.total = 0

    def record(self, kind: str, pages: int, pages_in_use: int,
               t_ms: Optional[float] = None, **detail) -> None:
        if kind not in self.KINDS:
            raise ValueError(
                f"unknown journal event kind {kind!r} (known: {self.KINDS})"
            )
        if t_ms is None:
            t_ms = time.monotonic() * 1000.0
        ev = {"t_ms": float(t_ms), "kind": kind, "pages": int(pages),
              "pages_in_use": int(pages_in_use)}
        ev.update(detail)
        self._ring.append(ev)
        self.total += 1

    def snapshot(self) -> List[dict]:
        return list(self._ring)

    @property
    def rotated_out(self) -> int:
        return self.total - len(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


class PageAllocator:
    """Fixed pool of KV pages: FIFO free list + per-page refcounts.

    ``alloc`` is all-or-nothing; ``incref`` adds an owner to a held page
    (an incref of a free page raises); ``decref`` removes one and frees
    the page when its count reaches zero (a decref of a free page is a
    double free and raises). FIFO reuse keeps a freed page's contents
    intact longest, so a use-after-free shows in tests."""

    def __init__(self, num_pages: int,
                 journal: Optional[PageEventJournal] = None):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: collections.deque = collections.deque(
            range(self.num_pages)
        )
        self.refcount: List[int] = [0] * self.num_pages
        self.journal = journal

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self.num_pages - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh pages (refcount 1 each); all-or-nothing."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)}/{self.num_pages} free"
            )
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            self.refcount[p] = 1
        if self.journal is not None and out:
            self.journal.record("alloc", len(out), self.allocated_pages)
        return out

    def incref(self, pages: Sequence[int]) -> None:
        """Add an owner to pages that are already held."""
        for p in pages:
            if self.refcount[p] <= 0:
                raise ValueError(
                    f"incref of free page {p} — share must happen while "
                    "the original owner still holds it"
                )
        for p in pages:
            self.refcount[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Drop one ownership per page; returns the pages freed."""
        freed: List[int] = []
        for p in pages:
            if self.refcount[p] <= 0:
                raise ValueError(f"decref of free page {p} (double free)")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        if self.journal is not None and freed:
            self.journal.record("free", len(freed), self.allocated_pages)
        return freed

    def check(self) -> None:
        """Assert the conservation invariants: no page on the free list
        twice, free + allocated == num_pages, no negative refcount, and a
        page is on the free list iff its refcount is zero."""
        free = list(self._free)
        if len(set(free)) != len(free):
            raise AssertionError(f"free list holds duplicates: {free}")
        if len(free) + self.allocated_pages != self.num_pages:
            raise AssertionError(
                f"conservation broken: {len(free)} free + "
                f"{self.allocated_pages} allocated != {self.num_pages}"
            )
        free_set = set(free)
        for p, rc in enumerate(self.refcount):
            if rc < 0:
                raise AssertionError(f"page {p} refcount {rc} < 0")
            if (rc == 0) != (p in free_set):
                raise AssertionError(
                    f"page {p} refcount {rc} but "
                    f"{'on' if p in free_set else 'off'} the free list"
                )


class _PinnedLRU:
    """Bounded LRU whose values hold PINNED page ids: insertion increfs,
    eviction/replacement decrefs — the cache's own reference, distinct
    from any slot's. Shared mechanics for the prefix and session stores
    so pin/unpin symmetry cannot diverge between them."""

    def __init__(self, capacity: int, allocator: PageAllocator):
        self.capacity = int(capacity)
        self.allocator = allocator
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def _pages_of(self, value) -> Sequence[int]:
        raise NotImplementedError

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (page-pressure reclaim:
        cache pins are optimizations, and under pool pressure the engine
        sheds them before truncating live streams). Returns False when
        empty. Note the decref may free nothing if a borrower still
        holds the pages — the caller loops."""
        if not self._entries:
            return False
        _, evicted = self._entries.popitem(last=False)
        self.allocator.decref(self._pages_of(evicted))
        return True

    def peek_lru(self):
        """(key, value) of the entry :meth:`evict_lru` would drop next,
        or None — the spill tier reads the victim's pages BEFORE the
        eviction releases the cache's pin on them."""
        if not self._entries:
            return None
        key = next(iter(self._entries))
        return key, self._entries[key]

    def _get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def _put(self, key, value) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self.allocator.decref(self._pages_of(old))
        self.allocator.incref(self._pages_of(value))
        self._entries[key] = value
        while len(self._entries) > self.capacity:
            _, evicted = self._entries.popitem(last=False)
            # Evict-while-pinned: this drops ONLY the cache's ref. Pages
            # still shared into a live slot keep that slot's refcount and
            # stay resident until it finishes — freeing them here would
            # hand an in-use page to the next admission (the refcount
            # leak class the regression test pins).
            self.allocator.decref(self._pages_of(evicted))

    def clear(self) -> None:
        while self._entries:
            _, evicted = self._entries.popitem(last=False)
            self.allocator.decref(self._pages_of(evicted))

    def __len__(self) -> int:
        return len(self._entries)


class PagedPrefixCache(_PinnedLRU):
    """Page-granular prompt-prefix index (the paged successor of the
    chunk-granular ``decode.PrefixCache``).

    Insertion publishes EVERY full-page prefix of an admitted prompt:
    level ``j`` is keyed by a digest CHAIN — level j's key is
    ``blake2b(page_j_tokens + key_{j-1})`` — so computing all L/ps level
    keys of a prompt costs one O(L) pass (each token byte is hashed
    once), not the O(L^2/ps) of re-serializing every prefix, and the
    store retains 16-byte digests instead of whole prefix byte-strings.
    Lookup probes from the longest possible level down, so a hit is the
    *longest shared page-prefix* — byte-equality of whole prompts is no
    longer required (satellite: page-granular keying). A hit must leave
    >= 1 token to prefill (the tail drives the first sampled logits),
    hence the strict ``< prompt_len`` bound.
    """

    def __init__(self, capacity: int, page_size: int,
                 allocator: PageAllocator):
        super().__init__(capacity, allocator)
        self.page_size = int(page_size)
        # Per-entry hit counts (bumped on lookup hits at the level that
        # matched): the push-replication planner's hotness ranking —
        # ``hot()`` orders what THIS pool can export by demand actually
        # observed here. Bounded lazily against 4x capacity so counters
        # of long-evicted entries cannot accumulate forever.
        self._hits: Dict[bytes, int] = {}

    def _pages_of(self, value) -> Sequence[int]:
        return value

    def _level_keys(self, prompt: np.ndarray, max_n: int) -> List[bytes]:
        """Chained level keys: keys[j-1] covers pages [0, j). One pass
        over the prompt bytes total (module-level :func:`digest_chain` —
        shared with the spill tier and the router's digest directory)."""
        return digest_chain(prompt, self.page_size, max_n)

    def digests(self, limit: int = 128) -> Dict[str, int]:
        """Bounded digest publication for cluster-wide prefix routing:
        the ``limit`` most-recently-used entries as ``{digest_hex:
        chain_len}``. O(1) per entry (the 16-byte level key IS the
        identity — no token bytes leave the replica), recency-bounded so
        a replica advertises what its pool actually still holds."""
        out: Dict[str, int] = {}
        for key in reversed(self._entries):
            if len(out) >= limit:
                break
            out[key.hex()] = len(self._entries[key])
        return out

    def lookup(self, prompt: np.ndarray) -> Optional[Tuple[List[int], int]]:
        """Longest shared page-prefix: ``(page_ids, shared_len)`` with
        ``shared_len == len(page_ids) * page_size < prompt.size``, or
        None."""
        max_n = (int(prompt.size) - 1) // self.page_size
        keys = self._level_keys(prompt, max_n)
        for n in range(max_n, 0, -1):
            entry = self._get(keys[n - 1])
            if entry is not None:
                key = keys[n - 1]
                self._hits[key] = self._hits.get(key, 0) + 1
                if len(self._hits) > 4 * self.capacity:
                    self._hits = {k: v for k, v in self._hits.items()
                                  if k in self._entries}
                return list(entry), n * self.page_size
        return None

    def insert(self, prompt: np.ndarray, page_ids: Sequence[int]) -> None:
        """Publish every full-page prefix of ``prompt`` whose pages are
        in ``page_ids`` (the admitting slot's table, still held by the
        slot — incref happens per level inside ``_put``)."""
        n_full = min(int(prompt.size) // self.page_size, len(page_ids))
        for n, key in enumerate(self._level_keys(prompt, n_full), start=1):
            if key not in self._entries:
                self._put(key, tuple(page_ids[:n]))

    def install(self, key: bytes, page_ids: Sequence[int]) -> bool:
        """Publish ONE entry under a pre-computed digest ``key`` — the
        fabric-push install path. A peer replica ships pages addressed
        by the chain digest alone (16 bytes; token bytes never leave
        their replica), so the receiver cannot recompute level keys —
        it trusts the digest the way the router's directory already
        does. ``page_ids`` must be held by the caller (refcount >= 1);
        ``_put`` increfs the cache's own pin, the caller then drops its
        hold — pin symmetry identical to a spill reload republishing.
        Returns False (and pins nothing) when the key is already
        present — a duplicate push refreshes recency instead."""
        if key in self._entries:
            self._get(key)
            return False
        self._put(key, tuple(page_ids))
        return True

    def hot(self, limit: int = 8) -> List[Tuple[str, int, int]]:
        """The ``limit`` hottest RESIDENT entries as ``(digest_hex,
        chain_len, hits)``, hit-rank ordered, zero-hit entries elided —
        what the push planner considers worth replicating from here."""
        ranked = sorted(
            (k for k in self._entries if self._hits.get(k, 0) > 0),
            key=lambda k: -self._hits.get(k, 0),
        )
        return [(k.hex(), len(self._entries[k]), self._hits.get(k, 0))
                for k in ranked[:limit]]


class PagedSessionCache(_PinnedLRU):
    """Session-id -> pinned page run of the finished turn.

    ``store`` pins the pages covering the stored history instead of
    copying the KV row out of the cache (the slab SessionCache's
    per-turn full-row device copy disappears); ``lookup`` returns the
    page run + history length when the stored turn is a strict prefix
    of the next prompt, exactly the slab semantics."""

    def __init__(self, capacity: int, page_size: int,
                 allocator: PageAllocator):
        super().__init__(capacity, allocator)
        self.page_size = int(page_size)

    def _pages_of(self, value) -> Sequence[int]:
        return value[0]

    def lookup(self, session_id: str, prompt: np.ndarray
               ) -> Optional[Tuple[List[int], int]]:
        """``(page_ids, stored_len)`` when the stored turn strictly
        prefixes ``prompt`` (>= 1 tail token left to prefill)."""
        entry = self._get(session_id)
        if entry is None:
            return None
        pages, history = entry
        n = int(history.size)
        if n >= prompt.size or not np.array_equal(history, prompt[:n]):
            return None
        return list(pages), n

    def store(self, session_id: str, page_ids: Sequence[int],
              history: np.ndarray) -> None:
        """Pin the pages covering ``history`` under ``session_id``.
        Call while the finishing slot still holds its pages (incref
        before the slot's decref — the pages must never transit
        refcount 0)."""
        n = pages_for(int(history.size), self.page_size)
        self._put(session_id,
                  (tuple(page_ids[:n]), np.asarray(history, np.int32)))


class HostSpillTier:
    """Device-memory → host-memory eviction tier for prefix pages.

    When pool pressure sheds a prefix-cache pin, the entry's page
    CONTENTS move to host RAM (keyed by the same chained digest as the
    HBM entry) instead of vanishing — a later prompt sharing that prefix
    reloads the pages into freshly allocated HBM and skips the prefill
    recompute. Hot system prompts therefore survive pool churn AND
    replica churn: the digest keys a replica publishes to the router
    include its spilled entries, so cluster-wide prefix routing keeps
    steering matching prompts here.

    Page IO is injected (``read_pages(page_ids) -> payload``,
    ``write_pages(page_ids, payload)``) so this stays numpy-only and
    testable without a device; the engine binds them to gather/scatter
    on its device page pool. Every spill and reload is journaled like
    any other allocator event — the tier is part of the page pool's
    flight record, not a side channel.

    Bounded by ``capacity_pages`` of host residency, LRU within the
    bound. An entry is REMOVED on reload (its pages are back in HBM and
    the prefix cache re-publishes them); re-spilling on the next
    pressure wave re-reads the then-current contents.
    """

    def __init__(
        self,
        capacity_pages: int,
        read_pages: Callable[[List[int]], Dict[str, np.ndarray]],
        write_pages: Callable[[List[int], Dict[str, np.ndarray]], None],
        journal: Optional[PageEventJournal] = None,
    ) -> None:
        if capacity_pages <= 0:
            raise ValueError(
                f"capacity_pages must be positive, got {capacity_pages}"
            )
        self.capacity_pages = int(capacity_pages)
        self._read = read_pages
        self._write = write_pages
        self.journal = journal
        # digest key (bytes) -> (payload, n_pages), LRU order.
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self.pages_held = 0
        self.spills = 0
        self.reloads = 0
        self.dropped = 0  # entries LRU-evicted from the tier itself
        # Digests whose pages came BACK from host RAM since the last
        # publication drain. A reload moves the entry between tiers
        # without changing the union the replica advertises, so the
        # directory's replacement-expiry sees "unchanged" and skips the
        # long-poll notify — out-of-process routers would never converge
        # after a spill round-trip. The controller drains this via
        # ``prefix_digests`` and forces the push.
        self._republish: List[str] = []

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def spill(self, key: bytes, page_ids: Sequence[int],
              pages_in_use: int) -> bool:
        """Copy ``page_ids``' contents to host under ``key``. Call
        BEFORE the HBM eviction drops the pin (the pages must still be
        intact). Returns False when the key is already spilled (the
        caller may proceed straight to the eviction)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        n = len(page_ids)
        if n > self.capacity_pages:
            return False  # one oversized entry cannot fit; don't thrash
        payload = self._read(list(page_ids))
        self._entries[key] = (payload, n)
        self.pages_held += n
        self.spills += 1
        if self.journal is not None:
            self.journal.record("spill", n, pages_in_use,
                                digest=key.hex())
        while self.pages_held > self.capacity_pages:
            _, (_, n_drop) = self._entries.popitem(last=False)
            self.pages_held -= n_drop
            self.dropped += 1
        return True

    def reload(self, key: bytes,
               allocator: PageAllocator) -> Optional[List[int]]:
        """Allocate fresh pages and copy the spilled contents back into
        HBM; returns the page ids (refcount 1, owned by the caller) or
        None when the key is absent or the pool cannot supply the pages
        right now (the caller falls back to recompute — a reload must
        never deepen the pressure that caused the spill)."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        payload, n = entry
        if not allocator.can_alloc(n):
            return None
        page_ids = allocator.alloc(n)
        self._write(page_ids, payload)
        del self._entries[key]
        self.pages_held -= n
        self.reloads += 1
        self._republish.append(key.hex())
        if self.journal is not None:
            self.journal.record("reload", n, allocator.allocated_pages,
                                digest=key.hex())
        return page_ids

    def drain_republish(self) -> List[str]:
        """Digests reloaded since the last drain (cleared on read): the
        cluster-wide republish signal the controller's digest push path
        consumes — see ``_republish``'s note on why tier moves must
        force a directory notify even though the advertised set is
        unchanged."""
        out, self._republish = self._republish, []
        return out

    def digests(self, limit: int = 128) -> Dict[str, int]:
        """Spilled entries as ``{digest_hex: chain_len}`` — published to
        the router alongside the HBM prefix cache's digests, because a
        spilled prefix is still servable here (one reload vs a full
        prefill recompute elsewhere)."""
        out: Dict[str, int] = {}
        for key in reversed(self._entries):
            if len(out) >= limit:
                break
            out[key.hex()] = self._entries[key][1]
        return out

    def clear(self) -> None:
        self._entries.clear()
        self.pages_held = 0
        self._republish.clear()

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries),
                "pages_held": self.pages_held,
                "spills": self.spills, "reloads": self.reloads,
                "dropped": self.dropped}


def table_array(pages: Sequence[int], n_entries: int,
                sentinel: int) -> np.ndarray:
    """A slot's page list as a fixed-width int32 table row: unallocated
    tail entries carry ``sentinel`` (= pool size, one past the last real
    page), so writes through them land in the pool's sink page and reads
    clamp into masked-off territory."""
    out = np.full((n_entries,), sentinel, dtype=np.int32)
    k = min(len(pages), n_entries)
    out[:k] = pages[:k]
    return out
