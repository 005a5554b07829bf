"""Paged-KV bookkeeping: the free-list page allocator, host side.

Port of ``ray_dynamic_batching_tpu/engine/paging.py`` (its allocator
half) plus ``pages_for`` from ``ops/tile_math.py``. The DEVICE half is the
page pool of ``models/decoder.py::PagedKVCache`` (k/v ``[L, P + 1, ps, K,
H]``) gathered through per-slot page tables; this module owns which pages
belong to whom:

- :class:`PageAllocator` — a FIFO free list with refcounts. A page is
  either free (refcount 0, on the list) or held by 1+ owners; ``decref``
  returns it to the list only when the last owner lets go; allocation is
  all-or-nothing; a double free raises. ``check()`` asserts conservation
  (``free + allocated == num_pages``) at any point.
- :class:`PageEventJournal` — a bounded ring of allocator events.
- :func:`table_array` — a slot's page list as a fixed-width table row,
  unallocated entries carrying the sentinel ``P``.

The prefix and session caches and the host spill tier (``PagedPrefixCache``,
``PagedSessionCache``, ``HostSpillTier``, ``digest_chain``) come with the
caches themselves in a later slice. Numpy only, like the reference.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence

import numpy as np


def pages_for(length: int, page_size: int) -> int:
    """Pages needed to hold ``length`` cached positions (ceil division)."""
    if length <= 0:
        return 0
    return -(-int(length) // int(page_size))


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
