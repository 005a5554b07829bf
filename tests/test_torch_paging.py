"""Port page allocator vs the JAX package's (host-side, exact).

The same random sequence of alloc / incref / decref operations, made from
a numpy seed, drives both ``PageAllocator``s: returned page ids,
refcounts, free lists and errors must be identical after every operation,
and ``check()`` must hold on both. Integers, so no tolerance.
"""

import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine import paging as j_paging
from ray_dynamic_batching_tpu.ops.tile_math import pages_for as j_pages_for
from ray_dynamic_batching_tpu_torch.engine import paging as t_paging

torch.set_num_threads(2)


def _outcome(fn, *args):
    """(result, exception type name) of one allocator call."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 — compared, not swallowed
        return None, type(e).__name__


@pytest.mark.parametrize("seed", range(6))
def test_random_ops_match_jax_allocator(seed):
    rng = np.random.default_rng(seed)
    num_pages = int(rng.integers(4, 40))
    jp = j_paging.PageAllocator(num_pages, journal=j_paging.PageEventJournal())
    tp = t_paging.PageAllocator(num_pages, journal=t_paging.PageEventJournal())
    held = []   # page lists handed out, in order
    for _ in range(2500):
        op = rng.integers(0, 6)
        if op <= 1 or not held:
            n = int(rng.integers(0, num_pages // 2 + 2))   # over-allocs too
            got = _outcome(tp.alloc, n)
            want = _outcome(jp.alloc, n)
            assert got == want
            if got[0]:
                held.append(list(got[0]))
        elif op == 2:
            pages = held[int(rng.integers(len(held)))]
            assert _outcome(tp.incref, pages) == _outcome(jp.incref, pages)
            held.append(list(pages))
        elif op == 3 and rng.random() < 0.1:
            # A double free (or a decref of a page already recycled).
            pages = [int(rng.integers(num_pages))]
            assert _outcome(tp.decref, pages) == _outcome(jp.decref, pages)
        else:
            pages = held.pop(int(rng.integers(len(held))))
            assert _outcome(tp.decref, pages) == _outcome(jp.decref, pages)
        assert tp.refcount == jp.refcount
        assert list(tp._free) == list(jp._free)
        assert (tp.free_pages, tp.allocated_pages) == (jp.free_pages,
                                                       jp.allocated_pages)
        tp.check()
        jp.check()
    assert tp.journal.total == jp.journal.total
    assert [(e["kind"], e["pages"], e["pages_in_use"])
            for e in tp.journal.snapshot()] == [
        (e["kind"], e["pages"], e["pages_in_use"])
        for e in jp.journal.snapshot()]


def test_loud_errors_match_jax():
    for mod in (t_paging, j_paging):
        a = mod.PageAllocator(3)
        pages = a.alloc(2)
        with pytest.raises(mod.OutOfPages):
            a.alloc(2)
        assert a.free_pages == 1                 # all-or-nothing
        a.decref(pages)
        with pytest.raises(ValueError, match="double free"):
            a.decref(pages[:1])
        with pytest.raises(ValueError, match="incref of free page"):
            a.incref(pages[:1])
        with pytest.raises(ValueError):
            a.alloc(-1)
        with pytest.raises(ValueError):
            mod.PageAllocator(0)
        a.check()


@pytest.mark.parametrize("n_pages,n_entries,sentinel", [
    (0, 4, 64), (3, 4, 64), (4, 4, 64), (6, 4, 9), (1, 1, 1),
])
def test_table_array_matches_jax(n_pages, n_entries, sentinel):
    pages = list(range(7, 7 + n_pages))
    got = t_paging.table_array(pages, n_entries, sentinel)
    want = j_paging.table_array(pages, n_entries, sentinel)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pages_for_matches_jax():
    for length in [-3, 0, 1, 127, 128, 129, 512, 513, 4097]:
        for ps in (1, 16, 128, 256):
            assert t_paging.pages_for(length, ps) == j_pages_for(length, ps)


def test_journal_rings_and_refuses_unknown_kinds():
    j = t_paging.PageEventJournal(capacity=3)
    for i in range(5):
        j.record("alloc", 1, i)
    assert len(j) == 3 and j.total == 5 and j.rotated_out == 2
    with pytest.raises(ValueError, match="unknown journal event kind"):
        j.record("nope", 0, 0)
