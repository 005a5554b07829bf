"""KV reuse in the port vs the JAX engine (CPU): prefix and session caches
and the host spill tier.

Both packages serve llama_tiny with the same weights (bridged with
``params_from_flax``) in f32, with the model's cache or the int8 cache,
and get the same numpy prompts: greedy streams must be identical — a
prefix hit (chunk granularity on the slab, page granularity on the paged
pool), a session's second turn (slab, paged, mono and chunked), a prefix
reloaded from the spill tier. Each engine test also checks that the reuse
path really ran (hit counters, chunk dispatches, borrowed pages) and that
the page pool conserves, with nothing left once the caches are cleared.
The cache classes' unit tests run on both packages' classes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.engine import decode as j_decode
from ray_dynamic_batching_tpu.engine import paging as j_paging
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu_torch.engine import decode as t_decode
from ray_dynamic_batching_tpu_torch.engine import paging as t_paging
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.utils.compile_ledger import get_ledger

torch.set_num_threads(2)

PKGS = {"jax": j_decode, "torch": t_decode}
PAGING = {"jax": j_paging, "torch": t_paging}
KV = {"f32": (None, None), "int8": (jnp.int8, torch.int8)}
NAME = "llama_tiny"


@pytest.fixture(scope="module")
def models():
    jm0 = j_lm.CausalLM(j_lm.TINY_LM, name=NAME, dtype=jnp.float32)
    params = jm0.init(jax.random.PRNGKey(0))
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                             jm0.cfg)
    out = {}
    for kv, (j_kv, t_kv) in KV.items():
        jm = j_lm.CausalLM(j_lm.TINY_LM, name=NAME, dtype=jnp.float32,
                           kv_dtype=j_kv)
        tm = t_lm.CausalLM(t_lm.TINY_LM, name=NAME, dtype=torch.float32,
                           device="cpu", seed=None, kv_dtype=t_kv)
        tm.module.load_state_dict(state)
        out[kv] = (jm, params, tm)
    return out


def _engine(pkg, models, kv="f32", **kw):
    jm, params, tm = models[kv]
    if pkg == "jax":
        q = JQueue(NAME, max_len=256)
        return j_decode.DecodeEngine(jm, params, q, **kw), q
    q = RequestQueue(NAME, max_len=256)
    return t_decode.DecodeEngine(tm, q, device="cpu", **kw), q


def _submit(pkg, q, tokens, **payload):
    cls = JRequest if pkg == "jax" else Request
    req = cls(model=NAME, payload={"tokens": [int(t) for t in tokens],
                                   **payload}, slo_ms=600_000.0)
    q.add_request(req)
    return req


def _serve(engine, pkg, q, tokens, **payload):
    req = _submit(pkg, q, tokens, **payload)
    engine.run_until_idle(timeout_s=300)
    return tuple(req.future.result(timeout=10).tokens)


def _hits(pkg, family, granularity=None):
    tags = {"model": NAME}
    if granularity is not None:
        tags["granularity"] = granularity
    return getattr(PKGS[pkg], family).get(tags=tags)


def _drained(engine):
    """No slot holds a page; clearing the caches frees the whole pool."""
    engine._allocator.check()
    assert all(s.free for s in engine._slots)
    for cache in (engine.paged_prefix, engine.paged_sessions):
        if cache is not None:
            cache.clear()
    engine._allocator.check()
    assert engine._allocator.free_pages == engine.num_pages


def _rand(seed, n):
    return np.random.default_rng(seed).integers(1, 500, n).tolist()


# --- the cache classes, on both packages -------------------------------------
@pytest.mark.parametrize("pkg", list(PKGS))
def test_prefix_cache_lru_eviction(pkg):
    mod = PKGS[pkg]
    z = (jnp.zeros((1,)) if pkg == "jax" else torch.zeros((1,)))
    pc = mod.PrefixCache(capacity=2, width=4)
    a = np.arange(8, dtype=np.int32)
    b, c = a + 1, a + 2
    pc.insert(a, z, z)
    pc.insert(b, z, z)
    assert pc.lookup(a) is not None      # refresh a
    pc.insert(c, z, z)                   # evicts b (LRU)
    assert pc.lookup(b) is None
    assert pc.lookup(a) is not None and pc.lookup(c) is not None
    assert len(pc) == 2


@pytest.mark.parametrize("pkg", list(PKGS))
def test_session_lru_eviction(pkg):
    mod = PKGS[pkg]
    z = (jnp.zeros((1,)) if pkg == "jax" else torch.zeros((1,)))
    seg = (z, z, None, None)
    sc = mod.SessionCache(capacity=2)
    sc.store("a", seg, np.asarray([1, 2], np.int32))
    sc.store("b", seg, np.asarray([3, 4], np.int32))
    assert sc.lookup("a", np.asarray([1, 2, 5], np.int32)) is not None
    sc.store("c", seg, np.asarray([5, 6], np.int32))  # evicts b
    assert sc.lookup("b", np.asarray([3, 4, 5], np.int32)) is None
    assert len(sc) == 2
    # Exact-length (no tail) and non-prefix lookups miss.
    assert sc.lookup("a", np.asarray([1, 2], np.int32)) is None
    assert sc.lookup("a", np.asarray([1, 9, 5], np.int32)) is None


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 500, n).astype(np.int32)


@pytest.mark.parametrize("pkg", list(PAGING))
def test_longest_shared_page_prefix(pkg):
    mod = PAGING[pkg]
    a = mod.PageAllocator(16)
    cache = mod.PagedPrefixCache(capacity=8, page_size=4, allocator=a)
    prompt = _prompt(11)
    pages = a.alloc(3)
    cache.insert(prompt, pages)          # levels 1 (4 tok) and 2 (8 tok)
    other = prompt.copy()
    other[6] += 1
    hit = cache.lookup(np.concatenate([other, other[:4]]))
    assert hit == ([pages[0]], 4)
    assert cache.lookup(np.concatenate([prompt, prompt[:4]])) == (
        [pages[0], pages[1]], 8)
    # A hit leaves >= 1 token to prefill.
    assert cache.lookup(prompt[:8]) == ([pages[0]], 4)


@pytest.mark.parametrize("pkg", list(PAGING))
def test_insert_pins_and_evict_unpins(pkg):
    mod = PAGING[pkg]
    a = mod.PageAllocator(16)
    cache = mod.PagedPrefixCache(capacity=2, page_size=4, allocator=a)
    p1 = _prompt(9, 1)
    pages1 = a.alloc(3)
    cache.insert(p1, pages1)
    assert a.refcount[pages1[0]] == 3    # slot + 2 levels
    a.decref(pages1)
    assert a.free_pages == 16 - 2
    p2 = _prompt(9, 2)
    pages2 = a.alloc(3)
    cache.insert(p2, pages2)
    a.decref(pages2)
    a.check()
    assert cache.lookup(p1) is None
    assert cache.lookup(p2) is not None


@pytest.mark.parametrize("pkg", list(PAGING))
def test_evict_while_pinned_regression(pkg):
    """Evicting an entry a live slot borrowed drops only the cache's ref;
    the page frees when the borrower finishes."""
    mod = PAGING[pkg]
    a = mod.PageAllocator(16)
    cache = mod.PagedPrefixCache(capacity=1, page_size=4, allocator=a)
    p1 = _prompt(6, 3)
    pages1 = a.alloc(2)
    cache.insert(p1, pages1)
    borrowed, _ = cache.lookup(np.concatenate([p1[:4], p1[:3]]))
    a.incref(borrowed)
    a.decref(pages1)
    pages2 = a.alloc(2)
    cache.insert(_prompt(6, 4), pages2)
    assert cache.lookup(p1) is None
    assert a.refcount[borrowed[0]] == 1
    a.check()
    assert a.decref(borrowed) == borrowed
    a.check()


@pytest.mark.parametrize("pkg", list(PAGING))
def test_store_pins_lookup_prefix_rule(pkg):
    mod = PAGING[pkg]
    a = mod.PageAllocator(8)
    cache = mod.PagedSessionCache(capacity=2, page_size=4, allocator=a)
    history = np.arange(1, 8, dtype=np.int32)  # 7 tokens -> 2 pages
    pages = a.alloc(2)
    cache.store("s1", pages, history)
    assert a.refcount[pages[0]] == 2
    a.decref(pages)
    assert a.free_pages == 6
    assert cache.lookup("s1", history) is None
    nxt = np.concatenate([history, [9, 10]]).astype(np.int32)
    assert cache.lookup("s1", nxt) == (list(pages), 7)
    bad = nxt.copy()
    bad[2] += 1
    assert cache.lookup("s1", bad) is None


@pytest.mark.parametrize("pkg", list(PAGING))
def test_restore_replaces_and_unpins_old_turn(pkg):
    mod = PAGING[pkg]
    a = mod.PageAllocator(8)
    cache = mod.PagedSessionCache(capacity=2, page_size=4, allocator=a)
    pages1 = a.alloc(1)
    cache.store("s", pages1, np.arange(1, 5, dtype=np.int32))
    a.decref(pages1)
    pages2 = a.alloc(2)
    cache.store("s", pages2, np.arange(1, 9, dtype=np.int32))
    a.decref(pages2)
    a.check()
    assert a.refcount[pages1[0]] == 0
    assert a.free_pages == 8 - 2


# --- the spill tier's unit invariants, on both packages ----------------------
class _HostPool:
    """A fake device pool: page contents are rows of a numpy array."""

    def __init__(self, num_pages, width=8):
        self.data = np.zeros((num_pages, width), np.float32)

    def read(self, page_ids):
        return {"k": self.data[np.asarray(page_ids, np.int32)].copy()}

    def write(self, page_ids, payload):
        self.data[np.asarray(page_ids, np.int32)] = payload["k"]


def _tier(pkg, capacity=8, num_pages=16):
    mod = PAGING[pkg]
    pool = _HostPool(num_pages)
    journal = mod.PageEventJournal()
    alloc = mod.PageAllocator(num_pages, journal=journal)
    tier = mod.HostSpillTier(capacity, pool.read, pool.write,
                             journal=journal)
    return pool, journal, alloc, tier


def _spill_round_trip(pkg):
    pool, _journal, alloc, tier = _tier(pkg)
    pages = alloc.alloc(3)
    pool.data[pages] = np.arange(3 * 8).reshape(3, 8)
    saved = pool.data[pages].copy()
    assert tier.spill(b"k1", pages, alloc.allocated_pages)
    alloc.decref(pages)
    pool.data[:] = -1.0
    out = tier.reload(b"k1", alloc)
    np.testing.assert_array_equal(pool.data[out], saved)
    assert all(alloc.refcount[p] == 1 for p in out)
    alloc.check()
    assert b"k1" not in tier and tier.pages_held == 0
    return out


def _spill_journaled(pkg):
    _pool, journal, alloc, tier = _tier(pkg)
    pages = alloc.alloc(2)
    tier.spill(b"k1", pages, alloc.allocated_pages)
    alloc.decref(pages)
    tier.reload(b"k1", alloc)
    ev = next(e for e in journal.snapshot() if e["kind"] == "spill")
    assert ev["pages"] == 2 and ev["digest"] == b"k1".hex()
    return [(e["kind"], e["pages"]) for e in journal.snapshot()]


def _spill_lru(pkg):
    _pool, _journal, alloc, tier = _tier(pkg, capacity=4)
    for i in range(4):
        pages = alloc.alloc(2)
        tier.spill(f"k{i}".encode(), pages, alloc.allocated_pages)
        alloc.decref(pages)
    assert tier.pages_held == 4 and len(tier) == 2 and tier.dropped == 2
    assert b"k0" not in tier and b"k3" in tier
    return tier.stats()


def _spill_dry(pkg):
    _pool, _journal, alloc, tier = _tier(pkg, num_pages=4)
    pages = alloc.alloc(3)
    tier.spill(b"k1", pages, alloc.allocated_pages)
    assert tier.reload(b"k1", alloc) is None
    assert b"k1" in tier
    alloc.check()
    return tier.stats()


def _spill_oversized(pkg):
    _pool, _journal, alloc, tier = _tier(pkg, capacity=2)
    assert not tier.spill(b"big", alloc.alloc(3), alloc.allocated_pages)
    assert len(tier) == 0
    return tier.stats()


def _spill_digests(pkg):
    _pool, _journal, alloc, tier = _tier(pkg, capacity=16)
    for i in range(5):
        pages = alloc.alloc(1)
        tier.spill(f"k{i}".encode(), pages, alloc.allocated_pages)
        alloc.decref(pages)
    d = tier.digests(limit=3)
    assert len(d) == 3 and all(v == 1 for v in d.values())
    return d


SPILL_UNITS = {
    "spill_reload_round_trip_is_exact": _spill_round_trip,
    "spill_and_reload_are_journaled": _spill_journaled,
    "lru_bound_in_pages": _spill_lru,
    "reload_declines_when_pool_is_dry": _spill_dry,
    "oversized_entry_refused": _spill_oversized,
    "digest_listing_bounded": _spill_digests,
}


@pytest.mark.parametrize("case", list(SPILL_UNITS))
def test_host_spill_tier_unit(case):
    """Each of the reference's unit invariants holds on the port's tier,
    and both tiers leave the same observable state."""
    assert SPILL_UNITS[case]("torch") == SPILL_UNITS[case]("jax")


# --- engines: greedy streams equal to the JAX engine's -----------------------
SLAB = dict(num_slots=2, max_len=256, prompt_buckets=[32],
            eos_token_id=None, default_max_new_tokens=5, decode_horizon=2)
ARMS = {
    "slab_mono": dict(chunked_prefill=False),
    "slab_chunked": dict(chunked_prefill=True),
    "paged_mono": dict(paged=True, page_size=128, chunked_prefill=False),
    "paged_chunked": dict(paged=True, page_size=128, chunked_prefill=True),
}
REUSE_CASES = [(arm, "f32") for arm in ARMS] + [("slab_mono", "int8"),
                                                 ("paged_chunked", "int8")]


def _session_turns(pkg, models, kv, arm, session_cache_size=4):
    """Turn 1 of 140 tokens, then turn 2 = turn 1 + reply + 3 new tokens
    under the same session id (the stored history, 144 tokens, covers one
    full page); returns (turn-1 tokens, turn-2 tokens, engine,
    long-fill/train chunk dispatches spent on turn 2)."""
    engine, q = _engine(pkg, models, kv, **SLAB, **ARMS[arm],
                        session_cache_size=session_cache_size)
    t1 = _rand(5, 140)
    out1 = _serve(engine, pkg, q, t1, session_id="chat")
    before = _chunks(pkg, engine)
    t2 = t1 + list(out1) + [17, 23, 29]
    out2 = _serve(engine, pkg, q, t2, session_id="chat")
    return out1, out2, engine, _chunks(pkg, engine) - before


def _chunks(pkg, engine):
    """Prefill chunk dispatches the port counts (the JAX engine's are not
    counted here: the port's own counters answer for its reuse)."""
    if pkg == "jax":
        return 0
    return engine.long_chunk_dispatches + engine.chunk_dispatches


@pytest.mark.parametrize("arm,kv", REUSE_CASES)
def test_session_continuation_matches_jax(models, arm, kv):
    """A session's second turn continues from the stored turn — the slab
    row, or the paged turn's full page borrowed by reference — and both
    turns are the JAX engine's tokens; the port's own sessionless engine
    agrees on the whole history, and the hit prefilled only the tail."""
    want1, want2, _je, _d = _session_turns("jax", models, kv, arm)
    hits = _hits("torch", "SESSION_HITS")
    got1, got2, engine, chunks = _session_turns("torch", models, kv, arm)
    assert (got1, got2) == (want1, want2)
    assert _hits("torch", "SESSION_HITS") == hits + 1
    cold1, cold2, _ce, cold_chunks = _session_turns(
        "torch", models, kv, arm, session_cache_size=0)
    assert (cold1, cold2) == (got1, got2)
    # One chunk against five for the whole 148-token prompt: the tail
    # from position 144 (the slab row, the mono paged seed), or from the
    # page boundary (the chunked paged borrow recomputes 20 tokens).
    assert (chunks, cold_chunks) == (1, 5)
    if engine.paged:
        _drained(engine)


def _prefix_pair(pkg, models, kv, arm, prefix_cache_size=4):
    """Two prompts sharing a 140-token head (one full page, four chunks of
    32), served one after the other; returns (tokens, engine, chunk
    dispatches of the second)."""
    engine, q = _engine(pkg, models, kv, **SLAB, **ARMS[arm],
                        prefix_cache_size=prefix_cache_size)
    head = _rand(9, 140)
    out = [_serve(engine, pkg, q, head + _rand(1, 10))]
    before = _chunks(pkg, engine)
    out.append(_serve(engine, pkg, q, head + _rand(2, 7)))
    return out, engine, _chunks(pkg, engine) - before


@pytest.mark.parametrize("arm,kv", REUSE_CASES)
def test_prefix_hit_matches_jax(models, arm, kv):
    """The second prompt reuses the first one's prefix — chunk 0 copied on
    the slab, the full page borrowed on the paged pool — and both streams
    are the JAX engine's and a cache-off engine's."""
    gran = "page" if ARMS[arm].get("paged") else "chunk"
    want, _je, _d = _prefix_pair("jax", models, kv, arm)
    hits = _hits("torch", "PREFIX_HITS", gran)
    got, engine, chunks = _prefix_pair("torch", models, kv, arm)
    assert got == want
    assert _hits("torch", "PREFIX_HITS", gran) == hits + 1
    cold, _ce, cold_chunks = _prefix_pair("torch", models, kv, arm,
                                          prefix_cache_size=0)
    assert cold == got
    if gran == "chunk":
        assert (chunks, cold_chunks) == (4, 5)  # chunk 0 skipped
    else:
        assert (chunks, cold_chunks) == (1, 5)  # the page skipped
        assert engine.paged_prefix is not None and len(engine.paged_prefix)
        _drained(engine)
    if gran == "chunk":
        entry = next(iter(engine.prefix_cache._entries.values()))
        # The segment carries its scale planes on an int8 cache.
        assert (entry[2] is not None) == (kv == "int8")


# --- the paged pool's copy-on-write paths (twins of test_paged_decode) ------
COW = dict(num_slots=4, max_len=192, prompt_buckets=[16, 128],
           eos_token_id=None, default_max_new_tokens=6, decode_horizon=4,
           page_size=128, prefix_cache_size=8, session_cache_size=4)


def _cow_prompts():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, n).tolist()
               for n in (5, 40, 150, 160, 150, 20)]
    prompts[3][:128] = prompts[2][:128]   # shared one-page prefix
    prompts[4] = list(prompts[2])         # identical long prompt
    return prompts


def _cow_run(pkg, models, kv, paged):
    engine, q = _engine(pkg, models, kv, paged=paged, **COW)
    reqs = [_submit(pkg, q, p, max_new_tokens=6,
                    **({"session_id": f"s{i % 2}"} if i >= 4 else {}))
            for i, p in enumerate(_cow_prompts())]
    engine.run_until_idle(timeout_s=300)
    return [tuple(r.future.result(timeout=10).tokens) for r in reqs], engine


@pytest.mark.parametrize("kv", list(KV))
def test_long_prefix_session_exact_and_conserved(models, kv):
    """A shared one-page head and an identical long prompt: the paged
    engine borrows pages, its tokens equal the slab's and the JAX paged
    engine's, and once the caches are cleared the pool is whole."""
    want, _je = _cow_run("jax", models, kv, paged=True)
    before = _hits("torch", "PREFIX_HITS", "page")
    paged, engine = _cow_run("torch", models, kv, paged=True)
    slab, _se = _cow_run("torch", models, kv, paged=False)
    assert paged == want == slab
    assert _hits("torch", "PREFIX_HITS", "page") - before >= 2
    assert engine._allocator.allocated_pages > 0   # the caches' pins
    _drained(engine)


def test_session_store_is_by_reference(models):
    """A finished session turn pins the slot's pages (no row copy); turn
    2 borrows the full page and matches the JAX engine."""
    outs = {}
    for pkg in PKGS:
        engine, q = _engine(pkg, models, paged=True, **COW)
        prompt = _rand(9, 140)
        turn1 = _serve(engine, pkg, q, prompt, max_new_tokens=4,
                       session_id="ref")
        turn2 = prompt + list(turn1) + [7, 8, 9]
        pages, stored = engine.paged_sessions.lookup(
            "ref", np.asarray(turn2, np.int32))
        assert stored == 140 + 4 - 1
        assert all(engine._allocator.refcount[p] >= 1 for p in pages)
        outs[pkg] = (turn1, _serve(engine, pkg, q, turn2, max_new_tokens=4,
                                   session_id="ref"))
        engine._allocator.check()
    assert outs["torch"] == outs["jax"]


def test_session_reservation_covers_only_the_tail(models):
    """With the history's page shared, a pool with one free page still
    admits turn 2 on the hit path (mono paged)."""
    outs = {}
    for pkg in PKGS:
        engine, q = _engine(pkg, models, num_slots=2, max_len=256,
                            prompt_buckets=[8, 16], eos_token_id=None,
                            default_max_new_tokens=3, decode_horizon=1,
                            paged=True, page_size=128, kv_pool_pages=2,
                            session_cache_size=4)
        prompt = _rand(2, 126)
        t1 = _serve(engine, pkg, q, prompt, max_new_tokens=3,
                    session_id="t")
        assert engine._allocator.free_pages == 1
        before = _hits(pkg, "SESSION_HITS")
        t2 = _serve(engine, pkg, q, prompt + list(t1) + [9, 8],
                    max_new_tokens=3, session_id="t")
        assert _hits(pkg, "SESSION_HITS") == before + 1
        engine._allocator.check()
        outs[pkg] = (t1, t2)
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("case", ["session", "prefix"])
def test_chunked_paged_cow_matches_jax(models, case):
    """The chunked paged arm (twins of test_chunked_prefill's CoW tests):
    a session turn whose borrow floors to the page boundary, and two long
    prompts sharing a >1-page head — the JAX engine's tokens, with the
    port's hit counted."""
    kw = dict(num_slots=2, max_len=224, prompt_buckets=[16],
              eos_token_id=None, default_max_new_tokens=5, decode_horizon=2,
              paged=True, page_size=128, chunked_prefill=True)
    outs = {}
    for pkg in PKGS:
        if case == "session":
            engine, q = _engine(pkg, models, session_cache_size=4, **kw)
            t1 = _rand(5, 40)
            o1 = _serve(engine, pkg, q, t1, max_new_tokens=6,
                        session_id="s1")
            before = _hits(pkg, "SESSION_HITS")
            t2 = t1 + list(o1[:-1]) + _rand(6, 9)
            o2 = _serve(engine, pkg, q, t2, max_new_tokens=6,
                        session_id="s1")
            assert _hits(pkg, "SESSION_HITS") == before + 1
            outs[pkg] = (o1, o2)
        else:
            engine, q = _engine(pkg, models, prefix_cache_size=4, **kw)
            head = _rand(9, 130)
            before = _hits(pkg, "PREFIX_HITS", "page")
            outs[pkg] = tuple(_serve(engine, pkg, q, head + _rand(s, 7))
                              for s in (1, 2))
            assert _hits(pkg, "PREFIX_HITS", "page") == before + 1
        engine._allocator.check()
    assert outs["torch"] == outs["jax"]


# --- the spill tier on the engine --------------------------------------------
SPILL = dict(num_slots=4, max_len=192, prompt_buckets=[16, 128],
             eos_token_id=None, default_max_new_tokens=4, decode_horizon=4,
             paged=True, page_size=128, prefix_cache_size=4)


@pytest.mark.parametrize("kv", list(KV))
def test_spill_reload_token_exact_vs_never_spilled(models, kv):
    """Publish a page, shed it to host memory under pressure, reload it
    for the next matching prompt: the tokens equal a never-spilled
    engine's and the JAX engine's spilled run, and the journal tells
    the story."""
    p1 = _rand(11, 150)
    p2 = p1[:128] + _rand(12, 30)
    ctl, cq = _engine("torch", models, kv, **SPILL)
    control = (_serve(ctl, "torch", cq, p1), _serve(ctl, "torch", cq, p2))
    runs = {}
    for pkg in PKGS:
        e, q = _engine(pkg, models, kv, host_spill_pages=8, **SPILL)
        first = _serve(e, pkg, q, p1)
        key = PAGING[pkg].digest_chain(np.asarray(p1, np.int32), 128, 1)[0]
        assert e.paged_prefix.lookup(np.asarray(p2, np.int32)) is not None
        assert e._reclaim_cache_pins()          # spill + evict the pin
        assert key in e.host_spill
        assert e.paged_prefix.lookup(np.asarray(p2, np.int32)) is None
        before = _hits(pkg, "PREFIX_HITS", "page")
        runs[pkg] = (first, _serve(e, pkg, q, p2))
        assert _hits(pkg, "PREFIX_HITS", "page") == before + 1
        kinds = [ev["kind"] for ev in e._page_journal.snapshot()]
        assert "spill" in kinds and "reload" in kinds
        assert e.host_spill.stats()["reloads"] == 1
        if pkg == "torch":
            _drained(e)
    assert runs["torch"] == runs["jax"] == control


def test_reload_writes_the_pool_in_place(models):
    """A reload copies into the existing pool tensors (the captured
    programs hold their addresses) and brings back the spilled bytes."""
    e, q = _engine("torch", models, "int8", host_spill_pages=8, **SPILL)
    p1 = _rand(13, 140)
    _serve(e, "torch", q, p1)
    ptrs = [t.data_ptr() for t in (e._cache.k, e._cache.v,
                                   e._cache.k_scale, e._cache.v_scale)]
    (key, pages), = [(k, list(v)) for k, v in e.paged_prefix._entries.items()]
    saved = e._read_pages(pages)
    assert saved["k"].dtype == torch.int8
    assert saved["k_scale"].shape == (e._cache.k.shape[0], 1, 128,
                                      e._cache.k.shape[3])
    assert e._reclaim_cache_pins()
    back = e.host_spill.reload(key, e._allocator)
    got = e._read_pages(back)
    for name in saved:
        assert torch.equal(got[name], saved[name]), name
    assert ptrs == [t.data_ptr() for t in (e._cache.k, e._cache.v,
                                           e._cache.k_scale,
                                           e._cache.v_scale)]
    e._allocator.decref(back)
    _drained(e)


# --- warmup covers the reuse programs ----------------------------------------
@pytest.mark.parametrize("arm", list(ARMS))
def test_reuse_programs_are_warmed(models, arm):
    """With every cache on, warmup records each reuse program the arm can
    dispatch, and serving prefix hits and session turns afterwards
    records no new episode."""
    engine, q = _engine("torch", models, **SLAB, **ARMS[arm],
                        prefix_cache_size=4, session_cache_size=4,
                        host_spill_pages=(8 if "paged" in arm else 0))
    ledger = get_ledger()
    engine.warmup()
    steady = ledger.counts()
    head = _rand(9, 140)
    for tail in (1, 2):
        _serve(engine, "torch", q, head + _rand(tail, 10))
    out = _serve(engine, "torch", q, head, session_id="w")
    _serve(engine, "torch", q, head + list(out) + [5, 6], session_id="w")
    assert ledger.counts() == steady


def test_session_continuation_through_stack(models):
    """A two-turn chat through the port's controller, router and handle
    (``LLMDeployment(session_cache_size=8)``): turn 2 continues from the
    stored row and equals the JAX engine's sessionless run of the whole
    history."""
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    _jm, _params, tm = models["f32"]
    kw = dict(num_slots=2, max_len=96, prompt_buckets=[8],
              default_max_new_tokens=5)
    controller = ServeController(control_interval_s=0.1)
    dep = LLMDeployment(NAME, model=tm, device="cpu",
                        session_cache_size=8, **kw)
    router = controller.deploy(DeploymentConfig(name="llama_sess"),
                               factory=dep)
    controller.start()
    try:
        handle = DeploymentHandle(router)
        turn1 = [5, 9, 2, 7, 11, 13]
        r1 = handle.remote({"tokens": turn1, "max_new_tokens": 5,
                            "session_id": "c1"}).result(timeout=120)
        hits = _hits("torch", "SESSION_HITS")
        turn2 = turn1 + list(r1.tokens) + [17, 23]
        r2 = handle.remote({"tokens": turn2, "max_new_tokens": 5,
                            "session_id": "c1"}).result(timeout=120)
        assert _hits("torch", "SESSION_HITS") == hits + 1
    finally:
        controller.shutdown()
    engine, q = _engine("jax", models, eos_token_id=None, **kw)
    assert tuple(r2.tokens) == _serve(engine, "jax", q, turn2,
                                      max_new_tokens=5)


@pytest.mark.parametrize("rows", [40, 200])
def test_auto_num_slots_session_term_matches(models, rows):
    """The session cache's rows come off the budget as the reference
    takes them (every length bucket's engine holds its own cache): the
    same slot count as the JAX deployment's; and the replica's multiplex
    bound outlasts the cached turns."""
    from ray_dynamic_batching_tpu.serve.llm import LLMDeployment as JDep
    from ray_dynamic_batching_tpu.utils import config as j_config
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils import config as t_config

    from ray_dynamic_batching_tpu_torch.models.quant import (
        tree_weight_bytes,
    )

    jm, params, tm = models["f32"]
    kw = dict(num_slots=0, max_len=64, prompt_buckets=[8], warmup=False,
              length_buckets=[32, 64])
    # The weights plus ``rows`` KV rows at max_len: at 40 the session
    # rows decide the count, at 200 they do not move it.
    budget = tree_weight_bytes(tm) + rows * tm.kv_bytes_per_slot(64)
    counts = []
    try:
        for mod in (j_config, t_config):
            mod.set_config(mod.RDBConfig.from_env(hbm_budget_bytes=budget))
        for sessions in (0, 4, 16):
            jdep = JDep(NAME, model=jm, params=params,
                        session_cache_size=sessions, **kw)
            dep = LLMDeployment(NAME, model=tm, device="cpu",
                                session_cache_size=sessions, **kw)
            for fraction in (1.0, 0.5):
                assert (dep.auto_num_slots(1, budget_fraction=fraction)
                        == jdep.auto_num_slots(1, budget_fraction=fraction))
            counts.append(dep.auto_num_slots(1))
        assert counts == ([32, 16, 8] if rows == 40 else [128] * 3)
        replica = dep.make_replica("r0", DeploymentConfig(name="s"))
        try:
            assert replica.max_multiplexed_models == 2 * 16 + 8
        finally:
            replica.stop()
    finally:
        j_config.reset_config()
        t_config.reset_config()
