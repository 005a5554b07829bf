"""The port's KV page fabric vs the JAX package's (CPU): live stream
migration, prefix push, queue books, parcel plumbing.

A stream frozen mid-decode, shipped to a peer engine and resumed there
emits exactly the tokens of the unmigrated run — on the port's f32 and
int8 caches, greedy and sampled rows with penalties and bias (a sampled
token's noise is a function of (base seed, request seed, token index),
all carried by the parcel). Greedy streams equal the JAX engine's too,
and a parcel the JAX engine exports mid-stream, copied field by field
into the port's parcel, finishes on the port byte-identically to the JAX
engine's straight run: both packages' payloads share the reference's
layout and dtypes. Also: refused and failed deliveries leave the source
untouched, prefix pushes install with pin symmetry, the spill tier's
republish signal, the queues' migration books, two-phase allocator moves
fuzzed against a shadow model (both packages' allocators), the journal's
fabric kinds, and one migration between two replicas of one deployment
through ``KVPageFabric.migrate``.
"""

import dataclasses
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.engine import pagefabric as j_fabric
from ray_dynamic_batching_tpu.engine import paging as j_paging
from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.utils import trace_export as j_trace
from ray_dynamic_batching_tpu_torch.engine import pagefabric as t_fabric
from ray_dynamic_batching_tpu_torch.engine import paging as t_paging
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.kv_fabric import KVPageFabric
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
from ray_dynamic_batching_tpu_torch.utils import trace_export as t_trace

torch.set_num_threads(2)

NAME = "llama_tiny"
KV = {"f32": (None, None), "int8": (jnp.int8, torch.int8)}
PAGING = {"jax": j_paging, "torch": t_paging}


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


BASE = dict(num_slots=8, max_len=96, prompt_buckets=[8, 16],
            eos_token_id=None, default_max_new_tokens=8, decode_horizon=4,
            paged=True, page_size=128)


def _engine(models, kv="f32", pkg="torch", **kw):
    jm, params, tm = models[kv]
    cfg = {**BASE, **kw}
    if pkg == "jax":
        q = JQueue(NAME, max_len=256)
        return JEngine(jm, params, q, **cfg), q
    q = RequestQueue(NAME, max_len=256)
    return DecodeEngine(tm, q, device="cpu", **cfg), q


def _payloads(sampled, n=4, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = {"tokens": rng.integers(1, 500, int(rng.integers(4, 14))).tolist(),
             "max_new_tokens": int(rng.integers(10, 20))}
        if sampled and i == n - 1:
            # Every sampling field the parcel must carry.
            p.update(temperature=0.8, top_k=16, seed=123,
                     presence_penalty=0.5, frequency_penalty=0.25,
                     logit_bias={3: 1.5})
        out.append(p)
    return out


def _submit_all(q, payloads, pkg="torch"):
    cls = JRequest if pkg == "jax" else Request
    reqs = [cls(model=NAME, payload=dict(p), slo_ms=600_000.0)
            for p in payloads]
    for r in reqs:
        q.add_request(r)
    return reqs


def _tokens(reqs):
    return [tuple(r.future.result(timeout=10).tokens) for r in reqs]


def _drive_until_live(engine, want, iters=60):
    """Hand-step the engine until ``want`` streams are past their first
    token without letting any finish."""
    for _ in range(iters):
        engine._admit()
        engine._pump_prefill()
        if engine._active_mask.any():
            engine._step()
        if len(engine.live_stream_ids()) >= want:
            return
    raise AssertionError(f"never reached {want} live streams")


def _straight(models, kv, payloads, pkg="torch"):
    engine, q = _engine(models, kv, pkg)
    reqs = _submit_all(q, payloads, pkg)
    engine.run_until_idle(timeout_s=600)
    return _tokens(reqs)


def _migrated(models, kv, payloads):
    a, qa = _engine(models, kv)
    b, qb = _engine(models, kv)
    reqs = _submit_all(qa, payloads)
    _drive_until_live(a, want=len(reqs))
    for rid in a.live_stream_ids():
        assert a.request_migration(rid, b.accept_parcel)
    a._service_fabric()
    b.run_until_idle(timeout_s=600)
    a.run_until_idle(timeout_s=600)
    return reqs, a, qa, b, qb


@pytest.mark.parametrize("kv,sampled", [
    ("f32", False), ("f32", True), ("int8", False), ("int8", True),
])
def test_straight_vs_migrated_byte_identical(models, kv, sampled):
    payloads = _payloads(sampled)
    ref = _straight(models, kv, payloads)
    reqs, a, _qa, b, _qb = _migrated(models, kv, payloads)
    assert _tokens(reqs) == ref
    if not sampled:
        assert ref == _straight(models, kv, payloads, pkg="jax")
    assert a.migrated_out == b.migrated_in == len(reqs)
    for engine in (a, b):
        engine._allocator.check()
        assert engine._allocator.free_pages == engine.num_pages


def test_books_and_journal_after_migration(models):
    reqs, a, qa, b, qb = _migrated(models, "f32", _payloads(False))
    _tokens(reqs)
    sa, sb = qa.stats(), qb.stats()
    assert sa["enqueued"] == sa["completed"] + sa["migrated_out"]
    assert sa["migrated_out"] == float(len(reqs))
    assert sb["migrated_in"] == float(len(reqs))
    assert sb["enqueued"] == sb["completed"] == float(len(reqs))
    out = [e for e in a._page_journal.snapshot()
           if e["kind"] == "migrate_out"]
    inn = [e for e in b._page_journal.snapshot()
           if e["kind"] == "migrate_in"]
    assert len(out) == len(inn) == len(reqs)
    assert all(e["bytes"] > 0 for e in out)
    instants = [e for e in t_trace.journal_to_chrome_events(out, pid=1)
                if e["ph"] == "i"]
    assert instants and all(e["name"] == "migrate_out"
                            and e["args"]["bytes"] > 0 for e in instants)
    assert a.snapshot()["fabric"]["migrated_out"] == len(reqs)
    assert b.snapshot()["fabric"]["migrated_in"] == len(reqs)


def test_failed_delivery_leaves_source_untouched(models):
    a, qa = _engine(models)
    reqs = _submit_all(qa, _payloads(False))
    _drive_until_live(a, want=len(reqs))
    live = a.live_stream_ids()
    before = {i: list(s.pages) for i, s in enumerate(a._slots)
              if not s.free}

    def dies(parcel):
        raise RuntimeError("courier died")

    assert a.request_migration(live[0], lambda parcel: False)
    assert a.request_migration(live[1], dies)
    a._service_fabric()
    assert a.migrated_out == 0
    assert {i: list(s.pages) for i, s in enumerate(a._slots)
            if not s.free} == before
    a.run_until_idle(timeout_s=600)
    assert [len(t) for t in _tokens(reqs)] == [
        r.payload["max_new_tokens"] for r in reqs]
    qs = qa.stats()
    assert "migrated_out" not in qs
    assert qs["enqueued"] == qs["completed"]


def test_refuses_mismatched_and_oversized_parcels(models):
    b, _ = _engine(models)

    def parcel(**kw):
        base = dict(kind=t_fabric.STREAM, page_size=b.page_size,
                    cache_len=8, payload={}, request=object(),
                    generated=[1], max_new_tokens=4)
        base.update(kw)
        return t_fabric.PageParcel(**base)

    assert not b.accept_parcel(parcel(page_size=b.page_size * 2))
    assert not b.accept_parcel(parcel(cache_len=90, max_new_tokens=200))
    assert not b.accept_parcel(parcel(
        sampling={"temperature": 0.7, "base_seed": b.base_seed + 1}))
    assert b.accept_parcel(parcel(
        sampling={"temperature": 0.0, "base_seed": b.base_seed + 1}))
    with b._fabric_lock:
        b._parcel_in_q.clear()
    slab, _ = _engine(models, paged=False)
    assert not slab.accept_parcel(parcel())
    assert slab.live_stream_ids() == []


PUSH = dict(num_slots=2, max_len=384, prompt_buckets=[128],
            prefix_cache_size=16)


def _publish_twice(engine, q, prompt, pkg="torch"):
    for _ in range(2):   # publish, then hit: hot() ranks proven reuse
        req, = _submit_all(q, [{"tokens": prompt, "max_new_tokens": 4}],
                           pkg)
        engine.run_until_idle(timeout_s=600)
        req.future.result(timeout=10)


def test_push_installs_digest_direct_with_pin_symmetry(models):
    a, qa = _engine(models, **PUSH)
    b, _ = _engine(models, **PUSH)
    prompt = list(range(1, 257))
    _publish_twice(a, qa, prompt)
    hexkey, n_pages, _hits = a.paged_prefix.hot(limit=4)[0]
    key = bytes.fromhex(hexkey)
    parcel = t_fabric.export_prefix_parcel(a, key)
    assert parcel.kind == t_fabric.PREFIX
    assert parcel.digest == key and parcel.n_pages == n_pages
    assert b.accept_parcel(parcel)
    b.run_until_idle(timeout_s=600)
    assert b.pushes_in == 1
    pages = list(b.paged_prefix._entries[key])
    assert all(b._allocator.refcount[p] == 1 for p in pages)
    assert any(e["kind"] == "push_in" for e in b._page_journal.snapshot())
    b._allocator.check()
    # The peer now hits the pushed prefix.
    hit = b.paged_prefix.lookup(np.asarray(prompt, np.int32))
    assert hit is not None and hit[1] == n_pages * 128
    # A duplicate push is a no-op.
    assert b.accept_parcel(parcel)
    b.run_until_idle(timeout_s=600)
    assert b.pushes_in == 1
    assert list(b.paged_prefix._entries[key]) == pages


def test_spill_reload_republish_signal(models):
    a, qa = _engine(models, host_spill_pages=16, **PUSH)
    prompt = list(range(1, 257))
    req, = _submit_all(qa, [{"tokens": prompt, "max_new_tokens": 4}])
    a.run_until_idle(timeout_s=600)
    req.future.result(timeout=10)
    key = next(iter(a.paged_prefix._entries))
    pages = list(a.paged_prefix._entries[key])
    assert a.host_spill.spill(key, pages, a._allocator.allocated_pages)
    assert a.host_spill.reload(key, a._allocator) is not None
    pub = a.prefix_digests()
    assert pub.get("reloaded") == [key.hex()]
    assert "reloaded" not in a.prefix_digests()


def test_stats_elide_until_first_migration():
    q = RequestQueue("m", max_len=8)
    assert "migrated_out" not in q.stats()
    assert "migrated_in" not in q.stats()
    r = Request(model="m", payload={"tokens": [1]}, slo_ms=1e6)
    q.add_request(r)
    q.note_migrated_out(r)
    q.note_migrated_in(Request(model="m", payload={"tokens": [1]},
                               slo_ms=1e6))
    s = q.stats()
    assert s["migrated_out"] == 1.0 and s["migrated_in"] == 1.0
    assert s["enqueued"] == 2.0


def _fuzz(mod):
    """Seeded random ops across two allocators with two-phase parcel
    moves against a shadow owner model; returns the final free counts
    per step checkpoint (the trajectory both packages must share)."""
    rng = np.random.default_rng(0)
    pools = {"a": mod.PageAllocator(48), "b": mod.PageAllocator(48)}
    owners, exporting, next_id, trace = {}, {}, 0, []
    for step in range(3_000):
        op = rng.integers(0, 5)
        if op == 0:
            name = ("a", "b")[int(rng.integers(0, 2))]
            n = int(rng.integers(1, 7))
            try:
                owners[next_id] = (name, pools[name].alloc(n))
                next_id += 1
            except mod.OutOfPages:
                assert pools[name].free_pages < n
        elif op == 1 and owners:
            idle = [k for k in owners if k not in exporting]
            if idle:
                k = idle[int(rng.integers(0, len(idle)))]
                name, pages = owners.pop(k)
                pools[name].decref(pages)
        elif op == 2 and owners:
            k = list(owners)[int(rng.integers(0, len(owners)))]
            name, pages = owners[k]
            take = int(rng.integers(1, len(pages) + 1))
            pools[name].incref(pages[:take])
            owners[next_id] = (name, list(pages[:take]))
            next_id += 1
        elif op == 3 and owners:
            idle = [k for k in owners if k not in exporting]
            if idle:
                k = idle[int(rng.integers(0, len(idle)))]
                exporting[k] = "b" if owners[k][0] == "a" else "a"
        elif op == 4 and exporting:
            k = list(exporting)[int(rng.integers(0, len(exporting)))]
            dst = exporting.pop(k)
            src, pages = owners[k]
            if pools[dst].can_alloc(len(pages)) and rng.integers(0, 4):
                newp = pools[dst].alloc(len(pages))
                pools[src].decref(pages)
                owners[k] = (dst, newp)
        for name, a in pools.items():
            a.check()
            counts = {}
            for pname, pages in owners.values():
                if pname == name:
                    for p in pages:
                        counts[p] = counts.get(p, 0) + 1
            assert all(a.refcount[p] == counts.get(p, 0)
                       for p in range(a.num_pages))
        if step % 100 == 0:
            trace.append((pools["a"].free_pages, pools["b"].free_pages))
    for name, pages in owners.values():
        pools[name].decref(pages)
    assert all(a.free_pages == a.num_pages for a in pools.values())
    return trace


def test_export_import_fuzz_against_shadow():
    assert _fuzz(t_paging) == _fuzz(j_paging)


def test_fabric_kinds_accepted_and_rendered():
    j = t_paging.PageEventJournal()
    for kind in ("migrate_out", "migrate_in", "push_out", "push_in"):
        j.record(kind, 3, 10, bytes=4096, request="r-1")
    events = t_trace.journal_to_chrome_events(j.snapshot(), pid=7)
    names = [e["name"] for e in events if e["ph"] == "i"]
    assert names == ["migrate_out", "migrate_in", "push_out", "push_in"]
    assert all(e["args"]["bytes"] == 4096
               for e in events if e["ph"] == "i")
    ref = j_paging.PageEventJournal()
    for ev in j.snapshot():
        ref.record(ev["kind"], ev["pages"], ev["pages_in_use"],
                   t_ms=ev["t_ms"], bytes=4096, request="r-1")
    assert j_trace.journal_to_chrome_events(ref.snapshot(), pid=7) == events


# --- across the two packages -------------------------------------------------
def _jax_live(models, kv, payloads):
    """A JAX engine driven until every stream is past its first token."""
    e, q = _engine(models, kv, pkg="jax")
    reqs = _submit_all(q, payloads, pkg="jax")
    _drive_until_live(e, want=len(reqs))
    return e, q, reqs


def _as_port_parcel(jp, request):
    """The JAX parcel, field by field, into the port's parcel (its numpy
    payload becomes host tensors; the live request is the port's)."""
    fields = {f.name: getattr(jp, f.name)
              for f in dataclasses.fields(j_fabric.PageParcel)}
    fields["payload"] = {k: torch.from_numpy(np.array(v))
                         for k, v in jp.payload.items()}
    fields["request"] = request
    return t_fabric.PageParcel(**fields)


@pytest.mark.parametrize("kv", list(KV))
def test_jax_exported_parcel_finishes_on_the_port(models, kv):
    """Each stream the JAX engine exports mid-decode is imported by the
    port engine and finishes exactly as the JAX engine's straight run."""
    payloads = _payloads(False)
    want = _straight(models, kv, payloads, pkg="jax")
    je, _jq, jreqs = _jax_live(models, kv, payloads)
    b, qb = _engine(models, kv)
    reqs = []
    for i, s in enumerate(je._slots):
        if s.free:
            continue
        jp = j_fabric.export_stream_parcel(je, i)
        req = Request(model=NAME, payload=dict(s.request.payload),
                      slo_ms=600_000.0)
        reqs.append((next(k for k, r in enumerate(jreqs)
                          if r is s.request), req))
        assert b.accept_parcel(_as_port_parcel(jp, req))
    b.run_until_idle(timeout_s=600)
    got = {i: tuple(r.future.result(timeout=10).tokens) for i, r in reqs}
    assert [got[i] for i in range(len(payloads))] == want
    assert b.migrated_in == len(payloads)
    b._allocator.check()
    assert b._allocator.free_pages == b.num_pages


@pytest.mark.parametrize("kv", list(KV))
def test_parcel_layout_is_the_reference_s(models, kv):
    """The same stream exported by both engines at the same point: the
    same keys, shapes and dtypes, equal resume state, and page contents
    within f32 rounding (int8 codes within one step)."""
    payloads = _payloads(False)
    je, _jq, _jr = _jax_live(models, kv, payloads)
    te, tq = _engine(models, kv)
    _submit_all(tq, payloads)
    _drive_until_live(te, want=len(payloads))
    idx = next(i for i, s in enumerate(te._slots) if not s.free)
    jp = j_fabric.export_stream_parcel(je, idx)
    tp = t_fabric.export_stream_parcel(te, idx)
    assert sorted(jp.payload) == sorted(tp.payload)
    for name, arr in jp.payload.items():
        got = tp.payload[name]
        assert tuple(got.shape) == arr.shape
        assert str(got.dtype).split(".")[-1] == str(arr.dtype)
        tol = 1.0 if got.dtype == torch.int8 else 1e-4
        np.testing.assert_allclose(got.numpy().astype(np.float64),
                                   arr.astype(np.float64), atol=tol)
    for f in ("cache_len", "generated", "max_new_tokens", "digest",
              "n_pages"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.nbytes == jp.nbytes


def test_courier_migrates_between_replicas_of_one_deployment(models):
    """``KVPageFabric.migrate`` moves one live stream between two
    replicas of one deployment (engine threads running); it finishes on
    the destination with the straight run's tokens, and the books of
    both replicas' queues conserve."""
    _jm, _params, tm = models["f32"]
    dep = LLMDeployment(NAME, model=tm, device="cpu", num_slots=4,
                        max_len=96, prompt_buckets=[8, 16],
                        default_max_new_tokens=80, decode_horizon=1,
                        paged=True, page_size=128)
    cfg = DeploymentConfig(name="llm")
    src, dst = dep.make_replica("r0", cfg), dep.make_replica("r1", cfg)
    payload = {"tokens": list(range(3, 15)), "max_new_tokens": 80}
    want = _straight(models, "f32", [payload])[0]
    fabric = KVPageFabric()
    src.start()
    dst.start()
    try:
        req = Request(model=NAME, payload=payload, slo_ms=600_000.0)
        assert src.assign(req)
        deadline = time.monotonic() + 60
        while not src.live_stream_ids():
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert fabric.migrate(src, dst, req.request_id)
        got = tuple(req.future.result(timeout=60).tokens)
        assert got == want
        assert fabric.stats()["parcels_shipped"] == 1
        assert src.engine.migrated_out == dst.engine.migrated_in == 1
        s_src = src.stats()["bucket_96"]
        s_dst = dst.stats()["bucket_96"]
        assert s_src["enqueued"] == s_src["migrated_out"] == 1.0
        assert s_dst["enqueued"] == s_dst["completed"] == 1.0
    finally:
        src.stop()
        dst.stop()
