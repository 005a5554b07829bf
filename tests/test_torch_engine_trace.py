"""The decode engine's flight recorder, port against the JAX package.

The port's ``DecodeEngine`` carries the reference's metric families for
its code paths (``rdb_decode_*``) and its three spans: the retroactive
``decode.prefill`` (admit -> first token) and ``decode.turn`` (dispatch
-> the one host fetch, linked to every active sequence), and
``decode.sequence`` at completion; plus ``snapshot()``. On llama_tiny in
f32 (the same weights on both sides) the same requests go through the
JAX engine and the port's on the slab monolithic, paged chunked (full
and tight pool) and slab-train arms, each with its package's collector
installed: the counter deltas, the ``decode.turn`` sequence (horizon,
active count, links), the ``decode.sequence`` attributes and the
snapshot (timings and journal stamps left out) are equal. Every test
resets the tracer in ``finally`` and stops every engine thread it
starts.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.utils import metrics as j_metrics
from ray_dynamic_batching_tpu.utils import tracing as j_tracing
from ray_dynamic_batching_tpu.utils import trace_export as j_export
from ray_dynamic_batching_tpu_torch.engine import decode as t_decode
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.utils import metrics as t_metrics
from ray_dynamic_batching_tpu_torch.utils import tracing as t_tracing
from ray_dynamic_batching_tpu_torch.utils import trace_export as t_export

torch.set_num_threads(2)

MODEL = "llama_tiny"
TAGS = {"model": MODEL}
# Every family the port's engine carries, with its kind.
FAMILIES = {
    "rdb_decode_tokens_total": "Counter",
    "rdb_decode_steps_total": "Counter",
    "rdb_decode_prefills_total": "Counter",
    "rdb_decode_ttft_ms": "Histogram",
    "rdb_decode_ttft_queue_ms": "Histogram",
    "rdb_decode_ttft_prefill_ms": "Histogram",
    "rdb_decode_active_slots": "Gauge",
    "rdb_decode_kv_pages_free": "Gauge",
    "rdb_decode_kv_page_occupancy": "Gauge",
    "rdb_decode_page_evictions_total": "Counter",
    "rdb_decode_prefill_chunks_total": "Counter",
    "rdb_decode_prefill_starved_total": "Counter",
    "rdb_decode_prefill_pending_trains": "Gauge",
}
COUNTERS = [n for n, kind in FAMILIES.items() if kind == "Counter"]

BASE = dict(num_slots=4, max_len=96, prompt_buckets=[8, 16],
            eos_token_id=None, default_max_new_tokens=8, decode_horizon=4)
ARMS = {
    # Bucketed groups plus the long fill for the prompts past 16.
    "slab_mono": dict(BASE, paged=False, chunked_prefill=False),
    "paged_chunked": dict(BASE, paged=True, page_size=128,
                          chunked_prefill=True),
    # Two pages for four slots: trains park on the pool (starved count).
    "paged_tight": dict(BASE, paged=True, page_size=128,
                        chunked_prefill=True, kv_pool_pages=2),
    "slab_train": dict(BASE, paged=False, chunked_prefill=True),
}

PKGS = {
    "jax": dict(metrics=j_metrics, tracing=j_tracing, export=j_export),
    "torch": dict(metrics=t_metrics, tracing=t_tracing, export=t_export),
}


@pytest.fixture(scope="module")
def models():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name=MODEL, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name=MODEL, dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


@pytest.fixture(autouse=True)
def _tracers_reset():
    yield
    j_tracing.tracer().reset()
    t_tracing.tracer().reset()


def _mix(seed=17, n=10):
    """Mostly bucketed prompts, every third one past the largest bucket
    (40-69 tokens: a long fill or a multi-chunk train)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = (int(rng.integers(3, 14)) if i % 3
                else int(rng.integers(40, 70)))
        out.append({"tokens": rng.integers(1, 500, plen).tolist(),
                    "max_new_tokens": 3 + i % 5})
    return out


def _ctx(i):
    return {"trace_id": f"{i + 1:032x}", "parent_span_id": 1000 + i}


def _counters(pkg):
    reg = PKGS[pkg]["metrics"].default_registry()
    return {n: reg.get(n).get(tags=TAGS) for n in COUNTERS}


def _engine(pkg, models, cfg):
    jm, params, tm = models
    if pkg == "jax":
        q = JQueue("j", max_len=256)
        return JEngine(jm, params, q, **cfg), q, JRequest
    q = RequestQueue("t")
    return DecodeEngine(tm, q, device="cpu", **cfg), q, Request


def _serve_traced(pkg, models, cfg, payloads):
    """Serve ``payloads`` with the package's collector installed; returns
    (engine, requests, collected spans, counter deltas)."""
    engine, q, req_cls = _engine(pkg, models, cfg)
    tracing = PKGS[pkg]["tracing"]
    collector = PKGS[pkg]["export"].ChromeTraceCollector()
    before = _counters(pkg)
    tracing.tracer().set_exporter(collector.export)
    try:
        reqs = [req_cls(model=MODEL, payload=p, slo_ms=6e4,
                        trace_ctx=_ctx(i)) for i, p in enumerate(payloads)]
        for r in reqs:
            q.add_request(r)
        engine.run_until_idle(timeout_s=300)
    finally:
        tracing.tracer().reset()
    after = _counters(pkg)
    deltas = {n: after[n] - before[n] for n in COUNTERS}
    return engine, reqs, collector.spans, deltas


def _snapshot_view(snap):
    """A snapshot without timings and journal stamps: the TTFT block
    keeps its count, journal events lose ``t_ms``."""
    out = dict(snap)
    out["ttft"] = {"n": snap["ttft"]["n"]}
    if "page_journal" in out:
        pj = dict(out["page_journal"])
        pj["events"] = [{k: v for k, v in e.items() if k != "t_ms"}
                        for e in pj["events"]]
        out["page_journal"] = pj
    return out


def _record(engine, spans, deltas):
    turns = [(s.attributes["horizon"], s.attributes["active"], len(s.links),
              s.attributes["spec"])
             for s in spans if s.name == "decode.turn"]
    seqs = sorted((s.trace_id, s.attributes["tokens"],
                   s.attributes["finish_reason"])
                  for s in spans if s.name == "decode.sequence")
    return turns, seqs, deltas, _snapshot_view(engine.snapshot())


@pytest.mark.parametrize("arm", list(ARMS))
def test_flight_record_matches_jax_engine(models, arm):
    """The same requests through both engines: equal counter deltas,
    ``decode.turn`` sequences, ``decode.sequence`` attributes and
    snapshots. The reference's snapshot also has a ``fabric`` block in
    paged mode (the page fabric is not ported); every other key is
    equal."""
    cfg = ARMS[arm]
    payloads = _mix()
    j_engine, _r, j_spans, j_deltas = _serve_traced("jax", models, cfg,
                                                    payloads)
    t_engine, reqs, t_spans, t_deltas = _serve_traced("torch", models, cfg,
                                                      payloads)
    want = _record(j_engine, j_spans, j_deltas)
    got = _record(t_engine, t_spans, t_deltas)
    want[3].pop("fabric", None)
    assert got[0] == want[0]           # decode.turn sequence
    assert got[1] == want[1]           # decode.sequence attributes
    assert got[2] == want[2]           # counter deltas
    assert got[3] == want[3]           # snapshot
    # The counters say what the run did.
    results = [r.future.result(timeout=5) for r in reqs]
    assert t_deltas["rdb_decode_tokens_total"] == sum(
        len(r.tokens) for r in results)
    assert t_deltas["rdb_decode_prefills_total"] == len(payloads)
    assert t_deltas["rdb_decode_steps_total"] == t_engine.steps
    assert got[0] and all(spec is False for *_x, spec in got[0])
    if arm == "paged_tight":
        assert t_deltas["rdb_decode_prefill_starved_total"] > 0
    if arm == "slab_mono":
        assert t_deltas["rdb_decode_prefill_chunks_total"] == 0
    else:
        assert t_deltas["rdb_decode_prefill_chunks_total"] > 0


def test_metric_families_are_the_reference_s(models):
    """Name, help text, tag keys, kind and buckets of each family equal
    the JAX package's."""
    j_reg = j_metrics.default_registry()
    t_reg = t_metrics.default_registry()
    for name, kind in FAMILIES.items():
        j, t = j_reg.get(name), t_reg.get(name)
        assert t is not None, name
        assert type(t).__name__ == type(j).__name__ == kind
        assert (t.description, t.tag_keys) == (j.description, j.tag_keys)
        if kind == "Histogram":
            assert t.boundaries == j.boundaries
    assert t_reg.get("rdb_decode_spec_rounds_total") is None


def test_decode_prefill_spans_carry_the_ttft_parts(models):
    """One ``decode.prefill`` per request, in the request's trace, from
    its admission to its first token, with the queue and scan waits the
    engine's TTFT breakdown holds; ``decode.sequence`` carries the
    result's numbers. The TTFT histogram keeps the trace id as its
    exemplar."""
    payloads = _mix(seed=3, n=6)
    engine, reqs, spans, _d = _serve_traced("torch", models,
                                            ARMS["paged_chunked"], payloads)
    prefills = {s.trace_id: s for s in spans if s.name == "decode.prefill"}
    seqs = {s.trace_id: s for s in spans if s.name == "decode.sequence"}
    assert len(prefills) == len(seqs) == len(payloads)
    for i, r in enumerate(reqs):
        ctx = _ctx(i)
        res = r.future.result(timeout=5)
        p, s = prefills[ctx["trace_id"]], seqs[ctx["trace_id"]]
        assert p.parent_id == s.parent_id == ctx["parent_span_id"]
        assert p.start_ms == r.admit_ms and p.end_ms >= p.start_ms
        assert p.attributes["queue_wait_ms"] == round(
            max(0.0, r.admit_ms - r.arrival_ms), 2)
        assert 0.0 <= p.attributes["scan_wait_ms"] <= \
            p.attributes["queue_wait_ms"]
        assert p.attributes["model"] == p.attributes["lane"] == MODEL
        assert s.attributes["tokens"] == len(res.tokens)
        assert s.attributes["finish_reason"] == res.finish_reason
        assert s.attributes["ttft_ms"] == round(res.ttft_ms, 1)
        assert s.attributes["total_ms"] == round(res.total_ms, 1)
    assert engine.ttft_breakdown()["n"] == len(payloads)
    text = t_metrics.default_registry().openmetrics_text()
    assert any(f'trace_id="{_ctx(i)["trace_id"]}"' in text
               for i in range(len(payloads)))


def test_turn_spans_cover_each_dispatch(models):
    """Each ``decode.turn`` spans its dispatch's two stamps and links to
    the ``decode.prefill``'s trace of every sequence it advanced."""
    payloads = _mix(seed=4, n=5)
    engine, _reqs, spans, _d = _serve_traced("torch", models,
                                             ARMS["slab_mono"], payloads)
    turns = [s for s in spans if s.name == "decode.turn"]
    assert sum(s.attributes["horizon"] for s in turns) == engine.steps
    traces = {_ctx(i)["trace_id"] for i in range(len(payloads))}
    for s in turns:
        assert s.end_ms >= s.start_ms
        assert s.parent_id is None and s.trace_id not in traces
        assert len(s.links) == s.attributes["active"] >= 1
        assert {l["trace_id"] for l in s.links} <= traces
    # The last turn's stamps are the engine's last scan window.
    assert (turns[-1].start_ms, turns[-1].end_ms) == (
        engine._scan_start_ms, engine._scan_end_ms)


def test_no_spans_without_an_exporter_and_counters_still_count(models):
    t_tracing.tracer().reset()
    before = _counters("torch")
    engine, q, _cls = _engine("torch", models, ARMS["slab_train"])
    reqs = [Request(model=MODEL, payload=p, slo_ms=6e4, trace_ctx=_ctx(i))
            for i, p in enumerate(_mix(seed=5, n=4))]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=300)
    assert t_tracing.tracer().finished_spans() == []
    after = _counters("torch")
    assert after["rdb_decode_prefills_total"] - \
        before["rdb_decode_prefills_total"] == 4
    assert after["rdb_decode_steps_total"] - \
        before["rdb_decode_steps_total"] == engine.steps


_HOST_FETCHES = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__")


def _count_fetches(monkeypatch, engine):
    """Run one ``_step`` counting the tensor methods that bring device
    values to the host."""
    calls = []
    for name in _HOST_FETCHES:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    try:
        engine._step(horizon=2)
    finally:
        monkeypatch.undo()
    return calls


def test_tracing_adds_no_host_fetch_to_a_step(models, monkeypatch):
    """A decode step with an exporter installed brings back as many
    tensors as one without: the spans use the stamps around the one
    fetch, never a sync of their own."""
    engine, q, _cls = _engine("torch", models, ARMS["paged_chunked"])
    for i, p in enumerate(_mix(seed=6, n=3)):
        q.add_request(Request(model=MODEL, payload={**p,
                                                    "max_new_tokens": 20},
                              slo_ms=6e4, trace_ctx=_ctx(i)))
    engine._admit()
    engine._drain_prefill()
    plain = _count_fetches(monkeypatch, engine)
    collector = t_export.ChromeTraceCollector()
    t_tracing.tracer().set_exporter(collector.export)
    try:
        traced = _count_fetches(monkeypatch, engine)
    finally:
        t_tracing.tracer().reset()
    assert traced == plain == ["cpu", "numpy"]
    assert [s.name for s in collector.spans] == ["decode.turn"]


def test_loop_sets_the_gauges(models):
    """The serving loop sets active slots and the pool's gauges after
    each turn; the pump sets the pending-train depth."""
    engine, q, _cls = _engine("torch", models, ARMS["paged_chunked"])
    reg = t_metrics.default_registry()
    reg.get("rdb_decode_active_slots").set(-1.0, tags=TAGS)
    reg.get("rdb_decode_kv_pages_free").set(-1.0, tags=TAGS)
    reqs = [Request(model=MODEL, payload=p, slo_ms=6e4)
            for p in _mix(seed=8, n=3)]
    engine.start()
    try:
        for r in reqs:
            q.add_request(r)
        for r in reqs:
            r.future.result(timeout=120)
    finally:
        engine.stop(timeout_s=10.0)
    assert engine._thread is None
    active = reg.get("rdb_decode_active_slots").get(tags=TAGS)
    free = reg.get("rdb_decode_kv_pages_free").get(tags=TAGS)
    occ = reg.get("rdb_decode_kv_page_occupancy").get(tags=TAGS)
    assert 0.0 <= active <= engine.num_slots
    assert 0.0 <= free <= engine.num_pages
    assert occ == pytest.approx(1.0 - free / engine.num_pages)
    assert reg.get("rdb_decode_prefill_pending_trains").get(tags=TAGS) == 0.0


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_snapshot_shape(models, paged):
    """The snapshot of an idle engine: the reference's keys, less the
    page fabric's block, and the journal block in paged mode."""
    cfg = ARMS["paged_chunked" if paged else "slab_mono"]
    j_engine, _q, _c = _engine("jax", models, cfg)
    t_engine, _q, _c = _engine("torch", models, cfg)
    want = j_engine.snapshot()
    want.pop("fabric", None)
    got = t_engine.snapshot()
    assert set(got) == set(want)
    assert _snapshot_view(got) == _snapshot_view(want)
    assert got["prefill"]["mode"] == ("chunked" if paged else "mono")
    if paged:
        assert got["page_journal"] == {"events": [], "journal_total": 0,
                                       "journal_rotated": 0}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_chrome_trace_aligns_the_journal_with_turns(models, pkg):
    """The page journal rendered beside the engine's spans (the twin of
    ``tests/test_paging.py``'s Chrome rendering): alloc/free instants and
    a pages-in-use counter on the spans' clock, each inside the window
    from the first queue pop to the last sequence's completion."""
    engine, _reqs, spans, _d = _serve_traced(
        pkg, models, ARMS["paged_chunked"], _mix(seed=9, n=4))
    journal = engine.snapshot()["page_journal"]["events"]
    doc = PKGS[pkg]["export"].to_chrome_trace(spans, journal=journal)
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert {e["name"] for e in instants} == {"alloc", "free"}
    assert len(instants) == len(counters) == len(journal)
    assert all(e["name"] == "kv_pages_in_use" for e in counters)
    assert counters[-1]["args"]["pages"] == 0
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert any(e["name"] == "decode.turn" for e in xs)
    lo = min(e["ts"] for e in xs)
    hi = max(e["ts"] + e["dur"] for e in xs)
    assert all(lo <= e["ts"] <= hi for e in instants)
    assert instants[0]["ts"] == pytest.approx(journal[0]["t_ms"] * 1000.0)


def test_concurrent_exporter_swaps_do_not_break_the_loop(models):
    """An exporter installed and removed while the loop serves: every
    request completes, and every span collected is whole."""
    engine, q, _cls = _engine("torch", models, ARMS["slab_train"])
    collector = t_export.ChromeTraceCollector()
    reqs = [Request(model=MODEL, payload=p, slo_ms=6e4, trace_ctx=_ctx(i))
            for i, p in enumerate(_mix(seed=10, n=6))]
    stop = threading.Event()

    def toggle():
        while not stop.is_set():
            t_tracing.tracer().set_exporter(collector.export)
            time.sleep(0.001)
            t_tracing.tracer().reset()
            time.sleep(0.001)

    toggler = threading.Thread(target=toggle, daemon=True)
    engine.start()
    toggler.start()
    try:
        for r in reqs:
            q.add_request(r)
        results = [r.future.result(timeout=120) for r in reqs]
    finally:
        stop.set()
        toggler.join(timeout=5)
        engine.stop(timeout_s=10.0)
    assert not toggler.is_alive() and engine._thread is None
    assert all(len(r.tokens) >= 1 for r in results)
    assert all(s.end_ms is not None and s.end_ms >= s.start_ms
               for s in collector.spans)


def test_engine_module_names_the_families():
    for name in FAMILIES:
        assert any(getattr(v, "name", None) == name
                   for v in vars(t_decode).values()), name
