"""The hop ledger, the trace export and the sim's reports, port against
the JAX package.

``utils/hops.py``, ``utils/trace_export.py`` and ``sim/report.py`` are
the reference's modules copied whole into the port. Each scenario here
runs on both packages and the outputs must be equal: the decomposer
cases of ``tests/test_hops.py`` (canonical tree, overlap, linked batch
and turn spans, failover, window overflow, skipped traces, the two
``LedgerError`` checks, the closed taxonomy), its seeded conservation
fuzz, its export truncation accounting and ``format_ledger_table``; the
committed capture ``tools/budgets/fixture_spans.jsonl`` through both
readers and decomposers (identical ledgers, hop by hop); the Chrome
rendering and summary of that capture; and the drift report and the
report helpers on the same sketches and dicts.
"""

import dataclasses
import json
import os
import random

import pytest

from ray_dynamic_batching_tpu.sim import report as j_report
from ray_dynamic_batching_tpu.utils import hops as j_hops
from ray_dynamic_batching_tpu.utils import metrics as j_metrics
from ray_dynamic_batching_tpu.utils import sketch as j_sketch
from ray_dynamic_batching_tpu.utils import trace_export as j_export
from ray_dynamic_batching_tpu.utils import tracing as j_tracing
from ray_dynamic_batching_tpu_torch.sim import report as t_report
from ray_dynamic_batching_tpu_torch.utils import hops as t_hops
from ray_dynamic_batching_tpu_torch.utils import metrics as t_metrics
from ray_dynamic_batching_tpu_torch.utils import sketch as t_sketch
from ray_dynamic_batching_tpu_torch.utils import trace_export as t_export
from ray_dynamic_batching_tpu_torch.utils import tracing as t_tracing

PKGS = {
    "jax": dict(hops=j_hops, export=j_export, tracing=j_tracing,
                metrics=j_metrics, report=j_report, sketch=j_sketch),
    "torch": dict(hops=t_hops, export=t_export, tracing=t_tracing,
                  metrics=t_metrics, report=t_report, sketch=t_sketch),
}

FIXTURE_SPANS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "budgets", "fixture_spans.jsonl",
)


class _Pkg:
    def __init__(self, name):
        self.name = name
        for k, v in PKGS[name].items():
            setattr(self, k, v)

    def S(self, name, trace_id, span_id, parent_id, start, end, links=()):
        return self.tracing.Span(
            name=name, trace_id=trace_id, span_id=span_id,
            parent_id=parent_id, start_ms=float(start), end_ms=float(end),
            links=[{"trace_id": "peer", "span_id": l} for l in links],
        )


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; the outputs must be
    equal. Returns the port's."""
    out = {name: scenario(_Pkg(name), *args) for name in PKGS}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _view(ledger):
    return None if ledger is None else dataclasses.asdict(ledger)


# --- the decomposer ---------------------------------------------------------

def _canonical(p):
    S = p.S
    return _view(p.hops.decompose([
        S("proxy.request", "t", 1, 999, 0, 100),
        S("handle.remote", "t", 2, 1, 2, 10),
        S("router.assign", "t", 3, 2, 3, 8),
        S("queue.wait", "t", 4, 2, 10, 40),
        S("engine.request", "t", 5, 2, 42, 90),
    ]))


def test_canonical_request_tree():
    ledger = _both(_canonical)
    assert ledger["root"] == "proxy.request"
    assert ledger["hops"] == {"handle.remote": 3.0, "router.assign": 5.0,
                              "queue.wait": 30.0, "engine.step": 48.0}
    assert ledger["unattributed_ms"] == 14.0
    assert ledger["end_ms"] - ledger["start_ms"] == 100.0


def _overlap(p):
    S = p.S
    return _view(p.hops.decompose([
        S("proxy.request", "t", 1, None, 0, 50),
        S("queue.wait", "t", 2, 1, 5, 30),
        S("engine.request", "t", 3, 1, 28, 45),
    ]))


def test_overlap_resolves_to_the_deeper_hop():
    ledger = _both(_overlap)
    assert ledger["hops"] == {"queue.wait": 23.0, "engine.step": 17.0}
    assert sum(ledger["hops"].values()) + ledger["unattributed_ms"] == 50.0


def _linked(p):
    S = p.S
    spans = [
        S("handle.remote_stream", "t", 1, None, 0, 100),
        S("queue.wait", "t", 2, 1, 0, 30),
        S("decode.prefill", "t", 3, 1, 30, 50),
    ]
    linked = [
        S("batch.form", "b", 50, None, 25, 30, links=[2]),
        S("decode.turn", "b2", 60, None, 50, 95, links=[3]),
    ]
    return _view(p.hops.decompose(spans, linked))


def test_linked_batch_and_decode_turn_spans_attribute():
    ledger = _both(_linked)
    assert ledger["hops"] == {"batch.form": 5.0, "queue.wait": 25.0,
                              "decode.prefill": 20.0, "decode.turn": 45.0}
    assert ledger["unattributed_ms"] == 5.0


def _failover(p):
    S = p.S
    return _view(p.hops.decompose([
        S("handle.remote", "t", 1, None, 0, 100),
        S("router.assign", "t", 2, 1, 1, 5),
        S("queue.wait", "t", 3, 1, 5, 20),
        S("failover.redispatch", "t", 4, 1, 30, 60),
        S("router.assign", "t", 5, 1, 40, 55),
        S("queue.wait", "t", 6, 1, 60, 80),
    ]))


def test_failover_redispatch_outranks_router_assign():
    ledger = _both(_failover)
    assert ledger["hops"]["failover"] == 30.0
    assert ledger["hops"]["router.assign"] == 4.0
    assert ledger["hops"]["queue.wait"] == 35.0


def _outside(p):
    S = p.S
    return _view(p.hops.decompose([
        S("handle.remote", "t", 1, None, 0, 10),
        S("queue.wait", "t", 2, 1, 5, 25),
    ]))


def test_spans_outside_window_are_reported_not_conserved():
    ledger = _both(_outside)
    assert ledger["hops"] == {"queue.wait": 5.0}
    assert ledger["outside_window_ms"] == 15.0


def _skipped(p):
    spans = [p.S("queue.wait", "t", 1, None, 0, 10)]
    ledgers, skipped = p.hops.request_ledgers(spans)
    relaxed = p.hops.decompose(spans, require_front_door=False)
    return (_view(p.hops.decompose(spans)), ledgers, skipped,
            _view(relaxed))


def test_non_front_door_traces_are_skipped():
    strict, ledgers, skipped, relaxed = _both(_skipped)
    assert strict is None and ledgers == [] and skipped == 1
    assert relaxed["root"] == "queue.wait"


def _bad_ledger(p, hops, residual):
    ledger = p.hops.HopLedger(trace_id="t", root="proxy.request",
                              start_ms=0.0, end_ms=10.0, hops=hops,
                              unattributed_ms=residual)
    with pytest.raises(p.hops.LedgerError) as info:
        ledger.check()
    return str(info.value)


@pytest.mark.parametrize("hops,residual,match", [
    ({"queue.wait": -1.0}, 11.0, "negative hop"),
    ({"queue.wait": 3.0}, 3.0, "conserve"),
], ids=["negative", "nonconserving"])
def test_bad_ledgers_raise(hops, residual, match):
    assert match in _both(_bad_ledger, hops, residual)


def test_taxonomy_is_the_reference_s():
    """The taxonomy is identical name for name: budgets and drift
    reports speak these hop names."""
    for attr in ("HOP_SPANS", "HOP_ORDER", "HOP_RANK", "SPAN_TO_HOP",
                 "FRONT_DOOR_SPANS", "DISPATCH_HOPS", "UNATTRIBUTED"):
        assert getattr(t_hops, attr) == getattr(j_hops, attr), attr
    assert set(t_hops.SPAN_TO_HOP.values()) == set(t_hops.HOP_ORDER)
    assert [t_hops.HOP_RANK[h] for h in t_hops.HOP_ORDER] == list(
        range(len(t_hops.HOP_ORDER)))
    assert issubclass(t_hops.LedgerError, AssertionError)


# --- conservation, fuzzed -----------------------------------------------------

def _random_trace(p, rng, trace_id):
    fd = p.hops.FRONT_DOOR_SPANS
    e2e = rng.uniform(10.0, 500.0)
    t0 = rng.uniform(0, 1000.0)
    spans = [p.S(rng.choice(sorted(fd)), trace_id, 1, None, t0, t0 + e2e)]
    linked = []
    sid = 2
    hop_names = [n for n in p.hops.SPAN_TO_HOP if n not in fd]
    for _ in range(rng.randrange(0, 12)):
        name = rng.choice(hop_names)
        a = t0 + rng.uniform(-20.0, e2e)
        b = a + rng.uniform(0.0, e2e)
        if rng.random() < 0.3:
            linked.append(p.S(name, f"peer{sid}", 100 + sid, None, a, b,
                              links=[1]))
        else:
            spans.append(p.S(name, trace_id, sid, 1, a, b))
        sid += 1
    return spans, linked


def _fuzz(p):
    rng = random.Random(1234)
    out = []
    for i in range(300):
        spans, linked = _random_trace(p, rng, f"t{i}")
        out.append(_view(p.hops.decompose(spans, linked)))
    return out


def test_fuzzed_ledgers_conserve_and_agree():
    ledgers = _both(_fuzz)
    assert len(ledgers) == 300 and all(l is not None for l in ledgers)
    for l in ledgers:
        assert all(v >= 0.0 for v in l["hops"].values())
        e2e = l["end_ms"] - l["start_ms"]
        assert sum(l["hops"].values()) + l["unattributed_ms"] == \
            pytest.approx(e2e, abs=1e-6)


def _fuzz_capture(p):
    rng = random.Random(99)
    all_spans = []
    for i in range(40):
        spans, linked = _random_trace(p, rng, f"t{i}")
        all_spans.extend(spans + linked)
    rng.shuffle(all_spans)
    ledgers, skipped = p.hops.request_ledgers(all_spans)
    return [_view(l) for l in ledgers], skipped


def test_fuzzed_capture_through_request_ledgers():
    ledgers, _skipped = _both(_fuzz_capture)
    assert len(ledgers) == 40


# --- the committed capture -----------------------------------------------------

def _fixture(p):
    spans = p.export.read_spans_jsonl(FIXTURE_SPANS)
    return spans, p.hops.request_ledgers(spans)


def test_fixture_capture_gives_identical_ledgers():
    """The committed capture through both packages' readers and
    decomposers: the same traces, every hop's ms and the residual equal
    within 1e-9."""
    _js, (j_ledgers, j_skipped) = _fixture(_Pkg("jax"))
    _ts, (t_ledgers, t_skipped) = _fixture(_Pkg("torch"))
    assert t_skipped == j_skipped
    assert [l.trace_id for l in t_ledgers] == [l.trace_id for l in j_ledgers]
    assert len(t_ledgers) > 0
    for a, b in zip(t_ledgers, j_ledgers):
        assert set(a.hops) == set(b.hops)
        for hop in a.hops:
            assert abs(a.hops[hop] - b.hops[hop]) <= 1e-9
        assert abs(a.unattributed_ms - b.unattributed_ms) <= 1e-9
        assert (a.root, a.start_ms, a.end_ms) == (b.root, b.start_ms,
                                                  b.end_ms)
        a.check()


def _fixture_reads(p):
    spans, (ledgers, _s) = _fixture(p)
    served = [l for l in ledgers if p.hops.is_served(l)]
    sketches = p.hops.hop_sketches(served)
    quantiles = {hop: (sk.count, sk.quantile(0.5), sk.quantile(0.95))
                 for hop, sk in sketches.items()}
    return (len(served), quantiles, p.hops.format_ledger_table(ledgers),
            p.export.read_export_header(FIXTURE_SPANS),
            p.export.trace_summary(spans))


def test_fixture_sketches_table_header_and_summary_agree():
    n_served, quantiles, table, header, summary = _both(_fixture_reads)
    assert n_served > 0 and "queue.wait" in quantiles
    head = table.splitlines()[0]
    assert head.index("queue.wait") < head.index(t_hops.UNATTRIBUTED) \
        < head.index("e2e_ms")
    assert header["truncated"] is False


def _fixture_chrome(p):
    spans, _l = _fixture(p)
    doc = p.export.to_chrome_trace(spans)
    round_trip = [p.export.span_to_dict(p.export.span_from_dict(
        p.export.span_to_dict(s))) for s in spans]
    return json.loads(json.dumps(doc)), round_trip


def test_fixture_chrome_trace_and_round_trip_agree():
    doc, round_trip = _both(_fixture_chrome)
    events = doc["traceEvents"]
    assert any(e["ph"] == "X" for e in events)
    starts = [e["id"] for e in events if e["ph"] == "s"]
    assert sorted(starts) == sorted(e["id"] for e in events
                                    if e["ph"] == "f")
    assert len(round_trip) == len(t_export.read_spans_jsonl(FIXTURE_SPANS))


def _table_order(p):
    ledgers = [p.hops.HopLedger(trace_id="abc", root="proxy.request",
                                start_ms=0.0, end_ms=10.0,
                                hops={"queue.wait": 4.0, "engine.step": 5.0},
                                unattributed_ms=1.0)]
    return p.hops.format_ledger_table(ledgers)


def test_format_ledger_table_columns_follow_hop_order():
    table = _both(_table_order)
    assert table.index("queue.wait") < table.index("engine.step")


# --- export truncation accounting ---------------------------------------------

def _dropped(p, sink):
    return p.metrics.default_registry().get(
        "rdb_trace_dropped_spans_total").get(tags={"sink": sink})


def _collector_truncation(p):
    before = _dropped(p, "collector")
    c = p.export.ChromeTraceCollector(cap=3)
    for i in range(5):
        c.export(p.S("queue.wait", "t", i + 1, None, 0, 1))
    return (len(c.spans), c.dropped, c.chrome_trace()["metadata"],
            _dropped(p, "collector") - before)


def test_collector_counts_and_stamps_truncation():
    kept, dropped, meta, counted = _both(_collector_truncation)
    assert (kept, dropped, counted) == (3, 2, 2)
    assert meta == {"truncated": True, "dropped_spans": 2}


def _collector_clean(p):
    c = p.export.ChromeTraceCollector(cap=10)
    c.export(p.S("queue.wait", "t", 1, None, 0, 1))
    return c.chrome_trace()["metadata"]


def test_collector_untruncated_header():
    assert _both(_collector_clean) == {"truncated": False,
                                       "dropped_spans": 0}


def _file_truncation(p, tmp_path):
    path = str(tmp_path / f"{p.name}.jsonl")
    before = _dropped(p, "jsonl")
    ex = p.export.FileSpanExporter(path, max_spans=2)
    for i in range(4):
        ex.export(p.S("queue.wait", "t", i + 1, None, 0, 1))
    ex.close()
    ex.export(p.S("queue.wait", "t", 9, None, 0, 1))  # post-close
    return (p.export.read_export_header(path),
            len(p.export.read_spans_jsonl(path)),
            _dropped(p, "jsonl") - before)


def test_file_exporter_header_rewritten_on_close(tmp_path):
    header, n, counted = _both(_file_truncation, tmp_path)
    assert header == {"truncated": True, "spans": 2, "dropped": 2}
    assert n == 2 and counted == 3


def _file_clean(p, tmp_path):
    path = str(tmp_path / f"clean_{p.name}.jsonl")
    ex = p.export.FileSpanExporter(path)
    ex.export(p.S("queue.wait", "t", 1, None, 0, 1))
    ex.close()
    return p.export.read_export_header(path)


def test_clean_capture_header_says_untruncated(tmp_path):
    assert _both(_file_clean, tmp_path) == {"truncated": False, "spans": 1,
                                            "dropped": 0}


def _journal_lane(p):
    journal = [
        {"t_ms": 10.0, "kind": "alloc", "pages": 4, "pages_in_use": 4},
        {"t_ms": 12.5, "kind": "eviction", "pages": 2, "pages_in_use": 2,
         "slot": 1},
        {"t_ms": 20.0, "kind": "free", "pages": 2, "pages_in_use": 0},
    ]
    turn = p.S("decode.turn", "b", 7, None, 11.0, 19.0)
    return json.loads(json.dumps(p.export.to_chrome_trace([turn],
                                                          journal=journal)))


def test_journal_lane_renders_alike():
    doc = _both(_journal_lane)
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert [e["name"] for e in instants] == ["alloc", "eviction", "free"]
    assert [e["args"]["pages"] for e in counters] == [4, 2, 0]
    assert instants[0]["ts"] == pytest.approx(10.0 * 1000.0)


# --- the sim's reports ----------------------------------------------------------

def _sketches(p, values, n=20):
    out = {}
    for hop, v in values.items():
        sk = p.sketch.QuantileSketch()
        for _ in range(n):
            sk.observe(v)
        out[hop] = sk
    return out


def _drift(p):
    live = _sketches(p, {"queue.wait": 100.0, "engine.step": 100.0})
    sim = _sketches(p, {"queue.wait": 100.0, "engine.step": 300.0})
    return p.report.hop_drift_report(live, sim, tolerance=0.5)


def test_drift_report_names_the_mispriced_hop():
    diff = _both(_drift)
    assert diff["drifting_hops"] == ["engine.step"]
    assert diff["hops"]["queue.wait"]["ok"] and not diff["ok"]


def _one_sided(p):
    live = _sketches(p, {"proxy.request": 5.0}, n=10)
    return p.report.hop_drift_report(live, {}, tolerance=0.5)


def test_hops_missing_on_one_side_are_ungraded_not_silent():
    diff = _both(_one_sided)
    assert diff["ok"] and diff["ungraded"] == {
        "proxy.request": {"live_count": 10, "sim_count": 0}}


class _SimQueue:
    def __init__(self, hop_sketches):
        self.hop_sketches = hop_sketches


class _SimQueues:
    def __init__(self, queues):
        self._queues = queues

    def queues(self):
        return self._queues


def _merged(p):
    qs = _SimQueues({
        "a": _SimQueue(_sketches(p, {"queue.wait": 10.0}, n=5)),
        "b": _SimQueue(_sketches(p, {"queue.wait": 30.0,
                                     "engine.step": 7.0}, n=5)),
    })
    merged = p.report.merged_hop_sketches(qs)
    return {hop: (sk.count, sk.quantile(0.5), sk.quantile(0.95))
            for hop, sk in merged.items()}


def test_merged_hop_sketches_agree():
    merged = _both(_merged)
    assert merged["queue.wait"][0] == 10 and merged["engine.step"][0] == 5


_REPORT_A = {
    "models": {
        "m1": {"slo_attainment": 0.99, "latency_p99_ms": 120.123456,
               "dropped": 1, "stale": 2,
               "classes": {"interactive": {"stale": 1, "dropped": 0},
                           "batch": {"stale": 1, "dropped": 1}}},
        "m2": {"slo_attainment": 0.91, "latency_p99_ms": 300.0},
    },
    "chips_used": 2, "schedule_changes": 3,
    "gray": {"timeline": [
        {"replica": "e1", "at": 1.5, "from": "healthy", "to": "probation",
         "p50_ms": 10.0, "p95_ms": 40.0},
        {"replica": "e1", "at": 9.0, "from": "probation", "to": "healthy"},
    ], "final_states": {"e1": "healthy"}},
    "observatory": {"alerts": {"timeline": [
        {"key": "m1", "qos": "interactive", "at": 2.0, "from": "ok",
         "to": "page", "fast_burn": 14.4, "slow_burn": 6.0},
    ], "final_states": {"m1": {"interactive": "page"}}}},
}
_REPORT_B = {
    "models": {"m1": {"slo_attainment": 0.97, "latency_p99_ms": 150.0}},
    "chips_used": 1, "schedule_changes": 1,
}
_PARTITION = {
    "scenario": {"name": "split"},
    "store": {"leader": "s0", "epoch": 2, "self_demotions": 1,
              "split_brain_commits": 0, "rejected_appends": 3,
              "appended_total": 40, "log_tail_records": 4,
              "max_tail_replayed": 4, "snapshots_taken": 2,
              "failovers": [{"at_s": 5.0, "owner": "s1", "epoch": 2,
                             "snapshot_index": 30, "tail_replayed": 4}]},
    "max_over_admitted": 2, "degrade_bound": 5, "reconverged": True,
    "ledgers": {"shard0": {"degraded_entries": 2, "merged": True,
                           "stale_at_end": False}},
}


def _report_helpers(p):
    r = p.report
    diff = r.compare_reports(_REPORT_A, _REPORT_B, "A", "B")
    return {
        "attainment": [r.slo_attainment(c) for c in (
            {"completed": 90, "violations": 5, "stale": 3, "dropped": 2},
            {})],
        "shed": r.shed_by_class(_REPORT_A["models"]["m1"]),
        "fraction": [r.shed_fraction(_REPORT_A["models"]["m1"], "batch"),
                     r.shed_fraction(_REPORT_A["models"]["m2"], "batch")],
        "json": r.render_json(_REPORT_A),
        "compare": diff,
        "compare_text": r.format_compare(diff),
        "gray": (r.gray_timeline(_REPORT_A),
                 r.format_gray_timeline(_REPORT_A),
                 r.format_gray_timeline(_REPORT_B)),
        "alerts": (r.alert_timeline(_REPORT_A),
                   r.format_alert_timeline(_REPORT_A),
                   r.format_alert_timeline(_REPORT_B)),
        "partition": r.format_partition_story(_PARTITION),
    }


def test_report_helpers_agree():
    out = _both(_report_helpers)
    assert out["attainment"] == [pytest.approx(1.0 - 10 / 95), 1.0]
    assert out["shed"] == {"interactive": 1.0, "batch": 2.0}
    assert out["fraction"] == [pytest.approx(2 / 3), 1.0]
    assert '"latency_p99_ms": 120.1235' in out["json"]
    assert out["compare"]["winner"] == "B"
    assert out["compare"]["models"]["m2"]["slo_attainment"]["delta"] is None
    assert "probation" in out["gray"][1]
    assert out["gray"][2] == "gray: detection disabled or no transitions"
    assert "ok -> page" in out["alerts"][1]
    assert "failover @5.0s -> s1" in out["partition"]
