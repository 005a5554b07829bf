"""Whole runs on the CPU at a tiny size: the harness past its look for a
card, the port's serving path on the CPU's plain kernels, and the check.
Sound runs come out correct; a run with the timed path broken
underneath comes out not correct."""

import json
import shutil
import time

import pytest
import torch

from gpubench import harness

TINY_LLAMA = {
    "vocab_size": 512, "d_model": 64, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 2, "mlp_dim": 128, "max_seq_len": 512}
TINY_GPT2 = {
    "vocab_size": 300, "d_model": 64, "num_layers": 2, "num_heads": 4,
    "num_kv_heads": 4, "mlp_dim": 256, "max_seq_len": 256}
# Above the sound tiny runs' widest gaps (0.01-0.05 in bf16 on the CPU)
# and below what a broken path gives (0.5 or more).
TINY_LIMIT = 0.25


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A benchmark folder of two tiny configurations (one of each
    family, cut from the committed ones) and an open and a closed cell."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.BENCH_DIR / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "cells").mkdir()
    for src, name, sizes in (("mistral-7b-v0.3", "tiny-llama", TINY_LLAMA),
                             ("gpt2-medium", "tiny-gpt2", TINY_GPT2)):
        c = harness.find_config(src)
        c["name"] = name
        c["decoder"].update(sizes)
        c["deployment"].update(num_slots=4, max_len=256, kv_pool_pages=8)
        c["check"] = {"max_logit_gap": TINY_LIMIT, "mean_logit_gap": None}
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    cells = {
        "tiny-open": {"config": "tiny-llama", "traffic": {
            "loop": "open", "rate_rps": 4.0, "sizes_seed": 1,
            "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.9,
                       "min": 8, "max": 150},
            "output": {"dist": "lognormal", "median": 16, "sigma": 0.5,
                       "min": 4, "max": 40}}},
        "tiny-closed": {"config": "tiny-gpt2", "traffic": {
            "loop": "closed", "clients": 4, "pool": 400, "sizes_seed": 2,
            "prompt": {"dist": "uniform", "min": 20, "max": 100},
            "output": {"dist": "uniform", "min": 4, "max": 24}}},
    }
    for name, cell in cells.items():
        (root / "cells" / f"{name}.json").write_text(json.dumps(cell))
    spec = json.loads((harness.BENCH_DIR.parent / "BENCHMARK.json")
                      .read_text())
    rename = {"mistral7b-chat-poisson": "tiny-open",
              "mistral7b-batch-closed": "tiny-closed",
              "gpt2m-longctx-closed": "tiny-closed"}
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            if "workloads" in m:
                m["workloads"] = sorted({rename[w] for w in m["workloads"]})
    return root, spec


def _run(bench, cell, trace=False, seed=2 ** 33 + 7):
    root, spec = bench
    return harness.run(cell, seed, 3.0, trace, spec, time.monotonic(),
                       device="cpu", bench_dir=root).result


@pytest.mark.parametrize("cell,metrics", [
    ("tiny-open", {"ttft_p95_ms", "tpot_p95_ms", "setup_s"}),
    ("tiny-closed", {"output_tok_s", "setup_s"}),
])
def test_sound_runs_are_correct(bench, cell, metrics):
    out = _run(bench, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == metrics
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert 0 <= out["checks"]["max_logit_gap"]["value"] < TINY_LIMIT
    assert set(out["readings"]) == {"program"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny-open", "tiny-closed"])
def test_the_control_reads_far_above_the_program(bench, cell):
    root, spec = bench
    out = harness.run(cell, 2 ** 33 + 9, 3.0, False, spec, time.monotonic(),
                      device="cpu", bench_dir=root, control="fp8").result
    program, control = out["readings"]["program"], out["readings"]["control"]
    # The judged numbers are the control's (the tiny limit is not set
    # from them; the card test holds the committed limits against it).
    assert out["checks"]["max_logit_gap"]["value"] == control["max_logit_gap"]
    assert control["max_logit_gap"] > 3 * program["max_logit_gap"]
    assert control["mean_logit_gap"] > 3 * program["mean_logit_gap"]


def test_traced_run_reads_the_ports_spans(bench):
    out = _run(bench, "tiny-open", trace=True)
    assert out["correct"]
    assert {"route_hop_ms_p95", "queue_wait_ms_p95", "prefill_ms_p95",
            "step_ms.chat"} <= set(out["metrics"])
    # No device trace on the CPU: the device's readers read nothing.
    closed = _run(bench, "tiny-closed", trace=True)
    assert set(closed["metrics"]) == {"step_ms.batch", "slots_decoding",
                                      "kv_pool_pct"}
    assert 0 < closed["metrics"]["slots_decoding"]["value"] <= 4
    assert 0 < closed["metrics"]["kv_pool_pct"]["value"] <= 100
    assert 0 < closed["device"]["kv_pool_pct_peak"] <= 100


def test_a_closed_loop_runs_its_ramp_before_the_window(bench):
    """A closed loop's clients start ``ramp_s`` before the window opens:
    requests are in flight at the open, and the window counts only the
    tokens streamed inside it."""
    root, _ = bench
    config = harness.find_config("tiny-gpt2", root)
    traffic = dict(harness.find_cell("tiny-closed", root)["traffic"],
                   ramp_s=1.0)
    plan = harness.make_plan(traffic, 1.5, 5,
                             int(config["decoder"]["vocab_size"]))
    weights = harness.reference.make_weights(config["decoder"], 5, "cpu")
    served = harness.Served(config, weights, torch.device("cpu"))
    opened = []
    try:
        before = time.monotonic()
        records, t0, t1, complete = harness.drive(
            served.handle, plan, 1.5, on_open=opened.append)
    finally:
        served.close()
    assert complete and opened == [t0] and t1 - t0 == 1.5
    assert 0.95 < t0 - before < 1.05
    assert min(r.sent for r in records) < t0 - 0.9
    early = [r for r in records if r.sent < t0]
    assert any(t > t0 for r in early for t in r.token_times)
    assert harness.stats.tokens_in(records, t0, t1) < sum(
        len(r.token_times) for r in records if r.ok)


def _alter_tokens(monkeypatch):
    """Every token the model produces becomes token 5."""
    from ray_dynamic_batching_tpu_torch.models import decoder

    orig = decoder.DecoderModule.logits_of

    def altered(self, x, take=None):
        out = orig(self, x, take).clone()
        out[..., 5] += 1e4
        return out

    monkeypatch.setattr(decoder.DecoderModule, "logits_of", altered)


def _state_unchanged(monkeypatch):
    """A decode step leaves the KV pool as it found it: its writes go to
    the sink page."""
    from ray_dynamic_batching_tpu_torch.models import decoder

    orig = decoder.paged_write_index

    def dropped(positions, page_table, num_pages, page_size):
        pid, off = orig(positions, page_table, num_pages, page_size)
        if positions.shape[1] == 1:
            pid = torch.full_like(pid, num_pages)
        return pid, off

    monkeypatch.setattr(decoder, "paged_write_index", dropped)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged],
                         ids=["token_altered", "state_unchanged"])
@pytest.mark.parametrize("cell", ["tiny-open", "tiny-closed"])
def test_a_broken_path_is_not_correct(bench, monkeypatch, fault, cell):
    fault(monkeypatch)
    out = _run(bench, cell)
    assert not out["correct"]
    assert out["checks"]["max_logit_gap"]["value"] > TINY_LIMIT


def test_the_trace_stops_while_the_engine_is_held(bench, monkeypatch):
    """The device trace's stop runs with the engine's loop held: no step
    runs during it, and the loop goes on after it to answer every
    request."""
    root, _ = bench
    config = harness.find_config("tiny-gpt2", root)
    plan = harness.make_plan(harness.find_cell("tiny-closed", root)["traffic"],
                             2.0, 5, int(config["decoder"]["vocab_size"]))
    weights = harness.reference.make_weights(config["decoder"], 5, "cpu")
    served = harness.Served(config, weights, torch.device("cpu"))
    engine = served.engine
    steps = []
    inner = engine._step
    engine._step = lambda *a, **k: (steps.append(1), inner(*a, **k))[1]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    during = []

    class Capture:
        def finish(self):
            n = len(steps)
            time.sleep(0.3)
            during.append(len(steps) - n)

    try:
        records, _, _, complete = harness.drive(
            served.handle, plan, 2.0,
            on_close=lambda: harness.stop_while_held(engine, Capture()))
    finally:
        served.close()
    assert during == [0] and complete
    assert records and all(r.ok for r in records)
    assert "_service_fabric" not in vars(engine)
