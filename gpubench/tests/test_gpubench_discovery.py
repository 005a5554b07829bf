"""A configuration, a cell and a metric added as files are found by
name, with no edit of the harness."""

import json

from gpubench import harness


def test_files_dropped_in_a_folder_are_found(tmp_path):
    for sub in ("configs", "cells", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new-model.json").write_text(
        json.dumps({"name": "new-model", "decoder": {}}))
    (tmp_path / "cells" / "new-model.burst").with_suffix(".json")
    (tmp_path / "cells" / "new-model.burst.json").write_text(
        json.dumps({"name": "new-model.burst", "config": "new-model"}))
    (tmp_path / "metrics" / "spare_slots.p50.py").write_text(
        "def read(window):\n    return 2 * window\n")
    cell = harness.find_cell("new-model.burst", tmp_path)
    assert harness.find_config(cell["config"], tmp_path)["name"] == \
        "new-model"
    assert harness.find_reader("spare_slots.p50", tmp_path)(21) == 42


def test_the_committed_metrics_each_have_a_reader():
    spec = json.loads((harness.BENCH_DIR.parent / "BENCHMARK.json")
                      .read_text())
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            assert callable(harness.find_reader(m["name"]))
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell["config"] == w["config"]
        harness.find_config(cell["config"])


def test_which_metrics_a_cell_reports():
    spec = {"end_to_end": [
        {"name": "ttft", "workloads": ["chat"]},
        {"name": "tok_s", "workloads": ["batch"]},
        {"name": "setup_s"}],
        "per_layer": [
            {"name": "queue", "moves": "ttft", "workloads": ["chat"]},
            {"name": "idle", "moves": "tok_s"},
            {"name": "boot", "moves": "setup_s"}]}
    names = lambda c, s: [m["name"] for m in harness.metrics_of(spec, c, s)]
    assert names("chat", "end_to_end") == ["ttft", "setup_s"]
    assert names("batch", "end_to_end") == ["tok_s", "setup_s"]
    assert names("chat", "per_layer") == ["queue", "boot"]
    assert names("batch", "per_layer") == ["idle", "boot"]
