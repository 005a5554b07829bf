"""The state API, its terminal viewers and the dashboard, the port against
the JAX package (CPU).

``StateAPI.summary()`` over equivalent controllers (one batch deployment
of two replicas, a job manager with one finished job) has the JAX API's
keys and values, the audit ring's wall-clock stamps aside. The renderers
and the ``--watch`` viewer give identical text on identical inputs. The
port's dashboard answers ``/``, ``/api/state``, ``/metrics`` and its
health route, and the ``--url`` viewer reads it. Every controller and
dashboard is stopped in a ``finally``.
"""

import io
import json
import sys
import types
import urllib.error
import urllib.request

import pytest

from ray_dynamic_batching_tpu import state as j_state
from ray_dynamic_batching_tpu.runtime import jobs as j_jobs
from ray_dynamic_batching_tpu.runtime import kv as j_kv
from ray_dynamic_batching_tpu.serve import (
    DeploymentConfig as JDeploymentConfig,
    ServeController as JServeController,
)
from ray_dynamic_batching_tpu_torch import state as t_state
from ray_dynamic_batching_tpu_torch.runtime import jobs as t_jobs
from ray_dynamic_batching_tpu_torch.runtime import kv as t_kv
from ray_dynamic_batching_tpu_torch.serve import (
    DeploymentConfig as TDeploymentConfig,
    ServeController as TServeController,
)
from ray_dynamic_batching_tpu_torch.serve.dashboard import DashboardServer
from ray_dynamic_batching_tpu_torch.utils import metrics as t_metrics

PKGS = {
    "jax": types.SimpleNamespace(state=j_state, jobs=j_jobs, kv=j_kv,
                                 controller=JServeController,
                                 config=JDeploymentConfig),
    "torch": types.SimpleNamespace(state=t_state, jobs=t_jobs, kv=t_kv,
                                   controller=TServeController,
                                   config=TDeploymentConfig),
}


def double_batch(payloads):
    return [p * 2 for p in payloads]


def _unstamped(value):
    """``value`` without its wall-clock and process-specific readings."""
    if isinstance(value, dict):
        return {k: _unstamped(v) for k, v in value.items()
                if k not in ("wall_time", "submitted_at", "finished_at",
                             "pid", "log_path")}
    if isinstance(value, list):
        return [_unstamped(v) for v in value]
    return value


def _summary(pkg, workdir):
    ctl = pkg.controller()
    try:
        ctl.deploy(pkg.config(name="doubler", num_replicas=2),
                   factory=lambda: double_batch)
        jm = pkg.jobs.JobManager(kv=pkg.kv.KVStore(), workdir=workdir)
        jm.wait(jm.submit([sys.executable, "-c", "pass"], job_id="j1",
                          metadata={"kind": "probe"}), timeout_s=60)
        return pkg.state.StateAPI(controller=ctl, jobs=jm).summary()
    finally:
        ctl.shutdown()


def test_summary_equals_the_jax_apis(tmp_path):
    got = _summary(PKGS["torch"], str(tmp_path / "t"))
    want = _summary(PKGS["jax"], str(tmp_path / "j"))
    assert list(got) == list(want)
    assert _unstamped(got) == _unstamped(want)
    assert [d["name"] for d in got["deployments"]] == ["doubler"]
    assert len(got["replicas"]) == 2 and got["jobs"][0]["status"] == "SUCCEEDED"
    assert {"deploy", "scale"} <= {a["trigger"] for a in got["audit"]}


def test_empty_api_equals_the_jax_apis():
    got = t_state.StateAPI(registry=t_metrics.MetricsRegistry()).summary()
    want = j_state.StateAPI().summary()
    assert got == want


QUEUES = {
    "good": {"slo_compliance": 0.99, "latency_p95_ms": 5,
             "latency_p99_ms": 9, "depth": 1},
    "warn": {"slo_compliance": 0.96, "latency_p95_ms": 20,
             "latency_p99_ms": 40, "depth": 5},
    "bad": {"slo_compliance": 0.5, "latency_p95_ms": 900,
            "latency_p99_ms": 2000, "depth": 99},
}
AUDIT = [
    {"wall_time": 1.7e9, "domain": "sched", "trigger": "rate_change",
     "migration_cost": 12.5, "diff": {"engines_changed": {
         "0": {"old": ["a"], "new": ["a", "b"]}, "1": {"old": [], "new": []}}}},
    {"wall_time": 1.7e9 + 61, "domain": "serve", "trigger": "scale",
     "diff": {"delta": 2}},
    {"wall_time": 1.7e9 + 62, "domain": "serve", "trigger": "heal",
     "diff": {}, "note": "replaced r1"},
]
SNAPSHOTS = [
    {"queues": QUEUES, "rates_rps": {"good": 12.0, "bad": 3.5},
     "plan": [{"node": 0}, {"node": 1}], "schedule_changes": 3,
     "audit": AUDIT},
    {"queues": {}, "rates_rps": {}},
]


@pytest.mark.parametrize("render", [
    lambda s: s.render_queue_table(QUEUES),
    lambda s: s.render_queue_table(QUEUES, {"warn": 7.25}),
    lambda s: s.render_audit_table(AUDIT),
    lambda s: s.render_audit_table(AUDIT, last=1),
    lambda s: s.render_snapshot(SNAPSHOTS[0]),
    lambda s: s.render_snapshot(SNAPSHOTS[1]),
], ids=["queues", "queues_rates", "audit", "audit_last", "snapshot",
        "snapshot_empty"])
def test_renderers_equal_the_jax_packages(render):
    got = render(t_state)
    assert got == render(j_state)
    assert got


@pytest.mark.parametrize("snap", SNAPSHOTS, ids=["full", "empty"])
def test_watch_metrics_file_equals_the_jax_viewer(tmp_path, snap):
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(snap))
    outs = []
    for mod in (t_state, j_state):
        out = io.StringIO()
        mod.watch_metrics_file(str(path), interval_s=0, iterations=2,
                               out=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    missing = io.StringIO()
    t_state.watch_metrics_file(str(tmp_path / "none.json"), interval_s=0,
                               iterations=1, out=missing)
    assert "waiting for" in missing.getvalue()


def test_cli_watch_prints_the_jax_clis_text(tmp_path, capsys):
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(SNAPSHOTS[0]))
    argv = ["--watch", str(path), "--iterations", "1", "--interval", "0"]
    assert t_state.main(argv) == 0
    got = capsys.readouterr().out
    assert j_state.main(argv) == 0
    assert got == capsys.readouterr().out and "2 node(s)" in got


@pytest.fixture
def controller():
    ctl = TServeController()
    try:
        ctl.deploy(TDeploymentConfig(name="doubler", num_replicas=2),
                   factory=lambda: double_batch)
        yield ctl
    finally:
        ctl.shutdown()


def test_dashboard_routes(controller):
    dash = DashboardServer(t_state.StateAPI(controller=controller),
                           port=0).start()
    base = f"http://127.0.0.1:{dash.port}"
    try:
        html = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "rdb-tpu dashboard" in html
        state = json.load(urllib.request.urlopen(base + "/api/state",
                                                 timeout=10))
        assert state["deployments"][0]["name"] == "doubler"
        assert len(state["replicas"]) == 2
        resp = urllib.request.urlopen(base + "/metrics", timeout=10)
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert "# TYPE" in resp.read().decode()
        req = urllib.request.Request(
            base + "/metrics",
            headers={"Accept": "application/openmetrics-text"})
        resp = urllib.request.urlopen(req, timeout=10)
        assert resp.headers["Content-Type"].startswith(
            "application/openmetrics-text")
        assert urllib.request.urlopen(base + "/-/healthz",
                                      timeout=10).read() == b"ok"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        dash.stop()


def test_cli_url_reads_the_dashboard(controller, capsys):
    dash = DashboardServer(t_state.StateAPI(controller=controller),
                           port=0).start()
    try:
        assert t_state.main(["--url", f"http://127.0.0.1:{dash.port}",
                             "--iterations", "1"]) == 0
        out = capsys.readouterr().out
        assert "doubler" in out and "unreachable" not in out
    finally:
        dash.stop()
