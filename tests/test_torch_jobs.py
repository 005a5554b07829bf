"""The job manager, the port against the JAX package (CPU).

The cases of ``tests/test_jobs.py``'s job manager run on both packages'
``runtime/jobs.py`` with the same entrypoints: success with its log,
failure with its code, a bad entrypoint, a stopped process group,
listing with metadata and a restarted manager's reconciliation. The job
records agree field by field (pids, clocks and log paths aside). The
table lives in the port's ``runtime/kv``, the file-backed store too: a
manager restarted over the same file finds its jobs. Every job is waited
for or stopped.
"""

import sys
import types

import pytest

from ray_dynamic_batching_tpu.runtime import jobs as j_jobs
from ray_dynamic_batching_tpu.runtime import kv as j_kv
from ray_dynamic_batching_tpu_torch.runtime import jobs as t_jobs
from ray_dynamic_batching_tpu_torch.runtime import kv as t_kv

PKGS = {"jax": types.SimpleNamespace(jobs=j_jobs, kv=j_kv),
        "torch": types.SimpleNamespace(jobs=t_jobs, kv=t_kv)}


def py(code: str):
    return [sys.executable, "-c", code]


def _record(info) -> dict:
    d = {k: v for k, v in vars(info).items()
         if k not in ("pid", "submitted_at", "finished_at", "log_path")}
    d["entrypoint"] = [a if a != sys.executable else "python"
                       for a in d["entrypoint"]]
    return d


def _run(pkg, workdir) -> dict:
    jobs = pkg.jobs
    jm = jobs.JobManager(kv=pkg.kv.KVStore(), workdir=workdir)
    out = {}
    ok = jm.submit(py("print('hello from job')"), job_id="ok",
                   metadata={"kind": "profiler"})
    bad = jm.submit(py("import sys; print('boom'); sys.exit(3)"),
                    job_id="bad")
    out["ok"] = _record(jm.wait(ok, timeout_s=60))
    out["bad"] = _record(jm.wait(bad, timeout_s=60))
    out["logs"] = [jm.logs(ok), jm.logs(bad), jm.logs("none")]
    with pytest.raises(OSError):
        jm.submit(["/nonexistent/binary"], job_id="missing")
    out["missing"] = _record(jm.get("missing"))
    with pytest.raises(ValueError, match="already exists"):
        jm.submit(py("pass"), job_id="ok")
    sleeper = jm.submit(py("import time; time.sleep(600)"), job_id="sleep")
    try:
        out["running"] = jm.status(sleeper)
        out["stopped"] = jm.stop(sleeper, grace_s=1.0)
        out["sleep"] = _record(jm.wait(sleeper, timeout_s=60))
        out["stop_again"] = jm.stop(sleeper)
    finally:
        jm.stop(sleeper, grace_s=0.5)
    out["list"] = [j.job_id for j in jm.list_jobs()]
    ghost = jobs.JobInfo(job_id="ghost", entrypoint=["x"],
                         status=jobs.RUNNING, pid=2 ** 22 + 12345)
    jm.kv.put("jobs:ghost", ghost.to_json())
    fresh = jobs.JobManager(kv=jm.kv, workdir=workdir)
    out["recovered"] = fresh.recover()
    out["statuses"] = {j.job_id: j.status for j in fresh.list_jobs()}
    return out


def test_job_manager_matches_the_jax_package(tmp_path):
    got = _run(PKGS["torch"], str(tmp_path / "t"))
    want = _run(PKGS["jax"], str(tmp_path / "j"))
    assert got == want
    assert got["ok"]["status"] == "SUCCEEDED" and got["ok"]["return_code"] == 0
    assert got["bad"]["status"] == "FAILED" and got["bad"]["return_code"] == 3
    assert "hello from job" in got["logs"][0] and "boom" in got["logs"][1]
    assert got["missing"]["status"] == "FAILED"
    assert got["running"] == "RUNNING" and got["sleep"]["status"] == "STOPPED"
    assert got["recovered"] == ["ghost"]
    assert got["statuses"]["ghost"] == "LOST"
    assert got["statuses"]["ok"] == "SUCCEEDED"


def test_table_survives_in_a_file_store(tmp_path):
    path = str(tmp_path / "kv.json")
    jm = t_jobs.JobManager(kv=t_kv.FileKVStore(path),
                           workdir=str(tmp_path / "logs"))
    jid = jm.submit(py("print(6 * 7)"))
    assert jm.wait(jid, timeout_s=60).status == t_jobs.SUCCEEDED
    again = t_jobs.JobManager(kv=t_kv.FileKVStore(path),
                              workdir=str(tmp_path / "logs"))
    assert again.recover() == []
    assert again.status(jid) == t_jobs.SUCCEEDED
    assert "42" in again.logs(jid)


def test_default_workdir_is_under_the_temporary_directory(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    jm = t_jobs.JobManager()
    assert jm.workdir == str(tmp_path / "rdb_jobs")
