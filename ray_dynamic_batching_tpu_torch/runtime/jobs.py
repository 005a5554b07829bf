"""Job manager — submitted entrypoints as tracked subprocesses.

Re-creates the GCS job manager's role (``gcs_server/gcs_job_manager.cc``:
job table with lifecycle states, persisted to GCS storage) and the shape of
Ray's job-submission API (entrypoint command, captured logs, terminal
status polling). A job here is an OS process: the framework's units of
long-running work — profilers, workload drivers, batch generation — are
scripts, and the manager owns their lifecycle, log capture, and restart-
safe bookkeeping.

The job table lives in the KV store (``jobs:{id}``) exactly like the serve
controller's checkpoints, so a restarted manager recovers the table and
marks jobs whose processes died with it (ref: GCS restart reconciles its
job table from storage).

Own copy of ``ray_dynamic_batching_tpu/runtime/jobs.py`` with its import
paths rewritten; the table lives in the port's ``runtime/kv``. The
default log directory is ``rdb_jobs`` under the temporary directory
(``TMPDIR``), where the reference names ``/tmp/rdb_jobs``.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import tempfile
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_dynamic_batching_tpu_torch.runtime.kv import KVStore
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("jobs")

JOB_KEY = "jobs:{job_id}"

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"
LOST = "LOST"  # manager restarted; the process is gone
TERMINAL = (SUCCEEDED, FAILED, STOPPED, LOST)


@dataclass
class JobInfo:
    job_id: str
    entrypoint: List[str]
    status: str = PENDING
    pid: Optional[int] = None
    return_code: Optional[int] = None
    submitted_at: float = field(default_factory=time.time)
    finished_at: Optional[float] = None
    log_path: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "JobInfo":
        return JobInfo(**json.loads(text))


class JobManager:
    """Submit/track/stop jobs; table checkpointed to the KV store."""

    def __init__(
        self,
        kv: Optional[KVStore] = None,
        workdir: Optional[str] = None,
    ) -> None:
        self.kv = kv or KVStore()
        workdir = workdir or os.path.join(tempfile.gettempdir(), "rdb_jobs")
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    # --- lifecycle ----------------------------------------------------------
    def submit(
        self,
        entrypoint: Union[str, Sequence[str]],
        job_id: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        cwd: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Launch the entrypoint as a tracked subprocess; returns job_id
        (ref JobSubmissionClient.submit_job shape)."""
        if isinstance(entrypoint, str):
            entrypoint = shlex.split(entrypoint)
        job_id = job_id or f"job-{uuid.uuid4().hex[:10]}"
        if self.get(job_id) is not None:
            raise ValueError(f"job {job_id!r} already exists")
        log_path = os.path.join(self.workdir, f"{job_id}.log")
        info = JobInfo(
            job_id=job_id,
            entrypoint=list(entrypoint),
            log_path=log_path,
            metadata=dict(metadata or {}),
        )
        log_f = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                entrypoint,
                stdout=log_f,
                stderr=subprocess.STDOUT,
                env={**os.environ, **(env or {})},
                cwd=cwd,
                start_new_session=True,  # stop() kills the whole group
            )
        except OSError as e:
            log_f.close()
            info.status = FAILED
            info.finished_at = time.time()
            info.metadata["error"] = str(e)
            self._save(info)
            raise
        finally:
            # Popen dup'd the fd (or we failed) — the parent's handle is
            # done either way.
            if not log_f.closed:
                log_f.close()
        info.status = RUNNING
        info.pid = proc.pid
        with self._lock:
            self._procs[job_id] = proc
        self._save(info)
        threading.Thread(
            target=self._reap, args=(job_id, proc), daemon=True,
            name=f"job-{job_id}",
        ).start()
        logger.info("job %s started: pid=%d %s", job_id, proc.pid, entrypoint)
        return job_id

    def _reap(self, job_id: str, proc: subprocess.Popen) -> None:
        rc = proc.wait()
        info = self.get(job_id)
        if info is None:
            return
        if info.status == STOPPED:
            info.return_code = rc
        else:
            info.status = SUCCEEDED if rc == 0 else FAILED
            info.return_code = rc
        info.finished_at = time.time()
        self._save(info)
        with self._lock:
            self._procs.pop(job_id, None)
        logger.info("job %s finished: rc=%d -> %s", job_id, rc, info.status)

    def stop(self, job_id: str, grace_s: float = 3.0) -> bool:
        """SIGTERM the job's process group, SIGKILL after the grace period
        (ref gcs_job_manager job termination)."""
        import signal

        with self._lock:
            proc = self._procs.get(job_id)
        info = self.get(job_id)
        if info is None:
            return False
        if proc is None or proc.poll() is not None:
            return False  # already terminal
        info.status = STOPPED
        self._save(info)
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            return True
        deadline = time.monotonic() + grace_s
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        return True

    # --- introspection -------------------------------------------------------
    def get(self, job_id: str) -> Optional[JobInfo]:
        raw = self.kv.get(JOB_KEY.format(job_id=job_id))
        return JobInfo.from_json(raw) if raw else None

    def status(self, job_id: str) -> Optional[str]:
        info = self.get(job_id)
        return info.status if info else None

    def wait(self, job_id: str, timeout_s: float = 60.0,
             poll_s: float = 0.05) -> JobInfo:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            info = self.get(job_id)
            if info is not None and info.status in TERMINAL:
                return info
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} not terminal within {timeout_s}s")

    def logs(self, job_id: str) -> str:
        info = self.get(job_id)
        if info is None or not info.log_path:
            return ""
        try:
            with open(info.log_path, "r", errors="replace") as f:
                return f.read()
        except OSError:
            return ""

    def list_jobs(self) -> List[JobInfo]:
        out = []
        for key in self.kv.keys("jobs:"):
            raw = self.kv.get(key)
            if raw:
                out.append(JobInfo.from_json(raw))
        return sorted(out, key=lambda j: j.submitted_at)

    # --- persistence ----------------------------------------------------------
    def _save(self, info: JobInfo) -> None:
        self.kv.put(JOB_KEY.format(job_id=info.job_id), info.to_json())

    def recover(self) -> List[str]:
        """After a manager restart: RUNNING jobs whose processes died with
        the old manager become LOST (ref GCS job-table reconciliation on
        restart). Returns the affected job ids."""
        lost = []
        for info in self.list_jobs():
            if info.status != RUNNING:
                continue
            alive = False
            if info.pid is not None:
                try:
                    os.kill(info.pid, 0)
                    alive = True
                except OSError:
                    alive = False
            if not alive:
                info.status = LOST
                info.finished_at = time.time()
                self._save(info)
                lost.append(info.job_id)
        return lost
