"""Workload generation — rate patterns + request drivers for tests/benches.

Own copy of ``ray_dynamic_batching_tpu/engine/workload.py``, whole, with
its import paths rewritten.

Re-creates the reference's load generators: the in-process
``WorkloadGenerator`` patterns — linear slope
(``293-project/src/test_scheduler.py:77-96``), sinusoidal / step / random /
spike (``293-project/src/venkat-code/test_scheduler.py:110-126``) — and the
zmq request simulator's per-model threads pushing at a settable rate
(``293-project/src/milind-code/request_simulator.py:29-42``).

Additions for the TPU framework's north star: Poisson arrivals (BASELINE.md
headline metric is latency vs offered QPS under Poisson load) and a
deterministic virtual-clock mode so integration tests can assert SLO
outcomes without wall-clock flakiness.
"""

from __future__ import annotations

import json
import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("workload")


@dataclass
class RatePattern:
    """rate(t) in requests/sec over elapsed seconds ``t``."""

    kind: str = "constant"      # constant|linear|sinusoidal|step|random|spike
    base_rps: float = 10.0
    # linear: rate = base + slope * t  (ref test_scheduler.py:77-90)
    slope: float = 0.0
    # sinusoidal: base + amplitude * sin(2*pi*t/period)  (ref venkat :110-115)
    amplitude: float = 0.0
    period_s: float = 60.0
    # step: jumps to base+amplitude after step_at_s  (ref venkat :116-119)
    step_at_s: float = 30.0
    # random walk bounds  (ref venkat :120-122)
    jitter: float = 0.2
    # spike: base except [spike_at_s, spike_at_s+spike_len_s) at base+amplitude
    spike_at_s: float = 30.0
    spike_len_s: float = 5.0
    seed: int = 0
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def rate(self, t: float) -> float:
        k = self.kind
        if k == "constant":
            r = self.base_rps
        elif k == "linear":
            r = self.base_rps + self.slope * t
        elif k == "sinusoidal":
            r = self.base_rps + self.amplitude * math.sin(
                2 * math.pi * t / self.period_s
            )
        elif k == "step":
            r = self.base_rps + (self.amplitude if t >= self.step_at_s else 0.0)
        elif k == "random":
            r = self.base_rps * (1 + self._rng.uniform(-self.jitter, self.jitter))
        elif k == "spike":
            in_spike = self.spike_at_s <= t < self.spike_at_s + self.spike_len_s
            r = self.base_rps + (self.amplitude if in_spike else 0.0)
        else:
            raise ValueError(f"unknown pattern kind {k!r}")
        return max(0.0, r)


def arrival_times(
    pattern: RatePattern,
    duration_s: float,
    poisson: bool = False,
    seed: int = 0,
) -> Iterator[float]:
    """Yield arrival offsets in [0, duration): deterministic uniform spacing
    at the instantaneous rate, or exponential gaps for Poisson arrivals."""
    rng = random.Random(seed)
    t = 0.0
    while t < duration_s:
        r = pattern.rate(t)
        if r <= 0:
            t += 0.05  # idle scan
            continue
        gap = rng.expovariate(r) if poisson else 1.0 / r
        t += gap
        if t < duration_s:
            yield t


class WorkloadDriver:
    """Threaded driver: submits via callback at pattern-scheduled times
    (one thread per model, ref request_simulator.py:29-42).

    ``record_path`` appends one JSONL line ``{"t_s": offset, "model":
    name}`` per submitted arrival — the replay format the what-if
    simulator consumes (``sim/workload.load_recorded_arrivals``), so any
    driven run becomes a reproducible simulation input. Drivers sharing
    one path append line-buffered (each line lands whole); the CALLER
    truncates the file once before starting its drivers.
    """

    def __init__(
        self,
        submit: Callable[[str, float], None],  # (model, arrival_offset_s)
        model: str,
        pattern: RatePattern,
        duration_s: float,
        poisson: bool = False,
        seed: int = 0,
        record_path: Optional[str] = None,
    ) -> None:
        self.submit = submit
        self.model = model
        self.pattern = pattern
        self.duration_s = duration_s
        self.poisson = poisson
        self.seed = seed
        self.record_path = record_path
        self.sent = 0
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        record = None
        if self.record_path:
            try:
                record = open(self.record_path, "a", buffering=1)
            except OSError:
                # Recording is a side feature: an unwritable path must
                # not kill the load-generation thread before it drives.
                logger.exception(
                    "cannot record arrivals to %s; driving unrecorded",
                    self.record_path,
                )
        start = time.monotonic()
        try:
            for offset in arrival_times(
                self.pattern, self.duration_s, self.poisson, self.seed
            ):
                delay = start + offset - time.monotonic()
                if delay > 0:
                    time.sleep(delay)  # rdb-lint: disable=event-loop-blocking (open-loop arrival pacing on the generator's own thread)
                if record is not None:
                    # Record BEFORE submitting: the trace is OFFERED
                    # load, and a replay must see arrivals the live run
                    # failed to deliver (else the recording inherits the
                    # survivor bias span replays are warned about).
                    try:
                        record.write(json.dumps(
                            {"t_s": round(offset, 6), "model": self.model}
                        ) + "\n")
                    except OSError:
                        # Disk trouble mid-run: a truncated record is not
                        # replayable — stop recording, keep driving, and
                        # say which it was (not a submit failure).
                        logger.exception(
                            "arrival recording to %s failed; recording "
                            "stopped, load generation continues",
                            self.record_path,
                        )
                        record.close()
                        record = None
                try:
                    self.submit(self.model, offset)
                    self.sent += 1
                except Exception:  # noqa: BLE001 — keep driving through errors
                    logger.exception(
                        "workload submit failed for %s", self.model
                    )
        finally:
            if record is not None:
                record.close()

    def start(self) -> "WorkloadDriver":
        self._thread = threading.Thread(
            target=self._run, name=f"workload-{self.model}", daemon=True
        )
        self._thread.start()
        return self

    def join(self, timeout_s: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout_s)


def run_workloads(drivers: List[WorkloadDriver], timeout_s: float) -> int:
    """Start all drivers, wait for completion; returns total sent."""
    for d in drivers:
        d.start()
    deadline = time.monotonic() + timeout_s
    for d in drivers:
        d.join(max(0.0, deadline - time.monotonic()))
    return sum(d.sent for d in drivers)
