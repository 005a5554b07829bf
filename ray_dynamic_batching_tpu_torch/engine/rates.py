"""Sliding-window request-rate tracking.

Own copy of ``ray_dynamic_batching_tpu/engine/rates.py``, whole, with its
import paths rewritten.

Re-creates the reference's ``RequestTracker``
(``293-project/src/scheduler.py:115-169``: thread-safe requests/sec over a
window that resets after ``window_size``). Here the window slides smoothly —
per-second counts in a ring pruned on read — so the control loop never sees
the sawtooth a hard reset produces.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ray_dynamic_batching_tpu_torch.utils.concurrency import assert_owner


class RateTracker:
    """Requests/sec over a sliding window (one instance per model)."""

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._buckets: Deque[Tuple[int, int]] = deque()  # (second, count)
        self._total = 0
        self._lock = threading.Lock()

    def record(self, n: int = 1) -> None:
        sec = int(self._clock())
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                s, c = self._buckets[-1]
                self._buckets[-1] = (s, c + n)
            else:
                self._buckets.append((sec, n))
            self._total += n
            self._prune(sec)

    def _prune(self, now_sec: int) -> None:
        assert_owner(self._lock)  # callers hold it (record / rate_rps)
        cutoff = now_sec - int(self.window_s)
        while self._buckets and self._buckets[0][0] <= cutoff:
            _, c = self._buckets.popleft()
            self._total -= c

    def rate_rps(self) -> float:
        sec = int(self._clock())
        with self._lock:
            self._prune(sec)
            if not self._buckets:
                return 0.0
            # Use the actual covered span so a cold start doesn't under-read.
            span = max(1.0, min(self.window_s, sec - self._buckets[0][0] + 1))
            return self._total / span

    def span_s(self) -> float:
        """Seconds of window the estimate actually covers (0 = cold).
        A 2-second-old tracker extrapolates one arrival to a full rate —
        change detectors should know how much evidence backs the number."""
        sec = int(self._clock())
        with self._lock:
            self._prune(sec)
            if not self._buckets:
                return 0.0
            return min(self.window_s, sec - self._buckets[0][0] + 1)

    def count_between(self, t0_s: float, t1_s: float) -> Optional[int]:
        """Arrivals recorded in ``[t0_s, t1_s)``, or None when the
        sliding window has already rotated past ``t0_s`` — the truth is
        gone, and a partial count would read as a real (low) rate.
        Forecast scoring uses this to grade a prediction against what
        ACTUALLY arrived over its horizon."""
        sec = int(self._clock())
        lo, hi = int(t0_s), int(t1_s)
        with self._lock:
            self._prune(sec)
            if lo <= sec - int(self.window_s):
                return None
            return sum(c for s, c in self._buckets if lo <= s < hi)

    def forecast_rps(self, horizon_s: float, alpha: float = 0.5,
                     beta: float = 0.2,
                     min_span_s: float = 0.0) -> Optional[float]:
        """Short-horizon arrival forecast (requests/sec ``horizon_s``
        from now) via Holt's linear method — EWMA level + trend over the
        per-second buckets. Pure arithmetic over data already held: no
        randomness, no state kept between calls, jax-free.

        REFUSES (returns None) rather than extrapolating when the
        evidence is thin: an empty window, a covered span below
        ``min_span_s``, or fewer than two CLOSED seconds of history.
        The current partial second is always excluded — it under-reads
        by construction (the cold-window foot-gun ``rate_rps`` guards
        with its span floor)."""
        now_sec = int(self._clock())
        with self._lock:
            self._prune(now_sec)
            if not self._buckets:
                return None
            span = min(self.window_s, now_sec - self._buckets[0][0] + 1)
            if span < min_span_s:
                return None
            counts = dict(self._buckets)
            first = self._buckets[0][0]
        last_closed = now_sec - 1
        if last_closed - first < 1:
            return None
        # Contiguous per-second series, gaps are genuine zeros.
        series = [float(counts.get(s, 0))
                  for s in range(first, last_closed + 1)]
        level, trend = series[0], 0.0
        for x in series[1:]:
            prev = level
            level = alpha * x + (1.0 - alpha) * (level + trend)
            trend = beta * (level - prev) + (1.0 - beta) * trend
        return max(0.0, level + trend * float(horizon_s))


class RateRegistry:
    """Per-model trackers + significant-change detection for the control loop
    (ref: threshold test at scheduler.py:794-801 — 5% change triggers a
    reschedule, doubled for decreases)."""

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._trackers: Dict[str, RateTracker] = {}
        self._last_scheduled: Dict[str, float] = {}
        self._lock = threading.Lock()

    def tracker(self, model: str) -> RateTracker:
        with self._lock:
            if model not in self._trackers:
                self._trackers[model] = RateTracker(self.window_s, self._clock)
            return self._trackers[model]

    def record(self, model: str, n: int = 1) -> None:
        self.tracker(model).record(n)

    def rates(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._trackers.items())
        return {m: t.rate_rps() for m, t in items}

    def changed_models(
        self, threshold: float, decrease_multiplier: float = 2.0,
        min_span_s: float = 0.0,
    ) -> Dict[str, float]:
        """Models whose rate moved beyond the threshold since the last
        accepted schedule; increases trip at `threshold`, decreases at
        `threshold * decrease_multiplier` (asymmetric — scaling down too
        eagerly causes flapping, ref scheduler.py:794-801).

        ``min_span_s`` ignores models whose sliding window covers less
        than that many seconds: a cold tracker extrapolates its first
        arrivals to up-to-2x-inflated rates, and replanning on that
        evidence migrates engines for noise (observed: a colocation demo
        split chips at t=5s on a 2.0 reading of a true 1.0 tok/s). Two
        exemptions: a model with NO scheduled baseline (its first
        scale-up has no engine to migrate, and holding its traffic
        unserved for half a window is guaranteed SLO misses), and an
        EMPTY window (span 0 means traffic stopped and the buckets
        expired — a real scale-to-zero signal, not a cold start; a
        guard there would pin the idle model's engine in HBM forever)."""
        out: Dict[str, float] = {}
        for model, rate in self.rates().items():
            base = self._last_scheduled.get(model)
            if min_span_s > 0 and base:
                span = self.tracker(model).span_s()
                if 0 < span < min_span_s:
                    continue
            if base is None:
                if rate > 0:
                    out[model] = rate
                continue
            if base == 0:
                if rate > 0:
                    out[model] = rate
                continue
            delta = (rate - base) / base
            if delta > threshold or -delta > threshold * decrease_multiplier:
                out[model] = rate
        return out

    def forecasts(self, horizon_s: float, alpha: float = 0.5,
                  beta: float = 0.2,
                  min_span_s: float = 0.0) -> Dict[str, Optional[float]]:
        """Per-model ``forecast_rps``; a refusing tracker stays in the
        map as None so consumers can COUNT refusals instead of silently
        seeing fewer models (the observatory's never-silent rule)."""
        with self._lock:
            items = list(self._trackers.items())
        return {
            model: t.forecast_rps(horizon_s, alpha=alpha, beta=beta,
                                  min_span_s=min_span_s)
            for model, t in items
        }

    def mark_scheduled(self, rates: Optional[Dict[str, float]] = None) -> None:
        self._last_scheduled.update(rates if rates is not None else self.rates())

    def scheduled_rates(self) -> Dict[str, float]:
        return dict(self._last_scheduled)
