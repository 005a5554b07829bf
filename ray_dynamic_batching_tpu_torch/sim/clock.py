"""Virtual clock + discrete-event kernel — the simulator's only time source.

Nexus (SOSP'19) validated its planner in simulation and Clockwork
(OSDI'20) showed predictable per-batch latencies make offline evaluation
faithful; both rest on one primitive: a clock that advances by EVENT, not
by wall time. Everything in ``sim/`` reads time from :class:`VirtualClock`
and yields control through :class:`EventLoop` — ``time.time`` /
``time.sleep`` are lint findings here (the ``sim-determinism`` rule), so
a 10-minute workload replays in milliseconds and two same-seed runs are
byte-identical.

Own copy of ``ray_dynamic_batching_tpu/sim/clock.py``, whole, with its
import paths rewritten.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Tuple


class VirtualClock:
    """Current simulated time. Only :class:`EventLoop` advances it."""

    def __init__(self, start_ms: float = 0.0) -> None:
        self._now_ms = float(start_ms)

    def now_ms(self) -> float:
        return self._now_ms

    def now_s(self) -> float:
        """Seconds view — drop-in for the ``clock=`` seams the live stack
        already exposes (``RateRegistry``, ``AuditLog(now=...)``)."""
        return self._now_ms / 1000.0


class EventLoop:
    """Deterministic discrete-event kernel: a heap of (time, seq, fn).

    Ties break on insertion order (``seq``), never on callable identity,
    so a given schedule of events always fires in one canonical order —
    the substrate of the byte-identical-report guarantee.
    """

    def __init__(self, clock: VirtualClock) -> None:
        self.clock = clock
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()

    def schedule_at(self, t_ms: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` at virtual ``t_ms`` (clamped to now — the past is
        immutable in a discrete-event world)."""
        t_ms = max(float(t_ms), self.clock.now_ms())
        heapq.heappush(self._heap, (t_ms, next(self._seq), fn))

    def schedule_in(self, delta_ms: float, fn: Callable[[], None]) -> None:
        self.schedule_at(self.clock.now_ms() + max(0.0, delta_ms), fn)

    def __len__(self) -> int:
        return len(self._heap)

    def run_until(self, t_ms: float) -> int:
        """Fire every event with timestamp <= ``t_ms`` in order, advancing
        the clock to each; returns the number fired. The clock lands on
        ``t_ms`` afterwards even if the heap drained early."""
        fired = 0
        while self._heap and self._heap[0][0] <= t_ms:
            when, _, fn = heapq.heappop(self._heap)
            self.clock._now_ms = when
            fn()
            fired += 1
        self.clock._now_ms = max(self.clock._now_ms, float(t_ms))
        return fired
