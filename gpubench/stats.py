"""Percentiles and the window arithmetic of the end-to-end metrics.

Every request offered is a :class:`Record`. Times are host monotonic
seconds. A request that failed, or whose streamed tokens disagree with
its final result, counts as past every latency limit (``inf``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class Record:
    """One request as the client saw it."""

    index: int
    prompt_len: int
    max_new: int
    scheduled: float                 # when it was due to be sent
    sent: float = 0.0                # when the client sent it
    token_times: List[float] = field(default_factory=list)
    tokens: Optional[List[int]] = None   # the final result's tokens
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        """Finished with every token it asked for, each streamed once."""
        return (self.error is None and self.tokens is not None
                and len(self.tokens) == self.max_new
                and len(self.token_times) == len(self.tokens))

    def ttft_s(self) -> float:
        return self.token_times[0] - self.scheduled if self.ok else math.inf

    def tpot_s(self) -> float:
        if not self.ok or len(self.token_times) < 2:
            return math.inf
        return ((self.token_times[-1] - self.token_times[0])
                / (len(self.token_times) - 1))


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in (0, 100]): the smallest value
    with at least q% of the values at or below it. ``inf`` entries (the
    failed requests) sort last."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def ttft_p95_ms(records: Sequence[Record]) -> float:
    return 1e3 * percentile([r.ttft_s() for r in records], 95)


def tpot_p95_ms(records: Sequence[Record]) -> float:
    return 1e3 * percentile([r.tpot_s() for r in records], 95)


def tokens_in(records: Sequence[Record], start: float, end: float) -> int:
    """Tokens of finished requests streamed inside [start, end]."""
    return sum(sum(start <= t <= end for t in r.token_times)
               for r in records if r.ok)


def output_tok_s(records: Sequence[Record], start: float,
                 end: float) -> float:
    return tokens_in(records, start, end) / (end - start)


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, the run-to-run spread a bound is set from."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
