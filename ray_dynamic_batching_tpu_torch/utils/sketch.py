"""Mergeable relative-error quantile sketch (DDSketch-style).

Own copy of ``ray_dynamic_batching_tpu/utils/sketch.py``, whole, with
its import paths rewritten.

The latency budget ledger needs percentiles that (a) hold a guaranteed
error bound so a budget ceiling means something, (b) merge across
processes/files/shards associatively so per-hop sketches from N capture
files aggregate into one fleet view, and (c) serialize byte-
deterministically so CI can diff them. A :class:`RollingWindow` gives
exact percentiles but only over its last N observations, does not merge,
and costs an O(n log n) sort per read on the hot path; a Prometheus
histogram merges but its percentile is a bucket upper bound whose error
is unbounded relative to the true value (see
``utils.metrics.Histogram.percentile``).

DDSketch (Masson et al., VLDB '19) fixes all three: logarithmic buckets
``[gamma^(i-1), gamma^i]`` with ``gamma = (1+alpha)/(1-alpha)`` guarantee
every reported quantile ``q`` satisfies ``|q - q_true| <= alpha *
q_true`` (relative, not absolute — exactly what latency percentiles
spanning microseconds to minutes need), buckets are integer counts so
merge is exact addition (associative, commutative, byte-deterministic),
and the whole state is a sparse int->int map that serializes to sorted
JSON.

Bounded memory: past ``max_bins`` distinct buckets the LOWEST buckets
collapse into one floor bucket (standard DDSketch policy — the high
quantiles the budget ledger gates on keep full accuracy; sub-floor
values degrade toward an upper-bound estimate). Collapse is the one
operation that can break strict merge associativity, so the default
``max_bins`` (2048) is sized to cover 1 us .. ~30 min of latency without
ever collapsing at the default accuracy; the collapse path is still
deterministic for a fixed observation order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock, assert_owner

__all__ = ["QuantileSketch", "RollingSketch"]


class QuantileSketch:
    """DDSketch with a contiguous-from-sparse bucket map.

    API is a strict superset of the deprecated ``RollingWindow``
    (``observe`` / ``percentile`` / ``mean`` / ``__len__``) so hot-path
    call sites swap without adaptation. NOT thread-safe — owners lock
    (the queue's lock already serializes its stats writes, and the
    metric family wraps access in the registry lock).
    """

    def __init__(self, relative_accuracy: float = 0.01,
                 max_bins: int = 2048, min_value: float = 1e-3) -> None:
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError(
                f"relative_accuracy must be in (0, 1), got {relative_accuracy}"
            )
        if max_bins < 2:
            raise ValueError(f"max_bins must be >= 2, got {max_bins}")
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        self.relative_accuracy = float(relative_accuracy)
        self.max_bins = int(max_bins)
        self.min_value = float(min_value)
        self.gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self.gamma)
        self._bins: Dict[int, int] = {}   # bucket index -> count
        self._zero = 0                    # observations in [0, min_value)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    # --- write side -------------------------------------------------------
    def _index(self, value: float) -> int:
        return int(math.ceil(math.log(value) / self._log_gamma))

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` ``n`` times. Negative values are refused
        loudly: every consumer here measures durations, and a negative
        duration is an upstream bug the sketch must not launder into a
        plausible percentile."""
        if n <= 0:
            raise ValueError(f"n must be positive, got {n}")
        value = float(value)
        if value < 0.0 or math.isnan(value) or math.isinf(value):
            raise ValueError(f"cannot observe {value!r} (finite >= 0 only)")
        if value < self.min_value:
            self._zero += n
        else:
            i = self._index(value)
            self._bins[i] = self._bins.get(i, 0) + n
            if len(self._bins) > self.max_bins:
                self._collapse()
        self._count += n
        self._sum += value * n
        self._min = value if self._min is None else min(self._min, value)
        self._max = value if self._max is None else max(self._max, value)

    def _collapse(self) -> None:
        """Fold the lowest bins into one floor bin until ``max_bins``
        holds. Deterministic (sorted index order); preserves total count
        and keeps every bin ABOVE the floor exact, so high quantiles —
        the ones budgets gate — never lose accuracy."""
        indices = sorted(self._bins)
        # Fold exactly the excess: ending at max_bins bins, not
        # max_bins - 1 — each extra folded bin is low-quantile
        # resolution thrown away beyond what the bound requires.
        n_fold = len(indices) - self.max_bins
        floor_idx = indices[n_fold]  # survivors: indices[n_fold:]
        folded = sum(self._bins.pop(i) for i in indices[:n_fold])
        self._bins[floor_idx] += folded

    # --- read side --------------------------------------------------------
    @property
    def count(self) -> int:
        return self._count

    def __len__(self) -> int:
        return self._count

    def sum(self) -> float:
        return self._sum

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def min(self) -> float:
        return self._min if self._min is not None else 0.0

    def max(self) -> float:
        return self._max if self._max is not None else 0.0

    def quantile(self, p: float) -> float:
        """Value at quantile ``p`` in [0, 1], within ``relative_accuracy``
        of the true rank value (nearest-rank, the live queue's rule).
        0.0 on an empty sketch — the callers' no-data convention."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {p}")
        if self._count == 0:
            return 0.0
        target = max(1, math.ceil(p * self._count))
        if target <= self._zero:
            return 0.0
        cum = self._zero
        for i in sorted(self._bins):
            cum += self._bins[i]
            if cum >= target:
                # Bucket i covers (gamma^(i-1), gamma^i]; the midpoint
                # estimate 2*gamma^i/(gamma+1) is within alpha of every
                # value in the bucket. Clamp to the observed extremes so
                # a single-value sketch reads back that value.
                est = 2.0 * (self.gamma ** i) / (self.gamma + 1.0)
                lo = self._min if self._min is not None else est
                hi = self._max if self._max is not None else est
                return min(max(est, lo), hi)
        return self._max if self._max is not None else 0.0

    def percentile(self, p: float) -> float:
        """RollingWindow-compatible alias of :meth:`quantile`."""
        return self.quantile(p)

    # --- merge + serialization -------------------------------------------
    def _compatible(self, other: "QuantileSketch") -> None:
        if (other.relative_accuracy != self.relative_accuracy
                or other.min_value != self.min_value):
            raise ValueError(
                "cannot merge sketches with different parameters "
                f"(alpha {self.relative_accuracy} vs "
                f"{other.relative_accuracy}, min_value {self.min_value} "
                f"vs {other.min_value}) — a silently re-bucketed merge "
                "would void the error bound"
            )

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch (exact integer bucket adds:
        associative and commutative as long as neither side collapses).
        Returns self for chaining."""
        self._compatible(other)
        for i, n in other._bins.items():
            self._bins[i] = self._bins.get(i, 0) + n
        if len(self._bins) > self.max_bins:
            self._collapse()
        self._zero += other._zero
        self._count += other._count
        self._sum += other._sum
        for v in (other._min,):
            if v is not None:
                self._min = v if self._min is None else min(self._min, v)
        for v in (other._max,):
            if v is not None:
                self._max = v if self._max is None else max(self._max, v)
        return self

    @classmethod
    def merged(cls, sketches: Iterable["QuantileSketch"],
               **kwargs: Any) -> "QuantileSketch":
        """A fresh sketch holding the union of ``sketches``."""
        out: Optional[QuantileSketch] = None
        for s in sketches:
            if out is None:
                out = cls(relative_accuracy=s.relative_accuracy,
                          max_bins=s.max_bins, min_value=s.min_value)
            out.merge(s)
        return out if out is not None else cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        """Canonical serialization: sorted integer bin keys (as strings —
        JSON object keys), so ``json.dumps(..., sort_keys=True)`` of two
        equal sketches is byte-identical."""
        return {
            "kind": "ddsketch",
            "relative_accuracy": self.relative_accuracy,
            "max_bins": self.max_bins,
            "min_value": self.min_value,
            "zero": self._zero,
            "count": self._count,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "bins": {str(i): self._bins[i] for i in sorted(self._bins)},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantileSketch":
        if d.get("kind") != "ddsketch":
            raise ValueError(f"not a ddsketch payload: kind={d.get('kind')!r}")
        out = cls(relative_accuracy=float(d["relative_accuracy"]),
                  max_bins=int(d["max_bins"]),
                  min_value=float(d["min_value"]))
        out._zero = int(d.get("zero", 0))
        out._count = int(d.get("count", 0))
        out._sum = float(d.get("sum", 0.0))
        out._min = None if d.get("min") is None else float(d["min"])
        out._max = None if d.get("max") is None else float(d["max"])
        out._bins = {int(k): int(v) for k, v in (d.get("bins") or {}).items()}
        return out

    def summary(self, quantiles: Iterable[float] = (0.5, 0.95, 0.99)
                ) -> Dict[str, float]:
        """Small stats block for reports: count + requested quantiles."""
        out: Dict[str, float] = {"count": float(self._count)}
        for q in quantiles:
            out[f"p{round(q * 100):d}_ms"] = self.quantile(q)
        return out

    def __repr__(self) -> str:
        return (f"QuantileSketch(alpha={self.relative_accuracy}, "
                f"count={self._count}, bins={len(self._bins)})")


class RollingSketch:
    """Recency-bounded quantile sketch: two :class:`QuantileSketch`
    epochs rotated every ``window`` observations, reads merged over
    both.

    Compliance signals (the queue's retry hints, failover's queue-health
    p50) need percentiles that track the LAST ~window completions — a
    cumulative sketch never forgets, so after hours of healthy traffic
    an overload's slow samples are a vanishing minority and the signal
    reports the healthy past long into the incident. Rotation bounds
    staleness: a read reflects at most the last ``2 * window``
    observations (current epoch + the sealed previous one), matching the
    deprecated ``RollingWindow(window)``'s recency contract while
    keeping the sketch's error bound (epoch merge is exact) and O(bins)
    reads instead of an O(n log n) sort under the owner's lock.

    Same read/write surface as :class:`QuantileSketch`, and — unlike
    the bare sketch — THREAD-SAFE, because its call sites are cross-
    thread by design: the engine thread observes completions while the
    failover worker and monitoring threads read percentiles with no
    shared lock (the contract ``RollingWindow`` held via its internal
    lock; without one, a concurrent observe mutates the bin dict under
    the sorted-bin walk of a reader's quantile and raises "dictionary
    changed size during iteration").
    """

    def __init__(self, window: int = 1000,
                 relative_accuracy: float = 0.01,
                 max_bins: int = 2048, min_value: float = 1e-3) -> None:
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.window = int(window)
        self._params = dict(relative_accuracy=relative_accuracy,
                            max_bins=max_bins, min_value=min_value)
        self._cur = QuantileSketch(**self._params)
        self._prev: Optional[QuantileSketch] = None
        self._total = 0
        self._lock = OrderedLock("sketch")

    @property
    def relative_accuracy(self) -> float:
        return self._cur.relative_accuracy  # rdb-lint: disable=lock-discipline (config read: every epoch's sketch is built from the same _params, so either epoch object answers identically)

    def observe(self, value: float, n: int = 1) -> None:
        with self._lock:
            if self._cur.count >= self.window:
                self._prev, self._cur = (
                    self._cur, QuantileSketch(**self._params)
                )
            self._cur.observe(value, n)
            self._total += n

    def _view(self) -> QuantileSketch:
        """Caller must hold ``self._lock``."""
        assert_owner(self._lock)
        if self._prev is None:
            return self._cur
        merged = QuantileSketch(**self._params)
        merged.merge(self._prev)
        merged.merge(self._cur)
        return merged

    def view(self) -> QuantileSketch:
        """A point-in-time COPY of the recency-bounded read view — safe
        to hold, read, or :meth:`QuantileSketch.merged` across instances
        (cross-queue aggregation) without this sketch's lock."""
        with self._lock:
            out = QuantileSketch(**self._params)
            out.merge(self._cur)
            if self._prev is not None:
                out.merge(self._prev)
            return out

    @property
    def count(self) -> int:
        """Observations in the current read view (recency-bounded);
        ``total`` counts everything ever observed."""
        with self._lock:
            return self._cur.count + (0 if self._prev is None
                                      else self._prev.count)

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def __len__(self) -> int:
        return self.count

    def mean(self) -> float:
        with self._lock:
            return self._view().mean()

    def min(self) -> float:
        with self._lock:
            return self._view().min()

    def max(self) -> float:
        with self._lock:
            return self._view().max()

    def quantile(self, p: float) -> float:
        with self._lock:
            return self._view().quantile(p)

    def percentile(self, p: float) -> float:
        return self.quantile(p)

    def summary(self, quantiles: Iterable[float] = (0.5, 0.95, 0.99)
                ) -> Dict[str, float]:
        with self._lock:
            return self._view().summary(quantiles)

    def __repr__(self) -> str:
        return (f"RollingSketch(window={self.window}, "
                f"count={self.count}, total={self._total})")  # rdb-lint: disable=lock-discipline (debug repr: a torn count is cosmetic, and taking the lock here could self-deadlock a log line emitted under it)
