"""Metrics primitives: Counter / Gauge / Histogram with Prometheus exposition.

Own copy of ``ray_dynamic_batching_tpu/utils/metrics.py`` with its
import paths rewritten; its default registry is the port's own, separate
from the JAX package's. Trimmed: the deprecated ``RollingWindow`` shim.

TPU-native analogue of the reference's metric stack
(``python/ray/util/metrics.py:137,187,262`` user API;
``src/ray/stats/metric_defs.cc`` native registry;
``python/ray/_private/metrics_agent.py:483`` Prometheus export). Pure Python,
lock-protected, with a text exposition endpoint consumed by ``serve.ingress``.
"""

from __future__ import annotations

import bisect
import math
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch

TagMap = Tuple[Tuple[str, str], ...]

# Overflow bucket for bounded tag keys: once a key has minted its cap of
# distinct values, every further value collapses here — client-controlled
# identifiers (tenants) must not mint unbounded series cardinality.
OTHER_LABEL = "__other__"

# Default top-K for tenant labels (override per metric via bounded_tags).
DEFAULT_TENANT_TOP_K = 16

# Default top-K for front-door shard labels on proxy/router families: the
# shard id is infrastructure-controlled (not client input) but scales with
# the front-door fleet, so it is bounded the same way — a misconfigured
# 200-shard ring must not mint 200x series cardinality per family.
DEFAULT_SHARD_TOP_K = 8


def _tags(tags: Optional[Dict[str, str]]) -> TagMap:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (),
                 bounded_tags: Optional[Dict[str, int]] = None):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        # tag key -> max distinct values; first-come keeps its own series,
        # overflow collapses to OTHER_LABEL (top-K by arrival order — the
        # stable tenants of a deployment register early and stay named).
        self.bounded_tags = dict(bounded_tags or {})
        self._bounded_seen: Dict[str, set] = {}
        self._lock = OrderedLock("metrics")
        _default_registry.register(self)

    def _normalize_tags(
        self, tags: Optional[Dict[str, str]], claim: bool = True
    ) -> Optional[Dict[str, str]]:
        """Collapse over-cap values of bounded tag keys to OTHER_LABEL.
        Applied on every write AND read so an overflowed value always
        addresses the same (overflow) series. Only WRITES claim a named
        top-K slot (``claim=True``); a read for a never-written value
        must not consume a slot a real series could still take."""
        if not self.bounded_tags or not tags:
            return tags
        out = None
        for key, cap in self.bounded_tags.items():
            value = (out or tags).get(key)
            if value is None or value == OTHER_LABEL:
                continue
            with self._lock:
                seen = self._bounded_seen.setdefault(key, set())
                if value in seen:
                    continue
                if len(seen) < cap:
                    if claim:
                        seen.add(value)
                    continue
            if out is None:
                out = dict(tags)
            out[key] = OTHER_LABEL
        return out if out is not None else tags

    def _check_tags(self, tags: Optional[Dict[str, str]]) -> None:
        # Declared tag_keys are enforced both ways (ref: ray.util.metrics API):
        # a typo'd OR omitted key fails loudly instead of minting a silent
        # parallel series.
        if self.tag_keys:
            given = set(tags or {})
            unknown = given - set(self.tag_keys)
            missing = set(self.tag_keys) - given
            if unknown or missing:
                raise ValueError(
                    f"metric {self.name!r}: tag keys mismatch "
                    f"(unknown={sorted(unknown)}, missing={sorted(missing)}); "
                    f"declared: {sorted(self.tag_keys)}"
                )

    def _prom_lines(self, exemplars: bool = False) -> Iterable[str]:
        # pragma: no cover - overridden
        return ()


class Counter(Metric):
    """Monotonically increasing counter (ref: util/metrics.py:137)."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (),
                 bounded_tags: Optional[Dict[str, int]] = None):
        super().__init__(name, description, tag_keys, bounded_tags)
        self._values: Dict[TagMap, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc requires value >= 0")
        self._check_tags(tags)
        key = _tags(self._normalize_tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        key = _tags(self._normalize_tags(tags, claim=False))
        with self._lock:
            return self._values.get(key, 0.0)

    def _prom_lines(self, exemplars: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.description}"
        yield f"# TYPE {self.name} counter"
        with self._lock:
            for tags, v in self._values.items():
                yield f"{self.name}{_fmt_tags(tags)} {v}"


class Gauge(Metric):
    """Point-in-time value (ref: util/metrics.py:262)."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (),
                 bounded_tags: Optional[Dict[str, int]] = None):
        super().__init__(name, description, tag_keys, bounded_tags)
        self._values: Dict[TagMap, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        self._check_tags(tags)
        key = _tags(self._normalize_tags(tags))
        with self._lock:
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        self._check_tags(tags)
        key = _tags(self._normalize_tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        self.inc(-value, tags)

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        key = _tags(self._normalize_tags(tags, claim=False))
        with self._lock:
            return self._values.get(key, 0.0)

    def _prom_lines(self, exemplars: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.description}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            for tags, v in self._values.items():
                yield f"{self.name}{_fmt_tags(tags)} {v}"


DEFAULT_LATENCY_BOUNDARIES_MS = (
    1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000
)


def _current_trace_id() -> Optional[str]:
    """Trace id of the active span, if the tracer is recording (exemplar
    auto-capture). Local import: metrics must stay importable before/without
    the tracing module in degraded environments."""
    try:
        from ray_dynamic_batching_tpu_torch.utils.tracing import tracer
    except ImportError:  # pragma: no cover - only in stripped builds
        return None
    t = tracer()
    return t.current_trace_id() if t.enabled else None


class Histogram(Metric):
    """Cumulative-bucket histogram (ref: util/metrics.py:187).

    Buckets carry OpenMetrics **exemplars**: the last observation landing in
    each bucket remembers the trace_id that produced it (from the active
    span, or passed explicitly), so a slow ``/metrics`` bucket links
    straight to the flight-record trace that landed in it.
    """

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Sequence[float] = DEFAULT_LATENCY_BOUNDARIES_MS,
        tag_keys: Sequence[str] = (),
        bounded_tags: Optional[Dict[str, int]] = None,
        track_quantiles: bool = False,
        relative_accuracy: float = 0.01,
    ):
        super().__init__(name, description, tag_keys, bounded_tags)
        self.boundaries = tuple(sorted(boundaries))
        self._buckets: Dict[TagMap, list] = {}
        self._sum: Dict[TagMap, float] = {}
        self._count: Dict[TagMap, int] = {}
        # Per (tags, bucket): (value, trace_id, unix_ts) of the most recent
        # traced observation in that bucket.
        self._exemplars: Dict[TagMap, list] = {}
        # Optional per-series quantile sketch: where a histogram already
        # carries exemplars (a latency family an operator reads
        # percentiles from), ``track_quantiles=True`` makes
        # :meth:`percentile` error-bounded instead of bucket-biased.
        # The exposition is unchanged — buckets and exemplars still
        # render; the sketch only backs in-process reads.
        self._sketch_accuracy = relative_accuracy if track_quantiles else None
        self._sketches: Dict[TagMap, QuantileSketch] = {}

    def observe(
        self,
        value: float,
        tags: Optional[Dict[str, str]] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        self._check_tags(tags)
        key = _tags(self._normalize_tags(tags))
        idx = bisect.bisect_left(self.boundaries, value)
        if trace_id is None:
            trace_id = _current_trace_id()
        with self._lock:
            buckets = self._buckets.setdefault(key, [0] * (len(self.boundaries) + 1))
            buckets[idx] += 1
            self._sum[key] = self._sum.get(key, 0.0) + value
            self._count[key] = self._count.get(key, 0) + 1
            if self._sketch_accuracy is not None and value >= 0.0:
                sk = self._sketches.get(key)
                if sk is None:
                    sk = self._sketches[key] = QuantileSketch(
                        relative_accuracy=self._sketch_accuracy
                    )
                sk.observe(value)
            if trace_id:
                ex = self._exemplars.setdefault(
                    key, [None] * (len(self.boundaries) + 1)
                )
                ex[idx] = (value, trace_id, time.time())

    def percentile(self, p: float, tags: Optional[Dict[str, str]] = None) -> float:
        """Approximate percentile.

        KNOWN BIAS (bucket path): the default implementation returns the
        UPPER BOUND of the cumulative bucket the rank lands in — e.g.
        with the default boundaries an observation set of all 21 ms
        reads back p50 = 50 ms, a 2.4x overstatement, and anything past
        the last boundary reads ``inf``. The error is unbounded relative
        to the true value (it depends entirely on where the boundaries
        fall), so alerting math on this path compares apples to bucket
        edges. Construct the histogram with ``track_quantiles=True`` to
        back this read with a relative-error quantile sketch
        (``utils.sketch.QuantileSketch``): the bias drops to the
        configured ``relative_accuracy`` while the exposition stays a
        plain histogram.
        """
        key = _tags(self._normalize_tags(tags, claim=False))
        with self._lock:
            sk = self._sketches.get(key)
            if sk is not None:
                return sk.quantile(p)
            buckets = self._buckets.get(key)
            total = self._count.get(key, 0)
        if not buckets or total == 0:
            return 0.0
        target = math.ceil(total * p)
        cum = 0
        for i, c in enumerate(buckets):
            cum += c
            if cum >= target:
                return self.boundaries[i] if i < len(self.boundaries) else float("inf")
        return float("inf")

    @staticmethod
    def _exemplar_suffix(ex) -> str:
        """OpenMetrics exemplar: `` # {trace_id="..."} value timestamp``."""
        if ex is None:
            return ""
        value, trace_id, ts = ex
        return f' # {{trace_id="{_escape_label(trace_id)}"}} {value} {ts:.3f}'

    def _prom_lines(self, exemplars: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.description}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            for key, buckets in self._buckets.items():
                # Exemplar suffixes are OpenMetrics syntax — emitted only
                # for OpenMetrics renders; the classic 0.0.4 text format
                # (a stock Prometheus scraper) must stay suffix-free or
                # the whole scrape fails to parse.
                ex = self._exemplars.get(key) if exemplars else None
                cum = 0
                for i, (b, c) in enumerate(zip(self.boundaries, buckets)):
                    cum += c
                    t = key + (("le", str(b)),)
                    yield (f"{self.name}_bucket{_fmt_tags(t)} {cum}"
                           + self._exemplar_suffix(ex[i] if ex else None))
                cum += buckets[-1]
                t = key + (("le", "+Inf"),)
                yield (f"{self.name}_bucket{_fmt_tags(t)} {cum}"
                       + self._exemplar_suffix(ex[-1] if ex else None))
                yield f"{self.name}_sum{_fmt_tags(key)} {self._sum.get(key, 0.0)}"
                yield f"{self.name}_count{_fmt_tags(key)} {self._count.get(key, 0)}"


class Sketch(Metric):
    """First-class mergeable quantile-sketch family (DDSketch-backed).

    One :class:`~ray_dynamic_batching_tpu_torch.utils.sketch.QuantileSketch`
    per tag set. Exposed in the OpenMetrics/Prometheus ``summary``
    grammar — ``name{quantile="0.5"} v`` lines plus ``_sum``/``_count``
    — the one exposition type built for pre-computed quantiles. Unlike a
    native Prometheus summary the underlying state MERGES (sketch bucket
    adds are exact), so per-process series aggregate without the
    classic "can't average percentiles" trap; ``sketch_state`` hands the
    raw sketch out for cross-process merges and serialization.
    """

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (),
                 quantiles: Sequence[float] = (0.5, 0.9, 0.95, 0.99),
                 relative_accuracy: float = 0.01,
                 bounded_tags: Optional[Dict[str, int]] = None):
        super().__init__(name, description, tag_keys, bounded_tags)
        if not quantiles or any(not 0.0 <= q <= 1.0 for q in quantiles):
            raise ValueError(f"quantiles must be in [0, 1]: {quantiles}")
        self.quantiles = tuple(sorted(quantiles))
        self.relative_accuracy = float(relative_accuracy)
        self._sketches: Dict[TagMap, QuantileSketch] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self._check_tags(tags)
        key = _tags(self._normalize_tags(tags))
        with self._lock:
            sk = self._sketches.get(key)
            if sk is None:
                sk = self._sketches[key] = QuantileSketch(
                    relative_accuracy=self.relative_accuracy
                )
            sk.observe(value)

    def quantile(self, p: float,
                 tags: Optional[Dict[str, str]] = None) -> float:
        key = _tags(self._normalize_tags(tags, claim=False))
        # Reads stay INSIDE the lock: the bare sketch is unlocked, and a
        # concurrent observe mutating the bin dict under a reader's
        # sorted-bin walk raises "dictionary changed size".
        with self._lock:
            sk = self._sketches.get(key)
            return sk.quantile(p) if sk is not None else 0.0

    def percentile(self, p: float,
                   tags: Optional[Dict[str, str]] = None) -> float:
        return self.quantile(p, tags)

    def count(self, tags: Optional[Dict[str, str]] = None) -> int:
        key = _tags(self._normalize_tags(tags, claim=False))
        with self._lock:
            sk = self._sketches.get(key)
            return sk.count if sk is not None else 0

    def sketch_state(self, tags: Optional[Dict[str, str]] = None
                     ) -> Optional[Dict]:
        """Serialized sketch for this tag set (mergeable across
        processes via ``QuantileSketch.from_dict(...).merge(...)``);
        None when the series was never observed."""
        key = _tags(self._normalize_tags(tags, claim=False))
        with self._lock:
            sk = self._sketches.get(key)
            return sk.to_dict() if sk is not None else None

    def merge_state(self, state: Dict,
                    tags: Optional[Dict[str, str]] = None) -> None:
        """Fold a serialized sketch (another process's
        :meth:`sketch_state`) into this series."""
        incoming = QuantileSketch.from_dict(state)
        self._check_tags(tags)
        key = _tags(self._normalize_tags(tags))
        with self._lock:
            sk = self._sketches.get(key)
            if sk is None:
                self._sketches[key] = incoming
            else:
                sk.merge(incoming)

    def _prom_lines(self, exemplars: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.description}"
        yield f"# TYPE {self.name} summary"
        # Render UNDER the lock (into a list, so the lock is not held
        # across yields): quantile() walks the sketch's sorted bins, and
        # a concurrent observe would mutate the dict mid-walk.
        lines = []
        with self._lock:
            for key, sk in self._sketches.items():
                for q in self.quantiles:
                    # Repr trims the float the way Prometheus clients do
                    # (0.5 not 0.50000): the label value is an opaque
                    # string to the scraper but a float to dashboards.
                    t = key + (("quantile", repr(q)),)
                    lines.append(
                        f"{self.name}{_fmt_tags(t)} {sk.quantile(q)}"
                    )
                lines.append(f"{self.name}_sum{_fmt_tags(key)} {sk.sum()}")
                lines.append(
                    f"{self.name}_count{_fmt_tags(key)} {sk.count}"
                )
        yield from lines


def _escape_label(value: str) -> str:
    # Prometheus exposition requires \\, \", \n escaping in label values.
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_tags(tags: TagMap) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in tags)
    return "{" + inner + "}"


class MetricsRegistry:
    """Process-wide registry; renders the Prometheus text format."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}
        # Same rank as the per-metric locks: the registry snapshots and
        # releases before touching any Metric, so the two
        # are never held together.
        self._lock = OrderedLock("metrics")

    def register(self, metric: Metric) -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(
                    f"metric {metric.name!r} already registered; reuse the "
                    "existing instance (duplicate registration would silently "
                    "drop the earlier metric's data from export)"
                )
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def prometheus_text(self) -> str:
        """Classic Prometheus 0.0.4 text exposition (no exemplars)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m._prom_lines())
        return "\n".join(lines) + "\n"

    def openmetrics_text(self) -> str:
        """OpenMetrics exposition WITH exemplars and the `# EOF` trailer.
        Served when the scraper negotiates ``application/openmetrics-text``
        via Accept — only that grammar permits exemplar suffixes."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m._prom_lines(exemplars=True))
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry


def now_ms() -> float:
    return time.monotonic() * 1000.0
