"""The engine queue (``engine/queue.py``): 95th percentile over the
window's requests of their ``queue.wait`` spans, summed per request."""

from gpubench import stats


def read(window):
    per = {}
    for s in window.spans_named("queue.wait"):
        per[s.trace_id] = per.get(s.trace_id, 0.0) + (s.end_ms - s.start_ms)
    return stats.percentile(list(per.values()), 95) if per else None
