"""95th percentile over every request offered in the window of (last
token - first token) / (tokens - 1), as streamed to the client; a failed
request counts as past every limit."""

from gpubench import stats


def read(window):
    return stats.tpot_p95_ms(window.records) if window.records else None
