"""95th percentile over every request offered in the window of the time
from its scheduled send to its first streamed token; a failed request
counts as past every limit."""

from gpubench import stats


def read(window):
    return stats.ttft_p95_ms(window.records) if window.records else None
