"""Output tokens streamed inside the window, over the window."""

from gpubench import stats


def read(window):
    return stats.output_tok_s(window.records, window.start, window.end)
