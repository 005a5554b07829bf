"""The engine's prefill (``engine/decode.py`` chunk trains): 95th
percentile of the window's ``decode.prefill`` spans (admission to first
token)."""

from gpubench import stats


def read(window):
    ms = window.span_ms("decode.prefill")
    return stats.percentile(ms, 95) if ms else None
