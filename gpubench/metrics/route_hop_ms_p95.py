"""The serve layer's hop (``serve/handle.py`` ``remote_stream`` with
``serve/router.py``'s ``router.assign`` inside it): 95th percentile of
the window's ``handle.remote_stream`` spans."""

from gpubench import stats


def read(window):
    ms = window.span_ms("handle.remote_stream")
    return stats.percentile(ms, 95) if ms else None
