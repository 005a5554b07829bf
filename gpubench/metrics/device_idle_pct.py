"""The device, over the device trace's part of the window: the share in
which no operation ran (the union of the operations' intervals, not
their sum), in percent."""

from gpubench import devtrace


def read(window):
    window = window.traced_part()
    if window is None:
        return None
    ops = window.window_ops()
    if not ops:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(ops) / window.seconds)
