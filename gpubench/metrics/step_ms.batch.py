"""The engine's decode turn (``engine/decode.py``): milliseconds a step,
the ``decode.turn`` spans of the window summed over the steps they ran."""

from gpubench.metrics._steps import step_ms


def read(window):
    return step_ms(window)
