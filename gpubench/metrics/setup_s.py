"""Set-up: process start to the window's open, the kernel build (a
checkout's first run), the weights, the engine's warmup (graph captures)
and a closed loop's ramp to its steady state included."""


def read(window):
    return window.setup_s
