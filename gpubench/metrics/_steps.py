"""Shared by the ``step_ms.*`` readers: the window's decode turns."""


def step_ms(window):
    """Time of the ``decode.turn`` spans inside the window over
    the steps they ran (each turn runs ``horizon`` steps)."""
    turns = window.turns()
    steps = sum(int(s.attributes["horizon"]) for s in turns)
    if not steps:
        return None
    return sum(s.end_ms - s.start_ms for s in turns) / steps
