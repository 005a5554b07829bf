"""The engine's decode turn (``engine/decode.py``): slots decoding a step,
the ``active`` count of the window's ``decode.turn`` spans weighted by the
steps each turn ran."""


def read(window):
    turns = window.turns()
    steps = sum(int(s.attributes["horizon"]) for s in turns)
    if not steps:
        return None
    return sum(int(s.attributes["active"]) * int(s.attributes["horizon"])
               for s in turns) / steps
