"""The weight products (``models/decoder.py`` ``Dense``, the head of
``models/causal_lm.py``), over the device trace's part of the window: the
least time the products of that part need (a weight read a decode step,
the prompt tokens' operations; ``costs.py``) over the GEMM kernels'
device time, in percent. Prompts count whole where their first token
came inside the part."""

from gpubench import costs, devtrace


def read(window):
    window = window.traced_part()
    if window is None:
        return None
    ops = [o for o in window.window_ops() if devtrace.is_gemm(o.name)]
    spent = sum(o.end - o.start for o in ops)
    steps = sum(int(s.attributes["horizon"]) for s in window.turns())
    if not spent or not steps:
        return None
    prompts = window.prefilled()
    need = costs.gemm_least_s(window.shapes, steps,
                              sum(1 for _ in window.decoded()),
                              sum(prompts), len(prompts))
    return 100.0 * need / spent
