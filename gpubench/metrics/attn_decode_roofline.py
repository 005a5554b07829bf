"""Decode attention (``ops/decode_attention.py``, kernels 2 and 3 in
``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu``), over
the device trace's part of the window: the cached bytes its decoded
tokens need (each token's own context, each byte read once) at the HBM
peak, over the kernels' device time, in percent."""

from gpubench import costs, devtrace


def read(window):
    window = window.traced_part()
    if window is None:
        return None
    spent = sum(o.end - o.start for o in window.window_ops()
                if devtrace.is_decode_attention(o.name))
    if not spent:
        return None
    keys = sum(window.decoded())
    return 100.0 * costs.decode_kv_least_s(window.shapes, keys) / spent
