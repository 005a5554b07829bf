"""The whole step, over the device trace's part of the window: the model
FLOPs of its prompts and decoded tokens (attention included; the head
where a token needs logits) over the part's length at the bf16 peak, in
percent. Prompts count whole where their first token came inside it."""

from gpubench import costs


def read(window):
    window = window.traced_part()
    if window is None:
        return None
    s = window.shapes
    flops = sum(costs.token_flops(s, keys, True) for keys in window.decoded())
    flops += sum(costs.prompt_flops(s, p) for p in window.prefilled())
    return 100.0 * flops / (window.seconds * costs.PEAK_BF16_FLOPS)
