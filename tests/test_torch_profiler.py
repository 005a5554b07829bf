"""The port's profiler times a forward as the reference does.

``profiles/profiler.py::timed_steps_ms`` follows the reference's rule
(``ray_dynamic_batching_tpu/profiles/profiler.py:58-79``): after the warmup
dispatches, three samples, each dispatching ``iters`` forwards and ending
with ONE scalar fetch of the last output. The output's transfer to the host
is not part of a row: a [B, T, V] logits tensor read back whole would price
gigabytes of copy into every step. The spy below records every host read of
a forward's output and how many elements it moved.
"""

from __future__ import annotations

import torch

from ray_dynamic_batching_tpu_torch.models.base import ServableModel
from ray_dynamic_batching_tpu_torch.profiles import profiler

_READS = ("cpu", "item", "numpy", "tolist", "__float__", "__int__")


class _Spy(torch.Tensor):
    """A tensor that logs each host read made of it or of anything
    computed from it: (operation, elements read)."""

    log: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _READS and args and isinstance(args[0], torch.Tensor):
            cls.log.append((name, args[0].numel()))
        return super().__torch_function__(func, types, args, kwargs or {})


class _Wide(ServableModel):
    """A forward whose output is [B, T, V]: what ``CausalLM.apply``
    returns."""

    name = "wide"

    def __init__(self, vocab: int):
        super().__init__(torch.float32, "cpu")
        self.vocab = vocab
        self.calls = 0

    def forward(self, tokens):
        self.calls += 1
        B, T = tokens.shape
        out = torch.ones((B, T, self.vocab)).as_subclass(_Spy)
        return out * tokens[..., None].float()

    def example_inputs(self, batch_size, seq_len=None):
        return (torch.ones((batch_size, seq_len or 4)),)


def _reads(vocab: int, iters: int, warmup: int):
    _Spy.log = []
    model = _Wide(vocab)
    samples = profiler.timed_steps_ms(
        model, model.example_inputs(2, 8), iters=iters, warmup=warmup)
    return samples, model.calls, list(_Spy.log)


def test_each_sample_reads_one_element_whatever_the_output_size():
    """Warmup and every sample end with one fetch of ONE element; the
    forwards themselves read nothing back. The reads do not grow with the
    output (a 16x wider vocabulary reads the same), where a whole-output
    fetch per step read B*T*V elements a forward."""
    for vocab in (64, 1024):
        samples, calls, log = _reads(vocab, iters=3, warmup=2)
        assert calls == 2 + 3 * 3
        assert len(samples) == 3 and all(s >= 0.0 for s in samples)
        assert [n for _, n in log] == [1, 1, 1, 1], log


def test_profile_bucket_fetches_one_element_per_sample():
    """``ModelProfiler.profile_bucket``: the first dispatch (compile_ms)
    and each timed sample end with a one-element fetch."""
    _Spy.log = []
    model = _Wide(512)
    row = profiler.ModelProfiler(model, warmup_iters=2,
                                 timing_iters=4).profile_bucket(2, 8)
    assert row is not None and row.latency_ms >= 0.0
    assert [n for _, n in _Spy.log] == [1] * 5, _Spy.log
    assert model.calls == 1 + 1 + 3 * 4
