"""Offline model profiler — sweeps batch buckets of a model's forward.

Port of ``ray_dynamic_batching_tpu/profiles/profiler.py``
(:class:`ModelProfiler`, :func:`timed_steps_ms`, :func:`_is_oom` and
:func:`write_profile_outputs`, the summary.csv / detailed.json /
report.txt writer every profile family shares). The reference's
``ModelProfiler`` (``293-project/profiling/ModelProfiler.py:92-109``
CUDA-event timing, ``:85-90`` peak memory, ``:163-211`` OOM tolerance and
early stop) swept power-of-two buckets; so does this one. Where eager
torch on a card differs from the reference's compiled programs:

- **``compile_ms``** is the bucket's first dispatch (forward + one
  scalar fetch), as ``profiles/decode_profiler.py`` reads it: eager torch
  compiles nothing, and that dispatch pays the library's first look at
  the shapes.
- **Timing** is the reference's rule (:func:`timed_steps_ms`): three
  samples, each dispatching ``timing_iters`` forwards and ending with one
  scalar fetch of the last output (the card runs them in order, so that
  fetch observes every step); a sample's time is divided by its
  ``timing_iters``. The row is their mean and spread. A served step
  (``engine/worker.py``) still fetches its whole output: it returns its
  results.
- **``hbm_bytes``** is the model's weight bytes + the bucket's input
  bytes + the first dispatch's measured peak transient
  (``torch.cuda.reset_peak_memory_stats`` before it,
  ``max_memory_allocated`` less ``memory_allocated`` after). On the CPU
  the transient is not measured and is left out.
- **OOM**: :func:`_is_oom` also recognizes ``torch.cuda.OutOfMemoryError``
  (a card's allocator failure marks a bucket infeasible, as XLA's
  ``RESOURCE_EXHAUSTED`` does in the reference); after
  ``max_consecutive_errors`` the sweep stops early.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.models.base import ServableModel
from ray_dynamic_batching_tpu_torch.profiles.table import (
    BatchProfile,
    ProfileRow,
    default_batch_buckets,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("torch.profiler")


def _is_oom(err: Exception) -> bool:
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg or "OOM" in msg


def _fetch_scalar(out) -> float:
    """Host fetch of one element of ``out`` (its first tensor's first
    element): the completion signal of every step dispatched before it
    (reference ``profiler.py:51-55``)."""
    leaf = out[0] if isinstance(out, (tuple, list)) else out
    return float(leaf.reshape(-1)[0].item())


def timed_steps_ms(model: ServableModel, inputs, iters: int,
                   warmup: int = 1) -> List[float]:
    """Per-step latency samples of ``model`` on ``inputs`` (reference
    ``profiler.py:58-79``): ``warmup`` dispatches and one scalar fetch,
    then three samples, each ``iters`` dispatches ended by one scalar
    fetch of the last output, divided by ``iters``. Per-call dispatch
    overhead is included; the output's transfer to the host is not."""
    with torch.inference_mode():
        out = None
        for _ in range(max(warmup, 1)):
            out = model(*inputs)
        _fetch_scalar(out)
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = model(*inputs)
            _fetch_scalar(out)
            samples.append((time.perf_counter() - t0) * 1000.0 / iters)
    return samples


class ModelProfiler:
    """Profiles one model's forward across batch buckets."""

    def __init__(
        self,
        model: ServableModel,
        warmup_iters: int = 2,
        timing_iters: int = 5,
        max_consecutive_errors: int = 3,
    ):
        from ray_dynamic_batching_tpu_torch.utils.compile_cache import (
            maybe_enable,
        )

        maybe_enable()  # sweep re-runs reuse the built kernel libraries
        self.model = model
        self.warmup_iters = warmup_iters
        self.timing_iters = timing_iters
        self.max_consecutive_errors = max_consecutive_errors

    def profile_bucket(
        self, batch_size: int, seq_len: int = 0
    ) -> Optional[ProfileRow]:
        """First dispatch + timed steps of one bucket; None if it runs out
        of device memory."""
        device = self.model.device
        cuda = device.type == "cuda"
        try:
            inputs = self.model.example_inputs(batch_size, seq_len or None)
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                _fetch_scalar(self.model(*inputs))
            compile_ms = (time.perf_counter() - t0) * 1000.0
            transient = 0
            if cuda:
                transient = max(0, torch.cuda.max_memory_allocated(device)
                                - torch.cuda.memory_allocated(device))
            samples = timed_steps_ms(
                self.model, inputs, iters=max(self.timing_iters, 2),
                warmup=self.warmup_iters - 1,
            )
        except Exception as e:  # noqa: BLE001 — only OOM is tolerated
            if _is_oom(e):
                logger.warning(
                    "%s batch=%d seq=%d infeasible (OOM)",
                    self.model.name, batch_size, seq_len,
                )
                return None
            raise
        hbm_bytes = (self.model.param_bytes() + transient
                     + sum(x.numel() * x.element_size() for x in inputs))
        return ProfileRow(
            batch_size=batch_size,
            seq_len=seq_len,
            latency_ms=float(np.mean(samples)),
            latency_std_ms=float(np.std(samples)),
            hbm_bytes=hbm_bytes,
            compile_ms=compile_ms,
        )

    def sweep(
        self,
        batch_buckets: Optional[Sequence[int]] = None,
        seq_buckets: Sequence[int] = (0,),
        max_batch: int = 512,
    ) -> BatchProfile:
        """Full sweep (ref: ProfilerRunner loop, run_profiler.py:191-211)."""
        buckets = list(batch_buckets or default_batch_buckets(max_batch))
        profile = BatchProfile(self.model.name)
        for seq in seq_buckets:
            consecutive_errors = 0
            for b in buckets:
                row = self.profile_bucket(b, seq)
                if row is None:
                    consecutive_errors += 1
                    if consecutive_errors >= self.max_consecutive_errors:
                        logger.warning(
                            "%s: stopping sweep at seq=%d after %d errors",
                            self.model.name, seq, consecutive_errors,
                        )
                        break
                    continue
                consecutive_errors = 0
                profile.add(row)
                logger.info(
                    "%s b=%d s=%d: %.2f ms, %.1f sps, %.0f MB, first "
                    "dispatch %.0f ms",
                    self.model.name, b, seq, row.latency_ms,
                    row.with_throughput().throughput_sps,
                    row.hbm_bytes / 1e6, row.compile_ms,
                )
        return profile

    def write_outputs(self, profile: BatchProfile, out_dir: str
                      ) -> Tuple[str, str, str]:
        """Persist summary.csv / detailed.json / report.txt (reference
        contract, ``ModelProfiler.py:224-371``)."""
        return write_profile_outputs(profile, out_dir)


def write_profile_outputs(
    profile: BatchProfile, out_dir: str
) -> Tuple[str, str, str]:
    """Shared writer for every profile family (forward-pass, decode,
    prefill): summary.csv / detailed.json / report.txt keyed by the
    profile's model_name."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, profile.model_name)
    csv_path, json_path, report_path = (
        base + "_summary.csv", base + "_detailed.json", base + "_report.txt",
    )
    profile.to_csv(csv_path)
    with open(json_path, "w") as f:
        f.write(profile.to_json())
    with open(report_path, "w") as f:
        f.write(profile.report())
    return csv_path, json_path, report_path
