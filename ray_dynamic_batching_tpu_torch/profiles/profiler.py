"""Shared pieces of the offline profilers, in torch.

Own copy of the parts of ``ray_dynamic_batching_tpu/profiles/profiler.py``
that the decode profiler uses: :func:`_is_oom`, which here also recognizes
``torch.cuda.OutOfMemoryError`` (a card's allocator failure marks a bucket
infeasible, as XLA's ``RESOURCE_EXHAUSTED`` does in the reference), and
:func:`write_profile_outputs`, the summary.csv / detailed.json /
report.txt writer every profile family shares.

Trimmed: ``ModelProfiler`` and ``timed_steps_ms``, which sweep the vision
models' forward programs; they come with the vision servables (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile


def _is_oom(err: Exception) -> bool:
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg or "OOM" in msg


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
