"""Collation: request payloads -> bucket-padded input batches on the
model's device.

Port of ``ray_dynamic_batching_tpu/engine/collate.py``: every batch is
padded UP to the scheduled (batch, seq) bucket, so the engine runs one
warmed shape per placement. Each batch is built in pinned host memory
(on a card; pageable on the CPU) and copied to the model's device once.

Payload contracts by model family:
- vision:           np.ndarray [H, W, C] float (NHWC rows)
- text_classifier:  np.ndarray [T] int32 token ids (ragged across requests)
- causal_lm:        np.ndarray [T] int32 prompt tokens
- asr:              np.ndarray [T_frames, n_mels] float mel features
                    (ragged; padded to duration buckets, models/asr.py)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models.base import ServableModel
from ray_dynamic_batching_tpu_torch.utils.tracing import link_to, tracer


def _host_buffer(shape, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


def collate_vision(
    model: ServableModel, requests: List[Request], batch_bucket: int
) -> Tuple[Tuple[torch.Tensor, ...], int]:
    n = len(requests)
    (spec,) = model.input_shapes(batch_bucket)
    batch = _host_buffer(spec.shape, spec.dtype, model.device)
    for i, req in enumerate(requests):
        batch[i] = torch.from_numpy(np.asarray(req.payload, dtype=np.float32))
    return (batch.to(model.device, non_blocking=True),), n


def collate_text(
    model: ServableModel,
    requests: List[Request],
    batch_bucket: int,
    seq_bucket: int,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], int]:
    n = len(requests)
    tokens = np.zeros((batch_bucket, seq_bucket), dtype=np.int32)
    mask = np.zeros((batch_bucket, seq_bucket), dtype=np.int32)
    for i, req in enumerate(requests):
        ids = np.asarray(req.payload, dtype=np.int32)[:seq_bucket]
        tokens[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1
    # Padding rows keep all-zero masks; attention treats them as empty.
    mask[n:, 0] = 1  # at least one valid key so softmax rows are well-formed
    out = []
    for a in (tokens, mask):
        host = _host_buffer(a.shape, torch.int32, model.device)
        host.copy_(torch.from_numpy(a))
        out.append(host.to(model.device, non_blocking=True))
    return (out[0], out[1]), n


def collate_asr(
    model: ServableModel,
    requests: List[Request],
    batch_bucket: int,
    text_bucket: int = 8,
) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """Ragged mel clips -> duration-bucketed (mel, mask) plus a
    start-of-transcript prompt per row, matching ``ASRModel.apply``'s
    signature; padding rows keep one valid frame."""
    from ray_dynamic_batching_tpu_torch.models.asr import collate_audio

    n = len(requests)
    mels = [np.asarray(r.payload, dtype=np.float32) for r in requests]
    mel, mask = collate_audio(mels, batch_bucket)
    tokens = np.zeros((batch_bucket, text_bucket), np.int32)
    tokens[:, 0] = model.cfg.sot_token
    text_mask = np.zeros((batch_bucket, text_bucket), np.int32)
    text_mask[:, 0] = 1
    mask[n:, 0] = 1  # padding rows: one valid frame keeps softmax well-formed
    out = []
    for a in (mel, mask, tokens, text_mask):
        host = _host_buffer(a.shape, torch.from_numpy(a).dtype, model.device)
        host.copy_(torch.from_numpy(a))
        out.append(host.to(model.device, non_blocking=True))
    return tuple(out), n


def collate(
    model: ServableModel,
    requests: List[Request],
    batch_bucket: int,
    seq_bucket: int = 0,
) -> Tuple[Tuple[torch.Tensor, ...], int]:
    if not tracer().enabled:  # keep the disabled hot path allocation-free
        return _collate(model, requests, batch_bucket, seq_bucket)
    with tracer().span(
        "collate.batch",
        links=[link_to(r.trace_ctx) for r in requests],
        model=model.name,
        lane=model.name,
        family=model.family,
        batch_bucket=batch_bucket,
        n=len(requests),
    ):
        return _collate(model, requests, batch_bucket, seq_bucket)


def _collate(
    model: ServableModel,
    requests: List[Request],
    batch_bucket: int,
    seq_bucket: int,
) -> Tuple[Tuple[torch.Tensor, ...], int]:
    if model.family == "vision":
        return collate_vision(model, requests, batch_bucket)
    if model.family in ("text_classifier", "causal_lm"):
        if seq_bucket <= 0:
            seq_bucket = max(
                (len(np.atleast_1d(r.payload)) for r in requests), default=1
            )
        return collate_text(model, requests, batch_bucket, seq_bucket)
    if model.family == "asr":
        return collate_asr(model, requests, batch_bucket)
    raise ValueError(f"no collator for model family {model.family!r}")
