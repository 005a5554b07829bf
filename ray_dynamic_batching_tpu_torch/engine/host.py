"""Model hosting: reference-counted servable models on one device.

Port of ``ray_dynamic_batching_tpu/engine/host.py``: ``acquire`` builds a
model once (the registry's factory with ``model_kwargs``, random weights
from ``seed`` on ``device``) and counts its holders; ``release`` drops a
reference, and the last one frees the weights (the tensors go with the
module; the caching allocator keeps their blocks for reuse). A holder may
load other weights into the shared model (the tests load the JAX
package's params through ``models/convert.py``).

Trimmed: ``checkpoint_dir`` and ``save_checkpoint``, orbax checkpoints in
the reference; they raise until ``runtime/checkpoint`` is ported.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_dynamic_batching_tpu_torch.models.base import (
    ServableModel,
    get_model,
    resolve_device,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("host")

_NO_CHECKPOINTS = ("checkpoints need runtime/checkpoint, which is not "
                   "ported yet")


class ModelHost:
    """Reference-counted (model name -> model) cache for one process."""

    def __init__(self, checkpoint_dir: Optional[str] = None, seed: int = 0,
                 model_kwargs: Optional[Dict[str, Dict[str, Any]]] = None,
                 device: str = "cuda"):
        if checkpoint_dir is not None:
            raise NotImplementedError(_NO_CHECKPOINTS)
        self.seed = seed
        self.model_kwargs = model_kwargs or {}
        self.device = resolve_device(device)
        self._loaded: Dict[str, ServableModel] = {}
        self._refcounts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _build(self, name: str) -> ServableModel:
        kwargs = {"device": self.device, **self.model_kwargs.get(name, {})}
        return get_model(name, seed=self.seed, **kwargs).eval()

    def acquire(self, name: str) -> ServableModel:
        """Load (or re-reference) a model. The reference returns (model,
        params); here the weights live in the module."""
        with self._lock:
            if name in self._loaded:
                self._refcounts[name] += 1
                return self._loaded[name]
        model = self._build(name)
        with self._lock:
            if name not in self._loaded:  # lost no race: idempotent either way
                self._loaded[name] = model
                self._refcounts[name] = 0
            self._refcounts[name] += 1
            return self._loaded[name]

    def release(self, name: str) -> None:
        """Drop one reference; the last holder's release frees the weights."""
        with self._lock:
            if name not in self._refcounts:
                return
            self._refcounts[name] -= 1
            if self._refcounts[name] <= 0:
                del self._loaded[name]
                del self._refcounts[name]
                logger.info("%s: unloaded", name)

    def loaded_models(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._refcounts)

    def save_checkpoint(self, name: str, out_dir: Optional[str] = None) -> str:
        raise NotImplementedError(_NO_CHECKPOINTS)
