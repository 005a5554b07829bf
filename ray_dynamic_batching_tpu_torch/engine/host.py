"""Model hosting: reference-counted servable models on one device.

Port of ``ray_dynamic_batching_tpu/engine/host.py``: ``acquire`` builds a
model once (the registry's factory with ``model_kwargs``, random weights
from ``seed`` on ``device``) and counts its holders; ``release`` drops a
reference, and the last one frees the weights (the tensors go with the
module; the caching allocator keeps their blocks for reuse). A holder may
load other weights into the shared model (the tests load the JAX
package's params through ``models/convert.py``).

Checkpoints: with ``checkpoint_dir``, a model whose directory
``<checkpoint_dir>/<model name>`` exists is restored from it instead of
drawn from ``seed`` (the reference's rule: a model with no checkpoint is
initialized); ``save_checkpoint`` writes one there. The reference uses
orbax; the port writes ``runtime/checkpoint.py``'s format (npz leaves +
manifest), the tree being the model's ``state_dict`` (parameters and
buffers, by the port's names). A checkpoint that exists but does not
restore raises, where the reference logs it and initializes.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from ray_dynamic_batching_tpu_torch.models.base import (
    ServableModel,
    get_model,
    resolve_device,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("host")


class ModelHost:
    """Reference-counted (model name -> model) cache for one process."""

    def __init__(self, checkpoint_dir: Optional[str] = None, seed: int = 0,
                 model_kwargs: Optional[Dict[str, Dict[str, Any]]] = None,
                 device: str = "cuda"):
        from ray_dynamic_batching_tpu_torch.utils.compile_cache import (
            maybe_enable,
        )

        maybe_enable()  # kernel libraries built once are reused
        self.checkpoint_dir = checkpoint_dir
        self.seed = seed
        self.model_kwargs = model_kwargs or {}
        self.device = resolve_device(device)
        self._loaded: Dict[str, ServableModel] = {}
        self._refcounts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _checkpoint_path(self, name: str) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        path = os.path.join(self.checkpoint_dir, name)
        return path if os.path.isdir(path) else None

    def _build(self, name: str) -> ServableModel:
        from ray_dynamic_batching_tpu_torch.runtime.checkpoint import (
            restore_pytree,
        )

        kwargs = {"device": self.device, **self.model_kwargs.get(name, {})}
        path = self._checkpoint_path(name)
        if path is None:
            return get_model(name, seed=self.seed, **kwargs).eval()
        model = get_model(name, seed=None, **kwargs)
        model.load_state_dict(
            restore_pytree(path, model.state_dict(), device=self.device))
        logger.info("%s: restored checkpoint from %s", name, path)
        return model.eval()

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
        """Persist a loaded model's weights under ``<dir>/<name>``."""
        from ray_dynamic_batching_tpu_torch.runtime.checkpoint import (
            save_pytree,
        )

        with self._lock:
            if name not in self._loaded:
                raise KeyError(f"{name} not loaded")
            model = self._loaded[name]
        base = out_dir or self.checkpoint_dir
        if base is None:
            raise ValueError("no checkpoint_dir configured")
        path = os.path.abspath(os.path.join(base, name))
        save_pytree(path, dict(model.state_dict()))
        return path
