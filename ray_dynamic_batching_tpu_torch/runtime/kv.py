"""Cluster KV store — the control plane's persistence substrate.

TPU-native analogue of Ray's GCS key-value service
(``src/ray/gcs/gcs_server/gcs_kv_manager.cc``; Serve persists controller
checkpoints through it via ``serve/_private/storage/kv_store.py``). The
reference offers two backends — Redis (persistent, enables GCS fault
tolerance) and in-memory (``src/ray/gcs/store_client/redis_store_client.h``,
``in_memory_store_client.h``); here the equivalents are a process-local dict
and an atomic-rename JSON file that survives controller restarts.

Own copy of ``ray_dynamic_batching_tpu/runtime/kv.py``. Trimmed:
:class:`NativeKVStore` raises (the native binding comes later).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional


class KVStore:
    """Thread-safe in-memory KV (ref in_memory_store_client)."""

    def __init__(self) -> None:
        self._data: Dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value
            self._persist()

    def delete(self, key: str) -> bool:
        with self._lock:
            existed = self._data.pop(key, None) is not None
            if existed:
                self._persist()
            return existed

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def _persist(self) -> None:  # overridden by FileKVStore
        pass


class NativeKVStore(KVStore):
    """Backend on the C++ KV (``native/src/rdb_native.cc``) in the
    reference. Not ported: the port's binding to the native library comes
    with ROADMAP queue 1 item 10, so constructing one raises."""

    def __init__(self) -> None:
        raise NotImplementedError(
            "NativeKVStore binds the native C++ library, which the port "
            "does not bind yet (ROADMAP queue 1 item 10); use KVStore or "
            "FileKVStore")


class FileKVStore(KVStore):
    """KV persisted to a JSON file via atomic rename (ref Redis-backed GCS
    storage enabling head-node fault tolerance)."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                self._data.update(json.load(f))

    def _persist(self) -> None:
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self._data, f)
        os.replace(tmp, self.path)
