"""Cluster KV store — the control plane's persistence substrate.

TPU-native analogue of Ray's GCS key-value service
(``src/ray/gcs/gcs_server/gcs_kv_manager.cc``; Serve persists controller
checkpoints through it via ``serve/_private/storage/kv_store.py``). The
reference offers two backends — Redis (persistent, enables GCS fault
tolerance) and in-memory (``src/ray/gcs/store_client/redis_store_client.h``,
``in_memory_store_client.h``); here the equivalents are a process-local dict
and an atomic-rename JSON file that survives controller restarts.

Own copy of ``ray_dynamic_batching_tpu/runtime/kv.py`` with its import
paths rewritten, whole; :class:`NativeKVStore` runs on the port's binding
of the native library (``runtime/native.py``).
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
    """Backend on the C++ KV (native/src/rdb_native.cc): same string API
    plus versioned long-poll ``watch`` — the GCS-KV + long-poll pairing the
    reference splits across ``gcs_kv_manager.cc`` and
    ``serve/_private/long_poll.py``."""

    def __init__(self) -> None:
        from ray_dynamic_batching_tpu_torch.runtime import native

        self._kv = native.KVStore()

    def get(self, key: str) -> Optional[str]:
        hit = self._kv.get(key)
        return None if hit is None else hit[0].decode()

    def get_versioned(self, key: str):
        hit = self._kv.get(key)
        return None if hit is None else (hit[0].decode(), hit[1])

    def put(self, key: str, value: str) -> None:
        self._kv.put(key, value.encode())

    def delete(self, key: str) -> bool:
        return self._kv.delete(key)

    def keys(self, prefix: str = "") -> List[str]:
        return sorted(self._kv.keys(prefix))

    def watch(self, key: str, have_version: int = 0,
              timeout_ms: int = 1000) -> int:
        """Block until the key's version advances; 0 on timeout."""
        return self._kv.watch(key, have_version, timeout_ms)

    def close(self) -> None:
        self._kv.close()


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
