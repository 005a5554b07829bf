"""ctypes bindings for the C++ runtime substrate (native/src/rdb_native.cc).

The native layer plays the roles the reference implements in C++
(SURVEY.md §2.2): shared-memory object store (plasma,
``src/ray/object_manager/plasma/store.cc``), shared-memory request queues
with batch pop (fixes the per-item actor RPC at
``293-project/src/scheduler.py:277``), KV store with versioned long-poll
watch (GCS KV + ``serve/_private/long_poll.py``), actor mailbox runtime
(``transport/actor_scheduling_queue.cc`` ordering semantics +
``gcs_actor_manager.cc:1361`` max_restarts), and a heartbeat health
registry (``gcs_health_check_manager.cc``).

The port's own binding of the repo's one C++ source, over the same C ABI
as ``ray_dynamic_batching_tpu/runtime/native.py`` (so a queue or store one
binding creates, the other opens). The library is built at first use with
``g++`` from ``native/src/rdb_native.cc`` with ``native/Makefile``'s
flags, keyed by a hash of the source and the flags, into
``build/torch_native/`` at the root of the checkout (git-ignored; never
``native/build/``, which the JAX package's binding rebuilds). No ``g++``,
or a failed build, raises with the compiler's output: nothing here runs
without the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional, Tuple

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _REPO_ROOT / "native" / "src" / "rdb_native.cc"
BUILD_DIR = _REPO_ROOT / "build" / "torch_native"
# native/Makefile's CXXFLAGS and LDFLAGS.
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread"]
LDFLAGS = ["-shared", "-pthread", "-lrt"]
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the native runtime library cannot be built from "
            f"{_SOURCE}")
    return cxx


def lib_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256()
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return BUILD_DIR / f"librdb_native-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Path:
    """Compile the native library if this source and these flags have no
    build yet (idempotent, cached; atomic rename, so a concurrent process
    never loads a partial file)."""
    with _BUILD_LOCK:
        out = lib_path()
        if out.exists() and not force:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_cxx(), *CXXFLAGS, str(_SOURCE), *LDFLAGS, "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {_SOURCE} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out


ACTOR_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_uint64,
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_uint32,
    ctypes.c_void_p,
)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
    lib = ctypes.CDLL(str(build_native()))
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    sigs = {
        "rdb_queue_create": ([c.c_char_p, c.c_uint32, c.c_uint32], c.c_void_p),
        "rdb_queue_open": ([c.c_char_p], c.c_void_p),
        "rdb_queue_push": ([c.c_void_p, u8p, c.c_uint32], c.c_int),
        "rdb_queue_pop_batch": (
            [c.c_void_p, u8p, c.c_uint32, c.POINTER(c.c_uint32), c.c_int],
            c.c_int,
        ),
        "rdb_queue_size": ([c.c_void_p], c.c_uint32),
        "rdb_queue_dropped": ([c.c_void_p], c.c_uint64),
        "rdb_queue_item_size": ([c.c_void_p], c.c_uint32),
        "rdb_queue_capacity": ([c.c_void_p], c.c_uint32),
        "rdb_queue_close": ([c.c_void_p, c.c_int], None),
        "rdb_store_create": ([c.c_char_p, c.c_uint64, c.c_uint32], c.c_void_p),
        "rdb_store_open": ([c.c_char_p], c.c_void_p),
        "rdb_store_put": ([c.c_void_p, c.c_uint64, u8p, c.c_uint64], c.c_int64),
        "rdb_store_get": ([c.c_void_p, c.c_uint64, u8p, c.c_uint64], c.c_int64),
        "rdb_store_delete": ([c.c_void_p, c.c_uint64], c.c_int),
        "rdb_store_contains": ([c.c_void_p, c.c_uint64], c.c_int),
        "rdb_store_used": ([c.c_void_p], c.c_uint64),
        "rdb_store_evictions": ([c.c_void_p], c.c_uint64),
        "rdb_store_close": ([c.c_void_p, c.c_int], None),
        "rdb_kv_create": ([], c.c_void_p),
        "rdb_kv_destroy": ([c.c_void_p], None),
        "rdb_kv_put": ([c.c_void_p, c.c_char_p, u8p, c.c_uint32], c.c_uint64),
        "rdb_kv_get": (
            [c.c_void_p, c.c_char_p, u8p, c.c_uint32, c.POINTER(c.c_uint64)],
            c.c_int64,
        ),
        "rdb_kv_del": ([c.c_void_p, c.c_char_p], c.c_int),
        "rdb_kv_watch": (
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_int],
            c.c_uint64,
        ),
        "rdb_kv_keys": ([c.c_void_p, c.c_char_p, u8p, c.c_uint32], c.c_int64),
        "rdb_actors_create": ([c.c_uint32], c.c_void_p),
        "rdb_actor_register": (
            [c.c_void_p, c.c_char_p, ACTOR_FN, c.c_void_p, c.c_uint32,
             c.c_uint32],
            c.c_uint64,
        ),
        "rdb_actor_post": ([c.c_void_p, c.c_uint64, u8p, c.c_uint32], c.c_int),
        "rdb_actors_drain": ([c.c_void_p, c.c_int], c.c_int),
        "rdb_actor_processed": ([c.c_void_p, c.c_uint64], c.c_uint64),
        "rdb_actor_failed": ([c.c_void_p, c.c_uint64], c.c_uint64),
        "rdb_actor_is_dead": ([c.c_void_p, c.c_uint64], c.c_int),
        "rdb_actors_destroy": ([c.c_void_p], None),
        "rdb_health_create": ([c.c_double], c.c_void_p),
        "rdb_health_destroy": ([c.c_void_p], None),
        "rdb_health_report": ([c.c_void_p, c.c_char_p], None),
        "rdb_health_remove": ([c.c_void_p, c.c_char_p], c.c_int),
        "rdb_health_dead": ([c.c_void_p, u8p, c.c_uint32], c.c_int64),
        "rdb_health_alive_count": ([c.c_void_p], c.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else \
        ctypes.cast(ctypes.c_char_p(b""), ctypes.POINTER(ctypes.c_uint8))


class NativeQueue:
    """Cross-process shared-memory MPMC queue with batch pop.

    One ``pop_batch`` call drains up to ``max_items`` — the single-RPC batch
    pop the reference's queue lacks (SURVEY.md §3.1)."""

    def __init__(self, name: str, capacity: int = 1024, item_size: int = 4096,
                 create: bool = True):
        lib = _lib()
        self._lib = lib
        self.name = name.encode() if isinstance(name, str) else name
        if create:
            self._q = lib.rdb_queue_create(self.name, capacity, item_size)
        else:
            self._q = lib.rdb_queue_open(self.name)
        if not self._q:
            raise OSError(f"cannot {'create' if create else 'open'} queue {name}")
        self.item_size = lib.rdb_queue_item_size(self._q)
        self._owner = create

    def push(self, data: bytes) -> bool:
        """False = dropped because full (reference drop policy)."""
        rc = self._lib.rdb_queue_push(self._q, _buf(data), len(data))
        if rc == -2:
            raise ValueError(
                f"item of {len(data)} bytes exceeds slot size {self.item_size}"
            )
        return rc == 0

    def pop_batch(self, max_items: int, timeout_ms: int = 0) -> List[bytes]:
        out = (ctypes.c_uint8 * (max_items * self.item_size))()
        lens = (ctypes.c_uint32 * max_items)()
        n = self._lib.rdb_queue_pop_batch(
            self._q,
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
            max_items,
            lens,
            timeout_ms,
        )
        # memoryview slicing: copy only the n returned items, not the
        # whole max_items*item_size buffer (this is the hot serving path)
        mv = memoryview(out)
        return [
            bytes(mv[i * self.item_size: i * self.item_size + lens[i]])
            for i in range(max(n, 0))
        ]

    def __len__(self) -> int:
        return self._lib.rdb_queue_size(self._q)

    @property
    def dropped(self) -> int:
        return self._lib.rdb_queue_dropped(self._q)

    def close(self, unlink: Optional[bool] = None) -> None:
        if self._q:
            self._lib.rdb_queue_close(
                self._q, int(self._owner if unlink is None else unlink)
            )
            self._q = None


class ObjectStore:
    """Shared-memory object store with LRU eviction (plasma role)."""

    def __init__(self, name: str, capacity_bytes: int = 64 << 20,
                 max_objects: int = 4096, create: bool = True):
        lib = _lib()
        self._lib = lib
        self.name = name.encode() if isinstance(name, str) else name
        if create:
            self._s = lib.rdb_store_create(self.name, capacity_bytes, max_objects)
        else:
            self._s = lib.rdb_store_open(self.name)
        if not self._s:
            raise OSError(f"cannot {'create' if create else 'open'} store {name}")
        self._owner = create

    def put(self, oid: int, data: bytes) -> bool:
        rc = self._lib.rdb_store_put(self._s, oid, _buf(data), len(data))
        if rc == -2:
            raise KeyError(f"object {oid} already exists (immutable store)")
        return rc >= 0

    def get(self, oid: int) -> Optional[bytes]:
        # probe-then-read retry loop: the object can be deleted/evicted (or
        # in the KV case, grown) by another process between the two calls,
        # so trust only a read whose reported length fits the buffer
        n = self._lib.rdb_store_get(
            self._s, oid,
            ctypes.cast((ctypes.c_uint8 * 0)(), ctypes.POINTER(ctypes.c_uint8)),
            0,
        )
        while True:
            if n < 0:
                return None
            out = (ctypes.c_uint8 * max(n, 1))()
            n2 = self._lib.rdb_store_get(
                self._s, oid, ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
                n,
            )
            if n2 < 0:
                return None
            if n2 <= n:
                return bytes(out)[:n2]
            n = n2  # grew concurrently; retry with the larger size

    def delete(self, oid: int) -> bool:
        return self._lib.rdb_store_delete(self._s, oid) == 0

    def __contains__(self, oid: int) -> bool:
        return bool(self._lib.rdb_store_contains(self._s, oid))

    @property
    def used_bytes(self) -> int:
        return self._lib.rdb_store_used(self._s)

    @property
    def evictions(self) -> int:
        return self._lib.rdb_store_evictions(self._s)

    def close(self, unlink: Optional[bool] = None) -> None:
        if self._s:
            self._lib.rdb_store_close(
                self._s, int(self._owner if unlink is None else unlink)
            )
            self._s = None


class KVStore:
    """In-process KV with versioned long-poll watch (GCS KV role)."""

    def __init__(self):
        self._lib = _lib()
        self._kv = self._lib.rdb_kv_create()

    def put(self, key: str, value: bytes) -> int:
        return self._lib.rdb_kv_put(
            self._kv, key.encode(), _buf(value), len(value)
        )

    def get(self, key: str) -> Optional[Tuple[bytes, int]]:
        version = ctypes.c_uint64()
        n = self._lib.rdb_kv_get(
            self._kv, key.encode(),
            ctypes.cast((ctypes.c_uint8 * 0)(), ctypes.POINTER(ctypes.c_uint8)),
            0, ctypes.byref(version),
        )
        while True:
            if n < 0:
                return None
            out = (ctypes.c_uint8 * max(n, 1))()
            n2 = self._lib.rdb_kv_get(
                self._kv, key.encode(),
                ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), n,
                ctypes.byref(version),
            )
            if n2 < 0:
                return None
            if n2 <= n:
                return bytes(out)[:n2], version.value
            n = n2  # value grew between probe and read; retry

    def delete(self, key: str) -> bool:
        return self._lib.rdb_kv_del(self._kv, key.encode()) == 0

    def watch(self, key: str, have_version: int = 0,
              timeout_ms: int = 1000) -> int:
        """Block until the key's version exceeds have_version; 0 = timeout
        (the long-poll listen_for_change contract)."""
        return self._lib.rdb_kv_watch(
            self._kv, key.encode(), have_version, timeout_ms
        )

    def keys(self, prefix: str = "") -> List[str]:
        cap = 1 << 16
        while True:
            out = (ctypes.c_uint8 * cap)()
            n = self._lib.rdb_kv_keys(
                self._kv, prefix.encode(),
                ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), cap
            )
            if n == 0:
                return []
            if n <= cap:
                return bytes(out)[:n].decode().split("\n")
            cap = n + 1024  # listing outgrew the buffer; re-call larger

    def close(self) -> None:
        if self._kv:
            self._lib.rdb_kv_destroy(self._kv)
            self._kv = None


class ActorPool:
    """Actor runtime: named actors with FIFO mailboxes executed serially
    per actor, in parallel across actors, with max_restarts fault policy."""

    def __init__(self, n_threads: int = 4):
        self._lib = _lib()
        self._rt = self._lib.rdb_actors_create(n_threads)
        self._callbacks = {}  # keep CFUNCTYPE objects alive

    def register(self, name: str, handler: Callable[[bytes], None],
                 mailbox_cap: int = 1024, max_restarts: int = 3) -> int:
        def trampoline(actor_id, msg_ptr, msg_len, _ctx):
            try:
                data = bytes(
                    ctypes.cast(
                        msg_ptr, ctypes.POINTER(ctypes.c_uint8 * msg_len)
                    ).contents
                ) if msg_len else b""
                handler(data)
                return 0
            except Exception:
                return 1  # counted as a failure -> restart accounting

        cb = ACTOR_FN(trampoline)
        actor_id = self._lib.rdb_actor_register(
            self._rt, name.encode(), cb, None, mailbox_cap, max_restarts
        )
        self._callbacks[actor_id] = cb
        return actor_id

    def post(self, actor_id: int, msg: bytes) -> bool:
        rc = self._lib.rdb_actor_post(self._rt, actor_id, _buf(msg), len(msg))
        if rc == -2:
            raise KeyError(f"actor {actor_id} missing or dead")
        return rc == 0

    def drain(self, timeout_ms: int = 10_000) -> bool:
        return self._lib.rdb_actors_drain(self._rt, timeout_ms) == 0

    def processed(self, actor_id: int) -> int:
        return self._lib.rdb_actor_processed(self._rt, actor_id)

    def failed(self, actor_id: int) -> int:
        return self._lib.rdb_actor_failed(self._rt, actor_id)

    def is_dead(self, actor_id: int) -> bool:
        return bool(self._lib.rdb_actor_is_dead(self._rt, actor_id))

    def close(self) -> None:
        if self._rt:
            self._lib.rdb_actors_destroy(self._rt)
            self._rt = None
            self._callbacks.clear()


class HealthTable:
    """Heartbeat registry with staleness detection (GCS health-check role)."""

    def __init__(self, timeout_s: float = 5.0):
        self._lib = _lib()
        self._h = self._lib.rdb_health_create(timeout_s)

    def report(self, node: str) -> None:
        self._lib.rdb_health_report(self._h, node.encode())

    def remove(self, node: str) -> bool:
        return self._lib.rdb_health_remove(self._h, node.encode()) == 0

    def dead_nodes(self) -> List[str]:
        cap = 1 << 14
        while True:
            out = (ctypes.c_uint8 * cap)()
            n = self._lib.rdb_health_dead(
                self._h, ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), cap
            )
            if n == 0:
                return []
            if n <= cap:
                return bytes(out)[:n].decode().split("\n")
            cap = n + 1024

    @property
    def alive_count(self) -> int:
        return self._lib.rdb_health_alive_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.rdb_health_destroy(self._h)
            self._h = None
