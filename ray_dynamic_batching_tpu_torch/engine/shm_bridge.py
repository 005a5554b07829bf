"""Cross-process serving bridge over the C++ shm substrate.

The reference splits its data plane between gRPC (control/small data) and
plasma shared memory (large payloads) — SURVEY.md §2.2/§2.4. This module is
that pairing for the serving path, on the native substrate (`native/`):

- control plane: request *metadata* rides a :class:`NativeQueue` (shm MPMC
  ring) and is drained by the engine in ONE batch-pop per cycle — the
  single-RPC batch pop the reference's queue lacks (scheduler.py:277);
- data plane: request payloads and results ride the :class:`ObjectStore`
  (shm arena, plasma role), referenced by object id from the metadata.

Frontend processes (:class:`ShmFrontend`) submit and await results without
touching the card or the engine process; the engine side
(:class:`ShmBridge`) adapts popped requests into ordinary
:class:`engine.request.Request` objects whose completion writes the result
back into the store.

Own copy of ``ray_dynamic_batching_tpu/engine/shm_bridge.py`` with its
import paths rewritten, over the port's own binding of the native library
(``runtime/native.py``). One change: a result that is not an array is
made JSON-safe with the proxy's ``_to_jsonable`` before it is encoded, as
the socket ingress does, so an LLM's ``DecodeResult`` reaches the
frontend as its fields (``tokens``, ``finish_reason``, ...); the reference
writes the ``repr`` of anything ``json`` refuses.
"""

from __future__ import annotations

import io
import json
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_dynamic_batching_tpu_torch.engine.request import Request, now_ms
from ray_dynamic_batching_tpu_torch.runtime.native import NativeQueue, ObjectStore
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("shm_bridge")

_RESULT_BIT = 1 << 63  # result object id = payload oid | result bit
_OID_MASK = _RESULT_BIT - 1


def _encode_value(value: Any) -> bytes:
    """np arrays as npy bytes (zero-ambiguity dtypes/shapes); everything
    else as json."""
    if isinstance(value, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, value, allow_pickle=False)
        return b"NPY0" + buf.getvalue()
    return b"JSON" + json.dumps(value).encode()


def _decode_value(data: bytes) -> Any:
    tag, body = data[:4], data[4:]
    if tag == b"NPY0":
        return np.load(io.BytesIO(body), allow_pickle=False)
    if tag == b"JSON":
        return json.loads(body)
    raise ValueError(f"unknown payload tag {tag!r}")


class ShmFrontend:
    """Client-side handle in the frontend process: submit + await results."""

    def __init__(self, name: str, create: bool = False,
                 queue_capacity: int = 4096, store_bytes: int = 256 << 20):
        self.queue = NativeQueue(
            f"{name}.q", capacity=queue_capacity, item_size=4096, create=create
        )
        self.store = ObjectStore(
            f"{name}.store", capacity_bytes=store_bytes, create=create
        )

    def submit(self, model: str, payload: Any, slo_ms: float,
               request_id: Optional[str] = None) -> int:
        """Enqueue one request; returns the oid to poll for the result.
        Raises RuntimeError when the queue drops (backpressure is visible,
        never silent)."""
        request_id = request_id or uuid.uuid4().hex
        oid = uuid.uuid4().int & _OID_MASK
        if not self.store.put(oid, _encode_value(payload)):
            raise RuntimeError("shm store full: payload rejected")
        meta = json.dumps({
            "model": model,
            "slo_ms": slo_ms,
            "request_id": request_id,
            "oid": oid,
            # monotonic: shm is same-host, so CLOCK_MONOTONIC is shared
            # across processes and comparable with the engine's now_ms()
            "ts_ms": now_ms(),
        }).encode()
        try:
            pushed = self.queue.push(meta)
        except ValueError:
            self.store.delete(oid)  # oversized meta: reclaim the payload
            raise
        if not pushed:
            self.store.delete(oid)
            raise RuntimeError("shm queue full: request dropped")
        return oid

    def try_result(self, oid: int, delete: bool = True):
        """Non-blocking result probe: (False, None) when not ready yet,
        (True, value) when done; raises the engine-reported error. Lets a
        single poller thread multiplex many outstanding oids instead of one
        blocked ``get_result`` thread per request."""
        result_oid = oid | _RESULT_BIT
        data = self.store.get(result_oid)
        if data is None:
            return False, None
        if delete:
            self.store.delete(result_oid)
            self.store.delete(oid)
        value = _decode_value(data)
        if isinstance(value, dict) and "__error__" in value:
            raise RuntimeError(value["__error__"])
        return True, value

    def get_result(self, oid: int, timeout_s: float = 30.0,
                   poll_s: float = 0.002, delete: bool = True) -> Any:
        """Poll the store for the result object; raises on timeout or if
        the engine reported an error for this request."""
        result_oid = oid | _RESULT_BIT
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            data = self.store.get(result_oid)
            if data is not None:
                if delete:
                    self.store.delete(result_oid)
                    self.store.delete(oid)
                value = _decode_value(data)
                if isinstance(value, dict) and "__error__" in value:
                    raise RuntimeError(value["__error__"])
                return value
            time.sleep(poll_s)  # rdb-lint: disable=event-loop-blocking (cross-process shm result poll on the frontend caller's thread)
        raise TimeoutError(f"no result for oid {oid} within {timeout_s}s")

    def close(self, unlink: Optional[bool] = None) -> None:
        self.queue.close(unlink)
        self.store.close(unlink)


class ShmBridge:
    """Engine-side pump: batch-pops shm requests, rehydrates payloads from
    the store, and submits Requests whose completion writes results back."""

    def __init__(self, name: str, submit: Callable[[Request], bool],
                 batch_size: int = 64, create: bool = True,
                 queue_capacity: int = 4096, store_bytes: int = 256 << 20):
        self.frontend_name = name
        self.queue = NativeQueue(
            f"{name}.q", capacity=queue_capacity, item_size=4096, create=create
        )
        self.store = ObjectStore(
            f"{name}.store", capacity_bytes=store_bytes, create=create
        )
        self.submit = submit
        self.batch_size = batch_size
        self._run = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pumped = 0
        self.errors = 0
        self.result_drops = 0

    # --- result write-back -------------------------------------------------
    def _complete(self, oid: int, value: Any) -> None:
        try:
            ok = self.store.put(oid | _RESULT_BIT, _encode_value(value))
        except KeyError:
            return  # duplicate completion; first write wins (immutable store)
        if not ok:
            # result didn't fit the arena: the frontend will time out, so
            # make the reason findable (backpressure visible, never silent)
            self.result_drops += 1
            logger.error(
                "result for oid %d dropped: shm store full (%d bytes used)",
                oid, self.store.used_bytes,
            )

    def _make_request(self, meta: Dict[str, Any]) -> Optional[Request]:
        oid = meta["oid"]
        data = self.store.get(oid)
        if data is None:
            logger.warning("payload oid %d missing (evicted?)", oid)
            self._complete(oid, {"__error__": "payload missing from store"})
            return None
        try:
            payload = _decode_value(data)
        except Exception as e:  # noqa: BLE001 — report to the waiting frontend
            logger.warning("payload oid %d undecodable: %s", oid, e)
            self._complete(oid, {"__error__": f"payload decode failed: {e}"})
            return None
        req = Request(
            model=meta["model"],
            payload=payload,
            slo_ms=float(meta["slo_ms"]),
            request_id=meta["request_id"],
            # preserve the frontend's submit time so queue-wait inside the
            # shm ring counts against the SLO (staleness + accounting)
            arrival_ms=float(meta.get("ts_ms") or now_ms()),
        )

        def _on_done(fut) -> None:
            err = fut.exception()
            if err is not None:
                self._complete(oid, {"__error__": str(err)})
            else:
                result = fut.result()
                if not isinstance(result, np.ndarray):
                    # One JSON-safety convention for every door (the
                    # ingress and the proxies use it): a DecodeResult
                    # crosses as its fields, not as its repr.
                    from ray_dynamic_batching_tpu_torch.serve.proxy import (
                        _to_jsonable,
                    )

                    result = _to_jsonable(result)
                    try:
                        json.dumps(result)
                    except TypeError:
                        result = {"repr": repr(result)}
                self._complete(oid, result)

        req.future.add_done_callback(_on_done)
        return req

    def pump_once(self, timeout_ms: int = 100) -> int:
        """One batch-pop + submit sweep; returns requests pumped."""
        items = self.queue.pop_batch(self.batch_size, timeout_ms=timeout_ms)
        n = 0
        for raw in items:
            try:
                meta = json.loads(raw)
                req = self._make_request(meta)
            except Exception as e:  # noqa: BLE001 — poison pill must not kill the pump
                logger.warning("bad shm request: %s", e)
                self.errors += 1
                continue
            if req is None:
                self.errors += 1
                continue
            if not self.submit(req):
                req.reject(RuntimeError("engine rejected request"))
                self.errors += 1
                continue  # rejected != pumped: throughput stays honest
            n += 1
        self.pumped += n
        return n

    def _loop(self) -> None:
        while self._run.is_set():
            self.pump_once()

    def start(self) -> "ShmBridge":
        self._run.set()
        self._thread = threading.Thread(
            target=self._loop, name="shm-bridge", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, unlink: bool = True) -> None:
        self._run.clear()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # a wedged submit callable still owns the handles: closing
                # them under the live loop would hand C a freed mapping
                # (segfault); leak instead and say so
                logger.error(
                    "shm bridge pump thread did not exit; leaking shm "
                    "handles %s to avoid use-after-free", self.frontend_name,
                )
                return
            self._thread = None
        self.queue.close(unlink)
        self.store.close(unlink)
