"""Socket ingress — line-delimited JSON over TCP into the scheduler queues.

Re-creates the reference's standalone zmq frontend
(``293-project/src/milind-code/scheduler.py:20-100``: PULL socket bound to
``tcp://*:5555`` at ``:33``, JSON requests ``{timestamp, model_name,
request_id, SLO, image_path}`` decoded and pushed to per-model Ray queues,
with per-second arrival-rate accounting ``:51-58``).

TPU-native differences: plain TCP with newline-delimited JSON (no zmq
dependency — we own both ends), the payload carries the model input inline
(tokens/features) instead of an image path, and — unlike the reference's
fire-and-forget pull — the server can stream each request's result back on
the same connection (``"reply": false`` restores the reference behavior).

Own copy of ``ray_dynamic_batching_tpu/engine/ingress.py`` with its import
paths rewritten, whole.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Any, Callable, Optional

from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.utils.chaos import chaos
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("ingress")

DEFAULT_SLO_MS = 1000.0


class _IngressHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        server: SocketIngress = self.server  # type: ignore[assignment]
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                model = msg["model_name"]
                request = Request(
                    model=model,
                    payload=msg.get("payload"),
                    slo_ms=float(msg.get("SLO", DEFAULT_SLO_MS)),
                    request_id=str(msg.get("request_id", "")),
                )
            except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
                self._reply({"error": f"bad request: {e}"})
                continue
            if chaos().should_fail("ingress.handle"):
                # chaos: ingress drops the request on the floor (lost
                # frontend RPC); client sees an error reply, not a hang
                self._reply(
                    {"request_id": request.request_id,
                     "error": "chaos injected at ingress.handle"}
                )
                continue
            accepted = server.submit(request)
            if not msg.get("reply", True):
                continue  # fire-and-forget (the reference's mode)
            if not accepted:
                self._reply(
                    {"request_id": request.request_id, "error": "rejected"}
                )
                continue
            try:
                result = request.future.result(timeout=server.reply_timeout_s)
                self._reply(
                    {"request_id": request.request_id,
                     "result": _jsonable(result)}
                )
            except Exception as e:  # noqa: BLE001 — deliver errors to the client
                self._reply(
                    {"request_id": request.request_id, "error": str(e)}
                )

    def _reply(self, obj: Any) -> None:
        try:
            self.wfile.write(json.dumps(obj).encode() + b"\n")
        except (BrokenPipeError, ConnectionResetError):
            pass


def _jsonable(result: Any) -> Any:
    # One JSON-safety convention for both ingresses (dicts, np scalars and
    # arrays, dataclass-ish results all covered).
    from ray_dynamic_batching_tpu_torch.serve.proxy import _to_jsonable

    return _to_jsonable(result)


class SocketIngress(socketserver.ThreadingTCPServer):
    """TCP ingress feeding a submit callback (``LiveScheduler.submit_request``
    or a router assign) — the RequestHandle role (ref :74-100)."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(
        self,
        submit: Callable[[Request], bool],
        host: str = "127.0.0.1",
        port: int = 5555,
        reply_timeout_s: float = 60.0,
    ) -> None:
        super().__init__((host, port), _IngressHandler)
        self.submit = submit
        self.reply_timeout_s = reply_timeout_s
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "SocketIngress":
        self._thread = threading.Thread(
            target=self.serve_forever, name="socket-ingress", daemon=True
        )
        self._thread.start()
        logger.info("socket ingress on %s:%d", *self.server_address)
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class IngressClient:
    """Line-JSON client (the request-simulator side, ref
    request_simulator.py:33-42)."""

    def __init__(self, host: str, port: int, timeout_s: float = 60.0) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self._file = self.sock.makefile("rwb")

    def send(
        self,
        model_name: str,
        payload: Any,
        slo_ms: float = DEFAULT_SLO_MS,
        request_id: str = "",
        reply: bool = True,
    ) -> Optional[dict]:
        msg = {
            "model_name": model_name,
            "payload": payload,
            "SLO": slo_ms,
            "request_id": request_id,
            "reply": reply,
        }
        self._file.write(json.dumps(msg).encode() + b"\n")
        self._file.flush()
        if not reply:
            return None
        line = self._file.readline()
        if not line:
            raise ConnectionError("ingress closed connection")
        return json.loads(line)

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            self.sock.close()
