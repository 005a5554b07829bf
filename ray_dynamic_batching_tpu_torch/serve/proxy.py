"""HTTP ingress proxy — the framework's front door.

Own copy of ``ray_dynamic_batching_tpu/serve/proxy.py`` with its import
paths rewritten, whole; ``/-/status`` answers ``status_fn`` (the
controller's snapshot once it is ported) and ``admission`` takes the
admission controller when it is.

Re-creates Ray Serve's per-node proxy
(``python/ray/serve/_private/proxy.py:136`` ``GenericProxy``, ``:779``
``HTTPProxy``, actor wrapper ``:1153``) and its prefix router
(``_private/proxy_router.py``): requests are matched by route prefix to a
deployment handle, awaited, and returned as JSON. Implemented on asyncio
streams with a minimal HTTP/1.1 parser — the framework owns both sides of
the socket, so a full ASGI stack buys nothing on the hot path.

Routes:
- ``POST /api/{deployment}``  body = JSON payload → handle result; a payload
  with ``"stream": true`` gets a chunked NDJSON response — one line per
  chunk as the replica produces it, then a final ``{"result": ...}`` line
  (ref streaming proxy path ``_private/proxy.py:959``)
- ``GET  /-/healthz``         liveness (ref proxy health checks)
- ``GET  /-/status``          controller status snapshot
- ``GET  /metrics``           Prometheus text exposition
  (ref ``_private/metrics_agent.py:483,595`` Prometheus surfacing)
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ray_dynamic_batching_tpu_torch.engine.request import (
    BadRequest,
    DEFAULT_TENANT,
    normalize_qos,
)
from ray_dynamic_batching_tpu_torch.serve.failover import (
    RejectDisposition,
    reject_disposition,
    retry_after_header,
)
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.tracing import parse_traceparent, tracer

logger = get_logger("proxy")

PROXY_REQUESTS = m.Counter(
    "rdb_proxy_requests_total", "HTTP requests",
    tag_keys=("route", "code", "shard"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)
PROXY_LATENCY_MS = m.Histogram(
    "rdb_proxy_request_latency_ms", "End-to-end HTTP request latency",
    tag_keys=("route", "shard"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)

MAX_BODY_BYTES = 64 * 1024 * 1024


def _to_jsonable(obj: Any) -> Any:
    """Results may be np arrays / DecodeResults; make them JSON-safe."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in vars(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


class ProxyRouter:
    """Longest-prefix route table (ref _private/proxy_router.py)."""

    def __init__(self) -> None:
        self._handles: Dict[str, DeploymentHandle] = {}
        self._sorted: Tuple[str, ...] = ()  # longest-first; rebuilt on mutation
        self._lock = threading.Lock()

    def set_route(self, route: str, handle: DeploymentHandle) -> None:
        with self._lock:
            self._handles[route.rstrip("/")] = handle
            self._sorted = tuple(sorted(self._handles, key=len, reverse=True))

    def remove_route(self, route: str) -> None:
        with self._lock:
            self._handles.pop(route.rstrip("/"), None)
            self._sorted = tuple(sorted(self._handles, key=len, reverse=True))

    def match(self, path: str) -> Optional[Tuple[str, DeploymentHandle]]:
        with self._lock:
            for route in self._sorted:
                if path == route or path.startswith(route + "/"):
                    return route, self._handles[route]
        return None


class HTTPProxy:
    """Asyncio HTTP server bridging sockets to deployment handles."""

    def __init__(
        self,
        router: ProxyRouter,
        host: str = "127.0.0.1",
        port: int = 8265,
        status_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        request_timeout_s: float = 60.0,
        admission: Optional[Any] = None,
        shard_id: str = "0",
    ) -> None:
        self.router = router
        self.host = host
        self.port = port
        # Front-door shard identity (serve/frontdoor.py): tags every
        # proxy metric family so per-shard load skew is observable; "0"
        # is the unsharded default.
        self.shard_id = str(shard_id)
        self.status_fn = status_fn
        self.request_timeout_s = request_timeout_s
        # Optional serve.admission.AdmissionController: consulted BEFORE
        # any routing or queueing (the whole point of admission control —
        # a reject costs one HTTP round trip, not a queue slot). Wired by
        # serve.api when the module controller publishes a route.
        self.admission = admission
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._route_pool: Optional[ThreadPoolExecutor] = None

    async def _offload_routing(self, fn: Callable, *args: Any) -> Any:
        """Run a synchronous routing call off the event loop.

        handle.remote/remote_stream run assign_request's pow-2 + backoff
        loop, which sleeps up to the assign timeout when every replica is
        saturated — on the loop thread that would stall every live
        connection. The proxy's OWN pool (not the loop's default
        executor) absorbs those sleeps: parking up-to-1s backoffs on the
        shared default pool would head-of-line-block unrelated work
        (other deployments' routing, library callbacks) behind one
        saturated deployment. contextvars copy keeps the routing span
        inside this request's trace."""
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(
            self._route_pool, lambda: ctx.run(fn, *args)
        )

    # --- HTTP plumbing ----------------------------------------------------
    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Optional[Tuple[str, str, Dict[str, str], Optional[bytes]]]:
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _version = line.decode("latin1").strip().split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if b":" in h:
                k, v = h.decode("latin1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > MAX_BODY_BYTES:
            # body=None marks an oversized request: the caller answers 413
            # and closes the connection (the unread bytes would desync any
            # further pipelined parsing on this stream).
            return method, target, headers, None
        body = await reader.readexactly(length) if length else b""
        return method, target, headers, body

    @staticmethod
    def _response(code: int, payload: Any, reason: str = "",
                  headers: Optional[Dict[str, str]] = None) -> bytes:
        body = json.dumps(_to_jsonable(payload)).encode()
        status = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests",
                  500: "Internal Server Error", 503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(code, reason or "Error")
        extra = "".join(
            f"{k}: {v}\r\n" for k, v in (headers or {}).items()
        )
        head = (
            f"HTTP/1.1 {code} {status}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extra}"
            f"Connection: keep-alive\r\n\r\n"
        )
        return head.encode() + body

    @staticmethod
    def _text_response(code: int, text: str, ctype: str) -> bytes:
        body = text.encode()
        head = (
            f"HTTP/1.1 {code} OK\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: keep-alive\r\n\r\n"
        )
        return head.encode() + body

    # --- streaming (ref HTTPProxy.send_request_to_replica, proxy.py:959) --
    async def _stream_response(
        self,
        writer: asyncio.StreamWriter,
        handle: DeploymentHandle,
        payload: Any,
    ) -> str:
        """Chunked NDJSON: one line per streamed chunk, then a final
        ``{"result": ...}`` (or ``{"error": ...}``) line. Returns the HTTP
        code for metrics.

        Delivery is push-based: the TokenStream's producer thread hands
        chunks to this event loop via ``call_soon_threadsafe`` — no blocked
        reader thread per connection, so concurrent streams scale with the
        event loop, not with an executor pool.
        """
        stream, future = await self._offload_routing(
            handle.remote_stream, payload
        )
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Connection: keep-alive\r\n\r\n"
        )
        loop = asyncio.get_running_loop()
        aq: asyncio.Queue = asyncio.Queue()
        _CLOSE = object()

        def _push(item: Any) -> None:
            try:
                loop.call_soon_threadsafe(aq.put_nowait, item)
            except RuntimeError:
                pass  # loop shut down mid-stream; connection is dying anyway

        stream.subscribe(
            lambda chunk: _push(("chunk", chunk)),
            lambda err: _push((_CLOSE, err)),
        )

        async def _write_line(obj: Any) -> None:
            data = (json.dumps(_to_jsonable(obj)) + "\n").encode()
            writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            await writer.drain()

        code = "200"
        try:
            while True:
                kind, val = await asyncio.wait_for(
                    aq.get(), timeout=self.request_timeout_s
                )
                if kind is _CLOSE:
                    break
                await _write_line({"chunk": val})
            result = await asyncio.wait_for(
                asyncio.wrap_future(future), timeout=self.request_timeout_s
            )
            await _write_line({"result": result})
        except asyncio.TimeoutError:
            # The chunked header is already out — the error must arrive as a
            # body line + clean terminator, never a truncated socket.
            code = "504"
            await _write_line({"error": "stream timed out"})
        except Exception as e:  # noqa: BLE001 — surface on the trailer line
            # Same shared table as the unary path (the 200 header is
            # already out, so `code` is the metrics classification):
            # capacity sheds read as 429, system failures as 503 — never
            # server errors.
            code = str(reject_disposition(e).http_status)
            await _write_line({"error": str(e)})
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return code

    # --- request handling (ref GenericProxy.proxy_request, proxy.py:446) --
    async def _handle_one(
        self, method: str, path: str, body: bytes,
        writer: Optional[asyncio.StreamWriter] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[Optional[bytes], str]:
        if method == "GET" and path == "/-/healthz":
            return self._response(200, {"status": "ok"}), "healthz"
        if method == "GET" and path == "/-/status":
            status = self.status_fn() if self.status_fn else {}
            return self._response(200, status), "status"
        if method == "GET" and path == "/metrics":
            # Content negotiation: exemplars are OpenMetrics-only syntax —
            # a classic Prometheus scraper gets the clean 0.0.4 text, a
            # client Accept-ing application/openmetrics-text gets
            # exemplars + `# EOF`.
            accept = (headers or {}).get("accept", "")
            if "application/openmetrics-text" in accept:
                return (
                    self._text_response(
                        200, m.default_registry().openmetrics_text(),
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8",
                    ),
                    "metrics",
                )
            return (
                self._text_response(
                    200, m.default_registry().prometheus_text(),
                    "text/plain; version=0.0.4",
                ),
                "metrics",
            )
        matched = self.router.match(path)
        if matched is None:
            # Fixed sentinel tag: tagging with the raw path would let any
            # client mint unbounded metric label cardinality.
            return self._response(404, {"error": f"no route for {path}"}), "unmatched"
        route, handle = matched
        if method != "POST":
            return self._response(400, {"error": "use POST"}), route
        try:
            payload = json.loads(body) if body else None
        except json.JSONDecodeError as e:
            return self._response(400, {"error": f"bad JSON: {e}"}), route

        # --- QoS identity + admission (BEFORE any routing/queueing) ------
        # Headers win over payload fields (a gateway stamping classes must
        # override whatever the client self-declared); unknown classes are
        # the client's fault (400), never a silent default. Undeclared
        # identity grades at the HANDLE's per-deployment default — the
        # admitter and the queue must see the same class.
        hdrs = headers or {}
        body_dict = payload if isinstance(payload, dict) else {}
        tenant = (hdrs.get("x-rdb-tenant") or body_dict.get("tenant")
                  or DEFAULT_TENANT)
        declared_qos = hdrs.get("x-rdb-qos") or body_dict.get("qos_class")
        try:
            qos = (normalize_qos(declared_qos) if declared_qos
                   else getattr(handle, "default_qos_class", None)
                   or normalize_qos(None))
        except BadRequest as e:
            return self._response(400, {"error": str(e)}), route
        identity_kwargs: Dict[str, Any] = {}
        if isinstance(payload, dict):
            # The handle builds the Request from the payload: HEADER-
            # declared identity must ride it so spans/queues/audit see
            # the same class the admitter graded. Only explicitly-sent
            # values are written — injecting defaults would mutate every
            # user payload visibly (an echo deployment would reflect
            # keys the client never sent).
            if hdrs.get("x-rdb-tenant"):
                payload["tenant"] = tenant
            if hdrs.get("x-rdb-qos"):
                payload["qos_class"] = qos
        elif isinstance(handle, DeploymentHandle) and (
            hdrs.get("x-rdb-tenant") or hdrs.get("x-rdb-qos")
        ):
            # Non-dict payload: identity can't ride the payload, so pass
            # it as kwargs (only to the native handle, whose signature
            # takes them — adapter handles get dict payloads anyway).
            identity_kwargs = {"tenant": tenant, "qos_class": qos}
        if self.admission is not None:
            # Its own ledger hop (admission.check): bucket math is
            # microseconds, but a contended admission lock or governor
            # flap shows up here — and an invisible hop can never be
            # named guilty by the budget gate.
            with tracer().span("admission.check", lane="http",
                               tenant=tenant, qos_class=qos):
                ok, retry_after_s = self.admission.admit(
                    getattr(handle, "deployment", route), tenant, qos
                )
            if not ok:
                # Same header grammar as every other capacity reject
                # (failover.retry_after_header), just pre-dispatch.
                ra = retry_after_header(RejectDisposition(
                    "capacity", 429, "RESOURCE_EXHAUSTED",
                    retry_after_s=retry_after_s,
                ))
                return self._response(
                    429,
                    {"error": f"admission rate exceeded (tenant "
                              f"{tenant!r}, class {qos!r})"},
                    headers={"Retry-After": ra},
                ), route

        if (
            writer is not None
            and isinstance(payload, dict)
            and payload.get("stream")
            # Adapter handles without a streaming surface fall through to
            # the unary path, whose validation can answer 400 — a missing
            # attribute here would drop the connection with no response.
            and hasattr(handle, "remote_stream")
        ):
            code = await self._stream_response(writer, handle, payload)
            # None marks "already written"; tag carries the code for metrics.
            return None, f"{route}|{code}"

        future = await self._offload_routing(
            functools.partial(handle.remote, payload, **identity_kwargs)
        )
        try:
            result = await asyncio.wait_for(
                asyncio.wrap_future(future), timeout=self.request_timeout_s
            )
        except asyncio.TimeoutError:
            return self._response(504, {"error": "request timed out"}), route
        except Exception as e:  # noqa: BLE001 — replica-side errors surface as 500
            # One shared table (serve/failover.reject_disposition) decides
            # how a failure surfaces: capacity sheds are 429 + a COMPUTED
            # Retry-After (bucket refill / queue drain estimate), retryable
            # system failures and exhausted failover budgets are 503 +
            # Retry-After, user payloads 400, genuine bugs 500. The gRPC
            # front door maps the same table so the two can never disagree.
            disp = reject_disposition(e)
            if disp.kind == "internal" and "no replica" in str(e):
                # Untyped routing-layer saturation message: transient, not
                # a bug — keep the historical 503 classification.
                return self._response(
                    503, {"error": str(e)}, headers={"Retry-After": "1"}
                ), route
            ra = retry_after_header(disp)
            return self._response(
                disp.http_status, {"error": str(e)},
                headers={"Retry-After": ra} if ra is not None else None,
            ), route
        return self._response(200, {"result": result}), route

    async def _serve_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, path, headers, body = req
                if body is None:  # oversized: answer and drop the connection
                    resp = self._response(413, {"error": "body too large"},
                                          reason="Payload Too Large")
                    PROXY_REQUESTS.inc(tags={"route": "oversized",
                                             "code": "413",
                                             "shard": self.shard_id})
                    writer.write(resp)
                    await writer.drain()
                    break
                # The ingest span covers the whole hop (parse -> route ->
                # await replica result). An inbound W3C ``traceparent``
                # header joins the caller's trace; absent one, this span
                # starts the trace every downstream hop inherits.
                t_req = m.now_ms()
                with tracer().attach_context(
                    parse_traceparent(headers.get("traceparent")),
                    "proxy.request",
                    lane="http", method=method, path=path,
                ) as psp:
                    resp, route = await self._handle_one(
                        method, path, body, writer, headers
                    )
                if resp is None:  # streamed: already written, tag holds code
                    route, _, code = route.rpartition("|")
                else:
                    code = resp.split(b" ", 2)[1].decode()
                if psp is not None:
                    psp.attributes.update(route=route, code=code)
                PROXY_REQUESTS.inc(tags={"route": route, "code": code,
                                         "shard": self.shard_id})
                PROXY_LATENCY_MS.observe(
                    m.now_ms() - t_req,
                    tags={"route": route, "shard": self.shard_id},
                    trace_id=psp.trace_id if psp is not None else None,
                )
                if resp is None:
                    continue
                writer.write(resp)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:  # noqa: BLE001
            logger.exception("connection handler failed")
        finally:
            writer.close()

    # --- lifecycle --------------------------------------------------------
    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def _start():
            try:
                self._server = await asyncio.start_server(
                    self._serve_conn, self.host, self.port
                )
            except OSError as e:  # bind failure — surface it to start()
                self._start_error = e
                self._started.set()
                return
            if self.port == 0:
                self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()
            async with self._server:
                await self._server.serve_forever()

        try:
            self._loop.run_until_complete(_start())
        except asyncio.CancelledError:
            pass
        finally:
            self._loop.close()

    def start(self) -> "HTTPProxy":
        if self._thread is not None:
            return self
        # Fresh state per start: a previous run's event/error must not make a
        # restart report success before (or regardless of whether) we bind.
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        # Sized for saturation, not throughput: routing threads spend
        # their time in backoff sleeps, so 64 mostly-idle threads cover
        # 64 concurrently-backing-off requests before anyone queues.
        self._route_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="proxy-route"
        )
        self._thread = threading.Thread(
            target=self._run, name="http-proxy", daemon=True
        )
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("proxy failed to start")
        if self._start_error is not None:
            self._thread.join(timeout=5)
            self._thread = None
            raise RuntimeError(
                f"proxy failed to bind {self.host}:{self.port}"
            ) from self._start_error
        logger.info("http proxy listening on %s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        loop, server = self._loop, self._server
        if loop is not None and server is not None:
            # One threadsafe callback doing close + cancel atomically in the
            # loop thread: scheduling a second call after server.close()
            # races loop shutdown (Server.close() ends serve_forever, which
            # lets _run's finally close the loop).
            def _close() -> None:
                server.close()
                for task in asyncio.all_tasks(loop):
                    if task is not asyncio.current_task(loop):
                        task.cancel()

            try:
                loop.call_soon_threadsafe(_close)
            except RuntimeError:
                pass  # loop already closed — nothing left to stop
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._route_pool is not None:
            # Don't wait: a routing call mid-backoff can hold its thread
            # for up to the assign timeout; its request future resolves
            # (rejected) independently of pool teardown.
            self._route_pool.shutdown(wait=False)
            self._route_pool = None
