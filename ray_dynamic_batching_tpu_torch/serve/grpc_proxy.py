"""gRPC ingress proxy — the second front door.

Re-creates Ray Serve's ``gRPCProxy`` (``_private/proxy.py:558``): the same
route table and deployment handles as the HTTP proxy, behind gRPC. The
environment ships ``grpcio`` but no protoc codegen plugin, so the service
is registered through grpc's generic-handler API with JSON messages —
schema-light, but the full gRPC machinery (HTTP/2 transport, deadlines,
streaming, status codes) is real:

- ``/rdb.Serve/Predict``        unary-unary   {"deployment", "payload", ...}
  → {"result": ...}
- ``/rdb.Serve/PredictStream``  unary-stream  one message per streamed
  chunk, then {"result": ...} (token streaming, ref proxy.py:959)
- ``/rdb.Serve/Healthz``        unary-unary   liveness

Deployment resolution reuses :class:`ProxyRouter` with the HTTP path
convention (``/api/{deployment}``), so both proxies share one route table.

Own copy of ``ray_dynamic_batching_tpu/serve/grpc_proxy.py`` with its
import paths rewritten, whole. ``grpc`` is imported behind a gate: without
grpcio the module (and the ``serve`` package) imports, ``HAVE_GRPC`` is
False and building a proxy or a client raises.
"""

from __future__ import annotations

import json
import time
from concurrent import futures as cf
from typing import Any, Iterator, Optional

from ray_dynamic_batching_tpu_torch.engine.request import (
    BadRequest,
    DEFAULT_QOS_CLASS,
    DEFAULT_TENANT,
    StreamClosed,
    normalize_qos,
)
from ray_dynamic_batching_tpu_torch.serve.failover import reject_disposition
from ray_dynamic_batching_tpu_torch.serve.proxy import ProxyRouter, _to_jsonable
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.tracing import parse_traceparent, tracer

logger = get_logger("grpc_proxy")

GRPC_REQUESTS = m.Counter(
    "rdb_grpc_requests_total", "gRPC requests",
    tag_keys=("method", "code", "shard"),
    bounded_tags={"shard": m.DEFAULT_SHARD_TOP_K},
)

try:  # grpcio is present in the image; gate anyway (env contract)
    import grpc

    HAVE_GRPC = True
except ImportError:  # pragma: no cover - exercised only without grpcio
    grpc = None
    HAVE_GRPC = False


def _identity(b: bytes) -> bytes:
    return b


class GRPCProxy:
    """gRPC server bridging the shared route table to deployment handles."""

    def __init__(
        self,
        router: ProxyRouter,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 60.0,
        max_workers: int = 16,
        admission=None,
        shard_id: str = "0",
    ) -> None:
        if not HAVE_GRPC:
            raise RuntimeError("grpcio is not installed")
        # Front-door shard identity (serve/frontdoor.py): tags every gRPC
        # metric family; "0" is the unsharded default.
        self.shard_id = str(shard_id)
        # Optional serve.admission.AdmissionController — same instance
        # (and therefore the same buckets/governor state) as the HTTP
        # proxy's, so a tenant cannot dodge its budget by switching doors.
        self.admission = admission
        self.router = router
        self.host = host
        self.port = port
        self.request_timeout_s = request_timeout_s
        self._server: Optional["grpc.Server"] = None
        self._max_workers = max_workers

    def _count(self, method: str, code: str) -> None:
        GRPC_REQUESTS.inc(tags={"method": method, "code": code,
                                "shard": self.shard_id})

    # --- handlers ----------------------------------------------------------
    def _resolve(self, body: dict):
        deployment = body.get("deployment")
        if not deployment:
            return None, 'missing "deployment"'
        matched = self.router.match(f"/api/{deployment}")
        if matched is None:
            return None, f"no route for deployment {deployment!r}"
        return matched[1], None

    def _predict(self, request: bytes, context) -> bytes:
        try:
            body = json.loads(request or b"{}")
        except json.JSONDecodeError as e:
            self._count("Predict", "INVALID")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad JSON: {e}")
        handle, err = self._resolve(body)
        if handle is None:
            self._count("Predict", "NOT_FOUND")
            context.abort(grpc.StatusCode.NOT_FOUND, err)
        tenant, qos = self._identity(body, context, "Predict")
        # Ingest span for the gRPC front door; a ``traceparent`` field in
        # the JSON body (the generic-handler transport has no per-call
        # metadata plumbing here) joins the caller's trace. Admission AND
        # dispatch happen inside the span: the admission.check child must
        # nest under the request trace (an orphan-trace hop never shows
        # in the request's budget ledger), and the routed request
        # inherits the context; the result wait is accounted by the
        # proxy-side future timeout.
        with tracer().attach_context(
            parse_traceparent(body.get("traceparent")),
            "grpc.predict",
            lane="grpc", deployment=body.get("deployment"),
        ):
            self._admit(body.get("deployment"), tenant,
                        self._effective_qos(handle, qos), context,
                        "Predict")
            future = handle.remote(
                body.get("payload"),
                slo_ms=body.get("slo_ms"),
                multiplexed_model_id=body.get("multiplexed_model_id"),
                tenant=tenant,
                qos_class=qos,
            )
        timeout = self._budget(context)
        try:
            result = future.result(timeout=timeout)
        except TimeoutError:
            self._count("Predict", "DEADLINE")
            context.abort(
                grpc.StatusCode.DEADLINE_EXCEEDED, "request timed out"
            )
        except Exception as e:  # noqa: BLE001 — status mapping below
            code, status = self._error_status(e)
            self._count("Predict", code)
            context.abort(status, str(e))
        self._count("Predict", "OK")
        return json.dumps({"result": _to_jsonable(result)}).encode()

    def _identity(self, body: dict, context, method: str):
        """(tenant, declared qos_class or None) from the request body —
        top-level fields win, then fields embedded in the payload dict
        (the handle reads those too, so the admitter must grade the SAME
        identity the request will serve at). An unknown class is the
        client's fault (INVALID_ARGUMENT), validated HERE so it cannot
        escape handle.remote as an unhandled servicer error. None means
        "undeclared" — the handle's per-deployment default applies."""
        payload = body.get("payload")
        nested = payload if isinstance(payload, dict) else {}
        tenant = (body.get("tenant") or nested.get("tenant")
                  or DEFAULT_TENANT)
        declared = body.get("qos_class") or nested.get("qos_class")
        if not declared:
            return tenant, None
        try:
            return tenant, normalize_qos(declared)
        except BadRequest as e:
            self._count(method, "INVALID_ARGUMENT")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    @staticmethod
    def _effective_qos(handle, qos):
        """The class admission grades when none was declared: the
        handle's deployment default (what the Request will serve at)."""
        if qos is not None:
            return qos
        return getattr(handle, "default_qos_class", DEFAULT_QOS_CLASS)

    def _admit(self, deployment: str, tenant: str, qos: str,
               context, method: str) -> None:
        """Token-bucket admission BEFORE routing: a reject costs the
        client this RPC and a computed retry hint (trailing metadata
        ``retry-after-s``), not a queue slot."""
        if self.admission is None:
            return
        # Same ledger hop as the HTTP door (admission.check).
        with tracer().span("admission.check", lane="grpc",
                           tenant=tenant, qos_class=qos):
            ok, retry_after_s = self.admission.admit(deployment, tenant, qos)
        if ok:
            return
        self._count(method, "RESOURCE_EXHAUSTED")
        context.set_trailing_metadata(
            (("retry-after-s", f"{retry_after_s:.3f}"),)
        )
        context.abort(
            grpc.StatusCode.RESOURCE_EXHAUSTED,
            f"admission rate exceeded (tenant {tenant!r}, class {qos!r}); "
            f"retry after {retry_after_s:.3f}s",
        )

    @staticmethod
    def _error_status(e: Exception):
        """Status mapping from the ONE shared table
        (``serve/failover.reject_disposition``, also the HTTP proxy's):
        capacity sheds (admission rejects, queue-full drops, stale
        discards) are RESOURCE_EXHAUSTED, retryable system failures and
        exhausted failover budgets are UNAVAILABLE, user errors
        INVALID_ARGUMENT, genuine bugs INTERNAL."""
        disp = reject_disposition(e)
        return disp.grpc_code, getattr(grpc.StatusCode, disp.grpc_code)

    def _budget(self, context) -> float:
        """Remaining time budget: client deadline capped by the server
        timeout (an already-expired deadline is a tiny positive budget, NOT
        'no deadline' — time_remaining() == 0.0 is falsy)."""
        tr = context.time_remaining()
        if tr is None:
            return self.request_timeout_s
        return min(self.request_timeout_s, max(0.001, tr))

    def _predict_stream(
        self, request: bytes, context
    ) -> Iterator[bytes]:
        try:
            body = json.loads(request or b"{}")
        except json.JSONDecodeError as e:
            self._count("PredictStream", "INVALID")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad JSON: {e}")
        handle, err = self._resolve(body)
        if handle is None:
            self._count("PredictStream", "NOT_FOUND")
            context.abort(grpc.StatusCode.NOT_FOUND, err)
        tenant, qos = self._identity(body, context, "PredictStream")
        # Admission inside the request span, same as Predict: the
        # admission.check hop must join this trace to be budgetable.
        with tracer().attach_context(
            parse_traceparent(body.get("traceparent")),
            "grpc.predict_stream",
            lane="grpc", deployment=body.get("deployment"),
        ):
            self._admit(body.get("deployment"), tenant,
                        self._effective_qos(handle, qos), context,
                        "PredictStream")
            stream, future = handle.remote_stream(
                body.get("payload"), slo_ms=body.get("slo_ms"),
                tenant=tenant, qos_class=qos,
            )
        # One budget covers the WHOLE stream (chunks + trailer), so a
        # stalled replica can't pin a worker thread for 2x the timeout.
        deadline = time.monotonic() + self._budget(context)

        def remaining() -> float:
            return deadline - time.monotonic()

        error: Optional[Exception] = None
        while True:
            try:
                chunk = stream.get(timeout_s=max(0.001, remaining()))
            except StreamClosed:
                break
            except Exception as e:  # noqa: BLE001 — status carries it below
                error = e
                break
            yield json.dumps({"chunk": _to_jsonable(chunk)}).encode()
        if error is None:
            try:
                result = future.result(timeout=max(0.001, remaining()))
                yield json.dumps({"result": _to_jsonable(result)}).encode()
                self._count("PredictStream", "OK")
                return
            except Exception as e:  # noqa: BLE001
                error = e
        # Replica/timeout errors terminate the RPC with a real gRPC status
        # (same mapping as Predict), not an OK stream with an error body.
        if isinstance(error, TimeoutError):
            self._count("PredictStream", "DEADLINE")
            context.abort(
                grpc.StatusCode.DEADLINE_EXCEEDED, "stream timed out"
            )
        code, status = self._error_status(error)
        self._count("PredictStream", code)
        context.abort(status, str(error))

    def _healthz(self, request: bytes, context) -> bytes:
        return json.dumps({"status": "ok"}).encode()

    # --- lifecycle ---------------------------------------------------------
    def start(self) -> "GRPCProxy":
        if self.admission is None:
            # Default to the module controller's admission table (the
            # same instance the HTTP proxy grades against) so a tenant
            # cannot dodge its budget by switching doors; pass
            # ``admission=`` explicitly to bind a different controller.
            from ray_dynamic_batching_tpu_torch.serve import api as _api

            ctl = getattr(_api, "_controller", None)
            if ctl is not None:
                self.admission = ctl.admission
        rpcs = {
            "Predict": grpc.unary_unary_rpc_method_handler(
                self._predict,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
            "PredictStream": grpc.unary_stream_rpc_method_handler(
                self._predict_stream,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
            "Healthz": grpc.unary_unary_rpc_method_handler(
                self._healthz,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
        }
        self._server = grpc.server(
            cf.ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix="grpc-proxy",
            )
        )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("rdb.Serve", rpcs),)
        )
        self.port = self._server.add_insecure_port(f"{self.host}:{self.port}")
        if self.port == 0:
            raise RuntimeError("grpc proxy failed to bind")
        self._server.start()
        logger.info("grpc proxy listening on %s:%d", self.host, self.port)
        return self

    def stop(self, grace_s: float = 1.0) -> None:
        if self._server is not None:
            self._server.stop(grace_s).wait(grace_s + 1)
            self._server = None


class GRPCIngressClient:
    """Minimal client for the generic service (tests, load generators)."""

    def __init__(self, host: str, port: int):
        if not HAVE_GRPC:
            raise RuntimeError("grpcio is not installed")
        self.channel = grpc.insecure_channel(f"{host}:{port}")
        self._predict = self.channel.unary_unary(
            "/rdb.Serve/Predict",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        self._predict_stream = self.channel.unary_stream(
            "/rdb.Serve/PredictStream",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        self._healthz = self.channel.unary_unary(
            "/rdb.Serve/Healthz",
            request_serializer=_identity,
            response_deserializer=_identity,
        )

    def predict(self, deployment: str, payload: Any,
                timeout_s: float = 30.0, **opts) -> Any:
        body = json.dumps(
            {"deployment": deployment, "payload": payload, **opts}
        ).encode()
        resp = self._predict(body, timeout=timeout_s)
        return json.loads(resp)["result"]

    def predict_stream(self, deployment: str, payload: Any,
                       timeout_s: float = 30.0) -> Iterator[dict]:
        body = json.dumps(
            {"deployment": deployment, "payload": payload}
        ).encode()
        for msg in self._predict_stream(body, timeout=timeout_s):
            yield json.loads(msg)

    def healthz(self, timeout_s: float = 5.0) -> dict:
        return json.loads(self._healthz(b"{}", timeout=timeout_s))

    def close(self) -> None:
        self.channel.close()
