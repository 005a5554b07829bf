"""DeploymentHandle — the caller-side API for a deployment.

Own copy of ``ray_dynamic_batching_tpu/serve/handle.py``, whole, with
its import paths rewritten.

Re-creates Ray Serve's ``DeploymentHandle``
(``python/ray/serve/handle.py:745``; ``.remote()`` at ``:821`` returns a
response future resolved by the router): ``handle.remote(payload)`` builds a
request, routes it pow-2, and returns a ``concurrent.futures.Future`` the
caller (sync or asyncio via ``wrap_future``) awaits.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Optional, Tuple

from ray_dynamic_batching_tpu_torch.engine.request import (
    DEFAULT_QOS_CLASS,
    DEFAULT_TENANT,
    Request,
    TokenStream,
    normalize_qos,
)
from ray_dynamic_batching_tpu_torch.serve.router import Router
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer


def _session_affinity(payload: Any) -> Optional[str]:
    """Steer a session's turns to the replica holding its KV row: the
    session cache is per-engine, so without affinity a multi-replica
    deployment misses ~(n-1)/n of continuations. Rides the same
    multiplex-awareness the pow-2 scheduler already ranks by."""
    if isinstance(payload, dict) and payload.get("session_id") is not None:
        return f"session:{payload['session_id']}"
    return None


class DeploymentHandle:
    """Lightweight, shareable; one per (caller, deployment)."""

    def __init__(
        self,
        router: Router,
        default_slo_ms: float = 30_000.0,
        default_qos_class: str = DEFAULT_QOS_CLASS,
    ) -> None:
        self.router = router
        self.default_slo_ms = default_slo_ms
        # Per-deployment default tier (DeploymentConfig.default_qos_class):
        # requests that declare nothing serve at the deployment's contract.
        self.default_qos_class = normalize_qos(default_qos_class)

    def _qos_identity(self, payload, tenant, qos_class):
        """Resolve (tenant, qos_class): explicit kwargs (the gRPC/OpenAI
        doors) win, then payload fields (the HTTP door injects here), then
        the deployment default. Unknown classes raise BadRequest so the
        caller answers 4xx."""
        if isinstance(payload, dict):
            tenant = tenant or payload.get("tenant")
            qos_class = qos_class or payload.get("qos_class")
        return (
            tenant or DEFAULT_TENANT,
            normalize_qos(qos_class or self.default_qos_class),
        )

    @property
    def deployment(self) -> str:
        return self.router.deployment

    def remote(
        self,
        payload: Any,
        slo_ms: Optional[float] = None,
        locality_hint: Optional[str] = None,
        multiplexed_model_id: Optional[str] = None,
        tenant: Optional[str] = None,
        qos_class: Optional[str] = None,
    ) -> Future:
        """Route one request; the future resolves to the replica's result
        (ref handle.py:821). ``multiplexed_model_id`` steers routing toward
        replicas already holding that model (ref handle
        ``options(multiplexed_model_id=...)``). ``tenant``/``qos_class``
        ride the request through queueing, spans and failover (explicit
        kwargs > payload fields > deployment default)."""
        multiplexed_model_id = multiplexed_model_id or _session_affinity(
            payload
        )
        tenant, qos_class = self._qos_identity(payload, tenant, qos_class)
        # Span around routing; context rides the request so the replica's
        # execution span joins the same trace (ref task-metadata
        # propagation, tracing_helper.py:165,293).
        with tracer().span(
            "handle.remote", deployment=self.deployment,
            tenant=tenant, qos_class=qos_class,
        ):
            request = Request(
                model=self.deployment,
                payload=payload,
                slo_ms=slo_ms if slo_ms is not None else self.default_slo_ms,
                multiplexed_model_id=multiplexed_model_id,
                trace_ctx=tracer().inject_context(),
                tenant=tenant,
                qos_class=qos_class,
            )
            self.router.assign_request(request, locality_hint=locality_hint)
        return request.future

    def remote_stream(
        self,
        payload: Any,
        slo_ms: Optional[float] = None,
        locality_hint: Optional[str] = None,
        tenant: Optional[str] = None,
        qos_class: Optional[str] = None,
    ) -> Tuple[TokenStream, Future]:
        """Route one streaming request: chunks arrive on the returned
        :class:`TokenStream` as the replica produces them, the future still
        resolves with the final result (ref streaming handle path,
        ``serve/_private/replica.py:515`` ``handle_request_streaming``)."""
        stream = TokenStream()
        tenant, qos_class = self._qos_identity(payload, tenant, qos_class)
        with tracer().span(
            "handle.remote_stream", deployment=self.deployment,
            tenant=tenant, qos_class=qos_class,
        ):
            request = Request(
                model=self.deployment,
                payload=payload,
                slo_ms=slo_ms if slo_ms is not None else self.default_slo_ms,
                stream=stream,
                multiplexed_model_id=_session_affinity(payload),
                trace_ctx=tracer().inject_context(),
                tenant=tenant,
                qos_class=qos_class,
            )
            self.router.assign_request(request, locality_hint=locality_hint)
        return stream, request.future

    def options(self, slo_ms: Optional[float] = None,
                qos_class: Optional[str] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.router,
            default_slo_ms=slo_ms if slo_ms is not None else self.default_slo_ms,
            default_qos_class=(qos_class if qos_class is not None
                               else self.default_qos_class),
        )
