"""OpenAI-shaped completions surface over an LLM deployment.

Clients speaking the de-facto ``/v1/completions`` wire shape can hit the
framework without learning its native payloads: the adapter translates
{model, prompt, max_tokens, temperature, top_k, seed, stop, logit_bias,
user/session} into the decode engine's request fields and wraps
``DecodeResult`` back into the ``{id, object, choices, usage}`` response
envelope, with finish reasons mapped to the API's vocabulary.

Token ids, not text: this image has no tokenizer assets (zero egress), so
``prompt`` is a list of token ids and ``choices[].tokens`` carries ids.
The shape — not the tokenizer — is what client SDKs and gateways key on.
Streaming clients use the native NDJSON route (``{"stream": true}``,
``serve/proxy.py``); SSE framing is not replicated.

The reference's serve stack exposes raw handle routing only (its proxy
maps routes to deployments, ``_private/proxy.py:446``); an API-schema
adapter is a serving-completeness addition.

Own copy of ``ray_dynamic_batching_tpu/serve/openai_api.py`` with its
import paths rewritten, whole.
"""

from __future__ import annotations

import time
import uuid
from concurrent.futures import Future
from typing import Any, Dict, Optional

from ray_dynamic_batching_tpu_torch.engine.request import BadRequest, normalize_qos
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle

_FINISH_MAP = {
    "eos": "stop",
    "length": "length",
    "capacity": "length",
}


def _bad(msg: str) -> BadRequest:
    return BadRequest(f"invalid completions request: {msg}")


def translate_request(body: Dict[str, Any],
                      default_max_tokens: int = 64) -> Dict[str, Any]:
    """OpenAI-shaped body -> native decode payload (raises ValueError on
    malformed input so the proxy answers 4xx, not a replica error)."""
    if not isinstance(body, dict):
        raise _bad("body must be a JSON object")
    prompt = body.get("prompt")
    if (not isinstance(prompt, (list, tuple)) or not prompt
            or not all(isinstance(t, int) for t in prompt)):
        raise _bad("prompt must be a non-empty list of token ids "
                   "(no tokenizer assets in this environment)")
    if body.get("n", 1) != 1:
        raise _bad("n > 1 is not supported")
    if body.get("stream"):
        # The NATIVE route streams NDJSON; this adapter's response
        # envelope is unary. Reject loudly (a dropped connection would
        # look like a proxy bug to the client).
        raise _bad("stream=true is not supported on /v1/completions; "
                   "use the deployment's native route with "
                   '{"stream": true}')
    payload: Dict[str, Any] = {"tokens": list(prompt)}
    # Coercion failures (int(None), dict([1,2]), float("hot")) are the
    # CLIENT's malformed fields: fold TypeError in too, or they escape
    # the BadRequest->400 path as server errors.
    try:
        payload["max_new_tokens"] = int(
            body.get("max_tokens", default_max_tokens)
        )
        if "temperature" in body:
            payload["temperature"] = float(body["temperature"])
        if "top_k" in body:
            payload["top_k"] = int(body["top_k"])
        if "top_p" in body:
            payload["top_p"] = float(body["top_p"])
        if "seed" in body:
            payload["seed"] = int(body["seed"])
        if "presence_penalty" in body:
            payload["presence_penalty"] = float(body["presence_penalty"])
        if "frequency_penalty" in body:
            payload["frequency_penalty"] = float(body["frequency_penalty"])
        if "stop" in body:  # token ids, per the module contract
            stop = body["stop"]
            if not isinstance(stop, (list, tuple)):
                stop = [stop]
            payload["stop_token_ids"] = [int(t) for t in stop]
        if "logit_bias" in body:
            payload["logit_bias"] = {
                int(t): float(v)
                for t, v in dict(body["logit_bias"]).items()
            }
    except BadRequest:
        raise
    except (TypeError, ValueError) as e:
        raise _bad(f"malformed field: {e}")
    # Session continuation key: prefer the explicit extension field,
    # fall back to OpenAI's standard `user` (stable per end-user, which
    # is exactly what conversation KV affinity wants).
    session = body.get("session_id", body.get("user"))
    if session is not None:
        payload["session_id"] = str(session)
    # QoS extension fields: `tenant` names the paying account, `qos_class`
    # the service tier — both ride the native payload so the handle stamps
    # them onto the Request (admission at the proxy graded them already).
    # An unknown class is a 400, mirror of the native doors.
    if body.get("tenant") is not None:
        payload["tenant"] = str(body["tenant"])
    if body.get("qos_class") is not None:
        payload["qos_class"] = normalize_qos(str(body["qos_class"]))
    return payload


def translate_response(model: str, prompt_len: int, result: Any
                       ) -> Dict[str, Any]:
    """DecodeResult -> completions response envelope."""
    n_out = len(result.tokens)
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "tokens": list(result.tokens),
            "finish_reason": _FINISH_MAP.get(result.finish_reason,
                                             result.finish_reason),
        }],
        "usage": {
            "prompt_tokens": prompt_len,
            "completion_tokens": n_out,
            "total_tokens": prompt_len + n_out,
        },
        "ttft_ms": round(result.ttft_ms, 1),
    }


class CompletionsHandle:
    """Drop-in for :class:`DeploymentHandle` on a proxy route: the proxy
    calls ``remote(body)`` and resolves the returned future — this wrapper
    translates on the way in and rewraps the resolved result on the way
    out, so ``ProxyRouter.set_route('/v1/completions', ...)`` is the whole
    integration."""

    def __init__(self, handle: DeploymentHandle, model: str,
                 default_max_tokens: int = 64,
                 default_slo_ms: Optional[float] = None):
        self._handle = handle
        self.model = model
        self.default_max_tokens = default_max_tokens
        self.default_slo_ms = default_slo_ms

    @property
    def deployment(self) -> str:
        return self._handle.deployment

    def remote(self, body: Any, **kwargs):
        out: Future = Future()
        try:
            payload = translate_request(body, self.default_max_tokens)
        except Exception as e:  # noqa: BLE001 — a synchronous raise would
            out.set_exception(e)  # drop the HTTP connection responseless
            return out
        if self.default_slo_ms is not None:
            kwargs.setdefault("slo_ms", self.default_slo_ms)
        inner = self._handle.remote(payload, **kwargs)

        def _done(f):
            if out.done():  # proxy timeout already cancelled the future
                return
            try:
                out.set_result(translate_response(
                    self.model, len(payload["tokens"]), f.result()
                ))
            except Exception as e:  # noqa: BLE001 — surface replica errors
                if not out.done():
                    out.set_exception(e)

        inner.add_done_callback(_done)
        return out
