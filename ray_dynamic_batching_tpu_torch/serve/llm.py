"""LLM serving deployment — continuous-batching decode behind the replica
surface, in torch.

Port of ``ray_dynamic_batching_tpu/serve/llm.py``: ``LLMDeployment`` builds
the model once (random weights from a seed, or an injected model) and
makes replicas; each :class:`LLMReplica` owns a
:class:`~ray_dynamic_batching_tpu_torch.engine.decode.DecodeEngine` whose
request queue is the replica's admission queue.

The replica surface (``queue_len`` / ``accepting`` / ``assign`` /
``failure_sink`` / ``quarantine`` / ``healthy`` / ``stats``) is inherited
from :class:`~ray_dynamic_batching_tpu_torch.serve.replica.Replica`, so the
pow-2 router treats LLM replicas like batch replicas; the decode engine's
own thread replaces the batch loop.

This slice serves one length bucket with an explicit ``num_slots``, on a
slab cache (the default) or the paged pool (``paged=True``: token-budget
chunked prefill by default), in the model dtype or with the int8 KV cache
(``quantize_kv=True``); ``chunked_prefill=True`` on the slab runs the
slab-train arm. Prompts longer than the largest bucket are served as
multi-chunk trains (the chunked arms) or through the long fill (the
monolithic arms). The controller builds replicas through
:meth:`LLMDeployment.make_replica` with a ``DeploymentConfig`` and the
devices of the replica's placement bundle (one card; more raise until
multi-GPU). The reference's auto-sizing (HBM model, measured tables),
length buckets, speculative drafts, checkpoints, weight quantisation,
prefix digests and the page fabric surface come later.

Payload contract (as the reference)::

    {"tokens": [1, 2, 3], "max_new_tokens": 64, "temperature": 0.8,
     "top_k": 40, "top_p": 0.9, "seed": 1234}

Result: ``DecodeResult`` (tokens, finish_reason, ttft_ms, total_ms).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import (
    Request,
    RequestDropped,
)
from ray_dynamic_batching_tpu_torch.serve.replica import Replica
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils.sketch import QuantileSketch

logger = get_logger("torch.serve.llm")


class LLMReplica(Replica):
    """Decode engines behind the replica surface.

    ``engine_builders`` maps a KV-capacity bucket (max_len) to a builder
    that receives that bucket's request queue and returns an un-started
    :class:`DecodeEngine`; admission routes each request to the smallest
    bucket that fits prompt + max_new_tokens. Engines warm up (kernel
    build + one prefill and decode) at construction. The router wires
    ``failure_sink`` and ``quarantine`` on registration; the engines,
    not the batch loop, execute, so neither fires here."""

    def __init__(
        self,
        replica_id: str,
        deployment: str,
        engine_builders: Dict[int, Callable[[RequestQueue], DecodeEngine]],
        max_ongoing_requests: int = 256,
        warmup: bool = True,
        default_max_new_tokens: int = 64,
    ) -> None:
        super().__init__(
            replica_id=replica_id,
            deployment=deployment,
            fn=self._reject_batch_path,  # engines own execution, not the loop
            max_ongoing_requests=max_ongoing_requests,
        )
        self.default_max_new_tokens = default_max_new_tokens
        # Admission goes straight to the per-bucket queues below.
        self.queue.close()
        self.engines: Dict[int, DecodeEngine] = {}
        self._queues: Dict[int, RequestQueue] = {}
        for bucket in sorted(engine_builders):
            q = RequestQueue(f"{deployment}:{bucket}",
                             max_len=max_ongoing_requests)
            self._queues[bucket] = q
            self.engines[bucket] = engine_builders[bucket](q)
        if warmup:
            for engine in self.engines.values():
                engine.warmup()

    @property
    def engine(self) -> DecodeEngine:
        return self.engines[max(self.engines)]

    @staticmethod
    def _reject_batch_path(payloads: List[Any]) -> Sequence[Any]:
        raise RuntimeError("LLMReplica executes via its DecodeEngines")

    def _engine_for(self, payload: Any) -> int:
        max_new = self.default_max_new_tokens
        tokens = payload
        if isinstance(payload, dict):
            tokens = payload.get("tokens", ())
            max_new = int(payload.get("max_new_tokens", max_new))
        try:
            need = len(tokens) + max_new
        except TypeError:
            need = 1 + max_new
        for bucket in sorted(self.engines):
            if bucket >= need:
                return bucket
        return max(self.engines)  # the largest finishes it: "capacity"

    def assign(self, request: Request) -> bool:
        if not self.accepting():
            return False
        q = self._queues[self._engine_for(request.payload)]
        ok = q.add_request(request, reject_on_full=False)
        if ok and request.multiplexed_model_id:
            self.record_multiplexed_model(request.multiplexed_model_id)
        return ok

    def start(self) -> None:
        for engine in self.engines.values():
            engine.start()

    def stop(self, timeout_s: float = 5.0, drain: bool = True) -> None:
        self._stopped = True
        if drain:
            deadline = time.monotonic() + timeout_s
            while self._unfinished() > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        exc = RequestDropped(f"{self.replica_id} stopped")
        for engine in self.engines.values():
            engine._run.clear()
        join_deadline = time.monotonic() + timeout_s
        for engine in self.engines.values():
            engine.stop(max(0.1, join_deadline - time.monotonic()))
        for bucket, q in self._queues.items():
            q.close()
            self.engines[bucket].abort_active(exc)
        for req in self.drain_queue():
            self._queues[self._engine_for(req.payload)].count_external_drop(
                req, reason="closed")
            req.reject(exc)
        for engine in self.engines.values():
            t = engine._thread
            if t is None or not t.is_alive():
                engine.release_buffers()

    def drain_queue(self) -> List[Request]:
        self._stopped = True
        out: List[Request] = []
        for q in self._queues.values():
            while len(q) > 0:
                out.extend(q.get_batch(self.max_ongoing_requests,
                                       discard_stale=False))
        return out

    def queue_len(self) -> int:
        """The pow-2 routing signal, as the reference counts it: queued +
        decoding + mid-admission. Pending chunk trains are not counted, so
        both packages route the same engine state the same way."""
        return sum(
            len(q) + self.engines[b].active_slots + self.engines[b]._admitting
            for b, q in self._queues.items()
        )

    def _unfinished(self) -> int:
        """:meth:`queue_len` plus pending chunk trains: what a draining
        :meth:`stop` waits for, so it never aborts a train that holds a
        slot (the reference's drain reads ``queue_len`` and can)."""
        return self.queue_len() + sum(
            len(e._trains) for e in self.engines.values())

    def healthy(self, stall_timeout_s: float = 60.0) -> bool:
        """Every engine's loop thread alive and making progress."""
        for engine in self.engines.values():
            t = engine._thread
            if t is None or not t.is_alive():
                return False
            if (time.monotonic() - engine.last_heartbeat) >= stall_timeout_s:
                return False
        return True

    def reconfigure(
        self,
        max_batch_size: Optional[int] = None,
        batch_wait_timeout_s: Optional[float] = None,
        max_ongoing_requests: Optional[int] = None,
        user_config: Optional[dict] = None,
    ) -> None:
        # Slot count / buckets are compile-shape decisions and can't change
        # on a live engine; only admission-side knobs apply. user_config is
        # accepted for base-contract compatibility (the controller passes
        # it to every replica kind) but has no user callable to deliver to.
        if max_ongoing_requests is not None:
            self.max_ongoing_requests = max_ongoing_requests
            for q in self._queues.values():
                q.max_len = max_ongoing_requests

    def slo_compliance(self) -> float:
        """Worst recent compliance across the bucket queues (the base
        queue is closed here)."""
        return min((q.slo_compliance() for q in self._queues.values()),
                   default=1.0)

    def latency_observation(self) -> tuple:
        """Merged recent-latency sketch across the bucket queues: the gray
        detector's and the hedge bar's read."""
        views = [q.latency_window.view() for q in self._queues.values()]
        merged = QuantileSketch.merged(views)
        return (merged.percentile(0.5), merged.percentile(0.95),
                len(merged))

    def stats(self) -> dict:
        s: dict = {}
        if len(self._queues) == 1:
            s.update(next(iter(self._queues.values())).stats())
        for bucket, q in self._queues.items():
            engine = self.engines[bucket]
            s[f"bucket_{bucket}"] = {
                **q.stats(),
                "active_slots": float(engine.active_slots),
                "decode_steps": float(engine.steps),
                "completed": float(engine.completed),
            }
        s["ongoing"] = float(self.queue_len())
        s["active_slots"] = float(
            sum(e.active_slots for e in self.engines.values()))
        s["decode_steps"] = float(sum(e.steps for e in self.engines.values()))
        s["completed"] = float(
            sum(e.completed for e in self.engines.values()))
        return s


class LLMDeployment:
    """Deployment factory the controller consumes via ``make_replica``:
    builds the model once and shares it across replicas.

    ``device`` defaults to ``"cuda"`` (raising without CUDA); the CPU runs
    only with ``device="cpu"``. A replica placed on a card builds the
    model there if none exists yet. Without an injected ``model`` the weights
    are random, drawn on the device from ``seed``. ``quantize_kv=True``
    builds the model with ``kv_dtype=torch.int8``; an injected model must
    already have it."""

    def __init__(
        self,
        model_name: str,
        num_slots: int = 8,
        max_len: int = 256,
        prompt_buckets: Optional[Sequence[int]] = None,
        eos_token_id: Optional[int] = None,
        default_max_new_tokens: int = 64,
        decode_horizon: int = 8,
        ttft_horizon: Optional[int] = None,
        max_admissions_per_step: int = 2,
        dtype: Union[torch.dtype, str, None] = None,
        model: Any = None,
        warmup: bool = True,
        device: Union[str, torch.device, None] = "cuda",
        seed: int = 0,
        base_seed: int = 0,
        paged: bool = False,
        page_size: int = 128,
        kv_pool_pages: Optional[int] = None,
        chunked_prefill: Optional[bool] = None,
        prefill_token_budget: Optional[int] = None,
        quantize_kv: bool = False,
    ) -> None:
        if num_slots <= 0:
            raise ValueError(
                "num_slots must be explicit: auto-sizing from HBM tables is "
                "not ported yet")
        self.model_name = model_name
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_buckets = prompt_buckets
        self.eos_token_id = eos_token_id
        self.default_max_new_tokens = default_max_new_tokens
        self.decode_horizon = decode_horizon
        self.ttft_horizon = ttft_horizon
        self.max_admissions_per_step = max_admissions_per_step
        self.warmup = warmup
        self.device = device
        self.seed = seed
        self.base_seed = base_seed
        # KV layout: the slab cache, or the paged pool with token-budget
        # chunked admission (the engine's default when paged).
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.kv_pool_pages = kv_pool_pages
        self.chunked_prefill = chunked_prefill
        self.prefill_token_budget = prefill_token_budget
        # int8 KV cache: codes + per-(token, head) f32 scales, half the
        # bytes per slot (models/decoder.py::quantize_kv_rows).
        self.quantize_kv = bool(quantize_kv)
        if isinstance(dtype, str):
            # A declarative config names the dtype ("bfloat16"), as the
            # reference's JAX models accept a dtype name.
            named = getattr(torch, dtype, None)
            if not isinstance(named, torch.dtype):
                raise ValueError(f"unknown dtype {dtype!r}")
            dtype = named
        self._dtype = dtype
        self._model = model
        self._init_lock = threading.Lock()

    def _ensure_model(self, device: Optional[torch.device] = None):
        """The deployment's one model, built at first use on ``device``
        (a replica's placed card) or the deployment's ``device``. A model
        that already sits on another device than ``device`` raises: it is
        never moved quietly."""
        with self._init_lock:
            if self._model is not None and device is not None \
                    and not _same_device(self._model.device, device):
                raise ValueError(
                    f"{self.model_name}: the model sits on "
                    f"{self._model.device}, but the replica was placed on "
                    f"{device}; one model per deployment is shared by its "
                    "replicas and is never moved")
            if self._model is None:
                from ray_dynamic_batching_tpu_torch.models import registry

                kwargs = {"device": device if device is not None
                          else self.device, "seed": self.seed}
                if self._dtype is not None:
                    kwargs["dtype"] = self._dtype
                if self.quantize_kv:
                    kwargs["kv_dtype"] = torch.int8
                self._model = registry.get_model(self.model_name, **kwargs)
            elif self.quantize_kv and getattr(
                    self._model, "kv_dtype", None) != torch.int8:
                # An injected model owns its cache dtype; serving a
                # full-precision cache while the operator believes int8 is
                # on would skew every memory and slot-count decision.
                raise ValueError(
                    "quantize_kv=True but the injected model was not built "
                    "with kv_dtype=int8 — construct it with CausalLM(..., "
                    "kv_dtype=torch.int8) or pass model_name and let the "
                    "deployment build it"
                )
            return self._model

    def build_engine(self, queue: RequestQueue,
                     max_len: Optional[int] = None,
                     device: Optional[torch.device] = None) -> DecodeEngine:
        model = self._ensure_model(device)
        max_len = max_len or self.max_len
        prompt_buckets = self.prompt_buckets
        if prompt_buckets is not None:
            prompt_buckets = [b for b in prompt_buckets if b <= max_len] \
                or [max_len]
        return DecodeEngine(
            model,
            queue,
            num_slots=self.num_slots,
            max_len=max_len,
            prompt_buckets=prompt_buckets,
            eos_token_id=self.eos_token_id,
            default_max_new_tokens=self.default_max_new_tokens,
            decode_horizon=self.decode_horizon,
            ttft_horizon=self.ttft_horizon,
            max_admissions_per_step=self.max_admissions_per_step,
            base_seed=self.base_seed,
            device=model.device,
            paged=self.paged,
            page_size=self.page_size,
            kv_pool_pages=self.kv_pool_pages,
            chunked_prefill=self.chunked_prefill,
            prefill_token_budget=self.prefill_token_budget,
        )

    # Controller protocol: factories exposing make_replica own replica
    # construction. ``devices`` arrives from the replica's placement-group
    # bundle when the deployment reserves chips.
    def make_replica(
        self, replica_id: str, config: Any, devices: Optional[Sequence] = None,
    ) -> LLMReplica:
        device = None
        if devices and len(devices) > 1:
            # Fail BEFORE any model or engine build (and before the
            # placement group's chips are consumed by a doomed start).
            raise NotImplementedError(
                f"{config.name}: a {len(devices)}-chip (tensor-parallel) "
                "replica needs multi-GPU meshes, which are not ported yet "
                "(ROADMAP queue 1 item 8) — drop chips_per_replica")
        if devices:
            device = _torch_device(devices[0])
        replica = LLMReplica(
            replica_id=replica_id,
            deployment=config.name,
            engine_builders={
                self.max_len: lambda q: self.build_engine(q, device=device),
            },
            max_ongoing_requests=config.max_ongoing_requests,
            warmup=self.warmup,
            default_max_new_tokens=self.default_max_new_tokens,
        )
        replica.devices = list(devices) if devices else None
        return replica

    # Legacy callable protocol (factory() -> fn) is not meaningful here.
    def __call__(self) -> Callable[[List[Any]], Sequence[Any]]:
        raise TypeError(
            "LLMDeployment builds replicas via make_replica; register it "
            "with the controller directly"
        )


def _torch_device(device: Any) -> torch.device:
    """A placed device as a ``torch.device``: placement's ``CudaDevice``
    carries one; a ``torch.device`` or a string converts."""
    return getattr(device, "torch_device", None) or torch.device(device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, with a bare ``cuda`` read as the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)
