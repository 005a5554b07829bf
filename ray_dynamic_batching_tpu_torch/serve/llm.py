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

A deployment serves one engine per ``length_buckets`` entry (default: one
at ``max_len``), requests routed to the smallest cache that fits prompt +
max_new_tokens, on a slab cache (the default) or the paged pool
(``paged=True``: token-budget chunked prefill by default), in the model
dtype or with the int8 KV cache (``quantize_kv=True``);
``chunked_prefill=True`` on the slab runs the slab-train arm. Prompts
longer than the largest bucket are served as multi-chunk trains (the
chunked arms) or through the long fill (the monolithic arms).
``num_slots <= 0`` sizes each engine: from measured decode tables when
``profiles_dir`` holds them (:meth:`LLMDeployment.plan_from_tables`, which
also derives the horizons from ``token_slo_ms`` / ``ttft_slo_ms``), else
from the memory budget (:meth:`LLMDeployment.auto_num_slots`). The
controller builds replicas through :meth:`LLMDeployment.make_replica` with
a ``DeploymentConfig`` and the devices of the replica's placement bundle;
a bundle of more than one device makes a tensor-parallel replica over
its own mesh (``parallel/mesh.py``; reference ``llm.py:885-913``), whose
ranks the replica ends when it stops. KV reuse comes through
``prefix_cache_size``, ``session_cache_size`` and ``host_spill_pages``
(``DecodeEngine``), and the replica exposes the prefix digests and the
page-fabric surface (live migration, prefix push) the controller's
courier drives. Speculative decoding comes through ``draft_model_name``
(a registry model built beside the target from its own seed, 1) or a
built ``draft_model`` module (the target module itself for a
self-draft, sharing its weights unless ``quantize_weights=True``, where
it keeps a full-precision copy), with ``spec_tokens``; every
length-bucket engine gets the draft. ``quantize_weights=True`` serves
weight-only int8 (``models/quant.py``): the model is quantized once in
place and shared by every length-bucket engine, and ``auto_num_slots``
counts its int8 bytes. ``params`` takes the JAX package's params tree
(numpy leaves; a ``quantize_tree`` output keeps its codes) bridged by
``models/convert.py::params_from_flax``. ``checkpoint_dir`` (with
``checkpoint_step``, default the latest) restores the weights from a
``runtime/checkpoint.py`` step directory instead, the JAX params tree in
the reference's format: one the JAX package's ``CheckpointManager``
wrote serves here as it serves there.

Payload contract (as the reference)::

    {"tokens": [1, 2, 3], "max_new_tokens": 64, "temperature": 0.8,
     "top_k": 40, "top_p": 0.9, "seed": 1234, "session_id": "chat-1"}

Result: ``DecodeResult`` (tokens, finish_reason, ttft_ms, total_ms).
"""

from __future__ import annotations

import copy
import threading
import time
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import (
    Request,
    RequestDropped,
)
from ray_dynamic_batching_tpu_torch.models.quant import (
    is_quantized,
    load_state,
    quantize_tree,
    tree_weight_bytes,
)
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
from ray_dynamic_batching_tpu_torch.serve.replica import Replica
from ray_dynamic_batching_tpu_torch.utils.config import get_config
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
        mesh: Any = None,
    ) -> None:
        # A tensor-parallel replica's mesh: its ranks end with the replica.
        self.mesh = mesh
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
        if self.mesh is not None:
            self.mesh.shutdown()

    def drain_queue(self) -> List[Request]:
        self._stopped = True
        out: List[Request] = []
        for q in self._queues.values():
            while len(q) > 0:
                out.extend(q.get_batch(self.max_ongoing_requests,
                                       discard_stale=False))
        return out

    def prefix_digests(self, limit: int = 128) -> Optional[dict]:
        """Bounded prefix-page digest publication merged across this
        replica's bucket engines (cluster-wide prefix routing).
        The controller collects this each control step and pushes it to
        the router's digest directory over the long-poll channel."""
        merged: dict = {}
        page_size = None
        reloaded: List[str] = []
        for engine in self.engines.values():
            pub = engine.prefix_digests(limit)
            if pub is None:
                continue
            page_size = pub["page_size"]
            # Spill round-trip republish: forwarded so the controller can
            # force a directory push even when the advertised union is
            # unchanged.
            reloaded.extend(pub.get("reloaded", ()))
            for key, n in pub["digests"].items():
                if len(merged) >= limit:
                    break
                merged.setdefault(key, n)
        if page_size is None:
            return None
        out: dict = {"page_size": page_size, "digests": merged}
        if reloaded:
            out["reloaded"] = reloaded
        return out

    # --- page fabric surface (live migration + prefix push) ---------------
    def live_stream_ids(self) -> List[str]:
        """Migration-eligible stream ids across this replica's bucket
        engines (paged engines only; slab engines migrate nothing)."""
        out: List[str] = []
        for engine in self.engines.values():
            if engine.paged:
                out.extend(engine.live_stream_ids())
        return out

    def request_migration(self, request_id: str, deliver) -> bool:
        """Ask whichever bucket engine holds ``request_id`` to migrate it
        out through ``deliver`` (see DecodeEngine.request_migration)."""
        for engine in self.engines.values():
            if engine.paged and engine.request_migration(
                    request_id, deliver):
                return True
        return False

    def accept_parcel(self, parcel) -> bool:
        """Destination half of the courier edge at replica granularity:
        stream parcels route to the smallest capacity bucket that fits
        the stream's resume length (same bandwidth-per-token rule as
        fresh admissions), falling back to any accepting engine; prefix
        parcels go to the largest engine (where long prompts land)."""
        if self._stopped:
            return False
        if parcel.kind == "stream":
            need = parcel.resume_len
            for bucket in sorted(self.engines):
                if bucket >= need and self.engines[bucket].accept_parcel(
                        parcel):
                    return True
            for bucket in sorted(self.engines, reverse=True):
                if self.engines[bucket].accept_parcel(parcel):
                    return True
            return False
        return self.engine.accept_parcel(parcel)

    def hot_prefixes(self, limit: int = 8) -> List[tuple]:
        """Hit-ranked resident prefix entries across bucket engines, as
        ``(digest_hex, n_pages, hits)`` — the push planner's ranking."""
        out: List[tuple] = []
        for engine in self.engines.values():
            if engine.paged_prefix is not None:
                out.extend(engine.paged_prefix.hot(limit))
        out.sort(key=lambda t: -t[2])
        return out[:limit]

    def request_prefix_push(self, digest_hex: str, deliver) -> bool:
        """Export the prefix entry addressed by ``digest_hex`` through
        ``deliver`` from whichever engine holds it."""
        key = bytes.fromhex(digest_hex)
        for engine in self.engines.values():
            cache = engine.paged_prefix
            if cache is None or key not in cache._entries:
                continue
            if engine.request_prefix_push(key, deliver):
                return True
        return False

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
    already have it. ``draft_model_name`` builds a draft beside the model
    (on its device, seed 1, the model dtype, its own KV dtype);
    ``draft_model`` injects one (the model itself for a self-draft).
    ``params`` (a flax params tree of numpy arrays, possibly quantized by
    the JAX package) replaces the random weights of the model it builds;
    ``checkpoint_dir`` restores them from a checkpoint instead (step
    ``checkpoint_step``, default the latest), into the built or injected
    model, before any quantization. ``quantize_weights=True`` quantizes
    the model once, in place (idempotent: a pre-quantized tree passes
    through); a separate draft
    is not quantized, and a self-draft keeps a full-precision copy of the
    model's weights made before quantization (the reference's
    ``draft_params``).

    ``num_slots <= 0`` means "size me" (:meth:`build_engine`): the
    memory budget is the config's ``hbm_budget_bytes``, which on a card
    the caller sets from the card; nothing here reads a card's memory.

    A replica placed on several devices is tensor-parallel: its mesh runs
    on ``mesh_backend`` (default: NCCL when every rank has its own card,
    gloo on the CPU; several ranks on one card need ``"gloo"`` named),
    and the model is sharded once per mesh — drawn from ``seed`` on every
    rank, or, with ``params`` or an injected ``model``, cut from the whole
    weights (``parallel/mesh.py``)."""

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
        prefix_cache_size: int = 0,
        session_cache_size: int = 0,
        host_spill_pages: int = 0,
        quantize_kv: bool = False,
        length_buckets: Optional[Sequence[int]] = None,
        profiles_dir: Optional[str] = None,
        token_slo_ms: Optional[float] = None,
        ttft_slo_ms: Optional[float] = None,
        draft_model_name: Optional[str] = None,
        draft_model: Any = None,
        spec_tokens: int = 4,
        quantize_weights: bool = False,
        params: Any = None,
        mesh_backend: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_step: Optional[int] = None,
    ) -> None:
        if params is not None and model is not None:
            raise ValueError("pass either params or model, not both — an "
                             "injected model owns its weights")
        if checkpoint_dir is not None and params is not None:
            raise ValueError(
                "pass either params or checkpoint_dir, not both — the "
                "checkpoint would be silently ignored"
            )
        # Real weights: restored from the checkpoint subsystem instead of
        # a random draw, once, into the model every replica shares.
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_step = checkpoint_step
        self._restored = False
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
        # KV-capacity buckets: one engine per entry, requests routed to the
        # smallest cache fitting prompt + max_new (LLMReplica). Default:
        # one engine at max_len.
        self.length_buckets = sorted(length_buckets or [max_len])
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
        # KV reuse, per engine (0 = off): prefix entries, the host spill
        # tier's pages (paged, beside a prefix cache) and session turns.
        # A conversation that outgrows its length bucket lands on a larger
        # engine and re-prefills once.
        self.prefix_cache_size = prefix_cache_size
        self.host_spill_pages = host_spill_pages
        self.session_cache_size = session_cache_size
        # int8 KV cache: codes + per-(token, head) f32 scales, half the
        # bytes per slot (models/decoder.py::quantize_kv_rows).
        self.quantize_kv = bool(quantize_kv)
        # Weight-only int8, quantized once in _ensure_model and shared by
        # every length-bucket engine (per-engine quantization would
        # multiply the resident copies by the bucket count).
        self.quantize_weights = bool(quantize_weights)
        self._params = params
        if isinstance(dtype, str):
            # A declarative config names the dtype ("bfloat16"), as the
            # reference's JAX models accept a dtype name.
            named = getattr(torch, dtype, None)
            if not isinstance(named, torch.dtype):
                raise ValueError(f"unknown dtype {dtype!r}")
            dtype = named
        self._dtype = dtype
        self._model = model
        # Speculative decoding: a smaller registry model (or an injected
        # module, the counterpart of the reference's draft_params) drafts,
        # the target verifies (greedy-exact; DecodeEngine._spec_impl).
        self.draft_model_name = draft_model_name
        self.spec_tokens = spec_tokens
        self._draft_model = draft_model
        # Measured-table control (ref nexus.py:129-296 — profiled-latency-
        # driven planning): when ``profiles_dir`` holds
        # ``<model>_decode_summary.csv`` / ``<model>_prefill_summary.csv``
        # tables (profiles/decode_profiler.py), single-card engines derive
        # num_slots (if not pinned), decode_horizon and ttft_horizon from
        # measurement + the token/TTFT SLOs instead of the analytic memory
        # model — see plan_from_tables.
        self.profiles_dir = profiles_dir
        self.token_slo_ms = token_slo_ms
        self.ttft_slo_ms = ttft_slo_ms
        self._table_plans: Dict[tuple, Optional[Dict[str, int]]] = {}
        self._init_lock = threading.Lock()
        self.mesh_backend = mesh_backend
        # id(mesh) -> (mesh, rank 0's shard of the model on it).
        self._mesh_models: Dict[int, tuple] = {}

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
                if self._params is not None or self.checkpoint_dir:
                    kwargs["seed"] = None
                self._model = registry.get_model(self.model_name, **kwargs)
                if self._params is not None:
                    from ray_dynamic_batching_tpu_torch.models.convert import (
                        params_from_flax,
                    )

                    load_state(self._model, params_from_flax(
                        self._params, self._model.cfg))
                    self._params = None
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
            if self.checkpoint_dir is not None and not self._restored:
                self._restore_checkpoint()
            if self.quantize_weights:
                if self._draft_model is self._model:
                    # A self-draft drafts from the full-precision weights
                    # (the reference's draft_params): keep a copy before
                    # the codes replace them (engine/decode.py).
                    if is_quantized(self._model):
                        raise ValueError(
                            f"{self.model_name}: a self-draft of an already "
                            "quantized model would draft from its int8 "
                            "codes; its full-precision weights are gone")
                    self._draft_model = copy.deepcopy(self._model)
                quantize_tree(self._model)
            if self.draft_model_name is not None and self._draft_model is None:
                from ray_dynamic_batching_tpu_torch.models import registry

                # The reference draws the draft's weights from PRNGKey(1):
                # here its own generator, seed 1, on the target's device.
                kwargs = {"device": self._model.device, "seed": 1}
                if self._dtype is not None:
                    kwargs["dtype"] = self._dtype
                self._draft_model = registry.get_model(
                    self.draft_model_name, **kwargs)
            return self._model

    def _restore_checkpoint(self) -> None:
        """Load ``checkpoint_dir``'s step (default the latest) into the
        model, on its device: the saved flax tree restored into the
        structure ``params_to_flax`` gives the model, then mapped back
        (reference ``llm.py:531-541``). Caller holds ``_init_lock``."""
        from ray_dynamic_batching_tpu_torch.models.convert import (
            params_from_flax,
            params_to_flax,
        )
        from ray_dynamic_batching_tpu_torch.runtime.checkpoint import (
            CheckpointManager,
        )

        model = self._model
        tree = CheckpointManager(self.checkpoint_dir).restore(
            params_to_flax(model), step=self.checkpoint_step,
            device=model.device)
        load_state(model, params_from_flax(tree, model.cfg))
        self._restored = True

    def _sharded_model(self, mesh: Any):
        """The deployment's model on ``mesh``, sharded once per mesh: drawn
        from ``seed`` on every rank (no rank holds the whole model), or
        cut from the deployment's built model or ``params``."""
        from ray_dynamic_batching_tpu_torch.models import registry
        from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod

        with self._init_lock:
            held = self._mesh_models.get(id(mesh))
            if held is not None and held[0] is mesh:
                return held[1]
            fresh = (self._model is None and self._params is None
                     and self.checkpoint_dir is None)
        if fresh:
            kwargs = {"device": "meta", "seed": None}
            if self._dtype is not None:
                kwargs["dtype"] = self._dtype
            if self.quantize_kv:
                kwargs["kv_dtype"] = torch.int8
            probe = registry.get_model(self.model_name, **kwargs)
            shard = mesh_mod.build_sharded_model(
                mesh, type(probe), probe.cfg, probe.name, dtype=probe.dtype,
                seed=self.seed, kv_dtype=probe.kv_dtype)
        else:
            shard = mesh_mod.shard_params(mesh, self._ensure_model())
        with self._init_lock:
            self._mesh_models = {k: v for k, v in self._mesh_models.items()
                                 if v[0].world is not None
                                 and not v[0].world.closed}
            self._mesh_models[id(mesh)] = (mesh, shard)
        return shard

    def auto_num_slots(self, n_chips: int = 1,
                       max_len: Optional[int] = None,
                       budget_fraction: float = 1.0,
                       model: Any = None) -> int:
        """Size the continuous batch from the memory budget: per device,
        subtract this device's weight share, apply the planner's fraction
        (``RDB_HBM_PLAN_FRACTION`` — the knob the Nexus packer uses), and
        fill the rest with this device's KV-row shares. Tensor-parallel
        replicas would shard both weights and KV 1/n_chips, so per-device
        terms divide through (the arithmetic is the reference's; the port
        builds one-card replicas). Rounded down to a power of two (aligns
        prefill group widths), at most 256. ``model``: the model whose
        whole weights and KV rows are counted (default the deployment's;
        a TP replica passes an empty twin of the whole model)."""
        model = model if model is not None else self._ensure_model()
        cfg = get_config()
        # _ensure_model already quantized the model when asked, so a plain
        # byte count is exact for both modes.
        weights_bytes = tree_weight_bytes(model) / max(1, n_chips)
        budget = float(cfg.hbm_budget_bytes)
        per_slot = float(
            model.kv_bytes_per_slot(max_len or self.max_len)
        ) / max(1, n_chips)
        draft = self._draft_model
        if draft is not None:
            # Speculation's residency: the draft's weights (none extra for
            # a self-draft that shares the target module's; a quantized
            # target's self-draft is its full-precision copy, counted as
            # the reference counts draft_params) and a draft KV row per
            # slot with the window's headroom past max_len.
            if draft is not model:
                weights_bytes += tree_weight_bytes(draft) / max(1, n_chips)
            per_slot += float(draft.kv_bytes_per_slot(
                (max_len or self.max_len) + self.spec_tokens + 1
            )) / max(1, n_chips)
        if self.session_cache_size > 0:
            # Each stored session turn pins a full KV row: the cache at
            # capacity is that many phantom slots, in EVERY length-bucket
            # engine (rows sized by its bucket), while this call sees a
            # 1/n_buckets slice — so the whole deployment's session
            # residency comes off the top here.
            weights_bytes += (
                self.session_cache_size
                * float(sum(model.kv_bytes_per_slot(b)
                            for b in self.length_buckets))
            ) / max(1, n_chips)
        usable = (
            (budget - weights_bytes) * cfg.hbm_plan_fraction * budget_fraction
        )
        n = int(max(1.0, usable / max(per_slot, 1.0)))
        n = min(n, 256)
        n = 1 << (n.bit_length() - 1)   # round down to a power of two
        logger.info(
            "%s: auto num_slots=%d (%d chip(s), weights %.0f MB/chip, "
            "%.2f MB/slot/chip, budget %.0f GB/chip x %.2f)",
            self.model_name, n, n_chips, weights_bytes / 1e6,
            per_slot / 1e6, budget / 1e9, cfg.hbm_plan_fraction,
        )
        return n

    def plan_from_tables(
        self,
        decode_profile,
        prefill_profile=None,
        *,
        max_len: Optional[int] = None,
        token_slo_ms: Optional[float] = None,
        ttft_slo_ms: Optional[float] = None,
        num_slots: Optional[int] = None,
    ) -> Dict[str, int]:
        """Derive (num_slots, decode_horizon, ttft_horizon) from MEASURED
        decode tables + SLOs — the reference's profiled-latency control
        theory (``293-project/src/nexus.py:129-296``: committed tables
        drive admission/packing) applied to the decode phase, replacing
        the analytic memory model of :meth:`auto_num_slots`:

        - **num_slots**: among measured (slots, capacity) configs whose
          program fits the planner's HBM budget and whose per-substep
          latency respects the token SLO, the one with the highest
          full-occupancy token throughput.
        - **decode_horizon**: tokens reach the host only at scan end, so a
          full-batch scan of ``h`` substeps delivers bursts with gaps of
          ``h x step_ms`` — the token-latency SLO bounds ``h``.
        - **ttft_horizon**: an idle-queue arrival waits out at most one
          ttft-tier scan, then prefills; the TTFT budget left after the
          measured prefill latency (largest prompt bucket, group 1),
          with 20% headroom for queue/dispatch, bounds the tier.

        ``num_slots`` pins the slot count (the colocation planner's
        placement dictates it): horizons are then derived from THAT
        config's measured step — horizons computed for a different batch
        size would silently re-break the SLO the scan length encodes.

        Tables are profiled at the model's default (bf16) cache. Planning
        an int8-KV deployment (``quantize_kv=True``) from them is SAFE
        but conservative: the quantized scan is faster and smaller than
        the measured rows, so slot counts and horizons under-promise —
        re-profile with the quantized model to plan at its true capacity.
        """
        cfg = get_config()
        budget = cfg.hbm_budget_bytes * cfg.hbm_plan_fraction / max(
            1, len(self.length_buckets)
        )
        max_len = max_len or self.max_len
        token_slo_ms = token_slo_ms or self.token_slo_ms
        ttft_slo_ms = ttft_slo_ms or self.ttft_slo_ms
        candidates = [
            r for r in decode_profile.rows
            if r.seq_len == max_len and r.hbm_bytes > 0
        ]
        if num_slots is not None:
            # Pin BEFORE the budget filter: a caller-pinned config (the
            # colocation planner's placement) was already validated
            # against the planner's own HBM budget — re-filtering it
            # against the deployment's per-bucket slice would reject a
            # measured row that exists and silently fall back to default
            # horizons, the exact burst-SLO breach the pin prevents.
            rows = [r for r in candidates if r.batch_size == num_slots]
            if not rows:
                raise ValueError(
                    f"{self.model_name}: no measured decode row at "
                    f"(slots={num_slots}, cap={max_len}) to derive "
                    "horizons from"
                )
        else:
            rows = [r for r in candidates if r.hbm_bytes <= budget]
        if token_slo_ms is not None:
            fitting = [r for r in rows if r.latency_ms <= token_slo_ms]
            if not fitting and rows:
                # Nothing meets the SLO: serve with the fastest config
                # rather than refusing (the SLO viewer will show red).
                fitting = [min(rows, key=lambda r: r.latency_ms)]
            rows = fitting
        if not rows:
            raise ValueError(
                f"{self.model_name}: no measured decode config at "
                f"capacity {max_len} fits the HBM budget "
                f"({budget / 1e9:.1f} GB) — re-run the decode profiler"
            )
        best = max(rows, key=lambda r: r.batch_size / r.latency_ms)
        step_ms = best.latency_ms
        plan: Dict[str, int] = {"num_slots": int(best.batch_size)}
        horizon = self.decode_horizon
        if token_slo_ms is not None:
            horizon = max(1, int(token_slo_ms // step_ms))
            plan["decode_horizon"] = horizon
        if ttft_slo_ms is not None:
            prefill_ms = 0.0
            if prefill_profile is not None and prefill_profile.rows:
                largest = max(r.seq_len for r in prefill_profile.rows)
                singles = [
                    r for r in prefill_profile.rows
                    if r.seq_len == largest and r.batch_size == 1
                ] or [r for r in prefill_profile.rows
                      if r.seq_len == largest]
                prefill_ms = singles[0].latency_ms
            scan_budget = 0.8 * ttft_slo_ms - prefill_ms
            plan["ttft_horizon"] = int(
                min(max(1, scan_budget // step_ms), horizon)
            )
        logger.info(
            "%s: table plan at cap %d -> %s (step %.2f ms, %d candidate "
            "rows)", self.model_name, max_len, plan, step_ms, len(rows),
        )
        return plan

    def _table_plan(
        self, max_len: int, num_slots: Optional[int] = None,
    ) -> Optional[Dict[str, int]]:
        """Load committed tables from ``profiles_dir`` once per
        (capacity, pinned-slots) config; None when the decode table is
        absent (callers fall back to the analytic path)."""
        if self.profiles_dir is None:
            return None
        cache_key = (max_len, num_slots)
        if cache_key in self._table_plans:
            return self._table_plans[cache_key]
        decode_csv = os.path.join(
            self.profiles_dir, f"{self.model_name}_decode_summary.csv"
        )
        if not os.path.exists(decode_csv):
            logger.warning(
                "%s: profiles_dir=%s has no decode table — falling back "
                "to the analytic memory model", self.model_name,
                self.profiles_dir,
            )
            return None
        decode_profile = BatchProfile.from_csv(
            f"{self.model_name}_decode", decode_csv
        )
        prefill_csv = os.path.join(
            self.profiles_dir, f"{self.model_name}_prefill_summary.csv"
        )
        prefill_profile = None
        if os.path.exists(prefill_csv):
            prefill_profile = BatchProfile.from_csv(
                f"{self.model_name}_prefill", prefill_csv
            )
        try:
            plan = self.plan_from_tables(
                decode_profile, prefill_profile, max_len=max_len,
                num_slots=num_slots,
            )
        except ValueError as e:
            # A table that exists but has no row at this capacity (swept at
            # different max_lens) must degrade exactly like a missing
            # table — raising here would crash-loop every replica start
            # until the controller marks the deployment unhealthy.
            logger.warning(
                "%s: committed tables unusable at capacity %d (%s) — "
                "falling back to the analytic memory model",
                self.model_name, max_len, e,
            )
            plan = None
        self._table_plans[cache_key] = plan
        return plan

    def build_engine(self, queue: RequestQueue,
                     max_len: Optional[int] = None,
                     device: Optional[torch.device] = None,
                     num_slots: Optional[int] = None,
                     mesh: Any = None) -> DecodeEngine:
        """One engine at capacity ``max_len``. ``num_slots`` overrides the
        deployment's (the colocation control loop passes the planner's
        placement shape): a positive count is pinned and its horizons come
        from its own measured row when the tables have one; ``<= 0`` takes
        the table plan's slot count, or else :meth:`auto_num_slots`.
        ``mesh`` (a TP replica's): the engine serves the model's shard on
        it; measured tables are per-card measurements and are not read
        (reference ``llm.py:826-848``), and ``<= 0`` slots are sized for
        the mesh's devices."""
        tp = mesh is not None and mesh.shape.get("tp", 1) > 1
        model = self._sharded_model(mesh) if tp \
            else self._ensure_model(device)
        max_len = max_len or self.max_len
        num_slots = num_slots if num_slots is not None else self.num_slots
        decode_horizon = self.decode_horizon
        ttft_horizon = self.ttft_horizon
        # ANY pinned slot count pins the plan to ITS measured row, so the
        # horizons below always describe the config that actually runs.
        plan = None if tp else self._table_plan(
            max_len, num_slots=num_slots if num_slots > 0 else None)
        if plan is not None:
            if num_slots <= 0:
                num_slots = plan["num_slots"]
            decode_horizon = plan.get("decode_horizon", decode_horizon)
            ttft_horizon = plan.get("ttft_horizon", ttft_horizon)
        elif num_slots <= 0:
            whole = None
            if tp:
                from ray_dynamic_batching_tpu_torch.parallel.mesh import (
                    _recipe,
                    _twin,
                )

                whole = _twin(_recipe(model), torch.device("meta"))
            num_slots = self.auto_num_slots(
                mesh.size if tp else 1, max_len=max_len,
                budget_fraction=1.0 / len(self.length_buckets), model=whole,
            )
        prompt_buckets = self.prompt_buckets
        if prompt_buckets is not None:
            prompt_buckets = [b for b in prompt_buckets if b <= max_len] \
                or [max_len]
        return DecodeEngine(
            model,
            queue,
            num_slots=num_slots,
            max_len=max_len,
            prompt_buckets=prompt_buckets,
            eos_token_id=self.eos_token_id,
            default_max_new_tokens=self.default_max_new_tokens,
            decode_horizon=decode_horizon,
            ttft_horizon=ttft_horizon,
            max_admissions_per_step=self.max_admissions_per_step,
            base_seed=self.base_seed,
            device=model.device,
            paged=self.paged,
            page_size=self.page_size,
            kv_pool_pages=self.kv_pool_pages,
            chunked_prefill=self.chunked_prefill,
            prefill_token_budget=self.prefill_token_budget,
            prefix_cache_size=self.prefix_cache_size,
            session_cache_size=self.session_cache_size,
            host_spill_pages=self.host_spill_pages,
            draft_model=self._draft_model,
            spec_tokens=self.spec_tokens,
            quantize_weights=self.quantize_weights,
            mesh=mesh if tp else None,
        )

    # Controller protocol: factories exposing make_replica own replica
    # construction. ``devices`` arrives from the replica's placement-group
    # bundle when the deployment reserves chips.
    def make_replica(
        self, replica_id: str, config: Any, devices: Optional[Sequence] = None,
    ) -> LLMReplica:
        device = None
        mesh = None
        if devices and len(devices) > 1 and self.quantize_weights:
            # Fail BEFORE the mesh/engine build (and before the placement
            # group's chips are consumed by a doomed start).
            raise ValueError(
                f"{config.name}: quantize_weights is not supported for "
                "multi-chip (TP) replicas yet — drop chips_per_replica or "
                "the quantization flag")
        if devices and len(devices) > 1:
            # Multi-device bundle -> a TP replica over its own mesh slice
            # (its ranks start here and end with the replica).
            from ray_dynamic_batching_tpu_torch.parallel.mesh import (
                MeshConfig,
                build_mesh,
            )

            mesh = build_mesh(MeshConfig(tp=len(devices)),
                              [_torch_device(d) for d in devices],
                              backend=self.mesh_backend)
        elif devices:
            device = _torch_device(devices[0])
        try:
            replica = LLMReplica(
                replica_id=replica_id,
                deployment=config.name,
                engine_builders={
                    bucket: (lambda q, b=bucket: self.build_engine(
                        q, max_len=b, device=device, mesh=mesh))
                    for bucket in self.length_buckets
                },
                max_ongoing_requests=config.max_ongoing_requests,
                warmup=self.warmup,
                default_max_new_tokens=self.default_max_new_tokens,
                mesh=mesh,
            )
        except BaseException:
            if mesh is not None:
                mesh.shutdown()
            raise
        replica.devices = list(devices) if devices else None
        if self.session_cache_size > 0:
            # Session-affinity ids ride the replica's advertised multiplex
            # LRU: it must outlast the cached turns, or sessions would age
            # each other out of the routing view.
            replica.max_multiplexed_models = max(
                replica.max_multiplexed_models,
                len(self.length_buckets) * self.session_cache_size + 8)
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
