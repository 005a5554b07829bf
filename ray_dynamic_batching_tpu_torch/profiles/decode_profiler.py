"""Decode-phase profiler: measured tables for the LLM serving control loop.

Port of ``ray_dynamic_batching_tpu/profiles/decode_profiler.py`` onto the
port's :class:`~ray_dynamic_batching_tpu_torch.engine.decode.DecodeEngine`.
The reference's core control theory is profiled-latency-driven planning
(``293-project/profiling/*_summary.csv`` consumed at
``293-project/src/scheduler.py:1019-1041``; packing logic
``293-project/src/nexus.py:129-296``); this module sweeps the
continuous-batching decode engine along its two cost axes:

- **Decode step**: per-substep latency + device footprint vs
  ``num_slots`` (batch occupancy) x ``max_len`` (KV capacity): the
  engine's own decode program (``_decode_fn``, the graph serving
  replays) with every slot active and horizon 1.
- **Prefill**: admission-group latency vs (prompt bucket x group width),
  the engine's own group program (``_prefill_fn``) — the TTFT-side cost.

Rows reuse :class:`~ray_dynamic_batching_tpu_torch.profiles.table.ProfileRow`
(decode: ``batch_size`` = num_slots, ``seq_len`` = KV capacity; prefill:
``batch_size`` = group width, ``seq_len`` = prompt bucket) and land as
``<model>_decode_summary.csv`` / ``<model>_prefill_summary.csv`` through
:func:`~ray_dynamic_batching_tpu_torch.profiles.profiler.write_profile_outputs`,
the tables :meth:`LLMDeployment.plan_from_tables` and
:func:`~ray_dynamic_batching_tpu_torch.scheduler.nexus.pack_llm_engines` read.

Where the port differs from the reference's compiled programs:

- **Timing** is the reference's: chained dispatches, one host fetch per
  timing block of ``timing_iters`` (three blocks), so per-dispatch host
  cost is in the row, as it is in serving. On a card the first dispatch
  captures the program as a CUDA graph (``ops/graphs.py``) and every
  timed one replays it, as serving does. A profiled engine is never
  warmed; its captures run inside the capture ledger's warmup phase, as
  the reference's profiling compiles are startup work.
- **The cache is nearly full while timed.** The port's decode kernel
  skips the KV tiles no row attends, so its cost follows the fill, where
  the reference's static-shape scan reads the whole capacity whatever
  the fill. The cache lengths start where the timed steps end one
  position short of ``max_len``: a row prices the full-occupancy step the
  planner assumes.
- **``hbm_bytes``** is not read from a compiled program's memory
  analysis: it is the model's weight bytes + the engine's cache tensors
  (scale planes included) and penalty counts + the dispatch's inputs,
  plus, on a card, the first dispatch's transient peak
  (``torch.cuda.reset_peak_memory_stats`` before it,
  ``max_memory_allocated`` less ``memory_allocated`` after). On the CPU
  the transient is not measured and is left out.
- **``compile_ms``** is the wall time of the first (warmup) dispatch,
  host fetch included: on a card that dispatch runs the program eagerly
  and captures it, and pays the kernel build, if it is the process's
  first.
- An out-of-memory at any point of a config, the engine's cache
  allocation included, marks it infeasible; every other error is raised.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.models.quant import tree_weight_bytes
from ray_dynamic_batching_tpu_torch.profiles.profiler import _is_oom
from ray_dynamic_batching_tpu_torch.profiles.table import (
    BatchProfile,
    ProfileRow,
)
from ray_dynamic_batching_tpu_torch.utils.compile_ledger import get_ledger
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("torch.decode_profiler")


def _tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _engine_bytes(engine: DecodeEngine) -> int:
    """The engine's resident device state: every cache tensor (codes,
    scale planes, lengths) and the per-slot penalty counts."""
    c = engine._cache
    return _tensor_bytes(*vars(c).values(), engine._counts)


class DecodeProfiler:
    """Sweeps a model's decode engine across (num_slots, capacity) and
    (prompt bucket, group) configs on the model's device."""

    def __init__(
        self,
        model: Any,
        timing_iters: int = 8,
        warmup_iters: int = 2,
        max_consecutive_errors: int = 2,
    ):
        from ray_dynamic_batching_tpu_torch.utils.compile_cache import (
            maybe_enable,
        )

        maybe_enable()  # sweep re-runs reuse the built kernel libraries
        self.model = model
        self.device = model.device
        self.timing_iters = max(2, timing_iters)
        self.warmup_iters = max(1, warmup_iters)
        self.max_consecutive_errors = max_consecutive_errors

    @property
    def dispatches_per_config(self) -> int:
        """Dispatches one config runs: the warmup, then three timing
        blocks (each one prefill group or one horizon-1 decode step)."""
        return self.warmup_iters + 3 * self.timing_iters

    def _engine(self, num_slots: int, max_len: int,
                prompt_bucket: int, group: int) -> DecodeEngine:
        queue = RequestQueue(self.model.name, max_len=max(64, num_slots))
        return DecodeEngine(
            self.model, queue,
            num_slots=num_slots, max_len=max_len,
            prompt_buckets=[prompt_bucket], decode_horizon=1,
            max_admissions_per_step=group, device=self.device,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _measure(self, dispatch: Callable[[], torch.Tensor],
                 resident: int) -> Tuple[float, int, list]:
        """(first-dispatch ms, footprint bytes, per-dispatch ms samples)
        of ``dispatch``, which returns a device tensor; each timing block
        ends with one host fetch of it."""
        cuda = self.device.type == "cuda"
        if cuda:
            self._sync()
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        out = dispatch()
        out.reshape(-1)[0].item()
        compile_ms = (time.perf_counter() - t0) * 1000.0
        transient = 0
        if cuda:
            transient = max(0, torch.cuda.max_memory_allocated(self.device)
                            - torch.cuda.memory_allocated(self.device))
        for _ in range(self.warmup_iters - 1):
            out = dispatch()
        out.reshape(-1)[0].item()
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(self.timing_iters):
                out = dispatch()
            out.reshape(-1)[0].item()   # host fetch = completion
            samples.append(
                (time.perf_counter() - t0) * 1000.0 / self.timing_iters
            )
        return compile_ms, resident + transient, samples

    def _row(self, what: str, build: Callable[[], DecodeEngine],
             run: Callable[[DecodeEngine], Tuple[float, int, list]],
             batch_size: int, seq_len: int) -> Optional[ProfileRow]:
        """Build one config's engine, measure it, release it; None when
        the config runs out of device memory."""
        engine = None
        ledger = get_ledger()
        ledger.begin_warmup()
        try:
            engine = build()
            compile_ms, hbm_bytes, samples = run(engine)
        except Exception as e:  # noqa: BLE001 — only OOM is tolerated
            if _is_oom(e):
                logger.warning("%s %s %d x %d infeasible (OOM)",
                               self.model.name, what, batch_size, seq_len)
                return None
            raise
        finally:
            ledger.end_warmup()
            if engine is not None and engine._cache is not None:
                engine.release_buffers()
        return ProfileRow(
            batch_size=batch_size,
            seq_len=seq_len,
            latency_ms=float(np.mean(samples)),
            latency_std_ms=float(np.std(samples)),
            hbm_bytes=hbm_bytes,
            compile_ms=compile_ms,
        )

    # --- decode step -------------------------------------------------------
    def profile_decode_config(
        self, num_slots: int, max_len: int
    ) -> Optional[ProfileRow]:
        """One (slots, capacity) config: the engine's own decode program,
        every slot active, horizon 1, greedy. None if infeasible (OOM)."""

        def run(engine: DecodeEngine):
            B, dev = num_slots, self.device
            samp_f, samp_i, bias_ids, bias_vals = engine._sampling_arrays()
            # Rows: pending tokens / active mask / sample index — the
            # engine's single per-dispatch upload, all slots active.
            step_state = torch.stack([
                torch.ones((B,), dtype=torch.int32),
                torch.ones((B,), dtype=torch.int32),
                torch.zeros((B,), dtype=torch.int32),
            ]).to(dev)
            with torch.inference_mode():
                engine._cache.lengths.fill_(
                    max(0, max_len - 1 - self.dispatches_per_config))
            resident = (tree_weight_bytes(self.model) + _engine_bytes(engine)
                        + _tensor_bytes(step_state, samp_f, samp_i,
                                        bias_ids, bias_vals))
            return self._measure(
                lambda: engine._decode_fn(step_state, 1, samp_f, samp_i,
                                          bias_ids, bias_vals, False, False),
                resident)

        return self._row("decode",
                         lambda: self._engine(num_slots, max_len, 8, 1),
                         run, num_slots, max_len)

    # --- prefill -----------------------------------------------------------
    def profile_prefill_config(
        self, prompt_bucket: int, group: int, max_len: int
    ) -> Optional[ProfileRow]:
        """One (prompt bucket, group width) admission program."""
        num_slots = max(2, group)

        def run(engine: DecodeEngine):
            dev, K = self.device, engine.max_bias_entries
            tokmask = torch.ones((2, group, prompt_bucket),
                                 dtype=torch.int32).to(dev)
            meta_i = torch.zeros((3, group), dtype=torch.int32)
            meta_i[0] = torch.arange(group) % num_slots
            meta_i = meta_i.to(dev)
            meta_f = torch.zeros((2, group))
            meta_f[1] = 1.0
            meta_f = meta_f.to(dev)
            bias_ids = torch.zeros((group, K), dtype=torch.int32,
                                   device=dev)
            bias_vals = torch.zeros((group, K), device=dev)
            resident = (tree_weight_bytes(self.model) + _engine_bytes(engine)
                        + _tensor_bytes(tokmask, meta_i, meta_f, bias_ids,
                                        bias_vals))
            return self._measure(
                lambda: engine._prefill_fn(tokmask, meta_i, meta_f,
                                           bias_ids, bias_vals, False),
                resident)

        return self._row(
            "prefill",
            lambda: self._engine(num_slots, max_len, prompt_bucket, group),
            run, group, prompt_bucket)

    # --- sweeps ------------------------------------------------------------
    def sweep(
        self,
        slot_buckets: Sequence[int] = (4, 8, 16, 32, 64, 128),
        capacities: Sequence[int] = (256,),
        prompt_buckets: Sequence[int] = (16, 64),
        group_sizes: Sequence[int] = (1, 2, 4),
    ) -> Tuple[BatchProfile, BatchProfile]:
        """Returns (decode profile, prefill profile). Slot sweeps stop at
        the memory edge (profiler-stopped, not config-stopped) after
        ``max_consecutive_errors`` infeasible configs."""
        decode = BatchProfile(f"{self.model.name}_decode")
        for cap in capacities:
            errors = 0
            for slots in slot_buckets:
                row = self.profile_decode_config(slots, cap)
                if row is None:
                    errors += 1
                    if errors >= self.max_consecutive_errors:
                        break
                    continue
                errors = 0
                decode.add(row)
                logger.info(
                    "%s decode slots=%d cap=%d: %.2f ms/substep "
                    "(%.0f tok/s full), %.0f MB",
                    self.model.name, slots, cap, row.latency_ms,
                    slots * 1000.0 / row.latency_ms, row.hbm_bytes / 1e6,
                )
        prefill = BatchProfile(f"{self.model.name}_prefill")
        cap = max(capacities)
        for bucket in prompt_buckets:
            if bucket >= cap:
                continue
            for group in group_sizes:
                row = self.profile_prefill_config(bucket, group, cap)
                if row is None:
                    continue
                prefill.add(row)
                logger.info(
                    "%s prefill bucket=%d group=%d: %.2f ms",
                    self.model.name, bucket, group, row.latency_ms,
                )
        return decode, prefill
