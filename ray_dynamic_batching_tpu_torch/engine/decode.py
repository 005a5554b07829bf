"""Continuous-batching decode engine — slot-based KV-cache serving, in torch.

Port of ``ray_dynamic_batching_tpu/engine/decode.py::DecodeEngine``, three
of its arms:

- **slab + monolithic prefill** (the constructor defaults): a group of
  same-bucket prompts runs on a fresh row cache, the rows are copied into
  the shared slab cache at their slots, and the first token is sampled on
  the device (:meth:`_prefill_impl`); a prompt longer than the largest
  bucket takes the long fill (:meth:`_prefill_long`): chunks of the
  largest bucket into a private single-row cache, one decode step for
  the active batch between chunks, then one commit of the row into the
  shared cache;
- **paged + token-budget chunked prefill** (``paged=True``; chunking is
  its default): every admission becomes a chunk train holding a slot;
  between decode turns :meth:`_pump_prefill` spends at most
  ``prefill_token_budget`` prompt tokens, same-width single-chunk trains
  grouped into one pages-direct chunk program
  (:meth:`_chunk_group_paged_impl`) whose k/v go straight into the pages
  granted for that chunk; prompts longer than the largest bucket run as
  multi-chunk trains;
- **paged + monolithic prefill** (``paged=True, chunked_prefill=False``):
  the slab arm's prefill and long fill, its rows cut into pages at
  admission;
- **slab + token-budget chunked prefill** (``chunked_prefill=True`` on a
  slab engine): every admission becomes a chunk train on a private row
  cache, advanced one chunk of the largest bucket at a time by the same
  budget pump (:meth:`_advance_train_slab`, the long fill's chunk and
  commit), so a long prompt stalls decode by at most one chunk.

Every arm serves a model with an int8 KV cache (``kv_dtype=torch.int8``):
the row copies carry the scale planes beside the codes.

Decode is shared: ``horizon`` chained steps for all slots per host sync,
with presence/frequency penalties, sparse logit bias and the per-request
sampler on the device; everything the host needs comes back as ONE packed
``[2h+1, B]`` int32 tensor fetched once per dispatch
(:meth:`_decode_impl`). Page grants, eviction and the page table live on
the host (``engine/paging.py``); the device table has one writer,
:meth:`_refresh_table`.

PyTorch runs eagerly, so there is nothing to compile: the reference's
jit programs are plain methods, its donated buffers are tensors updated in
place, and its group padding to compiled widths is gone (a group is
exactly its rows, so no index is written twice). Speculative decoding,
the prefix/session caches, the page fabric, weight quantisation and the
mesh are later slices.

Sampling: ``jax.random`` keys cannot be reproduced in torch, so sampled
rows draw gumbel noise from a counter-based hash of (base_seed, request
seed, token index, vocab index) — a request's sampled stream depends on
neither its slot nor its batch neighbours. Greedy rows are an argmax over
f32 logits, the reference's rule exactly.

Flight recorder: the reference's metric families for the code paths
ported here (tokens, steps, prefills, TTFT and its queue/prefill shares,
active slots, the paged pool's gauges and evictions, the chunk
scheduler's counters) in the port's default registry, and its three
spans — the retroactive ``decode.prefill`` (admit -> first token) and
``decode.turn`` (dispatch -> the one host fetch), and ``decode.sequence``
at completion — each emitted only while the tracer is enabled, from
timestamps the engine already takes (no device sync of its own). The
speculation, prefix and session families come with those features.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.engine.paging import (
    OutOfPages,
    PageAllocator,
    PageEventJournal,
    pages_for,
    table_array,
)
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import (
    BadRequest,
    Request,
    RequestDropped,
    now_ms,
)
from ray_dynamic_batching_tpu_torch.models.base import resolve_device
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.tracing import link_to as _link_to
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer as _tracer

logger = get_logger("torch.decode")

TOKENS_TOTAL = m.Counter(
    "rdb_decode_tokens_total", "Generated tokens", tag_keys=("model",)
)
DECODE_STEPS = m.Counter(
    "rdb_decode_steps_total", "Decode steps executed", tag_keys=("model",)
)
PREFILLS_TOTAL = m.Counter(
    "rdb_decode_prefills_total", "Prompts prefilled", tag_keys=("model",)
)
TTFT_MS = m.Histogram(
    "rdb_decode_ttft_ms", "Time to first token", tag_keys=("model",)
)
TTFT_QUEUE_MS = m.Histogram(
    "rdb_decode_ttft_queue_ms",
    "Arrival->dequeue share of TTFT (includes waiting out in-flight scans)",
    tag_keys=("model",),
)
TTFT_PREFILL_MS = m.Histogram(
    "rdb_decode_ttft_prefill_ms",
    "Dequeue->first-token share of TTFT",
    tag_keys=("model",),
)
ACTIVE_SLOTS = m.Gauge(
    "rdb_decode_active_slots", "Slots currently decoding", tag_keys=("model",)
)
KV_PAGES_FREE = m.Gauge(
    "rdb_decode_kv_pages_free", "Free pages in the paged KV pool",
    tag_keys=("model",),
)
KV_PAGE_OCCUPANCY = m.Gauge(
    "rdb_decode_kv_page_occupancy",
    "Allocated fraction of the paged KV pool", tag_keys=("model",),
)
PAGE_EVICTIONS = m.Counter(
    "rdb_decode_page_evictions_total",
    "Slots capacity-finished to reclaim pages (over-subscribed pool)",
    tag_keys=("model",),
)
# Token-budget prefill scheduler: chunk programs dispatched (one per
# train row), trains parked on page starvation, the pending-train depth.
PREFILL_CHUNKS = m.Counter(
    "rdb_decode_prefill_chunks_total",
    "Chunk programs dispatched by the token-budget prefill scheduler",
    tag_keys=("model",),
)
PREFILL_STARVED = m.Counter(
    "rdb_decode_prefill_starved_total",
    "Chunk dispatches deferred by page starvation (train parked)",
    tag_keys=("model",),
)
PREFILL_PENDING = m.Gauge(
    "rdb_decode_prefill_pending_trains",
    "Chunk trains awaiting prefill budget", tag_keys=("model",),
)

_M32 = 0xFFFFFFFF


@dataclass
class DecodeResult:
    """Fulfilled into the request future when a sequence finishes."""

    tokens: List[int]
    finish_reason: str            # "eos" | "length" | "capacity"
    ttft_ms: float
    total_ms: float


@dataclass
class _Slot:
    request: Optional[Request] = None
    generated: List[int] = field(default_factory=list)
    max_new_tokens: int = 0
    prefill_done_ms: float = 0.0
    stop: frozenset = frozenset()  # per-request stop token ids
    # Paged mode: the slot's physical page ids in logical order.
    pages: List[int] = field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.request is None


@dataclass
class _ChunkTrain:
    """One admission mid-chunked-prefill: the unit the token-budget
    scheduler advances between decode turns. The train HOLDS its slot
    (``_free_slots`` excludes it) and — paged — the pages granted so far
    (``opts["_pages"]``); ``pos`` is the next position to prefill."""

    req: Request
    prompt: np.ndarray
    opts: Dict
    slot_idx: int
    C: int                 # chunk width
    total: int             # prompt length (prefill ends here)
    pos: int = 0
    row: Any = None        # slab: the train's private row cache
    last: Any = None       # slab: the last chunk's take-row logits


def bucket_up(value: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= value; None if value exceeds every bucket."""
    for b in sorted(buckets):
        if b >= value:
            return b
    return None


def _planes(rows, cache):
    """(source, destination) pairs of every per-position plane: k and v,
    and on an int8 cache their scale planes — a copy that dropped the
    scales would reconstruct garbage KV for every admitted prompt."""
    pairs = [(rows.k, cache.k), (rows.v, cache.v)]
    if cache.quantized:
        pairs += [(rows.k_scale, cache.k_scale), (rows.v_scale, cache.v_scale)]
    return pairs


def copy_rows_into(cache, rows, slots: torch.Tensor) -> None:
    """In place: the row cache's per-request rows into the shared cache at
    ``slots`` (the reference's donated dynamic_update_slice)."""
    for src, dst in _planes(rows, cache):
        dst.index_copy_(1, slots, src)
    cache.lengths.index_copy_(0, slots, rows.lengths)


def commit_row(cache, row, slot: int) -> None:
    """In place: a single finished row cache into the shared slab cache at
    ``slot``, cut down to shared capacity (the long fill's row is whole
    chunks and may be longer; past ``lengths`` it holds nothing anyone
    attends)."""
    S = cache.capacity
    for src, dst in _planes(row, cache):
        dst[:, slot] = src[:, 0, :S]
    cache.lengths[slot] = row.lengths[0]


def copy_rows_into_paged(cache, rows, slots: torch.Tensor,
                         write_pids: torch.Tensor) -> None:
    """In place: each row of the row cache, cut into page-size pieces,
    lands at the physical pages ``write_pids`` [nB, NP] names (sentinel
    entries land in the pool's sink page, which nothing reads); the
    per-slot lengths land at ``slots``."""
    L, nB = rows.k.shape[0], rows.k.shape[1]
    ps = cache.page_size
    S = write_pids.shape[1] * ps
    flat = write_pids.reshape(-1).long()
    for src, dst in _planes(rows, cache):
        pages = src[:, :, :S].reshape((L, nB * (S // ps), ps)
                                      + tuple(src.shape[3:]))
        dst.index_copy_(1, flat, pages)
    cache.lengths.index_copy_(0, slots, rows.lengths)


def run_chunk(chunk_fn, prompt: np.ndarray, pos: int, C: int, row, device):
    """One chunk of ``prompt`` from ``pos``: up to ``C`` tokens, the tail
    right-padded, through ``chunk_fn``. Returns (take-row logits, row,
    tokens taken)."""
    piece = prompt[pos: pos + C]
    tokmask = np.zeros((2, 1, C), dtype=np.int32)
    tokmask[0, 0, : piece.size] = piece
    tokmask[1, 0, : piece.size] = 1
    tokmask = torch.from_numpy(tokmask).to(device)
    last, row = chunk_fn(tokmask[0], tokmask[1], row, pos,
                         int(piece.size) - 1)
    return last, row, int(piece.size)


def run_chunked(chunk_fn, prompt: np.ndarray, C: int, row, device,
                between=None):
    """Host loop driving ``chunk_fn`` over a prompt: full-width chunks, a
    right-padded tail, and ``between`` after every non-final chunk (the
    decode-interleave hook). Returns (last logits, row)."""
    L = int(prompt.size)
    n_chunks = (L + C - 1) // C
    last = None
    for ci in range(n_chunks):
        last, row, _ = run_chunk(chunk_fn, prompt, ci * C, C, row, device)
        if ci < n_chunks - 1 and between is not None:
            between()
    return last, row


def _mix32(x):
    """A bijective 32-bit integer mix (xorshift-multiply) on values in
    [0, 2^32): int64 tensors or Python ints. Multipliers stay below 2^31
    so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def gumbel_noise(base_seed: int, seeds: torch.Tensor, tok_idx: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, V], a pure function of (base_seed, seeds[b],
    tok_idx[b], vocab index): the counter-based stand-in for the
    reference's ``fold_in(fold_in(PRNGKey(base_seed), seed), idx)``."""
    dev = seeds.device
    base = _mix32(int(base_seed) & _M32)  # host int: no device upload
    row = _mix32((seeds.to(torch.int64) + base) & _M32)
    row = _mix32((row + tok_idx.to(torch.int64)) & _M32)
    iota = torch.arange(vocab, dtype=torch.int64, device=dev)
    bits = _mix32(row[:, None] ^ iota[None, :]) >> 8      # 24 random bits
    u = (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


class DecodeEngine:
    """Continuous-batching executor for one CausalLM on one device.

    ``model`` provides ``make_cache``, ``prefill``, ``decode_step`` (and,
    paged, ``make_paged_cache``, ``prefill_chunk_paged``,
    ``decode_step_paged``) and ``cfg``
    (:class:`~ray_dynamic_batching_tpu_torch.models.causal_lm.CausalLM`)
    and owns its weights; ``device`` must be the model's device and
    defaults to ``"cuda"``.
    """

    def __init__(
        self,
        model: Any,
        queue: RequestQueue,
        num_slots: int = 8,
        max_len: int = 256,
        prompt_buckets: Optional[Sequence[int]] = None,
        eos_token_id: Optional[int] = None,
        default_max_new_tokens: int = 64,
        idle_wait_s: float = 0.005,
        decode_horizon: int = 8,
        ttft_horizon: Optional[int] = None,
        max_admissions_per_step: int = 2,
        base_seed: int = 0,
        device: Union[str, torch.device, None] = "cuda",
        paged: bool = False,
        page_size: int = 128,
        kv_pool_pages: Optional[int] = None,
        chunked_prefill: Optional[bool] = None,
        prefill_token_budget: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine asked for "
                f"{self.device}"
            )
        self.model = model
        self.queue = queue
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_buckets = sorted(prompt_buckets or [16, 32, 64, 128])
        self.prompt_buckets = [b for b in self.prompt_buckets if b <= max_len]
        self.eos_token_id = eos_token_id
        self.default_max_new_tokens = default_max_new_tokens
        self.idle_wait_s = idle_wait_s
        self.base_seed = int(base_seed)

        self._slots = [_Slot() for _ in range(num_slots)]
        # Host mirror of per-slot cache lengths (page headroom,
        # kv_occupancy).
        self._len_host = np.zeros((num_slots,), dtype=np.int32)
        # Paged pool: one pool of pages shared by every slot through a
        # per-slot page table, so occupancy follows cached tokens.
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self._page_journal: Optional[PageEventJournal] = None
        if self.paged:
            if self.page_size <= 0 or self.page_size % 128:
                raise ValueError(
                    f"page_size {self.page_size} must be a multiple of 128 "
                    "(the engine's page rule, shared with the JAX package)"
                )
            # Logical capacity: whole pages covering max_len; max_len
            # stays the generation bound (token-exactness vs the slab).
            self._n_table_entries = pages_for(max_len, self.page_size)
            self._paged_capacity = self._n_table_entries * self.page_size
            full_backing = num_slots * self._n_table_entries
            self.num_pages = int(kv_pool_pages or full_backing)
            # Over-subscription is allowed, but the pool must back one
            # slot or nothing could ever decode.
            if self.num_pages < self._n_table_entries:
                raise ValueError(
                    f"kv_pool_pages {self.num_pages} cannot back even one "
                    f"slot ({self._n_table_entries} pages at page_size "
                    f"{self.page_size}, max_len {max_len})"
                )
            self._page_journal = PageEventJournal()
            self._allocator = PageAllocator(self.num_pages,
                                            journal=self._page_journal)
            self._table_host = np.full(
                (num_slots, self._n_table_entries), self.num_pages,
                dtype=np.int32,
            )
            self._table_dirty = True
        if chunked_prefill is None:
            chunked_prefill = self.paged
        self.chunked_prefill = bool(chunked_prefill)
        with torch.inference_mode():
            if self.paged:
                self._cache = model.make_paged_cache(
                    num_slots, self.num_pages, self.page_size,
                    self._paged_capacity)
            else:
                self._cache = model.make_cache(num_slots, max_len)
            V = model.cfg.vocab_size
            # Per-slot generated-token counts for the penalties, on device.
            self._counts = torch.zeros((num_slots, V), dtype=torch.int32,
                                       device=self.device)
        self._tokens = np.zeros((num_slots, 1), dtype=np.int32)
        self._active_mask = np.zeros((num_slots,), dtype=bool)
        self._temps = np.zeros((num_slots,), dtype=np.float32)
        self._topk = np.zeros((num_slots,), dtype=np.int32)
        self._topp = np.ones((num_slots,), dtype=np.float32)
        self._seeds = np.zeros((num_slots,), dtype=np.int32)
        self._pres = np.zeros((num_slots,), dtype=np.float32)
        self._freq = np.zeros((num_slots,), dtype=np.float32)
        self.max_bias_entries = 16
        self._bias_ids = np.zeros((num_slots, self.max_bias_entries),
                                  dtype=np.int32)
        self._bias_vals = np.zeros((num_slots, self.max_bias_entries),
                                   dtype=np.float32)

        self.decode_horizon = max(1, int(decode_horizon))
        if ttft_horizon is None:
            ttft_horizon = max(1, self.decode_horizon // 4)
        self.ttft_horizon = min(max(1, int(ttft_horizon)),
                                self.decode_horizon)
        self.max_admissions_per_step = max(1, int(max_admissions_per_step))
        # Token-budget chunked admission: the most prefill tokens one
        # scheduler round spends between decode turns, at least one chunk
        # of the largest bucket so a full-width chunk can always go.
        chunk_w = self.prompt_buckets[-1] if self.prompt_buckets else max_len
        self.prefill_token_budget = max(
            int(prefill_token_budget or chunk_w), chunk_w)
        self._trains: List[_ChunkTrain] = []   # FIFO (arrival order)
        self._train_slots: set = set()
        # TTFT decomposition (queue_wait, scan_wait, prefill) per admission.
        self._scan_start_ms = 0.0
        self._scan_end_ms = 0.0
        self._ttft_parts: collections.deque = collections.deque(maxlen=1024)
        # Device copies of the per-slot sampling arrays; rebuilt only when
        # an admission changes them.
        self._sampling_dev = None
        # Installed by a colocation executor (engine/colocate.py): called
        # between the chunk dispatches of long admissions so co-tenant
        # engines on the same device are not stalled.
        self.interleave_hook: Optional[Callable[[], None]] = None
        self._admitting = 0
        self._thread: Optional[threading.Thread] = None
        self._run = threading.Event()
        self.steps = 0
        self.prefill_groups = 0      # monolithic prefill dispatches
        self.chunk_dispatches = 0    # chunk-train dispatches
        self.long_chunk_dispatches = 0   # long-fill chunk dispatches
        self.completed = 0
        self.last_heartbeat = time.monotonic()

    def _device_ctx(self):
        """The engine's card as the current device (a null context on the
        CPU): the scope a colocation executor's turns run under."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # --- device programs ---------------------------------------------------
    @staticmethod
    def _apply_bias(logits, bias_ids, bias_vals):
        """Sparse per-row logit bias: logits[b, ids[b, j]] += vals[b, j];
        padding entries (0, 0.0) add nothing."""
        return logits.scatter_add(1, bias_ids.long(),
                                  bias_vals.to(logits.dtype))

    def _sample_tokens(self, logits, temps, topk, seeds, tok_idx,
                       bias_ids, bias_vals, topp, any_sampled: bool):
        """Per-request sampling on the device: temperature 0 -> greedy
        argmax; otherwise top-k then top-p masked, temperature-scaled
        categorical via gumbel-argmax keyed by (base_seed, request seed,
        token index). ``any_sampled`` is the host's knowledge that some
        row samples (the reference's runtime ``lax.cond`` — here decided
        on the host so no device value is read)."""
        logits = self._apply_bias(logits.float(), bias_ids, bias_vals)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not any_sampled:
            return greedy
        V = logits.shape[-1]
        k_eff = torch.where(topk > 0, torch.clamp(topk, max=V),
                            torch.full_like(topk, V)).long()
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        kth = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])
        # Scalars, not device tensors built from host values: nothing in
        # the horizon loop may upload or fetch.
        neg_inf = float("-inf")
        t = torch.clamp(temps, min=1e-6)[:, None]
        scaled = logits.masked_fill(logits < kth, neg_inf) / t
        # Top-p over the top-k-masked sorted view (no second sort).
        p_eff = torch.where((topp > 0.0) & (topp < 1.0), topp,
                            torch.ones_like(topp))[:, None]
        ranks = torch.arange(V, device=logits.device)[None, :]
        sorted_scaled = sorted_desc.masked_fill(ranks >= k_eff[:, None],
                                                neg_inf) / t
        probs = torch.softmax(sorted_scaled, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < p_eff
        kept_min = sorted_scaled.masked_fill(~keep_sorted, float("inf")
                                             ).amin(dim=-1, keepdim=True)
        scaled = scaled.masked_fill(scaled < kept_min, neg_inf)
        noise = gumbel_noise(self.base_seed, seeds, tok_idx, V)
        sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
        return torch.where(temps > 0.0, sampled, greedy)

    @torch.inference_mode()
    def _prefill_impl(self, tokmask, meta_i, meta_f, bias_ids, bias_vals,
                      any_sampled: bool,
                      write_pids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """``nB`` prompts -> cache rows at ``slots`` + first sampled tokens.
        Inputs arrive packed by dtype: ``tokmask`` [2, nB, T] (tokens,
        attention mask), ``meta_i`` [3, nB] (slots, top_k, seeds),
        ``meta_f`` [2, nB] (temperature, top_p). Paged engines pass
        ``write_pids`` [nB, NP]: the rows are cut into pages and land at
        those physical pages."""
        tokens, attn_mask = tokmask[0], tokmask[1]
        slots, topk, seeds = meta_i[0], meta_i[1], meta_i[2]
        temps, topp = meta_f[0], meta_f[1]
        nB = tokens.shape[0]
        # A fresh zeroed row cache: positions past the prompt are masked,
        # and zeros (not stale memory) is what they hold, as in the
        # reference.
        rows = self.model.make_cache(
            nB, self._paged_capacity if self.paged else self.max_len)
        last_logits, rows = self.model.prefill(tokens, attn_mask, rows)
        if self.paged:
            copy_rows_into_paged(self._cache, rows, slots.long(), write_pids)
        else:
            copy_rows_into(self._cache, rows, slots.long())
        return self._sample_tokens(
            last_logits, temps, topk, seeds, torch.zeros_like(slots),
            bias_ids, bias_vals, topp, any_sampled,
        )

    @torch.inference_mode()
    def _row_chunk_impl(self, tokens, attn_mask, row, start: int,
                        take_idx: int):
        """One chunk on a private row cache (the long fill's and the slab
        trains'); the caller counts it."""
        return self.model.prefill_chunk(tokens, attn_mask, row, start,
                                        take_idx)

    @torch.inference_mode()
    def _commit_long_impl(self, row, slot: int, meta_i, last_logits,
                          meta_f, bias_ids, bias_vals, any_sampled: bool,
                          write_pids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Close a long fill: the finished row into the shared cache at
        ``slot`` (slab: cut to capacity; paged: cut into the pages
        ``write_pids`` [1, NP] names), then the first token sampled.
        ``meta_i`` [3] packs slot / top_k / seed, ``meta_f`` [2]
        temperature / top_p (the token index of a first sample is 0)."""
        if self.paged:
            copy_rows_into_paged(self._cache, row, meta_i[0:1].long(),
                                 write_pids)
        else:
            commit_row(self._cache, row, slot)
        return self._sample_tokens(
            last_logits, meta_f[0:1], meta_i[1:2], meta_i[2:3],
            torch.zeros_like(meta_i[0:1]), bias_ids, bias_vals, meta_f[1:2],
            any_sampled,
        )

    @torch.inference_mode()
    def _chunk_group_paged_impl(self, tokmask, tables, meta_i, meta_f,
                                bias_ids, bias_vals, n_final: int,
                                any_sampled: bool) -> torch.Tensor:
        """One pages-direct chunk program for a group of chunk trains:
        row i is one train's next ``<= W``-token chunk, its k/v written
        straight through its own table row ``tables[i]`` into the pages
        granted for it, its read the staircase window from its own start.
        The first token is sampled for every row (only final rows' are
        used). ``meta_i`` [6, g] packs start / take_idx / top_k / seed and,
        in its first ``n_final`` columns, the final rows' slots and prompt
        lengths (host-built, so no index is steered anywhere); ``meta_f``
        [2, g] temperature / top_p."""
        tokens, attn_mask = tokmask[0], tokmask[1]
        starts, take_idx, topk, seeds = meta_i[0], meta_i[1], meta_i[2], \
            meta_i[3]
        temps, topp = meta_f[0], meta_f[1]
        taken, _ = self.model.prefill_chunk_paged(
            tokens, attn_mask, self._cache, tables, starts, take_idx)
        if n_final:
            self._cache.lengths.index_copy_(
                0, meta_i[4, :n_final].long(), meta_i[5, :n_final])
        return self._sample_tokens(
            taken, temps, topk, seeds, torch.zeros_like(starts), bias_ids,
            bias_vals, topp, any_sampled,
        )

    @torch.inference_mode()
    def _decode_impl(self, step_state, horizon: int, samp_f, samp_i,
                     bias_ids, bias_vals, any_sampled: bool,
                     any_penalty: bool) -> torch.Tensor:
        """``horizon`` chained decode steps; one packed int32 result
        [2h+1, B] (h token rows, h advanced rows, 1 lengths row) so the
        host fetches once per dispatch.

        ``step_state`` [3, B] packs pending tokens / active mask / next
        sample index; ``samp_f`` [4, B] temperature/top_p/presence/
        frequency; ``samp_i`` [2, B] top_k/seeds. Rows at capacity produce
        garbage logits; the in-bounds check folds into ``advanced`` so
        their token is never surfaced. ``any_penalty`` (host-known: some
        active row has a penalty) skips the penalty pass and the counts
        update, which are exact no-ops otherwise."""
        tokens = step_state[0][:, None]
        active = step_state[1].bool()
        tok_idx0 = step_state[2]
        temps = torch.where(active, samp_f[0], torch.zeros_like(samp_f[0]))
        topp, pres, freq = samp_f[1], samp_f[2], samp_f[3]
        topk, seeds = samp_i[0], samp_i[1]
        cache = self._cache
        rows = torch.arange(tokens.shape[0], device=self.device)
        # Paged pools round capacity up to whole pages; max_len stays the
        # generation bound, so paged and slab engines stop at the same
        # length (for slab caches the two coincide).
        limit = self.max_len if self.paged else cache.capacity
        step_fn = (self.model.decode_step_paged if self.paged
                   else self.model.decode_step)
        toks, advs = [], []
        for j in range(horizon):
            advanced = active & (cache.lengths < limit)
            logits, cache = step_fn(tokens, cache, advanced)
            logits = logits.float()
            if any_penalty:
                counts = self._counts
                logits = logits - (pres[:, None] * (counts > 0)
                                   + freq[:, None] * counts.float())
            nxt = self._sample_tokens(logits, temps, topk, seeds,
                                      tok_idx0 + j, bias_ids, bias_vals,
                                      topp, any_sampled)
            nxt = torch.where(advanced, nxt, tokens[:, 0])
            if any_penalty:
                self._counts.index_put_((rows, nxt.long()),
                                        advanced.to(torch.int32),
                                        accumulate=True)
            tokens = nxt[:, None]
            toks.append(nxt)
            advs.append(advanced.to(torch.int32))
        return torch.cat([torch.stack(toks), torch.stack(advs),
                          cache.lengths[None, :]], dim=0)

    def warmup(self) -> None:
        """Build the kernels and run every admission shape — the
        (bucket x group) prefill grid on monolithic arms; on the paged
        chunked arm the chunk program at every bucket width and every
        group size up to ``min(max_admissions_per_step, budget // W)`` (the
        largest bucket's group of 1 is the multi-chunk train's shape); on
        the slab chunked arm its one row-cache chunk and commit — plus a
        greedy and a sampled decode step before serving: the reference's
        warmup grid, here priming the kernel build, the GEMM heuristics
        and the allocator instead of XLA compiles, so the first requests
        pay none of it. Paged warmup writes through all-sentinel tables
        (every write lands in the sink page; no page is allocated), so the
        allocator is untouched. The lengths and counts are reset
        afterwards."""
        if self.device.type == "cuda":
            from ray_dynamic_batching_tpu_torch.ops import _build

            _build.build()
        dev = self.device
        K = self.max_bias_entries
        slab_trains = self.chunked_prefill and not self.paged
        if slab_trains:
            C = self.prompt_buckets[-1]
            with torch.inference_mode():
                row = self.model.make_cache(1, self._long_row_cap(C))
            last, row, _ = run_chunk(self._row_chunk_impl,
                                     np.zeros((C,), np.int32), 0, C, row, dev)
            self._commit_long_impl(
                row, 0, torch.zeros((3,), dtype=torch.int32, device=dev),
                last, torch.tensor([0.0, 1.0], device=dev),
                torch.zeros((1, K), dtype=torch.int32, device=dev),
                torch.zeros((1, K), device=dev), True)
        for b in [] if slab_trains else self.prompt_buckets:
            top = self.max_admissions_per_step
            if self.chunked_prefill:
                top = min(top, self.prefill_token_budget // b)
            for g in range(1, top + 1):
                tokmask = torch.stack([torch.zeros((g, b), dtype=torch.int32),
                                       torch.ones((g, b), dtype=torch.int32)])
                meta_f = torch.zeros((2, g))
                meta_f[1] = 1.0
                bias = (torch.zeros((g, K), dtype=torch.int32, device=dev),
                        torch.zeros((g, K), device=dev))
                sentinel = None
                if self.paged:
                    sentinel = torch.full((g, self._n_table_entries),
                                          self.num_pages, dtype=torch.int32,
                                          device=dev)
                if self.chunked_prefill:
                    self._chunk_group_paged_impl(
                        tokmask.to(dev), sentinel,
                        torch.zeros((6, g), dtype=torch.int32, device=dev),
                        meta_f.to(dev), *bias, 0, g % 2 == 0)
                    continue
                meta_i = torch.zeros((3, g), dtype=torch.int32)
                meta_i[0] = torch.arange(g) % self.num_slots
                self._prefill_impl(
                    tokmask.to(dev), meta_i.to(dev), meta_f.to(dev), *bias,
                    g % 2 == 0, sentinel,
                )
        samp_f, samp_i, bias_ids, bias_vals = self._sampling_arrays()
        for sampled in (False, True):
            self._decode_impl(
                torch.zeros((3, self.num_slots), dtype=torch.int32,
                            device=dev),
                1, samp_f, samp_i, bias_ids, bias_vals, sampled, sampled,
            )
        with torch.inference_mode():
            self._cache.lengths.zero_()
            self._counts.zero_()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --- admission ---------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots)
                if s.free and i not in self._train_slots]

    def _prep_prompt(self, req: Request) -> Tuple[np.ndarray, int, Dict]:
        """Validate one request before it costs a dispatch; returns
        (prompt ids, bucket, opts) or raises BadRequest."""
        try:
            prompt = np.asarray(
                req.payload["tokens"] if isinstance(req.payload, dict)
                else req.payload,
                dtype=np.int32,
            ).reshape(-1)
        except (TypeError, ValueError, KeyError) as e:
            raise BadRequest(f"{req.request_id}: malformed tokens: {e}")
        if prompt.size == 0:
            raise BadRequest(f"{req.request_id}: empty prompt")
        V = self.model.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= V:
            raise BadRequest(f"{req.request_id}: token id out of vocab")
        bucket = bucket_up(int(prompt.size), self.prompt_buckets)
        if bucket is None:
            # Longer than every bucket: chunked (bucket -1) — a multi-chunk
            # train, or on the monolithic arms the long fill — as long as
            # the cache holds the prompt plus one generated token.
            if prompt.size >= self.max_len:
                raise BadRequest(
                    f"{req.request_id}: prompt length {prompt.size} "
                    f"exceeds KV capacity {self.max_len}")
            bucket = -1
        opts = {
            "_cache_len": int(prompt.size),
            "max_new": self.default_max_new_tokens,
            "temperature": 0.0,
            "top_k": 0,
            # Stable default seed from the request id (crc32), so a
            # re-submitted request resamples the same way on any replica.
            "seed": zlib.crc32(req.request_id.encode()) & 0x7FFFFFFF,
            "stop": frozenset(),
            "logit_bias": {},
            "presence_penalty": 0.0,
            "frequency_penalty": 0.0,
            "top_p": 1.0,
        }
        if isinstance(req.payload, dict):
            p = req.payload
            try:
                opts["max_new"] = int(p.get("max_new_tokens", opts["max_new"]))
                opts["temperature"] = float(p.get("temperature", 0.0))
                opts["top_k"] = int(p.get("top_k", 0))
                opts["top_p"] = float(p.get("top_p", 1.0))
                opts["presence_penalty"] = float(
                    p.get("presence_penalty", 0.0))
                opts["frequency_penalty"] = float(
                    p.get("frequency_penalty", 0.0))
                if not (math.isfinite(opts["presence_penalty"])
                        and math.isfinite(opts["frequency_penalty"])):
                    raise BadRequest(
                        f"{req.request_id}: penalties must be finite")
                if "seed" in p:
                    opts["seed"] = int(p["seed"]) & 0x7FFFFFFF
                opts["stop"] = frozenset(
                    int(t) for t in p.get("stop_token_ids", ()))
                bias = {int(t): float(v)
                        for t, v in dict(p.get("logit_bias", {})).items()}
                for t in p.get("banned_tokens", ()):
                    bias[int(t)] = -1e9  # a ban = very negative bias
            except (TypeError, ValueError) as e:
                raise BadRequest(f"{req.request_id}: malformed field: {e}")
            if len(bias) > self.max_bias_entries:
                raise BadRequest(
                    f"{req.request_id}: {len(bias)} logit-bias entries "
                    f"exceed the limit of {self.max_bias_entries}")
            if any(not 0 <= t < V for t in bias):
                raise BadRequest(
                    f"{req.request_id}: logit-bias token id out of vocab")
            opts["logit_bias"] = bias
            if not 0.0 <= opts["top_p"] <= 1.0:
                raise BadRequest(f"{req.request_id}: top_p must be in [0, 1]")
            if opts["top_p"] == 0.0:
                opts["top_p"] = 1e-9  # the smallest nucleus: argmax alone
            if opts["temperature"] < 0.0:
                raise BadRequest(
                    f"{req.request_id}: temperature must be >= 0")
        return prompt, bucket, opts

    def _bias_arrays(self, opts: Dict):
        """opts -> fixed-width (ids [K], vals [K]) padded with (0, 0.0)."""
        K = self.max_bias_entries
        ids = np.zeros((K,), dtype=np.int32)
        vals = np.zeros((K,), dtype=np.float32)
        for j, (t, v) in enumerate(opts.get("logit_bias", {}).items()):
            ids[j] = t
            vals[j] = v
        return ids, vals

    def _admit(self) -> int:
        """Fill free slots from the queue (continuous batching join).
        Chunked engines admit into chunk trains, every free slot at once:
        their prefill work is paced by the token budget in
        :meth:`_pump_prefill`. Monolithic arms ration by count instead:
        while slots are decoding, at most ``max_admissions_per_step``
        prefills run between decode steps; an idle engine fills every
        free slot."""
        free = self._free_slots()
        if not free:
            return 0
        if self._active_mask.any() and not self.chunked_prefill:
            free = free[: self.max_admissions_per_step]
        batch = self.queue.get_batch(len(free), discard_stale=True)
        self._admitting = len(batch)
        try:
            if self.chunked_prefill:
                return self._admit_chunked(batch, free)
            return self._admit_batch(batch, free)
        finally:
            self._admitting = 0

    def _admit_batch(self, batch: List[Request], free: List[int]) -> int:
        t_dequeue = now_ms()
        by_bucket: Dict[int, List[Tuple[Request, np.ndarray, Dict]]] = {}
        for req in batch:
            req.admit_ms = t_dequeue
            try:
                prompt, bucket, opts = self._prep_prompt(req)
            except Exception as e:  # noqa: BLE001 — bad prompt must not kill loop
                req.reject(e)
                continue
            if self.paged and not self._alloc_admission_pages(
                    req, prompt, opts):
                continue  # page-starved: requeued (or refused) inside
            by_bucket.setdefault(bucket, []).append((req, prompt, opts))
        admitted = 0
        cap = self.max_admissions_per_step
        long_items = by_bucket.pop(-1, [])
        for bucket, items in by_bucket.items():
            for off in range(0, len(items), cap):
                chunk = items[off: off + cap]
                slots = free[admitted: admitted + len(chunk)]
                try:
                    self._prefill_group(bucket, chunk, slots)
                except Exception as e:  # noqa: BLE001 — no dangling futures
                    logger.exception("%s: prefill group failed",
                                     self.model.name)
                    for req, _p, opts in chunk:
                        self._release_pages(opts)
                        req.reject(e)
                    continue
                admitted += len(chunk)
        # Long prompts fill one by one after the groups; past the free
        # slots they go back to the queue untouched (pages re-granted at
        # their next admission).
        for req, prompt, opts in long_items:
            if admitted >= len(free):
                self._release_pages(opts)
                self._requeue(req, "long-prompt admission")
                continue
            try:
                self._prefill_long(req, prompt, opts, free[admitted])
            except Exception as e:  # noqa: BLE001 — same no-dangle rule
                logger.exception("%s: long fill failed", self.model.name)
                self._release_pages(opts)
                req.reject(e)
                continue
            admitted += 1
        return admitted

    def _prefill_group(self, bucket: int,
                       items: List[Tuple[Request, np.ndarray, Dict]],
                       slot_ids: List[int]) -> None:
        n = len(items)
        tokens = np.zeros((n, bucket), dtype=np.int32)
        mask = np.zeros((n, bucket), dtype=np.int32)
        meta_i = np.zeros((3, n), dtype=np.int32)
        meta_f = np.zeros((2, n), dtype=np.float32)
        bias_ids = np.zeros((n, self.max_bias_entries), dtype=np.int32)
        bias_vals = np.zeros((n, self.max_bias_entries), dtype=np.float32)
        for i, (_req, prompt, opts) in enumerate(items):
            tokens[i, : prompt.size] = prompt
            mask[i, : prompt.size] = 1
            meta_i[:, i] = (slot_ids[i], opts["top_k"], opts["seed"])
            meta_f[:, i] = (opts["temperature"], opts.get("top_p", 1.0))
            bias_ids[i], bias_vals[i] = self._bias_arrays(opts)
        dev = self.device
        pids = None
        if self.paged:
            # Physical destination pages per row (sentinel tail).
            pids = torch.from_numpy(np.stack([
                table_array(opts["_pages"], self._n_table_entries,
                            self.num_pages) for _r, _p, opts in items
            ])).to(dev)
        first = self._prefill_impl(
            torch.from_numpy(np.stack([tokens, mask])).to(dev),
            torch.from_numpy(meta_i).to(dev),
            torch.from_numpy(meta_f).to(dev),
            torch.from_numpy(bias_ids).to(dev),
            torch.from_numpy(bias_vals).to(dev),
            bool((meta_f[0] > 0).any()),
            pids,
        )
        first_host = first.cpu().numpy()  # ONE fetch for the whole group
        self.prefill_groups += 1
        t = now_ms()
        for i, (req, _prompt, opts) in enumerate(items):
            self._register(slot_ids[i], req, int(first_host[i]), opts, t)

    # --- the long fill (monolithic arms) -----------------------------------
    def _long_row_cap(self, C: int) -> int:
        """Row-cache capacity of a long fill: whole chunks covering the
        cache (the paged one page-rounded, so the commit's page cut has
        whole pages) plus one spare chunk — one shape for every prompt,
        as the reference keeps it. The commit cuts it back down."""
        cap = self._paged_capacity if self.paged else self.max_len
        return ((cap + C - 1) // C) * C + C

    def _interleave_step(self) -> None:
        """One plain decode step for the active batch between long-fill
        chunks: a long prompt stalls in-flight streams by at most one
        chunk. When a colocation executor hosts this engine it installs
        ``interleave_hook``, so co-tenant engines get scans between chunks
        too, not only this engine's own batch."""
        if self._active_mask.any():
            self._step(horizon=1)
        if self.interleave_hook is not None:
            self.interleave_hook()

    def _prefill_long(self, req: Request, prompt: np.ndarray, opts: Dict,
                      slot_idx: int) -> None:
        """Admit one prompt longer than every bucket: prefill it in chunks
        of the largest bucket into a private single-row cache, one decode
        step for the active batch between chunks, then ONE commit (row into
        the shared cache + first-token sample) and registration. Paged
        engines granted the prompt's pages at admission; the commit cuts
        the row into them."""
        C = self.prompt_buckets[-1]
        with torch.inference_mode():
            row = self.model.make_cache(1, self._long_row_cap(C))

        def chunk(*args):
            self.long_chunk_dispatches += 1
            return self._row_chunk_impl(*args)

        last, row = run_chunked(chunk, prompt, C, row, self.device,
                                between=self._interleave_step)
        self._commit_and_register(req, opts, slot_idx, row, last)

    def _commit_and_register(self, req: Request, opts: Dict, slot_idx: int,
                             row, last) -> None:
        """Shared tail of every row-cache admission (the long fill, a slab
        train's final chunk): ONE commit (the row into the shared cache +
        first-token sample), then registration."""
        bids, bvals = self._bias_arrays(opts)
        pids = None
        if self.paged:
            pids = torch.from_numpy(table_array(
                opts["_pages"], self._n_table_entries, self.num_pages
            )[None]).to(self.device)
        dev = self.device
        first = self._commit_long_impl(
            row, slot_idx,
            torch.tensor([slot_idx, opts["top_k"], opts["seed"]],
                         dtype=torch.int32).to(dev),
            last,
            torch.tensor([opts["temperature"], opts["top_p"]],
                         dtype=torch.float32).to(dev),
            torch.from_numpy(bids[None]).to(dev),
            torch.from_numpy(bvals[None]).to(dev),
            opts["temperature"] > 0, pids,
        )
        self._register(slot_idx, req, int(first.cpu()[0]), opts, now_ms())

    # --- token-budget chunked admission ------------------------------------
    def _admit_chunked(self, batch: List[Request], free: List[int]) -> int:
        """Every dequeued request becomes a :class:`_ChunkTrain` holding a
        slot; no prefill dispatches here — :meth:`_pump_prefill` advances
        trains between decode turns."""
        t_dequeue = now_ms()
        started = 0
        for req in batch:
            req.admit_ms = t_dequeue
            try:
                prompt, bucket, opts = self._prep_prompt(req)
            except Exception as e:  # noqa: BLE001 — bad prompt must not kill loop
                req.reject(e)
                continue
            slot_idx = free[started]  # len(batch) <= len(free) by dequeue
            try:
                self._start_train(req, prompt, bucket, opts, slot_idx)
            except Exception as e:  # noqa: BLE001 — no-dangle rule
                logger.exception("%s: train admission failed",
                                 self.model.name)
                self._release_pages(opts)
                req.reject(e)
                continue
            started += 1
        return started

    def _start_train(self, req: Request, prompt: np.ndarray, bucket: int,
                     opts: Dict, slot_idx: int) -> None:
        """Park one admission's chunk train for the budget pump. Paged: a
        bucketed prompt keeps its bucket as the chunk width, so
        same-bucket trains group into one program; a long prompt chunks
        at the largest bucket. Slab trains always chunk at the largest
        bucket, on a private row cache of :meth:`_long_row_cap` (the
        long fill's shapes, so one chunk and one commit serve every
        train)."""
        C_max = self.prompt_buckets[-1]
        row = None
        if self.paged:
            W = bucket if bucket > 0 else C_max
            opts["_pages"] = []
        else:
            W = C_max
            with torch.inference_mode():
                row = self.model.make_cache(1, self._long_row_cap(W))
        self._trains.append(_ChunkTrain(
            req=req, prompt=prompt, opts=opts, slot_idx=slot_idx, C=W,
            total=int(prompt.size), row=row,
        ))
        self._train_slots.add(slot_idx)

    def _pump_prefill(self) -> None:
        """Spend at most ``prefill_token_budget`` tokens advancing pending
        chunk trains, FCFS from the oldest. Slab trains advance one
        row-cache chunk each. Paged: single-chunk trains of the head's
        width group into one dispatch of at most
        ``min(max_admissions_per_step, budget // W)`` rows; a multi-chunk
        train dispatches alone. A train whose next chunk cannot get its
        pages parks for the round (live streams are never evicted to feed
        an admission); a round where nothing could progress while no
        stream decodes requeues the newest train, so parked trains cannot
        deadlock the pool among themselves."""
        if not self._trains:
            return
        model_tag = {"model": self.model.name}
        budget = self.prefill_token_budget
        parked: set = set()
        dispatched_any = False
        while budget > 0:
            head = next(
                (t for t in self._trains if id(t) not in parked), None)
            if head is None or head.C > budget:
                break
            if not self.paged:
                try:
                    self._advance_train_slab(head)
                except Exception as e:  # noqa: BLE001 — no-dangle rule
                    logger.exception("%s: chunk dispatch failed",
                                     self.model.name)
                    self._drop_train(head, e)
                    continue
                budget -= head.C
                dispatched_any = True
                # Colocation fairness: co-tenant engines get their scans
                # between chunk dispatches (engine/colocate.py).
                if self.interleave_hook is not None:
                    self.interleave_hook()
                continue
            members = [head]
            if head.total <= head.C:
                cap = min(self.max_admissions_per_step,
                          max(1, budget // head.C))
                for t in self._trains:
                    if len(members) >= cap:
                        break
                    if (t is head or id(t) in parked or t.C != head.C
                            or t.total > t.C):
                        continue
                    members.append(t)
            ready = []
            for t in members:
                if self._grant_train_pages(t):
                    ready.append(t)
                else:
                    parked.add(id(t))
                    PREFILL_STARVED.inc(tags=model_tag)
            if not ready:
                continue
            try:
                self._dispatch_chunk_group(ready)
            except Exception as e:  # noqa: BLE001 — no-dangle rule
                logger.exception("%s: chunk dispatch failed",
                                 self.model.name)
                for t in ready:
                    self._drop_train(t, e)
                continue
            budget -= head.C * len(ready)
            dispatched_any = True
            if self.interleave_hook is not None:
                self.interleave_hook()
        if (self.paged and not dispatched_any and self._trains
                and not self._active_mask.any()):
            self._relieve_train_starvation()
        PREFILL_PENDING.set(float(len(self._trains)), tags=model_tag)

    def _drain_prefill(self) -> None:
        """Pump pending chunk trains to completion (tests and manual
        drivers; the serving loop pumps one budget per turn). Decode turns
        run only while trains are parked behind pages that active streams
        hold."""
        while self._trains:
            before = (sum(t.pos for t in self._trains), len(self._trains))
            self._pump_prefill()
            after = (sum(t.pos for t in self._trains), len(self._trains))
            if after != before:
                continue
            if self._active_mask.any():
                self._step(horizon=1)
                continue
            raise TimeoutError(
                f"{self.model.name}: chunk trains cannot progress "
                "(page-starved with no active streams)")

    def _grant_train_pages(self, train: _ChunkTrain) -> bool:
        """Extend the train's pages to cover its NEXT chunk's real
        positions (a final chunk also covers the first generated token);
        False when the pool cannot (the train parks)."""
        take = min(train.C, train.total - train.pos)
        if train.pos + take >= train.total:
            need = pages_for(min(train.total + 1, self._paged_capacity),
                             self.page_size)
        else:
            need = pages_for(train.pos + take, self.page_size)
        delta = need - len(train.opts["_pages"])
        if delta <= 0:
            return True
        if not self._allocator.can_alloc(delta):
            return False
        train.opts["_pages"].extend(self._allocator.alloc(delta))
        return True

    def _dispatch_chunk_group(self, trains: List[_ChunkTrain]) -> None:
        """ONE pages-direct chunk program for same-width trains; the
        first token of each final row is fetched in one copy and the
        train registers into its slot."""
        W = trains[0].C
        g = len(trains)
        tokens = np.zeros((g, W), np.int32)
        mask = np.zeros((g, W), np.int32)
        tables = np.empty((g, self._n_table_entries), np.int32)
        meta_i = np.zeros((6, g), np.int32)
        meta_f = np.zeros((2, g), np.float32)
        bias_ids = np.zeros((g, self.max_bias_entries), np.int32)
        bias_vals = np.zeros((g, self.max_bias_entries), np.float32)
        finals: List[Tuple[int, _ChunkTrain]] = []
        for i, t in enumerate(trains):
            piece = t.prompt[t.pos: t.pos + W]
            take = int(piece.size)
            tokens[i, :take] = piece
            mask[i, :take] = 1
            tables[i] = table_array(t.opts["_pages"], self._n_table_entries,
                                    self.num_pages)
            meta_i[:4, i] = (t.pos, take - 1, t.opts["top_k"],
                             t.opts["seed"])
            meta_f[:, i] = (t.opts["temperature"], t.opts.get("top_p", 1.0))
            bias_ids[i], bias_vals[i] = self._bias_arrays(t.opts)
            if t.pos + take >= t.total:
                # Only the final chunk publishes the prompt's length.
                meta_i[4:, len(finals)] = (t.slot_idx, t.total)
                finals.append((i, t))
        dev = self.device
        first = self._chunk_group_paged_impl(
            torch.from_numpy(np.stack([tokens, mask])).to(dev),
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(meta_i).to(dev),
            torch.from_numpy(meta_f).to(dev),
            torch.from_numpy(bias_ids).to(dev),
            torch.from_numpy(bias_vals).to(dev),
            len(finals), bool((meta_f[0] > 0).any()),
        )
        for t in trains:
            t.pos = min(t.pos + W, t.total)
        self.chunk_dispatches += 1
        PREFILL_CHUNKS.inc(g, tags={"model": self.model.name})
        if not finals:
            return
        first_host = first.cpu().numpy()  # ONE fetch, final rows only
        t_done = now_ms()
        for i, t in finals:
            self._retire_train(t)
            self._register(t.slot_idx, t.req, int(first_host[i]), t.opts,
                           t_done)

    def _advance_train_slab(self, train: _ChunkTrain) -> None:
        """One row-cache chunk for a slab train; the final chunk flows
        into the commit (row into the shared cache + first-token sample)
        and registration."""
        train.last, train.row, take = run_chunk(
            self._row_chunk_impl, train.prompt, train.pos, train.C,
            train.row, self.device)
        train.pos += take
        self.chunk_dispatches += 1
        PREFILL_CHUNKS.inc(tags={"model": self.model.name})
        if train.pos >= train.total:
            self._retire_train(train)
            self._commit_and_register(train.req, train.opts, train.slot_idx,
                                      train.row, train.last)

    def _retire_train(self, train: _ChunkTrain) -> None:
        if train in self._trains:
            self._trains.remove(train)
        self._train_slots.discard(train.slot_idx)

    def _drop_train(self, train: _ChunkTrain, exc: Exception) -> None:
        """A failed train releases its pages and rejects its caller."""
        self._retire_train(train)
        self._release_pages(train.opts)
        train.req.reject(exc)

    def _relieve_train_starvation(self) -> None:
        """Deadlock valve: with no active streams no EOS can free pages,
        so requeue the newest train (preferring one that has not
        dispatched yet) and release its grant."""
        if not self._trains:
            return
        train = next((t for t in reversed(self._trains) if t.pos == 0),
                     self._trains[-1])
        self._retire_train(train)
        self._release_pages(train.opts)
        self._requeue(train.req, "page-starved chunked admission")

    # --- paged admission bookkeeping ---------------------------------------
    def _requeue(self, req: Request, why: str) -> None:
        """Back to the queue untouched; a refused requeue rejects (the
        engine holds the only reference)."""
        if not self.queue.add_request(req, reject_on_full=False,
                                      requeue=True):
            self.queue.count_external_drop(req, reason="requeue_refused")
            req.reject(RequestDropped(
                f"{req.request_id}: queue refused requeue during {why}"))

    def _alloc_admission_pages(self, req: Request, prompt: np.ndarray,
                               opts: Dict) -> bool:
        """Reserve a monolithic admission's pages (prompt + the first
        generated token); page-starved, the request goes back to the
        queue (False)."""
        try:
            opts["_pages"] = self._allocator.alloc(
                pages_for(int(prompt.size) + 1, self.page_size))
            return True
        except OutOfPages:
            self._requeue(req, "page-starved admission")
            return False

    def _release_pages(self, opts: Dict) -> None:
        """Undo an admission's page reservation (failed or requeued before
        a slot took ownership)."""
        if not self.paged:
            return
        pages = opts.pop("_pages", None)
        if pages:
            self._allocator.decref(pages)

    def _register(self, slot_idx: int, req: Request, first_tok: int,
                  opts: Dict, t: float) -> None:
        max_new = opts["max_new"]
        slot = self._slots[slot_idx]
        slot.request = req
        slot.generated = [first_tok]
        slot.max_new_tokens = max_new
        slot.prefill_done_ms = t
        slot.stop = opts["stop"]
        self._len_host[slot_idx] = int(opts.get("_cache_len", 0))
        if self.paged:
            # The slot now owns the admission's pages; the host table
            # maps them for the next dispatch's refresh.
            slot.pages = list(opts.get("_pages", ()))
            self._table_host[slot_idx] = table_array(
                slot.pages, self._n_table_entries, self.num_pages)
            self._table_dirty = True
        self._tokens[slot_idx, 0] = first_tok
        self._active_mask[slot_idx] = True
        self._temps[slot_idx] = opts["temperature"]
        self._topk[slot_idx] = opts["top_k"]
        self._topp[slot_idx] = opts.get("top_p", 1.0)
        self._seeds[slot_idx] = opts["seed"]
        self._bias_ids[slot_idx], self._bias_vals[slot_idx] = \
            self._bias_arrays(opts)
        self._pres[slot_idx] = opts.get("presence_penalty", 0.0)
        self._freq[slot_idx] = opts.get("frequency_penalty", 0.0)
        self._sampling_dev = None  # host arrays changed
        if self._pres[slot_idx] or self._freq[slot_idx]:
            # Fresh tenant: zero the reused row, then count the
            # prefill-sampled first token.
            with torch.inference_mode():
                self._counts[slot_idx].zero_()
                self._counts[slot_idx, first_tok] = 1
        PREFILLS_TOTAL.inc(tags={"model": self.model.name})
        TTFT_MS.observe(
            t - req.arrival_ms, tags={"model": self.model.name},
            trace_id=(req.trace_ctx or {}).get("trace_id"),
        )
        admit_ms = req.admit_ms or t
        queue_wait = max(0.0, admit_ms - req.arrival_ms)
        # The share of queue_wait spent inside the decode scan that was in
        # flight when the request arrived: overlap of [arrival, dequeue]
        # with the most recently completed scan window.
        scan_wait = max(0.0, min(admit_ms, self._scan_end_ms)
                        - max(req.arrival_ms, self._scan_start_ms))
        prefill_ms = max(0.0, t - admit_ms)
        self._ttft_parts.append(
            (queue_wait, min(scan_wait, queue_wait), prefill_ms)
        )
        TTFT_QUEUE_MS.observe(queue_wait, tags={"model": self.model.name})
        TTFT_PREFILL_MS.observe(prefill_ms, tags={"model": self.model.name})
        if _tracer().enabled:
            # Retroactive prefill span (admit -> first token) in the
            # request's trace: with the queue.wait span the pop emitted,
            # the flight record shows the full TTFT decomposition.
            _tracer().record_span(
                "decode.prefill",
                ctx=req.trace_ctx,
                start_ms=admit_ms,
                end_ms=t,
                model=self.model.name,
                lane=self.model.name,
                queue_wait_ms=round(queue_wait, 2),
                scan_wait_ms=round(min(scan_wait, queue_wait), 2),
            )
        req.stream_put(first_tok)
        if self._is_stop(slot, first_tok) or max_new <= 1:
            reason = "eos" if self._is_stop(slot, first_tok) else "length"
            self._finish(slot_idx, reason)

    def _is_stop(self, slot: _Slot, tok: int) -> bool:
        return ((self.eos_token_id is not None and tok == self.eos_token_id)
                or tok in slot.stop)

    # --- step + eviction ---------------------------------------------------
    def _finish(self, slot_idx: int, reason: str) -> None:
        slot = self._slots[slot_idx]
        req = slot.request
        t = now_ms()
        if self.paged and slot.pages:
            self._free_slot_pages(slot_idx)
        result = DecodeResult(
            tokens=list(slot.generated),
            finish_reason=reason,
            ttft_ms=slot.prefill_done_ms - req.arrival_ms,
            total_ms=t - req.arrival_ms,
        )
        req.fulfill(result)
        if _tracer().enabled:
            # Completion event joined to the caller's trace: carries the
            # numbers an operator actually debugs with.
            with _tracer().attach_context(req.trace_ctx,
                                          "decode.sequence") as sp:
                if sp is not None:
                    sp.attributes.update(
                        tokens=len(slot.generated),
                        finish_reason=reason,
                        ttft_ms=round(result.ttft_ms, 1),
                        total_ms=round(result.total_ms, 1),
                    )
        self.queue.record_batch_completion([req], completed_at_ms=t)
        TOKENS_TOTAL.inc(len(slot.generated), tags={"model": self.model.name})
        self._slots[slot_idx] = _Slot()
        self._active_mask[slot_idx] = False
        self._len_host[slot_idx] = 0
        self._temps[slot_idx] = 0.0
        self._topk[slot_idx] = 0
        self._topp[slot_idx] = 1.0
        self._seeds[slot_idx] = 0
        self._bias_ids[slot_idx] = 0
        self._bias_vals[slot_idx] = 0.0
        self._pres[slot_idx] = 0.0
        self._freq[slot_idx] = 0.0
        # No device-array invalidation: a freed slot's stale device values
        # are masked by the active row of the next dispatch.
        self.completed += 1

    # --- page-pool management (paged mode) --------------------------------
    def _free_slot_pages(self, slot_idx: int) -> None:
        """Return a finished slot's pages to the pool at once (EOS frees
        mid-cycle); its table row goes to sentinel at the next refresh,
        before any dispatch could write through it."""
        slot = self._slots[slot_idx]
        if slot.pages:
            self._allocator.decref(slot.pages)
            slot.pages = []
        self._table_host[slot_idx] = self.num_pages
        self._len_host[slot_idx] = 0
        self._table_dirty = True

    def _refresh_table(self) -> None:
        """Upload the host page table when it changed. This is the device
        table's only writer, and it uploads a fresh copy, so later host
        edits of the mirror never race the copy."""
        if self._table_dirty:
            self._cache.page_table = torch.from_numpy(
                self._table_host.copy()).to(self.device)
            self._table_dirty = False

    def _ensure_page_headroom(self, horizon: int) -> None:
        """Grow active slots' pages to cover the next ``horizon`` substeps
        before the dispatch. When an over-subscribed pool runs dry, the
        most recently admitted other slot is capacity-finished and its
        pages reused (newest first keeps the streams with the most sunk
        cost); if even that cannot cover a slot, the slot itself is
        capacity-finished. Full-backing pools never evict."""
        for i in np.flatnonzero(self._active_mask):
            slot = self._slots[i]
            if slot.free:
                continue
            need = pages_for(
                min(int(self._len_host[i]) + horizon, self.max_len),
                self.page_size)
            delta = need - len(slot.pages)
            if delta <= 0:
                continue
            while not self._allocator.can_alloc(delta):
                victim = self._eviction_victim(exclude=int(i))
                if victim is None:
                    break
                PAGE_EVICTIONS.inc(tags={"model": self.model.name})
                self._page_journal.record(
                    "eviction", len(self._slots[victim].pages),
                    self._allocator.allocated_pages, slot=int(victim))
                self._finish(victim, "capacity")
            if not self._allocator.can_alloc(delta):
                # Not even eviction could cover this slot: truncate IT.
                PAGE_EVICTIONS.inc(tags={"model": self.model.name})
                self._page_journal.record(
                    "eviction", len(slot.pages),
                    self._allocator.allocated_pages, slot=int(i))
                self._finish(int(i), "capacity")
                continue
            slot.pages.extend(self._allocator.alloc(delta))
            self._table_host[i] = table_array(
                slot.pages, self._n_table_entries, self.num_pages)
            self._table_dirty = True

    def _eviction_victim(self, exclude: int) -> Optional[int]:
        """Most recently admitted active slot other than ``exclude``."""
        best, best_t = None, -1.0
        for j, s in enumerate(self._slots):
            if j == exclude or s.free or not self._active_mask[j]:
                continue
            if s.prefill_done_ms > best_t:
                best, best_t = j, s.prefill_done_ms
        return best

    def _pick_horizon(self) -> int:
        """Single steps while chunk trains are pending (a long scan would
        stretch every pending train's TTFT) or requests wait for a free
        slot; the full scan only when the batch is full; the short
        ``ttft_horizon`` when slots are free but nothing is queued."""
        if self.decode_horizon <= 1:
            return 1
        if self._trains:
            return 1
        if not self._free_slots():
            return self.decode_horizon
        if len(self.queue) == 0:
            return self.ttft_horizon
        return 1

    def reset_ttft_window(self) -> None:
        """Drop the rolling TTFT window (benchmark phase boundaries)."""
        self._ttft_parts.clear()

    def ttft_breakdown(self) -> Dict[str, float]:
        """p50/p95 of the TTFT components over the rolling window."""
        parts = list(self._ttft_parts)
        if not parts:
            return {"n": 0}
        out: Dict[str, float] = {"n": len(parts)}
        for name, vals in zip(
            ("queue_wait_ms", "scan_wait_ms", "prefill_ms"), zip(*parts),
        ):
            s = sorted(vals)
            out[f"{name}_p50"] = round(s[len(s) // 2], 2)
            out[f"{name}_p95"] = round(
                s[min(len(s) - 1, int(len(s) * 0.95))], 2)
        return out

    def _sampling_arrays(self):
        """Device copies of the per-slot sampling state, packed by dtype."""
        if self._sampling_dev is None:
            dev = self.device
            self._sampling_dev = (
                torch.from_numpy(np.stack(
                    [self._temps, self._topp, self._pres, self._freq]
                )).to(dev),
                torch.from_numpy(np.stack([self._topk, self._seeds])).to(dev),
                torch.from_numpy(self._bias_ids.copy()).to(dev),
                torch.from_numpy(self._bias_vals.copy()).to(dev),
            )
        return self._sampling_dev

    def _record_turn_span(self, horizon: int, active_mask) -> None:
        """One retroactive span per decode scan (dispatch -> host fetch),
        linked to every sequence that was active in it: continuous
        batching's fan-in, the decode analogue of the batch-execution
        span. Bounded by num_slots links per turn."""
        links = [
            _link_to(slot.request.trace_ctx)
            for i, slot in enumerate(self._slots)
            if active_mask[i] and slot.request is not None
        ]
        _tracer().record_span(
            "decode.turn",
            start_ms=self._scan_start_ms,
            end_ms=self._scan_end_ms,
            links=links,
            model=self.model.name,
            lane=self.model.name,
            horizon=int(horizon),
            active=int(active_mask.sum()),
            spec=False,
        )

    def _step(self, horizon: Optional[int] = None) -> None:
        h = horizon if horizon is not None else self._pick_horizon()
        if self.paged:
            # Pages for every position this dispatch can write, granted
            # on the host first; then the table upload when it changed.
            self._ensure_page_headroom(h)
            self._refresh_table()
        # Per-slot index of the NEXT token to sample (prefill was index 0).
        tok_idx = np.asarray(
            [len(s.generated) if not s.free else 0 for s in self._slots],
            dtype=np.int32,
        )
        active = self._active_mask.copy()
        samp_f, samp_i, bias_ids, bias_vals = self._sampling_arrays()
        self._scan_start_ms = now_ms()
        packed = self._decode_impl(
            torch.from_numpy(np.stack([
                self._tokens[:, 0], active.astype(np.int32), tok_idx,
            ])).to(self.device),
            h, samp_f, samp_i, bias_ids, bias_vals,
            bool((self._temps[active] > 0).any()),
            bool(self._pres[active].any() or self._freq[active].any()),
        )
        packed_host = packed.cpu().numpy()   # ONE fetch per dispatch
        self._scan_end_ms = now_ms()
        if _tracer().enabled and active.any():
            self._record_turn_span(h, active)
        self.steps += h
        DECODE_STEPS.inc(h, tags={"model": self.model.name})
        self._harvest(packed_host[:h], packed_host[h: 2 * h].astype(bool),
                      packed_host[2 * h], h)

    def _harvest(self, toks_host, advanced_host, lengths_host,
                 h: int) -> None:
        """Distribute a scan's [h, B] outputs to their slots: a
        non-advanced substep finishes "capacity", a stop token is accepted
        then finishes "eos", the max_new bound accepts its last token then
        finishes "length" (eos beats length beats capacity at equal
        counts)."""
        active_idx = [i for i, slot in enumerate(self._slots)
                      if not slot.free and self._active_mask[i]]
        if not active_idx:
            return
        cols = np.asarray(active_idx, dtype=np.int64)
        self._len_host[cols] = lengths_host[cols]
        toks = toks_host[:, cols]
        adv = advanced_host[:, cols]
        blocked = ~adv
        cap_at = np.where(blocked.any(axis=0), blocked.argmax(axis=0), h)
        if self.eos_token_id is not None:
            stop_mask = toks == self.eos_token_id
        else:
            stop_mask = np.zeros_like(adv)
        for c, i in enumerate(active_idx):
            extra = self._slots[i].stop
            if extra:
                stop_mask[:, c] |= np.isin(
                    toks[:, c], np.fromiter(extra, dtype=np.int64))
        stop_take = np.where(stop_mask.any(axis=0),
                             stop_mask.argmax(axis=0) + 1, h + 1)
        len_take = np.asarray([
            max(0, self._slots[i].max_new_tokens
                - len(self._slots[i].generated))
            for i in active_idx
        ])
        accepted = np.minimum.reduce(
            [cap_at, stop_take, len_take, np.full_like(cap_at, h)])
        for c, i in enumerate(active_idx):
            slot = self._slots[i]
            acc = int(accepted[c])
            if acc > 0:
                new_toks = toks[:acc, c].tolist()
                slot.generated.extend(new_toks)
                self._tokens[i, 0] = new_toks[-1]
                if slot.request.stream is not None:
                    for tok in new_toks:
                        slot.request.stream_put(tok)
            if stop_take[c] == accepted[c]:
                self._finish(i, "eos")
            elif len_take[c] == accepted[c]:
                self._finish(i, "length")
            elif cap_at[c] == accepted[c] and cap_at[c] < h:
                self._finish(i, "capacity")
            elif lengths_host[i] >= self.max_len:
                self._finish(i, "capacity")

    # --- loop --------------------------------------------------------------
    def run_until_idle(self, timeout_s: float = 60.0) -> None:
        """Drive admissions + steps until queue and slots are empty."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            admitted = self._admit()
            self._pump_prefill()
            if self._active_mask.any():
                self._step()
            elif (not admitted and not self._trains
                    and len(self.queue) == 0):
                return
        raise TimeoutError(f"{self.model.name}: decode did not drain")

    def _set_gauges(self) -> None:
        """The loop's per-turn gauges: active slots and, paged, the
        pool's free pages and allocated fraction."""
        tags = {"model": self.model.name}
        ACTIVE_SLOTS.set(float(self._active_mask.sum()), tags=tags)
        if self.paged:
            KV_PAGES_FREE.set(float(self._allocator.free_pages), tags=tags)
            KV_PAGE_OCCUPANCY.set(
                self._allocator.allocated_pages / self.num_pages, tags=tags)

    def _loop(self) -> None:
        while self._run.is_set():
            try:
                self._admit()
                self._pump_prefill()
                if self._active_mask.any():
                    self._step()
                    self._set_gauges()
                elif not self._trains:
                    self.queue.wait_for_requests(self.idle_wait_s)
                self.last_heartbeat = time.monotonic()
            except Exception:  # noqa: BLE001 — engine must not die silently
                logger.exception("%s: decode loop iteration failed",
                                 self.model.name)
                time.sleep(0.05)

    def release_buffers(self) -> None:
        """Drop the engine's device footprint (the cache with its scale
        planes, the counts). Call only after the loop has stopped; the
        engine is unusable afterwards."""
        self._cache = None
        self._counts = None
        self._sampling_dev = None
        if self.paged:
            self._allocator = None
            self._table_host = None

    def abort_active(self, exc: Exception) -> None:
        """Reject every request still occupying a slot (shutdown). Call
        only after the loop has stopped."""
        for i, slot in enumerate(self._slots):
            if not slot.free and slot.request is not None:
                slot.request.reject(exc)
                if self.paged and self._allocator is not None:
                    self._free_slot_pages(i)
                self._slots[i] = _Slot()
                self._active_mask[i] = False
        # Chunk trains hold a slot and pages but no tokens yet.
        for train in list(self._trains):
            train.req.reject(exc)
            if self.paged and self._allocator is not None:
                self._release_pages(train.opts)
        self._trains.clear()
        self._train_slots.clear()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._run.set()
        self._thread = threading.Thread(
            target=self._loop, name=f"decode-{self.model.name}", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._run.clear()
        if self._thread is not None:
            self._thread.join(timeout_s)
            if self._thread.is_alive():
                logger.warning("%s: loop thread did not exit within %.1fs",
                               self.model.name, timeout_s)
            else:
                self._thread = None

    def kv_occupancy(self) -> float:
        """Useful fraction of reserved KV positions: of ``num_slots *
        max_len`` on a slab engine, of the allocated pages' positions on a
        paged one. 1.0 when nothing is reserved."""
        used = float(self._len_host.sum())
        if self.paged:
            reserved = float(self._allocator.allocated_pages * self.page_size
                             if self._allocator is not None else 0)
        else:
            reserved = float(self.num_slots * self.max_len)
        return used / reserved if reserved > 0 else 1.0

    def snapshot(self) -> Dict[str, Any]:
        """Operator-facing state dump: slot/KV occupancy, the TTFT
        breakdown and the prefill scheduler, plus — in paged mode — the
        pool's page counts and the allocator event journal (bounded ring;
        ``events`` carries the retained tail, ``journal_total`` /
        ``journal_rotated`` say how much history the ring has seen/shed,
        so a consumer can tell a quiet pool from a ring that wrapped).
        The journal feeds ``utils/trace_export.to_chrome_trace(spans,
        journal=...)`` for a lane time-aligned with the decode-turn
        spans. The reference's ``fabric`` and ``spec`` blocks come with
        the page fabric and speculative decoding."""
        out: Dict[str, Any] = {
            "model": self.model.name,
            "paged": self.paged,
            "num_slots": self.num_slots,
            "active_slots": self.active_slots,
            "kv_occupancy": self.kv_occupancy(),
            "ttft": self.ttft_breakdown(),
            "prefill": {
                "mode": "chunked" if self.chunked_prefill else "mono",
                "token_budget": self.prefill_token_budget,
                "pending_trains": len(self._trains),
            },
        }
        if self.paged:
            out["page_size"] = self.page_size
            out["num_pages"] = self.num_pages
            out["free_pages"] = self._allocator.free_pages
            out["allocated_pages"] = self._allocator.allocated_pages
            out["page_journal"] = {
                "events": self._page_journal.snapshot(),
                "journal_total": self._page_journal.total,
                "journal_rotated": self._page_journal.rotated_out,
            }
        return out

    @property
    def active_slots(self) -> int:
        return int(self._active_mask.sum())
