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

KV reuse (off by default): ``prefix_cache_size`` keeps prompt-prefix KV —
by page reference on the paged pool (:class:`PagedPrefixCache`: the
longest shared page-prefix borrowed copy-on-write, looked up at a chunk
train's first dispatch or at a mono long fill), as chunk-0 device copies
on the slab (:class:`PrefixCache`); ``host_spill_pages`` (paged, beside a
prefix cache) spills shed prefix entries to pinned host memory and
reloads them on the next match; ``session_cache_size`` continues a
payload's ``session_id`` from its previous turn (paged: the finished
turn's pages pinned; slab: its row copied), prefilling only the new
tail. The page fabric (``engine/pagefabric.py``) moves a live paged
stream to another engine or pushes a prefix entry to one, through
mailboxes the loop services between decode turns; imports write the pool
in place.

Decode is shared: ``horizon`` chained steps for all slots per host sync,
with presence/frequency penalties, sparse logit bias and the per-request
sampler on the device; everything the host needs comes back as ONE packed
``[2h+1, B]`` int32 tensor fetched once per dispatch
(:meth:`_decode_impl`). Page grants, eviction and the page table live on
the host (``engine/paging.py``); the device table has one writer,
:meth:`_refresh_table`.

The reference's hot jit programs (``ops/jit_model.py``) are created at
init as the port's programs (``ops/graphs.py``): on the card each key —
the program's host-static arguments and input shapes — is captured once
as a CUDA graph and replayed with one launch, its inputs copied into
static buffers; the reference's donated buffers are state updated in
place at fixed addresses (the cache with its lengths, page table and
scale planes; the penalty counts). :meth:`warmup` runs every key the
arm can dispatch inside the capture ledger's warmup phase and checks
the episodes against ``jit_model.required_for``; after it, a new key
raises. The long fill's chunk and commit run eagerly (their row cache
is per fill; the registry says so), as do the reuse programs' row seeds
and extracts, each warmed when its cache is on. The reference's group
padding to compiled widths is gone (a group is exactly its rows, so no
index is written twice): every group width is its own key.

Tensor parallelism (``mesh=``, a ``parallel/mesh.Mesh`` with ``tp`` > 1;
reference ``decode.py:540-579``, ``:651-694``, ``:846-851``,
``:1151-1160``): the reference's refusals come first and in its order —
a draft on a paged mesh engine, ``quantize_weights``, a paged engine over
a model with no ``paged_cache_pspec`` (``ValueError``). Then the model is
sharded (``parallel/mesh.shard_params``, unless it already is) and so is
a draft: a self-draft is the target's shard, a draft with its own
weights gets its own, cut by the same rules. Each rank allocates its
share of the kv heads (the draft's slab too), and every rank builds a
twin of the engine over its shards (``parallel/spmd.py``): every program
and every other device write of the leader (the row caches of a long
fill and of the draft's replay, the page-table upload, the reuse
programs' row seeds and extracts, a migrated stream's lengths and
counts, warmup) runs first on each follower's twin on the same host
inputs, then here, so the ranks issue the same collectives in the same
order; what such a call returns (a row, a stored session or prefix
segment) lives on every rank under one handle, each rank's own kv-head
shard. The page table, lengths mirror, allocator and its journal, the
prefix digests and the caches' LRU books, the spill tier's accounting,
admission, the draft's accept logic and results stay on rank 0. The
spill tier moves each rank's own shard of a page (:class:`_RankPages`);
a parcel (:meth:`_read_pages` / :meth:`_write_pages`) holds every kv
head, gathered over the tp group on export and cut per rank on import,
so it moves between a TP engine and a one-card engine either way. The
paged decode step runs inside ``ops/attention.tensor_parallel``, so its
paged kernel launches are kernel 4's (kernel 3 on the rank's shard).
Programs of a mesh engine run eagerly (``jit_model.eager_reason_for``).

Weight-only int8 (``quantize_weights=True``): the model's matmul weights
become int8 codes + f32 scales in place at construction
(``models/quant.py::quantize_tree``, idempotent — a model the deployment
quantized passes through, shared by every engine), and every product
reads the codes through ``ops/quant_matmul.int8_linear``: the same
programs and keys, captured the same way. The model owns its weights, so
an engine over an already quantized model serves int8 whatever it was
asked (:attr:`quantized` says which). A separate draft model is not
quantized. A self-draft (``draft_model`` is ``model``) drafts from the
target's weights as they were BEFORE ``quantize_tree``: the engine keeps
a full-precision copy of the module as the draft, as the reference's
self-draft keeps the caller's full-precision ``draft_params`` while only
the target's params are quantized. A model that arrives already quantized
has lost those weights, and a self-draft of it raises ``ValueError``
rather than drafting from the codes. Greedy tokens are the target's
either way; the acceptance rate is the reference's.

Speculative decoding (``draft_model``, ``spec_tokens``; greedy rows only):
a draft model — a second module with its own weights, or the target
module itself — proposes ``spec_tokens`` continuations per slot and the
target scores the whole window in ONE forward (:meth:`_spec_impl`); each
row accepts its longest matching prefix plus the target's own token, so a
round emits 1 to ``spec_tokens + 1`` tokens, exactly the plain greedy
stream. A sampled or penalised row sends the whole batch to a plain step,
after which the draft catches up on the tokens it did not see
(:meth:`_draft_catchup_impl`). The draft's cache is a slab of ``max_len +
spec_tokens + 1`` positions on every arm, filled beside every target
admission (its group prefill on the monolithic arms, otherwise a replay of
the whole prompt through its own chunk program). On the paged pool a
round's window writes into scratch pages drawn before the dispatch; the
accepted pages are spliced into the slot with no copy and the rejected
tail freed (:meth:`_splice_spec_pages`); a pool too tight for a window
makes the round one plain paged step (``spec_pool_fallbacks``).

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
timestamps the engine already takes (no device sync of its own); and
the prefix and session hit/miss families and the speculation families
(rounds, drafted / accepted / rejected tokens and the rolling acceptance,
tagged ``paged``).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import inspect
import math
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.engine.pagefabric import (
    PREFIX,
    STREAM,
    PageParcel,
    export_prefix_parcel,
    export_stream_parcel,
)
from ray_dynamic_batching_tpu_torch.engine.paging import (
    HostSpillTier,
    OutOfPages,
    PageAllocator,
    PagedPrefixCache,
    PagedSessionCache,
    PageEventJournal,
    digest_chain,
    pages_for,
    spec_scratch_pages,
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
from ray_dynamic_batching_tpu_torch.models.quant import (
    is_quantized,
    quantize_tree,
)
from ray_dynamic_batching_tpu_torch.ops import decode_attention as _decode_ops
from ray_dynamic_batching_tpu_torch.ops import quant_matmul as _quant_ops
from ray_dynamic_batching_tpu_torch.ops import graphs, jit_model
from ray_dynamic_batching_tpu_torch.utils.compile_ledger import (
    PHASE_WARMUP,
    get_ledger,
    instrument,
)
from ray_dynamic_batching_tpu_torch.utils.concurrency import OrderedLock
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
PREFIX_HITS = m.Counter(
    "rdb_decode_prefix_hits_total", "Prompt-prefix KV cache hits",
    # granularity: "chunk" = slab whole-segment byte equality, "page" =
    # paged longest-shared-page-prefix.
    tag_keys=("model", "granularity"),
)
PREFIX_MISSES = m.Counter(
    "rdb_decode_prefix_misses_total", "Prompt-prefix KV cache misses",
    tag_keys=("model", "granularity"),
)
SESSION_HITS = m.Counter(
    "rdb_decode_session_hits_total", "Session KV continuations",
    tag_keys=("model",),
)
SESSION_MISSES = m.Counter(
    "rdb_decode_session_misses_total",
    "Session requests without reusable KV", tag_keys=("model",),
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
# Speculation: the ``paged`` tag ("true"/"false") splits the slab and
# paged arms; accepted + rejected == drafted holds per round.
SPEC_ROUNDS = m.Counter(
    "rdb_decode_spec_rounds_total", "Speculative verify rounds",
    tag_keys=("model", "paged"),
)
SPEC_ACCEPTED = m.Counter(
    "rdb_decode_spec_accepted_total", "Draft tokens accepted by verify",
    tag_keys=("model", "paged"),
)
SPEC_DRAFTED = m.Counter(
    "rdb_decode_spec_drafted_total", "Draft tokens proposed to verify",
    tag_keys=("model", "paged"),
)
SPEC_REJECTED = m.Counter(
    "rdb_decode_spec_rejected_total", "Draft tokens rejected by verify",
    tag_keys=("model", "paged"),
)
SPEC_ACCEPTANCE = m.Gauge(
    "rdb_decode_spec_acceptance",
    "Rolling draft-token acceptance rate (accepted/drafted, bounded "
    "window)", tag_keys=("model", "paged"),
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
    session_id: Optional[str] = None        # store the turn on finish
    prompt_tokens: Optional[np.ndarray] = None  # session history head
    # Paged mode: the slot's physical page ids in logical order; the
    # first ``shared_pages`` are borrowed (refcounted) from a prefix or
    # session entry and never written by this slot.
    pages: List[int] = field(default_factory=list)
    shared_pages: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


@dataclass(eq=False)
class _RankPages:
    """One rank's host copy of a spilled page run (its kv-head shard on a
    mesh engine): what the spill tier holds on rank 0, each follower
    holding its own under the same handle (``parallel/spmd.py``)."""

    planes: Dict[str, torch.Tensor]


@dataclass
class _ChunkTrain:
    """One admission mid-chunked-prefill: the unit the token-budget
    scheduler advances between decode turns. The train HOLDS its slot
    (``_free_slots`` excludes it) and — paged — the pages granted so far
    (``opts["_pages"]``: a borrowed head, then per-chunk grants); ``pos``
    is the next position to prefill, ``base`` the first position the
    train computes (those below it were seeded from a prefix or session
    entry)."""

    req: Request
    prompt: np.ndarray
    opts: Dict
    slot_idx: int
    C: int                 # chunk width
    total: int             # prompt length (prefill ends here)
    pos: int = 0
    base: int = 0
    row: Any = None        # slab: the train's private row cache
    last: Any = None       # slab: the last chunk's take-row logits
    insert_prefix: bool = False  # slab: publish chunk 0 once computed


def bucket_up(value: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= value; None if value exceeds every bucket."""
    for b in sorted(buckets):
        if b >= value:
            return b
    return None


def _kv_planes(cache) -> Dict[str, torch.Tensor]:
    """A cache's per-position planes under the parcel's names: k and v,
    and on an int8 cache their scale planes — a copy that dropped the
    scales would reconstruct garbage KV."""
    out = {"k": cache.k, "v": cache.v}
    if cache.quantized:
        out.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    return out


def _planes(rows, cache):
    """(source, destination) pairs of every per-position plane."""
    return list(zip(_kv_planes(rows).values(), _kv_planes(cache).values()))


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
    attends). Shared by the target's long fill and the draft's."""
    S = cache.capacity
    for src, dst in _planes(row, cache):
        dst[:, slot] = src[:, 0, :S]
    cache.lengths[slot] = row.lengths[0]


def chunk_impl(model, tokens, attn_mask, row, start: int, take_idx: int):
    """One chunk of a prompt through ``model`` on its row cache: the
    draft long fill's chunk program (the draft has no pages-direct path,
    its cache being a slab, so every admission replays its prompt)."""
    return model.prefill_chunk(tokens, attn_mask, row, start, take_idx)


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


def run_chunk(chunk_fn, prompt: np.ndarray, pos: int, C: int, row):
    """One chunk of ``prompt`` from ``pos``: up to ``C`` tokens, the tail
    right-padded, through ``chunk_fn`` (host tensors in; the program
    uploads them). Returns (take-row logits, row, tokens taken)."""
    piece = prompt[pos: pos + C]
    tokmask = np.zeros((2, 1, C), dtype=np.int32)
    tokmask[0, 0, : piece.size] = piece
    tokmask[1, 0, : piece.size] = 1
    tokmask = torch.from_numpy(tokmask)
    last, row = chunk_fn(tokmask[0], tokmask[1], row, pos,
                         int(piece.size) - 1)
    return last, row, int(piece.size)


def run_chunked(chunk_fn, prompt: np.ndarray, C: int, row, between=None,
                start_chunk: int = 0, after_first=None, base: int = 0):
    """Host loop driving ``chunk_fn`` over ``prompt[base:]``: full-width
    chunks from global position ``base`` (seeded positions below it; it
    need not be chunk-aligned), a right-padded tail, ``between`` after
    every non-final chunk (the decode-interleave hook) and
    ``after_first`` on chunk 0 (the prefix-cache insert hook).
    ``start_chunk`` skips chunks a prefix seed already holds. Returns
    (last logits, row)."""
    n_chunks = (int(prompt.size) - base + C - 1) // C
    last = None
    for ci in range(start_chunk, n_chunks):
        last, row, _ = run_chunk(chunk_fn, prompt, base + ci * C, C, row)
        if ci == 0 and after_first is not None:
            after_first(row)
        if ci < n_chunks - 1 and between is not None:
            between()
    return last, row


class _DeviceLRU:
    """Bounded LRU whose values hold device tensors: dropping the last
    reference on eviction frees the memory. Shared mechanics of the slab
    prefix and session caches."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def _get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def _put(self, key, value) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


class PrefixCache(_DeviceLRU):
    """Device-resident LRU of prompt-prefix KV segments, chunk-granular:
    each entry is one chunk width's computed k/v (``[L, 1, C, K, H]``,
    with the scale planes on an int8 cache) keyed by the exact first C
    token ids; a hit seeds an admission's row cache with a copy instead
    of recomputing chunk 0."""

    def __init__(self, capacity: int, width: int):
        super().__init__(capacity)
        self.width = int(width)

    def _key(self, prompt: np.ndarray) -> bytes:
        return np.ascontiguousarray(prompt[: self.width]).tobytes()

    def lookup(self, prompt: np.ndarray) -> Optional[Tuple]:
        """(k, v, k_scale, v_scale) — scales None for a model-dtype
        cache."""
        return self._get(self._key(prompt))

    def insert(self, prompt: np.ndarray, k: torch.Tensor, v: torch.Tensor,
               k_scale=None, v_scale=None) -> None:
        key = self._key(prompt)
        if key not in self._entries:
            self._put(key, (k, v, k_scale, v_scale))


class SessionCache(_DeviceLRU):
    """Device-resident LRU of finished conversation turns, keyed by
    session id: the previous turn's cache row (prompt + generated tokens)
    is exactly the prefix KV of the next turn's prompt, so a hit seeds
    the admission with the stored row and prefills only the new tail.
    Entries hold one full row ([L, 1, S, K, H] k/v and scale planes)
    plus the token history for the prefix check."""

    def lookup(self, session_id: str, prompt: np.ndarray):
        """(k, v, k_scale, v_scale, history_len) when the stored turn is
        a strict prefix of ``prompt`` (>= 1 tail token left to
        prefill)."""
        entry = self._get(session_id)
        if entry is None:
            return None
        seg, history = entry
        n = int(history.size)
        if n >= prompt.size or not np.array_equal(history, prompt[:n]):
            return None
        return (*seg, n)

    def store(self, session_id: str, seg: Tuple,
              history: np.ndarray) -> None:
        """``seg`` is :meth:`DecodeEngine._extract_row_impl`'s (k, v,
        k_scale, v_scale)."""
        self._put(session_id, (seg, np.asarray(history, np.int32)))


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
    defaults to ``"cuda"``. ``draft_model`` (a CausalLM on the same
    device and of the same vocabulary, owning its weights — the target
    module itself for a self-draft) turns on speculative decoding with
    ``spec_tokens`` proposals a round.
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
        prefix_cache_size: int = 0,
        session_cache_size: int = 0,
        host_spill_pages: int = 0,
        draft_model: Any = None,
        spec_tokens: int = 4,
        quantize_weights: bool = False,
        mesh: Any = None,
    ):
        # What a follower rank needs to build this engine's twin.
        twin_kwargs = {k: v for k, v in locals().items()
                       if k not in ("self", "model", "queue", "device",
                                    "mesh", "draft_model")}
        from ray_dynamic_batching_tpu_torch.utils.compile_cache import (
            maybe_enable,
        )

        maybe_enable()  # kernel libraries built once are reused
        if mesh is not None and mesh.shape.get("tp", 1) > 1:
            model, draft_model = self._shard_for_mesh(
                model, mesh, paged=paged, draft_model=draft_model,
                quantize_weights=quantize_weights)
            device = mesh.device
        else:
            mesh = None
        self.mesh = mesh
        self._tp_key: Optional[str] = None
        self._tp_quiet = False
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine asked for "
                f"{self.device}"
            )
        if draft_model is not None:
            if draft_model.device != self.device:
                raise ValueError(
                    f"draft model lives on {draft_model.device}, engine "
                    f"asked for {self.device}")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                # A proposal must index the target's logits (and the
                # target's embedding: on the card an id past its table is
                # a device-side assert, not an error).
                raise ValueError(
                    f"draft vocab {draft_model.cfg.vocab_size} differs from "
                    f"the target's {model.cfg.vocab_size}")
        if draft_model is model and is_quantized(model):
            raise ValueError(
                "a self-draft of an already quantized model would draft "
                "from its int8 codes: the full-precision weights the draft "
                "reads are gone; quantize through this engine "
                "(quantize_weights=True) or pass a full-precision draft")
        if draft_model is model and quantize_weights:
            # The draft keeps the weights quantize_tree is about to
            # replace (the reference's draft_params stay full precision).
            draft_model = copy.deepcopy(model)
        if quantize_weights:
            quantize_tree(model)
        self.quantized = is_quantized(model)
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
        # Prompt-prefix KV reuse (0 = off; needs a prompt bucket): paged
        # engines reuse by page reference (longest shared page-prefix,
        # copy-on-write), slab engines keep chunk-granular device copies.
        self.prefix_cache: Optional[PrefixCache] = None
        self.paged_prefix: Optional[PagedPrefixCache] = None
        if prefix_cache_size > 0 and self.prompt_buckets:
            if self.paged:
                self.paged_prefix = PagedPrefixCache(
                    prefix_cache_size, self.page_size, self._allocator)
            else:
                self.prefix_cache = PrefixCache(prefix_cache_size,
                                                self.prompt_buckets[-1])
        # Device -> host-memory spill tier (0 = off; only beside a paged
        # prefix cache): a prefix entry shed under pool pressure keeps
        # its page contents in pinned host memory and reloads on the next
        # matching prompt instead of recomputing.
        self.host_spill: Optional[HostSpillTier] = None
        if host_spill_pages > 0 and self.paged_prefix is not None:
            # On a mesh every rank spills and reloads its own kv-head
            # shard of the pages; rank 0 keeps the accounting.
            self.host_spill = HostSpillTier(
                host_spill_pages, self._spill_read, self._spill_write,
                journal=self._page_journal)
        # Multi-turn session continuation (0 = off): the paged store pins
        # the finished slot's pages, the slab store copies its row.
        self.session_cache: Optional[SessionCache] = None
        self.paged_sessions: Optional[PagedSessionCache] = None
        if session_cache_size > 0:
            if self.paged:
                self.paged_sessions = PagedSessionCache(
                    session_cache_size, self.page_size, self._allocator)
            else:
                self.session_cache = SessionCache(session_cache_size)
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
        # Page-fabric mailboxes (live migration + prefix push): other
        # threads request work through them and the loop services them
        # between decode turns (:meth:`_service_fabric`). The lock takes
        # the "allocator" rank and is never held across queue or
        # request-future calls.
        self._fabric_lock = OrderedLock("allocator")
        self._migrate_out_q: List[Tuple[str, Callable]] = []
        self._push_out_q: List[Tuple[bytes, Callable]] = []
        self._parcel_in_q: List[PageParcel] = []
        self.migrated_out = 0
        self.migrated_in = 0
        self.pushes_out = 0
        self.pushes_in = 0
        self._thread: Optional[threading.Thread] = None
        self._run = threading.Event()
        self.steps = 0
        self.prefill_groups = 0      # monolithic prefill dispatches
        self.chunk_dispatches = 0    # chunk-train dispatches
        self.long_chunk_dispatches = 0   # long-fill chunk dispatches
        # What warmup dispatched on the target: prefill groups, chunks and
        # long-fill chunks, and decode substeps (each a forward of every
        # layer); a draft's warmup keys are not counted here.
        self.warmup_fills = 0
        self.warmup_steps = 0
        self.completed = 0
        self.last_heartbeat = time.monotonic()

        # The hot programs (ops/jit_model.py), created here as the
        # reference creates its jit programs; one graph pool and capture
        # stream for all of them.
        self._graphs = graphs.GraphSet(self.device)
        self._decode_fn = self._program("decode_step", self._decode_impl)
        self._prefill_fn = (
            self._program("prefill_group_paged", self._prefill_paged_impl)
            if self.paged
            else self._program("prefill_group", self._prefill_impl))
        self._chunk_paged_fn = self._program("chunk_prefill",
                                             self._chunk_group_paged_impl)
        self._zero_counts_fn = self._program("zero_counts",
                                             self._reset_counts)
        self._long_chunk_fn = self._program("long_chunk",
                                            self._prefill_chunk_impl)
        self._long_commit_fn = (
            self._program("long_commit_paged", self._commit_long_paged_impl)
            if self.paged
            else self._program("long_commit", self._commit_long_impl))
        # The reuse programs: row-cache copies, run eagerly (a row cache
        # is per fill), each warmed when its cache is on.
        self._prefix_seed_fn = self._program("prefix_seed",
                                             self._seed_prefix_impl)
        self._prefix_extract_fn = self._program("prefix_extract",
                                                self._extract_prefix_impl)
        self._paged_seed_fn = self._program("paged_seed",
                                            self._seed_paged_impl)
        self._session_seed_fn = self._program("session_seed",
                                              self._seed_session_impl)
        self._session_extract_fn = self._program("session_extract",
                                                 self._extract_row_impl)
        # Speculative decoding (greedy rows only): the draft's cache is a
        # SLAB on every arm, with headroom past max_len for the k + 1
        # positions a round drafts near the end (the pool's pages are
        # target-geometry tensors; the target-side KV of drafted tokens is
        # what pages, in scratch pages spliced on accept). It is engine
        # state the captured programs read, allocated once and updated in
        # place.
        self.draft_model = draft_model
        self.spec_tokens = max(1, int(spec_tokens))
        self._dcache = None
        # Rolling (accepted, drafted) pairs per round: the acceptance
        # gauge, spec_acceptance() and snapshot()["spec"].
        self._spec_acc_window: collections.deque = collections.deque(
            maxlen=512)
        # Paged: slot -> (first table index, scratch page ids) of the
        # round in flight, always resolved (spliced or freed) before the
        # round's harvest.
        self._spec_scratch: Dict[int, Tuple[int, List[int]]] = {}
        self.spec_rounds = 0          # verify rounds dispatched
        self.spec_pool_fallbacks = 0  # rounds made plain by a tight pool
        self.draft_catchups = 0       # catch-up dispatches after plain steps
        self.draft_prefill_groups = 0     # draft group prefills (mono)
        self.draft_chunk_dispatches = 0   # draft long-fill chunks
        if draft_model is not None:
            with torch.inference_mode():
                self._dcache = draft_model.make_cache(
                    num_slots, max_len + self.spec_tokens + 1)
            self._spec_fn = self._program("spec_verify", self._spec_impl)
            self._draft_catchup_fn = self._program(
                "draft_catchup", self._draft_catchup_impl)
            self._draft_prefill_fn = self._program(
                "draft_prefill", self._draft_prefill_impl)
            self._draft_long_chunk_fn = self._program(
                "draft_long_chunk", functools.partial(chunk_impl,
                                                      draft_model))
            self._draft_long_commit_fn = self._program(
                "draft_long_commit", functools.partial(commit_row,
                                                       self._dcache))
        # The decode kernels' merge scratch, sized for the largest launch
        # any program can make (decode over every slot; a prefill group,
        # chunk group or long-fill chunk of a bucket <= 8 takes the
        # decode kernels too; with a draft, the verify window on the
        # target, and the draft's steps, catch-up windows and fills on its
        # own shapes) before anything is captured, and held for as long
        # as the graphs that bake it in.
        self._workspace = None
        if self.device.type == "cuda":
            small = [b for b in self.prompt_buckets
                     if b <= _decode_ops.MAX_WINDOW_FOR_KERNEL]
            cap = self._paged_capacity if self.paged else max_len
            window = max([1] + small)
            shapes = [(model.cfg, max(cap, self._long_row_cap(chunk_w)))]
            if draft_model is not None:
                window = max(window, self.spec_tokens + 1,
                             min(self.decode_horizon,
                                 _decode_ops.MAX_WINDOW_FOR_KERNEL))
                shapes.append((draft_model.cfg,
                               -(-self._dcache.capacity // chunk_w)
                               * chunk_w))
            # Each reserve keeps the larger scratch, so the last one is
            # the device's entry and covers every shape.
            self._workspace = [
                _decode_ops.reserve(
                    self.device,
                    B=max(num_slots, self.max_admissions_per_step),
                    K=c.num_kv_heads, S=cap_, H=c.head_dim,
                    R=window * (c.num_heads // c.num_kv_heads))
                for c, cap_ in shapes]
            if self.quantized:
                self._workspace.append(_quant_ops.reserve(self.device))
        if self.mesh is not None and self.mesh.is_leader:
            from ray_dynamic_batching_tpu_torch.parallel import spmd

            self._tp_key = self.mesh.world.new_key("engine")
            spmd.attach_engine(
                self.mesh.world, self._tp_key, self.model.tp_shard.key,
                twin_kwargs, None if draft_model is None
                else draft_model.tp_shard.key)
            # Every rank's shared cache under one handle, so the reuse
            # programs can take it as an argument (World.encode).
            self._spmd("_own_cache")

    def _own_cache(self):
        return self._cache

    @staticmethod
    def _shard_for_mesh(model, mesh, *, paged: bool, draft_model,
                        quantize_weights: bool) -> Tuple[Any, Any]:
        """The reference's mesh refusals in its order, before any sharding
        work; then rank 0's shards of ``model`` and of ``draft_model``
        (each the model itself when it already is one): a self-draft is
        the target's shard, a draft with its own weights gets its own
        (reference ``decode.py:846-851``)."""
        from ray_dynamic_batching_tpu_torch.parallel import mesh as mesh_mod

        if paged and draft_model is not None:
            raise ValueError(
                "speculative decoding over a TP-mesh paged pool is not "
                "supported yet: run paged+spec on single-card replicas, "
                "or drop the draft model for mesh slices")
        if quantize_weights:
            raise ValueError(
                "quantize_weights with a TP mesh is not supported yet: "
                "sharding rules key on kernel paths, which quantization "
                "rewrites into codes and scales")
        if paged and not hasattr(model, "paged_cache_pspec"):
            raise ValueError(
                f"{getattr(model, 'name', type(model).__name__)}: "
                "paged=True on a TP mesh needs the model to define "
                "paged_cache_pspec (the pool's sharding layout) — see "
                "CausalLM.paged_cache_pspec")

        def shard_of(m):
            shard = getattr(m, "tp_shard", None)
            if shard is not None:
                if shard.mesh is not mesh:
                    raise ValueError(f"{m.name} is sharded over another mesh")
                return m
            if not mesh.is_leader:
                raise ValueError("a follower rank's engine takes its shard")
            return mesh_mod.shard_params(mesh, m)

        target = shard_of(model)
        if draft_model is None:
            return target, None
        if draft_model is model or draft_model is target:
            return target, target
        return target, shard_of(draft_model)

    def _spmd(self, attr: str, *args) -> Any:
        """``getattr(self, attr)(*args)``; on rank 0 of a mesh engine,
        run first on every follower's twin on the same inputs
        (``parallel/spmd.World.mirror``), outputs bound to handles."""
        fn = getattr(self, attr)
        if self._tp_key is None or self._tp_quiet:
            return fn(*args)
        return self.mesh.world.mirror(self._tp_key, attr, fn, args)

    def _program(self, name: str, impl: Callable) -> Callable:
        """``impl`` as the registry's program ``name``: its host-static
        arguments (by name, from the registry) form the key beside the
        input shapes, and it is captured unless ``jit_model.eager_reason_for``
        says why not (the registry's reason, or the mesh's); every call
        goes through the capture ledger. On rank 0 of a mesh engine a call
        runs on every follower's twin first (``World.mirror``, as
        :meth:`_spmd`)."""
        spec = jit_model.program(name)
        params = list(inspect.signature(impl).parameters)
        static = [params.index(a) for a in spec.static]
        backend = self.mesh.backend if self.mesh is not None else None
        runner = instrument(name, self._graphs.program(
            name, impl, static,
            eager=bool(jit_model.eager_reason_for(name, backend))))
        if self.mesh is None or not self.mesh.is_leader:
            return runner

        def on_every_rank(*args):
            if self._tp_key is None or self._tp_quiet:
                return runner(*args)
            return self.mesh.world.mirror(self._tp_key, spec.attr, runner,
                                          args)

        return on_every_rank

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

    def _prefill_rows(self, tokmask, meta_i, meta_f, bias_ids, bias_vals,
                      any_sampled: bool,
                      write_pids: Optional[torch.Tensor]) -> torch.Tensor:
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
        if write_pids is not None:
            copy_rows_into_paged(self._cache, rows, slots.long(), write_pids)
        else:
            copy_rows_into(self._cache, rows, slots.long())
        return self._sample_tokens(
            last_logits, temps, topk, seeds, torch.zeros_like(slots),
            bias_ids, bias_vals, topp, any_sampled,
        )

    @torch.inference_mode()
    def _prefill_impl(self, tokmask, meta_i, meta_f, bias_ids, bias_vals,
                      any_sampled: bool) -> torch.Tensor:
        """The slab group prefill (:meth:`_prefill_rows`)."""
        return self._prefill_rows(tokmask, meta_i, meta_f, bias_ids,
                                  bias_vals, any_sampled, None)

    @torch.inference_mode()
    def _prefill_paged_impl(self, tokmask, meta_i, meta_f, bias_ids,
                            bias_vals, write_pids,
                            any_sampled: bool) -> torch.Tensor:
        """The paged group prefill: rows cut into the pages ``write_pids``
        [nB, NP] names (:meth:`_prefill_rows`)."""
        return self._prefill_rows(tokmask, meta_i, meta_f, bias_ids,
                                  bias_vals, any_sampled, write_pids)

    @torch.inference_mode()
    def _prefill_chunk_impl(self, tokens, attn_mask, row, start: int,
                            take_idx: int):
        """One chunk on a private row cache (the long fill's and the slab
        trains'); the caller counts it."""
        return self.model.prefill_chunk(tokens, attn_mask, row, start,
                                        take_idx)

    @torch.inference_mode()
    def _commit_long_impl(self, row, slot: int, meta_i, last_logits,
                          meta_f, bias_ids, bias_vals,
                          any_sampled: bool) -> torch.Tensor:
        """Close a slab long fill: the finished row into the shared cache
        at ``slot``, cut to capacity, then the first token sampled.
        ``meta_i`` [3] packs slot / top_k / seed, ``meta_f`` [2]
        temperature / top_p (the token index of a first sample is 0)."""
        commit_row(self._cache, row, slot)
        return self._sample_first(meta_i, last_logits, meta_f, bias_ids,
                                  bias_vals, any_sampled)

    @torch.inference_mode()
    def _commit_long_paged_impl(self, row, meta_i, last_logits, meta_f,
                                bias_ids, bias_vals, write_pids,
                                any_sampled: bool) -> torch.Tensor:
        """Close a paged long fill: the finished row cut into the pages
        ``write_pids`` [1, NP] names, then the first token sampled."""
        copy_rows_into_paged(self._cache, row, meta_i[0:1].long(),
                             write_pids)
        return self._sample_first(meta_i, last_logits, meta_f, bias_ids,
                                  bias_vals, any_sampled)

    def _sample_first(self, meta_i, last_logits, meta_f, bias_ids,
                      bias_vals, any_sampled: bool) -> torch.Tensor:
        return self._sample_tokens(
            last_logits, meta_f[0:1], meta_i[1:2], meta_i[2:3],
            torch.zeros_like(meta_i[0:1]), bias_ids, bias_vals, meta_f[1:2],
            any_sampled,
        )

    # --- the reuse programs: row-cache seeds and extracts ------------------
    @torch.inference_mode()
    def _seed_prefix_impl(self, row_cache, pk, pv, pks, pvs):
        """Copy a cached prefix segment into positions [0, C) of a fresh
        row cache, in place (the copy that replaces recomputing chunk 0);
        its valid length is its width."""
        return self._seed_session_impl(row_cache, pk, pv, pks, pvs,
                                       pk.shape[2])

    @torch.inference_mode()
    def _extract_prefix_impl(self, row_cache, width: int):
        """Copies of the row cache's first ``width`` positions (the chunk
        0 just computed), scale planes included on an int8 cache."""
        out = [p[:, :, :width].clone()
               for p in _kv_planes(row_cache).values()]
        return tuple(out + [None] * (4 - len(out)))

    @torch.inference_mode()
    def _seed_session_impl(self, row_cache, ek, ev, eks, evs, elen: int):
        """Copy a stored row (``[L, 1, n, K, H]`` k/v, and on an int8
        cache its scale planes) into positions [0, n) of a fresh row
        cache, in place, and mark ``elen`` positions valid."""
        n = ek.shape[2]
        for src, dst in zip((ek, ev, eks, evs),
                            _kv_planes(row_cache).values()):
            dst[:, :, :n].copy_(src)
        row_cache.lengths.fill_(int(elen))
        return row_cache

    @torch.inference_mode()
    def _extract_row_impl(self, cache, slot: int):
        """Copies of one slot's full row of the shared slab cache (the
        finished turn's KV, stored for the session's next turn)."""
        out = [p[:, slot:slot + 1].clone()
               for p in _kv_planes(cache).values()]
        return tuple(out + [None] * (4 - len(out)))

    @torch.inference_mode()
    def _seed_paged_impl(self, row_cache, cache, table_row, elen: int):
        """Gather a page run (``table_row`` [NP] int32, sentinel-padded:
        the sentinel is the pool's sink page) into positions [0, S) of a
        fresh row cache, in place, and mark ``elen`` valid — how a mono
        borrower sees its shared prefix during the tail prefill. Past
        ``elen`` the row holds garbage that the tail overwrites or the
        mask never attends."""
        S = self._paged_capacity
        idx = table_row.long()
        for src, dst in _planes(cache, row_cache):
            g = src.index_select(1, idx)       # [L, NP, ps, ...]
            dst[:, :, :S].copy_(g.reshape((g.shape[0], 1, S)
                                          + tuple(g.shape[3:])))
        row_cache.lengths.fill_(int(elen))
        return row_cache

    @torch.inference_mode()
    def _chunk_group_paged_impl(self, tokmask, tables, meta_i, meta_f,
                                bias_ids, bias_vals,
                                any_sampled: bool) -> torch.Tensor:
        """One pages-direct chunk program for a group of chunk trains:
        row i is one train's next ``<= W``-token chunk, its k/v written
        straight through its own table row ``tables[i]`` into the pages
        granted for it, its read the staircase window from its own start.
        The first token is sampled for every row (only final rows' are
        used). ``meta_i`` [6, g] packs start / take_idx / top_k / seed /
        slot / prompt length (-1 on a row whose prompt does not end in
        this chunk: its slot's length is written back unchanged);
        ``meta_f`` [2, g] temperature / top_p."""
        tokens, attn_mask = tokmask[0], tokmask[1]
        starts, take_idx, topk, seeds = meta_i[0], meta_i[1], meta_i[2], \
            meta_i[3]
        temps, topp = meta_f[0], meta_f[1]
        taken, _ = self.model.prefill_chunk_paged(
            tokens, attn_mask, self._cache, tables, starts, take_idx)
        # Only a final chunk publishes its prompt's length.
        lengths = self._cache.lengths
        slots = meta_i[4].long()
        lengths.index_copy_(0, slots, torch.where(
            meta_i[5] >= 0, meta_i[5], lengths.index_select(0, slots)))
        return self._sample_tokens(
            taken, temps, topk, seeds, torch.zeros_like(starts), bias_ids,
            bias_vals, topp, any_sampled,
        )

    @torch.inference_mode()
    def _reset_counts(self, slot_tok) -> None:
        """Fresh tenant: zero the reused counts row, then count the
        prefill-sampled first token (the scan counts only the tokens it
        samples itself). ``slot_tok`` [2] int32: slot, first token."""
        slot = slot_tok[0:1].long()
        self._counts.index_fill_(0, slot, 0)
        self._counts.index_put_(
            (slot, slot_tok[1:2].long()),
            torch.ones((1,), dtype=torch.int32, device=self._counts.device))

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
        if self.paged and self.mesh is not None:
            # The paged read of a TP slice: kernel 3 per kv-head shard.
            step_fn = functools.partial(
                self._tp_paged_step, self.model.decode_step_paged)
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

    def _tp_paged_step(self, step_fn, *args):
        """``step_fn(*args)`` inside the mesh's ``tensor_parallel``
        context (reference ``decode.py:1151-1160``)."""
        from ray_dynamic_batching_tpu_torch.ops.attention import (
            tensor_parallel,
        )

        with tensor_parallel(self.mesh, "tp",
                             self.model.tp_shard.heads_split):
            return step_fn(*args)

    @torch.inference_mode()
    def _spec_impl(self, step_state, bias_ids, bias_vals) -> torch.Tensor:
        """One speculative round for the whole batch, greedy-exact.
        ``step_state`` [2, B] int32 packs pending tokens and the active
        mask.

        The draft runs ``k + 1`` single-token steps (proposing d_1..d_k
        and keeping its own cache complete through d_k), the target
        scores the [t0, d_1..d_k] window in one verify forward, and each
        row accepts its longest matching prefix plus the target's own
        next token: 1 to k + 1 tokens, never other than what plain greedy
        decode would emit. Rows past capacity emit only the tokens whose
        k/v landed. Returns packed int32 [k + 3, B]: k + 1 output-token
        rows, the count row and the post-round lengths row (one fetch)."""
        tokens = step_state[0][:, None]
        active = step_state[1].bool()
        k = self.spec_tokens
        B = tokens.shape[0]
        cache, dcache = self._cache, self._dcache
        dlen0 = dcache.lengths.clone()
        drafts, tok = [], tokens
        for _ in range(k + 1):
            logits, _ = self.draft_model.decode_step(tok, dcache, active)
            nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            nxt = torch.where(active, nxt, tok[:, 0])
            drafts.append(nxt)
            tok = nxt[:, None]
        # The last proposal is drafted only to keep the draft cache
        # complete; it is never verified.
        d = torch.stack(drafts[:k], dim=1)                       # [B, k]
        window = torch.cat([tokens, d], dim=1)                   # [B, k+1]
        verify = (self.model.verify_step_paged if self.paged
                  else self.model.verify_step)
        logits, _ = verify(window, cache, active)
        logits = logits.float()
        # The plain path's bias, broadcast over the window, so biased
        # greedy stays exact.
        dense_bias = self._apply_bias(
            torch.zeros((B, logits.shape[-1]), device=logits.device),
            bias_ids, bias_vals)
        greedy = torch.argmax(logits + dense_bias[:, None, :],
                              dim=-1).to(torch.int32)            # [B, k+1]
        match = (d == greedy[:, :k]).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1)               # accepted
        # Capacity clamp: only tokens whose k/v landed may count.
        remaining = torch.clamp(self.max_len - cache.lengths, min=0)
        n_out = torch.where(active, torch.minimum(m + 1, remaining),
                            torch.zeros_like(remaining)).to(torch.int32)
        gm = torch.gather(greedy, 1, m[:, None])                 # [B, 1]
        d_pad = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
        j_idx = torch.arange(k + 1, device=d.device)[None, :]
        out = torch.where(j_idx < m[:, None], d_pad, gm)         # [B, k+1]
        cache.lengths.add_(n_out)
        # The draft tracked the same sequence: its lengths roll back to
        # the verified prefix (past them its k/v are garbage that is
        # overwritten before anything attends it).
        dcache.lengths.copy_(dlen0 + n_out)
        return torch.cat([out.t(), n_out[None, :], cache.lengths[None, :]],
                         dim=0)

    @torch.inference_mode()
    def _draft_catchup_impl(self, window, active, counts) -> None:
        """Write the draft k/v of the tokens the target just decoded
        plainly (``window`` [B, h] at each row's own draft length) and
        advance the draft lengths by each row's advanced count: the draft
        stays in step with the sequence without influencing it."""
        self.draft_model.verify_step(window, self._dcache, active)
        self._dcache.lengths.add_(
            torch.where(active, counts, torch.zeros_like(counts)))

    @torch.inference_mode()
    def _draft_prefill_impl(self, tokmask, meta_i) -> None:
        """The draft's rows for a monolithic prefill group: the target
        group's packed inputs (``tokmask`` [2, nB, T], ``meta_i`` [3, nB]
        with the slots in row 0) through the draft on a fresh row cache,
        copied into the draft cache at the slots (no sampling: the draft
        only ever proposes from its cache)."""
        nB = tokmask.shape[1]
        rows = self.draft_model.make_cache(nB, self._dcache.capacity)
        _, rows = self.draft_model.prefill(tokmask[0], tokmask[1], rows)
        copy_rows_into(self._dcache, rows, meta_i[0].long())

    def warmup(self) -> None:
        """Build the kernels and run every key the arm can dispatch, so
        that each hot program is captured before serving (the reference
        compiles its jit programs here): :meth:`_warmup_impl`.

        The whole run is bracketed by the capture ledger's warmup phase —
        ``end_warmup`` arms the steady-state mark, after which any capture
        is a recorded violation — and the engine's programs are sealed:
        on the card a key first seen later raises. The ledger's warmup
        counts are cross-checked against ``ops/jit_model.required_for``:
        a registered program this arm needs that warmup did not run
        raises HERE, at startup."""
        if self._tp_key is not None and not self._tp_quiet:
            # Every rank warms its own twin, the same keys in the same
            # order (warmup reads no host state but the configuration);
            # rank 0 sends none of it and holds the world meanwhile.
            return self.mesh.world.mirror(self._tp_key, "warmup",
                                          self._warmup_here, ())
        ledger = get_ledger()
        before = ledger.counts(phase=PHASE_WARMUP)
        ledger.begin_warmup()
        try:
            with self._device_ctx():
                self._warmup_impl()
        finally:
            ledger.end_warmup()
        self._graphs.seal()
        after = ledger.counts(phase=PHASE_WARMUP)
        if after == before:
            # Nothing new: every key was already captured (this engine
            # was warmed before) — nothing to cross-check.
            return
        required = jit_model.required_for(
            self.chunked_prefill, self.paged, self.draft_model is not None)
        gaps = [
            p.name for p in required
            if after.get(p.name, 0) <= before.get(p.name, 0)
        ]
        if gaps:
            raise RuntimeError(
                f"warmup coverage gap: registered hot-path program(s) "
                f"{gaps} compiled nothing during warmup — the warmup "
                "routine and ops/jit_model.required_for disagree; fix "
                "whichever is wrong before this engine serves"
            )

    def _warmup_here(self) -> None:
        self._tp_quiet = True
        try:
            self.warmup()
        finally:
            self._tp_quiet = False

    def _warmup_impl(self) -> None:
        """The arm's admission programs — the (bucket x group) prefill
        grid on monolithic arms; on the paged chunked arm the chunk
        program at every bucket width and every group size up to
        ``min(max_admissions_per_step, budget // W)`` (the largest
        bucket's group of 1 is the multi-chunk train's shape); on the
        slab chunked arm its one row-cache chunk and commit, which the
        monolithic arms also warm when a prompt past the largest bucket
        fits — each with greedy and with sampled rows; then the decode
        keys (:meth:`_warmup_decode`, with a draft its verify, catch-up
        and prefill keys and the draft's long-fill pair). Paged warmup
        writes through all-sentinel tables (every write lands in the sink
        page; no page is allocated), so the allocator is untouched. The
        lengths (the draft's too) and counts are reset afterwards, in
        place."""
        if self.device.type == "cuda":
            from ray_dynamic_batching_tpu_torch.ops import _build

            _build.build()
        if self.chunked_prefill and self.paged:
            self._warmup_chunks()
        elif self.chunked_prefill:
            self._warmup_long_fill()
        else:
            self._warmup_prefill_groups()
            if self._mono_long_fills():
                self._warmup_long_fill()
        self._warmup_reuse()
        self._warmup_decode()
        with torch.inference_mode():
            self._cache.lengths.zero_()
            self._counts.zero_()
            if self._dcache is not None:
                self._dcache.lengths.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mono_long_fills(self) -> bool:
        """A monolithic engine can take the long fill: a prompt past the
        largest bucket fits, or a session continuation (which takes the
        long fill's chunk and commit whatever the prompt's length)."""
        return (self.prompt_buckets[-1] + 1 < self.max_len
                or self.session_cache is not None
                or self.paged_sessions is not None)

    def _warmup_inputs(self, b: int, g: int, sampled: bool):
        """Host inputs of a (bucket, group) admission program: all-zero
        prompts of full masks, top_p 1, greedy or (temperature 1)
        sampled rows, no bias."""
        tokmask = torch.stack([torch.zeros((g, b), dtype=torch.int32),
                               torch.ones((g, b), dtype=torch.int32)])
        meta_f = torch.ones((2, g))
        meta_f[0] = float(sampled)
        K = self.max_bias_entries
        return (tokmask, meta_f, torch.zeros((g, K), dtype=torch.int32),
                torch.zeros((g, K)))

    def _sentinel_table(self, g: int) -> torch.Tensor:
        return torch.full((g, self._n_table_entries), self.num_pages,
                          dtype=torch.int32)

    def _warmup_prefill_groups(self) -> None:
        for b in self.prompt_buckets:
            for g in range(1, self.max_admissions_per_step + 1):
                for sampled in (False, True):
                    tokmask, meta_f, bids, bvals = self._warmup_inputs(
                        b, g, sampled)
                    meta_i = torch.zeros((3, g), dtype=torch.int32)
                    meta_i[0] = torch.arange(g) % self.num_slots
                    extra = ((self._sentinel_table(g),) if self.paged
                             else ())
                    self._prefill_fn(tokmask, meta_i, meta_f, bids, bvals,
                                     *extra, sampled)
                    self.warmup_fills += 1

    def _warmup_chunks(self) -> None:
        for b in self.prompt_buckets:
            top = min(self.max_admissions_per_step,
                      self.prefill_token_budget // b)
            for g in range(1, top + 1):
                for sampled in (False, True):
                    tokmask, meta_f, bids, bvals = self._warmup_inputs(
                        b, g, sampled)
                    meta_i = torch.zeros((6, g), dtype=torch.int32)
                    meta_i[4] = torch.arange(g) % self.num_slots
                    meta_i[5] = -1
                    self._chunk_paged_fn(tokmask, self._sentinel_table(g),
                                         meta_i, meta_f, bids, bvals,
                                         sampled)
                    self.warmup_fills += 1

    def _warmup_long_fill(self) -> None:
        """One chunk of the largest bucket on a row cache and one commit
        (paged: through an all-sentinel table); both run eagerly, so one
        key each."""
        C = self.prompt_buckets[-1]
        with torch.inference_mode():
            row = self.model.make_cache(1, self._long_row_cap(C))
        last, row, _ = run_chunk(self._long_chunk_fn,
                                 np.zeros((C,), np.int32), 0, C, row)
        self.warmup_fills += 1
        _tokmask, meta_f, bids, bvals = self._warmup_inputs(C, 1, False)
        meta_i = torch.zeros((3,), dtype=torch.int32)
        if self.paged:
            self._long_commit_fn(row, meta_i, last, meta_f[:, 0], bids,
                                 bvals, self._sentinel_table(1), False)
        else:
            self._long_commit_fn(row, 0, meta_i, last, meta_f[:, 0], bids,
                                 bvals, False)

    def _warmup_reuse(self) -> None:
        """The reuse programs this engine can dispatch, once each (one
        key apiece), on a throwaway row cache: the chunk-granular seed
        and extract beside a slab prefix cache, the row seed and extract
        beside a slab session cache, the page-run seed on a mono paged
        engine with a prefix or session cache (the chunked paged arm
        borrows pages and seeds nothing)."""
        C = self.prompt_buckets[-1]
        with torch.inference_mode():
            row = self.model.make_cache(1, self._long_row_cap(C))
        if self.prefix_cache is not None:
            seg = self._prefix_extract_fn(row, C)
            self._prefix_seed_fn(row, *seg)
        if self.session_cache is not None:
            seg = self._session_extract_fn(self._cache, 0)
            self._session_seed_fn(row, *seg, 0)
        if (self.paged and not self.chunked_prefill
                and (self.paged_prefix is not None
                     or self.paged_sessions is not None)):
            self._paged_seed_fn(row, self._cache,
                                self._sentinel_table(1)[0], 0)

    def _warmup_decode(self) -> None:
        """Every decode key ``_step`` can dispatch: horizons {1,
        ttft_horizon, decode_horizon} x greedy or sampled rows x
        penalties off or on (the reference decides the last two at run
        time; the port on the host), over all-inactive slots; then the
        counts reset of a fresh penalised tenant."""
        samp_f, samp_i, bias_ids, bias_vals = self._sampling_arrays()
        for h in sorted({1, self.ttft_horizon, self.decode_horizon}):
            for sampled in (False, True):
                for penalty in (False, True):
                    self._decode_fn(
                        torch.zeros((3, self.num_slots), dtype=torch.int32),
                        h, samp_f, samp_i, bias_ids, bias_vals, sampled,
                        penalty)
                    self.warmup_steps += h
        self._zero_counts_fn(torch.zeros((2,), dtype=torch.int32))
        if self._dcache is not None:
            self._warmup_spec()

    def _warmup_spec(self) -> None:
        """Every key a draft adds: the draft's group prefill over the
        (bucket x group) grid on monolithic arms, one verify round, the
        catch-up window of each decode horizon, and — wherever an
        admission replays its prompt through the draft (every chunked
        admission, and a mono long fill or session fill) — one draft
        long-fill chunk and commit, all over all-inactive slots."""
        B = self.num_slots
        if not self.chunked_prefill:
            for b in self.prompt_buckets:
                for g in range(1, self.max_admissions_per_step + 1):
                    tokmask, _f, _ids, _vals = self._warmup_inputs(
                        b, g, False)
                    meta_i = torch.zeros((3, g), dtype=torch.int32)
                    meta_i[0] = torch.arange(g) % B
                    self._draft_prefill_fn(tokmask, meta_i)
        _f, _i, bias_ids, bias_vals = self._sampling_arrays()
        self._spec_fn(torch.zeros((2, B), dtype=torch.int32), bias_ids,
                      bias_vals)
        for h in sorted({1, self.ttft_horizon, self.decode_horizon}):
            self._draft_catchup_fn(torch.zeros((B, h), dtype=torch.int32),
                                   torch.zeros((B,), dtype=torch.bool),
                                   torch.zeros((B,), dtype=torch.int32))
        if self.chunked_prefill or self._mono_long_fills():
            self._draft_long_fill(np.zeros((self.prompt_buckets[-1],),
                                           np.int32), 0, warm=True)

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
            "session_id": None,   # multi-turn KV continuation key
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
                if p.get("session_id") is not None:
                    opts["session_id"] = str(p["session_id"])
                    opts["_prompt_tokens"] = prompt
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
        session_items: List[Tuple[Request, np.ndarray, Dict, Tuple]] = []
        sessions = self.paged_sessions if self.paged else self.session_cache
        for req in batch:
            req.admit_ms = t_dequeue
            try:
                prompt, bucket, opts = self._prep_prompt(req)
            except Exception as e:  # noqa: BLE001 — bad prompt must not kill loop
                req.reject(e)
                continue
            hit = None
            if sessions is not None and opts["session_id"]:
                hit = sessions.lookup(opts["session_id"], prompt)
                if hit is not None and self.paged:
                    # Seed-read hold, taken at lookup: a long fill of this
                    # round interleaves decode steps whose finishes can
                    # store new turns and evict this entry; the hold keeps
                    # its pages until the seed has read them, and lets the
                    # reservation below cover only the non-shared tail.
                    self._allocator.incref(hit[0])
                    opts["_session_hold"] = list(hit[0])
                    opts["_session_share"] = hit[1] // self.page_size
                if hit is None:
                    # Counted once, at registration (a requeue re-looks
                    # up).
                    opts["_session_miss"] = True
            if self.paged and not self._alloc_admission_pages(
                    req, prompt, opts):
                continue  # page-starved: requeued (or refused) inside
            if hit is not None:
                session_items.append((req, prompt, opts, hit))
                continue
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
        # Long prompts and session continuations fill one by one after the
        # groups; past the free slots they go back to the queue untouched
        # (pages re-granted at their next admission).
        session_fill = (self._prefill_session_paged if self.paged
                        else self._prefill_session)
        singles = ([(self._prefill_long, (req, prompt, opts))
                    for req, prompt, opts in long_items]
                   + [(session_fill, (req, prompt, opts, hit))
                      for req, prompt, opts, hit in session_items])
        for fill, args in singles:
            req, opts = args[0], args[2]
            if admitted >= len(free):
                self._release_pages(opts)
                self._requeue(req, "chunked admission")
                continue
            try:
                fill(*args, free[admitted])
            except Exception as e:  # noqa: BLE001 — same no-dangle rule
                logger.exception("%s: chunked fill failed", self.model.name)
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
        extra = ()
        if self.paged:
            # Physical destination pages per row (sentinel tail).
            extra = (torch.from_numpy(np.stack([
                table_array(opts["_pages"], self._n_table_entries,
                            self.num_pages) for _r, _p, opts in items
            ])),)
        tokmask = torch.from_numpy(np.stack([tokens, mask]))
        meta_i = torch.from_numpy(meta_i)
        first = self._prefill_fn(
            tokmask, meta_i, torch.from_numpy(meta_f),
            torch.from_numpy(bias_ids), torch.from_numpy(bias_vals),
            *extra, bool((meta_f[0] > 0).any()),
        )
        if self._dcache is not None:
            # The draft must see the same prompts: its rows too.
            self._draft_prefill_fn(tokmask, meta_i)
            self.draft_prefill_groups += 1
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

    def _long_chunk(self, *args):
        """The long fill's chunk program, counted."""
        self.long_chunk_dispatches += 1
        return self._long_chunk_fn(*args)

    def _new_row(self):
        return self._spmd("_make_row")

    def _make_row(self):
        with torch.inference_mode():
            return self.model.make_cache(
                1, self._long_row_cap(self.prompt_buckets[-1]))

    def _prefill_long(self, req: Request, prompt: np.ndarray, opts: Dict,
                      slot_idx: int) -> None:
        """Admit one prompt longer than every bucket: prefill it in chunks
        of the largest bucket into a private single-row cache, one decode
        step for the active batch between chunks, then ONE commit (row into
        the shared cache + first-token sample) and registration. Paged
        engines granted the prompt's pages at admission; the commit cuts
        the row into them.

        With a prefix cache the fill reuses: paged, the longest shared
        page-prefix is borrowed by reference (the tail is recomputed into
        private pages, the row seeded from the borrowed pages) and the
        prompt's own full pages are published once committed; slab, a
        cached first chunk seeds the row and chunk 0 is skipped, or a
        computed chunk 0 is published."""
        C = self.prompt_buckets[-1]
        row = self._new_row()
        start_chunk = base = 0
        after_first = after_commit = None
        model_tag = {"model": self.model.name}
        if self.paged_prefix is not None:
            hit = self.paged_prefix.lookup(prompt)
            if hit is None and self.host_spill is not None:
                hit = self._reload_spilled_prefix(prompt)
            if hit is not None:
                shared_ids, shared_len = hit
                self._swap_in_shared(opts, shared_ids)
                row = self._paged_seed_fn(
                    row, self._cache, torch.from_numpy(table_array(
                        shared_ids, self._n_table_entries, self.num_pages)),
                    shared_len)
                base = shared_len
                PREFIX_HITS.inc(tags={**model_tag, "granularity": "page"})
            else:
                PREFIX_MISSES.inc(tags={**model_tag, "granularity": "page"})

            def after_commit():
                self.paged_prefix.insert(prompt, opts["_pages"])
        elif self.prefix_cache is not None:
            # Chunk 0 is full (a long prompt has two chunks or more), so
            # its k/v depend only on the first C token ids.
            hit = self.prefix_cache.lookup(prompt)
            if hit is not None:
                row = self._prefix_seed_fn(row, *hit)
                start_chunk = 1
                PREFIX_HITS.inc(tags={**model_tag, "granularity": "chunk"})
            else:
                def after_first(r):
                    self.prefix_cache.insert(
                        prompt, *self._prefix_extract_fn(r, C))
                PREFIX_MISSES.inc(tags={**model_tag,
                                        "granularity": "chunk"})
        last, row = run_chunked(self._long_chunk, prompt, C, row,
                                between=self._interleave_step,
                                start_chunk=start_chunk,
                                after_first=after_first, base=base)
        self._commit_and_register(req, prompt, opts, slot_idx, row, last,
                                  after_commit=after_commit)

    def _make_draft_row(self):
        C = self.prompt_buckets[-1]
        with torch.inference_mode():
            return self.draft_model.make_cache(
                1, -(-self._dcache.capacity // C) * C)

    def _draft_long_fill(self, prompt: np.ndarray, slot_idx: int,
                         warm: bool = False) -> None:
        """The whole prompt through the draft's chunk program (chunks of
        the largest bucket from position 0, the draft keeping no stored
        row) into a private draft row, one decode step for the active
        batch between chunks as the target's fill interleaves them, then
        the row committed into the draft cache at ``slot_idx``. ``warm``
        (warmup): no interleave, and the chunks are not counted in
        ``draft_chunk_dispatches``."""
        C = self.prompt_buckets[-1]
        row = self._spmd("_make_draft_row")

        def chunk(*args):
            if not warm:
                self.draft_chunk_dispatches += 1
            return self._draft_long_chunk_fn(*args)

        _, row = run_chunked(
            chunk, prompt, C, row,
            between=None if warm else self._interleave_step)
        self._draft_long_commit_fn(row, slot_idx)

    def _commit_and_register(self, req: Request, prompt: np.ndarray,
                             opts: Dict, slot_idx: int, row, last,
                             after_commit=None) -> None:
        """Shared tail of every row-cache admission (the long fill, a
        session fill, a slab train's final chunk): ONE commit (the row into
        the shared cache + first-token sample), ``after_commit`` (the paged
        prefix publish, which must see committed pages and run before a
        stop-on-first-token registration frees them), the draft's replay
        of the whole ``prompt`` when a draft rides along, then
        registration. Paged: borrowed head pages are steered to the sink
        page, so the commit never rewrites a shared page."""
        bids, bvals = self._bias_arrays(opts)
        meta_i = torch.tensor([slot_idx, opts["top_k"], opts["seed"]],
                              dtype=torch.int32)
        meta_f = torch.tensor([opts["temperature"], opts["top_p"]],
                              dtype=torch.float32)
        sampled = opts["temperature"] > 0
        if self.paged:
            shared = int(opts.get("_shared_pages", 0))
            wp = list(opts["_pages"])
            wp[:shared] = [self.num_pages] * shared
            pids = torch.from_numpy(table_array(
                wp, self._n_table_entries, self.num_pages)[None])
            first = self._long_commit_fn(
                row, meta_i, last, meta_f, torch.from_numpy(bids[None]),
                torch.from_numpy(bvals[None]), pids, sampled)
        else:
            first = self._long_commit_fn(
                row, slot_idx, meta_i, last, meta_f,
                torch.from_numpy(bids[None]), torch.from_numpy(bvals[None]),
                sampled)
        first_tok = int(first.cpu()[0])
        if after_commit is not None:
            after_commit()
        if self._dcache is not None:
            self._draft_long_fill(prompt, slot_idx)
        self._register(slot_idx, req, first_tok, opts, now_ms())

    def _prefill_session(self, req: Request, prompt: np.ndarray, opts: Dict,
                         hit: Tuple, slot_idx: int) -> None:
        """Continue a conversation from its stored row (slab): seed the row
        cache with the previous turn, chunk-prefill only the new tail from
        the stored length (not chunk-aligned), and commit."""
        ek, ev, eks, evs, elen = hit
        SESSION_HITS.inc(tags={"model": self.model.name})
        row = self._session_seed_fn(self._new_row(), ek, ev, eks, evs, elen)
        last, row = run_chunked(self._long_chunk, prompt,
                                self.prompt_buckets[-1], row,
                                between=self._interleave_step, base=elen)
        self._commit_and_register(req, prompt, opts, slot_idx, row, last)

    def _swap_in_shared(self, opts: Dict, shared_ids: List[int]) -> None:
        """Copy-on-write borrow at a mono fill: pin the shared pages, hand
        back the equivalent leading private pages reserved at admission,
        and splice — ``opts["_pages"]`` stays the slot's full logical run,
        ``_shared_pages`` marking the borrowed (never written) head.
        Incref before decref, so no page passes through refcount 0."""
        n = len(shared_ids)
        pages = opts["_pages"]
        self._allocator.incref(shared_ids)
        self._allocator.decref(pages[:n])
        opts["_pages"] = list(shared_ids) + pages[n:]
        opts["_shared_pages"] = n
        self._page_journal.record(
            "cow_copy", n, self._allocator.allocated_pages, source="prefix")

    def _prefill_session_paged(self, req: Request, prompt: np.ndarray,
                               opts: Dict, hit: Tuple,
                               slot_idx: int) -> None:
        """Paged session continuation (mono): borrow the stored turn's FULL
        pages by reference, seed the row from the whole stored run (the
        boundary page's content rides into the row; the commit writes its
        private copy — the copy-on-write), prefill only the new tail and
        commit the tail pages as private. The admission's hold pinned
        every stored page and its reservation covers only the tail: the
        hold's full-page head becomes the slot's borrow, its boundary page
        stays held until the commit has written the private copy."""
        shared_ids, stored_len = hit
        SESSION_HITS.inc(tags={"model": self.model.name})
        n_share = stored_len // self.page_size
        opts.pop("_session_hold", None)
        opts.pop("_session_share", None)
        opts["_pages"] = list(shared_ids[:n_share]) + opts["_pages"]
        opts["_shared_pages"] = n_share
        opts["_hold_tail"] = list(shared_ids[n_share:])
        self._page_journal.record(
            "cow_copy", n_share, self._allocator.allocated_pages,
            source="session")
        row = self._paged_seed_fn(
            self._new_row(), self._cache, torch.from_numpy(table_array(
                shared_ids, self._n_table_entries, self.num_pages)),
            stored_len)
        last, row = run_chunked(self._long_chunk, prompt,
                                self.prompt_buckets[-1], row,
                                between=self._interleave_step,
                                base=stored_len)
        self._commit_and_register(req, prompt, opts, slot_idx, row, last)
        hold_tail = opts.pop("_hold_tail", None)
        if hold_tail:
            self._allocator.decref(hold_tail)

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
        """Park one admission's chunk train for the budget pump, with its
        reuse resolved. Paged: a bucketed prompt keeps its bucket as the
        chunk width, so same-bucket trains group into one program; a long
        prompt or a session continuation chunks at the largest bucket. A
        session hit borrows the stored turn's full pages by reference and
        starts at the page boundary (the boundary positions are in the
        prompt and are recomputed into the train's own pages); the prefix
        lookup waits for the train's first dispatch
        (:meth:`_maybe_borrow_prefix`). Slab trains always chunk at the
        largest bucket, on a private row cache of :meth:`_long_row_cap`
        (the long fill's shapes, so one chunk and one commit serve every
        train), seeded from a stored session row or a cached first
        chunk."""
        C_max = self.prompt_buckets[-1]
        total = int(prompt.size)
        base = 0
        row = None
        insert_prefix = False
        W = bucket if bucket > 0 else C_max
        sessions = self.paged_sessions if self.paged else self.session_cache
        hit = None
        if sessions is not None and opts["session_id"]:
            hit = sessions.lookup(opts["session_id"], prompt)
            if hit is None:
                opts["_session_miss"] = True
        if self.paged:
            opts.setdefault("_pages", [])
            opts["_shared_pages"] = 0
            if hit is not None:
                shared_ids, stored_len = hit
                n_share = stored_len // self.page_size
                # Counted at registration: a starvation requeue re-admits
                # and re-looks-up.
                opts["_session_hit"] = True
                if n_share > 0:
                    head = list(shared_ids[:n_share])
                    self._allocator.incref(head)
                    opts["_pages"] = head
                    opts["_shared_pages"] = n_share
                    base = n_share * self.page_size
                    self._page_journal.record(
                        "cow_copy", n_share,
                        self._allocator.allocated_pages, source="session")
                W = C_max
        else:
            W = C_max
            row = self._new_row()
            if hit is not None:
                ek, ev, eks, evs, elen = hit
                opts["_session_hit"] = True   # counted at _register
                row = self._session_seed_fn(row, ek, ev, eks, evs, elen)
                base = int(elen)
            elif self.prefix_cache is not None and total > W:
                model_tag = {"model": self.model.name, "granularity": "chunk"}
                phit = self.prefix_cache.lookup(prompt)
                if phit is not None:
                    row = self._prefix_seed_fn(row, *phit)
                    base = W
                    PREFIX_HITS.inc(tags=model_tag)
                else:
                    insert_prefix = True
                    PREFIX_MISSES.inc(tags=model_tag)
        self._trains.append(_ChunkTrain(
            req=req, prompt=prompt, opts=opts, slot_idx=slot_idx, C=W,
            total=total, pos=base, base=base, row=row,
            insert_prefix=insert_prefix,
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
            # Single-chunk trains group; a multi-chunk train dispatches
            # alone, so it completes (and publishes its prefix pages)
            # before an identical queued prompt's first chunk looks up.
            if head.total - head.base <= head.C:
                cap = min(self.max_admissions_per_step,
                          max(1, budget // head.C))
                for t in self._trains:
                    if len(members) >= cap:
                        break
                    if (t is head or id(t) in parked or t.C != head.C
                            or t.total - t.base > t.C):
                        continue
                    members.append(t)
            ready = []
            for t in members:
                self._maybe_borrow_prefix(t)
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

    def _maybe_borrow_prefix(self, train: _ChunkTrain) -> None:
        """Longest-shared-page-prefix borrow, resolved at the train's first
        chunk dispatch (not at dequeue): trains of the same burst publish
        their pages as they complete, so an identical queued prompt finds
        them. Borrowed pages become the train's head; ``pos``/``base``
        jump past the shared positions."""
        if (self.paged_prefix is None or train.pos != 0 or train.base != 0
                or train.opts.get("_shared_pages", 0)
                or train.opts.get("_prefix_done")
                or train.total <= self.page_size):
            return
        train.opts["_prefix_done"] = True
        model_tag = {"model": self.model.name, "granularity": "page"}
        phit = self.paged_prefix.lookup(train.prompt)
        if phit is None and self.host_spill is not None:
            phit = self._reload_spilled_prefix(train.prompt)
        if phit is None:
            PREFIX_MISSES.inc(tags=model_tag)
            return
        shared_ids, shared_len = phit
        head = list(shared_ids)
        self._allocator.incref(head)
        train.opts["_pages"] = head + train.opts["_pages"]
        train.opts["_shared_pages"] = len(head)
        train.pos = train.base = shared_len
        self._page_journal.record(
            "cow_copy", len(head), self._allocator.allocated_pages,
            source="prefix")
        PREFIX_HITS.inc(tags=model_tag)

    def _grant_train_pages(self, train: _ChunkTrain) -> bool:
        """Extend the train's pages to cover its NEXT chunk's real
        positions (a final chunk also covers the first generated token —
        with a draft, the first verify window: :func:`spec_scratch_pages`);
        cache pins are shed first; False when the pool still cannot (the
        train parks: live streams are never evicted for an admission)."""
        take = min(train.C, train.total - train.pos)
        if train.pos + take >= train.total and self._dcache is not None:
            need = spec_scratch_pages(train.total, self.spec_tokens + 1,
                                      self.page_size, self._paged_capacity)
        elif train.pos + take >= train.total:
            need = pages_for(min(train.total + 1, self._paged_capacity),
                             self.page_size)
        else:
            need = pages_for(train.pos + take, self.page_size)
        delta = need - len(train.opts["_pages"])
        if delta <= 0:
            return True
        while not self._allocator.can_alloc(delta):
            if not self._reclaim_cache_pins():
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
            final = t.pos + take >= t.total
            # Only the final chunk publishes the prompt's length.
            meta_i[:, i] = (t.pos, take - 1, t.opts["top_k"], t.opts["seed"],
                            t.slot_idx, t.total if final else -1)
            meta_f[:, i] = (t.opts["temperature"], t.opts.get("top_p", 1.0))
            bias_ids[i], bias_vals[i] = self._bias_arrays(t.opts)
            if final:
                finals.append((i, t))
        first = self._chunk_paged_fn(
            torch.from_numpy(np.stack([tokens, mask])),
            torch.from_numpy(tables), torch.from_numpy(meta_i),
            torch.from_numpy(meta_f), torch.from_numpy(bias_ids),
            torch.from_numpy(bias_vals), bool((meta_f[0] > 0).any()),
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
            if self.paged_prefix is not None:
                # Publish before registration: a stop on the first token
                # frees the slot's pages, and the insert pins them first.
                self.paged_prefix.insert(t.prompt, t.opts["_pages"])
            if self._dcache is not None:
                # The draft has no pages-direct path (its cache is a
                # slab): the whole prompt replays through its chunk
                # program so speculation starts in step.
                self._draft_long_fill(t.prompt, t.slot_idx)
            self._register(t.slot_idx, t.req, int(first_host[i]), t.opts,
                           t_done)

    def _advance_train_slab(self, train: _ChunkTrain) -> None:
        """One row-cache chunk for a slab train; the final chunk flows
        into the commit (row into the shared cache + first-token sample)
        and registration."""
        train.last, train.row, take = run_chunk(
            self._long_chunk_fn, train.prompt, train.pos, train.C,
            train.row)
        if train.insert_prefix and train.pos == 0 and take == train.C:
            # Chunk 0 was full: its k/v depend only on the first C tokens.
            self.prefix_cache.insert(
                train.prompt, *self._prefix_extract_fn(train.row, train.C))
        train.pos += take
        self.chunk_dispatches += 1
        PREFILL_CHUNKS.inc(tags={"model": self.model.name})
        if train.pos >= train.total:
            self._retire_train(train)
            self._commit_and_register(train.req, train.prompt, train.opts,
                                      train.slot_idx, train.row, train.last)

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
        train = next((t for t in reversed(self._trains)
                      if t.pos == t.base), self._trains[-1])
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
        generated token — with a draft, the first verify window, whose
        row 0 is that token: :func:`spec_scratch_pages` — minus the
        session pages the borrow will cover); under pressure cache pins
        are shed first. Page-starved, the request goes back to the queue
        untouched (False) and any session hold is released."""
        if self._dcache is not None:
            need_pages = spec_scratch_pages(
                int(prompt.size), self.spec_tokens + 1, self.page_size,
                self._paged_capacity)
        else:
            need_pages = pages_for(int(prompt.size) + 1, self.page_size)
        need = max(0, need_pages - int(opts.get("_session_share", 0)))
        while True:
            try:
                opts["_pages"] = self._allocator.alloc(need)
                return True
            except OutOfPages:
                if not self._reclaim_cache_pins():
                    break
        hold = opts.pop("_session_hold", None)
        opts.pop("_session_share", None)
        if hold:
            self._allocator.decref(hold)
        self._requeue(req, "page-starved admission")
        return False

    def _release_pages(self, opts: Dict) -> None:
        """Undo an admission's page reservation (failed or requeued before
        a slot took ownership): the whole list is decrefed (a borrowed
        head releases its borrow, private pages free), and so is any
        outstanding session hold."""
        if not self.paged:
            return
        pages = opts.pop("_pages", None)
        opts.pop("_shared_pages", None)
        opts.pop("_session_share", None)
        if pages:
            self._allocator.decref(pages)
        for key in ("_session_hold", "_hold_tail"):
            hold = opts.pop(key, None)
            if hold:
                self._allocator.decref(hold)

    # --- page contents between the pool and the host (spill, parcels) -----
    def _read_pages(self, page_ids: List[int]) -> Dict[str, torch.Tensor]:
        """The listed pages' contents in host tensors (pinned on the card):
        k/v ``[L, n, ps, K, H]`` and, on an int8 pool, the scale planes
        ``[L, n, ps, K]``, every kv head: on rank 0 of a mesh engine each
        rank reads its kv-head shard and the shards are gathered over the
        tp group (:meth:`_gather_pages`), so a parcel keeps the JAX
        package's layout whatever engine made it. The copies are queued
        on the engine's stream, behind every program that wrote those
        pages, and waited for."""
        return self._spmd("_gather_pages", page_ids)

    def _gather_pages(self, page_ids: List[int]) -> Dict[str, torch.Tensor]:
        """Every rank's half of :meth:`_read_pages`: its shard of the
        pages, all-gathered over tp where the pool's kv heads are cut
        (where they replicate, every rank's pages are whole already)."""
        planes = self._page_planes(page_ids)
        if self.mesh is not None and self.model.tp_shard.heads_split:
            from ray_dynamic_batching_tpu_torch.parallel.collective import (
                pg_allgather,
            )

            tp = self.mesh.tp
            planes = {name: torch.cat(list(pg_allgather(
                tp.group, g.contiguous(), tp.size).unbind(0)), dim=3)
                for name, g in planes.items()}
        return self._to_host(planes)

    def _page_planes(self, page_ids: List[int]) -> Dict[str, torch.Tensor]:
        """This rank's planes of the listed pages, on the device."""
        idx = torch.tensor(page_ids, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            return {name: plane.index_select(1, idx)
                    for name, plane in _kv_planes(self._cache).items()}

    def _to_host(self, planes: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        pin = self.device.type == "cuda"
        out = {}
        for name, g in planes.items():
            host = torch.empty(g.shape, dtype=g.dtype, pin_memory=pin)
            host.copy_(g, non_blocking=pin)
            out[name] = host
        if pin:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _write_pages(self, page_ids: List[int], payload: Dict) -> None:
        """Copy page contents (host tensors or numpy arrays in the layout
        :meth:`_read_pages` gives, every kv head) into the listed pages,
        in place on the engine's stream: the pool keeps its address, which
        the captured programs hold. On rank 0 of a mesh engine the whole
        payload goes to every rank, which keeps its kv-head shard."""
        self._spmd("_write_pages_here", page_ids, payload)

    def _write_pages_here(self, page_ids: List[int], payload: Dict) -> None:
        idx = torch.tensor(page_ids, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            for name, plane in _kv_planes(self._cache).items():
                src = torch.as_tensor(payload[name])
                K = plane.shape[3]
                if src.shape[3] != K:
                    # A whole-heads payload on a rank holding a shard.
                    src = src.narrow(3, self.mesh.axis_index("tp") * K, K)
                plane.index_copy_(1, idx, src.to(
                    device=self.device, dtype=plane.dtype,
                    non_blocking=src.is_pinned()))

    def _spill_read(self, page_ids: List[int]) -> "_RankPages":
        """The spill tier's read: the pages' planes copied to host memory
        as they lie in this rank's pool. On a mesh engine every rank
        copies its own kv-head shard and keeps it under the handle of
        rank 0's :class:`_RankPages` (dropped on every rank when rank 0's
        entry goes)."""
        return self._spmd("_spill_read_here", page_ids)

    def _spill_read_here(self, page_ids: List[int]) -> "_RankPages":
        return _RankPages(self._to_host(self._page_planes(page_ids)))

    def _spill_write(self, page_ids: List[int], pages: "_RankPages") -> None:
        """The spill tier's reload: the planes written back into the
        listed pages; on a mesh engine every rank writes its own shard
        back (``pages`` travels as its handle)."""
        self._spmd("_spill_write_here", page_ids, pages)

    def _spill_write_here(self, page_ids: List[int],
                          pages: "_RankPages") -> None:
        self._write_pages_here(page_ids, pages.planes)

    def _reload_spilled_prefix(
            self, prompt: np.ndarray) -> Optional[Tuple[List[int], int]]:
        """Probe the spill tier for the longest spilled page-prefix of
        ``prompt``; on a hit the pages come back into fresh pool pages, are
        republished in the prefix cache and returned as a borrow
        ``(page_ids, shared_len)``, exactly as a resident hit. None when
        absent or when the pool has no pages for the reload (recompute:
        a reload never deepens the pressure)."""
        max_n = (int(prompt.size) - 1) // self.page_size
        if max_n <= 0 or len(self.host_spill) == 0:
            return None
        keys = digest_chain(prompt, self.page_size, max_n)
        for n in range(max_n, 0, -1):
            if keys[n - 1] not in self.host_spill:
                continue
            pids = self.host_spill.reload(keys[n - 1], self._allocator)
            if pids is None:
                return None
            # Republish (the cache pins them), then drop the reload's own
            # hold — the pin symmetry of a slot publishing.
            self.paged_prefix.insert(prompt[: n * self.page_size], pids)
            self._allocator.decref(pids)
            return self.paged_prefix.lookup(prompt)
        return None

    def prefix_digests(self, limit: int = 128) -> Optional[Dict[str, Any]]:
        """Bounded digest publication for cluster-wide prefix routing:
        resident prefix entries plus spilled ones (both servable here), as
        ``{"page_size": ..., "digests": {hex: chain_len}}``; the digests a
        reload brought back since the last call ride under ``reloaded``
        (the controller forces a directory push on them)."""
        if self.paged_prefix is None:
            return None
        digests = self.paged_prefix.digests(limit)
        if self.host_spill is not None and len(digests) < limit:
            for key, n in self.host_spill.digests(
                    limit - len(digests)).items():
                digests.setdefault(key, n)
        out: Dict[str, Any] = {"page_size": self.page_size,
                               "digests": digests}
        if self.host_spill is not None:
            reloaded = self.host_spill.drain_republish()
            if reloaded:
                out["reloaded"] = reloaded
        return out

    def _reclaim_cache_pins(self) -> bool:
        """Shed one LRU cache pin under pool pressure — prefix entries
        first (recompute cost), then session turns — before any live
        stream is capacity-finished. With a spill tier the shed prefix
        entry's page contents go to host memory first. True if an entry
        was dropped (its pages free unless a borrower holds them: callers
        loop)."""
        if self.paged_prefix is not None and self.host_spill is not None:
            lru = self.paged_prefix.peek_lru()
            if lru is not None:
                key, pages = lru
                self.host_spill.spill(key, list(pages),
                                      self._allocator.allocated_pages)
        for which, cache in (("prefix", self.paged_prefix),
                             ("session", self.paged_sessions)):
            if cache is not None and cache.evict_lru():
                self._page_journal.record(
                    "cache_reclaim", 0, self._allocator.allocated_pages,
                    cache=which)
                return True
        return False

    def _register(self, slot_idx: int, req: Request, first_tok: int,
                  opts: Dict, t: float) -> None:
        max_new = opts["max_new"]
        slot = self._slots[slot_idx]
        slot.request = req
        slot.generated = [first_tok]
        slot.max_new_tokens = max_new
        slot.prefill_done_ms = t
        slot.stop = opts["stop"]
        slot.session_id = opts.get("session_id")
        slot.prompt_tokens = opts.get("_prompt_tokens")
        self._len_host[slot_idx] = int(opts.get("_cache_len", 0))
        if self.paged:
            # The slot now owns the admission's pages; the host table
            # maps them for the next dispatch's refresh.
            slot.pages = list(opts.get("_pages", ()))
            slot.shared_pages = int(opts.get("_shared_pages", 0))
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
            self._zero_counts_fn(torch.tensor([slot_idx, first_tok],
                                              dtype=torch.int32))
        PREFILLS_TOTAL.inc(tags={"model": self.model.name})
        if opts.get("_session_hit"):
            # Chunk trains count their session hit here, past every
            # requeue window (mono session fills count at fill start).
            SESSION_HITS.inc(tags={"model": self.model.name})
        if opts.get("_session_miss"):
            SESSION_MISSES.inc(tags={"model": self.model.name})
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
        stores = slot.session_id and slot.prompt_tokens is not None
        if stores:
            # The cache holds prompt + generated[:-1] (the last token is
            # pending, never fed): that history is what the next turn's
            # prompt must extend.
            history = np.concatenate([
                np.asarray(slot.prompt_tokens, np.int32),
                np.asarray(slot.generated[:-1], np.int32)])
        if self.paged and slot.pages:
            if self.paged_sessions is not None and stores:
                # Pin the pages covering the history (the store's incref
                # comes before the slot's decref below, so no page passes
                # through the free list).
                self.paged_sessions.store(slot.session_id, slot.pages,
                                          history)
            self._free_slot_pages(slot_idx)
        if self.session_cache is not None and stores:
            self.session_cache.store(
                slot.session_id,
                self._session_extract_fn(self._cache, slot_idx), history)
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
            slot.shared_pages = 0
        self._table_host[slot_idx] = self.num_pages
        self._len_host[slot_idx] = 0
        self._table_dirty = True

    def _refresh_table(self) -> None:
        """Upload the host page table when it changed, into the device
        table in place (the captured programs read it at its address).
        This is the device table's only writer, and it uploads from a
        fresh copy of the mirror, so later host edits of the mirror never
        race the copy."""
        if self._table_dirty:
            self._spmd("_upload_table", torch.from_numpy(
                self._table_host.copy()))
            self._table_dirty = False

    def _upload_table(self, table: torch.Tensor) -> None:
        with torch.inference_mode():
            self._cache.page_table.copy_(table)

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
                # Cache pins go before any live stream is truncated (being
                # the only non-slot owners, they are what makes slot
                # eviction reclaim nothing).
                if self._reclaim_cache_pins():
                    continue
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

    def _record_turn_span(self, horizon: int, active_mask,
                          spec: bool = False) -> None:
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
            spec=spec,
        )

    def _use_spec(self) -> bool:
        """Speculative rounds serve all-greedy batches only: a sampled row
        would need rejection sampling to stay exact, and penalties need
        the plain path's per-step counts (negative ones too, so the test
        is on magnitude) — either sends the whole batch to a plain step."""
        active = self._active_mask
        return (
            self._dcache is not None
            and bool(active.any())
            and float(self._temps[active].max(initial=0.0)) == 0.0
            and float(np.abs(self._pres[active]).max(initial=0.0)) == 0.0
            and float(np.abs(self._freq[active]).max(initial=0.0)) == 0.0
        )

    # --- paged spec rounds: scratch pages ---------------------------------
    def _reserve_spec_scratch(self) -> bool:
        """Extend each active slot's table to cover this round's window
        ``[len, len + k + 1)`` with SCRATCH pages from the shared pool
        (:func:`spec_scratch_pages`, the admission headroom rule applied
        per round). The table names them, so the verify writes through
        them, but the slot does not own them yet: the round's outcome
        splices the accepted prefix's pages into ``slot.pages`` and frees
        the rejected tail (:meth:`_splice_spec_pages`). Under pool
        pressure cache pins are shed first; if the pool still cannot host
        a window, every page taken for this round goes back and the
        caller makes the round one plain paged step (False)."""
        win = self.spec_tokens + 1
        for i in np.flatnonzero(self._active_mask):
            slot = self._slots[i]
            if slot.free:
                continue
            need = spec_scratch_pages(int(self._len_host[i]), win,
                                      self.page_size, self._paged_capacity)
            delta = need - len(slot.pages)
            if delta <= 0:
                continue  # the partial page's headroom covers the window
            while not self._allocator.can_alloc(delta):
                if not self._reclaim_cache_pins():
                    break
            if not self._allocator.can_alloc(delta):
                self._rollback_spec_scratch()
                return False
            pids = self._allocator.alloc(delta)
            n0 = len(slot.pages)
            self._spec_scratch[int(i)] = (n0, pids)
            self._table_host[i, n0:n0 + delta] = pids
            self._table_dirty = True
        return True

    def _rollback_spec_scratch(self) -> None:
        """Give back every scratch page of an unresolved round (an aborted
        reserve, or a round whose dispatch raised). The table row is
        REBUILT from the slot's owned pages rather than sentinel-stamped
        over the recorded span: by now the row may have been rewritten (a
        plain step's headroom growth, a finish and a new tenant), and
        sentinels there would drop a live occupant's writes. The scratch
        pages themselves are held by the round alone (refcount 1, never
        in ``slot.pages``), so the decref is always right."""
        for i, (_n0, pids) in self._spec_scratch.items():
            self._table_host[i] = table_array(
                self._slots[i].pages, self._n_table_entries, self.num_pages)
            self._table_dirty = True
            self._allocator.decref(pids)
        self._spec_scratch.clear()

    def _splice_spec_pages(self, lengths_host: np.ndarray) -> None:
        """Resolve the round's scratch pages from the verified lengths:
        the pages the ACCEPTED length covers commit by table splice — into
        ``slot.pages``, no k/v copied (the table already names them and
        the accepted tokens' k/v landed there) — and the rejected tail
        frees back to the pool, its table entries reset to the sentinel.
        Each is a journal event (``spec_commit`` / ``spec_reject``). Runs
        before the harvest, so a finishing slot frees exactly the pages it
        owns; the dict is drained first, so no later rollback can decref
        the same pages twice."""
        items = list(self._spec_scratch.items())
        self._spec_scratch.clear()
        for i, (n0, pids) in items:
            slot = self._slots[i]
            covered = pages_for(int(lengths_host[i]), self.page_size)
            commit_n = max(0, min(covered - n0, len(pids)))
            committed, rejected = pids[:commit_n], pids[commit_n:]
            if committed:
                slot.pages.extend(committed)
                self._page_journal.record(
                    "spec_commit", len(committed),
                    self._allocator.allocated_pages, slot=int(i))
            if rejected:
                self._table_host[i, n0 + commit_n:n0 + len(pids)] = \
                    self.num_pages
                self._table_dirty = True
                self._allocator.decref(rejected)
                self._page_journal.record(
                    "spec_reject", len(rejected),
                    self._allocator.allocated_pages, slot=int(i))

    def spec_acceptance(self) -> Optional[float]:
        """Rolling draft-token acceptance rate (accepted / drafted over the
        bounded window of rounds), or None before the first round."""
        if not self._spec_acc_window:
            return None
        acc = sum(a for a, _ in self._spec_acc_window)
        drafted = sum(d for _, d in self._spec_acc_window)
        return acc / drafted if drafted else None

    def _spec_step(self) -> None:
        """One speculative round (:meth:`_spec_impl`): on the paged pool
        its scratch pages are reserved first — a pool too tight for them
        makes it one plain paged step — and resolved before the harvest;
        every round books drafted = accepted + rejected."""
        k = self.spec_tokens
        if self.paged:
            if self._spec_scratch:
                # A round that raised between reserve and splice.
                self._rollback_spec_scratch()
            if not self._reserve_spec_scratch():
                self.spec_pool_fallbacks += 1
                return self._step(horizon=1)
        active = self._active_mask.copy()
        try:
            # From here to the fetch the scratch is armed but unresolved:
            # any failure rolls it back now (a sampled row may keep every
            # later batch plain, and nothing else would return it).
            if self.paged:
                self._refresh_table()
            _f, _i, bias_ids, bias_vals = self._sampling_arrays()
            self._scan_start_ms = now_ms()
            packed = self._spec_fn(
                torch.from_numpy(np.stack([self._tokens[:, 0],
                                           active.astype(np.int32)])),
                bias_ids, bias_vals)
            ph = packed.cpu().numpy()       # ONE fetch per round
        except BaseException:
            if self.paged:
                self._rollback_spec_scratch()
            raise
        self._scan_end_ms = now_ms()
        if _tracer().enabled:
            self._record_turn_span(k, active, spec=True)
        out, n_out, lengths = ph[: k + 1], ph[k + 1], ph[k + 2]
        if self.paged:
            # Accepted prefixes splice, rejected tails free, before the
            # harvest can finish (and free) any slot.
            self._splice_spec_pages(lengths)
        self.steps += 1
        self.spec_rounds += 1
        DECODE_STEPS.inc(tags={"model": self.model.name})
        tags = {"model": self.model.name,
                "paged": "true" if self.paged else "false"}
        SPEC_ROUNDS.inc(tags=tags)
        live = np.asarray([not slot.free and active[i] and n_out[i] > 0
                           for i, slot in enumerate(self._slots)])
        drafted = k * int(active.sum())
        accepted = int((n_out[live] - 1).sum()) if live.any() else 0
        if drafted:
            SPEC_DRAFTED.inc(drafted, tags=tags)
            SPEC_REJECTED.inc(drafted - accepted, tags=tags)
            self._spec_acc_window.append((accepted, drafted))
            SPEC_ACCEPTANCE.set(self.spec_acceptance(), tags=tags)
        if accepted:
            SPEC_ACCEPTED.inc(accepted, tags=tags)
        # The plain harvest with advanced = (j < n_out): a short row is a
        # rejected draft, not a full cache.
        self._harvest(out, np.arange(k + 1)[:, None] < n_out[None, :],
                      lengths, k + 1, blocked_finishes_capacity=False)

    def _step(self, horizon: Optional[int] = None) -> None:
        if horizon is None and self._use_spec():
            return self._spec_step()
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
        prev_tokens = self._tokens.copy()   # the draft catch-up's head
        samp_f, samp_i, bias_ids, bias_vals = self._sampling_arrays()
        self._scan_start_ms = now_ms()
        packed = self._decode_fn(
            torch.from_numpy(np.stack([
                self._tokens[:, 0], active.astype(np.int32), tok_idx,
            ])),
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
        toks, advanced = packed_host[:h], packed_host[h: 2 * h].astype(bool)
        if self._dcache is not None:
            # Keep the draft in step through plain intervals (a sampled
            # row, the steps between chunks), or speculation resumes from
            # a stale draft context: the tokens whose k/v landed at
            # [len, len + h) are [pending, emitted[:-1]].
            window = np.concatenate([prev_tokens, toks[: h - 1].T], axis=1)
            self._draft_catchup_fn(
                torch.from_numpy(np.ascontiguousarray(window)),
                torch.from_numpy(active),
                torch.from_numpy(advanced.sum(axis=0).astype(np.int32)))
            self.draft_catchups += 1
        self._harvest(toks, advanced, packed_host[2 * h], h)

    def _harvest(self, toks_host, advanced_host, lengths_host,
                 h: int, blocked_finishes_capacity: bool = True) -> None:
        """Distribute a scan's [h, B] outputs to their slots: a
        non-advanced substep finishes "capacity", a stop token is accepted
        then finishes "eos", the max_new bound accepts its last token then
        finishes "length" (eos beats length beats capacity at equal
        counts). A speculative round passes advanced = (j < n_out) and
        ``blocked_finishes_capacity=False``: there a short row is a
        rejected draft, and only a row with no room even for the target's
        own token (n_out == 0) finishes "capacity", besides the trailing
        max_len check."""
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
            elif cap_at[c] == accepted[c] and (
                    cap_at[c] < h if blocked_finishes_capacity
                    else cap_at[c] == 0):
                self._finish(i, "capacity")
            elif lengths_host[i] >= self.max_len:
                self._finish(i, "capacity")

    # --- page fabric (live stream migration + prefix push) -----------------
    def live_stream_ids(self) -> List[str]:
        """Request ids of migration-eligible streams: slotted, past
        their first token, not mid-chunked-prefill (trains hold no
        emitted tokens yet, so they are requeue-safe under the
        at-most-once-after-first-token pin and drain the old way).
        Benign-racy read for planners; eligibility is re-checked on the
        engine thread at service time."""
        out: List[str] = []
        for i, s in enumerate(self._slots):
            if s.free or s.request is None or i in self._train_slots:
                continue
            if s.generated:
                out.append(s.request.request_id)
        return out

    def request_migration(
        self, request_id: str,
        deliver: Callable[[PageParcel], bool],
    ) -> bool:
        """Thread-safe: ask this engine to migrate ``request_id`` out
        through ``deliver`` at its next between-turns service point.
        ``deliver`` is invoked ON the engine thread with the frozen
        parcel and must return True only once the destination accepted
        it; the slot is committed (freed without fulfil) on True and
        left decoding untouched on False/raise. Returns False if the
        stream is not live here (advisory — a stream that finishes
        before service is simply skipped, duplicates are harmless)."""
        if not self.paged:
            return False
        live = any(
            (not s.free) and s.request is not None
            and s.request.request_id == request_id
            for s in self._slots
        )
        if not live:
            return False
        with self._fabric_lock:
            self._migrate_out_q.append((request_id, deliver))
        return True

    def request_prefix_push(
        self, key: bytes, deliver: Callable[[PageParcel], bool],
    ) -> bool:
        """Thread-safe: export prefix-cache entry ``key`` as a push
        parcel through ``deliver`` at the next service point (skipped
        if evicted by then)."""
        if not self.paged or self.paged_prefix is None:
            return False
        with self._fabric_lock:
            self._push_out_q.append((key, deliver))
        return True

    def accept_parcel(self, parcel: PageParcel) -> bool:
        """Thread-safe destination half of the courier edge: admission-
        check ``parcel`` and enqueue it for import on the engine thread.
        The checks are ADVISORY (the free-pages read races the engine
        thread benignly); the import path keeps its own OOM fallback
        chain (reclaim cache pins -> capacity-truncate), so a stale
        accept is honest, never corrupting. A False return leaves the
        source slot untouched — it simply resumes decoding."""
        if not self.paged or parcel.page_size != self.page_size:
            return False
        if parcel.kind == STREAM:
            if parcel.resume_len > self.max_len:
                return False
            s = parcel.sampling
            if (float(s.get("temperature", 0.0)) > 0.0
                    and int(s.get("base_seed", -1)) != self.base_seed):
                # Sampled rows only resume byte-identically under the
                # same engine-level noise seed; greedy rows never consult
                # it.
                return False
            with self._fabric_lock:
                pending = [p for p in self._parcel_in_q
                           if p.kind == STREAM]
                free_slots = sum(
                    1 for i, sl in enumerate(self._slots)
                    if sl.free and i not in self._train_slots
                )
                if len(pending) + 1 > free_slots:
                    return False
                pend_pages = sum(p.n_pages for p in pending)
                if not self._allocator.can_alloc(
                        pend_pages + parcel.n_pages):
                    return False
                self._parcel_in_q.append(parcel)
            return True
        # Prefix pushes are speculative: admission only rejects the
        # impossible (bigger than the pool); a tight pool skips the
        # install at import time rather than deepening pressure.
        if parcel.n_pages > self.num_pages:
            return False
        with self._fabric_lock:
            self._parcel_in_q.append(parcel)
        return True

    def _fabric_pending(self) -> bool:
        if not self.paged:
            return False
        with self._fabric_lock:
            return bool(self._parcel_in_q or self._migrate_out_q
                        or self._push_out_q)

    def _service_fabric(self) -> None:
        """Engine thread, between decode turns: drain the parcel
        mailboxes and process them. Pops under the fabric lock into
        locals first, then processes unlocked — the handlers call into
        queue accounting and request futures, whose locks rank below
        it. Imports write the pool in place and the next dispatch's
        table refresh maps them."""
        if not self.paged:
            return
        with self._fabric_lock:
            if not (self._parcel_in_q or self._migrate_out_q
                    or self._push_out_q):
                return
            inbound, self._parcel_in_q = self._parcel_in_q, []
            moves, self._migrate_out_q = self._migrate_out_q, []
            pushes, self._push_out_q = self._push_out_q, []
        for parcel in inbound:
            self._import_parcel(parcel)
        for rid, deliver in moves:
            self._migrate_stream_out(rid, deliver)
        for key, deliver in pushes:
            self._push_prefix_out(key, deliver)

    def _migrate_stream_out(
        self, request_id: str,
        deliver: Callable[[PageParcel], bool],
    ) -> None:
        """Freeze -> deliver -> commit. The export is read-only and the
        slot is torn down only AFTER the courier acknowledged delivery,
        so every failure mode (courier death, partition mid-parcel,
        destination refusal) leaves the stream decoding here as if the
        directive never arrived."""
        idx = None
        for i, s in enumerate(self._slots):
            if (not s.free and s.request is not None
                    and s.request.request_id == request_id
                    and i not in self._train_slots and s.generated):
                idx = i
                break
        if idx is None:
            return  # finished/moved since requested — nothing to do
        slot = self._slots[idx]
        req = slot.request
        parcel = export_stream_parcel(self, idx)
        ok = False
        try:
            ok = bool(deliver(parcel))
        except Exception:  # noqa: BLE001 — a courier fault keeps the stream
            logger.exception(
                "%s: migrate_out delivery failed for %s",
                self.model.name, request_id,
            )
        if not ok:
            return
        # Commit: the destination owns the stream now. Mirror _finish's
        # slot/sampling reset WITHOUT fulfil or completion accounting —
        # the same TokenStream keeps flowing from the new engine, and
        # note_migrated_out closes this queue's books instead.
        self._page_journal.record(
            "migrate_out", parcel.n_pages,
            self._allocator.allocated_pages,
            slot=int(idx), bytes=parcel.nbytes, request=request_id,
        )
        self.queue.note_migrated_out(req)
        self._free_slot_pages(idx)
        self._slots[idx] = _Slot()
        self._active_mask[idx] = False
        self._temps[idx] = 0.0
        self._topk[idx] = 0
        self._topp[idx] = 1.0
        self._seeds[idx] = 0
        self._bias_ids[idx] = 0
        self._bias_vals[idx] = 0.0
        self._pres[idx] = 0.0
        self._freq[idx] = 0.0
        self.migrated_out += 1

    def _import_parcel(self, parcel: PageParcel) -> None:
        if parcel.kind == PREFIX:
            self._install_prefix(parcel)
            return
        idx = None
        for i, s in enumerate(self._slots):
            if s.free and i not in self._train_slots:
                idx = i
                break
        need = parcel.n_pages
        if idx is not None:
            while not self._allocator.can_alloc(need):
                # Accepted capacity evaporated (admissions raced the
                # courier): cache pins are optimizations, inbound live
                # streams are not.
                if not self._reclaim_cache_pins():
                    break
        if idx is None or not self._allocator.can_alloc(need):
            # OOM-after-accept last resort: a complete-but-truncated
            # result — the same honest contract as cache exhaustion.
            self._fulfill_truncated(parcel)
            return
        pages = self._allocator.alloc(need) if need else []
        if parcel.payload:
            self._write_pages(pages, parcel.payload)
        self._register_migrated(idx, parcel, pages)
        self._page_journal.record(
            "migrate_in", need, self._allocator.allocated_pages,
            slot=int(idx), bytes=parcel.nbytes,
            request=parcel.request.request_id,
        )
        self.queue.note_migrated_in(parcel.request)
        self.migrated_in += 1

    def _register_migrated(
        self, slot_idx: int, parcel: PageParcel, pages: List[int],
    ) -> None:
        """Splice an imported stream into ``slot_idx`` and resume it.
        The _register variant for a stream that already emitted tokens:
        no stream_put / TTFT / prefill accounting (all happened at the
        source), device ``lengths`` set explicitly (normally the
        prefill program's job), penalty counts reconstructed from the
        generated list (the counts row of a live slot equals
        ``bincount(generated)`` — the scan counts only tokens it
        sampled plus the register-counted first token, and a live slot
        kept every one of them)."""
        slot = self._slots[slot_idx]
        slot.request = parcel.request
        slot.generated = list(parcel.generated)
        slot.max_new_tokens = parcel.max_new_tokens
        slot.prefill_done_ms = parcel.prefill_done_ms
        slot.stop = parcel.stop
        slot.session_id = parcel.session_id
        slot.prompt_tokens = parcel.prompt_tokens
        slot.pages = list(pages)
        slot.shared_pages = 0
        self._len_host[slot_idx] = int(parcel.cache_len)
        self._table_host[slot_idx] = table_array(
            slot.pages, self._n_table_entries, self.num_pages
        )
        self._table_dirty = True
        self._tokens[slot_idx, 0] = int(parcel.generated[-1])
        self._active_mask[slot_idx] = True
        s = parcel.sampling
        self._temps[slot_idx] = float(s.get("temperature", 0.0))
        self._topk[slot_idx] = int(s.get("top_k", 0))
        self._topp[slot_idx] = float(s.get("top_p", 1.0))
        self._seeds[slot_idx] = int(s.get("seed", 0))
        self._bias_ids[slot_idx] = np.asarray(s["bias_ids"]) \
            if "bias_ids" in s else 0
        self._bias_vals[slot_idx] = np.asarray(s["bias_vals"]) \
            if "bias_vals" in s else 0.0
        self._pres[slot_idx] = float(s.get("presence_penalty", 0.0))
        self._freq[slot_idx] = float(s.get("frequency_penalty", 0.0))
        self._sampling_dev = None  # host arrays changed
        row = None
        if self._pres[slot_idx] or self._freq[slot_idx]:
            vocab = int(self._counts.shape[1])
            row = np.bincount(
                np.asarray(parcel.generated, np.int64) % vocab,
                minlength=vocab,
            )[:vocab].astype(np.int32)
        self._spmd("_resume_slot", slot_idx, int(parcel.cache_len), row)

    @torch.inference_mode()
    def _resume_slot(self, slot_idx: int, cache_len: int,
                     counts: Optional[np.ndarray]) -> None:
        """A migrated stream's device state on every rank, in place (the
        captured programs hold these addresses): its cache length and,
        with penalties, its counts row."""
        self._cache.lengths[slot_idx] = cache_len
        if counts is not None:
            self._counts[slot_idx].copy_(torch.from_numpy(counts))

    def _fulfill_truncated(self, parcel: PageParcel) -> None:
        """Destination-OOM fallback after accept: resolve the stream as
        complete-but-truncated instead of stranding it (the source
        already committed the hand-off and cannot take it back)."""
        req = parcel.request
        t = now_ms()
        self.queue.note_migrated_in(req)
        req.fulfill(DecodeResult(
            tokens=list(parcel.generated),
            finish_reason="capacity",
            ttft_ms=parcel.prefill_done_ms - req.arrival_ms,
            total_ms=t - req.arrival_ms,
        ))
        self.queue.record_batch_completion([req], completed_at_ms=t)
        self.completed += 1
        logger.warning(
            "%s: migrated-in stream %s capacity-truncated "
            "(destination OOM after accept)",
            self.model.name, req.request_id,
        )

    def _push_prefix_out(
        self, key: bytes, deliver: Callable[[PageParcel], bool],
    ) -> None:
        parcel = export_prefix_parcel(self, key)
        if parcel is None:
            return  # evicted between planning and export
        ok = False
        try:
            ok = bool(deliver(parcel))
        except Exception:  # noqa: BLE001 — a failed push costs nothing
            logger.exception(
                "%s: prefix push delivery failed", self.model.name
            )
        if not ok:
            return
        self._page_journal.record(
            "push_out", parcel.n_pages,
            self._allocator.allocated_pages, bytes=parcel.nbytes,
        )
        self.pushes_out += 1

    def _install_prefix(self, parcel: PageParcel) -> None:
        """Install a pushed prefix parcel digest-direct: alloc, write,
        publish under the parcel's chain address. Skips duplicates and
        tight pools (a speculative warm must never evict local state to
        make room for itself)."""
        cache = self.paged_prefix
        if cache is None or not parcel.digest:
            return
        if parcel.digest in cache._entries:
            return
        need = parcel.n_pages
        if not self._allocator.can_alloc(need):
            return
        pages = self._allocator.alloc(need)
        self._write_pages(pages, parcel.payload)
        if cache.install(parcel.digest, pages):
            self._page_journal.record(
                "push_in", need, self._allocator.allocated_pages,
                bytes=parcel.nbytes,
            )
            self.pushes_in += 1
        # Pin symmetry: install increfs for the cache; drop the alloc's
        # own hold (pages free immediately on the losing race branch).
        self._allocator.decref(pages)

    # --- loop --------------------------------------------------------------
    def run_until_idle(self, timeout_s: float = 60.0) -> None:
        """Drive admissions + steps until queue and slots are empty."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._service_fabric()
            admitted = self._admit()
            self._pump_prefill()
            if self._active_mask.any():
                self._step()
            elif (not admitted and not self._trains
                    and len(self.queue) == 0
                    and not self._fabric_pending()):
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
                self._service_fabric()
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
        planes, the draft's cache and programs, the counts, the captured
        programs with their memory pool and the merge scratch they hold).
        Call only after the loop has stopped; the engine is unusable
        afterwards. On rank 0 of a mesh engine every follower drops its
        twin too."""
        if self._tp_key is not None:
            from ray_dynamic_batching_tpu_torch.parallel import spmd

            key, self._tp_key = self._tp_key, None
            if not (self.mesh.world.closed or self.mesh.world.failed):
                spmd.drop_objects(self.mesh.world, key)
        self._graphs.release()
        self._workspace = None
        self._cache = None
        self._counts = None
        self._sampling_dev = None
        self._dcache = None
        if self.draft_model is not None:
            self._spec_fn = self._draft_catchup_fn = None
            self._draft_prefill_fn = None
            self._draft_long_chunk_fn = self._draft_long_commit_fn = None
        if self.prefix_cache is not None:
            self.prefix_cache.clear()    # device k/v entries freed
        if self.session_cache is not None:
            self.session_cache.clear()
        if self.paged:
            # Cache pins drop first (clean decrefs), then the pool state.
            for cache in (self.paged_prefix, self.paged_sessions,
                          self.host_spill):
                if cache is not None:
                    cache.clear()
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
        # Accepted but not yet imported parcels hold live streams their
        # source already released: reject them too (they entered no books
        # here, so conservation holds on both sides).
        if self.paged:
            with self._fabric_lock:
                inbound, self._parcel_in_q = self._parcel_in_q, []
                self._migrate_out_q.clear()
                self._push_out_q.clear()
            for parcel in inbound:
                if parcel.kind == STREAM and parcel.request is not None:
                    parcel.request.reject(exc)

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
        spans; ``fabric`` counts the parcels moved; ``spec`` (with a draft)
        the window and the rolling acceptance."""
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
            out["fabric"] = {
                "migrated_out": self.migrated_out,
                "migrated_in": self.migrated_in,
                "pushes_out": self.pushes_out,
                "pushes_in": self.pushes_in,
            }
        if self.draft_model is not None:
            out["spec"] = {
                "spec_tokens": self.spec_tokens,
                "acceptance": self.spec_acceptance(),
                "rounds_windowed": len(self._spec_acc_window),
            }
        return out

    def capture_stats(self) -> Dict[str, Any]:
        """The engine's captured programs: captures, the seconds they
        took, the device memory reserved while capturing and the graphs
        of each program (zeros where nothing is captured)."""
        return self._graphs.stats()

    @property
    def active_slots(self) -> int:
        return int(self._active_mask.sum())
