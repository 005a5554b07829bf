"""KV page parcels — page sets as shippable objects.

Port of ``ray_dynamic_batching_tpu/engine/pagefabric.py``, whole, with its
import paths rewritten. A :class:`PageParcel` is a page run copied to host
memory (int8 scale planes included) plus everything needed to resume it on
another engine:

- **Stream parcels** carry a LIVE decode stream: the page contents
  covering its cached tokens, the full sampling row
  (temperature/top-k/top-p/seed/penalties/bias — and ``base_seed``: a
  sampled token's noise is a function of (base_seed, request seed, token
  index), all host-derivable), and the stream cursor (the ``generated``
  list + the live :class:`Request` object itself). Re-registering the
  parcel on a destination engine resumes the SAME ``TokenStream``.
- **Prefix parcels** carry one prefix-cache entry addressed by its
  chain digest: the receiver installs it digest-direct
  (``PagedPrefixCache.install``; token bytes never leave the source).

The payload keeps the reference's array layout and dtypes (k/v
``[L, n, ps, K, H]``, scales ``[L, n, ps, K]`` f32), so a parcel crosses
the two packages by a field copy. The port's payload values are pinned
host tensors (bf16 has no numpy dtype); the importer also takes numpy.

Export and import run ON the owning engine's thread (the engine services
its parcel mailboxes between decode turns:
``DecodeEngine._service_fabric``).
The transfer plane between engines is ``serve/kv_fabric.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ray_dynamic_batching_tpu_torch.engine.paging import (
    digest_chain,
    pages_for,
)

# Parcel kinds: a live stream move vs a speculative prefix replication.
STREAM = "stream"
PREFIX = "prefix"


@dataclass
class PageParcel:
    """One shippable page set + the state to resume it elsewhere.

    In-process transfer object: arrays are host copies in the
    reference's layout and dtypes (k/v ``[L, n, ps, K, H]`` in the cache
    dtype, scales ``[L, n, ps, K]`` f32), gathered off the card into
    pinned host tensors by the exporter; ``request`` is the live Request whose
    TokenStream keeps flowing after the import splices the pages in.
    ``digest`` is the chain address of the deepest full page covered
    (``b""`` when less than one full page is cached) — the same 16-byte
    identity the prefix caches, spill tier, and router directory key by.
    """

    kind: str                                   # STREAM | PREFIX
    page_size: int
    cache_len: int                              # tokens the pages cover
    payload: Dict[str, Any]                     # k/v [+ k_scale/v_scale]
    digest: bytes = b""
    src: str = ""                               # exporting engine/replica
    # --- stream-only resume state ------------------------------------
    request: Optional[Any] = None               # live engine Request
    generated: List[int] = field(default_factory=list)
    max_new_tokens: int = 0
    prefill_done_ms: float = 0.0
    stop: frozenset = frozenset()
    session_id: Optional[str] = None
    prompt_tokens: Optional[np.ndarray] = None
    sampling: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_pages(self) -> int:
        return pages_for(self.cache_len, self.page_size)

    @property
    def nbytes(self) -> int:
        """Courier-priced size: page plane bytes + the resume tokens.
        This is the ``parcel_bytes`` the replanner multiplies by the
        courier rate (scheduler/replan.py::migration_parcel_cost)."""
        n = sum(int(a.nbytes) for a in self.payload.values())
        n += 4 * (len(self.generated)
                  + (int(self.prompt_tokens.size)
                     if self.prompt_tokens is not None else 0))
        return n

    @property
    def resume_len(self) -> int:
        """KV capacity a destination must offer: cached tokens plus the
        tokens the stream may still generate."""
        return self.cache_len + max(
            0, self.max_new_tokens - len(self.generated)
        )


def export_stream_parcel(engine, slot_idx: int) -> PageParcel:
    """Freeze ``slot_idx``'s live stream into a parcel (engine thread,
    between decode turns). READ-ONLY: the slot keeps every page and all
    host/device state — a failed delivery simply resumes decoding here,
    because nothing was torn down to build the parcel."""
    slot = engine._slots[slot_idx]
    cache_len = int(engine._len_host[slot_idx])
    need = pages_for(cache_len, engine.page_size)
    # Headroom pages past the cached length hold garbage (the scan only
    # attends < lengths); exporting them would ship dead bytes.
    page_ids = list(slot.pages[:need])
    payload = engine._read_pages(page_ids) if page_ids else {}
    tokens = np.concatenate([
        np.asarray(slot.prompt_tokens, np.int32)
        if slot.prompt_tokens is not None else np.zeros((0,), np.int32),
        np.asarray(slot.generated, np.int32),
    ])
    chain = digest_chain(tokens, engine.page_size)
    return PageParcel(
        kind=STREAM,
        page_size=engine.page_size,
        cache_len=cache_len,
        payload=payload,
        digest=chain[-1] if chain else b"",
        src=engine.model.name,
        request=slot.request,
        generated=list(slot.generated),
        max_new_tokens=slot.max_new_tokens,
        prefill_done_ms=slot.prefill_done_ms,
        stop=slot.stop,
        session_id=slot.session_id,
        prompt_tokens=slot.prompt_tokens,
        sampling={
            "temperature": float(engine._temps[slot_idx]),
            "top_k": int(engine._topk[slot_idx]),
            "top_p": float(engine._topp[slot_idx]),
            "seed": int(engine._seeds[slot_idx]),
            "presence_penalty": float(engine._pres[slot_idx]),
            "frequency_penalty": float(engine._freq[slot_idx]),
            "bias_ids": np.array(engine._bias_ids[slot_idx]),
            "bias_vals": np.array(engine._bias_vals[slot_idx]),
            # Exactness gate: the device PRNG base key is engine-level,
            # so a sampled row only resumes byte-identically on an
            # engine sharing it (accept_parcel refuses otherwise).
            "base_seed": int(engine.base_seed),
        },
    )


def export_prefix_parcel(engine, key: bytes) -> Optional[PageParcel]:
    """One prefix-cache entry as a push parcel (engine thread). The
    pages are pinned by the cache and never rewritten after publication
    (CoW invariant), so the gather races nothing; None when the entry
    was evicted between planning and export."""
    cache = engine.paged_prefix
    if cache is None:
        return None
    entry = cache._entries.get(key)
    if entry is None:
        return None
    page_ids = list(entry)
    return PageParcel(
        kind=PREFIX,
        page_size=engine.page_size,
        cache_len=len(page_ids) * engine.page_size,
        payload=engine._read_pages(page_ids),
        digest=key,
        src=engine.model.name,
    )
