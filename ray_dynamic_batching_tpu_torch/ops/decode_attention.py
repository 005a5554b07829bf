"""Decode attention, slab and paged: the CUDA kernels, their plain versions,
their counts.

**Slab** — replaces
``ray_dynamic_batching_tpu/ops/decode_attention.py::_decode_attention``
(Pallas bodies ``_decode_kernel`` + ``_scan_tile``). The kernel is
``csrc/decode_attention.cu``: one block per (slot, KV head, split of
:data:`SPLIT` logical positions); all G = N / K query heads of that KV
head times the Tq window rows ride one read of each K/V tile (GQA by
layout — no repeat of the cache read); each split block carries the
online-softmax state over its tiles, and the last split of a (slot, KV
head) to finish merges the splits' partials inside the same launch (in
place of the TPU's sequential grid axis); the int8 window mask
[B, Tq, S] gates the scores.

What bounds it on the H100: the bytes of the K/V positions some window
row attends. Each block reads its slot's mask row first and skips the
64-key tiles and splits no row attends (exact under the reference's rule
unless a row attends nothing, when everything is read so that it gets
the mean of V). The mask is the keep-mask view of
``flash_attention.keep_mask`` (a row stride of 0 or a multiple of 16),
read in 16-byte chunks.

**One window row** (R = Tq * N / K = 1: Whisper's cross read and step,
the GPT-2 steps; :func:`body_for`): both kernels take the single-row scan
(``csrc/common.cuh`` ``RowScan``) — four warps a block, each with its own
``cp.async`` ring of its 16 keys of every tile and its own online softmax,
merged through shared memory, splits of :func:`row_split_tiles` tiles so
that the grid is about one wave. Each launch reports its body, counted in
:data:`launches_by_body`.

**Paged** — replaces ``_paged_decode_attention`` (the same ``_scan_tile``
body over a page pool). The kernel is ``csrc/paged_decode_attention.cu``:
the same block layout and the SAME per-tile scan (``csrc/common.cuh``,
``DecodeScan``, the same splits and the same merge, so that a slab cache
cut into pages gives bit-identical outputs), its KV tiles walked through
the slot's page-table row (entry p -> physical page
``min(table[b, p], P - 1)``, logical positions [p*ps, (p+1)*ps)),
validity ``pos <= lengths[b] + t`` computed in the kernel (no mask
stream). Tiles and splits wholly past ``lengths[b] + Tq - 1`` are not
read: every row attends position 0, so what they would add is exactly 0.
Bound on the H100: the bytes of the K/V positions each slot attends.

**Tensor-parallel paged (kernel 4)** — replaces
``_paged_decode_attention_tp`` (reference ``decode_attention.py:519-558``,
a ``shard_map`` of kernel 3 over the mesh's tp axis: q rows and the
pools split on the kv heads, the page table and lengths replicated, the
output split on the kv heads). It has no body of its own: each shard
runs kernel 3 on its slice of the heads, and the numerics are per head,
so the sharded result is exactly the unsharded one re-laid-out. On a
mesh rank, :func:`paged_decode_attention` with ``mesh`` launches kernel 3
on the rank's contiguous shard; :func:`paged_decode_attention_tp` runs
the ``tp`` shards of a whole call in one process (each shard's launch in
turn, outputs concatenated), the form the checks hold against one
unsharded launch, bit for bit. Both count their launches apart
(:data:`tp_paged_launches`, :data:`tp_paged_int8_launches`).

**Head dims.** Both kernels take a head dim that is a multiple of 16 up
to 128 (:func:`head_dim_ok`): the scan body is built 64 and 128 wide, and
a smaller head dim rides it with its K/V tiles and query rows zero-padded
in shared memory (``csrc/common.cuh``), so the bytes read from device
memory stay the head dim's own. ``ops/attention.route`` sends any other
head dim to the plain route before launch.

Both kernels take a per-device scratch for the split merge
(:func:`_workspace`): partials and arrival counters, allocated once and
reused, so calls on one device must run in stream order. An engine
sizes it with :func:`reserve` before it captures a CUDA graph
(``ops/graphs.py``); under capture a launch never grows it.

**Int8 KV** — the reference's ``k_scale``/``v_scale`` branch of both
kernels (``_scan_tile`` lines 142-167): k/v hold int8 codes and the
scales are one f32 per cached (token, head) row, in the cache's own
``[B, S, K]`` / ``[P, ps, K]`` layout (the reference transposes them to
``[B, K, S]`` / ``[P, K, ps]`` for the TPU's lane tiling; the H100 has no
reason to). The same kernels, instantiated for 1-byte K/V: codes are cast
to the query type, scores are ``(q . codes) * scale * k_scale[key]``, the
running sum takes the unscaled ``p``, and ``p * v_scale[key]`` is rounded
to the query type before the PV product with the codes. They read half
the bytes of a bf16 cache (plus 4 per row). Their launches are counted
apart (:data:`int8_launches`, :data:`paged_int8_launches`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_dynamic_batching_tpu_torch.ops import graphs
from ray_dynamic_batching_tpu_torch.ops.flash_attention import (
    keep_mask,
    mask_strides,
)

NEG_INF = -1e30

# Windows past this are prefill-shaped work (the JAX package's
# MAX_WINDOW_FOR_KERNEL).
MAX_WINDOW_FOR_KERNEL = 8

# The engine's page-size rule (the JAX package's lane-aligned page): the
# paged kernel route takes only pages that are a multiple of this.
PAGE_ALIGN = 128

#: Head dims both decode kernels take: multiples of 16 up to 128.
MAX_HEAD_DIM = 128


def head_dim_ok(H: int) -> bool:
    """Whether the decode kernels take head dim ``H`` (a multiple of 16
    in 16..128); ``ops/attention.route`` sends the others to the plain
    route."""
    return H % 16 == 0 and 16 <= H <= MAX_HEAD_DIM


def padded_head_dim(H: int) -> int:
    """The width of the scan body ``H`` rides in shared memory
    (``csrc/common.cuh``): 64 for 16..64, 128 for 80..128."""
    return 64 if H <= 64 else 128


#: Slab-kernel launches since the last reset (plain-version calls do not
#: count; a graph replay adds the launches its capture recorded), bf16/f32
#: K/V and int8 K/V apart.
launches = 0
int8_launches = 0
#: Paged-kernel launches since the last reset (likewise).
paged_launches = 0
paged_int8_launches = 0
#: Kernel 4: paged-kernel launches on a tensor-parallel shard of the kv
#: heads since the last reset (likewise; not counted in the two above).
tp_paged_launches = 0
tp_paged_int8_launches = 0
#: Launches of kernels 2-4 by the body they ran (``csrc/common.cuh``):
#: "scan" (DecodeScan, R = Tq * N / K >= 2) or "row" (RowScan, R = 1),
#: since the last reset (likewise).
BODIES = ("scan", "row")
launches_by_body = dict.fromkeys(BODIES, 0)


def body_for(Tq: int, N: int, K: int) -> str:
    """The body kernels 2 and 3 launch for a window of Tq rows of N query
    heads over K KV heads: "row" when R = Tq * N / K is 1, else "scan"."""
    return "row" if Tq * (N // K) == 1 else "scan"


def row_split_tiles(BK: int, S: int) -> int:
    """64-key tiles a split of the single-row scan holds for B * K = ``BK``
    (slot, KV head)s over S positions, as kernels 2 and 3 cut them
    (``rdb_row_split_tiles``: ``RowScan::split_tiles``, as many splits as
    keep B * K * splits within about one wave of blocks, at least two
    tiles a split). Builds the kernel's library on first use."""
    from ray_dynamic_batching_tpu_torch.ops import _build

    return int(_build.load("decode_attention").rdb_row_split_tiles(BK, S))


def decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """What the kernel computes, in PyTorch. q [B, Tq, N, H], k/v
    [B, S, K, H], mask int8 [B, Tq, S] (1 = attend) or None. Masked scores
    become NEG_INF and still enter the softmax (so a row with no attended
    key averages V, as in the reference kernel); f32 scores and softmax,
    probabilities rounded to the input type before the PV product.

    With ``k_scale``/``v_scale`` [B, S, K] f32, k/v are int8 codes, cast
    to q's type; the scores take ``scale * k_scale[key]`` after the dot,
    the running sum takes the unscaled probabilities, and ``p *
    v_scale[key]`` is what is rounded before the PV product (the
    reference's ``_scan_tile``)."""
    B, Tq, N, H = q.shape
    _, S, K, _ = k.shape
    G = N // K
    scale = H ** -0.5 if scale is None else scale
    qg = q.reshape(B, Tq, K, G, H).float()
    kf, vf = k.to(q.dtype).float(), v.to(q.dtype).float()
    s = torch.einsum("btkgh,bskh->bktgs", qg, kf) * scale
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if mask is not None:
        valid = (mask != 0)[:, None, :, None, :]          # [B, 1, Tq, 1, S]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    acc = torch.einsum("bktgs,bskh->bktgh", p.to(q.dtype).float(), vf)
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Tq, N, H).to(q.dtype)


def _check_scales(k, k_scale, v_scale, what: str) -> None:
    """Both scales or neither; with scales, k holds int8 codes and each
    scale plane is f32 of k's shape without the head dim."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: pass both k_scale and v_scale or neither")
    if k_scale is None:
        return
    want = tuple(k.shape[:-1])
    if k.dtype != torch.int8:
        raise TypeError(f"{what}: scales given but k/v are {k.dtype}, "
                        "not int8 codes")
    for t in (k_scale, v_scale):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{what}: scale planes must be f32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _kernel_args(q, k, v, k_scale, v_scale, what: str):
    """The checks both launches share: types, head dim, shared memory,
    contiguity, one device and 16-byte alignment. Returns (q, k, v,
    k_scale, v_scale) contiguous, the dtype code of q and the int8 flag."""
    B, Tq, N, H = q.shape
    K = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: unsupported dtype {q.dtype}")
    int8 = k_scale is not None
    if v.dtype != k.dtype or k.dtype != (torch.int8 if int8 else q.dtype):
        raise TypeError(f"{what}: k and v must be q's dtype, or int8 codes "
                        "with scales")
    if not head_dim_ok(H):
        raise ValueError(f"{what}: head_dim {H} is not a multiple of 16 "
                         f"in 16..{MAX_HEAD_DIM}")
    R = Tq * (N // K)
    # common.cuh DecodeScan::smem_bytes at the padded width HP: two K and
    # two V tiles in the K/V element type, the query rows (f32, or bf16
    # padded to 16 rows), f32 acc, scores and scales, plus the slab
    # kernel's split mask (Tq x 128 bytes) and flags (a byte per 64-key
    # tile, per window row and per split; the paged kernel has none,
    # counted all the same).
    HP = padded_head_dim(H)
    kv_size = 1 if int8 else q.element_size()
    q_bytes = max(4 * R, 2 * (-(-R // 16) * 16)) * HP
    smem = (256 * HP * kv_size + q_bytes + 4 * (R * HP + 72 * R + 256 + 3 * R)
            + 20 + Tq * 128 + -(-k.shape[1] // 64) + Tq + -(-k.shape[1] // 128))
    if smem > 227 * 1024:
        raise ValueError(f"{what}: {R} window rows per KV head need "
                         f"{smem} bytes of shared memory (max 232448)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t in (q, k, v):
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{what}: q, k and v must be 16-byte aligned "
                             "tensors on one device")
    if int8:
        # Scales are read one f32 at a time: natural alignment suffices.
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        if k_scale.device != q.device or v_scale.device != q.device:
            raise ValueError(f"{what}: scales on another device")
    return q, k, v, k_scale, v_scale, \
        0 if q.dtype == torch.float32 else 1, int8


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


#: Split length of both decode kernels, in logical positions
#: (``DecodeScan::SPLIT`` in ``csrc/common.cuh``): sizes the merge's
#: workspace; the launch refuses a workspace too small for its own.
SPLIT = 128

# device index -> (f32 partials, int32 arrival counters), grown on demand.
_workspaces: dict = {}


def _sizes(B: int, K: int, S: int, R: int, H: int):
    """(partials, counters) elements a launch of these dims needs."""
    return B * K * (-(-S // SPLIT)) * R * (H + 2), B * K


def _grow(device: torch.device, n_ws: int, n_cnt: int):
    """The device's scratch, replaced by a larger one when it holds less
    than (n_ws, n_cnt). A replaced scratch is freed only when nothing
    else holds it: a captured graph's owner keeps the one it captured
    (:func:`reserve`)."""
    key = device.index
    ws, cnt = _workspaces.get(key, (None, None))
    if ws is not None and ws.numel() >= n_ws and cnt.numel() >= n_cnt:
        return ws, cnt
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"decode workspace: a launch under graph capture needs "
            f"{n_ws} partials and {n_cnt} counters, the scratch holds "
            f"{0 if ws is None else ws.numel()} and "
            f"{0 if cnt is None else cnt.numel()}; reserve() the "
            "engine's largest shape before capturing")
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty((n_ws,), dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_cnt:
        cnt = torch.zeros((n_cnt,), dtype=torch.int32, device=device)
    _workspaces[key] = (ws, cnt)
    return ws, cnt


def _workspace(device: torch.device, B: int, K: int, S: int, R: int, H: int):
    """The split merge's scratch for one launch: per (slot, KV head, split)
    the partial (m, l, acc) of R rows, and one arrival counter per (slot,
    KV head). Kept per device and reused, never one allocation per call:
    each launch leaves the counters at 0, and they are zeroed only when
    created (outside any graph). Launches on one device share it, so they
    must run in stream order (the engine issues every kernel on the
    current stream, and replays its graphs there). Under graph capture a
    launch that needs more than the scratch holds raises instead of
    growing it: the graph would bake in memory the growth frees."""
    return _grow(device, *_sizes(B, K, S, R, H))


def reserve(device: torch.device, B: int, K: int, S: int, R: int, H: int):
    """Size the device's scratch for launches up to these dims (B slots,
    K KV heads, S positions, R window rows per KV head, head dim H)
    before any graph captures a launch; returns the scratch, which the
    caller keeps for as long as its graphs live (another engine's larger
    reserve replaces the device's entry, not the caller's buffers)."""
    from ray_dynamic_batching_tpu_torch.ops import _build

    device = torch.device(device)
    if device.index is None:   # launches key the scratch by their index
        device = torch.device(device.type, torch.cuda.current_device())
    with _build.launch_lock:
        return _grow(device, *_sizes(B, K, S, R, H))


def _launch(q, k, v, mask_i8, k_scale, v_scale, *, scale: float
            ) -> torch.Tensor:
    from ray_dynamic_batching_tpu_torch.ops import _build

    B, Tq, N, H = q.shape
    _, S, K, _ = k.shape
    q, k, v, k_scale, v_scale, dtype, int8 = _kernel_args(
        q, k, v, k_scale, v_scale, "decode kernel")
    mbs = mrs = 0
    if mask_i8 is not None:
        strides = mask_strides(mask_i8)
        if (mask_i8.device != q.device or tuple(mask_i8.shape) != (B, Tq, S)
                or strides is None):
            raise ValueError(f"decode kernel: mask must be an int8 [{B}, {Tq}, "
                             f"{S}] keep_mask layout (mask_strides)")
        mbs, mrs = strides
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    body = ctypes.c_int(-1)
    with _build.launch_lock:
        ws, cnt = _workspace(q.device, B, K, S, Tq * (N // K), H)
        rc = lib.rdb_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
            _ptr(v_scale), _ptr(mask_i8), mbs, mrs, out.data_ptr(), B, Tq, S,
            N, K, H, float(scale), dtype, int(int8), ws.data_ptr(),
            ws.numel(), cnt.data_ptr(), cnt.numel(),
            torch.cuda.current_stream(q.device).cuda_stream,
            ctypes.byref(body),
        )
    _build.check(lib, rc, "decode_attention")
    graphs.count_launch(globals(), "int8_launches" if int8 else "launches")
    graphs.count_launch(launches_by_body, BODIES[body.value])
    return out


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused small-window attention. q [B, Tq, N, H] with 1 <= Tq <= 8,
    k/v [B, S, K, H] with K dividing N, mask None or broadcastable to
    [B, 1, Tq, S]; other shapes raise (``ops/attention.route`` sends only
    these here — the reference's decline, decided before the call). CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version. ``k_scale``/``v_scale`` [B, S, K] f32 with int8 k/v: the
    int8-cache branch."""
    B, Tq, N, H = q.shape
    _, S, K, _ = k.shape
    if not (1 <= Tq <= MAX_WINDOW_FOR_KERNEL):
        raise ValueError(f"decode_attention: window {Tq} not in 1..8")
    if K == 0 or N % K != 0 or v.shape != k.shape:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    _check_scales(k, k_scale, v_scale, "decode_attention")
    mask_i8 = keep_mask(mask, B, Tq, S)
    scale = H ** -0.5 if scale is None else float(scale)
    if q.is_cuda:
        return _launch(q, k, v, mask_i8, k_scale, v_scale, scale=scale)
    return decode_attention_plain(q, k, v, mask_i8, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)


def logical_view(pool: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """Gather each slot's logical KV run [B, NP * ps, K, H] from a page
    pool [P, ps, K, H] (or its scales [B, NP * ps, K] from [P, ps, K])
    through ``page_table`` [B, NP], sentinel and stray entries clamped to
    page P - 1 (the length bound masks whatever they contribute)."""
    P, ps = pool.shape[0], pool.shape[1]
    B, NP = page_table.shape
    safe = torch.clamp(page_table.long(), max=P - 1)
    return pool[safe].reshape((B, NP * ps) + tuple(pool.shape[2:]))


def paged_decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """What the paged kernel computes, in PyTorch: clamp the table, gather
    the logical view (and the scales' with int8 pools), apply the
    staircase and the slab kernel's softmax rule. q [B, Tq, N, H]; k/v
    pools [P, ps, K, H]; page_table [B, NP] int32 (sentinel P); lengths
    [B]; k_scale/v_scale [P, ps, K] f32 or None."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        paged_window_mask,
    )

    k_g = logical_view(k, page_table)
    v_g = logical_view(v, page_table)
    if k_scale is not None:
        k_scale = logical_view(k_scale, page_table)
        v_scale = logical_view(v_scale, page_table)
    B, Tq = q.shape[:2]
    S = k_g.shape[1]
    mask = keep_mask(paged_window_mask(lengths, S, Tq), B, Tq, S)
    return decode_attention_plain(q, k_g, v_g, mask, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)


def _launch_paged(q, k, v, page_table, lengths, k_scale, v_scale, *,
                  scale: float, tp: int = 1) -> torch.Tensor:
    from ray_dynamic_batching_tpu_torch.ops import _build

    B, Tq, N, H = q.shape
    P, ps, K, _ = k.shape
    NP = page_table.shape[1]
    q, k, v, k_scale, v_scale, dtype, int8 = _kernel_args(
        q, k, v, k_scale, v_scale, "paged decode kernel")
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    for t in (table, lens):
        if t.device != q.device:
            raise ValueError("paged decode kernel: inputs on another device")
    out = torch.empty_like(q)
    lib = _build.load("paged_decode_attention")
    body = ctypes.c_int(-1)
    with _build.launch_lock:
        ws, cnt = _workspace(q.device, B, K, NP * ps, Tq * (N // K), H)
        rc = lib.rdb_paged_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
            _ptr(v_scale), table.data_ptr(), lens.data_ptr(),
            out.data_ptr(), B, Tq, N, K, H, P, ps, NP, float(scale), dtype,
            int(int8), ws.data_ptr(), ws.numel(), cnt.data_ptr(),
            cnt.numel(), torch.cuda.current_stream(q.device).cuda_stream,
            ctypes.byref(body),
        )
    _build.check(lib, rc, "paged_decode_attention")
    prefix = "tp_" if tp > 1 else ""
    graphs.count_launch(globals(), prefix + ("paged_int8_launches" if int8
                                             else "paged_launches"))
    graphs.count_launch(launches_by_body, BODIES[body.value])
    return out


def paged_eligible(q_shape, k_shape, v_shape, table_shape,
                   lengths_shape) -> bool:
    """The reference wrapper's shape contract (``decode_attention.py:
    449-467``) minus its TPU VMEM budget: 1 <= Tq <= 8, pools [P, ps, K, H]
    with K dividing N and the head dim of q, a 2-D table with B rows,
    lengths [B], and a page that is a multiple of :data:`PAGE_ALIGN`;
    plus the kernels' own head-dim rule (:func:`head_dim_ok`)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    B, Tq, N, H = q_shape
    P, ps, K, Hk = k_shape
    return (1 <= Tq <= MAX_WINDOW_FOR_KERNEL and Hk == H and head_dim_ok(H)
            and tuple(v_shape) == tuple(k_shape) and K > 0 and N % K == 0
            and len(table_shape) == 2 and table_shape[0] == B
            and tuple(lengths_shape) == (B,)
            and ps > 0 and ps % PAGE_ALIGN == 0)


def paged_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    mesh=None,
    mesh_axis: str = "tp",
) -> torch.Tensor:
    """Fused page-table decode attention. q [B, Tq, N, H] with
    1 <= Tq <= 8; k/v page pools [P, ps, K, H] with K dividing N;
    page_table [B, NP] int32 (sentinel P = unallocated); lengths [B].
    Window row t attends logical positions <= lengths[b] + t. Shapes
    outside :func:`paged_eligible` raise (``ops/attention.route`` sends
    only these here). CUDA tensors launch the kernel (or raise); CPU
    tensors run the plain version. ``k_scale``/``v_scale`` [P, ps, K] f32
    with int8 pools: the int8-pool branch.

    ``mesh`` (a mesh rank whose ``mesh_axis`` has more than one rank):
    q and the pools are this rank's shard of the kv heads (q's N/tp
    query heads over the pool's K/tp kv heads; the table and lengths
    whole) — kernel 4's per-shard launch, counted in
    :data:`tp_paged_launches`."""
    if not paged_eligible(q.shape, k.shape, v.shape, page_table.shape,
                          lengths.shape):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, pools "
            f"{tuple(k.shape)}, table {tuple(page_table.shape)}, lengths "
            f"{tuple(lengths.shape)} are not the paged decode pattern")
    _check_scales(k, k_scale, v_scale, "paged_decode_attention")
    H = q.shape[3]
    scale = H ** -0.5 if scale is None else float(scale)
    tp = 1 if mesh is None else int(mesh.shape.get(mesh_axis, 1))
    return _paged_shard(q, k, v, page_table, lengths, k_scale, v_scale,
                        scale=scale, tp=tp)


def _paged_shard(q, k, v, page_table, lengths, k_scale, v_scale, *,
                 scale: float, tp: int) -> torch.Tensor:
    if q.is_cuda:
        return _launch_paged(q, k, v, page_table, lengths, k_scale, v_scale,
                             scale=scale, tp=tp)
    return paged_decode_attention_plain(q, k, v, page_table, lengths,
                                        scale=scale, k_scale=k_scale,
                                        v_scale=v_scale)


def paged_decode_attention_tp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    tp: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """Kernel 4 in one process: a WHOLE call (q [B, Tq, N, H], pools
    [P, ps, K, H], scales [P, ps, K]) cut into ``tp`` shards on the kv
    heads — shard s takes query heads [s N/tp, (s+1) N/tp) and kv heads
    [s K/tp, (s+1) K/tp), each a contiguous copy, as a mesh rank holds
    it — each shard's kernel-3 launch in turn (what rank s launches),
    outputs concatenated on the heads. The reference's checks in its
    order (``decode_attention.py:449-486``, less its TPU VMEM budget);
    returns None where the reference declines: a shape outside
    :func:`paged_eligible`, or ``K % tp`` or ``N % tp`` not 0 (the heads
    would replicate and the gather path run)."""
    if not paged_eligible(q.shape, k.shape, v.shape, page_table.shape,
                          lengths.shape):
        return None
    if (k_scale is None) != (v_scale is None):
        return None
    N, K = q.shape[2], k.shape[2]
    if tp > 1 and (K % tp != 0 or N % tp != 0):
        return None
    _check_scales(k, k_scale, v_scale, "paged_decode_attention_tp")
    H = q.shape[3]
    scale = H ** -0.5 if scale is None else float(scale)
    n, kk = N // tp, K // tp
    outs = []
    for s in range(tp):
        def cut(t, m):
            return None if t is None else \
                t.narrow(2, s * m, m).contiguous()

        outs.append(_paged_shard(cut(q, n), cut(k, kk), cut(v, kk),
                                 page_table, lengths, cut(k_scale, kk),
                                 cut(v_scale, kk), scale=scale, tp=tp))
    return torch.cat(outs, dim=2)
