"""GPU smoke run of the PyTorch/CUDA port (``ray_dynamic_batching_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds the three kernels from ``csrc/`` (one process
   each, in parallel);
3. kernels — each kernel against its plain PyTorch version at the main
   paths' shapes, in bf16 and f32 (the paged kernel also at a Tq = 4
   staircase window in f32; flash also at a paged chunk deep in a long
   prompt, q [2, 64, 32, 128] over 512 positions with 3 and 5 live KV
   tiles, and at the unmasked attention of ViT-B/16, q/k/v [64, 197, 12,
   64], and of ViT-G/14, [32, 257, 16, 104] (head_dim 104), each fed as
   the model feeds it: views of one packed qkv projection, read in place;
   their bounds count q, k, v and out once), and the int8-KV branch of
   both decode kernels (int8 codes +
   f32 scales, q in bf16 and f32): max abs error against the stated
   tolerance, median CUDA-event times of kernel / plain version / a
   PyTorch yardstick never used by the port (one
   ``F.scaled_dot_product_attention`` call for flash and slab decode;
   gather + SDPA, 3 calls, for the paged kernel; dequantize + SDPA, 3
   calls, and gather + dequantize + SDPA, 7 calls, for the int8
   branches), and the bound from bytes and FLOPs over what the call's
   data needs: the K/V of the positions some window row attends (kernels
   1 and 2 skip the 64-key tiles no row attends; kernel 3 the tiles past
   each length). The masked kernels are timed on the int8 keep-mask
   [B, 1, Tq, S], which the model makes once per forward and every
   layer's call takes as it is; their time on a boolean mask, which the
   wrapper casts first (one more kernel a call; the paged arm's flash
   chunks still build their staircase mask per layer), and the dense
   bound (every position of k and v read), are printed beside;
4. parity — llama3_8b at full width, 2 layers, f32, with the model's own
   cache and with the int8 KV cache: slab ``prefill`` then one
   ``decode_step``, and paged ``prefill_chunk_paged`` (a W = 64 and a
   W = 8 chunk) then ``decode_step_paged``, each through the kernels and
   through the plain versions; the paged logits also against the slab
   logits of the same prompts; the int8-vs-f32-cache logit difference is
   printed, not gated;
5. main — ``LLMDeployment("llama3_8b")`` (slab + monolithic prefill) at
   full width and depth in bf16 with random weights serves 8 requests
   (6 greedy, 2 sampled);
6. paged — ``LLMDeployment("llama3_8b", paged=True)`` (paged pool +
   token-budget chunked prefill), the same model rebuilt after phase 5's
   is freed, serves 10 requests: 8 of 40-60 tokens (6 greedy, 2 sampled)
   and 2 greedy of 150-300 tokens, which run as multi-chunk trains;
7. int8 — ``LLMDeployment("llama3_8b", quantize_kv=True)`` (slab + mono,
   int8 KV cache) serves phase 6's 10 requests; the two long prompts go
   through the long fill;
8. int8_paged — ``LLMDeployment("llama3_8b", paged=True,
   quantize_kv=True)`` serves the same 10, and the cache bytes of the
   serving phases are printed side by side;
9. slab_chunked — ``LLMDeployment("llama3_8b", chunked_prefill=True)``
   (slab cache, token-budget chunk trains on row caches) serves the same
   10: every prompt is a train of 64-token chunks; its tok/s and TTFT are
   printed beside phases 5 and 7;
10. front — the default deployment built as ``bench.py`` builds it:
    ``make_replica`` -> ``Router(max_assign_timeout_s=30)`` ->
    ``DeploymentHandle(default_slo_ms=300000)``, an ``HTTPProxy`` on
    127.0.0.1 in front. Saturation: 16 greedy requests of 40-60 tokens
    through ``handle.remote`` (tok/s, capacity = tok/s / 32 req/s); then
    Poisson arrivals at 0.6 x capacity for 8 s from ``WorkloadDriver``
    (TTFT p50 / p99, the engine's TTFT breakdown, KV occupancy, the
    handle + router hop per request); then one buffered and one streamed
    ``POST /api/llama3_8b``, and ``GET /metrics``, which must carry the
    engine's ``rdb_decode_*`` families. Every request is answered (none
    rejected), the router routed exactly the requests submitted, and the
    streamed chunks equal the final line's tokens. The Poisson window
    alone runs with a ``ChromeTraceCollector`` installed: the load
    generator opens a root span for each arrival (submit -> answer; the
    serving path's spans join its trace), and ``request_ledgers`` splits
    each request into hops, once whole and once cut at its first token
    (the end of its ``decode.prefill``): every ledger must conserve, the
    served ledgers must be the answered requests, and the phase prints
    the per-hop p50 / p95 of both, the queue wait split by whether every
    slot was decoding at arrival (beside the share spent waiting out a
    scan), the 8 slowest TTFT ledgers and the engine's ``snapshot()``,
    and writes the Chrome trace to ``build/traces/front.json``;
11. controller — the declarative path of the README: ``apply_config``
    deploys application ``chat`` (route ``/chat``) with one ``llm:``
    deployment ``llama3_8b`` (phase 5's knobs, version ``v1``,
    ``max_ongoing_requests`` 4096) on the module controller and the module
    HTTP proxy that ``serve.api`` starts. Through the returned handle: 16
    saturating requests (tok/s and TTFT p50 beside phase 10's), one
    buffered and one streamed ``POST /chat``, ``serve.api.status()``; a
    redeploy of the same version with ``max_ongoing_requests`` 128
    reconfigures the live replica and every bucket queue; a wedged engine
    is replaced by the control loop and a 48-token probe served alone
    gives the same greedy tokens before and after; a 96-token generation
    decoding on v1 finishes through the rolling update to ``v2`` (the v1
    model through ``model=``, ``default_max_new_tokens`` 40), after which
    a request without ``max_new_tokens`` gets 40 tokens; after
    ``serve.api.shutdown()`` the device memory is back within 0.5 GB of
    its value before the phase;
12. colocate — measured tables and Nexus colocation. The memory budget
    (``hbm_budget_bytes``) is set from the card's total memory through the
    config. ``DecodeProfiler`` sweeps llama3_8b's decode step (every slot
    active, horizon 1) at 4, 8, 16 and 32 slots, capacity 512, and its
    prefill group program at bucket 64, groups 1 and 4 (8 timed
    dispatches, 2 warmup), prints every row and writes the two summary
    tables into ``build/profiles_h100/``; a zero row fails.
    ``LLMDeployment(num_slots=0, profiles_dir=...)`` builds an engine from
    the table plan (slots and both horizons, from the token SLO and the
    model's registered 150 ms TTFT SLO), and ``auto_num_slots()`` sizes
    from the same budget (256, the cap). A deployment with
    ``length_buckets=[256, 512]`` serves a prompt that fits 256 and one
    (300 tokens, the long fill) that needs 512, each reaching its own
    engine. Then two contracts, ``llama_a`` and ``llama_b``, share one
    model: ``pack_llm_engines`` plans them from the table just written,
    one ``ColocatedLLMEngines`` on the card runs the plan under an
    ``LLMLiveScheduler`` (control interval 2 s, rate window 8 s,
    headroom 0.85). The token SLO is twice ``slo_safety_factor`` times
    the 16-slot step (at once that step, the packer's SLO term alone
    would need two cards for the pair; the phase prints the plan it would
    give). Poisson arrivals of 40-60-token greedy prompts with 32 new
    tokens (seed 11) offer each contract 0.1 of the 16-slot row's
    full-occupancy throughput for 20 s, then 20 s with ``llama_a`` at
    twice that. Per contract and half: sent, completed, dropped, stale,
    SLO compliance, token gap and TTFT; planned fractions beside measured
    busy shares; the audit log; which branch the replan after the surge
    took, and whether it moved the plan. The phase fails on a dropped,
    stale or unanswered request; when no replan after the surge saw
    ``llama_a`` at 1.5 times its first-half offered rate, or the last such replan
    applied a plan other than the packer's for the rates it saw; on a
    48-token greedy probe through ``llama_a``'s colocated engine that
    differs from a lone engine of the same shape; or on device memory
    held by tensors after the shutdown more than 0.1 GB above its value
    before the phase (both read with cuBLAS's per-thread workspaces
    dropped: the process keeps one for each thread that ran a GEMM, and
    the phase starts several threads). The same traffic then runs again
    at 0.2 as a diagnostic that gates nothing but a lost request: at 0.2
    the packer admits a pair the host-bound card cannot keep, and the
    run prints how far it falls short. The diagnostic run alone is
    traced: each contract's ``decode.turn`` time per step is printed
    against the number of sequences active in the turn.

13. vision — the Nexus vision path, bf16 with random weights from seed 0.
    Parity: ``resnet50``, ``shufflenet_v2``, ``efficientnet_v2s``,
    ``vit_b_16`` and ``vit_g_14`` (48 layers, head_dim 104) at 224 x 224,
    batch 8, in f32 on the card (TF32 off): logits through the kernel
    route against ``plain_attention()``, held to 1e-4 (only the ViTs
    differ: 12 and 48 flash launches a forward); then the served bf16
    model's logits on the same input against that f32 forward, held to
    5e-2 x max |logit|. Profiles: ``ModelProfiler`` sweeps the
    reference's accelerator buckets (resnet50 1-1024, shufflenet_v2
    1-2048, efficientnet_v2s 1-512 at its 384, vit_b_16 1-256) into
    ``build/profiles_h100/`` and prints every row; ``vit_g_14``, which the
    SLO run does not serve (nor does the reference's demo), is timed at
    batch 1 and 32 through ``ModelProfiler.profile_bucket`` and printed.
    The SLO run is ``tools/run_slo_demo.py``'s non-CPU shape: the three
    demo models' tables -> ``SquishyBinPacker`` (12 GiB) -> three
    ``ReplicaEngine``s on the card under one ``LiveScheduler`` (monitor
    every 5 s, rate window 10 s, 5% threshold), SLOs 2000 / 1500 /
    4000 ms, Poisson arrivals of one NHWC example at min(200, max(0.2,
    0.010 x profiled peak)) rps for 60 s, resnet50's rate doubled at
    30 s. It prints the plans, the replans with their rates, per model
    the sent / completed / stale / dropped counts and the compliance of
    each half, per engine the batches, busy share beside the planned
    occupancy and step / profiled-latency ratios, and resnet50's queue
    depth every 5 s. The scheduler plans at 1.5 x the rates it reads
    (``RATE_HEADROOM`` in ``scheduler/control.py``). It fails on a request
    not accounted for, when no rate-change replan after the shift saw
    resnet50 at 1.5 x its offered rate, or on a compliance under 0.95 in
    any half of any model. After the gated run (its numbers read first,
    with tracing off throughout), 10 s more at the second half's rates
    run traced: every 4th arrival goes in under a load root and a
    ``handle.remote`` span (``tools/run_slo_demo.py``'s shape); the
    phase prints those requests' per-hop p50 / p95, the 5 slowest
    requests' ledgers and, per model,
    ``collate.batch`` against the ``engine.step`` it runs in and the step
    less its collate against the profiled row, and writes
    ``build/traces/vision.json``; a traced request not answered or a
    ledger that does not conserve fails it.

Phases 5 to 13 each set every launch count to 0 just before they serve and
read them just after: each kernel of the path must have launched the
number of times the engine's dispatches imply, the other kernels and the
plain route never. Phase 11 builds three engines inside its window (v1,
the heal's replacement, v2), and each engine's warmup launches its
prefill grid (one group of each size up to 4 at the one bucket) and two
decode steps; those warmup dispatches are added to the dispatches the
engines counted while serving. Phase 12 adds, beside its engines'
dispatches and warmups (the length-bucket replica's two engines and every
engine the scheduler builds are warmed), the profiler's: each config runs
2 + 3 x 8 dispatches, one prefill group or one decode step each. Phase 13
sets them to 0 just before its SLO run and reads them after its traced
window: flash = 12 x (the vit_b_16 batches served in both + the vit_b_16
buckets the engines warmed).

The line before the last is one JSON object with the per-kernel numbers
(``launches`` sums the serving phases; ``launches_by_path`` splits them)
and the numbers of the front, controller, colocate and vision phases
(``front``, ``controller``, ``colocate``, ``vision``; the per-hop splits
under ``front.hops``, ``colocate.runs.diagnostic.turns`` and
``vision.traced``); the last line is
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (for
bring-up); the default runs all. ``--profile`` traces each serving window
with ``torch.profiler`` and prints the device's busy share and its time by
kernel (used for PERF.md's breakdown).

Tolerances: bf16 2e-2 absolute — kernel and plain version both accumulate
in f32 from the same bf16 inputs, and the outputs (|x| < 4) differ by at
most a couple of bf16 ulps (2^-8 at 1) from the probabilities rounded at
another running max; f32 1e-4 — the same math summed in another order.
Model parity: 1e-3 absolute on logits of unit scale, two layers of f32
matmuls between the two attention paths (with int8 KV an f32 sum in
another order can flip a code at a .5 boundary in layer 1, which moves
these logits by ~2e-4). The paged run is also held, at 1e-3, to the slab
path in the same chunks (``prefill_chunk``), whose k/v come from the
same products.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import http.client
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LOGIT_TOL = 1e-3

# Main-path shapes (llama3_8b, 16 slots, max_len 512, bucket 64, groups of
# 4; paged: 128-token pages, 4 table entries per slot, a 64-page pool).
NB, T, S, SLOTS = 4, 64, 512, 16
N_HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
PS = 128
NP = S // PS
POOL = SLOTS * NP
# ViT-B/16's attention (phase 3's vit case): batch 64, 197 tokens, 12
# heads of 64; ViT-G/14's (the vit_g case): batch 32, 257 tokens, 16
# heads of 104.
VIT_SHAPE = (64, 197, 12, 64)
VIT_G_SHAPE = (32, 257, 16, 104)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, launches: int = 20, batches: int = 5) -> float:
    """Device time of one call: the median over ``batches`` of (CUDA-event
    time of ``launches`` back-to-back calls) / ``launches``. A spin kernel
    queued first keeps the card busy while the host enqueues the batch,
    so host-side wrapper time does not enter the measurement."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)   # ~30 ms of spinning at H100 clocks
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def bound(nbytes: int, flops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {line}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"cards {torch.cuda.device_count()}", flush=True)
    return {"smi": line, "kind": torch.cuda.get_device_name(0)}


def phase_build() -> None:
    from ray_dynamic_batching_tpu_torch.ops import _build

    seconds = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
        for ln in _build.ptxas_log.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[ptxas] {name}: {ln.strip()}", file=sys.stderr)
    print(f"[build] {len(_build.KERNELS)} kernels built and loaded in "
          f"{seconds:.3f} s", flush=True)


# --- phase 3: each kernel against its plain version ------------------------
def _prefill_inputs(dtype, gen, rng):
    from ray_dynamic_batching_tpu_torch.models.decoder import prefill_mask

    dev = "cuda"
    q = torch.randn((NB, T, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((NB, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((NB, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    lengths = torch.tensor([40, 47, 53, 60], device=dev)
    attn = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).int()
    mask = torch.cat([prefill_mask(attn), torch.zeros(
        (NB, 1, T, S - T), dtype=torch.bool, device=dev)], dim=-1)
    return _with_keep_mask(dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                                mask=mask))


def _with_keep_mask(x):
    """Beside the boolean mask, the int8 keep-mask [B, Tq, S] the kernels
    read, made once, as the model makes it once per forward for all its
    layers (``ops/attention.py`` ``kernel_mask``): ``ms`` is the call as
    the slab layers make it; ``ms_bool_mask`` is the call on the boolean
    mask, the wrapper's cast included."""
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    B, Tq = x["q"].shape[:2]
    return dict(x, keep=fl.keep_mask(x["mask"], B, Tq, x["k"].shape[1]))


def _paged_chunk_inputs(dtype, gen, rng):
    """A paged chunk deep in a long prompt, as the paged arm's flash call
    sees it: q [2, 64, 32, 128] over the gathered view k/v [2, 512, 8, 128]
    with the staircase of lengths 128 and 256 (3 and 5 live KV tiles)."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        paged_window_mask,
    )

    dev = "cuda"
    q = torch.randn((2, T, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((2, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((2, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    mask = paged_window_mask(torch.tensor([128, 256], device=dev), S, T)
    return _with_keep_mask(dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                                mask=mask))


def _packed_qkv(shape, dtype, gen):
    """q, k, v [B, T, N, H] as ``models/vit.py`` hands them to the
    attention: views of one packed [B, T, 3 N H] projection (strided over
    tokens, heads H apart), non-causal, no mask."""
    B, T, N, H = shape
    qkv = torch.randn((B, T, 3 * N * H), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = qkv.view(B, T, 3, N, H).unbind(2)
    return dict(q=q, k=k, v=v, mask=None, keep=None)


def _vit_inputs(dtype, gen, rng):
    """ViT-B/16's attention at the profiled batch 64 (197 tokens: 13
    query slabs of 16, the last with 5 rows)."""
    return _packed_qkv(VIT_SHAPE, dtype, gen)


def _vit_g_inputs(dtype, gen, rng):
    """ViT-G/14's attention at batch 32 (257 tokens, head_dim 104 on the
    kernel's 128-wide tiles)."""
    return _packed_qkv(VIT_G_SHAPE, dtype, gen)


def _qkvo_cost(x) -> tuple:
    """An unmasked call reads q, k and v once and writes out once; FLOPs
    4 B N Tq Tk H."""
    B, Tq, N, H = x["q"].shape
    return (_nbytes(x["q"], x["k"], x["v"], x["q"]),
            4 * B * N * Tq * x["k"].shape[1] * H)


def _decode_inputs(dtype, gen, rng):
    from ray_dynamic_batching_tpu_torch.models.decoder import decode_mask

    dev = "cuda"
    q = torch.randn((SLOTS, 1, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((SLOTS, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((SLOTS, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    lengths = torch.randint(40, S - 1, (SLOTS,), generator=gen, device=dev)
    return _with_keep_mask(dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                                mask=decode_mask(lengths, S)))


def _quantized(x):
    """The same inputs with k/v as int8 codes + f32 scales, quantized by
    the cache's write rule."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        quantize_kv_rows,
    )

    k, ks = quantize_kv_rows(x["k"])
    v, vs = quantize_kv_rows(x["v"])
    return dict(x, k=k, v=v, ks=ks, vs=vs)


def _int8_decode_inputs(dtype, gen, rng):
    return _quantized(_decode_inputs(dtype, gen, rng))


def _int8_paged_inputs(dtype, gen, rng, tq: int = 1):
    return _quantized(_paged_inputs(dtype, gen, rng, tq))


def _paged_inputs(dtype, gen, rng, tq: int = 1):
    """A 64-page pool in shuffled order, lengths 40..510 over the 16 slots
    (in shuffled slot order), each slot holding just the pages its
    positions <= length + tq - 1 need and the sentinel past them."""
    dev = "cuda"
    q = torch.randn((SLOTS, tq, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((POOL, PS, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((POOL, PS, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    lengths = np.minimum(np.linspace(40, 510, SLOTS).astype(np.int32),
                         S - tq)
    rng.shuffle(lengths)
    perm = rng.permutation(POOL)
    table = np.full((SLOTS, NP), POOL, np.int32)
    used = 0
    for b in range(SLOTS):
        n = -(-(int(lengths[b]) + tq) // PS)
        table[b, :n] = perm[used: used + n]
        used += n
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                table=torch.from_numpy(table).to(dev),
                lengths=torch.from_numpy(lengths).to(dev))


def _sdpa(q, k, v, mask):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True,
    ).transpose(1, 2)


def _scales(x) -> list:
    return [x[n] for n in ("ks", "vs") if n in x]


def _dense_cost(x) -> tuple:
    """Bytes (q, k, v, the scales of int8 k/v, out once each, the int8
    mask one byte an entry) and FLOPs (4 B N Tq S H) of a dense-window
    call, printed beside the recount over attended positions."""
    B, tq = x["q"].shape[:2]
    Tk = x["k"].shape[1]
    nbytes = _nbytes(x["q"], x["k"], x["v"], x["q"], *_scales(x), x["keep"])
    return nbytes, 4 * B * N_HEADS * tq * Tk * HEAD_DIM


def _masked_cost(x) -> tuple:
    """What this call's data needs (kernels 1 and 2): the K/V (and, int8,
    the scales) of the positions that at least one window row attends,
    read once, plus q, out and the int8 mask; FLOPs 4 N H per attended
    (row, key) pair. The kernels skip the 64-key tiles no row attends."""
    keep = x["keep"] != 0                               # [B, Tq, Tk]
    positions = int(keep.any(dim=1).sum().item())
    pairs = int(keep.sum().item())
    kv_elt = KV_HEADS * HEAD_DIM * x["k"].element_size()
    if "ks" in x:
        kv_elt += KV_HEADS * 4
    nbytes = 2 * positions * kv_elt + 2 * _nbytes(x["q"]) + _nbytes(x["keep"])
    return nbytes, 4 * N_HEADS * HEAD_DIM * pairs


def _paged_cost(x) -> tuple:
    """What this call's data needs: each slot reads the K/V (and, int8,
    the scales) of positions [0, length + Tq) once (the kernel skips tiles
    past them), plus q, out, the table and the lengths; FLOPs 4 N Tq H per
    attended position."""
    B, tq = x["q"].shape[:2]
    kv_elt = KV_HEADS * HEAD_DIM * x["k"].element_size()
    if "ks" in x:
        kv_elt += KV_HEADS * 4
    positions = int((x["lengths"].long() + tq).sum().item())
    nbytes = (2 * positions * kv_elt + 2 * _nbytes(x["q"])
              + _nbytes(x["table"], x["lengths"]))
    return nbytes, 4 * N_HEADS * tq * HEAD_DIM * positions


def _dequant_sdpa(x):
    """The int8 slab yardstick: dequantize k and v, then SDPA (3 calls)."""
    from ray_dynamic_batching_tpu_torch.models.decoder import dequantize_kv

    dt = x["q"].dtype
    return _sdpa(x["q"], dequantize_kv(x["k"], x["ks"], dt),
                 dequantize_kv(x["v"], x["vs"], dt), x["mask"])


def _gather_sdpa(x):
    """The paged yardstick: gather the logical view (k, v; with int8 pools
    also their scales, then dequantize them), then SDPA — 3 calls, 7 with
    int8 pools."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        dequantize_kv,
        paged_window_mask,
    )
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec

    k_g = dec.logical_view(x["k"], x["table"])
    v_g = dec.logical_view(x["v"], x["table"])
    if "ks" in x:
        dt = x["q"].dtype
        k_g = dequantize_kv(k_g, dec.logical_view(x["ks"], x["table"]), dt)
        v_g = dequantize_kv(v_g, dec.logical_view(x["vs"], x["table"]), dt)
    mask = paged_window_mask(x["lengths"], k_g.shape[1], x["q"].shape[1])
    return _sdpa(x["q"], k_g, v_g, mask)


def _kernel_specs():
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    return {
        "flash_attention": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/flash_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/flash_attention.py:154",
            inputs=_prefill_inputs,
            kernel=lambda x: fl.flash_attention(
                x["q"], x["k"], x["v"],
                mask=None if x["keep"] is None else x["keep"][:, None]),
            kernel_bool_mask=lambda x: fl.flash_attention(
                x["q"], x["k"], x["v"], mask=x["mask"]),
            plain=lambda x: fl.flash_attention_plain(
                x["q"], x["k"], x["v"], x["keep"]),
            library=lambda x: _sdpa(x["q"], x["k"], x["v"], x["mask"]),
            yardstick=None,
            cost=_masked_cost,
            # A paged chunk deep in a long prompt (3 and 5 live tiles),
            # and ViT-B/16's and ViT-G/14's unmasked attention (the
            # vision path).
            serving_cases=[("paged_chunk", _paged_chunk_inputs, None),
                           ("vit", _vit_inputs, _qkvo_cost),
                           ("vit_g", _vit_g_inputs, _qkvo_cost)],
        ),
        "decode_attention": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/decode_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:238",
            inputs=_decode_inputs,
            kernel=lambda x: dec.decode_attention(x["q"], x["k"], x["v"],
                                                  mask=x["keep"][:, None]),
            kernel_bool_mask=lambda x: dec.decode_attention(
                x["q"], x["k"], x["v"], mask=x["mask"]),
            plain=lambda x: dec.decode_attention_plain(
                x["q"], x["k"], x["v"], x["keep"]),
            library=lambda x: _sdpa(x["q"], x["k"], x["v"], x["mask"]),
            yardstick=None,
            cost=_masked_cost,
        ),
        "paged_decode_attention": dict(
            source=("ray_dynamic_batching_tpu_torch/csrc/"
                    "paged_decode_attention.cu"),
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:319",
            inputs=_paged_inputs,
            kernel=lambda x: dec.paged_decode_attention(
                x["q"], x["k"], x["v"], x["table"], x["lengths"]),
            plain=lambda x: dec.paged_decode_attention_plain(
                x["q"], x["k"], x["v"], x["table"], x["lengths"]),
            library=None,       # no one PyTorch call reads a page table
            yardstick=(_gather_sdpa, "gather + sdpa (3 calls)"),
            cost=_paged_cost,
            extra_cases=[(torch.float32, 4)],   # Tq = 4 staircase
        ),
        # The int8-KV branch of kernels 2 and 3: the same sources and
        # wrappers, 1-byte codes + f32 scales (the reference's scale
        # BlockSpecs and _scan_tile's ks/vs arithmetic).
        "decode_attention_int8": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/decode_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:268",
            inputs=_int8_decode_inputs,
            kernel=lambda x: dec.decode_attention(
                x["q"], x["k"], x["v"], mask=x["keep"][:, None], k_scale=x["ks"],
                v_scale=x["vs"]),
            kernel_bool_mask=lambda x: dec.decode_attention(
                x["q"], x["k"], x["v"], mask=x["mask"], k_scale=x["ks"],
                v_scale=x["vs"]),
            plain=lambda x: dec.decode_attention_plain(
                x["q"], x["k"], x["v"], x["keep"], k_scale=x["ks"],
                v_scale=x["vs"]),
            library=None,       # no one PyTorch call reads int8 codes
            yardstick=(_dequant_sdpa, "dequantize + sdpa (3 calls)"),
            cost=_masked_cost,
        ),
        "paged_decode_attention_int8": dict(
            source=("ray_dynamic_batching_tpu_torch/csrc/"
                    "paged_decode_attention.cu"),
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:354",
            inputs=_int8_paged_inputs,
            kernel=lambda x: dec.paged_decode_attention(
                x["q"], x["k"], x["v"], x["table"], x["lengths"],
                k_scale=x["ks"], v_scale=x["vs"]),
            plain=lambda x: dec.paged_decode_attention_plain(
                x["q"], x["k"], x["v"], x["table"], x["lengths"],
                k_scale=x["ks"], v_scale=x["vs"]),
            library=None,
            yardstick=(_gather_sdpa, "gather + dequantize + sdpa (7 calls)"),
            cost=_paged_cost,
            extra_cases=[(torch.float32, 4)],
        ),
    }


def _check(name: str, tag: str, sp, x, dtype) -> float:
    """The kernel against its plain version on ``x``: max abs error, held
    to the dtype's tolerance (fails the run past it)."""
    out = sp["kernel"](x)
    torch.cuda.synchronize()
    ref = sp["plain"](x)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out.float()).all():
        fail(f"{name} {tag}: non-finite output")
    print(f"[kernels] {name} {tag} q{tuple(x['q'].shape)} "
          f"k{tuple(x['k'].shape)}: max_abs_err {err:.3e} "
          f"(tol {TOL[dtype]:.0e})", flush=True)
    if not err <= TOL[dtype]:
        fail(f"{name} {tag}: max_abs_err {err} > {TOL[dtype]}")
    return err


def _timed(sp, x, dtype, cost=None) -> dict:
    """Kernel, plain, library / yardstick times and the bounds of one bf16
    case: the bound over what the call needs, and (kernels 1 and 2, on a
    masked case) the dense bound (every position read)."""
    cost = cost or sp["cost"]
    nbytes, flops = cost(x)
    b_ms, b_by = bound(nbytes, flops, dtype)
    row = dict(ms=time_ms(lambda: sp["kernel"](x)),
               plain_ms=time_ms(lambda: sp["plain"](x)),
               library_ms=(time_ms(lambda: sp["library"](x))
                           if sp["library"] else None),
               bound_ms=b_ms, bound_by=b_by, bound_mb=nbytes / 1e6)
    if "kernel_bool_mask" in sp and x["mask"] is not None:
        row["ms_bool_mask"] = time_ms(lambda: sp["kernel_bool_mask"](x))
    if cost is _masked_cost:
        d_bytes, d_flops = _dense_cost(x)
        row["dense_bound_ms"], _ = bound(d_bytes, d_flops, dtype)
    if sp["yardstick"] is not None:
        fn, row["yardstick"] = sp["yardstick"]
        row["yardstick_ms"] = time_ms(lambda: fn(x))
    return row


def _print_times(name: str, row: dict) -> None:
    lib = (f"sdpa {row['library_ms']:.4f} ms"
           if row["library_ms"] is not None else
           f"{row['yardstick']} {row['yardstick_ms']:.4f} ms")
    extra = ""
    if "ms_bool_mask" in row:
        extra += f" ({row['ms_bool_mask']:.4f} ms with the bool-mask cast)"
    dense = ""
    if "dense_bound_ms" in row:
        dense = f"; dense bound {row['dense_bound_ms']:.4f} ms"
    print(f"[kernels] {name} bf16: kernel {row['ms']:.4f} ms{extra}, plain "
          f"{row['plain_ms']:.4f} ms, {lib}, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {row['bound_mb']:.1f} MB){dense}", flush=True)


def phase_kernels() -> dict:
    from ray_dynamic_batching_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    results = {}
    for name, sp in _kernel_specs().items():
        row = {"name": name, "route": "cuda", "source": sp["source"],
               "replaces": sp["replaces"]}
        cases = [(torch.float32, None), (torch.bfloat16, None)]
        cases += sp.get("extra_cases", [])
        for dtype, tq in cases:
            make = sp["inputs"]
            x = make(dtype, gen, rng) if tq is None else make(dtype, gen,
                                                             rng, tq)
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            if tq is not None:
                tag += f" Tq={tq}"
            err = _check(name, tag, sp, x, dtype)
            if tq is not None:
                row[f"max_abs_err_f32_tq{tq}"] = err
                continue
            if dtype == torch.float32:
                row["max_abs_err_f32"] = err
                continue
            row.update(
                dtype="bfloat16",
                kv_dtype=str(x["k"].dtype).replace("torch.", ""),
                q_shape=list(x["q"].shape), kv_shape=list(x["k"].shape),
                max_abs_err=err, **_timed(sp, x, dtype))
            _print_times(name, row)
        for case, make, cost in sp.get("serving_cases", []):
            for dtype in (torch.float32, torch.bfloat16):
                x = make(dtype, gen, rng)
                tag = ("bf16" if dtype == torch.bfloat16 else "f32") + \
                    f" {case}"
                err = _check(name, tag, sp, x, dtype)
                if dtype == torch.float32:
                    row[f"{case}_max_abs_err_f32"] = err
                    continue
                sub = dict(q_shape=list(x["q"].shape),
                           kv_shape=list(x["k"].shape), max_abs_err=err,
                           **_timed(sp, x, dtype, cost))
                _print_times(f"{name} {case}", sub)
                row.update({f"{case}_{k}": v for k, v in sub.items()})
        results[name] = row
    attention.reset_counts()   # comparison launches do not count
    return results


# --- phase 4: model parity --------------------------------------------------
def _counts() -> dict:
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    return {"flash_attention": fl.launches,
            "decode_attention": dec.launches,
            "paged_decode_attention": dec.paged_launches,
            "decode_attention_int8": dec.int8_launches,
            "paged_decode_attention_int8": dec.paged_int8_launches,
            "plain": attention.plain_launches}


def _expect_only(tag: str, counts: dict, want: dict) -> None:
    """Every kernel count equals ``want`` (missing names: 0)."""
    got = {n: c for n, c in counts.items() if c or n in want}
    if got != want:
        fail(f"{tag}: launched {counts}, expected {want} and nothing else")


def _parity(model, tag: str) -> tuple:
    """Slab prefill + decode and paged chunks + decode through the kernels
    and through the plain versions (1e-3 apart), the paged logits also
    against the slab logits of the same prompts. Returns the kernel
    path's (slab, paged) logits."""
    from ray_dynamic_batching_tpu_torch.ops import attention

    int8 = model.kv_dtype == torch.int8
    suffix = "_int8" if int8 else ""
    V = model.cfg.vocab_size
    rng = np.random.default_rng(0)

    def cuda_i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    # Slab: a 64-token prompt and a 50-token one, prefill then one step.
    tokens = rng.integers(0, V, (2, T))
    attn = np.ones((2, T), np.int32)
    attn[1, 50:] = 0
    nxt = cuda_i32(rng.integers(0, V, (2, 1)))
    active = torch.ones((2,), dtype=torch.bool, device="cuda")

    def run_slab(toks, mask, cap=S):
        with torch.inference_mode():
            cache = model.make_cache(2, cap)
            first, cache = model.prefill(cuda_i32(toks), cuda_i32(mask),
                                         cache)
            second, cache = model.decode_step(nxt, cache, active)
            return first.float(), second.float()

    attention.reset_counts()
    got_slab = run_slab(tokens, attn)
    _expect_only(f"parity {tag} slab", _counts(), {
        "flash_attention": 2, "decode_attention" + suffix: 2})
    with attention.plain_attention():
        want = run_slab(tokens, attn)
    errs = [(g - w).abs().max().item() for g, w in zip(got_slab, want)]
    scale = max(w.abs().max().item() for w in want)
    print(f"[parity] llama3_8b width, 2 layers, f32, {tag}: prefill logits "
          f"err {errs[0]:.3e}, decode logits err {errs[1]:.3e} (|logits| "
          f"max {scale:.2f}, tol {LOGIT_TOL:.0e})", flush=True)
    if not all(np.isfinite(errs)) or max(errs) > LOGIT_TOL:
        fail(f"parity {tag}: logits differ by {errs}")

    # Paged: row 0 a 72-token prompt as a W = 64 chunk and a W = 8 chunk,
    # row 1 a 50-token prompt in the first chunk (idle, all-sentinel
    # table, in the second); then one paged decode step. Pages shuffled.
    long_p = rng.integers(0, V, 72)
    pool = 2 * NP
    perm = rng.permutation(pool)
    table = np.full((2, NP), pool, np.int32)
    table[0, :1] = perm[:1]                  # 72 + 1 positions: one page
    table[1, :1] = perm[1:2]
    tok1 = np.zeros((2, T), np.int32)
    tok1[0] = long_p[:T]
    tok1[1, :50] = tokens[1, :50]
    idle = table.copy()
    idle[1] = pool

    def run_paged():
        with torch.inference_mode():
            cache = model.make_paged_cache(2, pool, PS, S)
            first_1, _ = model.prefill_chunk_paged(
                cuda_i32(tok1), cuda_i32(attn), cache, cuda_i32(table),
                cuda_i32([0, 0]), cuda_i32([T - 1, 49]))
            tok2 = np.zeros((2, 8), np.int32)
            tok2[0] = long_p[T:]
            first_0, _ = model.prefill_chunk_paged(
                cuda_i32(tok2), cuda_i32([[1] * 8, [0] * 8]), cache,
                cuda_i32(idle), cuda_i32([T, 0]), cuda_i32([7, 0]))
            cache.page_table = cuda_i32(table)
            cache.lengths = cuda_i32([72, 50])
            second, cache = model.decode_step_paged(nxt, cache, active)
            return (torch.stack([first_0[0], first_1[1]]).float(),
                    second.float())

    def run_slab_chunks():
        """The same two chunks and decode step on a slab cache through
        ``prefill_chunk`` (the long fill's program): every k/v row comes
        from the same products as the paged run's."""
        with torch.inference_mode():
            cache = model.make_cache(2, S)
            first_1, cache = model.prefill_chunk(
                cuda_i32(tok1), cuda_i32(attn), cache, 0, 49)
            tok2 = np.zeros((2, 8), np.int32)
            tok2[0] = long_p[T:]
            first_0, cache = model.prefill_chunk(
                cuda_i32(tok2), cuda_i32([[1] * 8, [0] * 8]), cache, T, 7)
            second, cache = model.decode_step(nxt, cache, active)
            return (torch.stack([first_0[0], first_1[1]]).float(),
                    second.float())

    attention.reset_counts()
    got_paged = run_paged()
    _expect_only(f"parity {tag} paged", _counts(), {
        "flash_attention": 2, "paged_decode_attention" + suffix: 4})
    with attention.plain_attention():
        want = run_paged()
    errs = [(g - w).abs().max().item() for g, w in zip(got_paged, want)]
    errs_chunks = [(g - w).abs().max().item()
                   for g, w in zip(got_paged, run_slab_chunks())]
    slab_toks = np.zeros((2, 72), np.int32)
    slab_toks[0] = long_p
    slab_toks[1, :50] = tokens[1, :50]
    slab_mask = np.ones((2, 72), np.int32)
    slab_mask[1, 50:] = 0
    slab = run_slab(slab_toks, slab_mask)
    errs_slab = [(g - w).abs().max().item() for g, w in zip(got_paged, slab)]
    print(f"[parity] paged, f32, {tag}: chunk logits err {errs[0]:.3e}, "
          f"decode logits err {errs[1]:.3e} vs plain; vs the slab path in "
          f"the same chunks {errs_chunks[0]:.3e} / {errs_chunks[1]:.3e}; "
          f"vs the slab path's one-shot prefill {errs_slab[0]:.3e} / "
          f"{errs_slab[1]:.3e}{' (not gated)' if int8 else ''} "
          f"(tol {LOGIT_TOL:.0e})", flush=True)
    # With int8 codes the one-shot prefill is not gated: its k/v come from
    # a [2, 72] product instead of [2, 64] + [2, 8] ones, f32 sums in
    # another order, and a value on a .5 code boundary rounds the other
    # way — one code flip moves these logits by ~2e-3 (measured on the
    # CPU at reduced width). The same-chunks run isolates the layouts.
    gated = errs + errs_chunks + ([] if int8 else errs_slab)
    if not all(np.isfinite(errs + errs_chunks + errs_slab)) or \
            max(gated) > LOGIT_TOL:
        fail(f"paged parity {tag}: logits differ by {errs} / {errs_chunks} "
             f"/ {errs_slab}")
    return got_slab, got_paged


def phase_parity() -> None:
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    runs = {}
    for kv_dtype, tag in ((None, "f32 cache"), (torch.int8, "int8 KV")):
        # The same seed: the same weights in both models.
        model = CausalLM(cfg, "llama3_8b_2layer", dtype=torch.float32,
                         device="cuda", seed=0, kv_dtype=kv_dtype)
        runs[tag] = _parity(model, tag)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    diffs = [(a - b).abs().max().item()
             for pair in zip(runs["int8 KV"], runs["f32 cache"])
             for a, b in zip(*pair)]
    print("[parity] int8 KV against the f32 cache, same weights and prompts "
          "(not gated): slab prefill / decode, paged chunk / decode logits "
          "differ by " + " / ".join(f"{d:.3e}" for d in diffs), flush=True)


# --- phases 5 to 8: serving through LLMDeployment ---------------------------
def _profile_report(prof, wall_s: float) -> None:
    """Device time by kernel and the device's busy share of the window."""
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] window {wall_s * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}"
          f"%), idle {100 - 100 * busy_us / 1e3 / (wall_s * 1e3):.1f}%",
          flush=True)
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:14]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


def _serve(tag: str, payloads, dep_kwargs: dict, profile: bool):
    """Build a full-depth llama3_8b deployment, serve ``payloads`` with
    the launch counts zeroed just before, and return (results, counts,
    engine, wall seconds). The loop thread is stopped, the replica not."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    t0 = time.monotonic()
    dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                        **dep_kwargs)
    replica = dep.make_replica("llama3_8b-0",
                               DeploymentConfig(name="llama3_8b"))
    engine = replica.engine
    kv = "int8" if engine.model.kv_dtype == torch.int8 else "bf16"
    print(f"[{tag}] llama3_8b bf16 {engine.model.cfg.num_layers} layers, "
          f"{kv} KV cache, {engine.model.param_bytes() / 1e9:.2f} GB of "
          f"weights, replica built and warmed in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = _profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    with prof:
        attention.reset_counts()
        replica.start()
        t_start = time.monotonic()
        reqs = []
        for payload in payloads:   # arrival is stamped here, at assignment
            reqs.append(Request(model="llama3_8b", payload=payload,
                                slo_ms=600_000.0))
            if not replica.assign(reqs[-1]):
                fail(f"{tag}: replica refused a request")
        results = [r.future.result(timeout=600) for r in reqs]
        wall = time.monotonic() - t_start
        engine.stop()
        torch.cuda.synchronize()
        counts = _counts()
    if profile:
        _profile_report(prof, wall)
    V = engine.model.cfg.vocab_size
    for i, res in enumerate(results):
        if (len(res.tokens) != payloads[i]["max_new_tokens"]
                or res.finish_reason != "length"):
            fail(f"{tag} request {i}: {len(res.tokens)} tokens, "
                 f"{res.finish_reason}")
        if not all(0 <= t < V for t in res.tokens):
            fail(f"{tag} request {i}: token id out of vocab")
    return results, counts, engine, replica, wall


def _report(tag, results, counts, engine, wall) -> dict:
    ttfts = sorted(r.ttft_ms for r in results)
    n_tok = sum(len(r.tokens) for r in results)
    summary = dict(tok_s=n_tok / wall, ttft_p50_ms=statistics.median(ttfts),
                   ttft_max_ms=ttfts[-1])
    print(f"[{tag}] {len(results)} requests, {n_tok} tokens in {wall:.3f} s: "
          f"{summary['tok_s']:.1f} tok/s, TTFT p50 "
          f"{summary['ttft_p50_ms']:.1f} ms (max {ttfts[-1]:.1f} ms), "
          f"{engine.prefill_groups} prefill groups, {engine.chunk_dispatches}"
          f" chunk dispatches, {engine.long_chunk_dispatches} long-fill "
          f"chunks, {engine.steps} decode steps, launches {counts}",
          flush=True)
    print(f"[{tag}] TTFT parts {engine.ttft_breakdown()}", flush=True)
    return summary


def _payloads(rng, V, max_new, n_short, n_sampled, n_long) -> list:
    out = []
    for i in range(n_short + n_long):
        lo, hi = (40, 61) if i < n_short else (150, 301)
        prompt = rng.integers(0, V, int(rng.integers(lo, hi))).tolist()
        payload = {"tokens": prompt, "max_new_tokens": max_new}
        if n_short - n_sampled <= i < n_short:
            payload.update(temperature=0.8, top_k=50, seed=100 + i)
        out.append(payload)
    return out


# The serving knobs: 16 slots, max_len 512, one bucket of 64, groups of 4,
# horizon 8, 32 new tokens; paged: 128-token pages, a full-backing pool
# and a 256-token prefill budget.
SLAB_KNOBS = dict(num_slots=SLOTS, max_len=S, prompt_buckets=[T],
                  default_max_new_tokens=32, decode_horizon=8,
                  max_admissions_per_step=NB)
PAGED_KNOBS = dict(SLAB_KNOBS, paged=True, page_size=PS,
                   prefill_token_budget=256)


def _cache_bytes(engine) -> int:
    c = engine._cache
    return _nbytes(*[t for t in (c.k, c.v, c.k_scale, c.v_scale)
                     if t is not None])


def _expect_dispatches(tag: str, counts: dict, engine) -> None:
    """Each decode step runs the arm's decode kernel once per layer; flash
    runs once per layer for each prefill group, long-fill chunk
    (monolithic arms) or chunk dispatch (chunked arms); every other kernel
    and the plain route never."""
    L = engine.model.cfg.num_layers
    int8 = "_int8" if engine.model.kv_dtype == torch.int8 else ""
    decode = ("paged_decode_attention" if engine.paged
              else "decode_attention") + int8
    fills = (engine.prefill_groups + engine.long_chunk_dispatches
             + engine.chunk_dispatches)
    want = {decode: L * engine.steps, "flash_attention": L * fills}
    if not all(want.values()):
        fail(f"{tag}: a kernel of the path never launched: {want}")
    _expect_only(tag, counts, want)


def _serving_phase(tag: str, payloads, knobs: dict, profile: bool) -> tuple:
    """Serve ``payloads`` through a fresh deployment and hold every launch
    count to what the engine's dispatches imply (:func:`_expect_dispatches`).
    Returns (counts, cache bytes, tok/s and TTFT summary)."""
    gc.collect()
    torch.cuda.empty_cache()
    results, counts, engine, replica, wall = _serve(tag, payloads, knobs,
                                                    profile)
    _expect_dispatches(tag, counts, engine)
    # The two long prompts: chunks of T, as multi-chunk trains (chunked
    # arms) or through the long fill (monolithic arms).
    long_chunks = sum(-(-len(p["tokens"]) // T) for p in payloads
                      if len(p["tokens"]) > T)
    if engine.chunked_prefill and not engine.paged:
        # Slab trains: every prompt is a train of T-token chunks.
        chunks = sum(-(-len(p["tokens"]) // T) for p in payloads)
        if (engine.chunk_dispatches != chunks or engine.prefill_groups
                or engine.long_chunk_dispatches):
            fail(f"{tag}: {engine.chunk_dispatches} chunk dispatches, "
                 f"{engine.prefill_groups} prefill groups, "
                 f"{engine.long_chunk_dispatches} long-fill chunks; expected "
                 f"{chunks} chunk dispatches and nothing else")
    elif engine.chunked_prefill:
        # A multi-chunk train dispatches alone, once per chunk.
        if engine.chunk_dispatches < long_chunks:
            fail(f"{tag}: {engine.chunk_dispatches} chunk dispatches cannot "
                 f"have served the {long_chunks} chunks of the long prompts")
    elif engine.long_chunk_dispatches != long_chunks:
        fail(f"{tag}: {engine.long_chunk_dispatches} long-fill chunks, "
             f"expected {long_chunks}")
    if engine.paged:
        if engine.num_pages != POOL:
            fail(f"{tag}: pool of {engine.num_pages} pages, expected {POOL}")
        engine._allocator.check()
        if engine._allocator.free_pages != engine.num_pages:
            fail(f"{tag}: {engine._allocator.free_pages} of "
                 f"{engine.num_pages} pages free after the drain")
    summary = _report(tag, results, counts, engine, wall)
    summary["ttft_long_ms"] = [r.ttft_ms for p, r in zip(payloads, results)
                               if len(p["tokens"]) > T]
    if engine.paged:
        print(f"[{tag}] pool conserved: {engine.num_pages} of "
              f"{engine.num_pages} pages free after the drain", flush=True)
    nbytes = _cache_bytes(engine)
    print(f"[{tag}] KV cache {nbytes / 1e9:.3f} GB; "
          f"{engine.model.kv_bytes_per_slot(S) / 1e6:.1f} MB per slot at "
          f"max_len {S}", flush=True)
    replica.stop()
    return counts, nbytes, summary


# phase -> (launch-count path name, payloads of rng seed / long prompts,
# knobs): the int8 phases and slab_chunked serve phase 6's 10 requests.
SERVING = {
    "main": ("slab", 0, 0, SLAB_KNOBS),
    "paged": ("paged", 1, 2, PAGED_KNOBS),
    "int8": ("int8", 1, 2, dict(SLAB_KNOBS, quantize_kv=True)),
    "int8_paged": ("int8_paged", 1, 2, dict(PAGED_KNOBS, quantize_kv=True)),
    "slab_chunked": ("slab_chunked", 1, 2,
                     dict(SLAB_KNOBS, chunked_prefill=True)),
}


# --- phase 10: the front door ----------------------------------------------
def _answered(tag: str, fut, max_new: int):
    """A routed request's result: every request is answered with
    ``max_new`` tokens, none rejected."""
    try:
        res = fut.result(timeout=600)
    except Exception as e:  # noqa: BLE001 — a rejection fails the run
        fail(f"{tag}: request rejected or failed: {type(e).__name__}: {e}")
    if len(res.tokens) != max_new or res.finish_reason != "length":
        fail(f"{tag}: {len(res.tokens)} tokens, {res.finish_reason}")
    return res


def _post(proxy, path: str, payload: dict) -> tuple:
    """One POST through the proxy: (status, body text)."""
    conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


# --- flight records (phases 10, 12, 13) -------------------------------------
TRACE_DIR = "build/traces"


class _LoadRoots:
    """The load generator's own root span for each traced request: it
    opens before the request enters the serving path and closes when the
    request's future resolves. The generator originates the trace, as a
    client sending a W3C ``traceparent`` does, so the serving path's spans
    join it and a ledger's window is the request's latency as the client
    sees it. The roots stay with the generator; :meth:`spans` adds them
    to a capture."""

    NAME = "load.request"

    def __init__(self) -> None:
        self._roots: dict = {}
        self._lock = threading.Lock()

    def open(self, **attributes) -> dict:
        """A new root; returns the context its children join."""
        import random
        import uuid

        from ray_dynamic_batching_tpu_torch.utils.tracing import Span

        root = Span(name=self.NAME, trace_id=uuid.uuid4().hex,
                    span_id=random.getrandbits(63), parent_id=None,
                    start_ms=time.monotonic() * 1000.0,
                    attributes=dict(attributes))
        with self._lock:
            self._roots[root.trace_id] = root
        return root.context()

    def close_on(self, ctx: dict, fut) -> None:
        """Close the root when ``fut`` resolves."""
        root = self._roots[ctx["trace_id"]]

        def done(_f) -> None:
            root.end_ms = time.monotonic() * 1000.0

        fut.add_done_callback(done)

    def spans(self) -> list:
        with self._lock:
            return list(self._roots.values())


def _load_ledgers(tag: str, spans: list, loads: _LoadRoots,
                  cut_at: str | None = None) -> list:
    """The conserving hop ledger of every traced request whose root
    closed. With ``cut_at``, each root ends where its trace's span of
    that name ends (``decode.prefill``: the first token), so the ledger
    splits the TTFT. A ledger that does not conserve fails the phase."""
    from ray_dynamic_batching_tpu_torch.utils.hops import (
        LedgerError,
        request_ledgers,
    )

    roots = [r for r in loads.spans() if r.end_ms is not None]
    if cut_at is not None:
        ends = {s.trace_id: s.end_ms for s in spans if s.name == cut_at}
        roots = [dataclasses.replace(r, end_ms=ends[r.trace_id])
                 for r in roots if r.trace_id in ends]
    ids = {r.trace_id for r in roots}
    try:
        ledgers, _skipped = request_ledgers(list(spans) + roots,
                                            require_front_door=False)
    except LedgerError as e:
        fail(f"{tag}: a ledger does not conserve: {e}")
    return [l for l in ledgers if l.trace_id in ids]


def _hop_quantiles(ledgers: list) -> dict:
    """p50 / p95 (ms) of each hop over the ledgers, a ledger without the
    hop counting 0 ms, with the number of ledgers that have it; then the
    residual and the end-to-end."""
    from ray_dynamic_batching_tpu_torch.utils.hops import (
        HOP_ORDER,
        UNATTRIBUTED,
    )

    cols = {h: [l.hops.get(h, 0.0) for l in ledgers] for h in HOP_ORDER
            if any(h in l.hops for l in ledgers)}
    cols[UNATTRIBUTED] = [l.unattributed_ms for l in ledgers]
    cols["end_to_end"] = [l.end_to_end_ms for l in ledgers]
    return {h: dict(**_pcts(v), n=sum(1 for x in v if x > 0.0))
            for h, v in cols.items()}


def _print_hops(tag: str, label: str, ledgers: list) -> dict:
    q = _hop_quantiles(ledgers)
    worst = max(abs(sum(l.hops.values()) + l.unattributed_ms
                    - l.end_to_end_ms) for l in ledgers)
    print(f"[{tag}] {label}, {len(ledgers)} ledgers (every one conserves: "
          f"max |hops + unattributed - end to end| {worst:.2e} ms), p50 / "
          "p95 ms: " + "; ".join(
              f"{h} {v['p50']:.3f} / {v['p95']:.3f} ({v['n']})"
              for h, v in q.items()), flush=True)
    return q


def _write_trace(name: str, spans: list, journal=None) -> str:
    """The Chrome trace of a capture (with the page journal's lane when
    given) under ``build/traces/``."""
    import os

    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        to_chrome_trace,
    )

    os.makedirs(TRACE_DIR, exist_ok=True)
    path = f"{TRACE_DIR}/{name}.json"
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, journal=journal), f)
    return path


def _pcts(values: list) -> dict | None:
    return (dict(p50=float(np.percentile(values, 50)),
                 p95=float(np.percentile(values, 95))) if values else None)


def _span_quantiles(values: list, unit: str = "ms") -> str:
    q = _pcts(values)
    return f"p50 {q['p50']:.3f} / p95 {q['p95']:.3f} {unit}" if q else "none"


def _get(proxy, path: str) -> str:
    """One GET through the proxy: the body text (200 or the run fails)."""
    conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"GET {path}: HTTP {resp.status}")
    return body


def phase_front(profile: bool) -> tuple:
    """Saturation, Poisson arrivals and HTTP through handle -> router ->
    replica, the launch counts zeroed just before and read just after.
    Returns (counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        WorkloadDriver,
        arrival_times,
    )
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.serve.proxy import (
        HTTPProxy,
        ProxyRouter,
    )
    from ray_dynamic_batching_tpu_torch.serve.router import Router
    from ray_dynamic_batching_tpu_torch.utils.hops import (
        format_ledger_table,
        is_served,
    )
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    tag, max_new, duration_s = "front", 32, 8.0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                        **SLAB_KNOBS)
    replica = dep.make_replica(
        "llama3_8b#bench",
        DeploymentConfig(name="llama3_8b", max_ongoing_requests=4096))
    engine = replica.engine
    print(f"[{tag}] llama3_8b bf16 {engine.model.cfg.num_layers} layers "
          f"(slab + mono), replica built and warmed in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    V = engine.model.cfg.vocab_size
    rng = np.random.default_rng(2)

    def payload() -> dict:
        n = int(rng.integers(40, 61))
        return {"tokens": rng.integers(0, V, n).tolist(),
                "max_new_tokens": max_new}

    routes = ProxyRouter()
    proxy = HTTPProxy(routes, host="127.0.0.1", port=0)
    router = None
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = _profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    try:
        with prof:
            attention.reset_counts()
            t_window = time.monotonic()
            replica.start()
            router = Router("llama3_8b", replicas=[replica],
                            max_assign_timeout_s=30.0)
            handle = DeploymentHandle(router, default_slo_ms=300_000.0)
            routes.set_route("/api/llama3_8b", handle)
            proxy.start()

            # Saturation: every request at once.
            t_sat = time.monotonic()
            futs = [handle.remote(payload()) for _ in range(16)]
            sat = [_answered(f"{tag} saturation", f, max_new) for f in futs]
            sat_s = time.monotonic() - t_sat
            tok_s = sum(len(r.tokens) for r in sat) / sat_s
            capacity = tok_s / max_new
            print(f"[{tag}] saturation: 16 requests, {16 * max_new} tokens in "
                  f"{sat_s:.3f} s: {tok_s:.1f} tok/s, capacity "
                  f"{capacity:.2f} req/s", flush=True)

            # Poisson arrivals at 0.6 x capacity, each request traced:
            # the collector is installed for this window only.
            offered = 0.6 * capacity
            engine.reset_ttft_window()
            poisson_futs, hop_ms, seen_occ = [], [], []
            collector, loads = ChromeTraceCollector(), _LoadRoots()
            busy_at = {}    # trace id -> slots decoding as it arrived

            def submit(_model: str, _offset: float) -> None:
                p = payload()
                seen_occ.append(engine.kv_occupancy())
                ctx = loads.open(deployment="llama3_8b")
                busy_at[ctx["trace_id"]] = engine.active_slots
                with tracer().attach_context(ctx, "load.submit"):
                    t = time.perf_counter()
                    fut = handle.remote(p)
                    hop_ms.append((time.perf_counter() - t) * 1e3)
                loads.close_on(ctx, fut)
                poisson_futs.append(fut)

            pattern = RatePattern("constant", base_rps=offered)
            arrivals = len(list(arrival_times(pattern, duration_s, True, 7)))
            driver = WorkloadDriver(submit, "llama3_8b", pattern,
                                    duration_s=duration_s, poisson=True,
                                    seed=7)
            tracer().set_exporter(collector.export)
            try:
                driver.start()
                driver.join(duration_s + 60)
                if driver._thread.is_alive():
                    fail(f"{tag}: the workload driver did not finish")
                # The driver logs and skips a submit that raises: every
                # scheduled arrival must have been submitted.
                if driver.sent != arrivals or not arrivals:
                    fail(f"{tag}: {driver.sent} of {arrivals} arrivals "
                         "submitted")
                poisson = [_answered(f"{tag} poisson", f, max_new)
                           for f in poisson_futs]
                # decode.sequence is recorded just after each future
                # resolves.
                deadline = time.monotonic() + 10
                while (sum(s.name == "decode.sequence"
                           for s in collector.spans) < len(poisson)
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
            finally:
                tracer().reset()
            ttfts = sorted(r.ttft_ms for r in poisson)
            p50 = statistics.median(ttfts)
            p99 = ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))]
            breakdown = engine.ttft_breakdown()
            occupancy = engine.kv_occupancy()   # bench.py's read: drained
            occ_seen = statistics.mean(seen_occ)
            print(f"[{tag}] poisson @{offered:.2f} rps for {duration_s:.0f} s:"
                  f" {len(poisson)} of {driver.sent} requests answered, TTFT "
                  f"p50 {p50:.1f} ms p99 {p99:.1f} ms, handle + router hop "
                  f"p50 {statistics.median(hop_ms):.3f} ms (max "
                  f"{max(hop_ms):.3f}), TTFT parts {breakdown}, KV occupancy "
                  f"{occupancy:.4f} drained, {occ_seen:.4f} mean as each "
                  f"arrival saw it", flush=True)
            hops = _front_ledgers(tag, collector, loads, poisson, max_new,
                                  engine, busy_at, format_ledger_table,
                                  is_served)

            # HTTP: one buffered and one streamed request.
            code_b, body_b = _post(proxy, "/api/llama3_8b", payload())
            code_s, body_s = _post(proxy, "/api/llama3_8b",
                                   {**payload(), "stream": True})
            metrics_text = _get(proxy, "/metrics")
            wall = time.monotonic() - t_window
            engine.stop()
            torch.cuda.synchronize()
            counts = _counts()
    finally:
        proxy.stop()
        if router is not None:
            router.close()
        replica.stop(drain=False)
    if profile:
        _profile_report(prof, wall)
    if code_b != 200 or code_s != 200:
        fail(f"{tag}: HTTP {code_b} / {code_s}: {body_b[:200]} / "
             f"{body_s[:200]}")
    buffered = json.loads(body_b)["result"]["tokens"]
    lines = [json.loads(ln) for ln in body_s.splitlines() if ln]
    chunks = [ln["chunk"] for ln in lines if "chunk" in ln]
    finals = [ln["result"] for ln in lines if "result" in ln]
    if len(finals) != 1 or chunks != finals[0]["tokens"]:
        fail(f"{tag}: streamed chunks {chunks} against final {finals}")
    if len(buffered) != max_new or len(chunks) != max_new:
        fail(f"{tag}: HTTP answers of {len(buffered)} and {len(chunks)} "
             f"tokens, expected {max_new}")
    print(f"[{tag}] HTTP: buffered 200 ({len(buffered)} tokens), streamed "
          f"200 ({len(chunks)} chunks = the final line's tokens)", flush=True)
    families = ("rdb_decode_tokens_total", "rdb_decode_steps_total",
                "rdb_decode_prefills_total", "rdb_decode_ttft_ms_bucket")
    decode_lines = [ln for ln in metrics_text.splitlines()
                    if ln.startswith(families[:3])]
    missing = [f for f in families
               if not any(ln.startswith(f)
                          for ln in metrics_text.splitlines())]
    if missing:
        fail(f"{tag}: GET /metrics lacks the engine's families {missing}")
    print(f"[{tag}] GET /metrics: {'; '.join(decode_lines)}", flush=True)
    submitted = len(sat) + len(poisson) + 2
    if router.total_routed != submitted:
        fail(f"{tag}: router routed {router.total_routed}, "
             f"{submitted} submitted")
    _expect_dispatches(tag, counts, engine)
    print(f"[{tag}] {submitted} requests routed, none rejected, "
          f"{engine.prefill_groups} prefill groups, {engine.steps} decode "
          f"steps, launches {counts}", flush=True)
    numbers = dict(
        saturation_tok_s=tok_s, capacity_rps=capacity, offered_rps=offered,
        poisson_requests=len(poisson), ttft_p50_ms=p50, ttft_p99_ms=p99,
        ttft_breakdown=breakdown, kv_occupancy=occupancy,
        kv_occupancy_at_arrival=occ_seen,
        hop_p50_ms=statistics.median(hop_ms), hop_max_ms=max(hop_ms),
        routed=router.total_routed, http_buffered=code_b,
        http_streamed=code_s, hops=hops)
    return counts, numbers


def _front_ledgers(tag, collector, loads, poisson, max_new, engine, busy_at,
                   format_ledger_table, is_served) -> dict:
    """Phase 10's flight record: one ledger per Poisson request from its
    load root (submit -> answer) and one cut at its first token (the
    TTFT split), each conserving; the served ledgers must be the
    answered requests, each with one ``decode.prefill`` and a
    ``decode.sequence`` of ``max_new`` tokens. Prints the per-hop p50 /
    p95 of both; the queue wait split by whether every slot was decoding
    when the request arrived (``busy_at``: trace id -> slots decoding),
    beside the share of it spent waiting out an in-flight scan (the
    ``scan_wait_ms`` of its ``decode.prefill``); the slowest TTFT
    ledgers' rows and the engine's snapshot; and writes the Chrome trace
    under ``build/traces/``."""
    spans = collector.spans
    if collector.dropped:
        fail(f"{tag}: the collector dropped {collector.dropped} spans")
    full = _load_ledgers(tag, spans, loads)
    ttft = _load_ledgers(tag, spans, loads, cut_at="decode.prefill")
    served = [l for l in full if is_served(l)]
    prefills = [s for s in spans if s.name == "decode.prefill"]
    seqs = [s for s in spans if s.name == "decode.sequence"]
    traced = {l.trace_id for l in served}
    if (len(served) != len(poisson) or len(ttft) != len(poisson)
            or sorted(s.trace_id for s in prefills) != sorted(traced)
            or {s.trace_id for s in seqs} != traced
            or any(s.attributes["tokens"] != max_new for s in seqs)):
        fail(f"{tag}: {len(served)} served ledgers, {len(ttft)} TTFT "
             f"ledgers, {len(prefills)} decode.prefill and {len(seqs)} "
             f"decode.sequence spans for {len(poisson)} answered requests")
    turns: dict = {}       # horizon -> per-step ms of each decode.turn
    for s in spans:
        if s.name == "decode.turn":
            h = s.attributes["horizon"]
            turns.setdefault(h, []).append((s.end_ms - s.start_ms) / h)
    print(f"[{tag}] flight record of the Poisson window: {len(spans)} spans,"
          f" {len(served)} served ledgers = the answered requests; "
          "decode.turn by horizon (turns, ms a step p50 / p95): " + "; ".join(
              f"{h}: {len(v)}, {np.percentile(v, 50):.2f} / "
              f"{np.percentile(v, 95):.2f}" for h, v in sorted(turns.items())),
          flush=True)
    out = {"turns_by_horizon": {h: dict(n=len(v), **_pcts(v))
                                for h, v in sorted(turns.items())},
           "ttft": _print_hops(tag, "TTFT split by hop (load root cut at "
                               "the first token)", ttft),
           "request": _print_hops(tag, "whole request by hop (load root, "
                                  "submit -> answer)", served)}
    scan = {s.trace_id: s.attributes["scan_wait_ms"] for s in prefills}
    groups = {"a slot free": [], "every slot decoding": []}
    for l in ttft:
        full_at = busy_at[l.trace_id] >= engine.num_slots
        groups["every slot decoding" if full_at else "a slot free"].append(l)
    split = {}
    for label, ls in groups.items():
        wait = [l.hops.get("queue.wait", 0.0) for l in ls]
        sw = [scan[l.trace_id] for l in ls]
        split[label] = dict(n=len(ls), queue_wait=_pcts(wait),
                            scan_wait=_pcts(sw),
                            ttft=_pcts([l.end_to_end_ms for l in ls]))
        print(f"[{tag}] arrivals with {label}: {len(ls)}; queue.wait "
              f"{_span_quantiles(wait)}, of it waiting out a scan "
              f"{_span_quantiles(sw)}; TTFT "
              f"{_span_quantiles([l.end_to_end_ms for l in ls])}",
              flush=True)
    out["by_slots_at_arrival"] = split
    slow = sorted(ttft, key=lambda l: l.end_to_end_ms)[-8:]
    print(f"[{tag}] the 8 slowest TTFT ledgers (ms):\n"
          + format_ledger_table(slow), flush=True)
    print(f"[{tag}] engine snapshot {engine.snapshot()}", flush=True)
    snap = engine.snapshot().get("page_journal", {})
    path = _write_trace("front", spans + loads.spans(),
                        journal=snap.get("events"))
    print(f"[{tag}] Chrome trace written to {path}", flush=True)
    return out


# --- phase 11: the controller and the declarative entry points -------------
WARMUP_FILLS = NB       # one prefill group of each size 1..NB at bucket T
WARMUP_STEPS = 2        # one greedy and one sampled decode step


def _controller_run(front: dict | None) -> dict:
    """Deploy through ``apply_config``, then saturate, call over HTTP,
    read the status, redeploy in place, heal a wedged engine and roll to
    v2; shut everything down. Returns plain numbers only, so nothing of
    the phase outlives this call."""
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.serve import api as serve
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.serve.schema import (
        ServeConfigSchema,
        apply_config,
    )

    tag, max_new, name = "controller", 32, "llama3_8b"
    rng = np.random.default_rng(11)

    def payload(n_new=max_new) -> dict:
        n = int(rng.integers(40, 61))
        out = {"tokens": rng.integers(0, 128256, n).tolist()}
        if n_new is not None:
            out["max_new_tokens"] = n_new
        return out

    built = {}      # replica id -> replica: every engine the window built

    def track(router) -> None:
        for r in router.replicas():
            built.setdefault(r.replica_id, r)

    config = ServeConfigSchema.from_dict({"applications": [{
        "name": "chat", "route_prefix": "/chat",
        "deployments": [{
            "name": name,
            "llm": {"model": name, "dtype": "bfloat16", "seed": 0,
                    **SLAB_KNOBS},
            "version": "v1", "max_ongoing_requests": 4096,
        }],
    }]})
    out = {}
    attention.reset_counts()
    t_phase = time.monotonic()
    try:
        # 1. Deploy: the module controller and proxy, as the README does.
        handle = apply_config(config)[name]
        ctl = serve._get_controller()
        router = ctl.get_router(name)
        track(router)
        out["deploy_s"] = time.monotonic() - t_phase
        print(f"[{tag}] apply_config deployed {name} (v1) on the module "
              f"controller (control interval {ctl.control_interval_s} s) in "
              f"{out['deploy_s']:.1f} s", flush=True)

        # 2. Saturation through the handle.
        t_sat = time.monotonic()
        futs = [handle.remote(payload()) for _ in range(16)]
        sat = [_answered(f"{tag} saturation", f, max_new) for f in futs]
        sat_s = time.monotonic() - t_sat
        out["saturation_tok_s"] = sum(len(r.tokens) for r in sat) / sat_s
        out["saturation_ttft_p50_ms"] = statistics.median(
            r.ttft_ms for r in sat)
        beside = ("" if front is None else
                  f"; phase 10 in this call: {front['saturation_tok_s']:.1f}"
                  " tok/s")
        print(f"[{tag}] saturation: 16 requests, {16 * max_new} tokens in "
              f"{sat_s:.3f} s: {out['saturation_tok_s']:.1f} tok/s, TTFT p50 "
              f"{out['saturation_ttft_p50_ms']:.1f} ms{beside}", flush=True)

        # 3. HTTP through the module proxy.
        proxy = serve.get_proxy()
        code_b, body_b = _post(proxy, "/chat", payload())
        code_s, body_s = _post(proxy, "/chat", {**payload(), "stream": True})
        if code_b != 200 or code_s != 200:
            fail(f"{tag}: HTTP {code_b} / {code_s}: {body_b[:200]} / "
                 f"{body_s[:200]}")
        buffered = json.loads(body_b)["result"]["tokens"]
        lines = [json.loads(ln) for ln in body_s.splitlines() if ln]
        chunks = [ln["chunk"] for ln in lines if "chunk" in ln]
        finals = [ln["result"] for ln in lines if "result" in ln]
        if len(finals) != 1 or chunks != finals[0]["tokens"]:
            fail(f"{tag}: streamed chunks {chunks} against final {finals}")
        if len(buffered) != max_new or len(chunks) != max_new:
            fail(f"{tag}: HTTP answers of {len(buffered)} and {len(chunks)} "
                 f"tokens, expected {max_new}")
        out["http"] = [code_b, code_s]
        print(f"[{tag}] HTTP /chat: buffered 200 ({len(buffered)} tokens), "
              f"streamed 200 ({len(chunks)} chunks = the final line's "
              "tokens)", flush=True)

        # 4. Status.
        st = serve.status()[name]
        stats = next(iter(st["replicas"].values()))
        if st["running_replicas"] != 1 or not {
                "active_slots", "decode_steps"} <= set(stats):
            fail(f"{tag}: status {st['running_replicas']} running, replica "
                 f"stats {sorted(stats)}")
        print(f"[{tag}] status: running_replicas 1, active_slots "
              f"{stats['active_slots']:.0f}, decode_steps "
              f"{stats['decode_steps']:.0f}, versions {st['versions']}",
              flush=True)

        # 5. Redeploy in place: same replica, the bound on every queue.
        replica = router.replicas()[0]
        ctl.deploy(DeploymentConfig(name=name, version="v1",
                                    max_ongoing_requests=128,
                                    user_config={"note": "redeploy"}))
        caps = [q.max_len for q in replica._queues.values()]
        if (router.replicas() != [replica]
                or replica.max_ongoing_requests != 128 or caps != [128]):
            fail(f"{tag}: redeploy rebuilt the replica or missed the queues:"
                 f" {replica.max_ongoing_requests}, queues {caps}")
        _answered(f"{tag} redeploy", handle.remote(payload()), max_new)
        print(f"[{tag}] redeploy in place: same replica "
              f"{replica.replica_id}, max_ongoing_requests 128 on the replica"
              f" and its {len(caps)} bucket queue(s); a request served",
              flush=True)

        # 6. Heal: wedge the engine, the control loop replaces the replica.
        probe = {"tokens": np.random.default_rng(48).integers(
            0, 128256, 48).tolist(), "max_new_tokens": max_new}
        before = _answered(f"{tag} probe", handle.remote(dict(probe)),
                           max_new).tokens
        victim = replica
        t_wedge = time.monotonic()
        victim.engine._run.clear()
        victim.engine.last_heartbeat -= 3600.0
        while True:
            reps = router.replicas()
            if reps and reps[0] is not victim and reps[0].healthy():
                break
            if time.monotonic() - t_wedge > 120:
                fail(f"{tag}: the wedged replica was not replaced in 120 s")
            time.sleep(0.05)
        replaced_s = time.monotonic() - t_wedge
        track(router)
        after = _answered(f"{tag} probe after heal",
                          handle.remote(dict(probe)), max_new).tokens
        out["heal_s"] = time.monotonic() - t_wedge
        out["heal_replaced_s"] = replaced_s
        if after != before:
            print(f"[{tag}] probe before the heal: {before}", flush=True)
            print(f"[{tag}] probe after the heal:  {after}", flush=True)
            fail(f"{tag}: the healed replica's greedy tokens differ")
        print(f"[{tag}] heal: {victim.replica_id} wedged, replaced by "
              f"{reps[0].replica_id} (healthy) in {replaced_s:.2f} s, serving "
              f"again {out['heal_s']:.2f} s after the wedge; the 48-token "
              f"probe gives the same {max_new} greedy tokens", flush=True)

        # 7. Rolling update to v2 while a 96-token generation decodes.
        old = reps[0]
        done_before = old.engine.completed
        inflight = handle.remote({**payload(None), "max_new_tokens": 96})
        deadline = time.monotonic() + 60
        while old.engine.active_slots == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        if old.engine.active_slots == 0:
            fail(f"{tag}: the 96-token generation never started decoding")
        v2 = LLMDeployment(name, model=old.engine.model, dtype=torch.bfloat16,
                           **dict(SLAB_KNOBS, default_max_new_tokens=40))
        t_roll = time.monotonic()
        ctl.deploy(DeploymentConfig(name=name, version="v2",
                                    max_ongoing_requests=4096), factory=v2)
        out["rollout_s"] = time.monotonic() - t_roll
        track(router)
        if not inflight.done():
            fail(f"{tag}: deploy(v2) returned before v1 drained")
        res = _answered(f"{tag} in-flight", inflight, 96)
        if old.engine.completed - done_before != 1:
            fail(f"{tag}: the in-flight request did not finish on v1")
        versions = serve.status()[name]["versions"]
        if versions != {"v2": 1}:
            fail(f"{tag}: versions {versions} after the rollout")
        fresh = _answered(f"{tag} v2 default", handle.remote(payload(None)),
                          40)
        print(f"[{tag}] rolling update: the 96-token generation finished on "
              f"{old.replica_id} (v1, {len(res.tokens)} tokens) through the "
              f"graceful drain; deploy(v2) took {out['rollout_s']:.2f} s; "
              f"versions {versions}; a request without max_new_tokens got "
              f"{len(fresh.tokens)} tokens", flush=True)
    finally:
        serve.shutdown()
    wall = time.monotonic() - t_phase
    torch.cuda.synchronize()
    counts = _counts()

    # Launches: 32 x (the dispatches the engines counted + warmup).
    engines = [r.engine for r in built.values()]
    L = engines[0].model.cfg.num_layers
    fills = sum(e.prefill_groups + e.long_chunk_dispatches
                + e.chunk_dispatches for e in engines)
    steps = sum(e.steps for e in engines)
    if any(e.paged or e.chunked_prefill or e.model.kv_dtype == torch.int8
           or e.max_admissions_per_step != WARMUP_FILLS
           or len(e.prompt_buckets) != 1 for e in engines):
        fail(f"{tag}: an engine off the slab + mono arm")
    want = {"flash_attention": L * (fills + WARMUP_FILLS * len(engines)),
            "decode_attention": L * (steps + WARMUP_STEPS * len(engines))}
    _expect_only(tag, counts, want)
    print(f"[{tag}] {len(engines)} engines built in the window "
          f"({', '.join(built)}): {fills} prefill dispatches + "
          f"{WARMUP_FILLS} x {len(engines)} warmup groups, {steps} decode "
          f"steps + {WARMUP_STEPS} x {len(engines)} warmup steps; launches "
          f"{counts}; phase wall time {wall:.1f} s", flush=True)
    out.update(counts=counts, engines=len(engines), dispatches=fills,
               steps=steps, wall_s=wall)
    return out


def phase_controller(front: dict | None) -> tuple:
    """Phase 11; returns (counts, the phase's numbers)."""
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    out = _controller_run(front)
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    print(f"[controller] device memory allocated: {mem_before / 1e9:.3f} GB "
          f"before the phase, {mem_after / 1e9:.3f} GB after the shutdown",
          flush=True)
    if abs(mem_after - mem_before) > 0.5e9:
        fail("controller: a replaced or retired engine was not released "
             f"({(mem_after - mem_before) / 1e9:.3f} GB more than before)")
    out.update(mem_before_gb=mem_before / 1e9, mem_after_gb=mem_after / 1e9)
    return out.pop("counts"), out


# --- phase 12: measured tables and Nexus colocation ------------------------
# The sweep, the sizing, the length buckets and the colocation traffic of
# phase 12 (llama3_8b, bf16, full width and depth; 16 slots where a count
# is pinned, capacity 512, prompt bucket 64, groups of 4, 32 new tokens).
# Each contract is offered 0.1 of the 16-slot row's full-occupancy
# throughput; 0.2 runs after it as a diagnostic: there the surged pair
# saturates the card although the packer admits it (PERF.md), since the
# planner's fraction counts decode steps at full occupancy and no
# prefill, while a co-tenant's partly filled step costs a whole step.
# A replan sees the surge when it reads llama_a at 1.5 x its first half.
COLOCATE = dict(
    model="llama3_8b", dtype=torch.bfloat16, capacity=S, bucket=T,
    slots=(4, 8, 16, 32), groups=(1, NB), timing_iters=8, warmup_iters=2,
    pinned=SLOTS, length_buckets=(256, S), long_prompt=300,
    contracts=("llama_a", "llama_b"), util=0.1, diagnostic_util=0.2,
    surge=2.0, surge_seen=1.5, half_s=20.0,
    headroom=0.85, monitoring_interval_s=2.0, rate_window_s=8.0,
    max_new=32, prompt=(40, 61), probe_len=48, seed=11, expect_auto=256,
)
PROFILES_DIR = "build/profiles_h100"


def _colocate_run(dev, budget: int, ttft_slo_ms: float, profiles_dir: str,
                  c: dict = COLOCATE) -> dict:
    """Profile the decode engine, size deployments from the table and
    from the budget, route two prompts through two length buckets, then
    serve two contracts colocated by ``pack_llm_engines`` under an
    ``LLMLiveScheduler`` through a rate surge, and hold a greedy probe of
    the colocated engine against a lone engine; then the same traffic at
    the diagnostic utilization. The config carries the
    budget and the control loop's timing for the run. Returns plain
    numbers only (the dispatches every engine and the profiler ran among
    them), so nothing of the run outlives this call."""
    from ray_dynamic_batching_tpu_torch.utils.config import (
        RDBConfig,
        reset_config,
        set_config,
    )

    set_config(RDBConfig.from_env(
        hbm_budget_bytes=budget,
        monitoring_interval_s=c["monitoring_interval_s"],
        rate_window_s=c["rate_window_s"]))
    try:
        return _colocate_body(dev, ttft_slo_ms, profiles_dir, c)
    finally:
        reset_config()


def _colocate_body(dev, ttft_slo_ms: float, profiles_dir: str,
                   c: dict) -> dict:
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.models import registry
    from ray_dynamic_batching_tpu_torch.profiles.decode_profiler import (
        DecodeProfiler,
    )
    from ray_dynamic_batching_tpu_torch.profiles.profiler import (
        write_profile_outputs,
    )
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        LLMSession,
        pack_llm_engines,
    )
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.config import get_config

    tag, name, cap = "colocate", c["model"], c["capacity"]
    cfg = get_config()
    out: dict = {"budget_bytes": cfg.hbm_budget_bytes}
    model = registry.get_model(name, dtype=c["dtype"], device=dev, seed=0)
    V = model.cfg.vocab_size
    engines, warmed = [], []   # every engine that dispatched in the run

    # 1. The sweep: decode (slots x capacity) and prefill (bucket x group).
    prof = DecodeProfiler(model, timing_iters=c["timing_iters"],
                          warmup_iters=c["warmup_iters"])
    decode, prefill = prof.sweep(slot_buckets=c["slots"], capacities=(cap,),
                                 prompt_buckets=(c["bucket"],),
                                 group_sizes=c["groups"])
    rows = decode.rows + prefill.rows
    for kind, table in (("decode", decode), ("prefill", prefill)):
        for r in table.rows:
            print(f"[{tag}] {kind} row: batch_size {r.batch_size}, seq_len "
                  f"{r.seq_len}, latency_ms {r.latency_ms:.3f}, "
                  f"latency_std_ms {r.latency_std_ms:.3f}, hbm_bytes "
                  f"{r.hbm_bytes}, compile_ms {r.compile_ms:.1f}", flush=True)
    if (len(decode.rows) != len(c["slots"])
            or len(prefill.rows) != len(c["groups"])
            or any(r.hbm_bytes <= 0 or r.latency_ms <= 0 for r in rows)):
        fail(f"{tag}: the sweep gave {len(decode.rows)} decode and "
             f"{len(prefill.rows)} prefill rows, or a zero row")
    paths = [write_profile_outputs(t, profiles_dir)[0]
             for t in (decode, prefill)]
    print(f"[{tag}] tables written: {', '.join(paths)}", flush=True)
    out["decode_rows"] = [dict(slots=r.batch_size, ms=r.latency_ms,
                               std_ms=r.latency_std_ms, hbm=r.hbm_bytes,
                               first_ms=r.compile_ms) for r in decode.rows]
    out["prefill_rows"] = [dict(group=r.batch_size, ms=r.latency_ms,
                                std_ms=r.latency_std_ms, hbm=r.hbm_bytes,
                                first_ms=r.compile_ms) for r in prefill.rows]
    prof_fills = len(prefill.rows) * prof.dispatches_per_config
    prof_steps = len(decode.rows) * prof.dispatches_per_config

    # 2. Sizing: the table plan and the budget's answer.
    pinned = decode.row_for(c["pinned"], cap)
    token_slo = cfg.slo_safety_factor * pinned.latency_ms * 2.0
    max_new = c["max_new"]
    knobs = dict(model=model, max_len=cap, prompt_buckets=[c["bucket"]],
                 default_max_new_tokens=max_new,
                 max_admissions_per_step=NB, token_slo_ms=token_slo,
                 ttft_slo_ms=ttft_slo_ms, profiles_dir=profiles_dir)
    sized = LLMDeployment(name, num_slots=0, **knobs)
    e = sized.build_engine(RequestQueue("sized"))
    plan = dict(num_slots=e.num_slots, decode_horizon=e.decode_horizon,
                ttft_horizon=e.ttft_horizon)
    e.release_buffers()
    auto = sized.auto_num_slots()
    out.update(token_slo_ms=token_slo, table_plan=plan, auto_num_slots=auto)
    print(f"[{tag}] token SLO {token_slo:.1f} ms (2 x slo_safety_factor "
          f"{cfg.slo_safety_factor} x the {c['pinned']}-slot step), TTFT "
          f"SLO {ttft_slo_ms:.0f} ms; LLMDeployment(num_slots=0) table plan "
          f"{plan}; auto_num_slots() on the same budget: {auto}",
          flush=True)
    if plan["num_slots"] not in {r.batch_size for r in decode.rows}:
        fail(f"{tag}: the table plan's {plan['num_slots']} slots is no "
             "measured row")
    if auto != c["expect_auto"]:
        fail(f"{tag}: auto_num_slots() {auto}, expected {c['expect_auto']}")

    # 3. Length buckets: one engine per bucket, the smallest that fits.
    rng = np.random.default_rng(c["seed"])
    lb = LLMDeployment(name, num_slots=c["pinned"],
                       length_buckets=list(c["length_buckets"]),
                       **{k: v for k, v in knobs.items()
                          if k not in ("profiles_dir", "token_slo_ms",
                                       "ttft_slo_ms")})
    replica = lb.make_replica(f"{name}-lb", DeploymentConfig(name=name))
    warmed += replica.engines.values()
    replica.start()
    small, large = sorted(replica.engines)
    lens = {small: int(rng.integers(*c["prompt"])), large: c["long_prompt"]}
    reqs = {b: Request(model=name, payload={
        "tokens": rng.integers(0, V, n).tolist(), "max_new_tokens": max_new},
        slo_ms=600_000.0) for b, n in lens.items()}
    for r in reqs.values():
        if not replica.assign(r):
            fail(f"{tag}: the length-bucket replica refused a request")
    for r in reqs.values():
        _answered(f"{tag} length bucket", r.future, max_new)
    deadline = time.monotonic() + 30
    while (sum(e.completed for e in replica.engines.values()) < 2
           and time.monotonic() < deadline):
        time.sleep(0.01)
    replica.stop()
    engines += replica.engines.values()
    done = {b: e.completed for b, e in replica.engines.items()}
    if any(n != 1 for n in done.values()):
        fail(f"{tag}: prompts of {lens[small]} and {lens[large]} tokens "
             f"left {done} completions by bucket, expected one each")
    print(f"[{tag}] length_buckets {sorted(replica.engines)}: a "
          f"{lens[small]}-token prompt reached the {small} engine, a "
          f"{lens[large]}-token prompt the {large} engine (+{max_new} new "
          "tokens each)", flush=True)
    out["length_buckets"] = {str(b): lens[b] for b in lens}

    # 4. Colocation: two contracts of one model, packed from the table,
    # at the gated utilization and then at the diagnostic one.
    budget = cfg.hbm_budget_bytes * cfg.hbm_plan_fraction
    slo_once = cfg.slo_safety_factor * pinned.latency_ms
    try:
        n = len(pack_llm_engines(
            [LLMSession(m, 1.0, slo_once) for m in c["contracts"]],
            {m: decode for m in c["contracts"]}, hbm_budget_bytes=budget,
            compute_headroom=c["headroom"]))
        at_once = f"{n} card(s) for the pair"
    except ValueError as e:
        at_once = f"no plan ({e})"
    print(f"[{tag}] at a token SLO of once slo_safety_factor x the "
          f"{c['pinned']}-slot step ({slo_once:.1f} ms) the packer needs "
          f"{at_once}", flush=True)
    out["slo_at_once"] = at_once
    runs = {}
    for label, util, gated in (("gated", c["util"], True),
                               ("diagnostic", c["diagnostic_util"], False)):
        run = _colocate_traffic(tag, c, util, model, decode, knobs,
                                token_slo, ttft_slo_ms, engines, warmed,
                                probe=gated, traced=not gated)
        runs[label] = _traffic_report(f"{tag} {label} {util}", c, run,
                                      decode, token_slo, budget, gated)
        if not gated:
            runs[label]["turns"] = _turn_report(f"{tag} {label} {util}",
                                                run)
    out.update(
        runs=runs,
        fills=prof_fills + WARMUP_FILLS * len(warmed) + sum(
            e.prefill_groups + e.long_chunk_dispatches + e.chunk_dispatches
            for e in engines),
        steps=prof_steps + WARMUP_STEPS * len(warmed) + sum(
            e.steps for e in engines),
        engines=len(engines), layers=model.cfg.num_layers)
    return out


def _colocate_traffic(tag, c, util, model, decode, knobs, token_slo,
                      ttft_slo_ms, engines, warmed, probe: bool,
                      traced: bool = False) -> dict:
    """Serve ``llama_a`` and ``llama_b`` colocated on the card under an
    ``LLMLiveScheduler``: each is offered ``util`` of the pinned row's
    full-occupancy throughput for one half, then ``llama_a`` the surge
    multiple of it for the second. With ``probe``, a greedy probe goes
    through ``llama_a``'s colocated engine and a lone engine of its
    shape. With ``traced``, a collector is installed for the traffic and
    every request carries a trace context of its own; the record then
    holds the spans and each trace's contract. Appends every engine built
    to ``engines`` (and the warmed ones to ``warmed``), and returns the
    run's record."""
    import random
    import uuid

    from ray_dynamic_batching_tpu_torch.engine.colocate import (
        ColocatedLLMEngines,
    )
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.scheduler.llm_control import (
        LLMLiveScheduler,
        deployment_engine_factory,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    a, b = c["contracts"]
    cap, max_new, name = c["capacity"], c["max_new"], c["model"]
    V = model.cfg.vocab_size

    # Utilization of the pinned row's full-occupancy throughput, the row
    # the token SLO is set from. The host-bound rows are flat, so the
    # planner's row is the one with the least worst-case step and moves
    # with the rows' noise; a rate tied to it ranged 4x between calls, and
    # at its lowest a contract's 8 s window held no arrival and the
    # monitor drained it.
    row = decode.row_for(c["pinned"], cap)
    rate = util * 1000.0 * row.batch_size / row.latency_ms
    rates = {a: rate, b: rate}
    deployments = {m: LLMDeployment(name, num_slots=0, **knobs)
                   for m in (a, b)}
    build = deployment_engine_factory(deployments)

    def factory(m, placement, queue, device):
        engine = build(m, placement, queue, device)
        engine.warmup()          # attach-ready: a migration never serves cold
        warmed.append(engine)
        engines.append(engine)
        return engine

    chip = ColocatedLLMEngines(device=model.device, name="card0")
    sched = LLMLiveScheduler({a: decode, b: decode}, [chip], factory,
                             compute_headroom=c["headroom"])
    req_slo = ttft_slo_ms + max_new * token_slo
    for m in (a, b):
        sched.register_model(m, token_slo_ms=token_slo,
                             tokens_per_request=max_new)
    sent: dict = {}            # (contract, half) -> [request]
    colo_tokens = lone_tokens = None
    collector, contract_of = ChromeTraceCollector(), {}
    try:
        first = sched.rebalance(rates=rates)
        print(f"[{tag}] utilization {util}: offered {rate:.1f} tok/s each "
              f"({rate / max_new:.2f} req/s; of the {row.batch_size}-slot "
              f"row's {1000.0 * row.batch_size / row.latency_ms:.1f} tok/s)"
              "; plan: " + "; ".join(
                  f"{p.model} {p.num_slots} slots, f {p.compute_fraction:.3f}"
                  for chip_plan in first for p in chip_plan), flush=True)
        if len(first) != 1 or sorted(chip.models()) != [a, b]:
            fail(f"{tag}: the first plan does not colocate both contracts "
                 f"on the card: {[[p.model for p in x] for x in first]}")
        chip.start()
        sched.start_monitoring()
        if traced:
            tracer().set_exporter(collector.export)
        arr = np.random.default_rng(c["seed"])
        halves = []
        for half, mult in ((0, 1.0), (1, c["surge"])):
            events = []
            for m in (a, b):
                rps = rates[m] * (mult if m == a else 1.0) / max_new
                t = float(arr.exponential(1.0 / rps))
                while t < c["half_s"]:
                    events.append((t, m))
                    t += float(arr.exponential(1.0 / rps))
            events.sort()
            chip.reset_accounting()
            t_wall, t0 = time.time(), time.monotonic()
            for t, m in events:
                time.sleep(max(0.0, t0 + t - time.monotonic()))
                ctx = {}
                if traced:
                    ctx = {"trace_id": uuid.uuid4().hex,
                           "parent_span_id": random.getrandbits(63)}
                    contract_of[ctx["trace_id"]] = m
                req = Request(model=m, payload={
                    "tokens": arr.integers(
                        0, V, int(arr.integers(*c["prompt"]))).tolist(),
                    "max_new_tokens": max_new}, slo_ms=req_slo,
                    trace_ctx=ctx)
                sent.setdefault((m, half), []).append(req)
                sched.submit_request(req)
            time.sleep(max(0.0, t0 + c["half_s"] - time.monotonic()))
            plan_now = {p.model: p for x in sched._current_plan for p in x}
            halves.append(dict(
                start_wall=t_wall, busy=chip.busy_fractions(),
                planned={m: (p.num_slots, p.compute_fraction)
                         for m, p in plan_now.items()}))
        sched.stop_monitoring()
        results = {}
        for key, reqs_ in sent.items():
            results[key] = []
            for r in reqs_:
                try:
                    results[key].append(r.future.result(timeout=300))
                except Exception as e:  # noqa: BLE001 — counted, then fails
                    results[key].append(e)
        tracer().reset()
        if probe:   # llama_a's colocated engine against a lone engine
            toks = np.random.default_rng(48).integers(0, V, c["probe_len"])
            preq = Request(model=a, payload={"tokens": toks.tolist(),
                                             "max_new_tokens": max_new},
                           slo_ms=600_000.0)
            sched.submit_request(preq)
            colo_tokens = _answered(f"{tag} probe", preq.future,
                                    max_new).tokens
            served = chip.engine_for(a)
            lone = DecodeEngine(
                model, RequestQueue("lone"), num_slots=served.num_slots,
                max_len=served.max_len, prompt_buckets=served.prompt_buckets,
                default_max_new_tokens=max_new,
                decode_horizon=served.decode_horizon,
                ttft_horizon=served.ttft_horizon,
                max_admissions_per_step=served.max_admissions_per_step,
                device=model.device)
            lreq = Request(model=a, payload={"tokens": toks.tolist(),
                                             "max_new_tokens": max_new},
                           slo_ms=600_000.0)
            lone.queue.add_request(lreq)
            lone.run_until_idle(timeout_s=120)
            lone_tokens = _answered(f"{tag} lone probe", lreq.future,
                                    max_new).tokens
            lone.release_buffers()
            engines.append(lone)
        audit = sched.audit.to_dicts()
        stats = sched.queues.stats()
    finally:
        tracer().reset()
        sched.shutdown()
    return dict(util=util, rates=rates, req_slo=req_slo, sent=sent,
                results=results, halves=halves, audit=audit, stats=stats,
                probe=(colo_tokens, lone_tokens), spans=collector.spans,
                dropped_spans=collector.dropped, contract_of=contract_of)


def _turn_report(tag: str, run: dict) -> dict:
    """Each contract's ``decode.turn`` time per decode step (the turn's
    duration over its horizon) against the number of sequences active in
    the turn (a turn links to each of them, so its links name the
    contract), with the horizons it ran: what a step of each engine costs
    at each occupancy while the two share the card. Returns {contract:
    {active: {n, p50, p95}}} (ms)."""
    by: dict = {}
    horizons: dict = {}
    for s in run["spans"]:
        if s.name != "decode.turn":
            continue
        owners = {run["contract_of"].get(l["trace_id"]) for l in s.links}
        if len(owners) != 1 or None in owners:
            fail(f"{tag}: a decode.turn links to {owners}")
        (m,) = owners
        h = s.attributes["horizon"]
        by.setdefault(m, {}).setdefault(s.attributes["active"], []).append(
            (s.end_ms - s.start_ms) / h)
        horizons.setdefault(m, set()).add(h)
    out = {}
    for m in sorted(by):
        rows = {k: dict(n=len(v), **_pcts(v))
                for k, v in sorted(by[m].items())}
        out[m] = rows
        print(f"[{tag}] {m} decode.turn ms a step by active sequences "
              f"(horizons {sorted(horizons[m])}; turns, p50 / p95): "
              + "; ".join(f"{k}: {r['n']}, {r['p50']:.2f} / {r['p95']:.2f}"
                          for k, r in rows.items()), flush=True)
    if run["dropped_spans"]:
        print(f"[{tag}] the collector dropped {run['dropped_spans']} spans",
              flush=True)
    return out


def _replan(observed: dict, prev: list, decode, token_slo: float,
            budget: float, headroom: float) -> dict:
    """The plan ``LLMLiveScheduler.rebalance`` should apply for the rates
    it saw, from the packer alone: each contract's previous shape
    (``prev``, an audit record's placements) where that row alone still
    serves its rate, unless keeping them costs a card; else the packer's
    plan. Returns {contract: (slots, compute fraction)}."""
    from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        LLMSession,
        pack_llm_engines,
    )

    sessions = [LLMSession(m, r, token_slo)
                for m, r in observed.items() if r > 0]
    tables = {s.model: decode for s in sessions}

    def pack(t):
        return pack_llm_engines(sessions, t, hbm_budget_bytes=budget,
                                compute_headroom=headroom)

    plan, held = pack(tables), dict(tables)
    for s in sessions:
        shape = next(((p["slots"], p["capacity"]) for p in prev
                      if p["model"] == s.model), None)
        own = BatchProfile(decode.model_name, [
            r for r in decode.rows
            if (r.batch_size, r.seq_len) == shape and r.spec == "off"])
        try:
            pack_llm_engines([s], {s.model: own}, hbm_budget_bytes=budget,
                             compute_headroom=headroom)
        except ValueError:     # no such row, or it no longer serves
            continue
        held[s.model] = own
    kept = pack(held)
    return {p.model: (p.num_slots, p.compute_fraction)
            for chip in (kept if len(kept) <= len(plan) else plan)
            for p in chip}


def _traffic_report(tag, c, run, decode, token_slo, budget,
                    gated: bool) -> dict:
    """Print a colocation run: per contract and half, the plan beside the
    busy shares, the queues, the audit log, whether the scheduler saw the
    surge and what its replan did. With ``gated``, fail the phase on a
    stale or lost request, a surge no replan saw, a replan that applied
    another plan than the planner's for the rates it saw, or a probe that
    differs from the lone engine's; without it, fail only on a request
    that was never answered. Returns the run's numbers."""
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestStale
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        worst_latency_ms,
    )

    a, b = c["contracts"]
    halves, results, audit = run["halves"], run["results"], run["audit"]
    for h, half in enumerate(halves):
        for m in (a, b):
            res = results.get((m, h), [])
            done = [r for r in res if not isinstance(r, Exception)]
            ok = [r for r in done if r.total_ms <= run["req_slo"]]
            gaps = [(r.total_ms - r.ttft_ms) / max(1, len(r.tokens) - 1)
                    for r in done]
            half.setdefault("contracts", {})[m] = dict(
                sent=len(res), completed=len(done),
                stale=sum(isinstance(r, RequestStale) for r in res),
                dropped=sum(isinstance(r, Exception)
                            and not isinstance(r, RequestStale)
                            for r in res),
                slo_compliance=len(ok) / len(res) if res else 1.0,
                token_gap_p50_ms=statistics.median(gaps) if gaps else 0.0,
                ttft_p50_ms=statistics.median(r.ttft_ms for r in done)
                if done else 0.0)
        print(f"[{tag}] half {h + 1} ({'surge: ' + a + ' x' + str(c['surge']) if h else 'base'}): "
              + "; ".join(
                  f"{m} sent {s['sent']}, completed {s['completed']}, "
                  f"dropped {s['dropped']}, stale {s['stale']}, SLO "
                  f"compliance {s['slo_compliance']:.3f}, token gap p50 "
                  f"{s['token_gap_p50_ms']:.1f} ms, TTFT p50 "
                  f"{s['ttft_p50_ms']:.1f} ms"
                  for m, s in half["contracts"].items()), flush=True)
        print(f"[{tag}] half {h + 1}: planned (slots, compute fraction) "
              f"{ {m: (n, round(f, 3)) for m, (n, f) in half['planned'].items()} }"
              f", measured busy fractions "
              f"{ {m: round(f, 3) for m, f in half['busy'].items()} }",
              flush=True)
    stats = run["stats"]
    stale = {m: s["stale"] for m, s in stats.items()}
    print(f"[{tag}] queue totals: " + "; ".join(
        f"{m} enqueued {s['enqueued']:.0f}, completed {s['completed']:.0f},"
        f" dropped {s['dropped']:.0f}, stale {s['stale']:.0f}"
        for m, s in sorted(stats.items())), flush=True)
    for rec in audit:
        print(f"[{tag}] audit #{rec['seq']} {rec['trigger']} at "
              f"+{rec['wall_time'] - halves[0]['start_wall']:.1f} s: "
              f"rates {rec['observed'].get('rates_tok_s')}, placements "
              f"{rec['inputs'].get('placements')}, diff {rec['diff']}, "
              f"moved {rec['migration_cost']:.0f}"
              + (f", note: {rec['note']}" if rec["note"] else ""),
              flush=True)

    # The surge: a replan after it starts that saw llama_a's rate at
    # c["surge_seen"] times the first half's offered rate.
    base = run["rates"][a]
    after = [r for r in audit if r["trigger"] == "rate_change"
             and r["wall_time"] >= halves[1]["start_wall"]]
    seen = [r for r in after
            if r["observed"]["rates_tok_s"].get(a, 0.0)
            >= c["surge_seen"] * base]
    branch, moved_plan, agrees = "none", None, None
    if seen:
        last = seen[-1]
        observed = last["observed"]["rates_tok_s"]
        if "over capacity" in last["note"]:
            branch = "over capacity: kept the previous plan"
        elif "infeasible" in last["note"]:
            branch = "infeasible: kept the previous plan"
        else:
            placed = {p["model"]: (p["slots"], p["compute_fraction"])
                      for p in last["inputs"]["placements"]}
            branch = "applied on the same executor: " + ", ".join(
                f"{m} {n} slots, f {f}" for m, (n, f) in placed.items())
            prev = next(r["inputs"]["placements"]
                        for r in reversed(audit[:audit.index(last)])
                        if r["inputs"].get("placements"))
            want = _replan(observed, prev, decode, token_slo, budget,
                           c["headroom"])
            # The record rounds rates to 0.1 tok/s and fractions to 3
            # places, so a fraction may differ in its last place.
            agrees = (placed.keys() == want.keys() and all(
                placed[m][0] == want[m][0]
                and abs(placed[m][1] - want[m][1]) <= 2e-3 for m in want))
            before = halves[0]["planned"][a]
            moved_plan = placed.get(a, (0,))[0] != before[0]
            row = decode.row_for(placed[a][0], c["capacity"])
            terms = (f"on {placed[a][0]} slots its capacity term "
                     f"{observed[a] * row.latency_ms / (1000.0 * row.batch_size):.3f}"
                     f", its SLO term {worst_latency_ms(row) / token_slo:.3f}")
            branch += (f"; the surge moved {a} from {before[0]} to "
                       f"{placed[a][0]} slots ({terms})" if moved_plan else
                       f"; the surge left {a}'s row unchanged ({terms})")
            branch += ("; the planner gives the same plan for these rates"
                       " and the shapes it held" if agrees
                       else f"; the planner gives {want}")
        branch = (f"saw {a} at {observed[a]:.1f} tok/s (offered "
                  f"{base:.1f}, then {c['surge'] * base:.1f}): " + branch)
    print(f"[{tag}] {len(after)} replan(s) after the surge, {len(seen)} "
          f"saw {a} at >= {c['surge_seen']} x {base:.1f} tok/s; the last: "
          f"{branch}", flush=True)
    if any(x is not None for x in run["probe"]):
        print(f"[{tag}] probe: colocated {run['probe'][0]}", flush=True)
        print(f"[{tag}] probe: lone      {run['probe'][1]}", flush=True)
    unanswered = {k: sum(isinstance(r, TimeoutError) for r in v)
                  for k, v in results.items()}
    lost = {k: sum(isinstance(r, Exception)
                   and not isinstance(r, RequestStale) for r in v)
            for k, v in results.items()}
    if any(unanswered.values()) or sum(
            len(v) for v in run["sent"].values()) != sum(
            len(v) for v in results.values()):
        fail(f"{tag}: requests unanswered or unaccounted for: {unanswered}")
    if gated:
        if any(lost.values()) or any(stale.values()):
            fail(f"{tag}: requests dropped {lost}, stale {stale}")
        if not seen:
            fail(f"{tag}: no replan after the surge saw {a} at "
                 f"{c['surge_seen']} x its first-half rate")
        if agrees is False:
            fail(f"{tag}: the replan after the surge applied another plan "
                 "than the planner's for the rates it saw")
        if run["probe"][0] != run["probe"][1]:
            fail(f"{tag}: the colocated engine's greedy probe differs from "
                 "a lone engine's")
    return dict(
        util=run["util"], offered_tok_s=base,
        halves=[{k: v for k, v in h.items() if k != "start_wall"}
                for h in halves],
        replans_after_surge=len(after), saw_surge=len(seen), branch=branch,
        surge_moved_plan=moved_plan, stale=sum(stale.values()))


def _tensor_bytes_on_card() -> int:
    """Device memory held by live tensors once cuBLAS's per-thread GEMM
    workspaces are dropped: each new thread's first GEMM allocates one,
    which the process keeps and reuses, not a leak of the phase's
    engines."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def phase_colocate() -> tuple:
    """Phase 12; returns (counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.models import registry  # noqa: F401
    from ray_dynamic_batching_tpu_torch.models.base import _MODEL_SLOS
    from ray_dynamic_batching_tpu_torch.ops import attention

    mem_before = _tensor_bytes_on_card()
    budget = torch.cuda.get_device_properties(0).total_memory
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[colocate] hbm_budget_bytes {budget} (the card's total memory; "
          f"{smi})", flush=True)
    attention.reset_counts()
    t0 = time.monotonic()
    out = _colocate_run(torch.device("cuda", 0), budget,
                        _MODEL_SLOS[COLOCATE["model"]].latency_slo_ms,
                        PROFILES_DIR)
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    counts = _counts()
    L = out.pop("layers")
    _expect_only("colocate", counts, {
        "flash_attention": L * out["fills"],
        "decode_attention": L * out["steps"]})
    mem_after = _tensor_bytes_on_card()
    print(f"[colocate] launches {counts} = {L} x ({out['fills']} prefill "
          f"dispatches, {out['steps']} decode steps) over the profiler, "
          f"{out['engines']} engines and their warmups; device memory held "
          f"by tensors (cuBLAS workspaces dropped) {mem_before / 1e9:.3f} GB "
          f"before the phase, {mem_after / 1e9:.3f} GB after the shutdown; "
          f"phase wall time {wall:.1f} s",
          flush=True)
    if mem_after - mem_before > 0.1e9:
        fail("colocate: a drained or replaced engine was not released "
             f"({(mem_after - mem_before) / 1e9:.3f} GB more than before)")
    out.update(mem_before_gb=mem_before / 1e9, mem_after_gb=mem_after / 1e9,
               wall_s=wall)
    return counts, out


# --- phase 13: the Nexus vision path ---------------------------------------
# The four vision servables at 224 x 224 (EfficientNet-V2-S profiles at its
# own 384), bf16, random weights from seed 0. Profile buckets are the
# reference's accelerator sweep (tools/run_profiles.py:41-44); the SLO run
# is tools/run_slo_demo.py's non-CPU shape (:52-58, :191-): its SLOs, its
# offered load (min(200, max(0.2, 0.010 x profiled peak throughput)) rps),
# one NHWC example per model, 60 s with resnet50's rate doubled at 30 s,
# three engines, the packer's 12 GiB budget and the scheduler's default
# config (monitor every 5 s, rate window 10 s, 5% threshold).
VISION = dict(
    parity=("resnet50", "shufflenet_v2", "efficientnet_v2s", "vit_b_16",
            "vit_g_14"),
    parity_batch=8, parity_size=224, parity_tol=1e-4, bf16_rel_tol=5e-2,
    buckets={
        "resnet50": [1, 8, 32, 64, 128, 256, 512, 1024],
        "shufflenet_v2": [1, 8, 32, 128, 256, 512, 1024, 2048],
        "efficientnet_v2s": [1, 8, 32, 64, 128, 256, 512],
        "vit_b_16": [1, 8, 16, 32, 64, 128, 256],
    },
    warmup_iters=2, timing_iters=4,
    workload=(("resnet50", 2000.0, 0.010, 2.0),
              ("shufflenet_v2", 1500.0, 0.010, 1.0),
              ("vit_b_16", 4000.0, 0.010, 1.0)),
    max_rps=200.0, min_rps=0.2, duration_s=60.0, engines=3,
    # The traced window after the gated run: its length, and every how
    # many arrivals one goes in traced.
    traced_s=10.0, traced_every=4,
    hbm_budget_bytes=12 << 30, gate=0.95, surge_seen=1.5,
    vit="vit_b_16", classes=1000,
    # Flash launches a forward (one a layer); the other models have none.
    flash_layers={"vit_b_16": 12, "vit_g_14": 48},
    # Timed apart from the sweep: not in the demo, so not in the SLO run.
    extra_buckets={"vit_g_14": [1, 32]},
)
COUNTER_FIELDS = ("completed", "violations", "stale", "dropped")


def _phase_compliance(start: dict, end: dict) -> dict:
    """tools/run_slo_demo.py's per-phase accounting: counter deltas, with
    stale and dropped requests counted as misses."""
    d = {k: end[k] - start[k] for k in COUNTER_FIELDS}
    accounted = d["completed"] + d["stale"] + d["dropped"]
    misses = d["violations"] + d["stale"] + d["dropped"]
    d["slo_compliance"] = 1.0 - misses / accounted if accounted else 1.0
    return d


def _vision_parity(c: dict) -> dict:
    """Each model in f32 on the card (TF32 off for convs and matmuls),
    batch 8: logits through the kernel route against the plain route; then
    the served bf16 model against that f32 forward."""
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    try:
        for name in c["parity"]:
            model = get_model(name, dtype=torch.float32,
                              image_size=c["parity_size"]).eval()
            x = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (c["parity_batch"], c["parity_size"], c["parity_size"], 3)
            ).astype(np.float32)).cuda()
            before = fl.launches
            with torch.inference_mode():
                out = model(x)
                with attention.plain_attention():
                    ref = model(x)
            torch.cuda.synchronize()
            launched = fl.launches - before
            want = c["flash_layers"].get(name, 0)
            if tuple(out.shape) != (c["parity_batch"], c["classes"]) or not (
                    bool(torch.isfinite(out).all())):
                fail(f"vision parity {name}: logits {tuple(out.shape)} not "
                     f"finite [{c['parity_batch']}, {c['classes']}]")
            err = (out - ref).abs().max().item()
            print(f"[vision] parity {name} f32 batch {c['parity_batch']} at "
                  f"{c['parity_size']}: kernel route vs plain route max abs "
                  f"logit err {err:.3e} (max |logit| "
                  f"{ref.abs().max().item():.3f}; tol {c['parity_tol']:.0e}); "
                  f"flash launches {launched} (expected {want})", flush=True)
            if launched != want:
                fail(f"vision parity {name}: {launched} flash launches, "
                     f"expected {want}")
            if not err <= c["parity_tol"]:
                fail(f"vision parity {name}: {err} > {c['parity_tol']}")
            # The model as served (bf16, channels-last, cuDNN's bf16
            # convolutions) against the f32 forward of the same weights.
            served = get_model(name, image_size=c["parity_size"]).eval()
            with torch.inference_mode():
                low = served(x).float()
            scale = ref.abs().max().item()
            rel = (low - ref).abs().max().item() / scale
            print(f"[vision] parity {name} bf16 (served) vs f32: max abs "
                  f"logit err {rel * scale:.3e} = {rel:.3e} x max |logit| "
                  f"(tol {c['bf16_rel_tol']:.0e})", flush=True)
            if not rel <= c["bf16_rel_tol"]:
                fail(f"vision parity {name}: bf16 logits off the f32 "
                     f"forward by {rel:.3e} x max |logit|")
            errs[name] = {"route_f32": err, "bf16_vs_f32_rel": rel}
            del model, out, ref, served, low
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    attention.reset_counts()   # comparison launches do not count
    return errs


def _vision_profiles(c: dict, profiles_dir: str) -> dict:
    """``ModelProfiler`` over the reference's buckets for each model,
    written to ``profiles_dir``; returns name -> BatchProfile."""
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler

    out = {}
    for name, buckets in c["buckets"].items():
        t0 = time.monotonic()
        model = get_model(name).eval()
        profiler = ModelProfiler(model, warmup_iters=c["warmup_iters"],
                                 timing_iters=c["timing_iters"])
        prof = profiler.sweep(batch_buckets=buckets)
        if not prof.rows:
            fail(f"vision profile {name}: no feasible bucket")
        csv_path, _, _ = profiler.write_outputs(prof, profiles_dir)
        for r in prof.rows:
            r = r.with_throughput()
            print(f"[vision] profile {name} b={r.batch_size}: "
                  f"{r.latency_ms:.3f} ms (std {r.latency_std_ms:.3f}), "
                  f"{r.throughput_sps:.1f} img/s, hbm_bytes {r.hbm_bytes}, "
                  f"first dispatch {r.compile_ms:.1f} ms", flush=True)
        missing = sorted(set(buckets) - {r.batch_size for r in prof.rows})
        print(f"[vision] profile {name}: {len(prof.rows)} rows -> {csv_path}"
              f" (infeasible: {missing or 'none'}; "
              f"{time.monotonic() - t0:.1f} s)", flush=True)
        out[name] = prof
        del model, profiler
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _extra_profiles(c: dict) -> dict:
    """The models outside the SLO run, timed at a few buckets through
    ``ModelProfiler.profile_bucket`` and printed (nothing written)."""
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler

    out = {}
    for name, buckets in c["extra_buckets"].items():
        model = get_model(name).eval()
        profiler = ModelProfiler(model, warmup_iters=c["warmup_iters"],
                                 timing_iters=c["timing_iters"])
        rows = {}
        for b in buckets:
            r = profiler.profile_bucket(b)
            if r is None:
                fail(f"vision profile {name} b={b}: out of device memory")
            r = r.with_throughput()
            print(f"[vision] profile {name} b={b}: {r.latency_ms:.3f} ms "
                  f"(std {r.latency_std_ms:.3f}), {r.throughput_sps:.1f} "
                  f"img/s, hbm_bytes {r.hbm_bytes}, first dispatch "
                  f"{r.compile_ms:.1f} ms", flush=True)
            rows[b] = {"latency_ms": r.latency_ms,
                       "throughput_sps": r.throughput_sps,
                       "hbm_bytes": r.hbm_bytes}
        out[name] = rows
        del model, profiler
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _vision_slo_run(c: dict, profiles_dir: str) -> tuple:
    """run_slo_demo's live run on the card: profiles read back from
    ``profiles_dir`` -> ``SquishyBinPacker`` -> three ``ReplicaEngine``s
    under a ``LiveScheduler``, Poisson arrivals through a rate step.
    Returns (launch counts, the run's numbers)."""
    from ray_dynamic_batching_tpu_torch.engine import worker
    from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
    from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        WorkloadDriver,
    )
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
    from ray_dynamic_batching_tpu_torch.scheduler.control import (
        LiveScheduler,
    )
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        SquishyBinPacker,
    )

    names = [w[0] for w in c["workload"]]
    slos = {w[0]: w[1] for w in c["workload"]}
    profiles = {n: BatchProfile.from_csv(
        n, f"{profiles_dir}/{n}_summary.csv") for n in names}
    packer = SquishyBinPacker(profiles, hbm_budget_bytes=c["hbm_budget_bytes"])
    queues = QueueManager()
    host = ModelHost()
    engines = [worker.ReplicaEngine(f"card{i}", queues, host)
               for i in range(c["engines"])]
    sched = LiveScheduler(packer, engines, queues=queues)
    for n in names:
        sched.register_model(n, slo_ms=slos[n])
    example = {}   # one NHWC example per model (run_slo_demo.py:276-280)
    for n in names:
        (spec,) = get_model(n, device="meta", seed=None).input_shapes(1)
        example[n] = np.zeros(spec.shape[1:], np.float32)
    base = {n: min(c["max_rps"], max(c["min_rps"],
                                     util * profiles[n].max_throughput()))
            for n, _, util, _ in c["workload"]}
    mult = {n: m for n, _, _, m in c["workload"]}
    (surged,) = [n for n, m in mult.items() if m != 1.0]
    shift_at = c["duration_s"] / 2.0
    print(f"[vision] offered rps {({n: round(r, 2) for n, r in base.items()})}"
          f"; SLOs {slos} ms; shift at {shift_at:.0f} s: {surged} x "
          f"{mult[surged]}", flush=True)

    def batches(e, n):
        return worker.BATCHES_TOTAL.get(tags={"engine": e.engine_id,
                                              "model": n})

    b0 = {(e.engine_id, n): batches(e, n) for e in engines for n in names}
    depths: list = []            # (t_s, {model: queue depth}) every second
    sampling = threading.Event()

    def sample_depths(t_start: float) -> None:
        while not sampling.wait(1.0):
            depths.append((time.monotonic() - t_start,
                           {n: len(queues.queue(n)) for n in names}))

    attention.reset_counts()
    for e in engines:
        e.track_ratios = True
        e.start()
    drivers, snap_mid = [], None
    try:
        plans = sched.rebalance(rates=base)
        baseline = sched.schedule_changes
        for p in plans:
            print(f"[vision] plan: {p.describe()}", flush=True)
        initial = {e.engine_id: 0.0 for e in engines}
        deadline = time.monotonic() + 120
        while not set(names) <= {m for e in engines for m in e.models}:
            if time.monotonic() > deadline:
                fail("vision: engines never loaded the planned models")
            time.sleep(0.1)
        for e in engines:
            initial[e.engine_id] = sum(
                p.occupancy for p in e._schedule.placements)
            e.busy_ms = 0.0
            e.drain_ratios()
        sched.start_monitoring()

        def submit(model: str, _offset: float) -> None:
            sched.submit_request(Request(model=model, payload=example[model],
                                         slo_ms=slos[model]))

        drivers = [
            WorkloadDriver(submit, n, RatePattern(
                "step", base_rps=base[n], amplitude=base[n] * (mult[n] - 1.0),
                step_at_s=shift_at), duration_s=c["duration_s"],
                poisson=True, seed=17 + i)
            for i, n in enumerate(names)
        ]
        t0 = time.monotonic()
        for d in drivers:
            d.start()
        sampler = threading.Thread(target=sample_depths, args=(t0,),
                                   daemon=True)
        sampler.start()
        time.sleep(max(0.0, shift_at - (time.monotonic() - t0)))
        snap_mid = {n: dict(queues.queue(n).stats()) for n in names}
        for d in drivers:
            d.join(c["duration_s"] + 60)
        deadline = time.monotonic() + 60
        while (any(len(queues.queue(n)) > 0 for n in names)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        time.sleep(0.5)
        wall_s = time.monotonic() - t0
        last = {e.engine_id: sum(p.occupancy for p in e._schedule.placements)
                for e in engines}
        # The gated run's numbers, read before the traced window.
        sampling.set()
        ratios = {e.engine_id: e.drain_ratios() for e in engines}
        busy_ms = {e.engine_id: e.busy_ms for e in engines}
        ends = {n: queues.queue(n).stats() for n in names}
        served = {(e.engine_id, n): batches(e, n) - b0[(e.engine_id, n)]
                  for e in engines for n in names}
        schedule_log = list(sched.schedule_log)
        audit = sched.audit.to_dicts()
        traced = _vision_traced_window(
            c, sched, queues, names, example, slos,
            {n: base[n] * mult[n] for n in names}, profiles)
    finally:
        sampling.set()
        sched.stop_monitoring()
        for e in engines:
            e.stop()
    torch.cuda.synchronize()
    counts = _counts()
    layers = c["flash_layers"][c["vit"]]
    warmups = sum(1 for e in engines for k in e._warmed if k[0] == c["vit"])
    vit_batches = sum(v for (_, n), v in served.items() if n == c["vit"])
    vit_traced = sum(batches(e, c["vit"]) - b0[(e.engine_id, c["vit"])]
                     for e in engines) - vit_batches
    _expect_only("vision", counts, {
        "flash_attention": layers * (vit_batches + vit_traced + warmups)})

    out = {"offered_rps": base, "wall_s": wall_s, "models": {},
           "replans": [], "engines": {}, "traced": traced}
    worst = 1.0
    zero = {k: 0 for k in COUNTER_FIELDS}
    for d in drivers:
        n = d.model
        end = ends[n]
        p1 = _phase_compliance(zero, snap_mid[n])
        p2 = _phase_compliance(snap_mid[n], end)
        worst = min(worst, p1["slo_compliance"], p2["slo_compliance"])
        lost = d.sent - (end["completed"] + end["stale"] + end["dropped"])
        out["models"][n] = dict(
            sent=d.sent, completed=end["completed"], stale=end["stale"],
            dropped=end["dropped"], depth=end["depth"], lost=lost,
            phase1=p1, phase2=p2, p95_ms=end["latency_p95_ms"],
            p99_ms=end["latency_p99_ms"])
        print(f"[vision] {n}: sent {d.sent}, completed {end['completed']:.0f}"
              f", stale {end['stale']:.0f}, dropped {end['dropped']:.0f}, "
              f"unaccounted {lost:.0f}; compliance first half "
              f"{p1['slo_compliance']:.4f}, second half "
              f"{p2['slo_compliance']:.4f}; latency p95 "
              f"{end['latency_p95_ms']:.1f} ms, p99 "
              f"{end['latency_p99_ms']:.1f} ms", flush=True)
        if lost or end["depth"]:
            fail(f"vision: {n} has {lost:.0f} requests unaccounted for and "
                 f"{end['depth']:.0f} still queued")
    surge_seen = []
    for rec in schedule_log[baseline:]:
        t_s = rec["ts"] - t0
        rates = rec["rates"]
        out["replans"].append({"t_s": t_s, "rates": rates,
                               "nodes": rec["nodes"]})
        print(f"[vision] replan at {t_s:+.1f} s, rates "
              f"{({k: round(v, 2) for k, v in rates.items()})}: "
              f"{rec['nodes']}", flush=True)
        if t_s >= shift_at and (rates.get(surged, 0.0)
                                >= c["surge_seen"] * base[surged]):
            surge_seen.append(t_s)
    triggers = [a["trigger"] for a in audit]
    for e in engines:
        r = sorted(ratios[e.engine_id])
        busy = busy_ms[e.engine_id] / (wall_s * 1e3)
        out["engines"][e.engine_id] = dict(
            batches={n: served[(e.engine_id, n)] for n in names},
            busy_share=busy, planned_first=initial[e.engine_id],
            planned_last=last[e.engine_id],
            ratio_p50=r[len(r) // 2] if r else None,
            ratio_p95=r[int(0.95 * (len(r) - 1))] if r else None)
        print(f"[vision] engine {e.engine_id}: batches "
              f"{({n: served[(e.engine_id, n)] for n in names})}; busy "
              f"share {busy:.3f} against planned occupancy "
              f"{initial[e.engine_id]:.3f} (first plan), "
              f"{last[e.engine_id]:.3f} (last); step / profiled "
              f"bucket latency p50 "
              f"{out['engines'][e.engine_id]['ratio_p50']}, p95 "
              f"{out['engines'][e.engine_id]['ratio_p95']} over {len(r)} "
              f"steps", flush=True)
    out["depths"] = depths
    print(f"[vision] queue depth {surged} / all, every 5 s: " + ", ".join(
        f"{t_s:.0f} s {d[surged]} / {sum(d.values())}"
        for t_s, d in depths[4::5]), flush=True)
    low = {(n, h): out["models"][n][h]["slo_compliance"]
           for n in names for h in ("phase1", "phase2")
           if out["models"][n][h]["slo_compliance"] < c["gate"]}
    print(f"[vision] worst-phase compliance {worst:.4f} (gate {c['gate']}"
          f"; under it: {low or 'none'}); {surged} after the shift "
          f"{out['models'][surged]['phase2']['slo_compliance']:.4f}; "
          f"replan triggers {triggers}; replans after the "
          f"shift that saw {surged} >= {c['surge_seen']} x offered: "
          f"{len(surge_seen)}; launches {counts} = {layers} x "
          f"({vit_batches} {c['vit']} batches + {vit_traced} in the traced "
          f"window + {warmups} warm-ups); wall {wall_s:.1f} s", flush=True)
    out.update(worst_compliance=worst, triggers=triggers,
               surge_replans=len(surge_seen), vit_batches=vit_batches,
               vit_warmups=warmups)
    if low:
        fail(f"vision: SLO compliance under {c['gate']}: {low}")
    if "rate_change" not in triggers[1:] or not surge_seen:
        fail(f"vision: no rate-change replan after the shift saw {surged}'s "
             "raised rate")
    return counts, out


def _vision_traced_window(c: dict, sched, queues, names, example, slos,
                          rates: dict, profiles: dict) -> dict:
    """After the gated SLO run, ``c["traced_s"]`` seconds more of Poisson
    arrivals at the rates of its second half with a collector installed.
    Every ``c["traced_every"]``-th arrival goes in under a load root and
    a ``handle.remote`` span whose context the request carries (as
    ``tools/run_slo_demo.py``'s ``_SchedulerHandle`` submits); the rest
    are submitted bare. Prints the traced requests' per-hop p50 / p95
    and, per model, ``collate.batch`` against the ``engine.step`` it
    runs in, and the step less its collate against the profiled row of
    the step's bucket; writes the Chrome trace under ``build/traces/``.
    Fails on a traced request not answered or a ledger that does not
    conserve."""
    import itertools

    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        WorkloadDriver,
    )
    from ray_dynamic_batching_tpu_torch.utils.hops import format_ledger_table
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    tag = "vision traced"
    collector, loads = ChromeTraceCollector(), _LoadRoots()
    counter = itertools.count()
    futs = []

    def submit(model: str, _offset: float) -> None:
        if next(counter) % c["traced_every"]:
            sched.submit_request(Request(model=model, payload=example[model],
                                         slo_ms=slos[model]))
            return
        ctx = loads.open(deployment=model)
        with tracer().attach_context(ctx, "handle.remote", deployment=model,
                                     lane=model):
            req = Request(model=model, payload=example[model],
                          slo_ms=slos[model],
                          trace_ctx=tracer().inject_context())
            sched.submit_request(req)
        loads.close_on(ctx, req.future)
        futs.append(req.future)

    drivers = [WorkloadDriver(submit, n, RatePattern("constant",
                                                     base_rps=rates[n]),
                              duration_s=c["traced_s"], poisson=True,
                              seed=71 + i)
               for i, n in enumerate(names)]
    tracer().set_exporter(collector.export)
    try:
        for d in drivers:
            d.start()
        for d in drivers:
            d.join(c["traced_s"] + 60)
        for f in futs:
            try:
                f.result(timeout=60)
            except Exception as e:  # noqa: BLE001 — a lost request fails
                fail(f"{tag}: a traced request failed: "
                     f"{type(e).__name__}: {e}")
        deadline = time.monotonic() + 60
        while (any(len(queues.queue(n)) > 0 for n in names)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        time.sleep(0.5)
    finally:
        tracer().reset()
    spans = collector.spans
    if collector.dropped:
        fail(f"{tag}: the collector dropped {collector.dropped} spans")
    ledgers = _load_ledgers(tag, spans, loads)
    if len(ledgers) != len(futs):
        fail(f"{tag}: {len(ledgers)} ledgers for {len(futs)} traced "
             "requests")
    print(f"[{tag}] {c['traced_s']:.0f} s at {({n: round(r, 2) for n, r in rates.items()})}"
          f" rps: {sum(d.sent for d in drivers)} arrivals, {len(futs)} "
          f"traced, {len(spans)} spans", flush=True)
    out = {"sent": sum(d.sent for d in drivers), "traced": len(futs),
           "hops": _print_hops(tag, "request by hop (load root, submit -> "
                               "answer)", ledgers), "models": {}}
    slow = sorted(ledgers, key=lambda l: l.end_to_end_ms)[-5:]
    print(f"[{tag}] the 5 slowest traced requests (ms):\n"
          + format_ledger_table(slow), flush=True)
    steps = {s.span_id: s for s in spans if s.name == "engine.step"}
    collates: dict = {}
    for s in spans:
        if s.name == "collate.batch" and s.parent_id in steps:
            collates[s.parent_id] = s
    for n in names:
        mine = [s for s in steps.values() if s.attributes["model"] == n]
        step_ms = [s.end_ms - s.start_ms for s in mine]
        coll_ms = [collates[s.span_id].end_ms - collates[s.span_id].start_ms
                   for s in mine if s.span_id in collates]
        share = sum(coll_ms) / sum(step_ms) if step_ms else 0.0
        # The step less its collate over the profiled row of its bucket.
        rest = [(s.end_ms - s.start_ms
                 - (collates[s.span_id].end_ms - collates[s.span_id].start_ms)
                 ) / profiles[n].latency_ms(s.attributes["batch_bucket"])
                for s in mine if s.span_id in collates]
        out["models"][n] = dict(
            steps=len(mine), collate_share=share, step_ms=_pcts(step_ms),
            collate_ms=_pcts(coll_ms), rest_over_profiled=_pcts(rest))
        print(f"[{tag}] {n}: {len(mine)} engine.step spans, "
              f"{_span_quantiles(step_ms)}; collate.batch inside them "
              f"{_span_quantiles(coll_ms)}; collate {share:.3f} of the "
              "steps' time; the step less its collate over the profiled "
              f"row of its bucket {_span_quantiles(rest, unit='x')} (buckets "
              f"{sorted({s.attributes['batch_bucket'] for s in mine})})",
              flush=True)
    path = _write_trace("vision", spans + loads.spans())
    print(f"[{tag}] Chrome trace written to {path}", flush=True)
    return out


def phase_vision() -> tuple:
    """Phase 13; returns (counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.models import registry  # noqa: F401

    t0 = time.monotonic()
    errs = _vision_parity(VISION)
    profiles = _vision_profiles(VISION, PROFILES_DIR)
    extra = _extra_profiles(VISION)
    counts, out = _vision_slo_run(VISION, PROFILES_DIR)
    out.update(parity_max_abs_err=errs, wall_phase_s=time.monotonic() - t0,
               profiled={n: len(p.rows) for n, p in profiles.items()},
               extra_profiles=extra)
    print(f"[vision] phase wall time {out['wall_phase_s']:.1f} s",
          flush=True)
    return counts, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    all_phases = (["build", "kernels", "parity"] + list(SERVING)
                  + ["front", "controller", "colocate", "vision"])
    ap.add_argument("--phases", default=",".join(all_phases),
                    help=f"comma-separated subset of {','.join(all_phases)} "
                         "(the device phase always runs)")
    ap.add_argument("--profile", action="store_true",
                    help="trace each serving window with torch.profiler "
                         "and print device time by kernel")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(all_phases):
        fail(f"unknown phases {sorted(phases - set(all_phases))}")
    dev = phase_device()
    if "build" in phases:
        phase_build()
    kernels = phase_kernels() if "kernels" in phases else {}
    if "parity" in phases:
        phase_parity()
    by_path, cache, summary = {}, {}, {}
    for phase, (path, seed, n_long, knobs) in SERVING.items():
        if phase in phases:
            payloads = _payloads(np.random.default_rng(seed), 128256, 32, 8,
                                 2, n_long)
            by_path[path], cache[path], summary[path] = _serving_phase(
                phase, payloads, knobs, args.profile)
    if cache:
        print("[cache] KV cache bytes by serving phase: " + ", ".join(
            f"{p} {b / 1e9:.3f} GB" for p, b in cache.items()), flush=True)
    if "slab_chunked" in summary:
        beside = []
        for p in ("slab", "int8", "slab_chunked"):
            if p not in summary:
                continue
            s = summary[p]
            longs = " / ".join(f"{t:.1f}" for t in s["ttft_long_ms"])
            beside.append(
                f"{p} {s['tok_s']:.1f} tok/s, TTFT p50 {s['ttft_p50_ms']:.1f}"
                f" ms (max {s['ttft_max_ms']:.1f})"
                + (f", the long prompts {longs} ms" if longs else ""))
        print("[slab_chunked] beside main and int8: " + "; ".join(beside),
              flush=True)
    front = controller = colocate = vision = None
    if "front" in phases:
        by_path["front"], front = phase_front(args.profile)
    if "controller" in phases:
        by_path["controller"], controller = phase_controller(front)
    if "colocate" in phases:
        by_path["colocate"], colocate = phase_colocate()
    if "vision" in phases:
        by_path["vision"], vision = phase_vision()
    for name, row in kernels.items():
        split = {path: c[name] for path, c in by_path.items()}
        row["launches"] = sum(split.values()) if split else None
        row["launches_by_path"] = split
    print(json.dumps({"kernels": list(kernels.values()), "front": front,
                      "controller": controller, "colocate": colocate,
                      "vision": vision}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
