"""GPU smoke run of the PyTorch/CUDA port (``ray_dynamic_batching_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero before the
last line:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds both kernels from ``csrc/`` (one process each,
   in parallel);
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes, in bf16 and f32: max abs error against the stated
   tolerance, median CUDA-event times of kernel / plain version /
   ``F.scaled_dot_product_attention`` (a yardstick, never used by the
   port), and the bound from bytes and FLOPs;
4. parity — llama3_8b at full width, 2 layers, f32: ``prefill`` then one
   ``decode_step`` through the kernels and through the plain versions;
5. main path — ``LLMDeployment("llama3_8b")`` at full width and depth in
   bf16 with random weights serves 8 requests (6 greedy, 2 sampled); both
   kernels' launch counts, set to 0 just before, must have moved.

The line before the last is one JSON object with the per-kernel numbers;
the last line is ``{"ok": true, "device": {...}}``. ``--phases`` runs a
subset (for bring-up); the default runs all. ``--profile`` traces the
main-path window with ``torch.profiler`` and prints the device's busy
share and its time by kernel (used for PERF.md's breakdown).

Tolerances: bf16 2e-2 absolute — kernel and plain version both accumulate
in f32 from the same bf16 inputs, and the outputs (|x| < 4) differ by at
most a couple of bf16 ulps (2^-8 at 1) from the probabilities rounded at
another running max; f32 1e-4 — the same math summed in another order.
Model parity: 1e-3 absolute on logits of unit scale, two layers of f32
matmuls between the two attention paths.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LOGIT_TOL = 1e-3

# Main-path shapes (llama3_8b, 16 slots, max_len 512, bucket 64, groups of 4).
NB, T, S, SLOTS = 4, 64, 512, 16
N_HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
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


def _prefill_inputs(dtype, gen):
    from ray_dynamic_batching_tpu_torch.models.decoder import prefill_mask

    dev = "cuda"
    q = torch.randn((NB, T, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((NB, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((NB, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    lengths = torch.tensor([40, 47, 53, 60], device=dev)
    attn = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).int()
    mask = torch.cat([prefill_mask(attn), torch.zeros(
        (NB, 1, T, S - T), dtype=torch.bool, device=dev)], dim=-1)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


def _decode_inputs(dtype, gen):
    from ray_dynamic_batching_tpu_torch.models.decoder import decode_mask

    dev = "cuda"
    q = torch.randn((SLOTS, 1, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((SLOTS, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((SLOTS, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    lengths = torch.randint(40, S - 1, (SLOTS,), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), decode_mask(lengths, S)


def _sdpa(q, k, v, mask):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True,
    ).transpose(1, 2)


def phase_kernels() -> dict:
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = {
        "flash_attention": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/flash_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/flash_attention.py:154",
            inputs=_prefill_inputs,
            kernel=lambda q, k, v, m: fl.flash_attention(q, k, v, mask=m),
            plain=lambda q, k, v, m: fl.flash_attention_plain(
                q, k, v, fl.keep_mask(m, NB, T, S)),
            tq=T, batch=NB,
        ),
        "decode_attention": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/decode_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:238",
            inputs=_decode_inputs,
            kernel=lambda q, k, v, m: dec.decode_attention(q, k, v, mask=m),
            plain=lambda q, k, v, m: dec.decode_attention_plain(
                q, k, v, fl.keep_mask(m, SLOTS, 1, S)),
            tq=1, batch=SLOTS,
        ),
    }
    results = {}
    for name, sp in specs.items():
        row = {"name": name, "route": "cuda", "source": sp["source"],
               "replaces": sp["replaces"]}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m = sp["inputs"](dtype, gen)
            out = sp["kernel"](q, k, v, m)
            torch.cuda.synchronize()
            ref = sp["plain"](q, k, v, m)
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out.float()).all():
                fail(f"{name} {dtype}: non-finite output")
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"[kernels] {name} {tag} q{tuple(q.shape)} "
                  f"k{tuple(k.shape)}: max_abs_err {err:.3e} "
                  f"(tol {TOL[dtype]:.0e})", flush=True)
            if not err <= TOL[dtype]:
                fail(f"{name} {tag}: max_abs_err {err} > {TOL[dtype]}")
            if dtype == torch.float32:
                row["max_abs_err_f32"] = err
                continue
            m_i8 = m.expand(sp["batch"], 1, sp["tq"], S)
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
            nbytes += m_i8.numel()  # int8 mask, one byte per entry
            flops = 4 * sp["batch"] * N_HEADS * sp["tq"] * S * HEAD_DIM
            b_ms, b_by = bound(nbytes, flops, dtype)
            row.update(
                dtype="bfloat16",
                q_shape=list(q.shape), kv_shape=list(k.shape),
                max_abs_err=err,
                ms=time_ms(lambda: sp["kernel"](q, k, v, m)),
                plain_ms=time_ms(lambda: sp["plain"](q, k, v, m)),
                library_ms=time_ms(lambda: _sdpa(q, k, v, m)),
                bound_ms=b_ms, bound_by=b_by,
            )
            print(f"[kernels] {name} bf16: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        results[name] = row
    return results


def phase_parity() -> None:
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model = CausalLM(cfg, "llama3_8b_2layer", dtype=torch.float32,
                     device="cuda", seed=0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)).cuda()
    attn = torch.ones((2, T), dtype=torch.int32, device="cuda")
    attn[1, 50:] = 0
    nxt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)).cuda()
    active = torch.ones((2,), dtype=torch.bool, device="cuda")

    def run():
        with torch.inference_mode():
            cache = model.make_cache(2, S)
            first, cache = model.prefill(tokens, attn, cache)
            second, cache = model.decode_step(nxt, cache, active)
            return first.float(), second.float()

    attention.reset_counts()
    got = run()
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    if fl.launches != 2 or dec.launches != 2:
        fail(f"parity: kernel path launched flash {fl.launches} / decode "
             f"{dec.launches} times, expected 2 / 2")
    with attention.plain_attention():
        want = run()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    scale = max(w.abs().max().item() for w in want)
    print(f"[parity] llama3_8b width, 2 layers, f32: prefill logits err "
          f"{errs[0]:.3e}, decode logits err {errs[1]:.3e} (|logits| max "
          f"{scale:.2f}, tol {LOGIT_TOL:.0e})", flush=True)
    if not all(np.isfinite(errs)) or max(errs) > LOGIT_TOL:
        fail(f"parity: logits differ by {errs}")
    del model
    torch.cuda.empty_cache()


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


def phase_main(profile: bool = False) -> dict:
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    max_new = 32
    t0 = time.monotonic()
    dep = LLMDeployment(
        "llama3_8b", num_slots=SLOTS, max_len=S, prompt_buckets=[T],
        default_max_new_tokens=max_new, decode_horizon=8,
        max_admissions_per_step=NB, dtype=torch.bfloat16, seed=0,
    )
    replica = dep.make_replica("llama3_8b-0")
    engine = replica.engine
    layers = engine.model.cfg.num_layers
    V = engine.model.cfg.vocab_size
    print(f"[main] llama3_8b bf16 {layers} layers, "
          f"{engine.model.param_bytes() / 1e9:.2f} GB of weights, replica "
          f"built and warmed in {time.monotonic() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    payloads = []
    for i in range(8):
        prompt = rng.integers(0, V, int(rng.integers(40, 61))).tolist()
        payload = {"tokens": prompt, "max_new_tokens": max_new}
        if i >= 6:
            payload.update(temperature=0.8, top_k=50, seed=100 + i)
        payloads.append(payload)
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
                fail("replica refused a request")
        results = [r.future.result(timeout=600) for r in reqs]
        wall = time.monotonic() - t_start
        replica.stop()
        torch.cuda.synchronize()
    if profile:
        _profile_report(prof, wall)
    counts = {"flash_attention": fl.launches,
              "decode_attention": dec.launches,
              "plain": attention.plain_launches}
    for i, res in enumerate(results):
        if len(res.tokens) != max_new or res.finish_reason != "length":
            fail(f"request {i}: {len(res.tokens)} tokens, "
                 f"{res.finish_reason}")
        if not all(0 <= t < V for t in res.tokens):
            fail(f"request {i}: token id out of vocab")
    expect_flash = layers * engine.prefill_groups
    expect_decode = layers * engine.steps
    if counts["flash_attention"] != expect_flash or expect_flash == 0:
        fail(f"flash launches {counts['flash_attention']}, expected "
             f"{expect_flash} ({engine.prefill_groups} prefill groups)")
    if counts["decode_attention"] != expect_decode or expect_decode == 0:
        fail(f"decode launches {counts['decode_attention']}, expected "
             f"{expect_decode} ({engine.steps} decode steps)")
    if counts["plain"] != 0:
        fail(f"{counts['plain']} attention calls took the plain route")
    ttfts = sorted(r.ttft_ms for r in results)
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[main] 8 requests, {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tok/s, TTFT p50 "
          f"{statistics.median(ttfts):.1f} ms (max {ttfts[-1]:.1f} ms), "
          f"{engine.prefill_groups} prefill groups, {engine.steps} decode "
          f"steps, launches {counts}", flush=True)
    print(f"[main] TTFT parts {engine.ttft_breakdown()}", flush=True)
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,parity,main",
                    help="comma-separated subset of build,kernels,parity,"
                         "main (the device phase always runs)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the main-path window with torch.profiler "
                         "and print device time by kernel")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    dev = phase_device()
    if "build" in phases:
        phase_build()
    kernels = phase_kernels() if "kernels" in phases else {}
    if "parity" in phases:
        phase_parity()
    counts = phase_main(args.profile) if "main" in phases else {}
    for name, row in kernels.items():
        row["launches"] = counts.get(name)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
