"""Kernel 1's backward against edited copies of itself, on one CUDA card.

Builds ``ray_dynamic_batching_tpu_torch/csrc/flash_attention_bwd.cu`` as it
is and a few variants of it (each a named text edit of that source,
compiled into ``build/flash_bwd_variants/``), prints ptxas's registers and
spills for every bf16 kernel of each build, then times each build's
backward alone at llama3_8b's training shape (q [4,512,32,128], k/v
[4,512,8,128] bf16, causal + a key mask with batch row 1's last quarter
padding, as ``chip_smoke.py`` phase 22a feeds it) with its split by kernel
from ``torch.profiler``, and checks its gradients against autograd of the
plain version. Run from the root of a checkout::

    python3 flash_bwd_variants.py

Variants:

- ``fma``: the bf16 route sent to the FMA kernels the f32 route keeps
  (what the bf16 route ran before its tensor-core kernels);
- ``two_launches``: the dK/dV role's blocks and the dQ role's as two
  launches of the fused kernel, one after the other (what the fusion
  saves);
- ``dkdv_only`` and ``dq_only``: one role's blocks alone (the preprocess
  and that role: the split the fused launch hides; the other role's
  gradients are left unwritten);
- ``dq_halves_unrolled``: the dQ role's two 32-key halves of a tile in a
  loop the compiler unrolls (it spills at head_dim 128);
- ``inline``: both roles inlined into the kernel's one body (ptxas
  spills at head_dim 128; the committed roles are ``__noinline__``);
- ``dkdv_bq16``: the dK/dV role walks 16 query rows a step at head_dim
  128, not 32 (fewer registers, twice the steps).

Exits non-zero without a card. Numbers go to standard output; PERF.md
quotes them with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from ray_dynamic_batching_tpu_torch.ops import _build
from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

OUT = Path(__file__).resolve().parent / "build" / "flash_bwd_variants"

LAUNCH = ("  kern<<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>"
          "(a, static_cast<int>(n_kv));")
DQ_HALVES = "#pragma unroll 1  // unrolled, the halves' fragments spill at HP 128"
VARIANTS = {
    "committed": [],
    "fma": [("launch_bf16<64>(", "launch<__nv_bfloat16, 64>("),
            ("launch_bf16<128>(", "launch<__nv_bfloat16, 128>(")],
    "two_launches": [(LAUNCH, LAUNCH.replace("(blocks)", "(n_kv)") + "\n"
                      "  kern<<<static_cast<unsigned>(blocks - n_kv), "
                      "TC_THREADS, smem, stream>>>(a, 0);")],
    "dkdv_only": [(LAUNCH, LAUNCH.replace("(blocks)", "(n_kv)"))],
    "dq_only": [(LAUNCH, LAUNCH.replace("(blocks)", "(blocks - n_kv)")
                 .replace("static_cast<int>(n_kv)", "0"))],
    "dq_halves_unrolled": [(DQ_HALVES, "#pragma unroll")],
    "inline": [("__device__ __noinline__ void dkdv_block",
                "__device__ __forceinline__ void dkdv_block"),
               ("__device__ __noinline__ void dq_block",
                "__device__ __forceinline__ void dq_block")],
    "dkdv_bq16": [("static constexpr int BQ = HP == 128 ? 32 : 64;",
                   "static constexpr int BQ = HP == 128 ? 16 : 64;")],
}


def build_all() -> dict:
    """name -> the bound library; one nvcc per variant, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source.replace('#include "common.cuh"',
                              f'#include "{_build.CSRC / "common.cuh"}"')
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: edit anchor not found once: {old!r}")
            text = text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    fn_name, argtypes = _build.KERNELS["flash_attention_bwd"]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{log}")
        (OUT / f"{name}.ptxas.log").write_text(log)
        kern, spills = None, []
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kern = next((k for _, keys in cs.TRAIN_BWD_ROLES[1:]
                             for k in keys if k in ln), None)
                kern = kern and kern + ("<128>" if "Li128E" in ln else
                                        "<64>" if "Li64E" in ln else "")
                spills = []
            elif kern and "spill stores" in ln:
                spills.append(int(ln.split("bytes spill stores")[0]
                                  .split(",")[-1]))
            elif kern and "Used" in ln and "bf16" in kern:
                print(f"[ptxas] {name} {kern}: "
                      f"{ln.split('Used')[1].split(',')[0].strip()}; "
                      f"spill stores by function {spills} bytes", flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, x, saved, grads) -> None:
    """One backward launch of ``lib`` on the saved forward."""
    q, k, v = x["q"], x["k"], x["v"]
    B, Tq, N, H = q.shape
    rc = getattr(lib, _build.KERNELS["flash_attention_bwd"][0])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), saved["out"].data_ptr(),
        x["dout"].data_ptr(), saved["lse"].data_ptr(), x["keep"].data_ptr(),
        grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
        saved["D"].data_ptr(), B, Tq, k.shape[1], N, k.shape[2], H,
        H ** -0.5, 1, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"launch failed: {rc}")


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    dev = cs.phase_device()
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = cs._train_attn_inputs(4, 512, 32, 8, 128, torch.bfloat16, gen)
    B, T, N, H = x["q"].shape
    lse = torch.empty((B, N, T), dtype=torch.float32, device="cuda")
    out = fl._launch(x["q"], x["k"], x["v"], x["keep"], causal=True,
                     scale=H ** -0.5, lse=lse)
    saved = dict(out=out, lse=lse, D=torch.empty_like(lse))
    want = cs._train_attn_grads(x, kernel=False)[1:]
    b_ms, b_by = cs.bound(*cs._train_bwd_cost(x), torch.bfloat16)
    print(f"[bwd] q{tuple(x['q'].shape)} k{tuple(x['k'].shape)} bf16 causal "
          f"+ key mask; backward bound {b_ms:.4f} ms ({b_by})", flush=True)
    first = None
    for name, lib in libs.items():
        grads = [torch.zeros_like(x[n]) for n in "qkv"]
        launch(lib, x, saved, grads)
        torch.cuda.synchronize()
        if name.endswith("_only"):
            check = "; one role: its gradients only"
        else:
            errs = [(g.float() - w.float()).abs().max().item()
                    / w.float().abs().max().item()
                    for g, w in zip(grads, want)]
            check = "; dq / dk / dv max abs err over max |ref| " + " / ".join(
                f"{e:.2e}" for e in errs)
            if first is None:
                first = [g.clone() for g in grads]
            else:
                check += "; bits {} committed".format(
                    "equal to" if all(torch.equal(a, b)
                                      for a, b in zip(grads, first))
                    else "differ from")
        ms = cs.time_ms(lambda: launch(lib, x, saved, grads), 10, 5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                launch(lib, x, saved, grads)
            torch.cuda.synchronize()
        split = cs._by_role(prof, cs.TRAIN_BWD_ROLES[1:], 5)
        print(f"[bwd] {name}: {ms:.4f} ms (" + ", ".join(
            f"{r} {t:.4f}" for r, t in split.items() if t) + ")" + check,
            flush=True)
    print(f"[device] {dev['smi']}", flush=True)


if __name__ == "__main__":
    main()
