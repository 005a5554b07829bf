"""Kernel 1's vision body against edited copies of itself, on one CUDA card.

Builds ``ray_dynamic_batching_tpu_torch/csrc/flash_attention.cu`` as it is
and a few variants of it (each a named text edit of that source, compiled
into ``build/flash_variants/``), then times every build at ViT-B/16's and
ViT-G/14's attention (q/k/v views of one packed qkv projection, bf16, no
mask, as ``chip_smoke.py`` phase 3 feeds them) beside one
``scaled_dot_product_attention`` call, and checks each result against the
plain version. Run from the root of a checkout::

    python3 flash_variants.py

Variants:

- ``no_kv_reads``: K and V are never read from device memory (the copies
  zero-fill shared memory instead): how much of the time is bytes;
- ``two_blocks_an_sm``: 48 KB more shared memory a block at head_dim 64,
  so two blocks share an SM instead of three (8 warps an SM, not 12): how
  much occupancy buys;
- ``guarded_tiles``: every tile takes the partial-tile instantiation, whose
  unrolled products test the live key groups at run time;
- ``staggered``: blocks start 0, 700 or 1400 clock cycles late by
  (blockIdx.x + blockIdx.y) % 3, so the three blocks sharing an SM do
  not walk their tiles in step: whether the warps of a scheduler
  overlap one's exp with another's products;
- ``exp_f16x2``: p from ``ex2.approx.f16x2``, two scores an instruction
  (half the MUFU work, f16 arguments): how much of a tile is the exp;
- ``stamps``: the unchanged body with ``clock64`` stamps at each phase of
  every tile for the warps of one batch row; prints the median cycles of
  QK^T + row max, exp + pack, and PV + the wait for the next tile.

``--body c`` instead times body C (the long-row body: TMA + wgmma) at the
servables' rows it takes — Whisper's encoder [8,1500,20,64], DistilBERT
[32,256,12,64] and gpt2_medium's no-cache [8,256,16,64] (causal), each
under its key mask as the models make it — against its variants:

- ``one_block_an_sm``: ``__launch_bounds__(288, 1)``, so ptxas may keep
  every accumulator in registers (no spills) at one block an SM;
- ``stages_2`` / ``stages_4``: a 2- or 4-deep K / V / mask ring.

Exits non-zero without a card. Numbers go to standard output; PERF.md
quotes them with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from ray_dynamic_batching_tpu_torch.ops import _build
from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

OUT = Path(__file__).resolve().parent / "build" / "flash_variants"
STAMP_SLOTS = 16 * 16 * 128   # heads x warps x (round, tile, phase)

KV_K = "rdb::cp_async16(ks + swz<HP>(r, c), in ? kb + r * st.kt + c * 8 : kb, in);"
KV_V = "rdb::cp_async16(vs + swz<HP>(r, c), in ? vb + r * st.vt + c * 8 : vb, in);"
STAMP_FN = """__device__ long long g_stamps[%d];
__device__ __forceinline__ void stamp(int slot) {
  if (blockIdx.y == 5 && threadIdx.x %% 32 == 0 && slot < 128)
    g_stamps[(blockIdx.x * 16 + threadIdx.x / 32) * 128 + slot] = clock64();
}
""" % STAMP_SLOTS
# Appended at the end of the file, outside the anonymous namespace.
STAMP_READ = """
extern "C" int rdb_stamps(long long* host, int n, int clear) {
  return static_cast<int>(clear ? cudaMemcpyToSymbol(g_stamps, host, 8 * n)
                                : cudaMemcpyFromSymbol(host, g_stamps, 8 * n));
}
"""
EX2H2 = """#include <cuda_fp16.h>
__device__ __forceinline__ float2 ex2h2(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  uint32_t y;
  asm("ex2.approx.f16x2 %0, %1;" : "=r"(y) : "r"(*reinterpret_cast<const uint32_t*>(&h)));
  return __half22float2(*reinterpret_cast<const __half2*>(&y));
}
"""
SLOT = "((round * 8 + t) * 4)"
VARIANTS = {
    "committed": [],
    "no_kv_reads": [(KV_K, KV_K.replace(", in);", ", false);")),
                    (KV_V, KV_V.replace(", in);", ", false);"))],
    "two_blocks_an_sm": [(
        "return static_cast<size_t>(2 * kv_rows(Tk) + 16 * WARPS) * HP * 2;",
        "return static_cast<size_t>(2 * kv_rows(Tk) + 16 * WARPS) * HP * 2"
        " + (HP == 64 ? 48 * 1024 : 0);")],
    "guarded_tiles": [("      if (k0 + TBK <= Tk)\n        vision_tile<HP, HL, true>",
                       "      if (false)\n        vision_tile<HP, HL, true>")],
    "staggered": [(
        "  const float scale2 = scale * 1.4426950408889634f;  // to log2 units",
        "  const float scale2 = scale * 1.4426950408889634f;  // to log2 units\n"
        "  {\n    const long long t0 = clock64();\n"
        "    const int d = (blockIdx.x + blockIdx.y) % 3 * 700;\n"
        "    while (clock64() - t0 < d) {\n    }\n  }")],
    "exp_f16x2": [
        ("// --- bf16: tensor cores", EX2H2 + "// --- bf16: tensor cores"),
        ("#pragma unroll\n    for (int c = 0; c < 4; ++c)\n"
         "      p[c] = FULL || j < 2 * kg ? ex2(fmaf(s[j][c], scale2, neg_m[c / 2])) : 0.f;",
         "#pragma unroll\n    for (int c = 0; c < 4; c += 2) {\n"
         "      const float2 e = ex2h2(fmaf(s[j][c], scale2, neg_m[c / 2]),\n"
         "                             fmaf(s[j][c + 1], scale2, neg_m[c / 2]));\n"
         "      p[c] = FULL || j < 2 * kg ? e.x : 0.f;\n"
         "      p[c + 1] = FULL || j < 2 * kg ? e.y : 0.f;\n    }")],
    "stamps": [
        ("// --- bf16: tensor cores", STAMP_FN + "// --- bf16: tensor cores"),
        ("int k0, int kg, int Tk, float scale2, int lane) {",
         "int k0, int kg, int Tk, float scale2, int lane, int sb) {\n  stamp(sb);"),
        ("    neg_m[hh] = -m_new;\n  }", "    neg_m[hh] = -m_new;\n  }\n  stamp(sb + 1);"),
        ("+ tree_sum8(ps[hh]);", "+ tree_sum8(ps[hh]);\n  stamp(sb + 2);"),
        ("k0, 4, Tk, scale2, lane);", f"k0, 4, Tk, scale2, lane, {SLOT});"),
        ("Tk,\n                                   scale2, lane);",
         f"Tk,\n                                   scale2, lane, {SLOT});"),
        ("", STAMP_READ),
    ],
}


RING = "constexpr int STAGES = 3;        // the K / V / mask ring"
VARIANTS_C = {
    "committed": [],
    "one_block_an_sm": [("__global__ void __launch_bounds__(THREADS, 2)\n"
                         "flash_long_kernel(",
                         "__global__ void __launch_bounds__(THREADS, 1)\n"
                         "flash_long_kernel(")],
    "stages_2": [(RING, RING.replace("= 3", "= 2"))],
    "stages_4": [(RING, RING.replace("= 3", "= 4"))],
}
# Body C's rows: (name, shape, causal), each under a key mask.
ROWS_C = (("whisper_encoder", (8, 1500, 20, 64), False),
          ("distilbert_T256", (32, 256, 12, 64), False),
          ("gpt2_apply_T256", (8, 256, 16, 64), True))


def build_all(variants=VARIANTS) -> dict:
    """name -> the bound library; one nvcc per variant, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = source.replace('#include "common.cuh"',
                              f'#include "{_build.CSRC / "common.cuh"}"')
        for old, new in edits:
            if not old:                 # an empty anchor appends
                text += new
                continue
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
    fn_name, argtypes = _build.KERNELS["flash_attention"]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{log}")
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        print(f"[build] {name}: registers by kernel {regs}; {spills[:1]}",
              flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
        libs[name] = lib
    if "stamps" in libs:
        libs["stamps"].rdb_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int]
    return libs


def launch(lib, q, k, v, keep=None, causal=False) -> torch.Tensor:
    """One launch of a build; ``keep`` a keep-mask view (``keep_mask``)."""
    B, Tq, N, H = q.shape
    out = torch.empty((B, Tq, N, H), dtype=q.dtype, device=q.device)
    body = ctypes.c_int(-1)
    mbs, mrs = (0, 0) if keep is None else fl.mask_strides(keep)
    rc = lib.rdb_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if keep is None else keep.data_ptr(), mbs, mrs, out.data_ptr(),
        B, Tq, k.shape[1], N, k.shape[2], H, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), H ** -0.5,
        int(causal), 1, None, torch.cuda.current_stream().cuda_stream,
        ctypes.byref(body))
    if rc:
        sys.exit(f"launch failed: {rc}")
    return out


def main_c(dev) -> None:
    """Body C's rows against its variants (``--body c``)."""
    libs = build_all(VARIANTS_C)
    for name, shape, causal in ROWS_C:
        x = cs._own_stream(cs._servable_case(*shape[:3], shape[1],
                                             shape[2], shape[3], "key",
                                             causal), 0)(torch.bfloat16,
                                                         None, None)
        ref = fl.flash_attention_plain(x["q"], x["k"], x["v"], x["keep"],
                                       causal=causal).float()
        sdpa = cs.time_ms(lambda: cs._sdpa(x["q"], x["k"], x["v"],
                                           x["mask"]))
        print(f"[{name}] {tuple(shape)} sdpa {sdpa:.4f} ms", flush=True)
        for var, lib in libs.items():
            out = launch(lib, x["q"], x["k"], x["v"], x["keep"], causal)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            ms = cs.time_ms(lambda: launch(lib, x["q"], x["k"], x["v"],
                                           x["keep"], causal))
            print(f"[{name}] {var}: {ms:.4f} ms, max_abs_err {err:.3e}",
                  flush=True)
    print(f"[device] {dev['smi']}", flush=True)


def stamp_medians(lib, x) -> str:
    """One launch; the median cycles of each phase over the full tiles
    stamped (batch row 5, every head and warp)."""
    buf = np.zeros(STAMP_SLOTS, np.int64)
    torch.cuda.synchronize()
    lib.rdb_stamps(buf.ctypes.data, buf.size, 1)
    launch(lib, x["q"], x["k"], x["v"])
    torch.cuda.synchronize()
    lib.rdb_stamps(buf.ctypes.data, buf.size, 0)
    s = buf.reshape(16, 16, 32, 4)     # head, warp, round * 8 + tile, phase
    qk, ex, pv = [], [], []
    for a, b in zip(s[:, :, :-1].reshape(-1, 4), s[:, :, 1:].reshape(-1, 4)):
        if a[0] and a[2] and b[0] > a[2]:
            qk.append(a[1] - a[0])
            ex.append(a[2] - a[1])
            pv.append(b[0] - a[2])
    return (f"cycles a tile (median of {len(qk)}): QK^T + row max "
            f"{np.median(qk):.0f}, exp + pack {np.median(ex):.0f}, PV + "
            f"next tile's wait {np.median(pv):.0f}")


def main() -> None:
    dev = cs.phase_device()
    if sys.argv[1:] == ["--body", "c"]:
        main_c(dev)
        return
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in (("vit", cs.VIT_SHAPE), ("vit_g", cs.VIT_G_SHAPE)):
        x = cs._packed_qkv(shape, torch.bfloat16, gen)
        ref = fl.flash_attention_plain(x["q"], x["k"], x["v"]).float()
        sdpa = cs.time_ms(lambda: cs._sdpa(x["q"], x["k"], x["v"], None))
        print(f"[{name}] {tuple(shape)} sdpa {sdpa:.4f} ms", flush=True)
        for var, lib in libs.items():
            out = launch(lib, x["q"], x["k"], x["v"])
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            ms = cs.time_ms(lambda: launch(lib, x["q"], x["k"], x["v"]))
            line = f"[{name}] {var}: {ms:.4f} ms, max_abs_err {err:.3e}"
            if var == "stamps":
                line += "; " + stamp_medians(lib, x)
            print(line, flush=True)
    print(f"[device] {dev['smi']}", flush=True)


if __name__ == "__main__":
    main()
