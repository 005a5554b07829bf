"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), keyed by a hash
of the sources and flags, under ``build/torch_kernels/`` at the root of the
checkout. Libraries are loaded with ``ctypes``; the argument types are
declared here, beside the build, for every entry point.

Nothing here runs at import: the op modules import this module inside the
function that launches a kernel, so CPU-only installs (no ``nvcc``) never
touch it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # Compile a source's many kernel instantiations on every core (the
    # decode sources hold 64): the build gates the smoke run's time limit.
    "--split-compile=0",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# kernel -> (C entry point, argtypes); every entry point returns a
# cudaError_t as int (0 = launched).
KERNELS: Dict[str, tuple] = {
    "flash_attention": (
        "rdb_flash_attention",
        [_P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L,
         _L, _L, _F, _I, _I, _P, _P, ctypes.POINTER(_I)],
    ),
    "flash_attention_bwd": (
        "rdb_flash_attention_bwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _F, _I, _I, _P],
    ),
    "decode_attention": (
        "rdb_decode_attention",
        [_P, _P, _P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _F, _I,
         _I, _P, _L, _P, _I, _P, ctypes.POINTER(_I)],
    ),
    "paged_decode_attention": (
        "rdb_paged_decode_attention",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _F, _I, _I, _P, _L, _P, _I, _P, ctypes.POINTER(_I)],
    ),
    "int8_weight_matmul": (
        "rdb_int8_weight_matmul",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _L, _P, _I, _P,
         ctypes.POINTER(_I)],
    ),
}

# kernel -> {C function: argtypes} of the launch rules each library
# exports beside its entry point (they launch nothing; int return).
RULES: Dict[str, Dict[str, list]] = {
    "flash_attention": {"rdb_flash_body": [_I] * 7 + [ctypes.POINTER(_I)]},
    "decode_attention": {"rdb_row_split_tiles": [_I, _I]},
}

_lock = threading.Lock()
#: Held across each host-side launch call. A launch sets its kernel's
#: dynamic shared-memory limit (a per-function, process-wide attribute)
#: and then launches, so two threads launching one kernel at shapes that
#: need different limits — the engines of two length buckets, or a
#: colocated engine beside a successor warming up on another thread —
#: must not interleave the two calls; the decode kernels' shared merge
#: scratch is picked under it too, so its reuse follows launch order.
launch_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's resource report (-Xptxas -v) per kernel, kept for the smoke run.
ptxas_log: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all started together. Returns the seconds spent."""
    t0 = time.monotonic()
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn_name, argtypes = KERNELS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            for rule, rule_args in RULES.get(name, {}).items():
                getattr(lib, rule).argtypes = rule_args
                getattr(lib, rule).restype = ctypes.c_int
            lib.rdb_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rdb_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error: a refused launch never
    runs, and a later synchronize would not report it."""
    if rc != 0:
        msg = lib.rdb_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")
