"""Run one cell of the port's benchmark and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the port's spans and the device
trace). The last line of standard output is the result, one JSON object;
the numbers that decide ``correct``, each beside its limit, are the last
lines of standard error and the result's last key (``checks``).

``--control fp8`` judges, in place of the served tokens, the tokens that
the reference computed from float8 products puts first at each position
of the same prompts and served tokens: the check's control, which has to
come out not correct. ``--control int8w`` serves the port's weight-only
int8 path instead of bf16 (a reading kept beside it). ``--rate``
overrides an open loop's rate (the knee sweep). None of them belongs to
a benchmark run. Exits 2, printing no result, without
a card; 3 if the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so only a checkout's first run builds; nothing loads JAX through a
    library."""
    cache = ROOT / "build" / "gpubench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    # The port builds its kernels into <checkout>/build/torch_kernels
    # unless told to use a shared directory elsewhere.
    os.environ.pop("RDB_COMPILATION_CACHE_DIR", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8", "int8w"), default=None)
    ap.add_argument("--rate", type=float, default=0.0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))

    import torch

    from gpubench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    need = next(int(w["chips"]) for w in spec["workloads"]
                if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gpubench: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), spec, PROCESS_START,
                      control=args.control, rate_rps=args.rate)
    loaded = harness.forbidden_modules(list(sys.modules))
    if loaded:
        print(f"gpubench: loaded {', '.join(loaded)}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    for name, c in out.checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
