"""Find an open-loop cell's knee: one set-up, a window at each rate.

    python3 gpubench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 8,12,16,20

For each rate, prints the requests sent, TTFT p50 / p95 and TPOT p95 (ms),
the median TTFT of the window's first and last thirds of arrivals, and
how many requests were still waiting for their first token when the
window closed. The knee is the highest rate whose backlog does not grow
over the window (the last third's TTFT stays near the first third's);
the cell's rate is set to 0.8 of it. Not part of a benchmark run.
"""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gpubench import run as run_mod  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    run_mod._fixed_caches()

    import torch

    from gpubench import harness, reference, stats
    from gpubench.traffic import make_plan

    cell = harness.find_cell(args.workload)
    config = harness.find_config(cell["config"])
    dev = torch.device("cuda")
    weights = reference.make_weights(config["decoder"], args.seed, dev)
    served = harness.Served(config, weights, dev)
    print(f"set-up {time.monotonic() - PROCESS_START:.1f} s", flush=True)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            plan = make_plan(cell["traffic"], args.seconds, args.seed,
                             int(config["decoder"]["vocab_size"]), rate)
            records, t0, t1, complete = harness.drive(served.handle, plan,
                                                      args.seconds)
            ok = [r for r in records if r.ok]
            third = max(1, len(records) // 3)
            first = [r.ttft_s() for r in records[:third]]
            last = [r.ttft_s() for r in records[-third:]]
            waiting = sum(1 for r in records
                          if not r.token_times or r.token_times[0] > t1)
            line = {
                "rate_rps": rate, "sent": len(records), "ok": len(ok),
                "complete": complete,
                "ttft_p50_ms": 1e3 * statistics.median(
                    r.ttft_s() for r in records),
                "ttft_p95_ms": stats.ttft_p95_ms(records),
                "tpot_p95_ms": stats.tpot_p95_ms(records),
                "ttft_first_third_p50_ms": 1e3 * statistics.median(first),
                "ttft_last_third_p50_ms": 1e3 * statistics.median(last),
                "waiting_at_close": waiting,
                "output_tok_s": stats.output_tok_s(records, t0, t1),
            }
            print(json.dumps(harness.finite(line)), flush=True)
            if line["ttft_last_third_p50_ms"] > 4 * max(
                    line["ttft_first_third_p50_ms"], 1.0):
                break   # past the knee: higher rates only queue longer
    finally:
        served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
