"""Phase 12's gated colocation run under two replan rules, on one CUDA card.

``chip_smoke.py`` phase 12 serves two contracts of llama3_8b colocated on
the card under ``LLMLiveScheduler`` through a 2x surge, and fails on a
stale or lost request. This script runs that traffic (its functions, its
config) on decode rows set so that 32 slots lead at the offered rate and
4 slots win below ~50 tok/s, as rows measured on a host-bound card can
fall, once under each rule:

- ``reference``: every replan applies the packer's plan as it comes (the
  JAX package's ``scheduler/llm_control.py``), so the packer's HBM
  tie-break moves an engine between tied rows on rate noise;
- ``port``: a replan keeps a hosted engine's shape while that row still
  serves its rate (``LLMLiveScheduler._keep_hosted_shapes``).

Two runs of each, alternating. Prints, per run, the engine moves, the
stale requests by contract and whether phase 12's gate passed. Run from
the root of a checkout::

    python3 replan_rules.py

Exits non-zero without a card.
"""

from __future__ import annotations

import json
import time

import torch

import chip_smoke as cs
from ray_dynamic_batching_tpu_torch.models import registry
from ray_dynamic_batching_tpu_torch.models.base import _MODEL_SLOS
from ray_dynamic_batching_tpu_torch.profiles.decode_profiler import DecodeProfiler
from ray_dynamic_batching_tpu_torch.profiles.profiler import write_profile_outputs
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile, ProfileRow
from ray_dynamic_batching_tpu_torch.scheduler import llm_control
from ray_dynamic_batching_tpu_torch.utils.config import (
    RDBConfig,
    get_config,
    set_config,
)

# (latency ms, std ms) by slot count; the 16-slot row sets the offered
# rate (0.1 of its throughput, 53.3 tok/s) and the token SLO (132 ms).
ROWS = {4: (17.0, 0.5), 8: (33.0, 5.0), 16: (30.0, 1.0), 32: (27.0, 0.5)}


def main() -> None:
    dev = cs.phase_device()
    cs.phase_build()
    c = dict(cs.COLOCATE)
    card = torch.device("cuda", 0)
    set_config(RDBConfig.from_env(
        hbm_budget_bytes=torch.cuda.get_device_properties(0).total_memory,
        monitoring_interval_s=c["monitoring_interval_s"],
        rate_window_s=c["rate_window_s"]))
    cfg = get_config()
    model = registry.get_model(c["model"], dtype=c["dtype"], device=card,
                               seed=0)
    # The engines size their horizons from measured tables, as in phase 12.
    decode, prefill = DecodeProfiler(
        model, timing_iters=c["timing_iters"],
        warmup_iters=c["warmup_iters"]).sweep(
        slot_buckets=c["slots"], capacities=(c["capacity"],),
        prompt_buckets=(c["bucket"],), group_sizes=c["groups"])
    for table in (decode, prefill):
        write_profile_outputs(table, cs.PROFILES_DIR)
    hbm = {r.batch_size: r.hbm_bytes for r in decode.rows}
    rows = BatchProfile(decode.model_name, [
        ProfileRow(batch_size=n, seq_len=c["capacity"], latency_ms=ms,
                   latency_std_ms=sd, hbm_bytes=hbm[n], compile_ms=1.0)
        for n, (ms, sd) in ROWS.items()])
    token_slo = cfg.slo_safety_factor * ROWS[c["pinned"]][0] * 2.0
    ttft = _MODEL_SLOS[c["model"]].latency_slo_ms
    knobs = dict(model=model, max_len=c["capacity"],
                 prompt_buckets=[c["bucket"]],
                 default_max_new_tokens=c["max_new"],
                 max_admissions_per_step=cs.NB, token_slo_ms=token_slo,
                 ttft_slo_ms=ttft, profiles_dir=cs.PROFILES_DIR)
    budget = cfg.hbm_budget_bytes * cfg.hbm_plan_fraction
    keep = llm_control.LLMLiveScheduler._keep_hosted_shapes
    runs = []
    for rule in ("reference", "port", "reference", "port"):
        llm_control.LLMLiveScheduler._keep_hosted_shapes = (
            keep if rule == "port" else (lambda self, sessions, plan: plan))
        t0 = time.monotonic()
        run = cs._colocate_traffic(f"{rule} rule", c, c["util"], model,
                                   rows, knobs, token_slo, ttft, [], [],
                                   probe=True)
        moves = sum(r["migration_cost"] for r in run["audit"])
        stale = {m: s["stale"] for m, s in run["stats"].items()}
        try:
            cs._traffic_report(f"{rule} rule", c, run, rows, token_slo,
                               budget, True)
            gate = "pass"
        except SystemExit:
            gate = "fail"
        print(f"[replan] {rule} rule: engine moves {moves:.0f}, stale "
              f"{stale}, phase 12's gate {gate} "
              f"({time.monotonic() - t0:.1f} s)", flush=True)
        runs.append(dict(rule=rule, moves=moves, stale=stale, gate=gate))
    llm_control.LLMLiveScheduler._keep_hosted_shapes = keep
    print(f"[device] {dev['smi']}", flush=True)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
