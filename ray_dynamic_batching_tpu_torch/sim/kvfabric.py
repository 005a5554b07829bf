"""Sim twin of the KV page fabric: rolling updates with live migration
vs. drain-evict-requeue.

A deterministic virtual-time ledger — not the full ``Simulation``
machinery, because the question this twin answers is narrow and the
answer must be exact: when every replica in a deployment is rolled once
(the rolling-update worst case), what happens to the streams that were
mid-decode on each victim?

- **drain** arm (the pre-fabric baseline): a victim's live streams are
  requeue-ELIGIBLE only before their first token (the at-most-once
  pin — a stream that already emitted tokens cannot be replayed without
  re-delivering them). Streams past their first token at roll time are
  DROPPED; prefilling streams replay from scratch (requeued).
- **migrate** arm: every live stream is frozen into a parcel
  (page-rounded KV bytes + the cursor) and couriered to a surviving
  replica, costing a pause of ``parcel_mb x COURIER_MS_PER_MB`` — the
  SAME constant the replanner prices moves with (``scheduler/replan``)
  — after which it resumes exactly where it stopped. Zero drops, zero
  replays, by construction.

Both arms run the identical seeded workload; reports render to sorted
JSON so the soak can assert byte-determinism across runs. No wall
clock, no global RNG (sim-determinism lint applies to this file).

Own copy of ``ray_dynamic_batching_tpu/sim/kvfabric.py``, whole, with
its import paths rewritten.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Dict, List

from ray_dynamic_batching_tpu_torch.scheduler.replan import COURIER_MS_PER_MB


@dataclass
class MigrationScenario:
    """One rolling-update workload: ``replicas`` engines each decoding
    ``streams_per_replica`` streams, every replica rolled once at a
    staggered virtual time while its streams are mid-flight."""

    replicas: int = 3
    streams_per_replica: int = 6
    mean_prompt_tokens: int = 384
    mean_new_tokens: int = 96
    page_size: int = 128
    # int8-KV tiny model scale: bytes of k+v (+ scale planes) per cached
    # token across layers — only relative cost matters to the gate.
    kv_bytes_per_token: int = 4096
    decode_ms_per_token: float = 8.0
    prefill_ms_per_token: float = 0.15
    # Virtual time at which replica i rolls: roll_start_ms + i * stagger.
    roll_start_ms: float = 250.0
    roll_stagger_ms: float = 150.0
    seed: int = 0


def _pages(tokens: int, page_size: int) -> int:
    return -(-max(0, tokens) // page_size)


def run_migration_sim(scenario: MigrationScenario, arm: str) -> Dict:
    """One arm over the scenario's seeded workload. ``arm`` is
    ``"drain"`` or ``"migrate"``; returns the ledger report."""
    if arm not in ("drain", "migrate"):
        raise ValueError(f"unknown arm {arm!r} (want drain|migrate)")
    rng = random.Random(scenario.seed)
    streams: List[Dict] = []
    for rep in range(scenario.replicas):
        for s in range(scenario.streams_per_replica):
            prompt = max(8, int(rng.gauss(scenario.mean_prompt_tokens,
                                          scenario.mean_prompt_tokens / 4)))
            new = max(2, int(rng.gauss(scenario.mean_new_tokens,
                                       scenario.mean_new_tokens / 4)))
            streams.append({
                "replica": rep,
                "prompt": prompt,
                "new": new,
                # Staggered arrivals: later streams are mid-prefill or
                # early-decode when their replica rolls.
                "arrival_ms": rng.uniform(0.0, 400.0),
            })

    completed = dropped = requeued = migrations = 0
    tokens_emitted = 0
    parcel_bytes_total = 0
    pauses: List[float] = []
    for st in streams:
        roll_ms = (scenario.roll_start_ms
                   + st["replica"] * scenario.roll_stagger_ms)
        first_tok_ms = (st["arrival_ms"]
                        + st["prompt"] * scenario.prefill_ms_per_token)
        done_ms = first_tok_ms + st["new"] * scenario.decode_ms_per_token
        if done_ms <= roll_ms:
            # Finished before its replica rolled: unaffected either way.
            completed += 1
            tokens_emitted += st["new"]
            continue
        if arm == "drain":
            if roll_ms < first_tok_ms:
                # Still prefilling: no token emitted yet, replayable.
                requeued += 1
                completed += 1
                tokens_emitted += st["new"]
            else:
                # Past first token: the at-most-once pin forbids replay
                # — the drain arm can only shed it.
                dropped += 1
                k = int((roll_ms - first_tok_ms)
                        / scenario.decode_ms_per_token) + 1
                tokens_emitted += min(k, st["new"])
            continue
        # migrate arm: prefilling streams requeue exactly as before (no
        # pages worth shipping beats a cheap replay); live streams ship.
        if roll_ms < first_tok_ms:
            requeued += 1
            completed += 1
            tokens_emitted += st["new"]
            continue
        k = int((roll_ms - first_tok_ms) / scenario.decode_ms_per_token) + 1
        k = min(k, st["new"])
        cache_len = st["prompt"] + k
        nbytes = (_pages(cache_len, scenario.page_size)
                  * scenario.page_size * scenario.kv_bytes_per_token)
        parcel_bytes_total += nbytes
        pauses.append(nbytes / 1e6 * COURIER_MS_PER_MB)
        migrations += 1
        completed += 1
        tokens_emitted += st["new"]

    tokens_expected = 0
    for st in streams:
        if arm == "drain":
            roll_ms = (scenario.roll_start_ms
                       + st["replica"] * scenario.roll_stagger_ms)
            first_tok_ms = (st["arrival_ms"]
                            + st["prompt"] * scenario.prefill_ms_per_token)
            done_ms = (first_tok_ms
                       + st["new"] * scenario.decode_ms_per_token)
            if done_ms > roll_ms and roll_ms >= first_tok_ms:
                # A shed stream's client got only the tokens emitted
                # before the roll.
                k = int((roll_ms - first_tok_ms)
                        / scenario.decode_ms_per_token) + 1
                tokens_expected += min(k, st["new"])
                continue
        tokens_expected += st["new"]

    report = {
        "arm": arm,
        "arrivals": len(streams),
        "completed": completed,
        "dropped": dropped,
        "requeued": requeued,
        "migrations": migrations,
        "parcel_mb_total": round(parcel_bytes_total / 1e6, 3),
        "pause_ms_mean": round(sum(pauses) / len(pauses), 4) if pauses
        else 0.0,
        "pause_ms_max": round(max(pauses), 4) if pauses else 0.0,
        "tokens_emitted": tokens_emitted,
        "tokens_expected": tokens_expected,
        "conserved": (completed + dropped == len(streams)
                      and tokens_emitted == tokens_expected),
    }
    return report


def render_json(report: Dict) -> str:
    """Canonical byte form for determinism comparison (sorted keys,
    fixed separators — same discipline as ``sim/report.render_json``)."""
    return json.dumps(report, indent=2, sort_keys=True)
