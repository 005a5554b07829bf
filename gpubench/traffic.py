"""Traffic of a cell, made from its JSON parameters and the run's seed.

One general generator reads every mix: a cell file's ``traffic`` block
names a loop (``open``: Poisson arrivals at a fixed rate; ``closed``: a
number of clients with no think time, which run ``ramp_s`` seconds
before the window opens, so the window sees the loop in its steady
state), a prompt-length and an output-length distribution
(``lognormal``: median, sigma, clip; or ``uniform``: low, high), and the
seed of the fixed set of sizes and gaps.

The set of sizes and inter-arrival gaps is fixed by the cell
(``sizes_seed``); the run's ``--seed`` only orders them, draws the token
ids and (elsewhere) the weights. It reorders within consecutive blocks of
``shuffle_block`` requests (and gaps), so each stretch of the run offers
the same work whatever the seed: seeds differ no more than runs of one
seed do.

``arrival_offsets`` is a frozen copy of the schedule arithmetic of the
port's ``engine/workload.py`` (``arrival_times`` at a constant Poisson
rate): later changes there do not move this benchmark's arrivals.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np


def arrival_offsets(rate_rps: float, duration_s: float,
                    seed: int) -> Iterator[float]:
    """Poisson arrival offsets in [0, duration_s) at ``rate_rps``:
    exponential gaps from ``random.Random(seed)``, as ``arrival_times``
    draws them for a constant pattern with ``poisson=True``."""
    rng = random.Random(seed)
    t = 0.0
    while t < duration_s:
        t += rng.expovariate(rate_rps)
        if t < duration_s:
            yield t


def block_permutation(rng: np.random.Generator, n: int,
                      block: int) -> np.ndarray:
    """A permutation of range(n) that reorders within consecutive blocks
    of ``block`` only, so every block keeps the same set of items."""
    return np.concatenate([
        start + rng.permutation(min(block, n - start))
        for start in range(0, n, block)]) if n else np.zeros(0, np.int64)


def draw_lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from a length spec: ``{"dist": "lognormal",
    "median", "sigma", "min", "max"}`` (clipped) or ``{"dist":
    "uniform", "min", "max"}`` (inclusive)."""
    dist = spec["dist"]
    lo, hi = int(spec["min"]), int(spec["max"])
    if dist == "lognormal":
        x = rng.lognormal(math.log(float(spec["median"])),
                          float(spec["sigma"]), n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if dist == "uniform":
        return rng.integers(lo, hi + 1, n).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist!r}")


@dataclass
class Plan:
    """What one run offers: request ``i`` has ``prompts[i]`` (token ids)
    and ``outputs[i]`` new tokens; an open loop sends it at
    ``offsets[i]`` seconds into the window, a closed loop hands the
    requests out in order to ``clients`` clients, from ``ramp_s``
    seconds before the window opens."""

    loop: str
    prompts: List[np.ndarray]
    outputs: List[int]
    offsets: List[float]
    clients: int
    rate_rps: float
    ramp_s: float = 0.0


def make_plan(traffic: Dict, seconds: float, seed: int, vocab: int,
              rate_rps: float = 0.0) -> Plan:
    """The run's requests. ``rate_rps`` overrides an open loop's rate
    (the knee sweep); 0 takes the cell's."""
    loop = traffic["loop"]
    sizes = np.random.default_rng(int(traffic["sizes_seed"]))
    order = np.random.default_rng([int(seed), 1])
    ids = np.random.default_rng([int(seed), 2])
    offsets: List[float] = []
    clients = 0
    rate = ramp = 0.0
    if loop == "open":
        rate = float(rate_rps or traffic["rate_rps"])
        gaps = np.diff([0.0, *arrival_offsets(
            rate, seconds, int(traffic["sizes_seed"]))])
        n = len(gaps)
        block = int(traffic.get("shuffle_block", n))
        gaps = gaps[block_permutation(order, n, block)]
        offsets = np.cumsum(gaps).tolist()
    elif loop == "closed":
        clients = int(traffic["clients"])
        ramp = float(traffic.get("ramp_s", 0.0))
        n = int(traffic["pool"])
        block = int(traffic.get("shuffle_block", n))
    else:
        raise ValueError(f"unknown loop {loop!r}")
    prompt_lens = draw_lengths(traffic["prompt"], n, sizes)
    output_lens = draw_lengths(traffic["output"], n, sizes)
    perm = block_permutation(order, n, block)
    prompt_lens, output_lens = prompt_lens[perm], output_lens[perm]
    prompts = [ids.integers(0, vocab, int(p)).astype(np.int64)
               for p in prompt_lens]
    return Plan(loop=loop, prompts=prompts,
                outputs=[int(o) for o in output_lens], offsets=offsets,
                clients=clients, rate_rps=rate, ramp_s=ramp)
