"""The seeded arrival schedule and the fixed set of sizes."""

import numpy as np

from gpubench import traffic

OPEN = {"loop": "open", "rate_rps": 12.0, "sizes_seed": 25001,
        "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.9,
                   "min": 32, "max": 1536},
        "output": {"dist": "lognormal", "median": 128, "sigma": 0.8,
                   "min": 16, "max": 512}}
CLOSED = {"loop": "closed", "clients": 8, "pool": 300, "sizes_seed": 7,
          "prompt": {"dist": "uniform", "min": 448, "max": 704},
          "output": {"dist": "uniform", "min": 128, "max": 256}}


def test_schedule_is_the_ports_poisson_schedule():
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        arrival_times,
    )

    ours = list(traffic.arrival_offsets(12.0, 30.0, 5))
    ports = list(arrival_times(RatePattern("constant", base_rps=12.0), 30.0,
                               poisson=True, seed=5))
    assert ours == ports and 300 < len(ours) < 420


def test_same_seed_same_plan():
    a = traffic.make_plan(OPEN, 30.0, 2 ** 40 + 3, vocab=32768)
    b = traffic.make_plan(OPEN, 30.0, 2 ** 40 + 3, vocab=32768)
    assert a.offsets == b.offsets and a.outputs == b.outputs
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))


def test_seeds_reorder_one_set_of_sizes_and_gaps():
    a = traffic.make_plan(OPEN, 30.0, 11, vocab=32768)
    b = traffic.make_plan(OPEN, 30.0, 2 ** 33 + 1, vocab=32768)
    assert a.outputs != b.outputs
    assert sorted(a.outputs) == sorted(b.outputs)
    assert sorted(map(len, a.prompts)) == sorted(map(len, b.prompts))
    gaps = lambda p: sorted(np.round(np.diff([0.0] + p.offsets), 12))
    assert gaps(a) == gaps(b)
    assert max(a.offsets) < 30.0 and len(a.offsets) == len(b.offsets)
    assert all(o < 32768 for p in a.prompts for o in p)


def test_length_clips_and_closed_pool():
    p = traffic.make_plan(OPEN, 30.0, 1, vocab=100)
    assert min(map(len, p.prompts)) >= 32 and max(map(len, p.prompts)) <= 1536
    assert 16 <= min(p.outputs) and max(p.outputs) <= 512
    c = traffic.make_plan(CLOSED, 30.0, 1, vocab=100)
    assert c.clients == 8 and len(c.prompts) == 300 and not c.offsets
    assert 448 <= min(map(len, c.prompts)) <= max(map(len, c.prompts)) <= 704
    # The longest request fits the gpt2-medium engine's 1024 positions.
    assert max(len(x) + n for x, n in zip(c.prompts, c.outputs)) <= 960


def test_block_permutation_keeps_each_block_s_set():
    rng = np.random.default_rng(3)
    perm = traffic.block_permutation(rng, 10, 4)
    assert sorted(perm) == list(range(10))
    assert sorted(perm[:4]) == [0, 1, 2, 3] and sorted(perm[8:]) == [8, 9]
    assert list(traffic.block_permutation(rng, 5, 1)) == list(range(5))


def test_a_closed_loop_carries_its_ramp():
    assert traffic.make_plan(dict(CLOSED, ramp_s=20), 30.0, 1,
                             vocab=100).ramp_s == 20.0
    assert traffic.make_plan(CLOSED, 30.0, 1, vocab=100).ramp_s == 0.0
    assert traffic.make_plan(OPEN, 30.0, 1, vocab=100).ramp_s == 0.0
