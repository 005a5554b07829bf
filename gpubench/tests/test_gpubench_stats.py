"""Percentiles and the window arithmetic of the end-to-end metrics."""

import math

import pytest

from gpubench import stats


def test_nearest_rank_percentile():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _record(i, scheduled, first, gap, n, start_ok=True):
    r = stats.Record(index=i, prompt_len=10, max_new=n, scheduled=scheduled)
    r.token_times = [first + k * gap for k in range(n)]
    r.tokens = list(range(n)) if start_ok else None
    return r


def test_failed_requests_count_past_every_limit():
    recs = [_record(i, i * 0.1, i * 0.1 + 0.05, 0.01, 4) for i in range(19)]
    assert stats.ttft_p95_ms(recs) == pytest.approx(50.0)
    bad = _record(19, 1.9, 1.95, 0.01, 4)
    bad.error = "RequestDropped: stopped"
    assert not bad.ok
    assert math.isinf(stats.ttft_p95_ms(recs + [bad, bad]))
    # Streamed tokens that disagree with the final result: a failure.
    short = _record(20, 2.0, 2.05, 0.01, 4)
    short.token_times.pop()
    assert not short.ok and math.isinf(short.tpot_s())


def test_tpot_and_tokens_in_the_window():
    r = _record(0, 0.0, 0.1, 0.02, 11)
    assert r.tpot_s() == pytest.approx(0.02)
    assert r.ttft_s() == pytest.approx(0.1)
    # Tokens at 0.1 .. 0.3; the window [0, 0.2] holds 6 of them.
    assert stats.tokens_in([r], 0.0, 0.2 + 1e-9) == 6
    assert stats.output_tok_s([r], 0.0, 1.0) == pytest.approx(11.0)


def _open_loop(stall_at=None, stall_s=0.0):
    """20 requests a second for 10 s, 50 ms to the first token, then
    40 tokens 20 ms apart; a stall of ``stall_s`` at ``stall_at`` holds
    back every token due after it."""
    out = []
    for i in range(200):
        t = i * 0.05
        times = [t + 0.05 + k * 0.02 for k in range(40)]
        if stall_at is not None:
            times = [x + stall_s if x >= stall_at else x for x in times]
        r = stats.Record(index=i, prompt_len=10, max_new=40, scheduled=t)
        r.token_times, r.tokens = times, list(range(40))
        out.append(r)
    return out


def test_a_stall_in_the_window_moves_every_metric():
    calm, stalled = _open_loop(), _open_loop(stall_at=5.0, stall_s=0.8)
    assert stats.ttft_p95_ms(stalled) > stats.ttft_p95_ms(calm)
    assert stats.tpot_p95_ms(stalled) > stats.tpot_p95_ms(calm)
    assert (stats.output_tok_s(stalled, 0.0, 10.0)
            < stats.output_tok_s(calm, 0.0, 10.0))


def test_quartile_spread():
    assert stats.quartile_spread([10, 10, 10, 10]) == 0.0
    assert stats.quartile_spread([90, 100, 110, 100, 95, 105]) > 0
