"""The port's capture flight recorder (``utils/compile_ledger.py``): one
twin of each test in ``tests/test_compile_ledger.py``, written against the
port's ledger and its programs (``ops/graphs.py``).

The unit is the EPISODE — one wrapped call in which a program ran a key
for the first time. On the CPU nothing is captured: a program runs its
impl and records the same episode a capture on the card would, so the
first call of each new input shape (or host-static value) is one episode
and a repeat is none.
"""

import json
import threading

import pytest
import torch

from ray_dynamic_batching_tpu_torch.ops import graphs
from ray_dynamic_batching_tpu_torch.utils.compile_ledger import (
    PHASE_STARTUP,
    PHASE_STEADY,
    PHASE_WARMUP,
    SteadyStateViolation,
    get_ledger,
)


@pytest.fixture()
def ledger():
    led = get_ledger()
    led.reset()
    yield led
    # Leave the process ledger disarmed so later tests' episodes are
    # plain startup episodes, never false violations.
    led.reset()


def _toy(scale):
    # A fresh program per test: it has seen no key, so first-call
    # episodes are deterministic regardless of what ran before.
    return graphs.GraphSet(torch.device("cpu")).program(
        "toy", lambda x: x * scale)


class TestEpisodeCounting:
    def test_first_call_is_exactly_one_episode(self, ledger):
        fn = ledger.instrument("toy", _toy(2))
        fn(torch.ones((4,)))
        assert ledger.counts()["toy"] == 1

    def test_cached_dispatch_records_nothing(self, ledger):
        fn = ledger.instrument("toy", _toy(3))
        fn(torch.ones((4,)))
        before = ledger.counts()["toy"]
        fn(torch.ones((4,)))
        fn(torch.ones((4,)))
        assert ledger.counts()["toy"] == before

    def test_forced_retrace_counts_exactly_once_per_shape(self, ledger):
        fn = ledger.instrument("toy", _toy(5))
        fn(torch.ones((4,)))          # startup episode
        ledger.begin_warmup()
        fn(torch.ones((8,)))          # new shape: ONE warmup episode
        fn(torch.ones((8,)))          # seen
        ledger.end_warmup()
        assert ledger.counts()["toy"] == 2
        assert ledger.counts(phase=PHASE_STARTUP)["toy"] == 1
        assert ledger.counts(phase=PHASE_WARMUP)["toy"] == 1
        assert ledger.counts(phase=PHASE_STEADY) == {}

    def test_result_passes_through_wrapper(self, ledger):
        fn = ledger.instrument("toy", _toy(7))
        out = fn(torch.ones((2,)))
        assert out.tolist() == [7.0, 7.0]


class TestSteadyStateMark:
    def test_violation_recorded_and_gate_raises(self, ledger):
        fn = ledger.instrument("toy", _toy(11))
        ledger.begin_warmup()
        fn(torch.ones((4,)))
        ledger.end_warmup()
        ledger.check_steady()  # clean so far
        fn(torch.ones((16,)))  # post-warmup new shape: the violation
        v = ledger.violations()
        assert len(v) == 1
        assert v[0]["fn"] == "toy"
        assert "16" in v[0]["shapes"]
        assert "test_torch_compile_ledger" in v[0]["callsite"]
        with pytest.raises(SteadyStateViolation) as exc:
            ledger.check_steady()
        assert "toy" in str(exc.value)

    def test_nested_warmups_arm_only_at_depth_zero(self, ledger):
        fn = ledger.instrument("toy", _toy(13))
        ledger.begin_warmup()
        ledger.begin_warmup()
        ledger.end_warmup()
        # Still inside the outer warmup: episodes are warmup, not steady.
        fn(torch.ones((4,)))
        ledger.end_warmup()
        assert ledger.counts(phase=PHASE_WARMUP)["toy"] == 1
        assert ledger.violations() == []
        assert ledger.phase == PHASE_STEADY

    def test_force_arm_via_steady_state(self, ledger):
        fn = ledger.instrument("toy", _toy(17))
        ledger.steady_state()
        fn(torch.ones((4,)))
        with pytest.raises(SteadyStateViolation):
            ledger.check_steady()


class TestReport:
    def test_report_is_byte_stable(self, ledger):
        fn = ledger.instrument("toy", _toy(19))
        ledger.begin_warmup()
        fn(torch.ones((4,)))
        ledger.end_warmup()
        first = ledger.to_json()
        second = ledger.to_json()
        assert first == second
        payload = json.loads(first)
        assert payload["functions"]["toy"]["episodes"] == 1
        assert payload["functions"]["toy"]["capture_ms"] == 0  # the CPU
        assert payload["by_phase"][PHASE_WARMUP] >= 1
        assert payload["violations"] == []
        assert first.endswith("\n")

    def test_reset_clears_everything(self, ledger):
        fn = ledger.instrument("toy", _toy(23))
        ledger.steady_state()
        fn(torch.ones((4,)))
        ledger.reset()
        assert ledger.counts() == {}
        assert ledger.violations() == []
        assert ledger.phase == PHASE_STARTUP

    def test_wrapper_is_thread_attributed(self, ledger):
        # Frames are thread-local: an episode on a worker thread charges
        # the program the WORKER wrapped, not whatever the main thread
        # happens to be running.
        fn = ledger.instrument("worker_toy", _toy(29))
        done = threading.Event()

        def work():
            fn(torch.ones((6,)))
            done.set()

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert done.is_set()
        assert ledger.counts()["worker_toy"] == 1
