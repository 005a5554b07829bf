"""Runtime capture flight recorder — the graph layer's hop ledger.

Port of ``ray_dynamic_batching_tpu/utils/compile_ledger.py``. Where the
reference hooks ``jax.monitoring``'s compilation callbacks, the port's
programs (``ops/graphs.py``) report their own episodes: the unit is a
**capture** — the first call of a new program key, which on the card runs
the program once and records it as a CUDA graph, and on the CPU (or under
``graphs.disable_capture()``), where nothing is captured, runs it and
records the same episode, so the CPU tests can show that warmup covers
serving.

- ``instrument(name, fn)`` wraps a program; while a wrapped call is on
  the stack, any episode reported is charged to ``name``. A replay
  reports nothing, so the wrapper's steady-state cost is one
  thread-local push/pop. One wrapped call in which an episode was
  reported counts as ONE episode.
- a phase machine (``startup`` → ``warmup`` → ``steady``) driven by
  ``begin_warmup()``/``end_warmup()`` around ``DecodeEngine.warmup()``
  (depth-counted: nested warmups — colocated engines, a rolling
  successor warming beside a serving engine — re-enter the warmup
  phase). The first ``end_warmup`` that unwinds to depth 0 arms the
  **steady-state mark**: every later episode is a recorded violation
  carrying the function, argument shapes, and triggering callsite.
- every episode increments ``rdb_jit_compiles_total{fn,phase}`` (fn
  label bounded — an unbounded cardinality bug cannot mint series) and
  emits a ``jit.compile`` tracer span, so captures join the flight
  record and the hop ledger.

An episode reported with no wrapped call on the stack lands under
``__unattributed__`` with a callsite walked from the Python stack.

Each episode carries two times: ``run_ms``, the program's first (eager)
call, and ``capture_ms``, recording it as a graph (0 where nothing is
captured).
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_dynamic_batching_tpu_torch.utils import metrics as m
from ray_dynamic_batching_tpu_torch.utils.concurrency import (
    OrderedLock,
    assert_owner,
)
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

logger = get_logger("compile_ledger")

UNATTRIBUTED = "__unattributed__"

PHASE_STARTUP = "startup"
PHASE_WARMUP = "warmup"
PHASE_STEADY = "steady"

# Hot-path fn labels are a small closed set (ops/jit_model.py registry
# + __unattributed__); 16 leaves headroom without unbounding the series.
COMPILES = m.Counter(
    "rdb_jit_compiles_total",
    "CUDA-graph capture episodes (first calls of a new program key where "
    "nothing is captured) by program and ledger phase "
    "(startup | warmup | steady — steady MUST stay 0 in serving)",
    tag_keys=("fn", "phase"),
    bounded_tags={"fn": 16},
)


class SteadyStateViolation(RuntimeError):
    """A capture landed after the steady-state mark (post-warmup)."""


_tls = threading.local()


class _Frame:
    __slots__ = ("name", "fired", "run_ms", "capture_ms")

    def __init__(self, name: str) -> None:
        self.name = name
        self.fired = False
        self.run_ms = 0.0
        self.capture_ms = 0.0


def _frames() -> List[_Frame]:
    stack = getattr(_tls, "frames", None)
    if stack is None:
        stack = _tls.frames = []
    return stack


def _shape_sig(args: Tuple[Any, ...], limit: int = 12) -> str:
    """Compact shape/dtype signature of a call's positional args —
    attribution detail for episodes, computed ONLY when one fired."""
    parts: List[str] = []
    for a in args[:limit]:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            parts.append(f"{dtype}[{','.join(str(d) for d in shape)}]")
        elif isinstance(a, (int, float, bool)):
            parts.append(repr(a))
        elif isinstance(a, (tuple, list)):
            parts.append(f"{type(a).__name__}({len(a)})")
        else:
            parts.append(type(a).__name__)
    if len(args) > limit:
        parts.append("...")
    return f"({', '.join(parts)})"


def _callsite() -> str:
    """First stack frame outside torch, this module and the graph runner
    — the code that triggered the capture, repo-relative when possible."""
    for fr in reversed(traceback.extract_stack()):
        fn = fr.filename.replace("\\", "/")
        if "/torch/" in fn or fn.endswith(
            ("/utils/compile_ledger.py", "/ops/graphs.py")
        ):
            continue
        for marker in ("ray_dynamic_batching_tpu_torch/", "tools/",
                       "tests/"):
            i = fn.find(marker)
            if i >= 0:
                fn = fn[i:]
                break
        return f"{fn}:{fr.lineno} ({fr.name})"
    return "<unknown>"


class CompileLedger:
    """Process-wide capture episode recorder (see module docstring)."""

    def __init__(self) -> None:
        self._lock = OrderedLock("compile_ledger")
        self._phase = PHASE_STARTUP
        self._warmup_depth = 0
        # fn -> {"episodes": int, "by_phase": {phase: int},
        #        "run_ms"/"capture_ms": float}
        self._fns: Dict[str, Dict[str, Any]] = {}
        self._violations: List[Dict[str, Any]] = []

    # --- phase machine --------------------------------------------------
    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    def begin_warmup(self) -> None:
        with self._lock:
            self._warmup_depth += 1
            self._phase = PHASE_WARMUP

    def end_warmup(self) -> None:
        with self._lock:
            self._warmup_depth = max(0, self._warmup_depth - 1)
            if self._warmup_depth == 0:
                self._phase = PHASE_STEADY

    def steady_state(self) -> None:
        """Force-arm the steady-state mark (gates/tests; engine warmup
        arms it through ``end_warmup``)."""
        with self._lock:
            self._warmup_depth = 0
            self._phase = PHASE_STEADY

    # --- recording ------------------------------------------------------
    def note_episode(self, run_ms: float, capture_ms: float) -> None:
        """A program ran a new key: charged to the wrapped call on this
        thread's stack (one episode per wrapped call, however many keys
        it ran), else recorded at once as unattributed."""
        stack = _frames()
        if stack:
            fr = stack[-1]
            fr.fired = True
            fr.run_ms += run_ms
            fr.capture_ms += capture_ms
            return
        self._record(UNATTRIBUTED, shapes="", callsite=_callsite(),
                     run_ms=run_ms, capture_ms=capture_ms)

    def _fn_rec(self, name: str) -> Dict[str, Any]:
        assert_owner(self._lock)
        rec = self._fns.get(name)
        if rec is None:
            rec = self._fns[name] = {
                "episodes": 0, "by_phase": {},
                "run_ms": 0.0, "capture_ms": 0.0,
            }
        return rec

    def _record(self, name: str, shapes: str, callsite: str,
                run_ms: float, capture_ms: float) -> None:
        end = time.monotonic() * 1000.0
        with self._lock:
            phase = self._phase
            rec = self._fn_rec(name)
            rec["episodes"] += 1
            rec["by_phase"][phase] = rec["by_phase"].get(phase, 0) + 1
            rec["run_ms"] += run_ms
            rec["capture_ms"] += capture_ms
            if phase == PHASE_STEADY:
                self._violations.append({
                    "fn": name, "phase": phase, "shapes": shapes,
                    "callsite": callsite,
                    "run_ms": round(run_ms, 3),
                    "capture_ms": round(capture_ms, 3),
                })
        # Outside the ledger lock on purpose: the metric and tracer have
        # their own (metrics-rank / plain) locks and neither needs ours.
        COMPILES.inc(tags={"fn": name, "phase": phase})
        tracer().record_span(
            "jit.compile",
            start_ms=end - run_ms - capture_ms, end_ms=end,
            fn=name, phase=phase, shapes=shapes, callsite=callsite,
            run_ms=round(run_ms, 3), capture_ms=round(capture_ms, 3),
        )
        if phase == PHASE_STEADY:
            logger.warning(
                "steady-state capture: fn=%s shapes=%s at %s "
                "(%.1f ms first run, %.1f ms capture)",
                name, shapes, callsite, run_ms, capture_ms,
            )

    # --- instrumentation ------------------------------------------------
    def instrument(self, name: str,
                   fn: Callable[..., Any]) -> Callable[..., Any]:
        """Wrap a program so its episodes are charged to ``name``.
        Replays cost one list push/pop."""
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            frame = _Frame(name)
            stack = _frames()
            stack.append(frame)
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
                if frame.fired:
                    self._record(
                        name,
                        shapes=_shape_sig(args),
                        callsite=_callsite(),
                        run_ms=frame.run_ms,
                        capture_ms=frame.capture_ms,
                    )
        wrapper.__name__ = f"ledger[{name}]"
        wrapper.__wrapped__ = fn
        return wrapper

    # --- inspection -----------------------------------------------------
    def counts(self, phase: Optional[str] = None) -> Dict[str, int]:
        with self._lock:
            if phase is None:
                return {n: r["episodes"] for n, r in self._fns.items()}
            return {
                n: r["by_phase"].get(phase, 0)
                for n, r in self._fns.items()
                if r["by_phase"].get(phase, 0)
            }

    def violations(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._violations)

    def check_steady(self) -> None:
        """Raise :class:`SteadyStateViolation` if any capture landed
        after the steady-state mark — the gate's hard failure."""
        v = self.violations()
        if v:
            lines = [
                f"  {x['fn']} {x['shapes']} at {x['callsite']}"
                for x in v
            ]
            raise SteadyStateViolation(
                f"{len(v)} capture(s) after the steady-state mark:\n"
                + "\n".join(lines)
            )

    def report(self) -> Dict[str, Any]:
        """Deterministically ordered snapshot (ms rounded to whole
        milliseconds so serializing the same state is byte-stable)."""
        with self._lock:
            fns = {
                name: {
                    "episodes": rec["episodes"],
                    "by_phase": dict(sorted(rec["by_phase"].items())),
                    "run_ms": int(round(rec["run_ms"])),
                    "capture_ms": int(round(rec["capture_ms"])),
                }
                for name, rec in sorted(self._fns.items())
            }
            violations = list(self._violations)
            phase = self._phase
        totals = {p: 0 for p in (PHASE_STARTUP, PHASE_WARMUP,
                                 PHASE_STEADY)}
        for rec in fns.values():
            for p, n in rec["by_phase"].items():
                totals[p] = totals.get(p, 0) + n
        return {
            "phase": phase,
            "functions": fns,
            "total_compiles": sum(r["episodes"] for r in fns.values()),
            "by_phase": totals,
            "violations": violations,
        }

    def to_json(self) -> str:
        return json.dumps(self.report(), indent=2, sort_keys=True) + "\n"

    def reset(self) -> None:
        """Clear all state in place (the process ledger is a singleton
        its programs report to; tests reset it between cases)."""
        with self._lock:
            self._phase = PHASE_STARTUP
            self._warmup_depth = 0
            self._fns = {}
            self._violations = []


_ledger = CompileLedger()


def get_ledger() -> CompileLedger:
    """The process ledger."""
    return _ledger


def instrument(name: str, fn: Callable[..., Any]) -> Callable[..., Any]:
    """Module-level convenience: wrap ``fn`` against the process
    ledger (see :meth:`CompileLedger.instrument`)."""
    return _ledger.instrument(name, fn)
