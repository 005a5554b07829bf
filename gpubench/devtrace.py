"""The device trace of a window: kernels from ``torch.profiler``.

Kernel times come from the profiler's CUDA activity (CUPTI), whose
timestamps are on the host's wall clock in nanoseconds; they are mapped
onto ``time.monotonic`` seconds, the clock of the window and of the
port's spans, by one pair of readings taken together.

The busy time is the union of the device operations' intervals (two
kernels that overlap count once), so the idle share is what no
operation covered.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Families of kernels by name, for the per-layer readers, with a
# leading "void " taken off. The weight products are cuBLAS's, matched by
# the prefixes of its kernels' names, and the port's int8 GEMM's; the
# port's kernels are matched by their whole qualified names
# (ray_dynamic_batching_tpu_torch/csrc/*.cu), so a new kernel of the port
# joins no family by a shared word.
CUBLAS_GEMM_PREFIXES = (
    "nvjet_", "sm90_xmma_gemm_", "sm80_xmma_gemm_",
    "cutlass::Kernel2<cutlass_", "ampere_bf16_", "ampere_sgemm_",
    "gemv2N_kernel", "gemv2T_kernel", "gemvx::kernel", "gemmk1_kernel",
    "gemmSN_", "splitKreduce_kernel", "cublasLt::")
PORT_GEMMS = ("(anonymous namespace)::stream_kernel<",
              "(anonymous namespace)::fma_kernel<",
              "(anonymous namespace)::wg::wgmma_kernel<")
DECODE_ATTN = ("(anonymous namespace)::decode_kernel<",
               "(anonymous namespace)::decode_row_kernel<",
               "(anonymous namespace)::paged_decode_kernel<",
               "(anonymous namespace)::paged_row_kernel<")


def _bare(name: str) -> str:
    return name[5:] if name.startswith("void ") else name


@dataclass(frozen=True)
class Op:
    """One device operation, in host monotonic seconds."""

    name: str
    start: float
    end: float


def is_gemm(name: str) -> bool:
    return _bare(name).startswith(CUBLAS_GEMM_PREFIXES + PORT_GEMMS)


def is_decode_attention(name: str) -> bool:
    return _bare(name).startswith(DECODE_ATTN)


class Capture:
    """``torch.profiler`` over the device; :meth:`ops` gives what ran, on
    the monotonic clock. :meth:`begin` starts recording at a given time
    from a thread of its own; :meth:`finish` stops it. Stopping gathers
    the results and holds the interpreter for tens of seconds a million
    operations, so the harness stops it once the window has closed and
    every request has been answered: no launch runs beside the stop."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._profile = lambda: profile(activities=[ProfilerActivity.CUDA])
        self._prof = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wall_ns = 0
        self._mono = 0.0
        self.took: Dict[str, float] = {}

    def warm(self, work) -> None:
        """A first trace around ``work()``, in set-up: the first start of
        the profiler in a process, and the first replays under it, are
        slow."""
        t = time.monotonic()
        with self._profile():
            self.took["warm_start"] = time.monotonic() - t
            work()
            t = time.monotonic()
        self.took["warm_stop"] = time.monotonic() - t

    def begin(self, start: float) -> None:
        """Start recording at ``start`` (monotonic) on a thread of its
        own, so the caller goes on offering load; the same thread stops
        it at :meth:`finish` (the profiler's state belongs to the thread
        that started it)."""
        def trace() -> None:
            time.sleep(max(0.0, start - time.monotonic()))
            t = time.monotonic()
            self._prof = self._profile()
            self._prof.__enter__()
            self._mono = time.monotonic()
            self._wall_ns = time.time_ns()
            self.took["start"] = self._mono - t
            self._stop.wait()
            t = time.monotonic()
            self._prof.__exit__(None, None, None)
            self.took["stop"] = time.monotonic() - t

        self._stop.clear()
        self._thread = threading.Thread(target=trace, name="gpubench-trace",
                                        daemon=True)
        self._thread.start()

    def finish(self) -> None:
        """Stop recording and wait until the stop has gathered the
        results."""
        self._stop.set()
        self._thread.join()

    @property
    def started(self) -> float:
        """When the recording began (monotonic seconds)."""
        return self._mono

    def ops(self) -> List[Op]:
        from torch.autograd import DeviceType

        out = []
        shift = self._mono - self._wall_ns / 1e9
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() / 1e9 + shift
            out.append(Op(e.name(), start, start + e.duration_ns() / 1e9))
        out.sort(key=lambda o: o.start)
        return out


def clip(ops: Iterable[Op], start: float, end: float) -> List[Op]:
    """The parts of ``ops`` inside [start, end]."""
    return [Op(o.name, max(o.start, start), min(o.end, end))
            for o in ops if o.end > start and o.start < end]


def busy_intervals(ops: Sequence[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals (``ops`` sorted by start)."""
    merged: List[List[float]] = []
    for o in ops:
        if merged and o.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], o.end)
        else:
            merged.append([o.start, o.end])
    return [(a, b) for a, b in merged]


def busy_s(ops: Sequence[Op]) -> float:
    return sum(b - a for a, b in busy_intervals(ops))


def time_by_name(ops: Iterable[Op]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for o in ops:
        out[o.name] = out.get(o.name, 0.0) + (o.end - o.start)
    return out


def idle_gaps(ops: Sequence[Op], start: float, end: float
              ) -> List[Tuple[float, float]]:
    """The intervals of [start, end] in which no operation ran."""
    gaps, at = [], start
    for a, b in busy_intervals(ops):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if end > at:
        gaps.append((at, end))
    return gaps


def host_activity(spans: Sequence, t: float) -> Optional[str]:
    """The name of the shortest port span open at monotonic second
    ``t`` (spans carry milliseconds), or None."""
    best, best_len = None, float("inf")
    ms = t * 1e3
    for s in spans:
        if s.end_ms is not None and s.start_ms <= ms <= s.end_ms:
            length = s.end_ms - s.start_ms
            if length < best_len:
                best, best_len = s.name, length
    return best
