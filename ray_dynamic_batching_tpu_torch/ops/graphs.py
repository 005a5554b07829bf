"""Captured device programs: the port's counterpart of ``jax.jit`` with
donation.

The reference runs every hot program as one compiled XLA program; eager
PyTorch dispatches the same work op by op from Python, hundreds of
launches a decode step. A :class:`Program` records its impl once per key
as a CUDA graph and replays it with one launch.

- **The key** is the program's host-static arguments (the positions it
  was created with: a horizon, ``any_sampled``, ...) and the shapes and
  dtypes of its tensor arguments. Any other host value in a graphed
  program's arguments is refused: a graph would bake it in.
- **Inputs** are static device buffers, one set per input signature,
  filled by ``copy_`` before each replay (host tensors are uploaded into
  them, device tensors copied); the output is the graph's own tensor,
  which the next replay of the same key overwrites — fetch it first.
- **State** the impl updates in place (the engine's cache and counts:
  the registry's ``donated``) must keep its address for the engine's
  life, as XLA needs a donated buffer.
- **The first call** of a key runs the impl eagerly (that call's result,
  counted like any other launch) and then captures it on the set's own
  stream into the set's one memory pool, with
  ``capture_error_mode="thread_local"``: colocated engines and a rolling
  successor warm on other threads while an engine serves (captures
  themselves take turns, one in the process at a time). A capture
  that fails raises :class:`CaptureError`, and so does every later
  capture of its set (its pool may be left recording); nothing falls
  back to eager execution.
- **Sealed** (after the owner's warmup), a key first seen raises: it is
  recorded in the capture ledger first, as a steady-state violation.
- **Launch counts**: a kernel wrapper counts through :func:`count_launch`;
  while this thread captures, the launch goes into the capture's record
  instead, and each replay adds the record — the counts stay the
  launches the card ran.

On the CPU, and in a set built inside :func:`disable_capture`, a program
runs its impl eagerly; the first call of each key records the same
ledger episode a capture would (``utils/compile_ledger.py``). A program
created ``eager=True`` (the registry's ``eager_reason``) never captures.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from ray_dynamic_batching_tpu_torch.utils.compile_ledger import get_ledger

_tls = threading.local()
_disabled_lock = threading.Lock()
_disabled = 0     # disable_capture() contexts open, in any thread
# Captures run one at a time in the process: capture streams come from
# PyTorch's per-device stream pool, so two sets may share one.
_capture_lock = threading.Lock()


@contextlib.contextmanager
def _capturing() -> Iterator[None]:
    """The process's one capture at a time, with Python's cycle collector
    off: a collection inside a capture could free another graph (an
    engine's programs form reference cycles), and destroying a graph is
    an operation a capturing thread may not make — it invalidates the
    capture."""
    with _capture_lock:
        enabled = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if enabled:
                gc.enable()


class CaptureError(RuntimeError):
    """A program could not be captured, or a sealed set met a new key."""


@contextlib.contextmanager
def disable_capture() -> Iterator[None]:
    """Engines built while this context is open — on any thread: a
    controller builds replacements on its own — run every program eagerly
    on the card, for their whole life (the counterpart of
    ``jax.disable_jit()``): for holding the graphed path against the
    eager one. The serving path never enters it."""
    global _disabled
    with _disabled_lock:
        _disabled += 1
    try:
        yield
    finally:
        with _disabled_lock:
            _disabled -= 1


def count_launch(namespace: Dict[str, Any], name: str) -> None:
    """One kernel launch: ``namespace[name] += 1`` (a module's counter),
    or, while this thread captures a graph, one launch in the capture's
    record, which every replay of that graph adds."""
    record = getattr(_tls, "record", None)
    if record is None:
        namespace[name] += 1
    else:
        record.append((namespace, name))


class _Graph:
    __slots__ = ("graph", "inputs", "output", "launches")

    def __init__(self, graph, inputs, output, launches) -> None:
        self.graph = graph
        self.inputs = inputs          # {arg position: static buffer}
        self.output = output
        self.launches = launches      # ((namespace, name, n), ...)

    def replay(self, args: Sequence[Any]) -> Any:
        for i, buf in self.inputs.items():
            buf.copy_(args[i])
        self.graph.replay()
        for ns, name, n in self.launches:
            ns[name] += n
        return self.output


class GraphSet:
    """One engine's captured programs: one memory pool and one capture
    stream for all of them, and the captures' totals. Whether the set
    captures is fixed when it is built: on a CUDA device, outside
    :func:`disable_capture`."""

    def __init__(self, device: torch.device) -> None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.capture = device.type == "cuda" and not _disabled
        self.sealed = False
        self.failed: Optional[str] = None   # the capture that failed
        self.captures = 0
        self.capture_s = 0.0
        self.pool_bytes = 0   # device memory reserved while capturing
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._programs: List[Program] = []

    def program(self, name: str, impl: Callable[..., Any],
                static: Sequence[int] = (), eager: bool = False
                ) -> "Program":
        """A program running ``impl``; ``static`` are the positions of its
        host-static arguments (part of the key)."""
        prog = Program(self, name, impl, static, eager)
        self._programs.append(prog)
        return prog

    def seal(self) -> None:
        """Warmup is over: from now on a new key raises."""
        self.sealed = True

    def stats(self) -> Dict[str, Any]:
        return {"captures": self.captures,
                "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes,
                "graphs": {p.name: len(p._graphs) for p in self._programs
                           if p._graphs}}

    def release(self) -> None:
        """Drop every graph, its buffers and the pool (the owner has
        stopped dispatching)."""
        for prog in self._programs:
            prog._graphs.clear()
            prog._inputs.clear()
        self._pool = None
        self._stream = None

    def _capture_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=self.device)
        return self._pool, self._stream


class Program:
    """One hot program of a :class:`GraphSet` (see the module docstring).
    Not thread-safe: an engine dispatches from one thread at a time."""

    def __init__(self, owner: GraphSet, name: str, impl: Callable[..., Any],
                 static: Sequence[int], eager: bool) -> None:
        self.name = name
        self._owner = owner
        self._impl = impl
        self._static = tuple(static)
        self._graphed = owner.capture and not eager
        self._seen: set = set()                  # keys run eagerly
        self._graphs: Dict[tuple, _Graph] = {}
        self._inputs: Dict[tuple, Dict[int, torch.Tensor]] = {}

    def _signature(self, args: Sequence[Any]) -> tuple:
        sig = []
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                sig.append((i, tuple(a.shape), a.dtype))
            elif a is None:
                sig.append((i, None))
            elif self._graphed and i not in self._static:
                raise TypeError(
                    f"{self.name}: argument {i} ({type(a).__name__}) is "
                    "neither a tensor nor host-static; a graph would bake "
                    "it in")
        return tuple(sig)

    def _key(self, args: Sequence[Any]) -> tuple:
        return (tuple(args[i] for i in self._static), self._signature(args))

    def _on_device(self, args: Sequence[Any]) -> List[Any]:
        dev = self._owner.device
        return [a.to(dev) if isinstance(a, torch.Tensor) and a.device != dev
                else a for a in args]

    def __call__(self, *args: Any) -> Any:
        key = self._key(args)
        with torch.inference_mode():
            if not self._graphed:
                if key in self._seen:
                    return self._impl(*self._on_device(args))
                self._seen.add(key)
                t0 = time.perf_counter()
                out = self._impl(*self._on_device(args))
                get_ledger().note_episode(
                    (time.perf_counter() - t0) * 1000.0, 0.0)
                return out
            graph = self._graphs.get(key)
            if graph is not None:
                if torch.cuda.current_device() != self._owner.device.index:
                    raise CaptureError(
                        f"{self.name}: replay on cuda:"
                        f"{torch.cuda.current_device()}, captured on "
                        f"{self._owner.device}")
                return graph.replay(args)
            if self._owner.sealed:
                get_ledger().note_episode(0.0, 0.0)
                raise CaptureError(
                    f"{self.name}: key {key} first seen after warmup; "
                    "nothing was captured for it")
            if self._owner.failed:
                raise CaptureError(
                    f"{self.name}: not captured: an earlier capture of "
                    f"this set failed ({self._owner.failed})")
            return self._capture(key, args)

    def _capture(self, key: tuple, args: Sequence[Any]) -> Any:
        owner, dev = self._owner, self._owner.device
        t0 = time.perf_counter()
        out = self._impl(*self._on_device(args))   # this call's result
        run_ms = (time.perf_counter() - t0) * 1000.0
        sig = key[1]
        inputs = self._inputs.get(sig)
        if inputs is None:
            inputs = self._inputs[sig] = {
                i: torch.empty(a.shape, dtype=a.dtype, device=dev)
                for i, a in enumerate(args) if isinstance(a, torch.Tensor)}
        for i, buf in inputs.items():
            buf.copy_(args[i])
        cap_args = [inputs.get(i, a) for i, a in enumerate(args)]
        pool, stream = owner._capture_pool()
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        reserved = torch.cuda.memory_reserved(dev)
        record: List[tuple] = []
        t1 = time.perf_counter()
        _tls.record = record
        try:
            with _capturing(), torch.cuda.stream(stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    output = self._impl(*cap_args)
                finally:
                    graph.capture_end()
        except Exception as e:  # noqa: BLE001 — re-raised as CaptureError
            # The pool may still be marked as recording: the set captures
            # nothing more.
            owner.failed = f"{self.name} {key}: {e}"
            raise CaptureError(
                f"{self.name}: capture of key {key} failed: {e}") from e
        finally:
            _tls.record = None
        current.wait_stream(stream)
        capture_s = time.perf_counter() - t1
        counted = collections.Counter((id(ns), name) for ns, name in record)
        spaces = {id(ns): ns for ns, _ in record}
        self._graphs[key] = _Graph(
            graph, inputs, output,
            tuple((spaces[i], name, n) for (i, name), n in counted.items()))
        owner.captures += 1
        owner.capture_s += capture_s
        owner.pool_bytes += max(
            0, torch.cuda.memory_reserved(dev) - reserved)
        get_ledger().note_episode(run_ms, capture_s * 1000.0)
        return out
