"""The benchmark's run: set-up, the measured window, the check, the result.

A cell (``cells/<name>.json``) names a configuration
(``configs/<name>.json``) and a traffic mix. The run makes the weights
from the seed on the card, builds the port's serving path on them
(``DeploymentHandle`` -> ``Router`` -> ``LLMReplica`` -> a paged
``DecodeEngine``, warmed: kernels built and programs captured), offers
the traffic through ``DeploymentHandle.remote_stream`` for the window,
waits for every request, and then checks a sample of what was served
against the plain reference (``reference.py``) on the same weights.

Every metric, end to end or per layer, is a reader in
``metrics/<name>.py`` with ``read(window) -> float | None``, found by the
name ``BENCHMARK.json`` gives it.
"""

from __future__ import annotations

import faulthandler
import gc
import importlib.util
import json
import math
import queue
import sys
import threading
import time
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gpubench import costs, devtrace, reference, stats
from gpubench.traffic import Plan, make_plan

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_dynamic_batching_tpu")
DRAIN_S = 60.0          # how long past the close a request may still come
TRACE_S = 6.0           # the device trace: the window's last seconds
WATCHDOG_S = 280.0      # from the window's open to the run's end, at most
HOLD_WAIT_S = 30.0      # for the engine's loop to come round and hold
CHECK_TOKENS = 2048     # served tokens the check samples, at least
CHECK_REQUESTS = 16     # ... from at most this many requests
POOL_EVERY_S = 0.25     # how often the KV pool's occupancy is sampled


def note(line: str) -> None:
    """A progress line on standard error."""
    print(f"gpubench: {line}", file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return load_json(bench_dir / "cells" / f"{name}.json")


def find_config(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def find_reader(metric: str, bench_dir: Path = BENCH_DIR
                ) -> Callable[["Window"], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(spec: Dict, cell: str, section: str) -> List[Dict]:
    """The entries of ``spec[section]`` this cell reports: those that
    list it, and those with no list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in spec[section]:
        listed = m.get("workloads")
        if listed is not None:
            if cell in listed:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out


def forbidden_modules(names: Sequence[str]) -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``ray_dynamic_batching_tpu_torch`` is not
    ``ray_dynamic_batching_tpu``)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


# --- the system under test ---------------------------------------------------
_PORT_LEAF = {"embed": "tok_embed.weight", "pos_embed": "pos_embed.weight",
              "head": "lm_head.weight"}
_PORT_MLP = {"gate": "mlp_gate", "up": "mlp_up", "down": "mlp_down"}


def port_name(name: str) -> str:
    """The port's ``DecoderModule`` parameter of a reference weight."""
    if name in _PORT_LEAF:
        return _PORT_LEAF[name]
    parts = name.split(".")
    if parts[0] == "layers" and parts[2] in _PORT_MLP:
        parts[2] = _PORT_MLP[parts[2]]
    return ".".join(parts)


def port_model(config: Dict, weights: reference.Weights, device):
    """The port's ``CausalLM`` of the configuration, holding the
    benchmark's weight tensors as its parameters (no copy)."""
    from dataclasses import fields

    from ray_dynamic_batching_tpu_torch.models.causal_lm import CausalLM
    from ray_dynamic_batching_tpu_torch.models.decoder import DecoderConfig

    known = {f.name for f in fields(DecoderConfig)}
    cfg = DecoderConfig(**{k: v for k, v in config["decoder"].items()
                           if k in known})
    model = CausalLM(cfg, name=config["name"],
                     dtype=getattr(torch, config["dtype"]), device=device,
                     seed=None)
    module = model.module
    params = dict(module.named_parameters())
    for name, w in weights.items():
        target = port_name(name)
        if target not in params:
            raise KeyError(f"the port has no parameter {target}")
        old = params.pop(target)
        if old.shape != w.shape or old.dtype != w.dtype:
            raise ValueError(f"{target}: the port holds {old.dtype} "
                             f"{tuple(old.shape)}, the weights are "
                             f"{w.dtype} {tuple(w.shape)}")
        owner = module.get_submodule(target.rpartition(".")[0])
        setattr(owner, target.rpartition(".")[2],
                torch.nn.Parameter(w, requires_grad=False))
    if params:
        raise KeyError(f"weights missing for {sorted(params)}")
    eps = model.module.final_norm.eps
    if eps != float(config["decoder"]["norm_eps"]):
        raise ValueError(f"the port's norm eps is {eps}, the configuration "
                         f"states {config['decoder']['norm_eps']}")
    return model


class Served:
    """handle -> router -> replica -> engine, built and warmed."""

    def __init__(self, config: Dict, weights: reference.Weights, device,
                 quantize_weights: bool = False) -> None:
        from ray_dynamic_batching_tpu_torch.serve.controller import (
            DeploymentConfig,
        )
        from ray_dynamic_batching_tpu_torch.serve.handle import (
            DeploymentHandle,
        )
        from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
        from ray_dynamic_batching_tpu_torch.serve.router import Router

        name = config["name"]
        knobs = dict(config["deployment"])
        knobs["quantize_weights"] = quantize_weights
        self.deployment = LLMDeployment(
            name, model=port_model(config, weights, device),
            dtype=getattr(torch, config["dtype"]), device=device,
            warmup=True, **knobs)
        self.replica = self.deployment.make_replica(
            f"{name}#bench",
            DeploymentConfig(name=name, max_ongoing_requests=1 << 20))
        self.engine = self.replica.engine
        self.replica.start()
        self.router = Router(name, replicas=[self.replica],
                             max_assign_timeout_s=30.0)
        self.handle = DeploymentHandle(self.router,
                                       default_slo_ms=3_600_000.0)

    def close(self) -> None:
        self.router.close()
        self.replica.stop(timeout_s=10.0, drain=False)
        self.engine = self.replica = self.router = self.handle = None
        self.deployment = None


class PoolSampler:
    """The share of the engine's KV pool that is allocated, read from the
    port's ``rdb_decode_kv_page_occupancy`` gauge (set after every decode
    turn) every :data:`POOL_EVERY_S` on a thread of its own, as
    (monotonic second, share) pairs."""

    def __init__(self, model_name: str) -> None:
        from ray_dynamic_batching_tpu_torch.engine.decode import (
            KV_PAGE_OCCUPANCY,
        )

        self._read = lambda: KV_PAGE_OCCUPANCY.get(
            tags={"model": model_name})
        self.samples: List[tuple] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample,
                                        name="gpubench-pool", daemon=True)

    def _sample(self) -> None:
        while not self._stop.wait(POOL_EVERY_S):
            self.samples.append((time.monotonic(), self._read()))

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


# --- the window --------------------------------------------------------------
class _Tracker:
    """Counts requests still open; wakes the waiter when none are."""

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.open = 0

    def started(self) -> None:
        with self.cond:
            self.open += 1

    def done(self) -> None:
        with self.cond:
            self.open -= 1
            self.cond.notify_all()

    def wait(self, deadline: float) -> bool:
        with self.cond:
            while self.open > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(left)
            return True


def _send(handle, plan: Plan, i: int, scheduled: float, tracker: _Tracker,
          on_done: Optional[Callable[[], None]] = None) -> stats.Record:
    rec = stats.Record(index=i, prompt_len=len(plan.prompts[i]),
                       max_new=plan.outputs[i], scheduled=scheduled)
    payload = {"tokens": plan.prompts[i].tolist(),
               "max_new_tokens": plan.outputs[i]}
    stamp = rec.token_times.append
    tracker.started()

    def finished(fut) -> None:
        try:
            rec.tokens = list(fut.result().tokens)
        except Exception as e:  # noqa: BLE001 — the request's own failure
            rec.error = f"{type(e).__name__}: {e}"
        tracker.done()
        if on_done is not None:
            on_done()

    rec.sent = time.monotonic()
    try:
        stream, fut = handle.remote_stream(payload)
    except Exception as e:  # noqa: BLE001 — a refused send is a failure
        rec.error = f"{type(e).__name__}: {e}"
        tracker.done()
        if on_done is not None:
            on_done()
        return rec
    stream.subscribe(lambda _chunk: stamp(time.monotonic()),
                     lambda _err: None)
    fut.add_done_callback(finished)
    return rec


def drive(handle, plan: Plan, seconds: float,
          on_open: Optional[Callable[[float], None]] = None,
          on_close: Optional[Callable[[], None]] = None):
    """Offer ``plan`` for ``seconds``; returns (records, start, end,
    finished_in_time). An open loop sends each request at its offset from
    the window's open; a closed loop keeps ``plan.clients`` requests in
    flight from ``plan.ramp_s`` seconds before the window opens until it
    closes. ``on_open(start)`` runs before the first request, with the
    time the window will open, and ``on_close()`` as it closes. Every
    request sent is waited for, up to :data:`DRAIN_S` past the close
    (past ``on_close``'s return)."""
    tracker = _Tracker()
    records: List[stats.Record] = []
    t0 = time.monotonic() + plan.ramp_s
    if on_open is not None:
        on_open(t0)
    t1 = t0 + seconds
    if plan.loop == "open":
        for i, off in enumerate(plan.offsets):
            due = t0 + off
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            records.append(_send(handle, plan, i, due, tracker))
    else:
        free: "queue.Queue[int]" = queue.Queue()
        for c in range(plan.clients):
            free.put(c)
        i = 0
        while True:
            left = t1 - time.monotonic()
            if left <= 0:
                break
            try:
                c = free.get(timeout=left)
            except queue.Empty:
                break
            if time.monotonic() >= t1:
                break
            if i >= len(plan.prompts):
                raise RuntimeError(
                    f"the closed loop used all {i} requests of its pool "
                    "before the window closed: raise the cell's pool")
            records.append(_send(handle, plan, i, time.monotonic(), tracker,
                                 on_done=lambda c=c: free.put(c)))
            i += 1
    now = time.monotonic()
    if now < t1:
        time.sleep(t1 - now)
    if on_close is not None:
        on_close()
    complete = tracker.wait(max(t1, time.monotonic()) + DRAIN_S)
    for r in records:
        if r.tokens is None and r.error is None:
            r.error = f"no answer within {DRAIN_S:.0f} s of the close"
    return records, t0, t1, complete


def stop_while_held(engine, capture: devtrace.Capture) -> None:
    """Stop the device trace with nothing running on the card: the
    engine's loop is held at the top of its next iteration (its
    ``_service_fabric`` call, before any launch), the card finishes what
    was queued, the trace stops, and the loop goes on. Stopping the
    profiler while the loop launches graph replays can hang the process.
    The held seconds fall after the window, where the traced run reads
    nothing."""
    hold, parked = threading.Event(), threading.Event()
    inner = engine._service_fabric

    def gate() -> None:
        if hold.is_set():
            parked.set()
            while hold.is_set():
                time.sleep(0.002)
        inner()

    hold.set()
    engine._service_fabric = gate
    try:
        if not parked.wait(HOLD_WAIT_S):
            raise RuntimeError(f"the engine's loop did not come round "
                               f"within {HOLD_WAIT_S:.0f} s")
        torch.cuda.synchronize()
        capture.finish()
    finally:
        hold.clear()
        del engine._service_fabric


# --- what the readers see ----------------------------------------------------
@dataclass
class Window:
    """One run's window, as the metric readers read it."""

    cell: Dict
    config: Dict
    records: List[stats.Record]
    start: float
    end: float
    setup_s: float
    spans: List[Any] = field(default_factory=list)
    ops: List[devtrace.Op] = field(default_factory=list)
    pool: List[tuple] = field(default_factory=list)  # (second, share)
    trace_start: Optional[float] = None   # the device trace's part
    trace_end: Optional[float] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def shapes(self) -> costs.Shapes:
        return costs.Shapes.of(self.config)

    def in_window(self, t: float) -> bool:
        return self.start <= t <= self.end

    def spans_named(self, name: str) -> List[Any]:
        """The port's spans named ``name`` wholly inside the window."""
        return [s for s in self.spans if s.name == name
                and s.end_ms is not None and self.in_window(s.start_ms / 1e3)
                and self.in_window(s.end_ms / 1e3)]

    def span_ms(self, name: str) -> List[float]:
        """Durations (ms) of :meth:`spans_named`."""
        return [s.end_ms - s.start_ms for s in self.spans_named(name)]

    def turns(self) -> List[Any]:
        return self.spans_named("decode.turn")

    def pool_shares(self) -> List[float]:
        """The KV pool's allocated shares sampled inside the window."""
        return [v for t, v in self.pool if self.in_window(t)]

    def decoded(self):
        """(keys attended, with the head) of every token a decode step
        produced inside the window: the j-th token (j >= 2) of a prompt
        of P attends P + j - 1 keys."""
        for r in self.records:
            if not r.ok:
                continue
            for j, t in enumerate(r.token_times[1:], start=2):
                if self.in_window(t):
                    yield r.prompt_len + j - 1

    def prefilled(self) -> List[int]:
        """Prompt lengths of the requests whose first token (the end of
        their prefill) came inside the window."""
        return [r.prompt_len for r in self.records
                if r.ok and self.in_window(r.token_times[0])]

    def window_ops(self) -> List[devtrace.Op]:
        return devtrace.clip(self.ops, self.start, self.end)

    def traced_part(self) -> Optional["Window"]:
        """The part of the window the device trace covers (the device
        readers' window), or None in a run with no device trace."""
        if self.trace_start is None or not self.ops:
            return None
        return dataclasses.replace(self, start=self.trace_start,
                                   end=self.trace_end)


def read_metrics(window: Window, entries: Sequence[Dict],
                 bench_dir: Path = BENCH_DIR) -> Dict[str, Dict]:
    """Each entry's reader over the window; a reader that finds nothing
    to read returns None, and the metric is left out."""
    out = {}
    for m in entries:
        value = find_reader(m["name"], bench_dir)(window)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(window: Window) -> Dict[str, List]:
    """The ten device operations that took most time, and the ten
    longest idle gaps, each named by the port span open on the host."""
    ops = window.window_ops()
    by_name = sorted(devtrace.time_by_name(ops).items(),
                     key=lambda kv: -kv[1])[:10]
    gaps = sorted(devtrace.idle_gaps(ops, window.start, window.end),
                  key=lambda g: g[0] - g[1])[:10]
    named = [[devtrace.host_activity(window.spans, (a + b) / 2) or "none",
              b - a] for a, b in gaps]
    return {"device_ops": [[n, s] for n, s in by_name], "idle_gaps": named}


# --- the check ---------------------------------------------------------------
def check_sample(records: Sequence[stats.Record], seed: int
                 ) -> List[stats.Record]:
    """A sample of the finished requests, drawn from the seed: the one
    that served most tokens, then others until :data:`CHECK_TOKENS`
    served tokens or :data:`CHECK_REQUESTS` requests."""
    done = [r for r in records if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.max_new, r.prompt_len, -r.index))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 3]).permutation(len(rest))
    sample, served = [longest], longest.max_new
    for k in order:
        if served >= CHECK_TOKENS or len(sample) >= CHECK_REQUESTS:
            break
        sample.append(rest[k])
        served += rest[k].max_new
    return sample


def logit_gaps(weights: reference.Weights, config: Dict, plan: Plan,
               sample: Sequence[stats.Record], device, control: bool = False
               ) -> Dict[str, Dict[str, float]]:
    """The check's readings over the sample's served tokens: the widest
    and the mean gap by which a served token's reference logit lies below
    the reference's best (``program``); with ``control``, the same of the
    token the float8 reference puts first at each position (``control``)."""
    own, low = [], []
    for r in sample:
        prompt = torch.as_tensor(plan.prompts[r.index], device=device)
        served = torch.as_tensor(r.tokens, dtype=torch.int64, device=device)
        g, c = reference.gaps(weights, config["decoder"], prompt, served,
                              control)
        own.append(g)
        if c is not None:
            low.append(c)
    out = {}
    for name, parts in (("program", own), ("control", low)):
        if parts:
            g = torch.cat(parts)
            out[name] = {"max_logit_gap": float(g.max()),
                         "mean_logit_gap": float(g.mean())}
    return out


# --- one run -------------------------------------------------------------------
@dataclass
class Run:
    """What :func:`run` returns: the result line and the numbers beside
    the limits."""

    result: Dict
    checks: Dict[str, Dict[str, float]]


def power_limit_w() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        spec: Dict, process_start: float, device: str = "cuda",
        control: Optional[str] = None, rate_rps: float = 0.0,
        bench_dir: Path = BENCH_DIR) -> Run:
    """Set up, drive the window, check, and build the result line."""
    cell = find_cell(cell_name, bench_dir)
    config = find_config(cell["config"], bench_dir)
    dev = torch.device(device)
    weights = reference.make_weights(config["decoder"], seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    note(f"weights made at {time.monotonic() - process_start:.1f} s")
    served = Served(config, weights, dev,
                    quantize_weights=(control == "int8w"))
    pool = PoolSampler(served.engine.model.name)
    note(f"served path built and warmed at "
         f"{time.monotonic() - process_start:.1f} s")
    capture = devtrace.Capture() if trace and dev.type == "cuda" else None
    if capture is not None:
        capture.warm(lambda: served.handle.remote(
            {"tokens": list(range(1, 200)), "max_new_tokens": 24}
        ).result(timeout=120))
        note(f"profiler warmed at {time.monotonic() - process_start:.1f} s")
    plan = make_plan(cell["traffic"], seconds, seed,
                     int(config["decoder"]["vocab_size"]), rate_rps)
    spans: List[Any] = []
    if trace:
        from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

        tracer().set_exporter(spans.append)
    pool.start()
    if dev.type == "cuda":
        # A run that hangs prints every thread's stack and exits non-zero
        # inside the time a run is allowed.
        faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        records, t0, t1, complete = drive(
            served.handle, plan, seconds,
            on_open=(lambda t: capture.begin(
                t + max(0.0, seconds - TRACE_S)))
            if capture is not None else None,
            on_close=(lambda: stop_while_held(served.engine, capture))
            if capture is not None else None)
    finally:
        pool.stop()
        if trace:
            tracer().reset()
    # Set-up ends as the window opens: a closed loop's ramp is in it.
    setup_s = t0 - process_start
    capture_ops = capture.ops() if capture is not None else []
    if capture is not None:
        note(f"profiler {capture.took}, {len(capture_ops)} device ops, "
             f"at {time.monotonic() - process_start:.1f} s")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    served.close()
    served = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    window = Window(cell=cell, config=config, records=records, start=t0,
                    end=t1, setup_s=setup_s, spans=spans, ops=capture_ops,
                    pool=pool.samples)
    if capture is not None:
        window.trace_start, window.trace_end = capture.started, t1
    section = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(window, metrics_of(spec, cell_name, section),
                           bench_dir)
    note(f"window closed and drained at "
         f"{time.monotonic() - process_start:.1f} s")
    sample = check_sample(records, seed)
    readings = logit_gaps(weights, config, plan, sample, dev,
                          control=(control == "fp8"))
    note(f"checked {len(sample)} requests at "
         f"{time.monotonic() - process_start:.1f} s")
    judged = readings.get("control" if control == "fp8" else "program", {})
    failed = sum(not r.ok for r in records)
    checks = {name: {"value": judged.get(name, math.inf),
                     "limit": float(limit)}
              for name, limit in config["check"].items()
              if limit is not None}
    checks["failed_requests"] = {"value": float(failed), "limit": 0.0}
    correct = (complete and bool(sample)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu")
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": name, "count": 1, "memory_peak_bytes": peak,
        "power_limit_w": power_limit_w() if dev.type == "cuda" else None,
    }
    shares = window.pool_shares()
    if shares:
        # What of the reserved pool (in memory_peak_bytes) holds pages.
        device_info["kv_pool_pct_peak"] = 100.0 * max(shares)
        device_info["kv_pool_pct_mean"] = 100.0 * sum(shares) / len(shares)
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": len(records),
        "failed": failed, "metrics": metrics, "device": device_info,
    }
    part = window.traced_part()
    if part is not None:
        device_info["busy_s"] = devtrace.busy_s(part.window_ops())
        device_info["window_s"] = part.seconds
        result["breakdown"] = breakdown(part)
    late = [r.sent - r.scheduled for r in records]
    third = (t1 - t0) / 3
    result["load"] = {
        "loop": plan.loop, "rate_rps": plan.rate_rps,
        "clients": plan.clients, "ramp_s": plan.ramp_s,
        "sent": len(records),
        "tok_s_by_third": [stats.output_tok_s(records, t0 + k * third,
                                              t0 + (k + 1) * third)
                           for k in range(3)],
        "generator_late_ms_max": 1e3 * max(late) if late else 0.0,
        "sampled_requests": [r.index for r in sample],
        "control": control,
    }
    result["readings"] = readings
    result["checks"] = checks
    if dev.type == "cuda":
        faulthandler.cancel_dump_traceback_later()
    return Run(result=finite(result), checks=finite(checks))


def finite(obj: Any) -> Any:
    """``obj`` with every infinite number (a failed request's latency, a
    check with nothing to read) written as 1e300, which JSON can hold."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj
