"""The serve control plane and the declarative entry points, port against
the JAX package.

Host scenarios run on both packages and their outputs are compared, as
``tests/test_torch_serving.py`` does: the controller with callable
factories (deploy and route, scale, heal, salvage, restart budget,
checkpoint and store recovery, failover adoption, redeploy, delete; its
``status()`` and the audit records compared with ids and wall-clock
stamps left out), the replicated store and its lease on a fake clock, the
control fabric's partition specs and seeded edge outcomes, token-bucket
admission and the overload governor on an injected clock, autoscaling,
long poll, placement strategies on fake devices, the observatory's burn
rates on fixed counters, rate forecasts, the audit ring, the KV stores,
the decorator API and the config schema. On llama_tiny in f32 (the same
weights on both sides), controller-deployed stacks of both packages give
identical greedy tokens; the port heals a wedged engine and rolls a
versioned deployment with the reference tests' assertions, releasing
every replaced or retired engine. Every controller is shut down, every
wait has a timeout.
"""

import gc
import json
import threading
import time
import types
import weakref
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine import rates as j_rates
from ray_dynamic_batching_tpu.engine import request as j_request
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.parallel import placement as j_placement
from ray_dynamic_batching_tpu.runtime import kv as j_kv
from ray_dynamic_batching_tpu.scheduler import audit as j_audit
from ray_dynamic_batching_tpu.serve import admission as j_admission
from ray_dynamic_batching_tpu.serve import api as j_api
from ray_dynamic_batching_tpu.serve import autoscaling as j_autoscaling
from ray_dynamic_batching_tpu.serve import controller as j_controller
from ray_dynamic_batching_tpu.serve import fabric as j_fabric
from ray_dynamic_batching_tpu.serve import handle as j_handle
from ray_dynamic_batching_tpu.serve import kv_fabric as j_kv_fabric
from ray_dynamic_batching_tpu.serve import llm as j_llm
from ray_dynamic_batching_tpu.serve import long_poll as j_long_poll
from ray_dynamic_batching_tpu.serve import observatory as j_observatory
from ray_dynamic_batching_tpu.serve import schema as j_schema
from ray_dynamic_batching_tpu.serve import store as j_store
from ray_dynamic_batching_tpu.utils import chaos as j_chaos
from ray_dynamic_batching_tpu_torch.engine import rates as t_rates
from ray_dynamic_batching_tpu_torch.engine import request as t_request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.parallel import placement as t_placement
from ray_dynamic_batching_tpu_torch.runtime import kv as t_kv
from ray_dynamic_batching_tpu_torch.scheduler import audit as t_audit
from ray_dynamic_batching_tpu_torch.serve import admission as t_admission
from ray_dynamic_batching_tpu_torch.serve import api as t_api
from ray_dynamic_batching_tpu_torch.serve import autoscaling as t_autoscaling
from ray_dynamic_batching_tpu_torch.serve import controller as t_controller
from ray_dynamic_batching_tpu_torch.serve import fabric as t_fabric
from ray_dynamic_batching_tpu_torch.serve import handle as t_handle
from ray_dynamic_batching_tpu_torch.serve import kv_fabric as t_kv_fabric
from ray_dynamic_batching_tpu_torch.serve import llm as t_llm
from ray_dynamic_batching_tpu_torch.serve import long_poll as t_long_poll
from ray_dynamic_batching_tpu_torch.serve import observatory as t_observatory
from ray_dynamic_batching_tpu_torch.serve import schema as t_schema
from ray_dynamic_batching_tpu_torch.serve import store as t_store
from ray_dynamic_batching_tpu_torch.utils import chaos as t_chaos

torch.set_num_threads(2)

_MODS = ("rates", "request", "placement", "kv", "audit", "admission", "api",
         "autoscaling", "controller", "fabric", "handle", "kv_fabric", "llm",
         "long_poll", "observatory", "schema", "store", "chaos")
PKGS = {
    name: types.SimpleNamespace(
        name=name, **{m: globals()[f"{name[0]}_{m}"] for m in _MODS})
    for name in ("jax", "torch")
}


@pytest.fixture(autouse=True)
def _no_chaos():
    """No injected faults from the environment in either package."""
    for pkg in PKGS.values():
        pkg.chaos.reset_chaos("")
        pkg.fabric.reset_fabric()
    yield
    for pkg in PKGS.values():
        pkg.chaos.reset_chaos("")
        pkg.fabric.reset_fabric()


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; the outputs must
    agree. Returns the port's."""
    out = {name: scenario(pkg, *args) for name, pkg in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def double_batch(payloads):
    return [p * 2 for p in payloads]


def _audit_view(records):
    """Audit records without their sequence numbers and wall-clock stamps."""
    return [{k: v for k, v in r.items() if k not in ("seq", "wall_time")}
            for r in records]


def _status_view(status):
    """``status()`` with the timing-valued parts left out: the key set,
    the replica set and its counts, versions, breakers, failover and hedge
    accounting, admission, and the audit records."""
    out = {}
    for name, d in status.items():
        out[name] = {
            "keys": sorted(d),
            "target": d["target_replicas"],
            "running": d["running_replicas"],
            "replicas": sorted(d["replicas"]),
            "restarts": d["restarts"],
            "healthy": d["healthy"],
            "versions": d["versions"],
            "target_version": d["target_version"],
            "breakers": d["breakers"],
            "failover": d["failover"],
            "hedge": d["hedge"],
            "admission": d["admission"],
            "audit": _audit_view(d["audit"]),
        }
    return out


def _reconcile(ctl, name):
    with ctl._lock:
        deferred = ctl._reconcile(ctl._deployments[name])
    for action in deferred:
        action()


# --- the controller with callable factories ----------------------------------
def _kill(replica):
    replica._run.clear()  # a dead loop
    replica.queue.wake_waiters()


def _ctl_scenario(pkg, case, tmp_path):
    c, R = pkg.controller, pkg.request.Request
    cfg = c.DeploymentConfig
    out = {}
    if case == "checkpoint_recovery":
        path = str(tmp_path / f"{pkg.name}-gcs.json")
        ctl = c.ServeController(kv=pkg.kv.FileKVStore(path))
        ctl.deploy(cfg(name="doubler", num_replicas=2),
                   factory=lambda: double_batch)
        ctl.shutdown()
        ctl2 = c.ServeController(kv=pkg.kv.FileKVStore(path))
        ctl2.register_factory("doubler", lambda: double_batch)
        try:
            out["recovered"] = ctl2.recover()
            handle = pkg.handle.DeploymentHandle(ctl2.get_router("doubler"))
            out["served"] = handle.remote(5).result(timeout=5)
            out["status"] = _status_view(ctl2.status())
            with open(path) as f:
                out["file"] = json.loads(json.load(f)[c.CHECKPOINT_KEY])
        finally:
            ctl2.shutdown()
        return out
    if case == "store_recovery":
        store = pkg.store.InMemoryStore()
        ctl = c.ServeController(store=store)
        ctl.deploy(cfg(name="doubler", num_replicas=2),
                   factory=lambda: double_batch)
        out["mirror"] = (
            store.get_json("serve:deployments/doubler/config"),
            store.get_json("serve:deployments/doubler/replicas"))
        ctl.crash()
        ctl2 = c.ServeController(store=store)
        ctl2.register_factory("doubler", lambda: double_batch)
        try:
            out["recovered"] = ctl2.recover()
            handle = pkg.handle.DeploymentHandle(ctl2.get_router("doubler"))
            out["served"] = handle.remote(4).result(timeout=5)
            out["status"] = _status_view(ctl2.status())
        finally:
            ctl2.shutdown()
            ctl.shutdown()
        out["drained"] = store.get_json(
            "serve:deployments/doubler/replicas")["ids"]
        return out
    ctl = c.ServeController()
    try:
        router = ctl.deploy(
            cfg(name="doubler", num_replicas=2 if case == "route" else 1,
                max_restarts=2 if case == "restart_budget" else 3,
                max_batch_size=8),
            factory=lambda: double_batch)
        handle = pkg.handle.DeploymentHandle(router)
        if case == "route":
            futs = [handle.remote(i) for i in range(20)]
            out["results"] = [f.result(timeout=5) for f in futs]
        elif case == "scale":
            steps = []
            for n in (3, 1):
                ctl.deploy(cfg(name="doubler", num_replicas=n))
                steps.append(sorted(r.replica_id for r in router.replicas()))
            out["steps"] = steps
        elif case in ("unhealthy", "salvage"):
            victim = router.replicas()[0]
            _kill(victim)
            reqs = [R(model="doubler", payload=i, slo_ms=5000)
                    for i in range(5 if case == "salvage" else 0)]
            out["assigned"] = [victim.assign(r) for r in reqs]
            _reconcile(ctl, "doubler")
            out["salvaged"] = [r.future.result(timeout=5) for r in reqs]
            out["new"] = [r.replica_id for r in router.replicas()]
            out["served"] = handle.remote(21).result(timeout=5)
        elif case == "restart_budget":
            for _ in range(5):
                for r in router.replicas():
                    _kill(r)
                _reconcile(ctl, "doubler")
            out["exhausted"] = _status_view(ctl.status())
            ctl.deploy(cfg(name="doubler", num_replicas=1, max_restarts=2))
        elif case == "redeploy":
            ctl.deploy(cfg(name="doubler", num_replicas=1, max_batch_size=32,
                           max_ongoing_requests=64))
            rep = router.replicas()[0]
            out["knobs"] = (rep.policy.max_batch_size,
                            rep.max_ongoing_requests, rep.queue.max_len)
        elif case == "rollout":
            ctl.deploy(cfg(name="doubler", num_replicas=3, version="v1"))
            ctl.deploy(cfg(name="doubler", num_replicas=3, version="v2",
                           rolling_max_unavailable_fraction=0.34))
            out["mid"] = ctl.status()["doubler"]["versions"]
            for _ in range(3):
                _reconcile(ctl, "doubler")
            out["served"] = handle.remote(8).result(timeout=5)
        elif case == "delete":
            ctl.delete_deployment("doubler")
            out["left"] = ctl.deployments()
            out["audit"] = _audit_view(ctl.audit.to_dicts())
            return out
        out["status"] = _status_view(ctl.status())
    finally:
        ctl.shutdown()
    return out


CTL_CASES = ["route", "scale", "unhealthy", "salvage", "restart_budget",
             "redeploy", "rollout", "delete", "checkpoint_recovery",
             "store_recovery"]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("case", CTL_CASES)
def test_controller_scenarios_match(case, tmp_path):
    out = _both(_ctl_scenario, case, tmp_path)
    if case == "route":
        assert out["results"] == [2 * i for i in range(20)]
        assert out["status"]["doubler"]["running"] == 2
    if case in ("unhealthy", "salvage"):
        st = out["status"]["doubler"]
        assert st["running"] == 1 and st["restarts"] == 1
        assert out["new"] == ["doubler#1"] and out["served"] == 42
        assert out["salvaged"] == [2 * i for i in range(len(out["salvaged"]))]
        assert [a["trigger"] for a in st["audit"]][-1] == "heal"
    if case == "restart_budget":
        st = out["exhausted"]["doubler"]
        assert st["restarts"] == 2 and st["running"] == 0
        assert not st["healthy"]
        assert out["status"]["doubler"]["healthy"]
        assert out["status"]["doubler"]["running"] == 1
    if case == "redeploy":
        assert out["knobs"] == (32, 64, 64)
    if case == "rollout":
        assert out["mid"] == {"v1": 1, "v2": 2}
        assert out["status"]["doubler"]["versions"] == {"v2": 3}
    if case == "delete":
        assert out["left"] == []
        assert [a["trigger"] for a in out["audit"]] == ["deploy", "scale",
                                                         "delete"]
    if case in ("checkpoint_recovery", "store_recovery"):
        assert out["recovered"] == ["doubler"]
        assert out["status"]["doubler"]["running"] == 2


def _autoscale_scenario(pkg):
    gate = threading.Event()

    def slow(payloads):
        gate.wait(2)
        return payloads

    c = pkg.controller
    ctl = c.ServeController(control_interval_s=0.05)
    router = ctl.deploy(
        c.DeploymentConfig(
            name="slow", num_replicas=1, max_batch_size=1,
            autoscaling=pkg.autoscaling.AutoscalingConfig(
                min_replicas=1, max_replicas=4, target_ongoing_requests=2.0,
                upscale_delay_s=0.0, downscale_delay_s=10.0)),
        factory=lambda: slow)
    try:
        futs = [pkg.handle.DeploymentHandle(router).remote(i)
                for i in range(16)]
        ctl.start()
        deadline = time.monotonic() + 5
        while (ctl.status()["slow"]["running_replicas"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        scaled = ctl.status()["slow"]["running_replicas"] >= 2
        gate.set()
        results = [f.result(timeout=10) for f in futs]
    finally:
        gate.set()
        ctl.shutdown()
    return scaled, results


@pytest.mark.timeout(60)
def test_autoscaler_scales_up_under_load_alike():
    scaled, results = _both(_autoscale_scenario)
    assert scaled and results == list(range(16))


def _failover_scenario(pkg):
    """A standby adopts the live data plane of a crashed leader and the
    deposed leader's write is fenced (``tests/test_store.py``)."""
    s, c = pkg.store, pkg.controller
    log = s.StoreLog()
    lease = s.LeaderLease(duration_s=0.5)
    catalog = s.ReplicaCatalog()
    store_a = s.ReplicatedStore(log, lease, "ctl-A")
    epochs = [store_a.acquire_leadership()]
    ctl_a = c.ServeController(control_interval_s=0.05, store=store_a,
                              catalog=catalog)
    ctl_b = None
    try:
        router = ctl_a.deploy(
            c.DeploymentConfig(name="doubler", num_replicas=2,
                               max_restarts=4),
            factory=lambda: double_batch)
        handle = pkg.handle.DeploymentHandle(router)
        served = [handle.remote(3).result(timeout=5)]
        old = {r.replica_id: r for r in router.replicas()}
        ctl_a.crash()
        lease.revoke()
        store_b = s.ReplicatedStore(log, lease, "ctl-B")
        ctl_b = c.ServeController(control_interval_s=0.05, store=store_b,
                                  catalog=catalog)
        ctl_b.register_factory("doubler", lambda: double_batch)
        epochs.append(store_b.acquire_leadership())
        recovered = ctl_b.recover()
        adopted = (ctl_b.get_router("doubler") is router and all(
            r is old[r.replica_id] for r in router.replicas()))
        served.append(handle.remote(7).result(timeout=5))
        adopts = [a["observed"] for a in ctl_b.audit.to_dicts()
                  if a["trigger"] == "failover_adopt"]
        try:
            with ctl_a.store.txn() as t:
                t.put("serve:heartbeat", '{"owner": "ctl-A"}')
            fenced = False
        except s.StaleEpochError:
            fenced = True
        return (epochs, recovered, adopted, served, adopts, fenced,
                log.rejected_appends, sorted(old),
                ctl_b._deployments["doubler"].next_replica_ordinal)
    finally:
        if ctl_b is not None:
            ctl_b.shutdown()
        ctl_a.shutdown()


@pytest.mark.timeout(60)
def test_standby_adopts_the_data_plane_alike():
    (epochs, recovered, adopted, served, adopts, fenced, rejected, ids,
     ordinal) = _both(_failover_scenario)
    assert epochs == [1, 2] and recovered == ["doubler"] and adopted
    assert served == [6, 14] and adopts == [{"epoch": 2}]
    assert fenced and rejected >= 1
    assert ids == ["doubler#0", "doubler#1"] and ordinal == 2


# --- the replicated store on a fake clock ------------------------------------
def _store_scenario(pkg):
    s = pkg.store
    trace = []
    st = s.InMemoryStore()
    with st.txn() as t:
        t.put("a", "1")
        t.put("b", "2")
        trace.append(("staged", st.get("a"), t.get("a")))
    trace.append(("committed", st.get("a"), st.get("b"), st.version))
    with st.txn() as t:
        t.put("a", "1")
    trace.append(("elided", st.version))
    try:
        with st.txn() as t:
            t.put("k", "v")
            raise RuntimeError("half-done reconcile")
    except RuntimeError:
        pass
    trace.append(("discarded", st.get("k"), st.version))
    with st.txn() as t:
        t.put_json("j", {"b": 1, "a": 2})
    with st.txn() as t:
        t.put_json("j", {"a": 2, "b": 1})
    trace.append(("canonical", st.get("j"), st.version))

    clock = FakeClock()
    lease = s.LeaderLease(duration_s=5.0, clock=clock)
    trace.append(("lease", lease.acquire("A"), lease.acquire("B"),
                  lease.acquire("A")))
    clock.advance(6.0)
    trace.append(("takeover", lease.acquire("B"), lease.renew("A")))

    log = s.StoreLog()
    log.append(1, [("put", "k", "v")])
    log.fence_to(2)
    try:
        log.append(1, [("put", "k", "w")])
    except s.StaleEpochError as e:
        trace.append(("fenced", e.epoch, e.fence, log.rejected_appends))
    trace.append(("append", log.append(2, [("put", "k", "w")])))

    clock = FakeClock()
    log = s.StoreLog(clock=clock)
    lease = s.LeaderLease(duration_s=2.0, clock=clock)
    a = s.ReplicatedStore(log, lease, "A")
    b = s.ReplicatedStore(log, lease, "B")
    trace.append(("leader", a.acquire_leadership()))
    with a.txn() as t:
        t.put("cfg", "v1")
    trace.append(("replay", b.get("cfg"), b.catch_up(), b.get("cfg")))
    clock.advance(3.0)
    trace.append(("standby", b.acquire_leadership()))
    try:
        with a.txn() as t:
            t.put("cfg", "v2-from-the-dead")
        trace.append(("dead write applied",))
    except s.StaleEpochError:
        trace.append(("dead write fenced", b.get("cfg")))
    with b.txn() as t:
        t.put("cfg", "v2")
    trace.append(("new leader", b.get("cfg"), a.renew(), a.is_leader()))
    return trace


def test_store_txn_lease_and_fencing_match():
    trace = dict((t[0], t[1:]) for t in _both(_store_scenario))
    assert trace["committed"] == ("1", "2", 1) and trace["elided"] == (1,)
    assert trace["lease"] == (1, None, 1) and trace["takeover"] == (2, False)
    assert trace["fenced"] == (1, 2, 1)
    assert trace["dead write fenced"] == ("v1",)
    assert trace["new leader"] == ("v2", False, False)


# --- the control fabric --------------------------------------------------------
def _partition_specs(pkg):
    parse = pkg.fabric.parse_partition_spec
    out = []
    for spec in ("ctl-A+fd-0|log+lease@t=10:heal=5", "a|b@t=1",
                 "a|b@t=1:heal=2;c|d@t=5", ""):
        out.append([(sorted(p.a), sorted(p.b), p.at_s, p.heal_s,
                     [p.open_at(t) for t in (0.5, 1.0, 9.9, 10.0, 14.9,
                                             15.0, 1e9)])
                    for p in parse(spec)])
    for bad in ("a|b", "a@t=1", "|b@t=1", "a|a@t=1", "a|b@heal=2",
                "a|b@t=1:mend=2"):
        try:
            parse(bad)
            out.append((bad, "accepted"))
        except ValueError:
            out.append((bad, "ValueError"))
    table = pkg.fabric.parse_fabric_spec(
        "e1=-1:drop,e2=3:dup:p0.5,e3=-1:delay5-20")
    out.append({e: (n, p, f.mode, f.delay_ms) for e, (n, p, f)
                in sorted(table.items())})
    for bad in ("e1", "e1=-1", "e1=-1:warp9", "e1=-1:delay20-5",
                "e1=-1:drop:q0.5"):
        try:
            pkg.fabric.parse_fabric_spec(bad)
            out.append((bad, "accepted"))
        except ValueError:
            out.append((bad, "ValueError"))
    return out


def test_partition_and_edge_specs_parse_alike():
    out = _both(_partition_specs)
    assert out[0][0][:4] == (["ctl-A", "fd-0"], ["lease", "log"], 10.0, 5.0)
    assert all(v == "ValueError" for _bad, v in out[4:10])


def _edge_outcomes(pkg, seed):
    f = pkg.fabric
    trace = []
    fab = f.ControlFabric(partition_spec="", edge_spec="", seed=seed)
    seen = []
    trace.append(("passthrough", fab.active,
                  fab.call("store.append", lambda x: x + 1, 41),
                  fab.cast("controller.push", seen.append, "v"), seen,
                  fab.stats()))
    fab = f.ControlFabric(partition_spec="", edge_spec="e=2:drop", seed=seed)
    got = []
    for _ in range(3):
        try:
            got.append(fab.call("e", lambda: 1))
        except f.FabricUnreachable as e:
            got.append((e.edge, e.src, e.dst))
    trace.append(("drop", got, fab.stats(), fab.call("other", lambda: 2)))
    fab = f.ControlFabric(partition_spec="", edge_spec="e=-1:dup", seed=seed)
    seen = []
    fab.cast("e", seen.append, "m")
    trace.append(("dup", seen, fab.stats()))
    delays = []
    fab = f.ControlFabric(
        scheduler=lambda ms, fn: delays.append((ms, fn)),
        partition_spec="", edge_spec="e=-1:delay5-20:p0.7", seed=seed)
    seen = []
    for i in range(12):
        fab.cast("e", seen.append, i)
    inline = list(seen)
    for _ms, fn in delays:
        fn()
    trace.append(("delay", [ms for ms, _fn in delays], inline, seen,
                  fab.stats()))
    clock = FakeClock()
    fab = f.ControlFabric(clock=clock, seed=seed,
                          partition_spec="routers|controller@t=5:heal=5",
                          edge_spec="")
    fab.assign("fd-0", "routers")
    fab.assign("ctl-A", "controller")
    windows = []
    for _ in range(4):
        try:
            windows.append(fab.call("e", lambda: 1, src="fd-0", dst="ctl-A"))
        except f.FabricUnreachable as e:
            windows.append(("unreachable", e.edge))
        windows.append(fab.partition_active())
        clock.advance(2.5)
    trace.append(("partition", windows, fab.stats()))
    return trace


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_seeded_edge_outcomes_match(seed):
    trace = dict((t[0], t[1:]) for t in _both(_edge_outcomes, seed))
    assert trace["drop"][0][2] == 1 and trace["dup"][0] == ["m", "m"]
    assert all(5.0 <= ms <= 20.0 for ms in trace["delay"][0])
    assert sorted(trace["delay"][2]) == list(range(12))
    assert ("unreachable", "e") in trace["partition"][0]


# --- admission --------------------------------------------------------------
def _admission_scenario(pkg):
    a = pkg.admission
    trace = []
    t = [0.0]
    b = a.TokenBucket(rate_rps=10.0, burst=2.0, clock=lambda: t[0])
    trace.append([b.try_acquire() for _ in range(3)])
    t[0] += 0.1
    trace.append([b.try_acquire()[0] for _ in range(2)])
    trace.append(a.AdmissionController().admit("anything"))
    ctl = a.AdmissionController(clock=lambda: t[0])
    ctl.configure("d", a.AdmissionPolicy(rate_rps=5.0, burst=1.0))
    ctl.admit_or_raise("d")
    try:
        ctl.admit_or_raise("d")
    except a.AdmissionRejected as e:
        trace.append(("rejected", round(e.retry_after_s, 9)))
    ctl = a.AdmissionController(clock=lambda: t[0])
    audit = pkg.audit.AuditLog("test", now=lambda: t[0])
    ctl.audit = audit
    ctl.configure("g", a.AdmissionPolicy(
        rate_rps=100.0, burst=1.0,
        degraded_class_fractions={"best_effort": 0.1},
        depth_high=0.5, depth_low=0.1))
    steps = [ctl.observe("g", 0.05, 1.0), ctl.observe("g", 0.6, 1.0),
             ctl.degraded("g"), ctl.admit("g", qos_class="best_effort"),
             ctl.admit("g", qos_class="best_effort"),
             ctl.admit("g", qos_class="interactive"),
             ctl.observe("g", 0.0, 1.0), ctl.degraded("g"),
             ctl.observe("g", 0.0, 1.0), ctl.degraded("g")]
    trace.append(("governor", steps, _audit_view(audit.to_dicts()),
                  ctl.snapshot("g")))
    ctl = a.AdmissionController(clock=lambda: t[0])
    ctl.configure("d", a.AdmissionPolicy(rate_rps=1.0, burst=2.0,
                                         max_tenants=2))
    rot = [ctl.admit("d", tenant=x)[0] for x in ("a", "b")]
    rot.append(sum(1 for i in range(40)
                   if ctl.admit("d", tenant=f"rot-{i}")[0]))
    trace.append(("rotation", rot, ctl.snapshot("d")))
    try:
        a.AdmissionPolicy(rate_rps=1.0, depth_high=0.1, depth_low=0.5)
        trace.append(("hysteresis", "accepted"))
    except ValueError:
        trace.append(("hysteresis", "ValueError"))
    return trace


def test_admission_decisions_and_governor_match():
    trace = _both(_admission_scenario)
    assert trace[0][:2] == [(True, 0.0), (True, 0.0)]
    assert not trace[0][2][0] and trace[0][2][1] == pytest.approx(0.1)
    assert trace[1] == [True, False]
    assert trace[3] == ("rejected", 0.2)
    steps = trace[4][1]
    assert steps[:3] == [None, "degrade", True]
    assert steps[6:] == [None, True, "recover", False]
    assert trace[5][1] == [True, True, 2]


# --- autoscaling and long poll -------------------------------------------------
def _autoscaling_scenario(pkg):
    A = pkg.autoscaling
    policy = A.AutoscalingPolicy(A.AutoscalingConfig(
        min_replicas=1, max_replicas=10, target_ongoing_requests=2.0))
    desired = [policy.desired_replicas(ongoing, cur)
               for ongoing in (0.0, 1.0, 8.0, 20.0, 100.0)
               for cur in (1, 2, 4, 5)]
    policy = A.AutoscalingPolicy(
        A.AutoscalingConfig(min_replicas=1, max_replicas=10,
                            target_ongoing_requests=1.0, upscale_delay_s=0.0,
                            downscale_delay_s=2.0),
        interval_s=1.0)
    steps = [policy.step(ongoing, cur) for ongoing, cur in
             ((10.0, 1), (0.0, 4), (0.0, 4), (0.0, 4), (3.0, 3), (0.0, 2))]
    return desired, steps


def test_autoscaling_decisions_match():
    desired, steps = _both(_autoscaling_scenario)
    assert desired[8:12] == [4, 4, 4, 5]
    assert steps[:4] == [10, None, None, 2]


def _long_poll_scenario(pkg):
    lp = pkg.long_poll
    host = lp.LongPollHost()
    sid = host.notify_changed("k", "v1")
    immediate = host.listen_for_change({"k": sid - 1}, timeout_s=1)
    result = {}
    listener = threading.Thread(target=lambda: result.update(
        host.listen_for_change({"k": sid}, timeout_s=5)))
    listener.start()
    time.sleep(0.05)
    host.notify_changed("k", "v2")
    listener.join(timeout=5)
    seen = []
    client = lp.LongPollClient(host, {"cfg": seen.append},
                               poll_timeout_s=0.1)
    try:
        host.notify_changed("cfg", 1)
        host.notify_changed("cfg", 2)
        deadline = time.monotonic() + 2
        while (not seen or seen[-1] != 2) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        client.stop()
    return immediate["k"][1], result["k"][1], seen[-1]


@pytest.mark.timeout(30)
def test_long_poll_alike():
    assert _both(_long_poll_scenario) == ("v1", "v2", 2)


# --- placement ----------------------------------------------------------------
class FakeDevice:
    """The attributes placement reads (``tests/test_placement.py``)."""

    platform = "fake"

    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index

    def __repr__(self):
        return f"FakeDevice({self.id})"


def _cluster(nodes, chips_per_node):
    return [FakeDevice(n * chips_per_node + c, n)
            for n in range(nodes) for c in range(chips_per_node)]


def _placement_scenario(pkg, topology, requests):
    P = pkg.placement
    mgr = P.PlacementManager(_cluster(*topology))
    out = []
    groups = []
    for bundles, strategy in requests:
        try:
            pg = mgr.create([P.Bundle(b) for b in bundles], strategy)
            groups.append(pg)
            out.append([[d.id for d in a] for a in pg.assignments])
        except P.PlacementError as e:
            out.append(("PlacementError", str(e)))
        except ValueError:
            out.append("ValueError")
        out.append(mgr.free_chips())
    out.append(mgr.resource_view())
    for pg in groups:
        mgr.remove(pg)
        mgr.remove(pg)
    out.append(mgr.free_chips())
    pg, mesh = P.pin_slice(mgr, "1x1")
    out.append((pg.total_chips, mesh))
    try:
        P.pin_slice(mgr, "huge")
    except ValueError as e:
        out.append(str(e))
    return out


PLACEMENTS = {
    "strict_pack": ((2, 4), [([2, 2], "STRICT_PACK"), ([3, 3], "STRICT_PACK")]),
    "strict_spread": ((3, 2), [([1, 1, 2], "STRICT_SPREAD"),
                               ([1, 1, 1, 1], "STRICT_SPREAD")]),
    "pack": ((2, 4), [([3], "PACK"), ([1], "PACK"), ([4], "PACK"),
                      ([1], "PACK")]),
    "spread": ((2, 4), [([1, 1], "SPREAD"), ([2], "SPREAD")]),
    "invalid": ((1, 2), [([1], "DIAGONAL"), ([], "PACK"), ([0], "PACK")]),
    "atomic": ((2, 2), [([2, 2, 2], "STRICT_SPREAD"), ([4], "PACK")]),
}


@pytest.mark.parametrize("case", sorted(PLACEMENTS))
def test_placement_strategies_match(case):
    out = _both(_placement_scenario, *PLACEMENTS[case])
    assert out[-2] == (1, None)


def test_placement_defaults_to_the_visible_cuda_devices():
    """The port's default device list is the visible CUDA cards (none
    here); a multi-chip slice raises before anything is reserved."""
    P = t_placement
    if not torch.cuda.is_available():
        assert P.cuda_devices() == [] and P.PlacementManager().nodes() == {}
    dev = P.CudaDevice(id=0, hbm_bytes=80 * 2**30)
    assert dev.torch_device == torch.device("cuda", 0)
    mgr = P.PlacementManager([dev])
    view = mgr.resource_view()
    assert view["nodes"]["0"]["hbm_bytes_total"] == 80 * 2**30
    assert view["nodes"]["0"]["platform"] == "gpu"
    with pytest.raises(NotImplementedError, match="item 8"):
        P.pin_slice(mgr, "1x4")
    assert mgr.free_chips() == {0: 1}


# --- observatory, rates and the audit ring ------------------------------------
def _counters(completed=0, stale=0, dropped=0, violations=0):
    return {"completed": float(completed), "stale": float(stale),
            "dropped": float(dropped), "violations": float(violations)}


def _burn_scenario(pkg, trajectory):
    o = pkg.observatory
    clk = FakeClock()
    policy = o.ObservatoryPolicy(
        slo_target=0.99, fast_window_s=10.0, slow_window_s=30.0,
        epochs_per_window=5, warn_burn=2.0, page_burn=10.0, min_accounted=10,
        warn_after=1, page_after=1, resolve_after=2, resolved_hold_ticks=2)
    mon = o.BurnRateMonitor("test", policy, clock=clk)
    fired = []
    for misses, accounted in trajectory:
        clk.advance(1.0)
        fired += mon.tick({"dep": {"standard": _counters(
            completed=accounted, violations=misses)}})
    w = o.BurnWindow(10.0, 5, clk)
    w.observe(0.0, 0.0)
    burns = [w.burn(m, 100.0, budget=0.01, min_accounted=10)
             for m in range(0, 50, 5)]
    return ([f"{t['from']}->{t['to']}" for t in mon.transitions],
            mon.states(), burns,
            o.budget_counters(_counters(completed=90, stale=3, dropped=2,
                                        violations=5)))


def _trajectories():
    hard = [(i * 50.0, i * 100.0) for i in range(1, 5)]
    hard += [(200.0, 400.0 + i * 100.0) for i in range(1, 16)]
    burst, misses, acc = [], 0.0, 0.0
    for i in range(40):
        misses += 30.0 if i in (10, 11) else 0.0
        acc += 100.0
        burst.append((misses, acc))
    return {"incident": hard, "burst": burst}


@pytest.mark.parametrize("case", sorted(_trajectories()))
def test_burn_rate_alerts_match(case):
    seq, states, burns, budget = _both(_burn_scenario,
                                       _trajectories()[case])
    assert states == {"dep": {"standard": "ok"}}
    assert seq == (["ok->warning", "warning->page", "page->resolved",
                    "resolved->ok"] if case == "incident"
                   else ["ok->warning", "warning->ok"])
    assert burns == sorted(burns) and budget == (10.0, 95.0)


def _forecast_scenario(pkg):
    clk = FakeClock(10.0)
    rates = pkg.rates.RateRegistry(window_s=60.0, clock=clk)
    scorer = pkg.observatory.ForecastScorer(
        pkg.observatory.ObservatoryPolicy(forecast_horizon_s=3.0,
                                          forecast_min_span_s=3.0),
        clock=clk)
    forecasts = []
    for i in range(14):
        rates.record("m", 10 + (i % 3))
        scorer.tick(rates)
        forecasts.append(rates.tracker("m").forecast_rps(
            5.0, min_span_s=3.0))
        clk.advance(1.0)
    return [repr(f) for f in forecasts], scorer.snapshot()


def test_rate_forecasts_and_scoring_match():
    forecasts, snap = _both(_forecast_scenario)
    assert forecasts[0] == "None" and forecasts[-1] != "None"
    assert snap["m"]["refused"] > 0 and snap["m"]["scored"] > 0


def _live_hops(pkg, wait_ms, step_ms, n=50):
    hops = {}
    for hop, ms in (("queue.wait", wait_ms), ("engine.step", step_ms)):
        sk = pkg.observatory.QuantileSketch()
        sk.observe(ms, n=n)
        hops[hop] = sk
    return {"m": hops}


def _fidelity_last(mon):
    """The replay's report with its clock stamp left out."""
    last = dict(mon.snapshot()["last"])
    last.pop("at")
    return last


def _guilty_hop_scenario(pkg):
    o = pkg.observatory
    mon = o.FidelityMonitor(
        "test", o.ObservatoryPolicy(replay_every_ticks=1, drift_min_count=5),
        clock=FakeClock(), price=lambda model: {"engine.step": 10.0})
    mon.note_arrivals("m", 50)
    mon.tick(_live_hops(pkg, wait_ms=200.0, step_ms=30.0))
    return _fidelity_last(mon)


def test_fidelity_names_the_guilty_hop_as_the_reference_does():
    """Twin of ``tests/test_observatory.py::TestFidelityDrift``: the
    engine runs 3x its price and is named; the slow but unpriced
    queue.wait stays ungraded with its reason. Both packages give the
    same report."""
    report = _both(_guilty_hop_scenario)["models"]["m"]
    assert report["drifting_hops"] == ["engine.step"]
    assert report["ungraded"]["queue.wait"]["reason"] == "not-priced"
    assert report["hops"]["engine.step"]["ok"] is False


def _price_at_arrival_scenario(pkg):
    o = pkg.observatory
    price = {"engine.step": 10.0}
    mon = o.FidelityMonitor(
        "test", o.ObservatoryPolicy(replay_every_ticks=1, drift_min_count=5),
        clock=FakeClock(), price=lambda model: dict(price))
    mon.note_arrivals("m", 50)
    price["engine.step"] = 2.0  # the replan
    mon.note_arrivals("m", 50)
    live = o.QuantileSketch()
    live.observe(10.0, n=50)
    live.observe(2.0, n=50)
    mon.tick({"m": {"engine.step": live}})
    return _fidelity_last(mon)


def test_fidelity_prices_each_arrival_as_it_came():
    report = _both(_price_at_arrival_scenario)["models"]["m"]
    assert report["drifting_hops"] == []
    assert report["hops"]["engine.step"]["ok"] is True


def _unpriced_scenario(pkg):
    o = pkg.observatory
    mon = o.FidelityMonitor("test", o.ObservatoryPolicy(replay_every_ticks=1),
                            clock=FakeClock(), price=None)
    mon.note_arrivals("m", 20)
    mon.tick(_live_hops(pkg, wait_ms=5.0, step_ms=20.0))
    return _fidelity_last(mon)


def test_fidelity_unpriced_model_is_ungraded_never_silent():
    report = _both(_unpriced_scenario)["models"]["m"]
    assert report["drifting_hops"] == []
    assert report["ungraded_reason"] == "unpriced: no cost model"
    assert all(e["reason"] == "not-priced"
               for e in report["ungraded"].values())


def _cadence_scenario(pkg):
    o = pkg.observatory
    mon = o.FidelityMonitor("test", o.ObservatoryPolicy(replay_every_ticks=4),
                            clock=FakeClock(),
                            price=lambda model: {"engine.step": 5.0})
    mon.note_arrivals("m", 20)
    for _ in range(12):
        mon.tick(_live_hops(pkg, wait_ms=1.0, step_ms=5.0))
    return mon.replays, _fidelity_last(mon)


def test_fidelity_replay_cadence():
    replays, last = _both(_cadence_scenario)
    assert replays == 3
    assert last["models"]["m"]["hops"]["engine.step"]["ok"] is True


def _audit_scenario(pkg):
    clk = FakeClock(100.0)
    log = pkg.audit.AuditLog("serve", capacity=3, now=clk)
    for i in range(5):
        clk.advance(1.0)
        log.record("scale", key=f"d{i % 2}", before={"replicas": i},
                   after={"replicas": i + 1}, diff={"delta": 1})
    return log.to_dicts(), log.to_dicts(key="d0", last=1), len(log)


def test_audit_ring_matches():
    everything, last, n = _both(_audit_scenario)
    assert n == 3 and [r["seq"] for r in everything] == [3, 4, 5]
    assert last[0]["wall_time"] == 105.0


def _kv_scenario(pkg, tmp_path):
    kv = pkg.kv.KVStore()
    kv.put("a:1", "x")
    kv.put("a:2", "y")
    kv.put("b:1", "z")
    out = [kv.get("a:1"), kv.keys("a:"), kv.delete("a:1"), kv.delete("a:1"),
           kv.keys()]
    path = str(tmp_path / f"{pkg.name}-kv.json")
    f = pkg.kv.FileKVStore(path)
    f.put("k", "v")
    f.put("j", "w")
    f.delete("j")
    with open(path) as fh:
        out.append((pkg.kv.FileKVStore(path).keys(), json.load(fh)))
    return out


def test_kv_stores_match(tmp_path):
    out = _both(_kv_scenario, tmp_path)
    assert out[:4] == ["x", ["a:1", "a:2"], True, False]
    assert out[-1] == (["k"], {"k": "v"})
    with pytest.raises(NotImplementedError, match="item 10"):
        t_kv.NativeKVStore()


def test_kv_fabric_is_inert_for_the_ports_llm_replica():
    """No port replica exposes live streams yet: the courier moves
    nothing and says so."""
    class Replica:
        replica_id = "r0"

        def queue_len(self):
            return 2

    fabric = t_kv_fabric.KVPageFabric()
    stats = fabric.drain_streams(Replica(), [Replica()], timeout_s=0.1)
    assert stats["requested"] == 0


# --- the decorator API and the module controller ------------------------------
def _api_scenario(pkg, case):
    serve = pkg.api
    ctl = pkg.controller.ServeController(control_interval_s=0.1)
    ctl.start()
    try:
        if case == "function":
            @serve.deployment
            def double(x):
                return x * 2

            return serve.run(double.bind(), controller=ctl).remote(21).result(
                timeout=10)
        if case == "class":
            @serve.deployment(name="scaler", num_replicas=2)
            class Scaler:
                def __init__(self, factor):
                    self.factor = factor

                def __call__(self, x):
                    return x * self.factor

            handle = serve.run(Scaler.bind(3), controller=ctl)
            futs = [handle.remote(i) for i in range(10)]
            return ([f.result(timeout=10) for f in futs],
                    ctl.status()["scaler"]["running_replicas"])
        if case == "batch":
            sizes = []

            @serve.deployment(name="batched")
            class Summer:
                @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
                def __call__(self, xs):
                    sizes.append(len(xs))
                    return [x + 1 for x in xs]

            handle = serve.run(Summer.options(max_ongoing_requests=64).bind(),
                               controller=ctl)
            futs = [handle.remote(i) for i in range(8)]
            cfg = ctl._deployments["batched"].config
            return ([f.result(timeout=10) for f in futs], max(sizes) <= 4,
                    cfg.max_batch_size, cfg.batch_wait_timeout_s)
        if case == "options":
            @serve.deployment(num_replicas=1)
            def f(x):
                return x

            g = f.options(num_replicas=3, max_ongoing_requests=7)
            errors = []
            for bad in (lambda: f.options(nonsense=1),
                        lambda: serve.run(f, controller=ctl)):
                try:
                    bad()
                except TypeError:
                    errors.append("TypeError")
            return (g._config.num_replicas, g._config.max_ongoing_requests,
                    f._config.num_replicas, errors)
        if case == "generator":
            @serve.deployment(name="gen")
            class Chunker:
                @serve.batch(max_batch_size=4)
                def __call__(self, xs):
                    half = (len(xs) + 1) // 2
                    yield [("a", x) for x in xs[:half]] + [None] * (
                        len(xs) - half)
                    yield [None] * half + [("b", x) for x in xs[half:]]

            @serve.deployment(name="badgen")
            def stream(x):
                yield x

            out = serve.run(Chunker.bind(), controller=ctl).remote(5).result(
                timeout=10)
            try:
                serve.run(stream.bind(), controller=ctl)
                return out, "accepted"
            except TypeError as e:
                return out, "@serve.batch" in str(e)
        if case == "user_config":
            seen = []

            @serve.deployment(name="cfgd", user_config={"scale": 2})
            class Scaled:
                def __init__(self):
                    self.scale = 1

                def reconfigure(self, cfg):
                    seen.append(dict(cfg))
                    self.scale = cfg.get("scale", self.scale)

                def __call__(self, x):
                    return x * self.scale

            handle = serve.run(Scaled.bind(), controller=ctl)
            out = [handle.remote(10).result(timeout=10)]
            for opts in ({"user_config": {"scale": 5}},
                         {"user_config": {"scale": 5},
                          "max_ongoing_requests": 64},
                         {"user_config": {}}):
                serve.run(Scaled.options(**opts).bind(), controller=ctl)
                out.append(handle.remote(10).result(timeout=10))
            return out, seen
        if case == "multiplexed":
            @serve.deployment(name="mux", num_replicas=2)
            class Mux:
                @serve.multiplexed(max_num_models_per_replica=2)
                def get_model(self, model_id):
                    return lambda x: (model_id, x * 2)

                def __call__(self, payload):
                    return self.get_model(payload["model"])(payload["x"])

            handle = serve.run(Mux.bind(), controller=ctl)
            futs = [handle.remote({"model": "m1", "x": i},
                                  multiplexed_model_id="m1")
                    for i in range(6)]
            return ([f.result(timeout=10) for f in futs],
                    any("m1" in r.loaded_models
                        for r in ctl.get_router("mux").replicas()),
                    ctl._deployments["mux"].config.max_multiplexed_models)
    finally:
        ctl.shutdown()


API_CASES = ["function", "class", "batch", "options", "generator",
             "user_config", "multiplexed"]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("case", API_CASES)
def test_decorator_api_matches(case):
    out = _both(_api_scenario, case)
    if case == "user_config":
        assert out[0] == [20, 50, 50, 50]
        assert out[1] == [{"scale": 2}, {"scale": 5}, {}]
    if case == "batch":
        assert out == (list(range(1, 9)), True, 4, 0.05)


def _multiplexed_lru(pkg):
    serve = pkg.api
    loads, releases = [], []

    class Host:
        @serve.multiplexed(max_num_models_per_replica=2,
                           unload=lambda m: releases.append(m))
        def get_model(self, model_id):
            loads.append(model_id)
            return f"model:{model_id}"

    h = Host()
    got = [h.get_model(m) for m in ("a", "b", "a", "c", "b")]
    return got, loads, releases, h.get_model.loaded_model_ids()


def test_multiplexed_lru_matches():
    got, loads, releases, resident = _both(_multiplexed_lru)
    assert loads == ["a", "b", "c", "b"]
    assert releases == ["model:b", "model:a"] and resident == ["c", "b"]


def _module_level_scenario(pkg):
    serve = pkg.api
    before = serve.status()

    @serve.deployment(name="echo_api", num_replicas=2)
    def echo(x):
        return {"echo": x}

    try:
        serve.run(echo.bind(), route_prefix="/echo")
        st = serve.status()["echo_api"]
        via_lookup = serve.get_deployment_handle("echo_api").remote(
            "hi").result(timeout=10)
        proxy = serve.get_proxy()
        code, body = _post(proxy.port, "/echo", "ping")
        serve.delete("echo_api")
        after_delete = serve.status()
    finally:
        serve.shutdown()
    return (before, st["running_replicas"], st["healthy"], via_lookup, code,
            body, after_delete, serve.status(), serve.get_proxy())


def _post(port, path, payload):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


@pytest.mark.timeout(60)
def test_module_run_status_and_shutdown_match():
    out = _both(_module_level_scenario)
    assert out == ({}, 2, True, {"echo": "hi"}, 200,
                   {"result": {"echo": "ping"}}, {}, {}, None)


# --- the config schema ----------------------------------------------------------
@t_api.deployment(name="cfg_echo")
def t_cfg_echo(x):
    return {"echo": x}


t_cfg_echo_app = t_cfg_echo.bind()


class CfgScaler:
    """Bare class target: the schema wraps it with @deployment defaults."""

    def __init__(self, factor=2):
        self.factor = factor

    def __call__(self, x):
        return x * self.factor


def _target(pkg, attr):
    """An import path that resolves to ``pkg``'s own target objects."""
    if pkg.name == "jax":
        return f"tests.fixtures:{attr}"
    return f"{__name__}:{'t_' + attr if attr.startswith('cfg_') else attr}"


def _schema_errors(pkg):
    S = pkg.schema
    out = []
    for doc in ({}, {"applications": [{"name": "a"}]},
                {"applications": [
                    {"name": "a", "deployments": [{"name": "d",
                                                   "import_path": "x:y"}]},
                    {"name": "a", "deployments": [{"name": "e",
                                                   "import_path": "x:y"}]}]},
                {"applications": [{"name": "a", "deployments": [
                    {"name": "d", "import_path": "x:y", "num_gpus": 1}]}]},
                {"applications": [
                    {"name": "a", "deployments": [{"name": "d",
                                                   "import_path": "x:y"}]},
                    {"name": "b", "deployments": [{"name": "d",
                                                   "import_path": "x:z"}]}]}):
        try:
            S.ServeConfigSchema.from_dict(doc)
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    ctl = pkg.controller.ServeController()
    try:
        for dep in ({"name": "d", "llm": {"model": "llama_tiny"},
                     "init_kwargs": {"num_slots": 4}},
                    {"name": "d"}):
            cfg = S.ServeConfigSchema.from_dict(
                {"applications": [{"name": "a", "deployments": [dep]}]})
            try:
                S.apply_config(cfg, controller=ctl)
                out.append("applied")
            except ValueError as e:
                out.append(str(e))
    finally:
        ctl.shutdown()
    return out


def test_schema_validation_matches():
    out = _both(_schema_errors)
    assert "no applications" in out[0] and "no deployments" in out[1]
    assert "duplicate" in out[2] and "unknown fields" in out[3]
    assert "inside the llm mapping" in out[5] and "exactly one" in out[6]


def _schema_apply(pkg, tmp_path):
    S = pkg.schema
    ctl = pkg.controller.ServeController(control_interval_s=0.1)
    ctl.start()
    try:
        handles = S.apply_config(S.ServeConfigSchema.from_dict(
            {"applications": [
                {"name": "echo_app", "deployments": [{
                    "name": "cfg_echo",
                    "import_path": _target(pkg, "cfg_echo_app"),
                    "num_replicas": 2, "max_ongoing_requests": 64}]},
                {"name": "scale_app", "deployments": [{
                    "name": "scaler", "import_path": _target(pkg, "CfgScaler"),
                    "init_kwargs": {"factor": 5}}]}]}), controller=ctl)
        out = [handles["cfg_echo"].remote("hi").result(timeout=10),
               handles["scaler"].remote(4).result(timeout=10)]
        dep = ctl._deployments["cfg_echo"].config
        out.append((dep.num_replicas, dep.max_ongoing_requests))
        path = tmp_path / f"{pkg.name}-app.json"
        path.write_text(json.dumps({"applications": [{
            "name": "files", "route_prefix": "/files", "deployments": [{
                "name": "cfg_echo2",
                "import_path": _target(pkg, "cfg_echo_app")}]}]}))
        loaded = S.load_config(str(path))
        out.append([(a.name, a.route_prefix, [d.name for d in a.deployments])
                    for a in loaded.applications])
        handles = S.run_config(str(path), controller=ctl)
        out.append(handles["cfg_echo2"].remote(1).result(timeout=10))
        code, body = _post(pkg.api.get_proxy().port, "/files", 3)
        out.append((code, body))
    finally:
        ctl.shutdown()
        pkg.api.shutdown()
    return out


@pytest.mark.timeout(60)
def test_apply_config_import_targets_match(tmp_path):
    out = _both(_schema_apply, tmp_path)
    assert out[:3] == [{"echo": "hi"}, 20, (2, 64)]
    assert out[4:] == [{"echo": 1}, (200, {"result": {"echo": 3}})]


def _versioned_config(pkg):
    S = pkg.schema
    ctl = pkg.controller.ServeController()

    def doc(version):
        return S.ServeConfigSchema.from_dict({"applications": [{
            "name": "va", "deployments": [{
                "name": "cfg_ver",
                "import_path": _target(pkg, "cfg_echo_app"),
                "num_replicas": 3, "version": version,
                "rolling_max_unavailable_fraction": 0.34}]}]})

    try:
        out = []
        for version in ("v1", "v2"):
            S.apply_config(doc(version), controller=ctl)
            out.append(ctl.status()["cfg_ver"]["versions"])
        for _ in range(5):
            ctl._control_step()
        out.append(ctl.status()["cfg_ver"]["versions"])
        return out
    finally:
        ctl.shutdown()


@pytest.mark.timeout(60)
def test_version_flows_through_declarative_rollout_alike():
    assert _both(_versioned_config) == [{"v1": 3}, {"v1": 1, "v2": 2},
                                        {"v2": 3}]


# --- llama_tiny behind the controller -------------------------------------------
LLM = dict(num_slots=4, max_len=64, prompt_buckets=[16],
           default_max_new_tokens=8, decode_horizon=4, warmup=False)
PAYLOADS = [{"tokens": [int(t) for t in
                        np.random.default_rng(i).integers(1, 500, n)],
             "max_new_tokens": 6}
            for i, n in enumerate((5, 11, 14, 3, 9, 16))]


@pytest.fixture(scope="module")
def tiny():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=None)
    tm.module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    return jm, params, tm


def _llm_deployment(name, tiny, **kw):
    jm, params, tm = tiny
    kw = {**LLM, **kw}
    if name == "jax":
        return j_llm.LLMDeployment("llama_tiny", model=jm, params=params,
                                   dtype=jnp.float32, **kw)
    return t_llm.LLMDeployment("llama_tiny", model=tm, device="cpu", **kw)


@pytest.fixture(scope="module")
def llm_stacks(tiny):
    """Both packages' controllers serving the same llama_tiny weights."""
    built = {}
    try:
        for name, pkg in PKGS.items():
            ctl = pkg.controller.ServeController(control_interval_s=0.1)
            built[name] = ctl
            router = ctl.deploy(
                pkg.controller.DeploymentConfig(name="llama_tiny"),
                factory=_llm_deployment(name, tiny))
            ctl.start()
            built[name] = (ctl, pkg.handle.DeploymentHandle(
                router, default_slo_ms=300_000.0))
        yield built
    finally:
        for entry in built.values():
            (entry[0] if isinstance(entry, tuple) else entry).shutdown()


@pytest.mark.timeout(240)
def test_controller_deployed_tokens_identical_to_jax(llm_stacks):
    """The same payloads through both controller-deployed stacks, one at a
    time and then all at once: identical greedy tokens."""
    want = [llm_stacks["jax"][1].remote(p).result(timeout=120).tokens
            for p in PAYLOADS]
    ctl, handle = llm_stacks["torch"]
    got = [handle.remote(p).result(timeout=120).tokens for p in PAYLOADS]
    assert got == want
    with ThreadPoolExecutor(len(PAYLOADS)) as pool:
        futs = list(pool.map(handle.remote, PAYLOADS))
    assert [f.result(timeout=120).tokens for f in futs] == want


def _llm_status(pkg, stacks):
    ctl, handle = stacks[pkg.name]
    st = ctl.status()["llama_tiny"]
    stats = next(iter(st["replicas"].values()))
    router = ctl.deploy(pkg.controller.DeploymentConfig(
        name="llama_tiny", max_ongoing_requests=128,
        user_config={"note": "redeploy"}))
    replica = router.replicas()[0]
    out = handle.remote({"tokens": [1, 2, 3], "max_new_tokens": 3}).result(
        timeout=60)
    return (sorted(st), st["running_replicas"],
            sorted(k for k in stats if not k.startswith("bucket_")),
            replica.max_ongoing_requests,
            [q.max_len for q in replica._queues.values()], len(out.tokens),
            [a["trigger"] for a in ctl.audit.to_dicts(key="llama_tiny")])


@pytest.mark.timeout(120)
def test_llm_status_and_redeploy_reconfigure_match(llm_stacks):
    (keys, running, stat_keys, cap, queue_caps, n_tokens,
     triggers) = _both(_llm_status, llm_stacks)
    assert running == 1 and {"active_slots", "decode_steps"} <= set(stat_keys)
    assert cap == 128 and queue_caps == [128] and n_tokens == 3
    assert triggers[-1] == "deploy"


@pytest.mark.timeout(240)
def test_port_heals_a_wedged_engine():
    """The reference's ``TestLLMHeal`` on the port: a wedged engine is
    replaced by the control loop, serving resumes with the same greedy
    tokens, and the victim's engine is released."""
    controller = t_controller.ServeController(control_interval_s=0.1)
    dep = t_llm.LLMDeployment(
        "llama_tiny", num_slots=2, max_len=32, prompt_buckets=[8],
        default_max_new_tokens=4, dtype=torch.float32, device="cpu")
    router = controller.deploy(
        t_controller.DeploymentConfig(name="healme", num_replicas=1,
                                      max_restarts=2),
        factory=dep)
    controller.start()
    handle = t_handle.DeploymentHandle(router, default_slo_ms=60_000.0)
    try:
        probe = handle.remote({"tokens": [1, 2]}).result(timeout=60).tokens
        assert len(probe) == 4
        victim = controller._deployments["healme"].replicas[0]
        victim.engine._run.clear()
        victim.engine.last_heartbeat -= 3600.0
        gone = weakref.ref(victim.engine)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            reps = controller._deployments["healme"].replicas
            if reps and reps[0] is not victim and reps[0].healthy():
                break
            time.sleep(0.1)
        else:
            pytest.fail("wedged LLM replica was not replaced")
        assert reps[0].replica_id != victim.replica_id
        assert victim.engine._cache is None       # buffers released
        del victim, reps
        out = handle.remote({"tokens": [3, 4]}).result(timeout=60)
        assert len(out.tokens) == 4
        assert handle.remote({"tokens": [1, 2]}).result(
            timeout=60).tokens == probe
        st = controller.status()["healme"]
        assert st["restarts"] == 1 and [
            a["trigger"] for a in st["audit"]].count("heal") == 1
    finally:
        controller.shutdown()
    gc.collect()
    assert gone() is None


@pytest.mark.timeout(240)
def test_port_rolls_a_versioned_llm_deployment():
    """The reference's ``TestLLMRollingUpdate`` on the port: a generation
    mid-decode on the v1 replica finishes through the rollout's graceful
    drain, v2 (sharing v1's model, another default_max_new_tokens) serves
    afterwards, and nothing of either stays alive after shutdown."""
    controller = t_controller.ServeController(control_interval_s=3600.0)

    def dep(max_new, model=None):
        return t_llm.LLMDeployment(
            "llama_tiny", num_slots=2, max_len=64, prompt_buckets=[8],
            default_max_new_tokens=max_new, decode_horizon=2,
            dtype=torch.float32, device="cpu", warmup=False, model=model)

    v1 = dep(6)
    router = controller.deploy(
        t_controller.DeploymentConfig(name="llm_roll", num_replicas=1,
                                      version="v1"),
        factory=v1)
    try:
        handle = t_handle.DeploymentHandle(router, default_slo_ms=120_000.0)
        old_replica = router.replicas()[0]
        model = weakref.ref(old_replica.engine.model)
        warm = handle.remote({"tokens": [7, 8], "max_new_tokens": 2})
        assert len(warm.result(timeout=120).tokens) == 2
        inflight = handle.remote({"tokens": [1, 2, 3], "max_new_tokens": 24})
        deadline = time.monotonic() + 60
        while (old_replica.engine.active_slots == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert old_replica.engine.active_slots > 0
        controller.deploy(
            t_controller.DeploymentConfig(name="llm_roll", num_replicas=1,
                                          version="v2"),
            factory=dep(9, model=old_replica.engine.model))
        assert len(inflight.result(timeout=60).tokens) == 24
        assert controller.status()["llm_roll"]["versions"] == {"v2": 1}
        fresh = handle.remote({"tokens": [4, 5, 6]})
        assert len(fresh.result(timeout=120).tokens) == 9
        assert router.replicas()[0].engine.model is model()
        assert old_replica.engine._cache is None
        del old_replica, v1, warm, inflight, fresh
    finally:
        controller.shutdown()
    del controller, router, handle
    gc.collect()
    assert model() is None


def test_schema_llm_target_builds_the_ports_deployment():
    ctl = t_controller.ServeController(control_interval_s=0.1)
    ctl.start()
    try:
        handles = t_schema.apply_config(t_schema.ServeConfigSchema.from_dict(
            {"applications": [{"name": "chat", "deployments": [{
                "name": "llama",
                "llm": {"model": "llama_tiny", "num_slots": 2, "max_len": 32,
                        "prompt_buckets": [8], "default_max_new_tokens": 4,
                        "dtype": "float32", "device": "cpu"},
                "version": "v1", "max_ongoing_requests": 32}]}]}),
            controller=ctl)
        out = handles["llama"].remote({"tokens": [1, 2, 3]}).result(
            timeout=120)
        assert len(out.tokens) == 4
        state = ctl._deployments["llama"]
        assert isinstance(state.factory, t_llm.LLMDeployment)
        replica = state.replicas[0]
        assert replica.engine.model.dtype == torch.float32
        assert (replica.version, replica.max_ongoing_requests) == ("v1", 32)
    finally:
        ctl.shutdown()
    with pytest.raises(ValueError, match="unknown dtype"):
        t_llm.LLMDeployment("llama_tiny", dtype="float99", device="cpu")


class _PlacedCPU:
    """A placement device whose replicas build on the CPU."""

    process_index = 0
    platform = "cpu"
    torch_device = torch.device("cpu")

    def __init__(self, id):
        self.id = id


def test_make_replica_takes_a_config_and_placed_devices(tiny):
    cfg = t_controller.DeploymentConfig(name="llama_tiny",
                                        max_ongoing_requests=16)
    dep = t_llm.LLMDeployment("llama_tiny", dtype=torch.float32, device="cpu",
                              **LLM)
    with pytest.raises(NotImplementedError, match="item 8"):
        dep.make_replica("r0", cfg, devices=[_PlacedCPU(0), _PlacedCPU(1)])
    assert dep._model is None          # refused before any build
    replica = dep.make_replica("r1", cfg, devices=[_PlacedCPU(0)])
    try:
        assert replica.devices[0].id == 0
        assert replica.engine.model.device == torch.device("cpu")
        assert replica.max_ongoing_requests == 16
    finally:
        replica.stop(timeout_s=1.0, drain=False)
    on_cpu = _llm_deployment("torch", tiny)
    with pytest.raises(ValueError, match="never moved"):
        on_cpu.make_replica("r2", cfg,
                            devices=[t_placement.CudaDevice(id=0)])
    for name in PKGS:
        with pytest.raises(TypeError, match="make_replica"):
            _llm_deployment(name, tiny)()


def test_controller_places_llm_replicas_on_reserved_chips():
    ctl = t_controller.ServeController(
        placement=t_placement.PlacementManager([_PlacedCPU(0),
                                                _PlacedCPU(1)]))
    dep = t_llm.LLMDeployment("llama_tiny", dtype=torch.float32, device="cpu",
                              **LLM)
    try:
        router = ctl.deploy(t_controller.DeploymentConfig(
            name="placed", num_replicas=2, chips_per_replica=1), factory=dep)
        assert sorted(r.devices[0].id for r in router.replicas()) == [0, 1]
        assert ctl.resources()["nodes"]["0"]["chips_free"] == 0
        ctl.deploy(t_controller.DeploymentConfig(
            name="placed", num_replicas=1, chips_per_replica=1))
        assert ctl.resources()["nodes"]["0"]["chips_free"] == 1
    finally:
        ctl.shutdown()
    assert ctl.resources()["nodes"]["0"]["chips_free"] == 2
