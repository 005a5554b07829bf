"""The port's sharded front door (``ray_dynamic_batching_tpu_torch/serve/
frontdoor.py``) against the JAX package's.

Twins of the reference's ``tests/test_frontdoor.py`` on the port's
modules: ring affinity, gossip budgets, drift audit, the global
admission budget over N stateless shards (per-shard ledgers gossip
mergeable sketch states by replacement, so re-delivery cannot
double-count; the fleet admits within ``burst + rate * elapsed`` plus the
documented ``(N-1) * rate * staleness`` bound), the staleness contract,
and a shard as the port's ``HTTPProxy``'s admission layer. Then both
packages side by side on one fake clock: ``HashRing`` assignments,
``GlobalAdmissionLedger`` decision sequences and states, and a
``FrontDoor``'s admissions, gossip and drift audit are equal; and the
live gossip thread stops in ``stop()``. Every ``FrontDoor``, proxy and
controller a test starts is stopped."""

import json

import pytest

from ray_dynamic_batching_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.frontdoor import (
    FrontDoor,
    FrontDoorShard,
    GlobalAdmissionLedger,
    GlobalBudget,
    HashRing,
    affinity_key,
)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TestHashRing:
    def test_deterministic_and_stable_affinity(self):
        r1 = HashRing(["fd-0", "fd-1", "fd-2"])
        r2 = HashRing(["fd-0", "fd-1", "fd-2"])
        for i in range(200):
            key = f"session:{i}"
            assert r1.shard_for(key) == r2.shard_for(key)
            assert r1.shard_for(key) == r1.shard_for(key)

    def test_removal_moves_a_bounded_fraction(self):
        ring = HashRing([f"fd-{i}" for i in range(4)])
        keys = [f"session:{i}" for i in range(1000)]
        before = {k: ring.shard_for(k) for k in keys}
        ring.remove("fd-2")
        moved = sum(1 for k in keys if ring.shard_for(k) != before[k])
        # Only fd-2's arcs move (~1/4 of the space); everything else
        # stays — the consistent-hashing point. Generous slack for vnode
        # imbalance.
        assert 0 < moved < 450
        for k in keys:
            if before[k] != "fd-2":
                assert ring.shard_for(k) == before[k]

    def test_empty_ring_raises(self):
        ring = HashRing(["fd-0"])
        ring.remove("fd-0")
        with pytest.raises(ValueError):
            ring.shard_for("x")

    def test_affinity_key_precedence(self):
        assert affinity_key({"session_id": "s1"}, tenant="t",
                            request_id="r") == "session:s1"
        assert affinity_key({"x": 1}, tenant="t",
                            request_id="r") == "tenant:t"
        assert affinity_key(None, tenant=None,
                            request_id="r") == "request:r"


class TestGlobalLedger:
    def _ledger(self, clock, rate=10.0, burst=5.0):
        return GlobalAdmissionLedger(
            "fd-0", GlobalBudget(rate_rps=rate, burst=burst, t0=clock())
        )

    def test_single_shard_tracks_the_allowance_line(self):
        clock = FakeClock()
        lg = self._ledger(clock)
        admitted = 0
        while lg.admit(clock())[0]:
            admitted += 1
        assert admitted == 5  # the burst
        ok, retry = lg.admit(clock())
        assert not ok and retry > 0
        clock.advance(1.0)  # +10 tokens of allowance
        admitted = 0
        while lg.admit(clock())[0]:
            admitted += 1
        assert admitted == 10

    def test_check_does_not_burn_commit_does(self):
        clock = FakeClock()
        lg = self._ledger(clock)
        for _ in range(50):
            assert lg.check(clock())[0]  # read-only: still admissible
        assert lg.own_count == 0
        lg.commit(clock())
        assert lg.own_count == 1

    def test_absorb_is_idempotent_replacement(self):
        clock = FakeClock()
        lg = self._ledger(clock, rate=100.0, burst=100.0)
        peer = self._ledger(clock, rate=100.0, burst=100.0)
        peer.shard_id = "fd-1"
        for _ in range(7):
            peer.commit(clock())
        state = peer.state()
        lg.absorb("fd-1", state)
        lg.absorb("fd-1", state)  # re-delivered gossip
        lg.absorb("fd-1", json.loads(json.dumps(state)))  # reordered copy
        assert lg.merged_count() == 7  # NOT 21
        assert lg.merged_sketch().count == 7

    def test_own_state_never_absorbed(self):
        clock = FakeClock()
        lg = self._ledger(clock)
        lg.commit(clock())
        lg.absorb("fd-0", lg.state())  # a bus echo of our own payload
        assert lg.merged_count() == 1


class TestFrontDoorGossip:
    def test_global_budget_converges_through_gossip(self):
        clock = FakeClock()
        fd = FrontDoor(n_shards=2, clock=clock, gossip_interval_s=0.5)
        fd.configure("llm", rate_rps=10.0, burst=10.0)
        # Before any gossip each shard sees only itself: both can admit
        # the full burst (the staleness price).
        for shard in fd.shards.values():
            n = 0
            while shard.admit("llm")[0]:
                n += 1
            assert n == 10
        drift = fd.drift_audit("llm")
        assert drift["admitted"] == 20.0
        assert drift["over_admitted"] == pytest.approx(10.0)
        assert drift["over_admitted"] <= drift["bound"] + 10.0 * 0.5
        # After gossip the fleet view is shared: nobody admits.
        fd.gossip_round()
        for shard in fd.shards.values():
            assert not shard.admit("llm")[0]
        # The allowance line grows; shards split the new budget without
        # exceeding it (gossip after each wave).
        clock.advance(2.0)  # +20 allowance
        admitted = 0
        for shard in fd.shards.values():
            while shard.admit("llm")[0]:
                admitted += 1
            fd.gossip_round()
        assert admitted <= 20 + 1

    def test_drift_audit_lands_in_the_ring(self):
        clock = FakeClock()
        fd = FrontDoor(n_shards=2, clock=clock, gossip_interval_s=0.5)
        fd.configure("llm", rate_rps=10.0, burst=10.0)
        fd.admit("llm", payload={"session_id": "s0"})
        fd.drift_audit("llm")
        recs = [r for r in fd.audit.to_dicts()
                if r["trigger"] == "admission_drift"]
        assert recs and recs[-1]["key"] == "llm"
        assert "bound" in recs[-1]["observed"]

    def test_shard_removal_preserves_history(self):
        clock = FakeClock()
        fd = FrontDoor(n_shards=3, clock=clock, gossip_interval_s=0.5)
        fd.configure("llm", rate_rps=10.0, burst=30.0)
        # Pin some admissions on every shard.
        for shard in fd.shards.values():
            for _ in range(3):
                assert shard.admit("llm")[0]
        fd.gossip_round()
        fd.remove_shard("fd-1")
        # Survivors still account the departed shard's 3 admissions.
        survivor = fd.shards["fd-0"]
        assert survivor.ledger("llm").merged_count() == 9
        assert "fd-1" not in fd.ring.shards()

    def test_session_affinity_routes_to_one_shard(self):
        clock = FakeClock()
        fd = FrontDoor(n_shards=4, clock=clock)
        fd.configure("llm", rate_rps=1000.0, burst=1000.0)
        shard_ids = {
            fd.admit("llm", payload={"session_id": "sticky"})[0]
            for _ in range(20)
        }
        assert len(shard_ids) == 1


class TestShardProxySurface:
    """A FrontDoorShard drops into the proxies' ``admission=`` seam."""

    def test_admit_surface_matches_admission_controller(self):
        clock = FakeClock()
        shard = FrontDoorShard("fd-0", clock=clock)
        shard.configure("llm", GlobalBudget(rate_rps=2.0, burst=2.0,
                                            t0=clock()))
        ok, retry = shard.admit("llm", "tenant-1", "interactive")
        assert ok and retry == 0.0
        shard.admit("llm")
        ok, retry = shard.admit("llm")
        assert not ok and retry > 0  # same (ok, retry_after_s) contract

    def test_local_admission_chains_under_the_global_cap(self):
        clock = FakeClock()
        local = AdmissionController(clock=clock)
        local.configure("llm", AdmissionPolicy(rate_rps=1.0, burst=1.0))
        shard = FrontDoorShard("fd-0", clock=clock, local=local)
        shard.configure("llm", GlobalBudget(rate_rps=100.0, burst=100.0,
                                            t0=clock()))
        assert shard.admit("llm", "t0")[0]
        # Global budget has room, but the tenant's LOCAL bucket is dry —
        # and the local reject must not burn a global token.
        ledger = shard.ledger("llm")
        before = ledger.own_count
        ok, retry = shard.admit("llm", "t0")
        assert not ok and retry > 0
        assert ledger.own_count == before

    def test_http_proxy_accepts_a_shard(self):
        """End-to-end: a real HTTPProxy with a FrontDoorShard as its
        admission layer answers 429 + Retry-After when the global
        budget is dry."""
        import urllib.error
        import urllib.request

        from ray_dynamic_batching_tpu_torch.serve import (
            DeploymentConfig,
            DeploymentHandle,
            ServeController,
        )
        from ray_dynamic_batching_tpu_torch.serve.proxy import (
            HTTPProxy,
            ProxyRouter,
        )

        ctl = ServeController()
        router = ctl.deploy(
            DeploymentConfig(name="fdhttp", num_replicas=1),
            factory=lambda: (lambda ps: [p * 2 for p in ps]),
        )
        shard = FrontDoorShard("fd-7")
        # Fractional burst: exactly two admissions fit, and the near-zero
        # refill cannot creep the allowance over the next integer during
        # the test's wall-clock run.
        shard.configure("fdhttp", GlobalBudget(
            rate_rps=0.001, burst=1.5, t0=shard._clock()
        ))
        proute = ProxyRouter()
        proute.set_route("/api/fdhttp", DeploymentHandle(router))
        proxy = HTTPProxy(proute, port=0, admission=shard,
                          shard_id=shard.shard_id).start()
        try:
            url = f"http://127.0.0.1:{proxy.port}/api/fdhttp"

            def post(val):
                req = urllib.request.Request(
                    url, data=json.dumps(val).encode(),
                    headers={"Content-Type": "application/json"},
                )
                return urllib.request.urlopen(req, timeout=10)

            assert json.load(post(21))["result"] == 42
            post(1)  # burns the burst
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(2)
            assert ei.value.code == 429
            assert ei.value.headers.get("Retry-After") is not None
        finally:
            proxy.stop()
            ctl.shutdown()


class TestDepartedShardOracle:
    def test_drift_oracle_counts_removed_shards(self):
        """Review regression: remove_shard must move the departed
        shard's own admissions into the oracle baseline, or drift_audit
        under-reports over-admission by exactly that history."""
        clock = FakeClock()
        fd = FrontDoor(n_shards=3, clock=clock, gossip_interval_s=0.5)
        fd.configure("llm", rate_rps=10.0, burst=30.0)
        for shard in fd.shards.values():
            for _ in range(3):
                assert shard.admit("llm")[0]
        assert fd.true_admitted("llm") == 9
        fd.remove_shard("fd-1")
        assert fd.true_admitted("llm") == 9  # history survives removal
        drift = fd.drift_audit("llm")
        assert drift["admitted"] == 9.0


class TestConcurrentShardAdmission:
    def test_check_commit_is_one_critical_section(self):
        """Review regression: 16 threads racing one shard at the budget
        line must admit EXACTLY the allowance — the check and the commit
        happen under one lock, so no thread can slip through a window
        another thread's pending commit should have closed."""
        import threading

        # Fractional burst so the near-zero refill cannot creep the
        # allowance across the next integer mid-test: exactly 50
        # admissions fit (counts 0..49 < 49.5).
        shard = FrontDoorShard("fd-0")
        shard.configure("llm", GlobalBudget(
            rate_rps=1e-9, burst=49.5, t0=shard._clock()
        ))
        admitted = []

        def hammer():
            n = 0
            for _ in range(20):
                if shard.admit("llm")[0]:
                    n += 1
            admitted.append(n)

        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(admitted) == 50


# --- fail-closed staleness contract ---------------------------------------


class TestLedgerStaleness:
    def _ledger(self, clock, n_shards=4, bound=1.0, rate=10.0,
                burst=20.0, shard="fd-0"):
        lg = GlobalAdmissionLedger(
            shard, GlobalBudget(rate_rps=rate, burst=burst, t0=clock()),
            n_shards=n_shards, staleness_bound_s=bound,
        )
        return lg

    def _fresh_peers(self, lg, clock, n=3):
        for i in range(n):
            lg.absorb(f"peer-{i}", {"count": 0}, now=clock())

    def test_degrades_fail_closed_when_gossip_stops(self):
        clock = FakeClock()
        lg = self._ledger(clock)                 # allowed = 20 + 10t
        self._fresh_peers(lg, clock)
        assert lg.check(clock())[0] and not lg.degraded
        clock.advance(2.0)                       # > 1.0s bound, no gossip
        ok, _ = lg.check(clock())
        assert lg.degraded
        # Local fraction: allowed(2.0)/4 = 10 — own admissions only.
        admitted = 0
        while lg.admit(clock())[0]:
            admitted += 1
        assert admitted == 10                    # not the full 40

    def test_all_shards_degraded_never_exceed_the_global_allowance(self):
        """Fail-closed means the partition can only UNDER-admit: every
        shard degrading to allowed/N sums to at most the allowance."""
        clock = FakeClock()
        shards = [self._ledger(clock, shard=f"fd-{i}") for i in range(4)]
        for lg in shards:
            self._fresh_peers(lg, clock)
        clock.advance(3.0)                       # full gossip silence
        total = 0
        for lg in shards:
            while lg.admit(clock())[0]:
                total += 1
        # The GLOBAL line holds to within the same one-request-per-shard
        # rounding the healthy (N-1)*rate*staleness bound carries —
        # bounded forever, however long the partition lasts.
        assert total <= 20 + 10 * 3.0 + len(shards)

    def test_stalest_peer_governs_partial_partitions(self):
        clock = FakeClock()
        lg = self._ledger(clock)
        self._fresh_peers(lg, clock)
        clock.advance(2.0)
        # Two of three peers gossip on (same side); the third is cut
        # off — the merged count is missing a fleet slice, so the
        # ledger must STILL fail closed.
        lg.absorb("peer-0", {"count": 0}, now=clock())
        lg.absorb("peer-1", {"count": 0}, now=clock())
        lg.check(clock())
        assert lg.degraded

    def test_never_heard_peer_counts_from_the_anchor(self):
        clock = FakeClock()
        lg = self._ledger(clock)                 # nobody ever gossiped
        clock.advance(2.0)
        lg.check(clock())
        assert lg.degraded

    def test_reconverges_on_heal(self):
        clock = FakeClock()
        lg = self._ledger(clock)
        self._fresh_peers(lg, clock)
        clock.advance(2.0)
        lg.check(clock())
        assert lg.degraded and lg.degraded_entries == 0  # shard meters it
        for i in range(3):
            lg.absorb(f"peer-{i}", {"count": 5}, now=clock())
        ok, _ = lg.check(clock())
        assert not lg.degraded
        assert lg.merged_count() == 15           # merged view restored

    def test_retired_peer_is_exempt_and_shrinks_the_fleet(self):
        clock = FakeClock()
        lg = self._ledger(clock, n_shards=4)
        self._fresh_peers(lg, clock)
        lg.absorb("peer-2", {"count": 9}, now=clock())
        lg.retire_peer("peer-2")
        assert lg.n_shards == 3
        clock.advance(10.0)
        lg.absorb("peer-0", {"count": 0}, now=clock())
        lg.absorb("peer-1", {"count": 0}, now=clock())
        lg.check(clock())
        assert not lg.degraded                   # the ghost never stales
        assert lg.merged_count() == 9            # its history still counts

    def test_reordered_absorb_cannot_rewind_a_newer_state(self):
        clock = FakeClock()
        lg = self._ledger(clock, n_shards=2)  # one expected peer
        lg.absorb("peer-0", {"count": 5}, now=clock())
        clock.advance(0.5)
        # A fabric-delayed older payload lands late: the monotone count
        # guard keeps the newer state; the freshness stamp still moves.
        lg.absorb("peer-0", {"count": 3}, now=clock())
        assert lg.peer_count() == 5
        assert lg.peer_staleness_s(clock()) == 0.0

    def test_degradation_is_audited_metered_and_reconverges(self):
        clock = FakeClock()
        fd = FrontDoor(n_shards=2, clock=clock, gossip_interval_s=0.2,
                       staleness_bound_s=0.5)
        fd.configure("llm", rate_rps=10.0, burst=4.0)
        fd.gossip_round()                        # anchor freshness
        clock.advance(1.0)                       # silence > bound
        shard = fd.shards["fd-0"]
        shard.admit("llm")
        assert shard.ledger("llm").degraded
        assert shard.ledger("llm").degraded_entries == 1
        degraded = [a for a in fd.audit.to_dicts()
                    if a["trigger"] == "ledger_degraded"]
        assert degraded and degraded[0]["observed"]["shard"] == "fd-0"
        fd.gossip_round()                        # heal
        shard.admit("llm")
        assert not shard.ledger("llm").degraded
        assert any(a["trigger"] == "ledger_reconverged"
                   for a in fd.audit.to_dicts())
        assert shard.ledger_snapshot()["degraded_entries"] == 1

    def test_deployment_configured_after_removal_sizes_for_survivors(self):
        """A ledger born AFTER a shard removal must expect the
        SURVIVING fleet — sized for the original N it would wait
        forever on a ghost peer and degrade fail-closed permanently."""
        clock = FakeClock()
        fd = FrontDoor(n_shards=4, clock=clock, gossip_interval_s=0.2,
                       staleness_bound_s=0.5)
        fd.configure("old", rate_rps=10.0, burst=10.0)
        fd.remove_shard("fd-3")
        fd.configure("new-dep", rate_rps=10.0, burst=10.0)
        lg = fd.shards["fd-0"].ledger("new-dep")
        assert lg.n_shards == 3
        # Healthy gossip among the survivors: never degrades, however
        # long the (ghost-free) fleet runs.
        for _ in range(20):
            clock.advance(0.2)
            fd.gossip_round()
        fd.shards["fd-0"].admit("new-dep")
        assert not lg.degraded

    def test_idle_deployment_degrades_and_heals_via_gossip_sweep(self):
        """The degradation edges (flag, gauge, audit) move with GOSSIP
        progress: a deployment nobody admits through still enters
        degraded mode when its peers go silent and — critically —
        clears on heal instead of standing as a false alarm until the
        next admission."""
        from ray_dynamic_batching_tpu_torch.serve.fabric import ControlFabric

        clock = FakeClock()
        fab = ControlFabric(clock=clock, seed=0,
                            partition_spec="fd-0|fd-1@t=0", edge_spec="")
        fd = FrontDoor(n_shards=2, clock=clock, gossip_interval_s=0.2,
                       staleness_bound_s=0.5, fabric=fab)
        fd.configure("llm", rate_rps=10.0, burst=4.0)
        clock.advance(1.0)
        fd.gossip_round()  # absorbs dropped; the sweep sees the silence
        lg = fd.shards["fd-0"].ledger("llm")
        assert lg.degraded and lg.degraded_entries == 1
        assert any(a["trigger"] == "ledger_degraded"
                   for a in fd.audit.to_dicts())
        fab.configure(partition_spec="")  # heal
        fd.gossip_round()
        assert not lg.degraded
        assert any(a["trigger"] == "ledger_reconverged"
                   for a in fd.audit.to_dicts())


# --- both packages side by side ---------------------------------------------
def _packages():
    from ray_dynamic_batching_tpu.serve import frontdoor as j_fd
    from ray_dynamic_batching_tpu_torch.serve import frontdoor as t_fd

    return j_fd, t_fd


@pytest.mark.parametrize("n_shards,vnodes", [(2, 64), (3, 64), (5, 16)])
def test_hash_ring_assignments_equal_across_packages(n_shards, vnodes):
    """The same shard for every key, before and after a shard leaves."""
    ids = [f"fd-{i}" for i in range(n_shards)]
    keys = ([f"session:{i}" for i in range(400)]
            + [f"tenant:t{i}" for i in range(50)]
            + [f"request:{i:08x}" for i in range(50)])
    rings = [mod.HashRing(ids, vnodes=vnodes) for mod in _packages()]
    for _ in range(2):
        want, got = ([r.shard_for(k) for k in keys] for r in rings)
        assert got == want
        assert len(set(got)) == len(rings[1].shards())
        for r in rings:
            r.remove(ids[-1])


def test_affinity_keys_equal_across_packages():
    j_fd, t_fd = _packages()
    cases = [({"session_id": "s1"}, "t", "r"), ({"x": 1}, "t", "r"),
             (None, None, "r"), ({"session_id": ""}, "", "r9"),
             ([1, 2], "tenant-b", None)]
    for payload, tenant, rid in cases:
        assert (t_fd.affinity_key(payload, tenant, rid)
                == j_fd.affinity_key(payload, tenant, rid))


def _ledger_script(mod, seed: int, staleness_bound_s: float) -> list:
    """Two shards' ledgers of one budget on one fake clock: seeded
    admissions on either shard, gossip exchanged on most ticks and
    withheld on a run of them (long enough to go stale when a bound is
    armed). Returns every decision and the ledgers' views after each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clock = FakeClock()
    budget = mod.GlobalBudget(rate_rps=20.0, burst=10.0, t0=clock())
    ledgers = [mod.GlobalAdmissionLedger(
        f"fd-{i}", budget, n_shards=2,
        staleness_bound_s=staleness_bound_s) for i in range(2)]
    out = []
    for step in range(400):
        clock.advance(float(rng.exponential(0.03)))
        lg = ledgers[int(rng.integers(0, 2))]
        ok, retry = lg.admit(clock())
        if step % 5 == 0 and not 150 <= step < 230:
            a, b = ledgers
            a.absorb(b.shard_id, b.state(), now=clock())
            b.absorb(a.shard_id, a.state(), now=clock())
            for x in ledgers:
                x.refresh(clock())
        out.append((lg.shard_id, ok, round(retry, 9),
                    [(x.own_count, x.peer_count(), x.merged_count(),
                      x.degraded) for x in ledgers]))
    return out


@pytest.mark.parametrize("staleness_bound_s", [0.0, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_admission_ledger_sequences_equal_across_packages(
        seed, staleness_bound_s):
    j_fd, t_fd = _packages()
    want = _ledger_script(j_fd, seed, staleness_bound_s)
    got = _ledger_script(t_fd, seed, staleness_bound_s)
    assert got == want
    assert any(ok for _, ok, _, _ in got)
    assert any(not ok for _, ok, _, _ in got)
    if staleness_bound_s:
        # degraded while gossip was withheld, and healed after
        assert any(v[3] for _, _, _, views in got for v in views)
        assert not any(v[3] for v in got[-1][3])


def _front_door_script(mod) -> tuple:
    """A three-shard front door on a fake clock: sessions and tenants
    routed and admitted, gossip rounds every 0.2 s, a shard removed
    midway, a drift audit at the end."""
    clock = FakeClock()
    fd = mod.FrontDoor(n_shards=3, clock=clock, gossip_interval_s=0.2)
    fd.configure("llm", rate_rps=30.0, burst=15.0)
    decisions = []
    for i in range(600):
        clock.advance(0.01)
        payload = ({"session_id": f"s{i % 37}"} if i % 3
                   else {"prompt": i})
        decisions.append(fd.admit("llm", payload=payload,
                                  tenant=f"t{i % 4}",
                                  request_id=f"r{i}"))
        if i % 20 == 19:
            fd.gossip_round()
        if i == 300:
            fd.remove_shard("fd-1")
    audit = fd.drift_audit("llm")
    return (decisions, audit, fd.true_admitted("llm"),
            json.dumps(fd.stats(), sort_keys=True),
            [(r["trigger"], r["key"], r["observed"])
             for r in fd.audit.to_dicts()])


def test_front_door_admissions_and_drift_audit_equal_across_packages():
    j_fd, t_fd = _packages()
    want = _front_door_script(j_fd)
    got = _front_door_script(t_fd)
    assert got == want
    decisions, audit = got[0], got[1]
    assert {sid for sid, _, _ in decisions} == {"fd-0", "fd-1", "fd-2"}
    assert audit["over_admitted"] <= audit["bound"]


def test_live_gossip_thread_stops():
    """``start()`` runs gossip on a daemon thread; ``stop()`` ends it,
    and a second ``stop()`` is harmless."""
    import threading
    import time

    from ray_dynamic_batching_tpu_torch.serve.frontdoor import (
        FrontDoor as TFrontDoor,
    )

    fd = TFrontDoor(n_shards=2, gossip_interval_s=0.01)
    fd.configure("llm", rate_rps=100.0, burst=10.0)
    try:
        fd.start()
        assert fd.start() is fd                  # idempotent
        thread = fd._thread
        deadline = time.monotonic() + 10
        while fd.gossip_rounds < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fd.gossip_rounds >= 3
        assert fd.admit("llm", payload={"session_id": "a"})[1]
    finally:
        fd.stop()
    assert not thread.is_alive()
    assert fd._thread is None
    assert not [t for t in threading.enumerate()
                if t.name == "frontdoor-gossip" and t.is_alive()]
    fd.stop()
