"""Cluster-wide prefix routing in the port vs the JAX package (CPU): the
digest chain, the router's digest directory, longest-chain routing before
pow-2, and the controller publishing replica digests.

Each of the reference's routing tests runs on both packages' classes.
Across the packages: ``digest_chain`` gives the same bytes and
``chain_for`` the same chains on the same prompts, and a port
``LLMReplica`` whose paged engine published a prompt's pages has the
shared-prefix requests steered to it by the port's router.
"""

import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine import paging as j_paging
from ray_dynamic_batching_tpu.engine import request as j_request
from ray_dynamic_batching_tpu.serve import controller as j_controller
from ray_dynamic_batching_tpu.serve import replica as j_replica
from ray_dynamic_batching_tpu.serve import router as j_router
from ray_dynamic_batching_tpu_torch.engine import paging as t_paging
from ray_dynamic_batching_tpu_torch.engine import request as t_request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.serve import controller as t_controller
from ray_dynamic_batching_tpu_torch.serve import replica as t_replica
from ray_dynamic_batching_tpu_torch.serve import router as t_router
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

torch.set_num_threads(2)

PKG = {
    "jax": (j_paging, j_request, j_controller, j_replica, j_router),
    "torch": (t_paging, t_request, t_controller, t_replica, t_router),
}
pkgs = pytest.mark.parametrize("pkg", list(PKG))


def _mods(pkg):
    return dict(zip(("paging", "request", "controller", "replica",
                     "router"), PKG[pkg]))


def _chain(tokens, page_size=4, pkg="torch"):
    return [k.hex() for k in _mods(pkg)["paging"].digest_chain(
        np.asarray(tokens, np.int32), page_size,
        (len(tokens) - 1) // page_size)]


# --- the digest chain --------------------------------------------------------
@pytest.mark.parametrize("n,page_size", [(13, 4), (300, 128), (1, 4),
                                         (257, 16)])
def test_digest_chain_bytes_equal_across_packages(n, page_size):
    prompt = np.random.default_rng(n).integers(0, 128256, n).astype(np.int32)
    assert (t_paging.digest_chain(prompt, page_size)
            == j_paging.digest_chain(prompt, page_size))


@pkgs
def test_shared_helper_matches_prefix_cache_keys(pkg):
    paging = _mods(pkg)["paging"]
    cache = paging.PagedPrefixCache(8, page_size=4,
                                    allocator=paging.PageAllocator(16))
    prompt = np.arange(1, 14, dtype=np.int32)
    assert cache._level_keys(prompt, 3) == paging.digest_chain(prompt, 4, 3)


@pkgs
def test_chain_is_prefix_consistent(pkg):
    paging = _mods(pkg)["paging"]
    a = paging.digest_chain(np.arange(16, dtype=np.int32), 4)
    b = paging.digest_chain(np.arange(8, dtype=np.int32), 4)
    assert a[:2] == b


# --- the directory -----------------------------------------------------------
def _dir(pkg, **kw):
    return _mods(pkg)["router"].PrefixDigestDirectory(**kw)


@pkgs
def test_publish_and_longest_chain(pkg):
    d = _dir(pkg)
    chain = _chain(list(range(13)))
    assert d.publish("r0", 4, {chain[0]: 1})
    assert d.publish("r1", 4, {chain[0]: 1, chain[2]: 3})
    assert d.best(chain, ["r0", "r1", "r2"]) == (3, {"r1"})


@pkgs
def test_tie_returns_all_holders(pkg):
    d = _dir(pkg)
    chain = _chain(list(range(13)))
    d.publish("r0", 4, {chain[1]: 2})
    d.publish("r1", 4, {chain[1]: 2})
    assert d.best(chain, ["r0", "r1"]) == (2, {"r0", "r1"})


@pkgs
def test_expire_by_replacement_and_prune(pkg):
    d = _dir(pkg)
    chain = _chain(list(range(13)))
    d.publish("r0", 4, {chain[2]: 3})
    assert d.best(chain, ["r0"])[0] == 3
    assert d.publish("r0", 4, {})
    assert d.best(chain, ["r0"]) == (0, set())
    d.publish("r1", 4, {chain[0]: 1})
    d.prune({"r0"})
    assert d.best(chain, ["r1"]) == (0, set())


@pkgs
def test_unchanged_publish_reports_no_change(pkg):
    d = _dir(pkg)
    chain = _chain(list(range(13)))
    assert d.publish("r0", 4, {chain[0]: 1})
    assert not d.publish("r0", 4, {chain[0]: 1})


@pkgs
def test_bounded_per_replica(pkg):
    d = _dir(pkg, max_digests_per_replica=2)
    d.publish("r0", 4, {f"{i:032x}": 1 for i in range(50)})
    assert len(d.snapshot()["replicas"]["r0"]) == 2


@pkgs
def test_page_size_conflict_drops_the_publisher(pkg):
    d = _dir(pkg)
    chain = _chain(list(range(13)))
    d.publish("r0", 4, {chain[0]: 1})
    assert not d.publish("r1", 8, {chain[0]: 1})
    assert "r1" not in d.snapshot()["replicas"]


@pkgs
def test_chain_for_requires_tokens_past_one_page(pkg):
    d = _dir(pkg)
    assert d.chain_for({"tokens": list(range(20))}) == []   # idle
    d.publish("r0", 4, {"aa": 1})
    assert d.chain_for({"tokens": [1, 2, 3]}) == []
    assert d.chain_for("not-a-dict") == []
    assert d.chain_for({"x": 1}) == []
    assert d.chain_for({"tokens": list(range(13))}) == _chain(
        list(range(13)), pkg=pkg)


@pytest.mark.parametrize("size", [5, 12])
@pkgs
def test_chain_for_respects_strict_prefill_bound(pkg, size):
    d = _dir(pkg)
    d.publish("r0", 4, {"aa": 1})
    assert len(d.chain_for({"tokens": list(range(size))})) == (size - 1) // 4


@pkgs
def test_page_size_reanchors_after_all_publishers_leave(pkg):
    d = _dir(pkg)
    d.publish("r0", 128, {"aa": 1})
    assert not d.publish("r1", 64, {"bb": 1})
    d.prune(set())
    assert d.publish("r2", 64, {"bb": 1})
    assert d.snapshot()["page_size"] == 64
    assert d.best(["bb"], ["r2"]) == (1, {"r2"})


@pkgs
def test_malformed_tokens_never_crash_routing(pkg):
    d = _dir(pkg)
    d.publish("r0", 4, {"aa": 1})
    assert d.chain_for({"tokens": ["a", "b", "c", "d", "e", "f"]}) == []
    assert d.chain_for({"tokens": [2 ** 70] * 8}) == []
    assert d.chain_for({"tokens": [[1, 2]] * 8}) == []


@pytest.mark.parametrize("page_size", [4, 128])
def test_chain_for_equals_the_reference_s(page_size):
    """Both directories, published alike, give the same chains on the
    same prompts (under a page, a page, several pages, odd tails)."""
    rng = np.random.default_rng(page_size)
    dirs = [_dir(p) for p in PKG]
    for d in dirs:
        d.publish("r0", page_size, {"aa": 1})
    for n in (1, page_size, page_size + 1, 3 * page_size, 3 * page_size + 7):
        payload = {"tokens": rng.integers(0, 128256, n).tolist()}
        got, want = (d.chain_for(payload) for d in dirs)
        assert got == want
        assert len(got) == (n - 1) // page_size


# --- the router --------------------------------------------------------------
def _echo(payloads):
    return list(payloads)


def _router(pkg, n=3):
    m = _mods(pkg)
    reps = [m["replica"].Replica(f"r{i}", "d", _echo, max_batch_size=4,
                                 batch_wait_timeout_s=0.001)
            for i in range(n)]
    for r in reps:
        r.start()
    return m["router"].Router("d", replicas=reps), reps


def _route(pkg, router, tokens, n):
    seen = []
    for _ in range(n):
        req = _mods(pkg)["request"].Request(
            model="d", payload={"tokens": tokens}, slo_ms=10_000.0)
        assert router.assign_request(req)
        seen.append(req._assigned_replica)
        req.future.result(timeout=5)
    return seen


@pkgs
def test_longest_chain_holder_wins_before_pow2(pkg):
    router, reps = _router(pkg)
    try:
        tokens = list(range(13))
        chain = _chain(tokens)
        router.digests.publish("r2", 4, {chain[2]: 3})
        router.digests.publish("r0", 4, {chain[0]: 1})
        assert set(_route(pkg, router, tokens, 8)) == {"r2"}
    finally:
        for r in reps:
            r.stop()


@pkgs
def test_tie_falls_back_to_pow2_spread(pkg):
    router, reps = _router(pkg)
    try:
        tokens = list(range(13))
        chain = _chain(tokens)
        router.digests.publish("r0", 4, {chain[1]: 2})
        router.digests.publish("r1", 4, {chain[1]: 2})
        assert set(_route(pkg, router, tokens, 24)) == {"r0", "r1"}
    finally:
        for r in reps:
            r.stop()


@pkgs
def test_no_match_routes_like_plain_pow2(pkg):
    router, reps = _router(pkg)
    try:
        router.digests.publish("r0", 4, {"deadbeef" * 4: 1})
        assert len(set(_route(pkg, router, list(range(13)), 30))) >= 2
    finally:
        for r in reps:
            r.stop()


@pkgs
def test_membership_change_prunes_directory(pkg):
    router, reps = _router(pkg)
    try:
        router.digests.publish("r1", 4, {"aa": 1})
        router.update_replicas(reps[:1])
        assert "r1" not in router.digests.snapshot()["replicas"]
    finally:
        for r in reps:
            r.stop()


@pkgs
def test_digests_flow_replica_to_router_over_long_poll(pkg):
    ctl_mod = _mods(pkg)["controller"]
    ctl = ctl_mod.ServeController(control_interval_s=0.02)
    router = ctl.deploy(ctl_mod.DeploymentConfig(name="digesty",
                                                 num_replicas=1),
                        factory=lambda: _echo)
    try:
        rep = router.replicas()[0]
        published = {"page_size": 128, "digests": {"ab" * 16: 2}}
        rep.prefix_digests = lambda: published
        state = ctl._deployments["digesty"]
        ctl._publish_prefix_digests(state)
        snap = router.digests.snapshot()
        assert snap["replicas"][rep.replica_id] == {"ab" * 16: 2}
        key = ctl_mod.PREFIX_DIGEST_KEY.format(deployment="digesty")
        updates = ctl.long_poll.listen_for_change({key: -1}, timeout_s=1.0)
        assert updates[key][1]["replicas"][rep.replica_id]
        sid = updates[key][0]
        ctl._publish_prefix_digests(state)
        assert ctl.long_poll.snapshot_ids().get(key) == sid
    finally:
        ctl.shutdown()


def test_llm_replica_publications_steer_shared_prefixes():
    """Two port LLM replicas behind the port's router; one serves a long
    prompt (its paged engine publishes the prompt's page), its digests
    reach the directory through the controller's publication, and every
    later request sharing that page is routed to it."""
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=3)
    dep = LLMDeployment("llama_tiny", model=tm, device="cpu", num_slots=2,
                        max_len=256, prompt_buckets=[32],
                        default_max_new_tokens=2, paged=True, page_size=128,
                        prefix_cache_size=4)
    ctl = t_controller.ServeController(control_interval_s=0.05)
    router = ctl.deploy(t_controller.DeploymentConfig(name="llm",
                                                      num_replicas=2),
                        factory=dep)
    try:
        holder, other = router.replicas()
        head = np.random.default_rng(4).integers(1, 500, 140).tolist()
        req = t_request.Request(model="llm", payload={"tokens": head},
                                slo_ms=60_000.0)
        assert holder.assign(req)
        req.future.result(timeout=120)
        pub = holder.prefix_digests()
        assert pub["page_size"] == 128 and len(pub["digests"]) == 1
        assert other.prefix_digests()["digests"] == {}
        ctl._publish_prefix_digests(ctl._deployments["llm"])
        chain = router.digests.chain_for({"tokens": head[:128] + [7, 8]})
        assert chain == [next(iter(pub["digests"]))]
        got = _route("torch", router, head[:128] + [9, 9, 9], 6)
        assert set(got) == {holder.replica_id}
    finally:
        ctl.shutdown()
