"""The port's binding of the C++ runtime substrate (``runtime/native.py``),
on the CPU.

The cases of ``tests/test_native.py`` run against the port's binding:
the shm queue (batch pop, drop when full, oversized items, a blocking pop
woken by a push, a producer in another process), the object store (LRU
eviction, immutability, a writer in another process), the KV store's
versions and long-poll watch, the actor pool (per-actor FIFO, parallel
actors, max_restarts, mailbox backpressure), the health table and the
``NativeKVStore`` adapter. Beside them: a queue and a store made by the
JAX package's binding are read and written by the port's over the same C
ABI, and the reverse; the library is built from ``native/src`` into
``build/torch_native/`` keyed by source and flags; no compiler, or a
failed build, raises with the compiler's words. Shared-memory names carry
the pid and a uuid, so parallel test workers never collide.
"""

import multiprocessing as mp
import os
import threading
import time
import uuid

import pytest

from ray_dynamic_batching_tpu_torch.runtime import native
from ray_dynamic_batching_tpu_torch.runtime.native import (
    ActorPool,
    HealthTable,
    KVStore,
    NativeQueue,
    ObjectStore,
    build_native,
)


@pytest.fixture(scope="module", autouse=True)
def _built():
    build_native()


def _qname(tag):
    return f"/rdbtq_{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


class TestBuild:
    def test_library_lives_under_build_torch_native(self):
        path = build_native()
        root = native._REPO_ROOT
        assert path.parent == root / "build" / "torch_native"
        assert path.name.startswith("librdb_native-") and path.exists()
        assert build_native() == path          # cached: no rebuild

    def test_key_follows_source_and_flags(self, monkeypatch):
        before = native.lib_path()
        monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ["-g"])
        assert native.lib_path() != before

    def test_failed_build_raises_with_compiler_output(self, tmp_path,
                                                      monkeypatch):
        bad = tmp_path / "broken.cc"
        bad.write_text("this is not C++;\n")
        monkeypatch.setattr(native, "_SOURCE", bad)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
            build_native()
        assert "broken.cc" in str(e.value) and "error" in str(e.value)
        assert not list((tmp_path / "out").glob("*.so"))

    def test_no_compiler_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
        with pytest.raises(RuntimeError, match="not found"):
            build_native(force=True)


class TestQueue:
    def test_push_pop_batch(self):
        q = NativeQueue(_qname("basic"), capacity=16, item_size=64)
        try:
            for i in range(5):
                assert q.push(f"item{i}".encode())
            assert len(q) == 5
            assert q.pop_batch(3) == [b"item0", b"item1", b"item2"]
            assert q.pop_batch(10) == [b"item3", b"item4"]
            assert q.pop_batch(10, timeout_ms=50) == []
        finally:
            q.close()

    def test_drop_when_full(self):
        q = NativeQueue(_qname("full"), capacity=2, item_size=16)
        try:
            assert q.push(b"a") and q.push(b"b")
            assert not q.push(b"c")
            assert q.dropped == 1
        finally:
            q.close()

    def test_item_too_large(self):
        q = NativeQueue(_qname("big"), capacity=2, item_size=8)
        try:
            with pytest.raises(ValueError):
                q.push(b"x" * 9)
        finally:
            q.close()

    def test_blocking_pop_wakes_on_push(self):
        q = NativeQueue(_qname("wake"), capacity=8, item_size=32)
        try:
            got = []
            t = threading.Thread(
                target=lambda: got.extend(q.pop_batch(4, timeout_ms=2000)))
            t.start()
            time.sleep(0.05)
            q.push(b"late")
            t.join(timeout=3)
            assert got == [b"late"]
        finally:
            q.close()

    def test_cross_process(self):
        name = _qname("xproc")
        q = NativeQueue(name, capacity=64, item_size=32)
        try:
            p = mp.get_context("spawn").Process(target=_producer_proc,
                                                args=(name, 10))
            p.start()
            items = []
            deadline = time.time() + 30
            while len(items) < 10 and time.time() < deadline:
                items.extend(q.pop_batch(10, timeout_ms=500))
            p.join(timeout=10)
            assert sorted(items) == sorted(f"p{i}".encode()
                                           for i in range(10))
        finally:
            q.close()


def _producer_proc(name, n):
    from ray_dynamic_batching_tpu_torch.runtime.native import NativeQueue

    q = NativeQueue(name, create=False)
    for i in range(n):
        q.push(f"p{i}".encode())
    q.close(unlink=False)


class TestObjectStore:
    def test_put_get_delete(self):
        s = ObjectStore(_qname("store"), capacity_bytes=1 << 16, max_objects=8)
        try:
            assert s.put(1, b"hello")
            assert s.put(2, b"world!" * 100)
            assert 1 in s and 2 in s
            assert s.get(1) == b"hello"
            assert s.get(99) is None
            with pytest.raises(KeyError):
                s.put(1, b"dup")
            assert s.delete(1)
            assert 1 not in s
            assert s.get(2) == b"world!" * 100
            assert s.used_bytes >= 600
        finally:
            s.close()

    def test_lru_eviction(self):
        s = ObjectStore(_qname("lru"), capacity_bytes=1000, max_objects=8)
        try:
            s.put(1, b"a" * 400)
            s.put(2, b"b" * 400)
            assert s.get(1) == b"a" * 400
            s.put(3, b"c" * 400)
            assert 2 not in s
            assert s.get(1) == b"a" * 400 and s.get(3) == b"c" * 400
            assert s.evictions == 1
        finally:
            s.close()

    def test_cross_process_visibility(self):
        name = _qname("storex")
        s = ObjectStore(name, capacity_bytes=1 << 16)
        try:
            p = mp.get_context("spawn").Process(target=_store_writer_proc,
                                                args=(name,))
            p.start()
            p.join(timeout=30)
            assert p.exitcode == 0
            assert s.get(42) == b"written-by-child"
        finally:
            s.close()


def _store_writer_proc(name):
    from ray_dynamic_batching_tpu_torch.runtime.native import ObjectStore

    s = ObjectStore(name, create=False)
    assert s.put(42, b"written-by-child")
    s.close(unlink=False)


class TestInterop:
    """The JAX package's binding and the port's, one C ABI: what one
    creates, the other opens and reads."""

    @pytest.fixture
    def j_native(self, monkeypatch):
        from ray_dynamic_batching_tpu.runtime import native as j_native

        # The JAX binding runs ``make`` into native/build/, which that
        # package's own tests may be rebuilding in another worker: load
        # it over the port's built library of the same source instead.
        monkeypatch.setattr(j_native, "_LIB_PATH", build_native())
        return j_native

    def test_jax_made_queue_and_store_read_by_the_port(self, j_native):
        qname, sname = _qname("jq"), _qname("js")
        jq = j_native.NativeQueue(qname, capacity=8, item_size=64)
        js = j_native.ObjectStore(sname, capacity_bytes=1 << 16)
        try:
            assert jq.push(b"from-jax") and js.put(7, b"payload-jax")
            tq = NativeQueue(qname, create=False)
            ts = ObjectStore(sname, create=False)
            try:
                assert tq.pop_batch(4, timeout_ms=100) == [b"from-jax"]
                assert ts.get(7) == b"payload-jax"
                assert tq.push(b"from-port") and ts.put(8, b"payload-port")
            finally:
                tq.close(unlink=False)
                ts.close(unlink=False)
            assert jq.pop_batch(4, timeout_ms=100) == [b"from-port"]
            assert js.get(8) == b"payload-port"
        finally:
            jq.close()
            js.close()

    def test_port_made_queue_read_by_jax(self, j_native):
        qname = _qname("tq")
        tq = NativeQueue(qname, capacity=8, item_size=64)
        try:
            assert tq.push(b"one") and tq.push(b"two")
            jq = j_native.NativeQueue(qname, create=False)
            try:
                assert jq.pop_batch(4, timeout_ms=100) == [b"one", b"two"]
            finally:
                jq.close(unlink=False)
        finally:
            tq.close()


class TestKV:
    def test_put_get_versions(self):
        kv = KVStore()
        try:
            v1 = kv.put("a", b"1")
            v2 = kv.put("a", b"2")
            assert v2 > v1
            assert kv.get("a") == (b"2", v2)
            assert kv.get("missing") is None
            assert sorted(kv.keys()) == ["a"]
            kv.put("ab", b"x")
            kv.put("b", b"y")
            assert sorted(kv.keys("a")) == ["a", "ab"]
            assert kv.delete("a")
            assert kv.get("a") is None
        finally:
            kv.close()

    def test_watch_long_poll(self):
        kv = KVStore()
        try:
            v = kv.put("cfg", b"v1")
            assert kv.watch("cfg", v, timeout_ms=80) == 0
            result = {}
            t = threading.Thread(target=lambda: result.update(
                ver=kv.watch("cfg", v, timeout_ms=3000)))
            t.start()
            time.sleep(0.05)
            v2 = kv.put("cfg", b"v2")
            t.join(timeout=4)
            assert result["ver"] == v2
            t2 = threading.Thread(target=lambda: result.update(
                d=kv.watch("cfg", v2, 3000)))
            t2.start()
            time.sleep(0.05)
            kv.delete("cfg")
            t2.join(timeout=4)
            assert result["d"] > v2
        finally:
            kv.close()


class TestActors:
    def test_per_actor_fifo_order(self):
        pool = ActorPool(n_threads=4)
        try:
            seen, lock = [], threading.Lock()

            def handler(msg):
                with lock:
                    seen.append(msg)

            a = pool.register("a", handler)
            for i in range(50):
                assert pool.post(a, f"{i}".encode())
            assert pool.drain(5000)
            assert seen == [f"{i}".encode() for i in range(50)]
            assert pool.processed(a) == 50
        finally:
            pool.close()

    def test_parallel_across_actors(self):
        pool = ActorPool(n_threads=4)
        try:
            barrier = threading.Barrier(3, timeout=5)
            ids = [pool.register(f"p{i}", lambda _m: barrier.wait())
                   for i in range(3)]
            for aid in ids:
                pool.post(aid, b"go")
            assert pool.drain(5000)
        finally:
            pool.close()

    def test_max_restarts_kills_actor(self):
        pool = ActorPool(n_threads=2)
        try:
            def bad(_msg):
                raise RuntimeError("boom")

            a = pool.register("bad", bad, max_restarts=2)
            for _ in range(3):
                pool.post(a, b"x")
                pool.drain(2000)
            assert pool.failed(a) == 3 and pool.is_dead(a)
            with pytest.raises(KeyError):
                pool.post(a, b"more")
        finally:
            pool.close()

    def test_mailbox_backpressure(self):
        pool = ActorPool(n_threads=1)
        release = threading.Event()
        try:
            a = pool.register("slow", lambda _m: release.wait(5),
                              mailbox_cap=2)
            pool.post(a, b"0")
            time.sleep(0.05)
            assert pool.post(a, b"1") and pool.post(a, b"2")
            assert not pool.post(a, b"3")
            release.set()
            assert pool.drain(5000)
        finally:
            release.set()
            pool.close()


class TestHealth:
    def test_staleness(self):
        h = HealthTable(timeout_s=0.15)
        try:
            h.report("node1")
            h.report("node2")
            assert h.alive_count == 2 and h.dead_nodes() == []
            time.sleep(0.2)
            h.report("node2")
            assert sorted(h.dead_nodes()) == ["node1"]
            assert h.alive_count == 1
            assert h.remove("node1")
            assert h.dead_nodes() == []
        finally:
            h.close()


class TestNativeKVAdapter:
    def test_string_api_and_watch(self):
        from ray_dynamic_batching_tpu_torch.runtime.kv import NativeKVStore

        kv = NativeKVStore()
        try:
            kv.put("app/state", "v1")
            assert kv.get("app/state") == "v1"
            _, ver = kv.get_versioned("app/state")
            assert kv.watch("app/state", ver, timeout_ms=50) == 0
            kv.put("app/state", "v2")
            assert kv.watch("app/state", ver, timeout_ms=1000) > ver
            assert kv.keys("app/") == ["app/state"]
            assert kv.delete("app/state")
            assert kv.get("app/state") is None
        finally:
            kv.close()
