"""The ranks of a tensor-parallel mesh: one process per device.

This module has no counterpart in the JAX package. There a single
controller drives every chip of a mesh: GSPMD partitions one program over
the devices and inserts the collectives, so a sharded ``DecodeEngine`` is
one Python object. PyTorch runs one process per rank instead, and this
module keeps those processes in step.

- **The caller's process is rank 0** (the leader). :class:`World` spawns
  ranks ``1..N-1`` (followers) with the ``spawn`` start method, gives each
  its device, and joins them to one process group over the mesh's
  devices: NCCL or gloo, as the caller names it (``parallel/mesh.py``
  picks the default and refuses NCCL on a device listed twice). The
  group's rendezvous runs through a ``TCPStore`` on ``127.0.0.1`` at a
  port the operating system picks, so two worlds never collide.
- **Axis groups.** Beside the world's group, every rank joins one group
  for each mesh axis above 1 and one over ``dp`` x ``sp`` together
  (:data:`GROUP_AXES`): the ranks that share its coordinates on the
  other axes (:func:`line_of`; ranks are laid out over ``AXIS_ORDER``
  row-major, :func:`coords_of`). Where a set spans the whole world its
  group is the world's.
- **Control runs over pipes, data over the group.** The leader sends
  each follower a pickled message over its own pipe: a module-level
  function and its arguments. A follower blocks on its pipe, so an idle
  world costs nothing and never times out, and a leader that dies ends
  its followers (the pipe closes). The collectives a function issues run
  on the process group, with the world's timeout (120 s by default): a
  rank that hangs fails the call instead of wedging the process.
- **The invariant:** every rank runs the same programs in the same order
  on the same host inputs. :meth:`World.call` runs a function on every
  rank and gathers what each returns (model and engine builds, reports);
  :meth:`World.mirror` runs an engine method on every follower's twin of
  an engine, then the leader's own. Both hold the world's lock for the
  whole call, so the engines of several length buckets sharing one world
  issue their collectives one program at a time. Admission, pages,
  sampling parameters and results belong to rank 0.
- **Per-rank objects by handle.** What a mirrored call returns (a row
  cache, the logits of a chunk) lives on every rank, each its own. The
  leader registers its outputs by identity under a handle ``(message,
  position)``; a follower binds its outputs to the same handle. A later
  argument that is a registered object travels as its handle, any other
  tensor by value. When the leader's object dies (or is registered
  again), the next message releases the handle on every follower.

A follower whose mirrored call raises reports the traceback over its
pipe and exits: its peers' collectives then fail, and the leader raises
:class:`WorldError` with the follower's traceback. :meth:`World.shutdown`
stops every follower and joins it (terminating one that does not exit);
a world is also shut down when its leader exits.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import multiprocessing as mp
import pickle
import threading
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: Seconds a collective of a world's process group may take.
TIMEOUT_S = 120.0


class WorldError(RuntimeError):
    """A rank of a world failed, or the world was used after it failed or
    was shut down."""


class _Ref:
    """A per-rank object, named by its handle."""

    __slots__ = ("handle",)

    def __init__(self, handle) -> None:
        self.handle = handle


class _OnDevice:
    """A device tensor of the leader, sent by value: each follower puts it
    on its own device."""

    __slots__ = ("tensor",)

    def __init__(self, tensor: torch.Tensor) -> None:
        self.tensor = tensor


def _registrable(x: Any) -> bool:
    """Outputs bound to handles: tensors and cache dataclasses. The rule is
    the same on every rank, so handles line up."""
    return isinstance(x, torch.Tensor) or (
        dataclasses.is_dataclass(x) and not isinstance(x, type))


def _items(out: Any) -> Sequence[Any]:
    return out if isinstance(out, (tuple, list)) else (out,)


#: The axis sets a multi-axis mesh gives a process group of their own:
#: each axis, and the data axes together (the gradient sum of training).
GROUP_AXES = (("dp",), ("pp",), ("sp",), ("tp",), ("ep",), ("dp", "sp"))


def coords_of(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """A rank's coordinate on every axis: the mesh lays its ranks out over
    ``AXIS_ORDER`` row-major, as the reference reshapes its devices."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import AXIS_ORDER

    out = {}
    for ax in reversed(AXIS_ORDER):
        out[ax] = rank % shape[ax]
        rank //= shape[ax]
    return out


def line_of(rank: int, shape: Dict[str, int], axes: Sequence[str]
            ) -> List[int]:
    """The ranks that share ``rank``'s coordinates off ``axes``, in the
    order of their linear index over ``axes``: the members of its group
    over those axes."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import AXIS_ORDER

    mine = coords_of(rank, shape)
    n = 1
    for ax in AXIS_ORDER:
        n *= shape[ax]
    members = [r for r in range(n)
               if all(coords_of(r, shape)[ax] == mine[ax]
                      for ax in AXIS_ORDER if ax not in axes)]
    return members


def make_axis_groups(store, rank: int, shape: Dict[str, int], backend: str,
                     device: torch.device, timeout: datetime.timedelta,
                     world_group) -> Dict[tuple, Any]:
    """This rank's process group over each axis set of ``GROUP_AXES``
    whose size is above 1: the world's own group where the set spans every
    rank, else a group of the rank's line (every rank builds its groups in
    the same order, each line on a store prefix of its own)."""
    size = 1
    for n in shape.values():
        size *= n
    groups: Dict[tuple, Any] = {}
    for axes in GROUP_AXES:
        n = 1
        for ax in axes:
            n *= shape[ax]
        if n == 1:
            continue
        if n == size:
            groups[axes] = world_group
            continue
        members = line_of(rank, shape, axes)
        groups[axes] = make_group(
            store, members.index(rank), n, backend, device, timeout,
            prefix="/".join(axes) + "/" + "-".join(map(str, members)))
    return groups


def make_group(store, rank: int, size: int, backend: str,
               device: torch.device, timeout: datetime.timedelta,
               prefix: str = "tp"):
    """A process group of ``size`` ranks on ``store`` (not registered as
    torch's default group, so one process may hold several worlds)."""
    store = dist.PrefixStore(f"{prefix}/", store)
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        opts._devices = [
            dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
        return dist.ProcessGroupGloo(store, rank, size, opts)
    if backend == "nccl":
        torch.cuda.set_device(device)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")


class RankContext:
    """What a function run on a rank sees: the rank's mesh, its named
    objects (models, engines) and its handles."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.rank = mesh.rank
        self.objects: Dict[Any, Any] = {}
        self.handles: Dict[Any, Any] = {}

    def decode(self, a: Any) -> Any:
        if isinstance(a, _Ref):
            return self.handles[a.handle]
        if isinstance(a, _OnDevice):
            return a.tensor.to(self.mesh.device)
        if isinstance(a, (tuple, list)):
            return type(a)(self.decode(x) for x in a)
        return a

    def bind(self, out: Any, seq: int) -> None:
        for i, x in enumerate(_items(out)):
            if _registrable(x):
                self.handles[(seq, i)] = x


def _mirror_body(ctx: RankContext, seq: int, key: Any, attr: str,
                 args: tuple) -> None:
    """A follower's half of :meth:`World.mirror`."""
    out = getattr(ctx.objects[key], attr)(*ctx.decode(args))
    ctx.bind(out, seq)


def _follower_main(rank: int, size: int, port: int, devices: List[str],
                   shape: Dict[str, int], backend: str, timeout_s: float,
                   conn) -> None:
    """A follower: join the group, then run what the leader sends until it
    says stop or its pipe closes."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import Mesh

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # The ranks share the host's cores with rank 0 (and, on one card, the
    # card): one intra-op thread each.
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", port, size, False, timeout=timeout)
    group = make_group(store, rank, size, backend, device, timeout)
    groups = make_axis_groups(store, rank, shape, backend, device, timeout,
                              group)
    mesh = Mesh(shape, [torch.device(d) for d in devices], rank, backend,
                group, groups=groups)
    ctx = RankContext(mesh)
    while True:
        try:
            msg = conn.recv_bytes()
        except (EOFError, OSError):
            break              # the leader is gone
        seq, releases, fn, args, collect = pickle.loads(msg)
        for h in releases:
            ctx.handles.pop(h, None)
        if fn is None:
            break
        try:
            out = fn(ctx, seq, *args)
        except BaseException:  # noqa: BLE001 — reported to the leader
            tb = traceback.format_exc()
            conn.send(("err", tb))
            if not collect:
                break          # a mirrored call left the group out of step
            continue
        if collect:
            conn.send(("ok", out))
    ctx.objects.clear()
    ctx.handles.clear()
    try:
        conn.close()
    except OSError:
        pass


class World:
    """Rank 0 of a mesh and the processes of ranks 1..N-1 (see the module
    docstring). ``devices[r]`` is rank r's device; ``shape`` the mesh's
    axis sizes."""

    def __init__(self, devices: Sequence[torch.device], shape: Dict[str, int],
                 backend: str) -> None:
        from ray_dynamic_batching_tpu_torch.parallel.mesh import Mesh

        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.backend = backend
        self.timeout_s = TIMEOUT_S
        self.lock = threading.RLock()
        self.failed: Optional[str] = None
        self.closed = False
        self._seq = 0
        self._next_key = 0
        # id(leader object) -> (weakref, handle); handles to release.
        self._ids: Dict[int, tuple] = {}
        self._releases: List[Any] = []
        if any(d.type == "cuda" for d in self.devices):
            # One build before any rank exists: the followers load the
            # libraries rank 0 wrote (ops/_build.py), none runs nvcc.
            from ray_dynamic_batching_tpu_torch.ops import _build

            _build.build()
        timeout = datetime.timedelta(seconds=self.timeout_s)
        self._store = dist.TCPStore("127.0.0.1", 0, self.size, True,
                                    timeout=timeout, wait_for_workers=False)
        ctx = mp.get_context("spawn")
        self._conns = []
        self._procs = []
        names = [str(d) for d in self.devices]
        for r in range(1, self.size):
            mine, theirs = ctx.Pipe(duplex=True)
            p = ctx.Process(
                target=_follower_main, name=f"rdb-rank{r}", daemon=True,
                args=(r, self.size, self._store.port, names, dict(shape),
                      backend, self.timeout_s, theirs))
            p.start()
            theirs.close()
            self._conns.append(mine)
            self._procs.append(p)
        try:
            group = make_group(self._store, 0, self.size, backend,
                               self.devices[0], timeout)
            groups = make_axis_groups(self._store, 0, dict(shape), backend,
                                      self.devices[0], timeout, group)
        except BaseException:
            self._kill()
            raise
        self.mesh = Mesh(dict(shape), self.devices, 0, backend, group,
                         world=self, groups=groups)
        self.ctx = RankContext(self.mesh)
        self._finalizer = weakref.finalize(self, _stop_procs, self._conns,
                                           self._procs)
        atexit.register(self._finalizer)

    # --- the protocol ------------------------------------------------------
    def new_key(self, kind: str) -> str:
        """A fresh name for a per-rank object (model, engine)."""
        with self.lock:
            self._next_key += 1
            return f"{kind}{self._next_key}"

    def _check(self) -> None:
        if self.closed:
            raise WorldError("the world was shut down")
        if self.failed:
            raise WorldError(f"the world failed earlier: {self.failed}")

    def _sweep(self) -> List[Any]:
        for oid, (ref, h) in list(self._ids.items()):
            if ref() is None:
                del self._ids[oid]
                self._releases.append(h)
        out, self._releases = self._releases, []
        return out

    def _send(self, fn, args: tuple, collect: bool) -> int:
        self._seq += 1
        msg = pickle.dumps((self._seq, self._sweep(), fn, args, collect))
        for r, conn in enumerate(self._conns, start=1):
            try:
                conn.send_bytes(msg)
            except (OSError, ValueError) as e:
                self._fail(f"rank {r} is gone ({e!r}): "
                           f"{self._follower_errors()}")
        return self._seq

    def encode(self, a: Any) -> Any:
        """An argument as it travels to the followers: a registered object
        as its handle, a device tensor by value, anything else as is."""
        if isinstance(a, (tuple, list)):
            return type(a)(self.encode(x) for x in a)
        entry = self._ids.get(id(a))
        if entry is not None and entry[0]() is a:
            return _Ref(entry[1])
        if isinstance(a, torch.Tensor):
            return _OnDevice(a.cpu()) if a.device.type != "cpu" else a
        if _registrable(a):
            raise TypeError(
                f"{type(a).__name__} is a per-rank object the followers do "
                "not hold: only what a mirrored call returned can be passed")
        return a

    def register(self, out: Any, seq: int) -> None:
        for i, x in enumerate(_items(out)):
            if not _registrable(x):
                continue
            old = self._ids.get(id(x))
            if old is not None:
                self._releases.append(old[1])
            self._ids[id(x)] = (weakref.ref(x), (seq, i))

    def _replies(self) -> List[Any]:
        out = []
        for r, conn in enumerate(self._conns, start=1):
            try:
                if not conn.poll(self.timeout_s):
                    self._fail(
                        f"rank {r} did not answer in {self.timeout_s} s")
                kind, value = conn.recv()
            except (EOFError, OSError) as e:
                self._fail(f"rank {r} exited before answering ({e!r})")
            out.append((r, kind, value))
        return out

    def _fail(self, why: str) -> None:
        self.failed = why
        raise WorldError(why)

    def _follower_errors(self) -> str:
        msgs = []
        for r, conn in enumerate(self._conns, start=1):
            try:
                while conn.poll(0.5):
                    kind, value = conn.recv()
                    if kind == "err":
                        msgs.append(f"rank {r}:\n{value}")
            except (EOFError, OSError):
                msgs.append(f"rank {r}: exited")
        return "\n".join(msgs)

    def call(self, fn: Callable, *args: Any) -> List[Any]:
        """``fn(ctx, seq, *args)`` on every rank (this process first
        sends, then runs its own); returns each rank's result in rank
        order. A rank that raises makes the call raise
        :class:`WorldError`."""
        with self.lock:
            self._check()
            seq = self._send(fn, args, True)
            try:
                mine = fn(self.ctx, seq, *args)
            except BaseException as e:
                errs = self._collect_after_failure()
                self.failed = f"rank 0: {e!r}"
                raise WorldError(f"rank 0 failed: {e!r}{errs}") from e
            results = [mine]
            errors = []
            for r, kind, value in self._replies():
                if kind == "err":
                    errors.append(f"rank {r}:\n{value}")
                results.append(value)
            if errors:
                self.failed = "\n".join(errors)
                raise WorldError(self.failed)
            return results

    def _collect_after_failure(self) -> str:
        try:
            replies = self._replies()
        except WorldError as e:
            return f"; {e}"
        errs = [f"rank {r}:\n{v}" for r, k, v in replies if k == "err"]
        return ("; followers:\n" + "\n".join(errs)) if errs else ""

    def mirror(self, key: Any, attr: str, local: Callable, args: tuple):
        """``getattr(obj, attr)(*args)`` on every follower's object ``key``
        (arguments encoded: see :meth:`encode`), then ``local(*args)``
        here; outputs are bound to this message's handles on every rank.
        Returns the leader's output."""
        with self.lock:
            self._check()
            enc = self.encode(args)
            seq = self._send(_mirror_body, (key, attr, enc), False)
            try:
                out = local(*args)
            except BaseException as e:
                # The ranks may be out of step now: nothing more runs.
                errs = self._follower_errors()
                self.failed = f"{attr}: {e!r}" + (f"; {errs}" if errs else "")
                if errs:
                    raise WorldError(
                        f"{attr} failed on a follower:\n{errs}") from e
                raise
            self.register(out, seq)
            return out

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Stop every follower and join it (terminating a straggler); the
        world is unusable afterwards. Idempotent."""
        with self.lock:
            if self.closed:
                return
            self.closed = True
            _stop_procs(self._conns, self._procs, timeout_s)
            self._finalizer.detach()
            try:
                atexit.unregister(self._finalizer)
            except Exception:  # noqa: BLE001 — best effort at exit
                pass
            self._ids.clear()
            self.ctx.objects.clear()
            self.ctx.handles.clear()
            groups = [getattr(self.mesh, "group", None)]
            groups += list(getattr(self.mesh, "groups", {}).values())
            for group in {id(g): g for g in groups if g is not None}.values():
                if hasattr(group, "shutdown"):
                    try:
                        group.shutdown()
                    except Exception:  # noqa: BLE001 — peers are gone
                        pass
            self.mesh.group = None
            self.mesh.groups = {}

    def _kill(self) -> None:
        _stop_procs(self._conns, self._procs, 5.0)


def _stop_procs(conns, procs, timeout_s: float = 30.0) -> None:
    """Tell each follower to stop (closing its pipe), then join it,
    terminating and finally killing one that does not exit."""
    stop = pickle.dumps((0, [], None, (), False))
    for conn in conns:
        try:
            conn.send_bytes(stop)
        except (OSError, ValueError):
            pass
        try:
            conn.close()
        except OSError:
            pass
    for p in procs:
        p.join(timeout_s)
        if p.is_alive():
            p.terminate()
            p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join(5.0)


def _attach_body(ctx: RankContext, seq: int, key: str, model_key: str,
                 kwargs: dict, draft_key: Optional[str]) -> None:
    """A follower builds its twin of rank 0's engine ``key`` over its
    shard ``model_key`` (and its draft's shard ``draft_key``: the same
    object for a self-draft); its queue stays empty (rank 0 admits)."""
    if ctx.rank == 0:
        return None
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue

    model = ctx.objects[model_key]
    draft = None if draft_key is None else ctx.objects[draft_key]
    ctx.objects[key] = DecodeEngine(
        model, RequestQueue(f"{model.name}:{key}", max_len=1),
        mesh=ctx.mesh, draft_model=draft, **kwargs)
    return None


def attach_engine(world: World, key: str, model_key: str,
                  kwargs: dict, draft_key: Optional[str] = None) -> None:
    """Every follower builds its twin of rank 0's engine ``key`` with the
    same constructor arguments, over its shards of the model and the
    draft."""
    world.call(_attach_body, key, model_key, kwargs, draft_key)


def _drop_body(ctx: RankContext, seq: int, keys: tuple) -> None:
    for key in keys:
        obj = ctx.objects.pop(key, None)
        if ctx.rank != 0 and hasattr(obj, "release_buffers"):
            obj.release_buffers()


def drop_objects(world: World, *keys: str) -> None:
    """Every rank forgets its objects ``keys`` (a follower's engine twin
    releases its buffers first)."""
    world.call(_drop_body, keys)
