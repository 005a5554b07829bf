"""Placement groups — gang-scheduling chips for replicas and meshes.

Re-creates the reference's placement groups (``python/ray/util/placement_group.py:145``
— bundles of resources placed by strategy; native scheduling in
``gcs_placement_group_scheduler.cc`` and the bundle-aware policies under
``raylet/scheduling/policy/``) and the Serve deployment scheduler's
spread/compact choice (``serve/_private/deployment_scheduler.py``), for TPU
topology: a "node" is a host (process) and the resource is its chips.

A bundle reserves ``chips`` on one node; a group places all its bundles by
strategy:

- ``PACK``         prefer few nodes (co-locate; best-effort)
- ``SPREAD``       prefer distinct nodes (best-effort round-robin)
- ``STRICT_PACK``  all bundles on ONE node, or the group fails
- ``STRICT_SPREAD`` every bundle on a DIFFERENT node, or the group fails

Own copy of ``ray_dynamic_batching_tpu/parallel/placement.py`` with its
import paths rewritten. Trimmed: the default device list is the visible
CUDA devices (:func:`cuda_devices`: one :class:`CudaDevice` per card, each
with ``process_index`` 0 — one host — and its total memory as the HBM
figure); an explicit device list of any objects with ``process_index``
works as in the reference. :func:`pin_slice` of more than one chip builds
the slice's tensor-parallel mesh over the bundle's devices
(``parallel/mesh.build_mesh``), as the reference does.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence

from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("placement")

PACK = "PACK"
SPREAD = "SPREAD"
STRICT_PACK = "STRICT_PACK"
STRICT_SPREAD = "STRICT_SPREAD"
_STRATEGIES = (PACK, SPREAD, STRICT_PACK, STRICT_SPREAD)


@dataclasses.dataclass(frozen=True)
class CudaDevice:
    """One visible CUDA card as placement sees it: the attributes the
    manager reads (``id``, ``process_index``, ``platform``,
    ``memory_stats``) plus the ``torch.device`` a replica builds on."""

    id: int
    process_index: int = 0
    platform: str = "gpu"
    hbm_bytes: int = 0

    @property
    def torch_device(self):
        import torch

        return torch.device("cuda", self.id)

    def memory_stats(self) -> Dict[str, int]:
        return {"bytes_limit": self.hbm_bytes}


def cuda_devices() -> List[CudaDevice]:
    """The visible CUDA devices (none without a card)."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [
        CudaDevice(id=i, hbm_bytes=int(
            torch.cuda.get_device_properties(i).total_memory))
        for i in range(torch.cuda.device_count())
    ]


def mesh_chips(mesh: str) -> int:
    """Chip count of a mesh-shape string (``"1x4"`` -> 4); a malformed
    shape raises ``ValueError``."""
    try:
        dims = [int(d) for d in str(mesh).lower().split("x")]
    except ValueError:
        dims = []
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"malformed mesh shape {mesh!r} (want e.g. '1x4')")
    n = 1
    for d in dims:
        n *= d
    return n


class PlacementError(RuntimeError):
    """Group infeasible under its strategy (ref: PG stays pending; here we
    fail fast — the caller owns retry policy)."""


@dataclasses.dataclass(frozen=True)
class Bundle:
    chips: int = 1


@dataclasses.dataclass
class PlacementGroup:
    group_id: int
    bundles: List[Bundle]
    strategy: str
    # parallel to bundles: the devices reserved for each
    assignments: List[List[Any]] = dataclasses.field(default_factory=list)

    def bundle_devices(self, index: int) -> List[Any]:
        return list(self.assignments[index])

    @property
    def total_chips(self) -> int:
        return sum(b.chips for b in self.bundles)


def pin_slice(
    manager: "PlacementManager",
    mesh_shape: str,
    strategy: str = STRICT_PACK,
):
    """Pin one ``(model, mesh_shape)`` schedulable unit to silicon
    (reference ``placement.py:70-98``): reserve a
    ``mesh_chips(mesh_shape)``-wide chip SET as a single gang bundle and
    build its TP mesh from exactly those devices. Returns ``(group,
    mesh)``; ``mesh`` is None for a 1-chip shape (callers pin the single
    device instead — the classic path). ``STRICT_PACK`` by default: a TP
    slice's collectives must not straddle hosts. Release the reservation
    with ``manager.remove(group)`` and end the mesh's ranks with
    ``mesh.shutdown()`` when the slice dies. The mesh takes
    ``parallel/mesh.build_mesh``'s default backend: NCCL when every rank
    has its own card, gloo on CPU devices."""
    chips = mesh_chips(mesh_shape)
    pg = manager.create([Bundle(chips=chips)], strategy=strategy)
    if chips == 1:
        return pg, None
    from ray_dynamic_batching_tpu_torch.parallel.mesh import (
        MeshConfig,
        build_mesh,
    )

    try:
        mesh = build_mesh(MeshConfig(tp=chips), pg.bundle_devices(0))
    except BaseException:
        manager.remove(pg)
        raise
    return pg, mesh


class PlacementManager:
    """Chip accounting + strategy placement over the visible devices.

    Nodes are derived from ``device.process_index`` (one node per host —
    exactly the reference's node granularity). A manager instance owns its
    reservations; groups from the same manager never overlap chips.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None):
        devices = list(devices if devices is not None else cuda_devices())
        self._nodes: Dict[int, List[Any]] = {}
        for d in devices:
            self._nodes.setdefault(int(d.process_index), []).append(d)
        self._free: Dict[int, List[Any]] = {
            n: list(ds) for n, ds in self._nodes.items()
        }
        self._groups: Dict[int, PlacementGroup] = {}
        self._next_id = itertools.count(1)
        self._lock = threading.Lock()
        # HBM totals are static per device: query the backend ONCE here,
        # not per resource_view() poll under the lock.
        self._node_hbm: Dict[int, int] = {}
        for n, ds in self._nodes.items():
            hbm = 0
            for d in ds:
                try:
                    hbm += int(d.memory_stats().get("bytes_limit", 0))
                except Exception:  # noqa: BLE001 — CPU devices: no HBM
                    pass
            self._node_hbm[n] = hbm

    # --- introspection ----------------------------------------------------
    def nodes(self) -> Dict[int, int]:
        """node id -> total chips."""
        return {n: len(ds) for n, ds in self._nodes.items()}

    def free_chips(self) -> Dict[int, int]:
        with self._lock:
            return {n: len(ds) for n, ds in self._free.items()}

    def groups(self) -> List[PlacementGroup]:
        with self._lock:
            return list(self._groups.values())

    def resource_view(self) -> Dict[str, Any]:
        """Cluster resource snapshot (ref ``gcs_resource_manager.cc`` — the
        GCS-side node/resource view the dashboard and autoscaler read):
        per-node chip totals, free counts, HBM where the backend reports
        it, and live reservations."""
        with self._lock:
            nodes: Dict[str, Any] = {
                str(n): {
                    "chips_total": len(devs),
                    "chips_free": len(self._free[n]),
                    "platform": devs[0].platform if devs else "none",
                    "hbm_bytes_total": self._node_hbm.get(n, 0),
                }
                for n, devs in self._nodes.items()
            }
            reservations = [
                {
                    "group_id": pg.group_id,
                    "strategy": pg.strategy,
                    "chips": pg.total_chips,
                    # str keys, same namespace as the nodes map
                    "nodes": sorted({
                        str(int(d.process_index))
                        for a in pg.assignments for d in a
                    }),
                }
                for pg in self._groups.values()
            ]
        return {"nodes": nodes, "reservations": reservations}

    # --- placement --------------------------------------------------------
    def create(self, bundles: Sequence[Bundle],
               strategy: str = PACK) -> PlacementGroup:
        """Reserve chips for every bundle atomically (all-or-nothing, like
        the reference's gang placement)."""
        if strategy not in _STRATEGIES:
            raise ValueError(
                f"unknown strategy {strategy!r}; one of {_STRATEGIES}"
            )
        bundles = [
            b if isinstance(b, Bundle) else Bundle(**b) for b in bundles
        ]
        if not bundles or any(b.chips <= 0 for b in bundles):
            raise ValueError("bundles must be non-empty with chips > 0")
        with self._lock:
            assignments = self._place(bundles, strategy)
            # commit
            for devs in assignments:
                for d in devs:
                    self._free[int(d.process_index)].remove(d)
            pg = PlacementGroup(
                group_id=next(self._next_id),
                bundles=list(bundles),
                strategy=strategy,
                assignments=assignments,
            )
            self._groups[pg.group_id] = pg
            logger.info(
                "placed group %d: %s over nodes %s", pg.group_id, strategy,
                sorted({int(d.process_index) for a in assignments for d in a}),
            )
            return pg

    def remove(self, pg: PlacementGroup) -> None:
        """Release the group's chips (ref remove_placement_group)."""
        with self._lock:
            if self._groups.pop(pg.group_id, None) is None:
                return
            for devs in pg.assignments:
                for d in devs:
                    self._free[int(d.process_index)].append(d)

    # --- strategies (lock held) -------------------------------------------
    def _place(self, bundles: List[Bundle], strategy: str
               ) -> List[List[Any]]:
        free = {n: list(ds) for n, ds in self._free.items()}

        def free_desc() -> str:
            # lock is held: errors must never call self.free_chips() (it
            # re-acquires the non-reentrant lock -> deadlock). Report both
            # the committed state and the working state mid-request, since
            # nothing commits on failure and either alone misleads.
            committed = {n: len(ds) for n, ds in self._free.items()}
            working = {n: len(ds) for n, ds in free.items()}
            if committed == working:
                return f"free: {committed}"
            return (f"free: {committed}, after earlier bundles of this "
                    f"request: {working}")

        def take(node: int, k: int) -> List[Any]:
            out = free[node][:k]
            free[node] = free[node][k:]
            return out

        if strategy == STRICT_PACK:
            need = sum(b.chips for b in bundles)
            for node in sorted(free, key=lambda n: len(free[n])):
                if len(free[node]) >= need:
                    return [take(node, b.chips) for b in bundles]
            raise PlacementError(
                f"STRICT_PACK: no node has {need} free chips "
                f"({free_desc()})"
            )

        if strategy == STRICT_SPREAD:
            if len(bundles) > len(free):
                raise PlacementError(
                    f"STRICT_SPREAD: {len(bundles)} bundles > "
                    f"{len(free)} nodes"
                )
            # largest bundles first onto the emptiest fitting nodes
            order = sorted(range(len(bundles)),
                           key=lambda i: -bundles[i].chips)
            assignment: List[Optional[List[Any]]] = [None] * len(bundles)
            used = set()
            for i in order:
                fit = [n for n in free
                       if n not in used and len(free[n]) >= bundles[i].chips]
                if not fit:
                    raise PlacementError(
                        f"STRICT_SPREAD: no distinct node fits bundle "
                        f"{bundles[i]} (free: {free_desc()})"
                    )
                node = max(fit, key=lambda n: len(free[n]))
                used.add(node)
                assignment[i] = take(node, bundles[i].chips)
            return assignment  # type: ignore[return-value]

        if strategy == PACK:
            # fill the fullest-feasible node first (compact)
            out = []
            for b in bundles:
                fit = [n for n in free if len(free[n]) >= b.chips]
                if not fit:
                    raise PlacementError(
                        f"PACK: no node fits bundle {b} "
                        f"({free_desc()})"
                    )
                node = min(fit, key=lambda n: len(free[n]))
                out.append(take(node, b.chips))
            return out

        # SPREAD: emptiest node first, best-effort distinctness
        out = []
        for b in bundles:
            fit = [n for n in free if len(free[n]) >= b.chips]
            if not fit:
                raise PlacementError(
                    f"SPREAD: no node fits bundle {b} "
                    f"({free_desc()})"
                )
            node = max(fit, key=lambda n: len(free[n]))
            out.append(take(node, b.chips))
        return out
