"""Checkpoint / resume for model weights, in the JAX package's format.

Port of ``ray_dynamic_batching_tpu/runtime/checkpoint.py`` without JAX.
The on-disk format is the reference's, kept exactly, so a checkpoint one
package writes restores in the other:

- ``leaves.npz``: one array per leaf, keyed by the tree's '/'-joined path
  (``utils/pytree.py``, the key order of ``jax.tree_util``);
- ``manifest.json``: ``keys`` (flatten order), ``treedef`` (the structure
  as JAX prints it) and ``dtypes`` (each leaf's dtype name);
- a bfloat16 leaf is stored as raw two-byte ``|V2`` items with
  ``"bfloat16"`` in ``dtypes``: written here through a ``torch.int16``
  view and read back with ``.view(torch.bfloat16)``, never through
  numpy's float types (which have no bfloat16);
- a save commits by rename (``<dir>.tmp`` -> ``<dir>``, an existing one
  moved to ``<dir>.old`` first and removed after).

Leaves may be torch tensors (any device), numpy arrays or Python numbers;
a restore returns torch tensors, cast to the target leaf's dtype, on
``device`` (default the CPU). ``shardings`` (a tree of
:class:`~ray_dynamic_batching_tpu_torch.parallel.mesh.LeafShard` over the
saved arrays' axes, e.g. from :func:`checkpoint_shardings`) keeps a
rank's slice of each sharded leaf.

For a language model the tree saved and restored is the JAX params tree
(``{"params": {...}}``, flax layouts): ``models/convert.py``'s
``params_to_flax`` makes it from a built model and ``params_from_flax``
loads it back.

:class:`CheckpointManager` keeps the reference's step directories
(``root/step_<N>/``), ``metadata.json`` and keep-last-N gc.
:func:`save_train_state` / :func:`restore_train_state` are the
reference's (``{"params": ..., "opt_state": ...}`` under one step, the
step in the metadata). Given ``model=``, they take and give the port's
train state (``parallel/train.py``: f32 params and optax-shaped moments
keyed by port names) and store it as the JAX package does — the flax
params tree and optax's state (``opt_state/0/.count``,
``opt_state/0/.mu/params/...``) through ``models/convert.py`` — so a
train state saved by either package resumes in the other.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.utils.logging import get_logger
from ray_dynamic_batching_tpu_torch.utils.pytree import (
    flatten_with_paths,
    nest_paths,
    treedef_str,
    unflatten_like,
)

logger = get_logger("checkpoint")

_STEP_DIR = re.compile(r"^step_(\d+)$")


def _dtype_name(dtype: Any) -> str:
    """numpy's spelling of a dtype (``torch.bfloat16`` -> ``bfloat16``),
    the manifest's ``dtypes`` values."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(dtype: Any) -> Optional[torch.dtype]:
    if isinstance(dtype, torch.dtype):
        return dtype
    named = getattr(torch, _dtype_name(dtype), None) if dtype is not None \
        else None
    return named if isinstance(named, torch.dtype) else None


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as the array ``leaves.npz`` stores."""
    if isinstance(leaf, torch.Tensor):
        # Made contiguous where it lies (a card transposes fast), then
        # copied to the host.
        t = leaf.detach().contiguous().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _leaf_dtype(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return _dtype_name(leaf.dtype)
    return str(np.asarray(leaf).dtype)


def _to_tensor(arr: np.ndarray, saved: Optional[str]) -> torch.Tensor:
    """A stored array as a CPU tensor; raw void items take the dtype the
    manifest recorded."""
    if arr.dtype.kind == "V":
        if saved != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"cannot read a {arr.dtype} leaf saved as "
                             f"{saved!r}: only bfloat16 is stored raw")
        return torch.from_numpy(
            np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


def save_pytree(path: os.PathLike, tree: Any) -> None:
    """Single-checkpoint save: npz of leaves + json manifest, committed by
    rename. Overwriting an existing checkpoint swaps via two renames, so
    the vulnerable window is microseconds (not a whole rmtree)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = flatten_with_paths(tree)  # raises on path collisions
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    np.savez(tmp / "leaves.npz", **arrays)
    (tmp / "manifest.json").write_text(
        json.dumps({
            "keys": list(arrays.keys()),
            "treedef": treedef_str(tree),
            "dtypes": {k: _leaf_dtype(v) for k, v in flat.items()},
        })
    )
    old = path.with_name(path.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    if path.exists():
        path.rename(old)
    tmp.rename(path)
    if old.exists():
        shutil.rmtree(old)


def restore_pytree(
    path: os.PathLike,
    target: Any,
    shardings: Optional[Any] = None,
    device: Union[str, torch.device, None] = None,
) -> Any:
    """Restore into the structure of ``target`` (a tree whose leaves carry
    a ``dtype``: tensors, numpy arrays, anything shaped like them). With
    ``shardings`` (a tree of ``LeafShard`` at the same paths; a missing
    path restores whole), each leaf keeps this rank's slice. Leaves land
    on ``device`` (default the CPU)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    saved_dtypes = manifest.get("dtypes", {})
    flat_target = flatten_with_paths(target)  # ordered: flatten order
    flat_shard = flatten_with_paths(shardings) if shardings is not None else {}
    device = torch.device(device) if device is not None else None
    leaves = []
    with np.load(path / "leaves.npz") as data:
        missing = [k for k in flat_target if k not in data]
        if missing:
            raise KeyError(
                f"checkpoint {path} missing {len(missing)} leaves, "
                f"first: {missing[:3]}"
            )
        for key, tgt in flat_target.items():
            t = _to_tensor(data[key], saved_dtypes.get(key))
            shard = flat_shard.get(key)
            if shard is not None:
                t = shard.take(t).contiguous()
            t = t.to(device=device, dtype=_torch_dtype(
                getattr(tgt, "dtype", None)) or t.dtype)
            leaves.append(t)
    return unflatten_like(target, leaves)


def checkpoint_shardings(mesh: Any, model: Any) -> Dict[str, Any]:
    """This rank's slice of every leaf of ``model``'s params tree on
    ``mesh``, as ``{"params": {...: LeafShard}}`` over the flax arrays'
    axes: the port's own plan (``parallel/mesh.py::shard_plan``), moved
    from the port dimension it cuts to the flax axis that is the major
    part of that dimension (a ``[D, N, H]`` kernel cut on its N*H rows is
    cut on N)."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import (
        LeafShard,
        shard_plan,
    )

    plan = shard_plan(mesh, model)
    flat: Dict[str, Any] = {}
    for name, (path, _shape, dims) in model.flax_leaves().items():
        cut = plan[name]
        flat[path] = LeafShard(None)
        if cut.dim is not None and cut.parts > 1:
            flat[path] = LeafShard(dims.index(cut.dim), cut.parts, cut.index)
    return {"params": nest_paths(flat)}


class CheckpointManager:
    """Step-indexed checkpoint directory with retention — orbax-style
    management (step dirs, keep-last-N gc, atomic rename-commit) over a
    self-contained numpy format (npz leaves + json manifest), so restores
    have no library-version coupling and bfloat16 round-trips by raw view.

    Layout: ``root/step_<N>/{leaves.npz,manifest.json,metadata.json}``;
    ``latest_step()`` finds the newest.
    """

    def __init__(self, root: os.PathLike, max_to_keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._lock = threading.Lock()

    # --- introspection ----------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for child in self.root.iterdir():
            m = _STEP_DIR.match(child.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step}"

    # --- save / restore ---------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> Path:
        with self._lock:
            d = self._dir(step)
            save_pytree(d, tree)
            if metadata is not None:
                (d / "metadata.json").write_text(json.dumps(metadata))
            self._gc()
            return d

    def restore(
        self,
        target: Any,
        step: Optional[int] = None,
        shardings: Optional[Any] = None,
        device: Union[str, torch.device, None] = None,
    ) -> Any:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_pytree(self._dir(step), target, shardings, device)

    def metadata(self, step: Optional[int] = None) -> Optional[Dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        meta = self._dir(step) / "metadata.json"
        return json.loads(meta.read_text()) if meta.exists() else None

    def delete(self, step: int) -> None:
        with self._lock:
            d = self._dir(step)
            if d.exists():
                shutil.rmtree(d)

    def _gc(self) -> None:
        steps = self.steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self._dir(victim), ignore_errors=True)
            logger.info("checkpoint gc: removed step_%d", victim)


def save_train_state(manager: CheckpointManager, step: int, params: Any,
                     opt_state: Any = None, *, model: Any = None,
                     **metadata: Any) -> Path:
    """Params (+ optional optimizer state) under one step (reference
    ``checkpoint.py:183-194``). With ``model``, ``params`` / ``opt_state``
    are a port train state, saved in the JAX package's layout. Where
    ``model`` is rank 0's shard on a mesh, ``params`` / ``opt_state`` are
    rank 0's train state: every leaf's slices (the AdamW moments' too) are
    gathered whole to rank 0 along the axes the mesh's plan cut
    (``parallel/train.gather_train_state``), and rank 0 writes one
    checkpoint, the same as one device's: it restores on one device, over
    a mesh (restore whole, then ``make_sharded_train_state`` cuts it) and
    in the JAX package."""
    if getattr(model, "tp_shard", None) is not None:
        from ray_dynamic_batching_tpu_torch.parallel.train import (
            gather_train_state,
        )

        model, params, opt_state = gather_train_state(model, params,
                                                      opt_state)
    if model is not None:
        from ray_dynamic_batching_tpu_torch.models.convert import (
            opt_state_to_flax,
            params_to_flax,
        )

        params = params_to_flax(model, params)
        if opt_state is not None:
            opt_state = opt_state_to_flax(model, opt_state)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    return manager.save(step, tree, metadata={"step": step, **metadata})


def restore_train_state(manager: CheckpointManager, params_target: Any,
                        opt_state_target: Any = None,
                        step: Optional[int] = None,
                        params_shardings: Optional[Any] = None,
                        opt_state_shardings: Optional[Any] = None, *,
                        model: Any = None,
                        device: Union[str, torch.device, None] = None):
    """Inverse of :func:`save_train_state`; returns (params, opt_state or
    None, step restored) (reference ``checkpoint.py:197-223``). With
    ``model`` the targets and the result are a port train state (leaves
    on ``device``, default the targets'); either shardings tree may be
    given without the other."""
    step = step if step is not None else manager.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {manager.root}")
    if model is not None:
        from ray_dynamic_batching_tpu_torch.models.convert import (
            opt_state_from_flax,
            opt_state_to_flax,
            params_from_flax,
            params_to_flax,
        )

        if device is None:
            device = next(iter(params_target.values())).device
        params_target = params_to_flax(model, params_target)
        if opt_state_target is not None:
            opt_state_target = opt_state_to_flax(model, opt_state_target)
    target = {"params": params_target}
    if opt_state_target is not None:
        target["opt_state"] = opt_state_target
    shardings = {}
    if params_shardings is not None:
        shardings["params"] = params_shardings
    if opt_state_shardings is not None and opt_state_target is not None:
        shardings["opt_state"] = opt_state_shardings
    restored = restore_pytree(manager._dir(step), target, shardings or None,
                              None if model is not None else device)
    params, opt_state = restored["params"], restored.get("opt_state")
    if model is not None:
        params = {n: t.to(device=device, dtype=torch.float32).contiguous()
                  .requires_grad_(True)
                  for n, t in params_from_flax(params, model.cfg).items()}
        if opt_state is not None:
            opt_state = opt_state_from_flax(opt_state, model.cfg, device)
    return params, opt_state, step
