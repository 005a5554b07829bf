"""Map the JAX package's params onto the port's weights.

``params_from_flax(tree, cfg)`` takes the flax params as a nested dict of
numpy arrays (``{"params": {...}}`` or the inner dict) and returns a
``state_dict`` for :class:`~.decoder.DecoderModule` (f32 CPU tensors;
``load_state_dict`` casts them to the model's dtype and device). Layouts:

- ``q``/``k``/``v`` kernels ``[D, N, H]`` / ``[D, K, H]`` -> ``[N*H, D]``;
- the ``o`` kernel ``[N, H, D]`` (DenseGeneral over axes (-2, -1)) ->
  ``[D, N*H]``;
- ``mlp_*`` kernels ``[in, out]`` -> ``[out, in]``; biases flattened;
- ``*_norm`` scale/bias as they are;
- ``tok_embed/embedding`` and ``pos_embed/embedding`` ``[rows, D]`` as
  they are; ``lm_head/kernel`` ``[D, V]`` -> ``[V, D]``;
- a MoE layer's ``moe/router/kernel`` ``[D, E]`` -> ``[E, D]``; its
  experts ``moe/wi``, ``moe/wg`` ``[E, D, F]`` and ``moe/wo`` ``[E, F, D]``
  as they are.

Leaves may be numpy arrays or tensors (a checkpoint restored by
``runtime/checkpoint.py``: tensors keep their dtype and device, and
``load_state_dict`` casts them). ``params_to_flax(model)`` is the
inverse: a built decoder's weights as that tree, in the flax layouts
(``params_to_flax(model, params)``: a dict of tensors keyed by the
port's parameter names, such as a train state's f32 params, instead).

A train state (``parallel/train.py``) bridges with optax's state:
:func:`opt_state_to_flax` / :func:`opt_state_from_flax` map
``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())`` with
``mu`` / ``nu`` keyed by the port's names to the same namedtuples with
``mu`` / ``nu`` as flax params trees, optax's layout, and back;
:func:`train_state_from_flax` takes the JAX package's ``(params,
opt_state)`` whole. ``parallel/pipeline.py``'s split tree (``{"outer",
"layers"}``, the layers stacked) is the reference's and is made from, and
merged back into, the flax tree there.

A JAX-quantized tree (``models/quant.py::quantize_tree`` output, its
``QTensor`` leaves as objects with ``q`` / ``scale`` or as ``{"q",
"scale"}`` mappings of numpy arrays) bridges with no requantization:
each such leaf becomes ``<name>_codes`` (int8, in the layout above; the
experts' transposed to ``[E, out, in]``, the int8 kernel's) and
``<name>_scale`` (f32, flattened to the flax last axis), which
``models/quant.py::load_state`` installs.

The vision families' converters (``resnet_params_from_flax``,
``shufflenet_params_from_flax``, ``efficientnet_params_from_flax``,
``vit_params_from_flax``) take the whole ``init`` tree (``params`` and,
for the CNNs, ``batch_stats``) and return a ``state_dict`` for the
family's module in ``models/{resnet,shufflenet,efficientnet,vit}.py``:

- conv kernels ``[kh, kw, in/groups, out]`` -> ``[out, in/groups, kh,
  kw]`` (depthwise convs included); ``Dense`` kernels ``[in, out]`` ->
  ``[out, in]``; biases flattened;
- BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` as
  they are; LayerNorm ``scale`` -> ``weight``;
- ViT's ``DenseGeneral`` ``qkv`` ``[D, 3, N, H]`` -> ``[3*N*H, D]`` and
  ``proj`` ``[N, H, D]`` -> ``[D, N*H]``; ``cls_token`` and
  ``pos_embed`` as they are;
- numbered flax modules (``stage{i}_block{j}``, ``stage{s}_down`` /
  ``stage{s}_unit{i}``, ``block{i}``) -> the port's flat ``blocks.{k}`` /
  ``units.{k}`` in build order.

``distilbert_params_from_flax`` (``models/distilbert.py``'s
``DistilBertModule``) and ``asr_params_from_flax`` (``models/asr.py``'s
``ASRModel``, from the ``{"encoder", "decoder"}`` tree its ``init``
returns) map the encoder families:

- ``DenseGeneral`` kernels flatten to ``[in, out]`` and transpose:
  DistilBERT's ``qkv`` ``[D, 3, N, H]`` -> ``[3*N*H, D]``, its ``proj``
  and the ASR ``o`` kernels ``[N, H, D]`` -> ``[D, N*H]``, the ASR
  ``q``/``k``/``v`` ``[D, N, H]`` -> ``[N*H, D]``; biases flattened;
- LayerNorm ``scale``/``bias`` and embeddings as they are;
- the ASR convolutions' NWC kernels ``[3, in, out]`` -> ``[out, in, 3]``;
- numbered ``layer{i}`` -> ``layers.{i}``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ray_dynamic_batching_tpu_torch.models.decoder import DecoderConfig


def _t(x: Any) -> torch.Tensor:
    """A leaf as a tensor: a tensor as it is (its dtype and device, which
    ``load_state_dict`` casts from), anything else as f32."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _f32(x: Any) -> Any:
    """A leaf for a layout function: tensors as they are, the rest as f32
    numpy arrays (the layouts only reshape and transpose)."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _qtensor(x: Any):
    """(q, scale) numpy arrays of a quantized leaf, else None."""
    if isinstance(x, Mapping):
        if set(x) == {"q", "scale"}:
            return np.asarray(x["q"]), np.asarray(x["scale"])
        return None
    if hasattr(x, "q") and hasattr(x, "scale"):
        return np.asarray(x.q), np.asarray(x.scale)
    return None


def params_from_flax(tree: Mapping[str, Any],
                     cfg: DecoderConfig) -> Dict[str, torch.Tensor]:
    p = tree.get("params", tree)
    D, N, H = cfg.d_model, cfg.num_heads, cfg.head_dim
    sd: Dict[str, torch.Tensor] = {
        "tok_embed.weight": _t(p["tok_embed"]["embedding"]),
    }
    if cfg.pos == "learned":
        sd["pos_embed.weight"] = _t(p["pos_embed"]["embedding"])

    def put(name: str, x: Any, layout: Callable[[np.ndarray], np.ndarray],
            code_layout: Optional[Callable] = None) -> None:
        """One leaf, in the port's layout; a quantized one as codes (in
        ``code_layout``, default the same) + flat scales."""
        qt = _qtensor(x)
        if qt is None:
            sd[name] = _t(layout(_f32(x)))
            return
        q, scale = qt
        sd[f"{name}_codes"] = torch.from_numpy(np.ascontiguousarray(
            (code_layout or layout)(q.astype(np.int8))))
        sd[f"{name}_scale"] = _t(scale.reshape(-1))

    def norm(prefix: str, leaf: Mapping[str, Any]) -> None:
        sd[f"{prefix}.scale"] = _t(leaf["scale"])
        if cfg.norm == "ln":
            sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def dense(prefix: str, leaf: Mapping[str, Any], d_in: int,
              bias: bool = True) -> None:
        put(f"{prefix}.weight", leaf["kernel"],
            lambda k: k.reshape(d_in, -1).T)
        if cfg.use_bias and bias:
            put(f"{prefix}.bias", leaf["bias"], lambda b: b.reshape(-1))

    for i in range(cfg.num_layers):
        layer = p[f"layer{i}"]
        pre = f"layers.{i}"
        norm(f"{pre}.attn_norm", layer["attn_norm"])
        norm(f"{pre}.mlp_norm", layer["mlp_norm"])
        dense(f"{pre}.q", layer["q"], D)
        dense(f"{pre}.k", layer["k"], D)
        dense(f"{pre}.v", layer["v"], D)
        dense(f"{pre}.o", layer["o"], N * H)
        if cfg.num_experts > 0:
            moe = layer["moe"]
            dense(f"{pre}.moe.router", moe["router"], D, bias=False)
            for w in ("wi", "wg", "wo") if cfg.gated_mlp else ("wi", "wo"):
                # Unquantized experts keep the flax layout; int8 codes
                # take the kernel's [E, out, in].
                put(f"{pre}.moe.{w}", moe[w], lambda e: e,
                    lambda e: e.transpose(0, 2, 1))
            continue
        if cfg.gated_mlp:
            dense(f"{pre}.mlp_gate", layer["mlp_gate"], D)
        dense(f"{pre}.mlp_up", layer["mlp_up"], D)
        dense(f"{pre}.mlp_down", layer["mlp_down"], cfg.mlp_dim)
    norm("final_norm", p["final_norm"])
    if not cfg.tie_embeddings:
        put("lm_head.weight", p["lm_head"]["kernel"], lambda k: k.T)
    return sd


@torch.no_grad()
def params_to_flax(model: Any,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax` for a built decoder: its
    weights as the JAX package's params tree ``{"params": {...}}``, each
    leaf a tensor in the flax layout (a view of the model's weight where
    the layout allows; dtype and device the model's). What
    ``runtime/checkpoint.py`` saves and restores for a language model. A
    weight-only int8 model raises: checkpoint its full-precision weights
    and quantize after the restore."""
    from ray_dynamic_batching_tpu_torch.models.decoder import Dense
    from ray_dynamic_batching_tpu_torch.models.quant import is_quantized
    from ray_dynamic_batching_tpu_torch.utils.pytree import nest_paths

    if is_quantized(model):
        raise ValueError(f"{model.name} holds int8 codes; checkpoint the "
                         "full-precision model and quantize after restoring")
    modules = dict(model.module.named_modules())
    if params is None:
        params = dict(model.module.named_parameters())
    flat: Dict[str, Any] = {}
    for name, (path, shape, _dims) in model.flax_leaves().items():
        if name not in params:      # a pipeline stage's share
            continue
        w = params[name]
        mod_name, _, leaf = name.rpartition(".")
        if isinstance(modules[mod_name], Dense) and leaf == "weight":
            w = w.T   # [out, in] -> [in, out], then split into flax axes
        flat[path] = w.reshape(shape)
    return {"params": nest_paths(flat)}


# --- vision families --------------------------------------------------------
def _vision_leaf(module: str, leaf: str, x: np.ndarray
                 ) -> Tuple[str, np.ndarray]:
    """(port leaf name, port layout) of one flax leaf of ``module``."""
    if leaf == "kernel":
        if module == "qkv":                   # DenseGeneral [D, 3, N, H]
            return "weight", x.reshape(x.shape[0], -1).T
        if module == "proj":                  # DenseGeneral [N, H, D]
            return "weight", x.reshape(-1, x.shape[-1]).T
        if x.ndim == 4:                       # conv [kh, kw, in/g, out]
            return "weight", x.transpose(3, 2, 0, 1)
        return "weight", x.T                  # Dense [in, out]
    if leaf == "bias":
        return "bias", x.reshape(-1)
    if leaf == "scale" and module.startswith("ln"):
        return "weight", x
    return leaf, x                            # BN scale / mean / var, ...


def _vision_from_flax(tree: Mapping[str, Any],
                      rename: Callable[[str], str]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (key,))
            return
        *mods, leaf = path
        name, x = _vision_leaf(mods[-1] if mods else "", leaf,
                               np.asarray(node, dtype=np.float32))
        prefix = ".".join([rename(mods[0])] + mods[1:]) if mods else ""
        sd[f"{prefix}.{name}" if prefix else name] = _t(x)

    for collection in ("params", "batch_stats"):
        walk(tree.get(collection, {}), ())
    return sd


def _numbered(tree: Mapping[str, Any], pattern: str, flat: str,
              key: Callable[[re.Match], Tuple[int, ...]]
              ) -> Callable[[str], str]:
    """Rename the flax modules matching ``pattern`` to ``{flat}.{k}``, k
    counting them in ``key`` order (the port's build order)."""
    names = [n for n in tree.get("params", {}) if re.fullmatch(pattern, n)]
    order = sorted(names, key=lambda n: key(re.fullmatch(pattern, n)))
    index = {n: f"{flat}.{k}" for k, n in enumerate(order)}
    return lambda n: index.get(n, n)


def resnet_params_from_flax(tree: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    return _vision_from_flax(tree, _numbered(
        tree, r"stage(\d+)_block(\d+)", "blocks",
        lambda m: (int(m[1]), int(m[2]))))


def shufflenet_params_from_flax(tree: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    return _vision_from_flax(tree, _numbered(
        tree, r"stage(\d+)_(down|unit(\d+))", "units",
        lambda m: (int(m[1]), -1 if m[2] == "down" else int(m[3]))))


def efficientnet_params_from_flax(tree: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    return resnet_params_from_flax(tree)      # the same numbering


def vit_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return _vision_from_flax(tree, _numbered(
        tree, r"block(\d+)", "blocks", lambda m: (int(m[1]),)))


# --- encoder families (DistilBERT, ASR) ---------------------------------------
def _encoder_tree(params: Mapping[str, Any], prefix: str,
                  kernel: Callable[[str, np.ndarray], np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
    """A flax params subtree as a ``state_dict`` under ``prefix``:
    ``layer{i}`` -> ``layers.{i}``, ``kernel(module, x)`` lays out each
    kernel, ``embedding`` -> ``weight``, biases flattened."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (key,))
            return
        *mods, leaf = path
        x = np.asarray(node, dtype=np.float32)
        if leaf == "kernel":
            leaf, x = "weight", kernel(mods[-1], x)
        elif leaf == "embedding":
            leaf = "weight"
        elif leaf == "bias":
            x = x.reshape(-1)
        mods = [f"layers.{m[5:]}" if re.fullmatch(r"layer\d+", m) else m
                for m in mods]
        sd[".".join([prefix] + mods + [leaf]) if prefix
           else ".".join(mods + [leaf])] = _t(x)

    walk(params.get("params", params), ())
    return sd


def _dense_kernel(module: str, x: np.ndarray) -> np.ndarray:
    """A (Dense)General kernel -> ``[out, in]``: ``[N, H, D]`` output
    projections contract their first two axes, every other kernel its
    first axis."""
    if module in ("proj", "o", "self_o", "cross_o"):
        return x.reshape(-1, x.shape[-1]).T
    return x.reshape(x.shape[0], -1).T


def distilbert_params_from_flax(tree: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """flax ``DistilBertModule`` params -> its port's ``state_dict``."""
    return _encoder_tree(tree, "", _dense_kernel)


def asr_params_from_flax(tree: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """The ASR model's ``{"encoder", "decoder"}`` flax params ->
    ``ASRModel``'s ``state_dict``."""

    def kernel(module: str, x: np.ndarray) -> np.ndarray:
        if module.startswith("conv"):            # NWC [3, in, out]
            return x.transpose(2, 1, 0)
        return _dense_kernel(module, x)

    sd = _encoder_tree(tree["encoder"], "encoder", kernel)
    sd.update(_encoder_tree(tree["decoder"], "decoder", kernel))
    return sd


def opt_state_to_flax(model: Any, opt_state: Any) -> Any:
    """optax's state tree for ``opt_state`` (``parallel/optim.py``'s, its
    moments keyed by port names): the same namedtuples with ``mu`` / ``nu``
    as flax params trees (``{"params": {...}}``, flax layouts)."""
    from ray_dynamic_batching_tpu_torch.parallel.optim import (
        ScaleByAdamState,
    )

    adam = opt_state[0]
    return (ScaleByAdamState(adam.count, params_to_flax(model, adam.mu),
                             params_to_flax(model, adam.nu)),
            *opt_state[1:])


def opt_state_from_flax(tree: Any, cfg: DecoderConfig,
                        device: Any = None) -> Any:
    """The inverse of :func:`opt_state_to_flax`: optax's adamw state (the
    JAX package's, or one restored from a checkpoint) with its moments as
    f32 tensors keyed by port names, on ``device`` (default: where they
    are)."""
    from ray_dynamic_batching_tpu_torch.parallel.optim import (
        EmptyState,
        ScaleByAdamState,
    )

    adam = tree[0]

    def moments(t):
        return {n: _t(x).to(device=device, dtype=torch.float32)
                .contiguous() for n, x in params_from_flax(t, cfg).items()}

    count = adam.count if isinstance(adam.count, torch.Tensor) else \
        torch.tensor(np.asarray(adam.count), dtype=torch.int32)
    return (ScaleByAdamState(count.to(device=device, dtype=torch.int32),
                             moments(adam.mu), moments(adam.nu)),
            EmptyState(), EmptyState())


def train_state_from_flax(params: Mapping[str, Any], opt_state: Any,
                          cfg: DecoderConfig, device: Any = None):
    """(params, opt_state) of the port from the JAX package's: params as
    f32 tensors keyed by port names (what ``parallel/train.py`` trains),
    the optax state by :func:`opt_state_from_flax`."""
    flat = {n: _t(x).to(device=device, dtype=torch.float32).contiguous()
            for n, x in params_from_flax(params, cfg).items()}
    state = None if opt_state is None else opt_state_from_flax(
        opt_state, cfg, device)
    return flat, state
