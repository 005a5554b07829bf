"""Pieces the vision servables share: flax's convolution, BatchNorm and
Dense semantics in torch, and the NHWC contract.

The JAX package builds its CNNs and ViT from ``flax.linen`` layers; this
module gives the port the same arithmetic:

- :class:`Conv` — ``nn.Conv``: the default ``padding="SAME"`` pads
  ``total = max((ceil(n / s) - 1) * s + k - n, 0)`` per spatial axis,
  ``total // 2`` before and the rest after, so a stride-2 3x3 conv on an
  even input pads (0, 1), not torch's (1, 1). An explicit ``padding`` is
  symmetric, as the reference passes it. Weights ``[out, in/groups, kh,
  kw]`` in the compute dtype (the reference casts its f32 kernel in at
  use, which rounds alike).
- :class:`BatchNorm` — ``nn.BatchNorm(use_running_average=True)``: the
  statistics, scale and bias stay f32, the normalization runs in f32 and
  rounds once to the input's dtype (eps 1e-5). ``mean``/``var`` are
  buffers, and nothing else is (no ``num_batches_tracked``), so a
  ``state_dict`` counts what the reference's params tree counts.
- :class:`Dense` — ``nn.Dense``: ``[in, out]`` kernels become
  ``[out, in]`` weights in the layer's own dtype; inputs are cast to it.
- :class:`VisionModel` — the payload is NHWC ``[B, S, S, 3]`` (the
  reference's layout and ``example_inputs``); :func:`nchw` permutes it
  once into channels-last NCHW, the same memory.

Random weights (``init_vision_weights``) follow flax's default
initializers in distribution: kernels N(0, 1/fan_in), biases 0, norm
scales 1, statistics mean 0 / var 1.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.models.base import (
    InputSpec,
    ServableModel,
)


class VisionModel(ServableModel):
    """A classifier over NHWC images of ``image_size`` squared."""

    family = "vision"

    def __init__(self, image_size: int, dtype: torch.dtype,
                 device: Union[str, torch.device, None], name: str):
        super().__init__(dtype, device)
        self.name = name
        self.image_size = image_size

    def input_shapes(self, batch_size: int, seq_len: Optional[int] = None
                     ) -> Tuple[InputSpec]:
        s = self.image_size
        return (InputSpec((batch_size, s, s, 3), self.dtype),)

    def example_inputs(self, batch_size: int, seq_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor]:
        (spec,) = self.input_shapes(batch_size)
        return (torch.zeros(spec.shape, dtype=spec.dtype,
                            device=self.device),)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC payload -> NCHW view of channels-last memory, in ``dtype``."""
    return x.to(dtype).permute(0, 3, 1, 2)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False,
                 padding: Optional[int] = None, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.k, self.stride, self.groups, self.padding = k, stride, groups, \
            padding
        self.weight = nn.Parameter(torch.empty(
            cout, cin // groups, k, k, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, dtype=dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is not None:
            pad: Sequence[int] = (self.padding, self.padding)
        else:
            (ht, hb), (wl, wr) = (same_pads(n, self.k, self.stride)
                                  for n in x.shape[2:])
            if ht != hb or wl != wr:
                x = F.pad(x, (wl, wr, ht, hb))
                ht = wl = 0
            pad = (ht, wl)
        return F.conv2d(x, self.weight, self.bias, self.stride, pad, 1,
                        self.groups)


class BatchNorm(nn.Module):
    def __init__(self, c: int, *, device: torch.device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(c, **f32))
        self.bias = nn.Parameter(torch.zeros(c, **f32))
        self.register_buffer("mean", torch.zeros(c, **f32))
        self.register_buffer("var", torch.ones(c, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Mixed types: a bf16 input with f32 statistics normalizes in f32
        # and rounds once to bf16, as flax does.
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            False, 0.0, self.eps)


class Dense(nn.Linear):
    def __init__(self, cin: int, cout: int, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__(cin, cout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


@torch.no_grad()
def init_vision_weights(module: nn.Module, seed: int,
                        device: torch.device) -> None:
    """Random weights from ``seed`` on ``device`` (see the module doc)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for name, p in sorted(module.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(_owner(module, name), (BatchNorm, nn.LayerNorm)):
            p.fill_(1.0 if leaf in ("scale", "weight") else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "cls_token":
            p.zero_()
        elif leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=gen, device=device,
                                dtype=torch.float32) * 0.02)
        else:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=gen, device=device,
                                dtype=torch.float32) * fan_in ** -0.5)
    for mod in module.modules():
        if isinstance(mod, BatchNorm):
            mod.mean.zero_()
            mod.var.fill_(1.0)


def _owner(module: nn.Module, name: str) -> nn.Module:
    path = name.rsplit(".", 1)[0] if "." in name else ""
    return module.get_submodule(path) if path else module
