"""ResNet (bottleneck) servables, in torch.

Port of ``ray_dynamic_batching_tpu/models/resnet.py``: ``resnet50`` and
``resnet18_tiny`` (the tests' stride-identical 1/8-width topology). The
payload is NHWC, computed in ``dtype`` (bf16 by default) with f32
BatchNorm statistics; the head runs in ``dtype`` and is cast to f32, as
the reference's. The strided ``conv2`` of a bottleneck keeps flax's SAME
padding ((0, 1) on an even input, ``models/layers.py``); the stem conv
and the max pool pad (3, 3) and (1, 1) as the reference passes them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_dynamic_batching_tpu_torch.models.base import (
    ModelSLO,
    register_model,
)
from ray_dynamic_batching_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    VisionModel,
    init_vision_weights,
    nchw,
)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int, **kw):
        super().__init__()
        dev = kw["device"]
        self.conv1 = Conv(cin, features, 1, **kw)
        self.bn1 = BatchNorm(features, device=dev)
        self.conv2 = Conv(features, features, 3, stride=strides, **kw)
        self.bn2 = BatchNorm(features, device=dev)
        self.conv3 = Conv(features, features * 4, 1, **kw)
        self.bn3 = BatchNorm(features * 4, device=dev)
        self.proj_conv = self.proj_bn = None
        if cin != features * 4 or strides != 1:
            self.proj_conv = Conv(cin, features * 4, 1, stride=strides, **kw)
            self.proj_bn = BatchNorm(features * 4, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(self.proj_conv(x))
        return F.relu(y + residual)


class ResNet(VisionModel):
    def __init__(
        self,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        num_classes: int = 1000,
        image_size: int = 224,
        width: int = 64,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device, None] = "cuda",
        seed: Optional[int] = 0,
        name: str = "resnet50",
    ):
        super().__init__(image_size, dtype, device, name)
        kw = dict(dtype=dtype, device=self.device)
        self.stem_conv = Conv(3, width, 7, stride=2, padding=3, **kw)
        self.stem_bn = BatchNorm(width, device=self.device)
        blocks = []
        cin = width
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                feats = width * 2 ** i
                blocks.append(BottleneckBlock(
                    cin, feats, 2 if i > 0 and j == 0 else 1, **kw))
                cin = feats * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(cin, num_classes, **kw)
        self.to(memory_format=torch.channels_last)
        if seed is not None:
            init_vision_weights(self, seed, self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(nchw(x, self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3))).float()

    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        return 4.1e9 * 2  # ~4.1 GMACs for ResNet-50 @ 224


@register_model("resnet50", slo=ModelSLO(latency_slo_ms=2000.0))
def _resnet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), name="resnet50", **kwargs)


@register_model("resnet18_tiny")
def _resnet_tiny(**kwargs) -> ResNet:
    """Small config for CPU tests (stride-identical topology, 1/8 width)."""
    kwargs.setdefault("image_size", 32)
    kwargs.setdefault("width", 8)
    kwargs.setdefault("num_classes", 10)
    return ResNet(stage_sizes=(1, 1, 1, 1), name="resnet18_tiny", **kwargs)
