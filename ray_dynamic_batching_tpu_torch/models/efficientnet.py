"""EfficientNetV2-S servables, in torch.

Port of ``ray_dynamic_batching_tpu/models/efficientnet.py``:
``efficientnet_v2s`` (fused-MBConv stages, then MBConv stages with
squeeze-excite; 384x384 by default, as the reference) and
``efficientnet_tiny``. Every conv keeps flax's SAME padding ((0, 1) on an
even input for the strided ones, ``models/layers.py``); the
squeeze-excite convs carry biases (flax's ``nn.Conv`` default); the head
runs in f32 on the pooled features, as the reference's
``nn.Dense(dtype=f32)``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

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

# (block_type, expand, channels, repeats, stride, use_se)
V2_S_STAGES: Tuple[Tuple[str, int, int, int, int, bool], ...] = (
    ("fused", 1, 24, 2, 1, False),
    ("fused", 4, 48, 4, 2, False),
    ("fused", 4, 64, 4, 2, False),
    ("mbconv", 4, 128, 6, 2, True),
    ("mbconv", 6, 160, 9, 1, True),
    ("mbconv", 6, 256, 15, 2, True),
)

TINY_STAGES: Tuple[Tuple[str, int, int, int, int, bool], ...] = (
    ("fused", 1, 16, 1, 1, False),
    ("fused", 2, 32, 1, 2, False),
    ("mbconv", 2, 64, 1, 2, True),
)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduce_to: int, **kw):
        super().__init__()
        self.reduce = Conv(c, reduce_to, 1, bias=True, **kw)
        self.expand = Conv(reduce_to, c, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, block_type: str, cin: int, expand: int, out: int,
                 stride: int, use_se: bool, **kw):
        super().__init__()
        dev = kw["device"]
        mid = cin * expand
        self.fused = block_type == "fused"
        self.residual = stride == 1 and cin == out
        self.project = self.project_bn = self.se = None
        if self.fused:
            self.fused_conv = Conv(cin, mid, 3, stride=stride, **kw)
            self.fused_bn = BatchNorm(mid, device=dev)
            if expand != 1:
                self.project = Conv(mid, out, 1, **kw)
                self.project_bn = BatchNorm(out, device=dev)
            elif out != mid:
                self.project = Conv(mid, out, 1, **kw)  # no BatchNorm
        else:
            self.expand_conv = Conv(cin, mid, 1, **kw)
            self.expand_bn = BatchNorm(mid, device=dev)
            self.dw_conv = Conv(mid, mid, 3, stride=stride, groups=mid, **kw)
            self.dw_bn = BatchNorm(mid, device=dev)
            if use_se:
                self.se = SqueezeExcite(mid, max(1, cin // 4), **kw)
            self.project = Conv(mid, out, 1, **kw)
            self.project_bn = BatchNorm(out, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            y = F.silu(self.fused_bn(self.fused_conv(x)))
        else:
            y = F.silu(self.expand_bn(self.expand_conv(x)))
            y = F.silu(self.dw_bn(self.dw_conv(y)))
            if self.se is not None:
                y = self.se(y)
        if self.project is not None:
            y = self.project(y)
            if self.project_bn is not None:
                y = self.project_bn(y)
        return y + x if self.residual else y


class EfficientNetV2(VisionModel):
    def __init__(
        self,
        image_size: int = 384,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device, None] = "cuda",
        seed: Optional[int] = 0,
        name: str = "efficientnet_v2s",
        stages: Tuple[Tuple[str, int, int, int, int, bool], ...] = V2_S_STAGES,
        stem_channels: int = 24,
        final_channels: int = 1280,
        num_classes: int = 1000,
    ):
        super().__init__(image_size, dtype, device, name)
        kw = dict(dtype=dtype, device=self.device)
        self.stem_conv = Conv(3, stem_channels, 3, stride=2, **kw)
        self.stem_bn = BatchNorm(stem_channels, device=self.device)
        blocks = []
        cin = stem_channels
        for btype, expand, channels, repeats, stride, use_se in stages:
            for i in range(repeats):
                blocks.append(MBConv(btype, cin, expand, channels,
                                     stride if i == 0 else 1, use_se, **kw))
                cin = channels
        self.blocks = nn.ModuleList(blocks)
        self.final_conv = Conv(cin, final_channels, 1, **kw)
        self.final_bn = BatchNorm(final_channels, device=self.device)
        self.head = Dense(final_channels, num_classes, dtype=torch.float32,
                          device=self.device)
        self.to(memory_format=torch.channels_last)
        if seed is not None:
            init_vision_weights(self, seed, self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.stem_bn(self.stem_conv(nchw(x, self.dtype))))
        for block in self.blocks:
            x = block(x)
        x = F.silu(self.final_bn(self.final_conv(x)))
        return self.head(x.mean(dim=(2, 3)))

    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        return 8.8e9 * 2  # ~8.8 GMACs for V2-S @ 384


@register_model("efficientnet_v2s", slo=ModelSLO(latency_slo_ms=40.0))
def _efficientnet(**kwargs) -> EfficientNetV2:
    return EfficientNetV2(**kwargs)


@register_model("efficientnet_tiny")
def _efficientnet_tiny(**kwargs) -> EfficientNetV2:
    kwargs.setdefault("image_size", 32)
    return EfficientNetV2(
        name="efficientnet_tiny",
        stages=TINY_STAGES,
        stem_channels=8,
        final_channels=64,
        num_classes=10,
        **kwargs,
    )
