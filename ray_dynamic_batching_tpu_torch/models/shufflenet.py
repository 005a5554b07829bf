"""ShuffleNet-v2 servables, in torch.

Port of ``ray_dynamic_batching_tpu/models/shufflenet.py``:
``shufflenet_v2`` (1.0x) and ``shufflenet_tiny``. The reference's channel
shuffle is defined on NHWC channel order (``reshape [.., g, C/g]``, swap,
flatten); :func:`channel_shuffle` gives the same permutation on NCHW. Its
stem conv and the strided depthwise convs keep flax's SAME padding
((0, 1) on an even input, ``models/layers.py``); the max pool pads (1, 1)
as the reference passes it.
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


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Output channel ``j * groups + i`` takes input channel
    ``i * (C // groups) + j`` (the reference's NHWC shuffle)."""
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2).reshape(
        B, C, H, W)


class ShuffleUnit(nn.Module):
    def __init__(self, cin: int, out_channels: int, downsample: bool, **kw):
        super().__init__()
        dev = kw["device"]
        self.downsample = downsample
        branch_c = out_channels // 2
        if downsample:
            self.left_dw = Conv(cin, cin, 3, stride=2, groups=cin, **kw)
            self.left_dw_bn = BatchNorm(cin, device=dev)
            self.left_pw = Conv(cin, branch_c, 1, **kw)
            self.left_pw_bn = BatchNorm(branch_c, device=dev)
            right_in = cin
        else:
            right_in = cin // 2
        stride = 2 if downsample else 1
        self.right_pw1 = Conv(right_in, branch_c, 1, **kw)
        self.right_pw1_bn = BatchNorm(branch_c, device=dev)
        self.right_dw = Conv(branch_c, branch_c, 3, stride=stride,
                             groups=branch_c, **kw)
        self.right_dw_bn = BatchNorm(branch_c, device=dev)
        self.right_pw2 = Conv(branch_c, branch_c, 1, **kw)
        self.right_pw2_bn = BatchNorm(branch_c, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            left = self.left_dw_bn(self.left_dw(x))
            left = F.relu(self.left_pw_bn(self.left_pw(left)))
            right = x
        else:
            left, right = x.chunk(2, dim=1)
        right = F.relu(self.right_pw1_bn(self.right_pw1(right)))
        right = self.right_dw_bn(self.right_dw(right))
        right = F.relu(self.right_pw2_bn(self.right_pw2(right)))
        return channel_shuffle(torch.cat([left, right], dim=1))


class ShuffleNetV2(VisionModel):
    def __init__(
        self,
        image_size: int = 224,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device, None] = "cuda",
        seed: Optional[int] = 0,
        name: str = "shufflenet_v2",
        stage_repeats: Sequence[int] = (4, 8, 4),
        stage_channels: Sequence[int] = (116, 232, 464),
        final_channels: int = 1024,
        num_classes: int = 1000,
    ):
        super().__init__(image_size, dtype, device, name)
        kw = dict(dtype=dtype, device=self.device)
        self.stem_conv = Conv(3, 24, 3, stride=2, **kw)
        self.stem_bn = BatchNorm(24, device=self.device)
        units = []
        cin = 24
        for repeats, channels in zip(stage_repeats, stage_channels):
            units.append(ShuffleUnit(cin, channels, True, **kw))
            units += [ShuffleUnit(channels, channels, False, **kw)
                      for _ in range(repeats - 1)]
            cin = channels
        self.units = nn.ModuleList(units)
        self.final_conv = Conv(cin, final_channels, 1, **kw)
        self.final_bn = BatchNorm(final_channels, device=self.device)
        self.head = Dense(final_channels, num_classes, **kw)
        self.to(memory_format=torch.channels_last)
        if seed is not None:
            init_vision_weights(self, seed, self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(nchw(x, self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)
        for unit in self.units:
            x = unit(x)
        x = F.relu(self.final_bn(self.final_conv(x)))
        return self.head(x.mean(dim=(2, 3))).float()

    def flops_per_sample(self, seq_len: Optional[int] = None) -> float:
        return 146e6 * 2  # ~146 MMACs for 1.0x @ 224


@register_model("shufflenet_v2", slo=ModelSLO(latency_slo_ms=1500.0))
def _shufflenet(**kwargs) -> ShuffleNetV2:
    return ShuffleNetV2(name="shufflenet_v2", **kwargs)


@register_model("shufflenet_tiny")
def _shufflenet_tiny(**kwargs) -> ShuffleNetV2:
    kwargs.setdefault("image_size", 32)
    return ShuffleNetV2(
        name="shufflenet_tiny",
        stage_repeats=(1, 1, 1),
        stage_channels=(16, 32, 64),
        final_channels=64,
        num_classes=10,
        **kwargs,
    )
