"""ResNet-50/101/152 backbones and the residual blocks they share with HRNet (NCHW).

Counterpart of mindpose_tpu/models/backbones/resnet.py: the 7x7/2 stem and a
3x3/2 max-pool, then four bottleneck stages (64, 128, 256, 512 channels,
expansion 4), each starting with a block that has a downsample branch
(stage 1's too: 64 -> 256 channels at stride 1), the stride on the 3x3
conv; the output is stage 4's 2048-channel map at 1/32 of the input. The
submodules carry torchvision's names (conv1, bn1, layer1.0.conv1, ...,
layer1.0.downsample.0), so torchvision checkpoints and the JAX package's
``export_backbone_state(..., naming="torch")`` load with ``strict=True``.

The JAX package's BatchNorm knobs are checked as HRNet's are
(``common.check_bn_settings``); ``pretrained`` is refused: loading an
ImageNet backbone belongs to the training entry's leftovers.
"""
from typing import Any, Sequence

import torch
from torch import nn

from ...register import register
from ..common import BatchNorm2d, check_bn_settings, conv1x1, conv3x3, he_normal_
from .backbone import Backbone

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet50", "resnet101", "resnet152"]


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (expansion 1)."""

    expansion = 1

    def __init__(
        self,
        in_channels: int,
        channels: int,
        stride: int = 1,
        downsample: bool = False,
    ) -> None:
        super().__init__()
        self.conv1 = conv3x3(in_channels, channels, stride)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = conv3x3(channels, channels)
        self.bn2 = BatchNorm2d(channels)
        self.downsample = (
            nn.Sequential(conv1x1(in_channels, channels, stride), BatchNorm2d(channels))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block (expansion 4)."""

    expansion = 4

    def __init__(
        self,
        in_channels: int,
        channels: int,
        stride: int = 1,
        downsample: bool = False,
    ) -> None:
        super().__init__()
        out_channels = channels * self.expansion
        self.conv1 = conv1x1(in_channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = conv3x3(channels, channels, stride)
        self.bn2 = BatchNorm2d(channels)
        self.conv3 = conv1x1(channels, out_channels)
        self.bn3 = BatchNorm2d(out_channels)
        self.downsample = (
            nn.Sequential(conv1x1(in_channels, out_channels, stride),
                          BatchNorm2d(out_channels))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return torch.relu(out + identity)


class ResNet(Backbone):
    """ResNet feature extractor; returns the stage-4 NCHW feature map."""

    STAGE_CHANNELS = (64, 128, 256, 512)

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3), in_channels: int = 3) -> None:
        super().__init__()
        self.block_counts = tuple(int(c) for c in block_counts)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        he_normal_(self.conv1.weight)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        width = 64
        for stage, (channels, count) in enumerate(zip(self.STAGE_CHANNELS, self.block_counts)):
            blocks = []
            for i in range(count):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(Bottleneck(width, channels, stride, downsample=i == 0))
                width = channels * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    @property
    def out_channels(self) -> int:
        return self.STAGE_CHANNELS[-1] * Bottleneck.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def _resnet(block_counts: Sequence[int], pretrained: bool, in_channels: int,
            kwargs: Any) -> ResNet:
    unknown = sorted(set(kwargs) - {"bn_stats_frac", "bn_grad_stats"})
    if unknown:
        raise TypeError(f"unknown ResNet settings: {unknown}")
    if pretrained:
        raise NotImplementedError(
            "pretrained ImageNet backbones are not ported (ROADMAP.md, Queue 1, the training "
            "entry's leftovers: load_pretrained_backbone)")
    check_bn_settings(kwargs.get("bn_grad_stats", "exact"), kwargs.get("bn_stats_frac", 1.0))
    return ResNet(block_counts, in_channels=in_channels)


@register("backbone")
def resnet50(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
             **kwargs: Any) -> ResNet:
    """ResNet-50: stages of 3, 4, 6, 3 bottlenecks."""
    return _resnet((3, 4, 6, 3), pretrained, in_channels, kwargs)


@register("backbone")
def resnet101(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
              **kwargs: Any) -> ResNet:
    """ResNet-101: stages of 3, 4, 23, 3 bottlenecks."""
    return _resnet((3, 4, 23, 3), pretrained, in_channels, kwargs)


@register("backbone")
def resnet152(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
              **kwargs: Any) -> ResNet:
    """ResNet-152: stages of 3, 8, 36, 3 bottlenecks."""
    return _resnet((3, 8, 36, 3), pretrained, in_channels, kwargs)
