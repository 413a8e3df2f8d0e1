"""Residual blocks shared by the backbones (NCHW).

Counterpart of the blocks in mindpose_tpu/models/backbones/resnet.py, with
torchvision / official-HRNet submodule names (conv1, bn1, ..., downsample.0,
downsample.1), so published torch checkpoints and the JAX package's
``export_backbone_state(..., naming="torch")`` load with ``strict=True``.
The ResNet backbones themselves are not ported yet.
"""
import torch
from torch import nn

from ..common import BatchNorm2d, conv1x1, conv3x3

__all__ = ["BasicBlock", "Bottleneck"]


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
