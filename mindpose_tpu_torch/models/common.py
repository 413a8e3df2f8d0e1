"""Shared building blocks for the port's models (NCHW, float32).

Counterpart of mindpose_tpu/models/common.py. ``BatchNorm2d`` stands for
its ``batch_norm``; the JAX package's TPU-only BatchNorm knobs are checked
once, where a backbone is built from its settings (``backbones/hrnet.py``).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm2d",
    "conv1x1",
    "conv3x3",
    "he_normal_",
    "resize_nearest",
]


def he_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax ``he_normal``: truncated (+-2 sd) normal with variance 2 / fan_in."""
    fan_in = weight[0].numel()
    # 0.8796... is the sd of a unit normal truncated to +-2; dividing by it
    # restores the target variance, as flax's variance_scaling does
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def conv3x3(in_channels: int, out_channels: int, stride: int = 1) -> nn.Conv2d:
    conv = nn.Conv2d(in_channels, out_channels, 3, stride, padding=1, bias=False)
    he_normal_(conv.weight)
    return conv


def conv1x1(in_channels: int, out_channels: int, stride: int = 1) -> nn.Conv2d:
    conv = nn.Conv2d(in_channels, out_channels, 1, stride, bias=False)
    he_normal_(conv.weight)
    return conv


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics: eps 1e-5, running = 0.9 * running + 0.1 * batch.

    Eval mode is torch's. Train mode updates ``running_var`` with the
    biased batch variance E[x^2] - E[x]^2, as flax does, where torch would
    use the unbiased one. (Flax momentum 0.9 is torch momentum 0.1.)
    """

    def __init__(self, num_features: int) -> None:
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps) * self.weight
        return x * inv[None, :, None, None] + (self.bias - mean * inv)[None, :, None, None]


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor.

    An integer upscale (all HRNet fusion uses) repeats each pixel; other
    sizes use half-pixel centres, like ``jax.image.resize(method="nearest")``.
    """
    n, c, h, w = x.shape
    if height % h == 0 and width % w == 0:
        fh, fw = height // h, width // w
        if fh == 1 and fw == 1:
            return x
        x = x[:, :, :, None, :, None].expand(n, c, h, fh, w, fw)
        return x.reshape(n, c, height, width)
    return F.interpolate(x, size=(height, width), mode="nearest-exact")
