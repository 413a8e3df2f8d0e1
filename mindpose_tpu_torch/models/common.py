"""Shared building blocks for the port's models (NCHW, float32).

Counterpart of mindpose_tpu/models/common.py. ``BatchNorm2d`` stands for
its ``batch_norm``; the JAX package's TPU-only BatchNorm knobs are checked
once, where a backbone or head is built from its settings
(``check_bn_settings``).
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm2d",
    "check_bn_settings",
    "conv1x1",
    "conv3x3",
    "dense",
    "he_normal_",
    "lecun_normal_",
    "resize_bilinear",
    "resize_nearest",
]


def he_normal_(weight: torch.Tensor, fan_in: Optional[int] = None) -> torch.Tensor:
    """flax ``he_normal``: truncated (+-2 sd) normal with variance 2 / fan_in.

    ``fan_in`` defaults to a conv weight's ``I * kh * kw``; a transposed
    conv's weight is [I, O, kh, kw], and flax counts its fan-in as I * kh * kw
    too, so its caller passes that.
    """
    if fan_in is None:
        fan_in = weight[0].numel()
    # 0.8796... is the sd of a unit normal truncated to +-2; dividing by it
    # restores the target variance, as flax's variance_scaling does
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax ``lecun_normal``: truncated (+-2 sd) normal with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # sd of a unit normal cut at +-2
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def dense(in_features: int, out_features: int) -> nn.Linear:
    """A Linear with flax ``Dense``'s initial weights (lecun normal, zero bias)."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, in_features)
    nn.init.zeros_(layer.bias)
    return layer


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

    Eval mode is torch's. Train mode follows flax ``nn.BatchNorm`` with a
    compute dtype: the statistics E[x], E[x^2] - E[x]^2 (the biased
    variance, where torch would use the unbiased one; clamped at 0) and the
    normalization are taken in ``x.dtype`` promoted to at least float32
    (float64 stays float64), and only the output is cast back to
    ``x.dtype``. bf16 statistics would lose a channel's variance whenever it
    is small against its mean. The running statistics keep their own dtype.
    (Flax momentum 0.9 is torch momentum 0.1.)
    """

    def __init__(self, num_features: int) -> None:
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            # flax's order of operations: 0.9 * running + 0.1 * batch
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)


def check_bn_settings(bn_grad_stats: str = "exact", bn_stats_frac: float = 1.0) -> None:
    """Accept the JAX package's exact BatchNorm settings, refuse the divergent ones.

    ``bn_grad_stats: fused`` (exact BN with a hand-written backward) changes
    no result and builds plain BN here; subsampled statistics
    (``bn_stats_frac < 1``) and frozen-statistic gradients (``frozen``,
    ``frozen_var``) were measured to diverge (docs/performance.md:103-122).
    """
    if bn_grad_stats not in ("exact", "fused", "frozen", "frozen_var"):
        raise ValueError(
            f"bn_grad_stats must be 'exact', 'fused', 'frozen_var' or 'frozen', got {bn_grad_stats!r}")
    if bn_grad_stats in ("frozen", "frozen_var") or float(bn_stats_frac) < 1.0:
        raise NotImplementedError(
            f"bn_grad_stats={bn_grad_stats!r}, bn_stats_frac={bn_stats_frac} are not ported: "
            "both were measured to diverge (docs/performance.md:103-122)")


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


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor with half-pixel centres, like
    ``jax.image.resize(method="bilinear")``, which widens its kernel (an
    antialiasing triangle filter) where it downsamples: ``antialias=True``
    does the same, and changes nothing where it upsamples."""
    return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                         antialias=True)
