"""Shared building blocks for the port's models (NCHW, float32).

Counterpart of mindpose_tpu/models/common.py. ``BatchNorm2d`` stands for
its ``batch_norm`` in every mode (``bn_grad_stats``, ``bn_stats_frac``),
which a backbone or head sets on all of its BatchNorms once built
(``set_batch_norm_mode``).
"""
import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm2d",
    "check_bn_settings",
    "frozen_statistics",
    "set_batch_norm_mode",
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

    Eval mode is torch's. Train mode follows the JAX package's
    ``batch_norm`` (``mindpose_tpu/models/common.py:56-92``), which picks the module by
    ``grad_stats`` and ``stats_frac``:

    - ``"exact"`` with ``stats_frac >= 1``, and ``"fused"`` at any fraction
      (exact BN with a hand-written backward there; the fraction is
      ignored): flax ``nn.BatchNorm`` with a compute dtype. The statistics
      E[x], E[x^2] - E[x]^2 (the biased variance, where torch would use the
      unbiased one; clamped at 0) and the normalization are taken in
      ``x.dtype`` promoted to at least float32 (float64 stays float64), and
      only the output is cast back to ``x.dtype``. bf16 statistics would
      lose a channel's variance whenever it is small against its mean.
    - anything else: ``SubsampledBatchNorm`` (there, :125-179). The
      statistics come from the batch's leading ``max(1, round(N *
      stats_frac))`` samples (Python's round: half to even), in ``x.dtype``
      promoted to at least float32, the variance E[x^2] - E[x]^2 unclamped;
      ``"frozen_var"`` stops the variance's gradient, ``"frozen"`` the
      mean's too. The output is ``x * mul + add`` in ``x.dtype`` (bf16
      under autocast), ``mul`` and ``add`` the per-channel affine cast to
      it, as JAX computes it in the module's dtype.

    The running statistics keep their own dtype. (Flax momentum 0.9 is
    torch momentum 0.1.)

    ``sync_group``: a process group over which train mode takes its batch
    statistics (``parallel/fsdp.py`` sets it): the per-channel sums of x and
    x^2 and the count are all-reduced inside the forward, through the
    differentiable all-reduce, so that the statistics, the gradient and the
    running statistics are the global batch's, as one GSPMD program over the
    global batch computes them. A subsampled slice is then the global
    batch's leading rows: rank r holds global rows [r*b, (r+1)*b) and
    contributes those below the slice's end. ``update_statistics`` False
    (set by ``frozen_statistics``) leaves the running statistics as they are.
    """

    def __init__(self, num_features: int, stats_frac: float = 1.0,
                 grad_stats: str = "exact") -> None:
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        check_bn_settings(grad_stats)
        self.stats_frac = float(stats_frac)
        self.grad_stats = grad_stats
        self.sync_group = None
        self.update_statistics = True

    @property
    def subsampled(self) -> bool:
        """True where train mode takes JAX's ``SubsampledBatchNorm`` path."""
        return self.grad_stats != "fused" and (self.grad_stats != "exact"
                                               or self.stats_frac < 1.0)

    def _batch_moments(self, xf: torch.Tensor, rows: Optional[int] = None):
        """E[x] and E[x^2] per channel over this rank's batch or the group's;
        with ``rows``, over the (global) batch's first ``rows`` samples."""
        if self.sync_group is None:
            xs = xf if rows is None else xf[:rows]
            return xs.mean(dim=(0, 2, 3)), (xs * xs).mean(dim=(0, 2, 3))
        from torch.distributed.nn.functional import all_reduce

        if rows is not None:  # this rank's global rows [r*b, (r+1)*b) below ``rows``
            b = xf.shape[0]
            start = torch.distributed.get_rank(self.sync_group) * b
            xf = xf[:min(max(rows - start, 0), b)]
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        sums = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                     count]), group=self.sync_group)
        c = xf.shape[1]
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.update_statistics:
            with torch.no_grad():
                # flax's order of operations: 0.9 * running + 0.1 * batch
                self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
                self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.subsampled:
            return self._subsampled(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, mean_sq = self._batch_moments(xf)
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        self._update_running(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)

    def _subsampled(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if self.sync_group is not None:
            n *= torch.distributed.get_world_size(self.sync_group)
        rows = max(1, int(round(n * self.stats_frac)))
        mean, mean_sq = self._batch_moments(
            x.to(torch.promote_types(x.dtype, torch.float32)), rows)
        var = mean_sq - mean * mean
        self._update_running(mean, var)
        if self.grad_stats in ("frozen", "frozen_var"):
            var = var.detach()
        if self.grad_stats == "frozen":
            mean = mean.detach()
        inv = torch.rsqrt(var + self.eps) * self.weight
        mul = inv.to(x.dtype)[None, :, None, None]
        add = (self.bias - mean * inv).to(x.dtype)[None, :, None, None]
        return x * mul + add


def set_batch_norm_mode(module: nn.Module, stats_frac: float = 1.0,
                        grad_stats: str = "exact") -> None:
    """Give every ``BatchNorm2d`` of ``module`` the JAX package's
    ``bn_stats_frac`` and ``bn_grad_stats`` (``BatchNorm2d``'s doc)."""
    check_bn_settings(grad_stats)
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.stats_frac, m.grad_stats = float(stats_frac), grad_stats


@contextlib.contextmanager
def frozen_statistics(module: nn.Module) -> Iterator[None]:
    """Run the block with every ``BatchNorm2d`` of ``module`` leaving its
    running statistics untouched (a recompute of a forward already counted)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    kept = [m.update_statistics for m in norms]
    for m in norms:
        m.update_statistics = False
    try:
        yield
    finally:
        for m, k in zip(norms, kept):
            m.update_statistics = k


def check_bn_settings(bn_grad_stats: str = "exact") -> None:
    """Raise on a BatchNorm mode the JAX package's ``batch_norm`` does not know."""
    if bn_grad_stats not in ("exact", "fused", "frozen", "frozen_var"):
        raise ValueError(
            f"bn_grad_stats must be 'exact', 'fused', 'frozen_var' or 'frozen', got {bn_grad_stats!r}")


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
