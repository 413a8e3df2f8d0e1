"""SimpleBaseline head: three stride-2 transposed convs with BN and ReLU, then a conv.

Counterpart of mindpose_tpu/models/heads/simple_baseline_head.py, NCHW, with
the official SimpleBaseline torch names: ``deconv_layers`` (a Sequential of
ConvTranspose2d, BatchNorm2d, ReLU per stage, so the stages' convs sit at
0, 3, 6 and their BatchNorms at 1, 4, 7) and ``final_layer``.

Each flax ``ConvTranspose(k, strides=2, padding="SAME")`` (``transpose_kernel``
False) doubles the map's height and width; torch's ``ConvTranspose2d`` does
so with padding 1 at k=4 and 0 at k=2, and with the kernel flipped in both
spatial axes (``models/convert.py`` flips it when it carries JAX weights
across). The JAX head refuses any other kernel size, and so does this one.
``bn_grad_stats`` is the mode of the three BatchNorms (``common.BatchNorm2d``),
at the whole batch's statistics, as in JAX.
"""
from typing import Sequence

import torch
from torch import nn

from ...register import register
from ..common import BatchNorm2d, he_normal_, set_batch_norm_mode
from .head import Head

__all__ = ["SimpleBaselineHead"]

# kernel size -> ConvTranspose2d padding that doubles the size, as flax's "SAME"
DECONV_PADDING = {2: 0, 4: 1}


@register("head", extra_name="simple_baseline_head")
class SimpleBaselineHead(Head):
    """Deconvolution head from `Simple Baselines <https://arxiv.org/abs/1804.06208>`_."""

    def __init__(
        self,
        num_deconv_layers: int = 3,
        num_deconv_filters: Sequence[int] = (256, 256, 256),
        num_deconv_kernels: Sequence[int] = (4, 4, 4),
        in_channels: int = 2048,
        num_joints: int = 17,
        final_conv_kernel_size: int = 1,
        bn_grad_stats: str = "exact",
    ) -> None:
        super().__init__()
        layers = []
        channels = in_channels
        for i in range(num_deconv_layers):
            k = int(num_deconv_kernels[i])
            if k not in DECONV_PADDING:
                raise ValueError("Invalid deconv_kernel.")
            out = int(num_deconv_filters[i])
            deconv = nn.ConvTranspose2d(channels, out, k, stride=2, padding=DECONV_PADDING[k],
                                        bias=False)
            # flax's he_normal counts a transposed conv's fan-in as I * kh * kw
            he_normal_(deconv.weight, fan_in=channels * k * k)
            layers += [deconv, BatchNorm2d(out), nn.ReLU()]
            channels = out
        self.deconv_layers = nn.Sequential(*layers)
        k = final_conv_kernel_size
        self.final_layer = nn.Conv2d(channels, num_joints, k, padding=1 if k == 3 else 0)
        # starts near zero so initial heatmaps sit at the background, as the
        # JAX package's final_kernel_init (truncated normal, sd 1e-3) does
        nn.init.trunc_normal_(self.final_layer.weight, 0.0, 1e-3, -2e-3, 2e-3)
        nn.init.zeros_(self.final_layer.bias)
        set_batch_norm_mode(self, grad_stats=bn_grad_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_layer(self.deconv_layers(x))
