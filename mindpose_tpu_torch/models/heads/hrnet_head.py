"""HRNet head: a single conv with bias over the high-resolution feature.

Counterpart of mindpose_tpu/models/heads/hrnet_head.py, NCHW. The conv is
named ``head``, as in the JAX package.
"""
import torch
from torch import nn

from ...register import register
from .head import Head


@register("head", extra_name="hrnet_head")
class HRNetHead(Head):
    def __init__(
        self,
        in_channels: int = 32,
        num_joints: int = 17,
        final_conv_kernel_size: int = 1,
    ) -> None:
        super().__init__()
        k = final_conv_kernel_size
        self.head = nn.Conv2d(in_channels, num_joints, k, padding=1 if k == 3 else 0)
        # starts near zero so initial heatmaps sit at the background, as the
        # JAX package's final_kernel_init (truncated normal, sd 1e-3) does
        nn.init.trunc_normal_(self.head.weight, 0.0, 1e-3, -2e-3, 2e-3)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)
