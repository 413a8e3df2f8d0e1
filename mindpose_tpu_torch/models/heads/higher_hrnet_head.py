"""HigherHRNet head: per-level 1x1 "final" convs and a deconv refinement stage.

Counterpart of mindpose_tpu/models/heads/higher_hrnet_head.py, NCHW, with
the official HigherHRNet torch names: ``final_layers`` (one conv with bias
per level) and ``deconv_layers`` (per refinement stage a Sequential of
ConvTranspose2d, BatchNorm2d, ReLU and the BasicBlocks, so a stage's
transposed conv sits at 0, its BatchNorm at 1 and its blocks from 3 on).

Level 0's conv emits K heatmaps (and K tag maps, or 1, where that level
has the AE loss); the feature, concatenated with that output where
``cat_outputs`` says so, goes through ConvTranspose(k, stride 2) + BN +
ReLU and ``num_basic_blocks`` BasicBlocks, then the next level's conv at
twice the resolution. Returns the list of per-level NCHW outputs.

The JAX head's ``s2d_refine`` (on by default) runs each refinement stage in
2x2 space-to-depth form for the TPU's lanes: the same arithmetic over the
same variables (``ConvTranspose_i``, ``BatchNorm_i``, ``BasicBlock_j``,
``final_i``). It is accepted here and runs as the plain stage, so one
converter (``models/convert.py``) serves checkpoints of either form.
``bn_grad_stats`` is the mode of every BatchNorm of the head (each stage's
and its BasicBlocks', ``common.BatchNorm2d``), at the whole batch's
statistics, as in JAX.
"""
from typing import List, Sequence

import torch
from torch import nn

from ...register import register
from ..backbones.resnet import BasicBlock
from ..common import BatchNorm2d, he_normal_, set_batch_norm_mode
from .head import Head
from .simple_baseline_head import DECONV_PADDING

__all__ = ["HigherHRNetHead"]


@register("head", extra_name="higher_hrnet_head")
class HigherHRNetHead(Head):
    def __init__(
        self,
        in_channels: int = 32,
        num_joints: int = 17,
        with_ae_loss: Sequence[bool] = (True, False),
        tag_per_joint: bool = True,
        final_conv_kernel_size: int = 1,
        num_deconv_layers: int = 1,
        num_deconv_filters: Sequence[int] = (32,),
        num_deconv_kernels: Sequence[int] = (4,),
        cat_outputs: Sequence[bool] = (True,),
        num_basic_blocks: int = 4,
        bn_grad_stats: str = "exact",
        s2d_refine: bool = True,
    ) -> None:
        super().__init__()
        self.num_deconv_layers = num_deconv_layers
        self.cat_outputs = tuple(bool(c) for c in cat_outputs)
        dim_tag = num_joints if tag_per_joint else 1
        final_channels = [num_joints + dim_tag if with_ae_loss[i] else num_joints
                          for i in range(num_deconv_layers + 1)]

        k = final_conv_kernel_size
        finals = [nn.Conv2d(in_channels, final_channels[0], k, padding=1 if k == 3 else 0)]
        stages = []
        channels = in_channels
        for i in range(num_deconv_layers):
            if self.cat_outputs[i]:
                channels += final_channels[i]
            kernel = int(num_deconv_kernels[i])
            if kernel not in DECONV_PADDING:
                raise ValueError("Invalid deconv_kernel.")
            out = int(num_deconv_filters[i])
            deconv = nn.ConvTranspose2d(channels, out, kernel, stride=2,
                                        padding=DECONV_PADDING[kernel], bias=False)
            # flax's he_normal counts a transposed conv's fan-in as I * kh * kw
            he_normal_(deconv.weight, fan_in=channels * kernel * kernel)
            blocks = [BasicBlock(out, out) for _ in range(num_basic_blocks)]
            stages.append(nn.Sequential(deconv, BatchNorm2d(out), nn.ReLU(), *blocks))
            finals.append(nn.Conv2d(out, final_channels[i + 1], k, padding=1 if k == 3 else 0))
            channels = out
        for conv in finals:
            # starts near zero, as the JAX package's final_kernel_init
            # (truncated normal, sd 1e-3) does
            nn.init.trunc_normal_(conv.weight, 0.0, 1e-3, -2e-3, 2e-3)
            nn.init.zeros_(conv.bias)
        self.final_layers = nn.ModuleList(finals)
        self.deconv_layers = nn.ModuleList(stages)
        set_batch_norm_mode(self, grad_stats=bn_grad_stats)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = self.final_layers[0](x)
        outputs = [y]
        for i in range(self.num_deconv_layers):
            if self.cat_outputs[i]:
                x = torch.cat([x, y], dim=1)
            x = self.deconv_layers[i](x)
            y = self.final_layers[i + 1](x)
            outputs.append(y)
        return outputs
