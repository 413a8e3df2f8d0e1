"""SimCC head: coordinate classification over separate x and y bins.

Counterpart of mindpose_tpu/models/heads/simcc_head.py, NCHW ("SimCC: a
Simple Coordinate Classification perspective for Human Pose Estimation",
arXiv:2107.03332). A 1x1 conv maps the backbone's features to K channels;
each channel's map, flattened, goes through two Linear layers shared by the
joints, ``mlp_x`` and ``mlp_y``, which give its logits over ``input_size *
split_ratio`` horizontal and vertical bins. The flax module flattens NHWC
features as ``x.transpose(0, 3, 1, 2).reshape(n, k, h * w)``, which is the
NCHW map's own ``reshape(n, k, h * w)``.

A flax ``Dense`` sizes its kernel from the first input; a torch ``Linear``
is sized when built, so the head takes the backbone's output size
``feature_size`` ((h, w); ``create_network`` passes it). Initial weights are
flax's: lecun normal kernels, zero biases. Both outputs come back in at
least float32 (float32 under bf16 autocast, as the JAX head casts them).

Output: ``(x_logits [N, K, W*ratio], y_logits [N, K, H*ratio])``.
"""
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...register import register
from ..common import dense, lecun_normal_
from .head import Head

__all__ = ["SimCCHead", "at_least_float32"]


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its dtype promoted to at least float32 (a head's output dtype)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@register("head", extra_name="simcc_head")
class SimCCHead(Head):
    """1x1 conv to K channels -> flatten the map -> shared x/y bin Linear layers.

    Args:
        in_channels: backbone output channels.
        num_joints: K.
        input_size: the network input (W, H) in pixels; the bin counts are
            ``int(input_size * split_ratio)``.
        split_ratio: bins per input pixel (the paper's 2.0).
        feature_size: (h, w) of the backbone's output for that input.
        bn_grad_stats: accepted for head_setting uniformity, as in the JAX
            head; this head has no BatchNorm.
    """

    # model_factory.create_network passes the backbone's output size
    needs_feature_size = True

    def __init__(
        self,
        in_channels: int = 2048,
        num_joints: int = 17,
        input_size: Sequence[int] = (192, 256),
        split_ratio: float = 2.0,
        feature_size: Optional[Tuple[int, int]] = None,
        bn_grad_stats: str = "exact",
    ) -> None:
        super().__init__()
        if feature_size is None:
            raise ValueError("simcc_head needs feature_size, the (h, w) of the backbone's "
                             "output; create_network passes it")
        w_bins = int(input_size[0] * split_ratio)
        h_bins = int(input_size[1] * split_ratio)
        features = int(feature_size[0]) * int(feature_size[1])
        self.final_conv = nn.Conv2d(in_channels, num_joints, 1)
        lecun_normal_(self.final_conv.weight, in_channels)
        nn.init.zeros_(self.final_conv.bias)
        self.mlp_x = dense(features, w_bins)
        self.mlp_y = dense(features, h_bins)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.final_conv(x)
        n, k, h, w = x.shape
        x = x.reshape(n, k, h * w)
        return at_least_float32(self.mlp_x(x)), at_least_float32(self.mlp_y(x))
