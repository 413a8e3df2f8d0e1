"""RLE regression head: direct keypoint coordinates with a learned scale.

Counterpart of mindpose_tpu/models/heads/rle_head.py, NCHW (the regression
head of "Human Pose Regression with Residual Log-likelihood Estimation",
arXiv:2107.11291 §4). The backbone's features are averaged over the map
(the NHWC mean over axes (1, 2) is the NCHW mean over (2, 3)), and two
Linear layers give, per keypoint, a normalized coordinate ``mu``
(``fc_coord``) and a per-axis uncertainty ``sigma`` in (0, 1)
(``fc_sigma``, then a sigmoid). Initial weights are flax ``Dense``'s.

``mu`` is in units of the network input, ``pixel / (W, H)``, the convention
of the ``rle`` loss, the ``regression`` decoder and
``topdown_generate_regression_target``.

Output: ``(mu [N, K, 2], sigma [N, K, 2])``, in at least float32 (float32
under bf16 autocast, as the JAX head casts them).
"""
from typing import Tuple

import torch

from ...register import register
from ..common import dense
from .head import Head
from .simcc_head import at_least_float32

__all__ = ["RLERegressionHead"]


@register("head", extra_name="rle_head")
class RLERegressionHead(Head):
    """Global average pool -> Linear(2K) ``mu`` and Linear(2K) sigmoid ``sigma``.

    Args:
        in_channels: backbone output channels.
        num_joints: K.
        bn_grad_stats: accepted for head_setting uniformity, as in the JAX
            head; this head has no BatchNorm.
    """

    def __init__(self, in_channels: int = 2048, num_joints: int = 17,
                 bn_grad_stats: str = "exact") -> None:
        super().__init__()
        self.num_joints = num_joints
        self.fc_coord = dense(in_channels, num_joints * 2)
        self.fc_sigma = dense(in_channels, num_joints * 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = x.mean(dim=(2, 3))  # [N, C]
        n = feat.shape[0]
        mu = at_least_float32(self.fc_coord(feat)).reshape(n, self.num_joints, 2)
        sigma = torch.sigmoid(at_least_float32(self.fc_sigma(feat))).reshape(
            n, self.num_joints, 2)
        return mu, sigma
