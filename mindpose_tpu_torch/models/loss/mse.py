"""Joint MSE losses over NCHW heatmaps.

Counterpart of mindpose_tpu/models/loss/mse.py, in the port's layout:
heatmaps [N, K, H, W], target weights [N, K], masks [N, H, W]. The loss is
taken in the heatmaps' dtype promoted to at least float32 (``loss_dtype``).
The target weight multiplies the squared error once, as in the JAX package
(not squared, as the reference's HRNet loss has it).
"""
import dataclasses
from typing import Optional

import torch

from ...register import register
from .loss import Loss, loss_dtype


@register("loss", extra_name="joint_mse")
@dataclasses.dataclass(frozen=True)
class JointsMSELoss(Loss):
    """MSE over heatmaps with optional per-joint target weights.

    Inputs: pred/target [N, K, H, W]; target_weight [N, K].
    """

    use_target_weight: bool = False

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 target_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = loss_dtype(pred)
        loss = torch.square(pred.to(dtype) - target.to(dtype))
        if self.use_target_weight:
            return self.get_loss(loss, target_weight[:, :, None, None])
        return self.get_loss(loss)


@register("loss", extra_name="joint_mse_with_mask")
@dataclasses.dataclass(frozen=True)
class JointsMSELossWithMask(Loss):
    """MSE over heatmaps where masked-out pixels do not contribute.

    Inputs: pred/target [N, K, H, W]; mask [N, H, W].
    """

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        dtype = loss_dtype(pred)
        loss = torch.square(pred.to(dtype) - target.to(dtype))
        return self.get_loss(loss, mask[:, None, :, :].to(dtype))
