"""Heatmap knowledge distillation loss (teacher-in-the-loop).

Counterpart of mindpose_tpu/models/loss/distill.py: the student regresses
its Gaussian targets and the frozen teacher's heatmaps on the same batch,
whose last column the teacher preprocess appends (``models/distill.py``).
Returns the loss vector ``[task, alpha * distill]``; the train step sums it
for the backward pass and the callback logs each component.
"""
import dataclasses

import torch

from ...register import register
from .loss import Loss, loss_dtype


@register("loss", extra_name="joint_mse_distill")
@dataclasses.dataclass(frozen=True)
class JointsMSEDistillLoss(Loss):
    """MSE(pred, target) + alpha * MSE(pred, teacher_pred).

    Inputs: pred/target/teacher_pred [N, K, H, W]; target_weight [N, K].
    ``use_target_weight`` gates both terms by joint visibility. The teacher's
    heatmaps are detached, as ``stop_gradient`` detaches them; both terms
    are taken in ``loss_dtype(pred)``.
    """

    use_target_weight: bool = True
    alpha: float = 0.5

    def __call__(self, pred: torch.Tensor, target: torch.Tensor, target_weight: torch.Tensor,
                 teacher_pred: torch.Tensor) -> torch.Tensor:
        dtype = loss_dtype(pred)
        pred = pred.to(dtype)
        task = torch.square(pred - target.to(dtype))
        distill = torch.square(pred - teacher_pred.detach().to(dtype))
        weights = target_weight[:, :, None, None] if self.use_target_weight else None
        return torch.stack([self.get_loss(task, weights),
                            self.alpha * self.get_loss(distill, weights)])
