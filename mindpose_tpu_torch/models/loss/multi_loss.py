"""Multi-resolution heatmap MSE + AE loss for HigherHRNet, in the port's layout.

Counterpart of ``mindpose_tpu/models/loss/multi_loss.py:19-64``, NCHW:
per-level predictions [N, K (+K tags, or +1), H_s, W_s]; targets
[N, S, K, Hmax, Wmax] (the loader's [N, S, Hmax, Wmax, K] with the joint
axis moved before the spatial ones, as the train entry uploads it and the
device pipeline renders it); masks [N, S, Hmax, Wmax]; tag indices
[N, S, M, K, 2]. ``stage_sizes`` are (w, h): level i's target and mask
are cropped to [:h, :w].
"""
import dataclasses
from typing import Sequence, Tuple

import torch

from ...register import register
from .ae import AELoss
from .loss import Loss
from .mse import JointsMSELossWithMask


@register("loss", extra_name="ae_multi_loss")
@dataclasses.dataclass(frozen=True)
class AEMultiLoss(Loss):
    num_joints: int = 17
    num_stages: int = 2
    stage_sizes: Sequence[Tuple[int, int]] = ((128, 128), (256, 256))
    mse_loss_factor: Sequence[float] = (1.0, 1.0)
    ae_loss_factor: Sequence[float] = (0.001, 0.001)
    with_mse_loss: Sequence[bool] = (True, True)
    with_ae_loss: Sequence[bool] = (True, False)
    tag_per_joint: bool = True

    def __call__(
        self,
        preds: Sequence[torch.Tensor],
        target: torch.Tensor,
        mask: torch.Tensor,
        tag_ind: torch.Tensor,
    ) -> torch.Tensor:
        """Returns [mse, push, pull]."""
        mse_criterion = JointsMSELossWithMask()
        ae_criterion = AELoss(tag_per_joint=self.tag_per_joint)

        total_mse = 0.0
        total_push = 0.0
        total_pull = 0.0
        for i in range(self.num_stages):
            w, h = self.stage_sizes[i]
            pred = preds[i]
            if self.with_mse_loss[i]:
                total_mse += (
                    mse_criterion(
                        pred[:, : self.num_joints],
                        target[:, i, :, :h, :w],
                        mask[:, i, :h, :w],
                    )
                    * self.mse_loss_factor[i]
                )
            if self.with_ae_loss[i]:
                if self.tag_per_joint:
                    tag_pred = pred[:, self.num_joints :]
                else:
                    tag_pred = pred[:, self.num_joints]
                push, pull = ae_criterion(tag_pred, tag_ind[:, i]) * self.ae_loss_factor[i]
                total_push += push
                total_pull += pull

        like = next(t for t in (total_mse, total_push, total_pull) if torch.is_tensor(t))
        return torch.stack([torch.as_tensor(t, dtype=like.dtype, device=like.device)
                            for t in (total_mse, total_push, total_pull)])
