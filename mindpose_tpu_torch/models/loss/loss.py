"""Loss base: stateless callables over tensors.

Counterpart of mindpose_tpu/models/loss/loss.py. The reduction follows
MindSpore's ``LossBase.get_loss``, as the JAX package's does: the weight
multiplies elementwise, then the reduction runs over *all* elements.
"""
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Loss:
    reduction: Optional[str] = "mean"

    def get_loss(self, x: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        if weights is not None:
            x = x * weights
        if self.reduction == "mean":
            return x.mean()
        if self.reduction == "sum":
            return x.sum()
        return x
