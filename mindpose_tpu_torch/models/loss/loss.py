"""Loss base: stateless callables over tensors.

Counterpart of mindpose_tpu/models/loss/loss.py. The reduction follows
MindSpore's ``LossBase.get_loss``, as the JAX package's does: the weight
multiplies elementwise, then the reduction runs over *all* elements.

The losses are taken in the prediction's dtype promoted to at least
float32 (``loss_dtype``): float32 for a bf16, fp16 or float32 net, as the
JAX package takes its losses, and float64 for a float64 net.
"""
import dataclasses
from typing import Optional

import torch

__all__ = ["Loss", "loss_dtype"]


def loss_dtype(pred: torch.Tensor) -> torch.dtype:
    """The dtype a loss over ``pred`` is taken in: ``pred``'s, at least float32."""
    return torch.promote_types(pred.dtype, torch.float32)


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
