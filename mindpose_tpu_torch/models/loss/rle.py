"""Negative log-likelihood loss for direct coordinate regression.

Counterpart of mindpose_tpu/models/loss/rle.py, for the RLE head
(arXiv:2107.11291). The head predicts per keypoint ``(mu, sigma)``; the
loss is the NLL of the ground-truth coordinate under a density centred at
``mu`` with scale ``sigma`` (plus ``eps``):

- ``q_distribution="laplace"`` (default): ``log(2 sigma) + |gt - mu| / sigma``
  per axis, the paper's Q = Laplace baseline;
- ``q_distribution="gaussian"``:
  ``log(sigma sqrt(2 pi)) + (gt - mu)^2 / (2 sigma^2)``.

As in the JAX package, the realNVP flow of the full method is left out: the
losses are stateless functions, and the flow is discarded at inference in
the original too. The loss is taken in ``mu``'s dtype promoted to at least
float32 (``loss_dtype``).
"""
import dataclasses
import math
from typing import Optional, Tuple

import torch

from ...register import register
from .loss import Loss, loss_dtype


@register("loss", extra_name="rle")
@dataclasses.dataclass(frozen=True)
class RLELoss(Loss):
    """Inputs: pred ``(mu [N, K, 2], sigma [N, K, 2])``; target ``[N, K, 2]``
    normalized coordinates (the head's convention); target_weight ``[N, K]``.
    """

    use_target_weight: bool = True
    q_distribution: str = "laplace"
    eps: float = 1e-9

    def __call__(self, pred: Tuple[torch.Tensor, torch.Tensor], target: torch.Tensor,
                 target_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        mu, sigma = pred
        dtype = loss_dtype(mu)
        mu = mu.to(dtype)
        sigma = sigma.to(dtype) + self.eps
        err = (target.to(dtype) - mu) / sigma
        if self.q_distribution == "gaussian":
            nll = torch.log(sigma * math.sqrt(2.0 * math.pi)) + 0.5 * err**2
        elif self.q_distribution == "laplace":
            nll = torch.log(2.0 * sigma) + torch.abs(err)
        else:
            raise ValueError(f"unknown q_distribution: {self.q_distribution!r}")
        loss = torch.sum(nll, dim=-1)  # [N, K]
        if self.use_target_weight and target_weight is not None:
            loss = loss * target_weight.to(dtype)
        return self.get_loss(loss)
