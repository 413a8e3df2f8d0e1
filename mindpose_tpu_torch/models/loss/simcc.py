"""KL-divergence loss over SimCC bin distributions.

Counterpart of mindpose_tpu/models/loss/simcc.py, for the SimCC head
(arXiv:2107.03332 §3.2). The targets are per-joint discrete Gaussian label
distributions over the x and y bins, each summing to 1
(``topdown_generate_simcc_target``), so KL(target || softmax(logits)) is
the cross-entropy up to a constant; the target weight masks invisible
joints. The log-softmax and the loss are taken in the logits' dtype
promoted to at least float32 (``loss_dtype``): float32 for a bf16 or
float32 net, as the JAX package takes them, float64 for a float64 net.
"""
import dataclasses
from typing import Optional, Tuple

import torch

from ...register import register
from .loss import Loss, loss_dtype


@register("loss", extra_name="kl_discret")
@dataclasses.dataclass(frozen=True)
class KLDiscretLoss(Loss):
    """Inputs: pred ``(x_logits [N, K, Bx], y_logits [N, K, By])``;
    target ``[N, K, Bx+By]`` (x labels, then y labels, each summing to 1);
    target_weight ``[N, K]``.
    """

    use_target_weight: bool = True

    def __call__(self, pred: Tuple[torch.Tensor, torch.Tensor], target: torch.Tensor,
                 target_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_logits, y_logits = pred
        dtype = loss_dtype(x_logits)
        bx = x_logits.shape[-1]
        tx = target[..., :bx].to(dtype)
        ty = target[..., bx:].to(dtype)

        def ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:  # [N, K]
            logp = torch.log_softmax(logits.to(dtype), dim=-1)
            return -torch.sum(labels * logp, dim=-1)

        loss = ce(x_logits, tx) + ce(y_logits, ty)
        if self.use_target_weight and target_weight is not None:
            loss = loss * target_weight.to(dtype)
        return self.get_loss(loss)
