"""Associative-embedding (grouping) loss over NCHW tag maps.

Counterpart of ``mindpose_tpu/models/loss/ae.py:19-72`` ("End-to-End
Learning for Joint Detection and Grouping", arXiv:1611.05424), in its
gather form: the tag values are gathered at the ground-truth keypoints'
flat indices (``y * w + x``, which names the same pixel in NHWC and in
NCHW), O(N*M*K) instead of a dense [N, M, K, H, W] mask. The tag maps are
cast to float32 as JAX casts them (bf16 under autocast; ``loss_dtype``
keeps a float64 net's float64).
The ``eps`` placements and the ``- num_inst`` that removes the push loss's
diagonal are the JAX package's.
"""
import dataclasses

import torch

from ...register import register
from .loss import Loss, loss_dtype


@register("loss", extra_name="ae")
@dataclasses.dataclass(frozen=True)
class AELoss(Loss):
    """Pull/push grouping loss over tag maps.

    Inputs (tag_per_joint=True):
        pred: tag maps [N, K, H, W]
        target: tag indices [N, M, K, 2]: (flat index into H*W, valid flag);
            padded instance slots carry index 0 with valid 0
    Inputs (tag_per_joint=False):
        pred: [N, H, W]; target: [N, M, 2]

    Output: stacked [push_loss, pull_loss].
    """

    tag_per_joint: bool = True
    eps: float = 0.01

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if not self.tag_per_joint:
            pred = pred[:, None]  # [N, 1, H, W]
            target = target[:, :, None, :]  # [N, M, 1, 2]

        dtype = loss_dtype(pred)
        pred = pred.to(dtype)
        n, k, h, w = pred.shape

        pred_flat = pred.reshape(n, k, h * w)
        ind = target[..., 0].long()  # [N, M, K]
        valid = target[..., 1].to(dtype)  # [N, M, K]

        # tag value at each annotated keypoint position
        tags = torch.gather(pred_flat, 2, ind.permute(0, 2, 1)).permute(0, 2, 1)  # [N, M, K]
        tags = tags * valid

        # per-instance reference embedding
        k_n = valid.sum(dim=2)  # [N, M]
        h_n = tags.sum(dim=2) / (k_n + self.eps)  # [N, M]

        # pull loss: tags toward their instance embedding
        diff = (h_n[:, :, None] - tags) * valid
        pull = torch.square(diff).sum(dim=2) / (k_n + self.eps)  # [N, M]
        inst_mask = (k_n > 0).to(dtype)  # [N, M]
        num_inst = inst_mask.sum(dim=1)  # [N]
        pull_loss = pull.sum(dim=1) / (num_inst + self.eps)

        # push loss: instance embeddings apart
        a = h_n[:, :, None]
        b = h_n[:, None, :]
        push = torch.exp(-torch.square(a - b))  # [N, M, M]
        pair_mask = inst_mask[:, :, None] * inst_mask[:, None, :]
        push = (push * pair_mask).sum(dim=(1, 2)) - num_inst  # remove diagonal
        push_loss = 0.5 * push / (num_inst * (num_inst - 1) + self.eps)

        return torch.stack([self.get_loss(push_loss), self.get_loss(pull_loss)])
