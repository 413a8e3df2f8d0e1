"""Regression decoder: normalized (mu, sigma) -> original-frame keypoints.

Counterpart of mindpose_tpu/models/decoders/regression_decoder.py, in plain
PyTorch on the outputs' device (no kernel in the JAX package either).
``mu`` is in input-size units; times the input size it is in crop pixels,
which the top-down decoder's back-projection maps to the original frame
with the input size in place of the heatmap size
(``ops/cuda/decode.preds_and_boxes``). The keypoint score is
``clip(1 - mean(sigma), 0, 1)``, the RLE paper's confidence at inference.
"""
import dataclasses
from typing import Sequence, Tuple

import torch

from ...ops.cuda.decode import preds_and_boxes
from ...register import register
from .decoder import Decoder


@register("decoder", extra_name="regression")
@dataclasses.dataclass(frozen=True)
class RegressionDecoder(Decoder):
    """Inputs: ``(mu [N, K, 2], sigma [N, K, 2])``; center [N, 2]; scale [N, 2];
    score [N].
    Outputs: preds [N, K, 3]; boxes [N, 6], as ``TopDownHeatMapDecoder``'s.
    """

    input_size: Sequence[int] = (192, 256)  # (W, H)
    pixel_std: float = 200.0
    to_original: bool = True

    def __post_init__(self):
        # yaml lists are unhashable; the dataclass stays hashable
        object.__setattr__(self, "input_size", tuple(self.input_size))

    def __call__(
        self,
        pred: Tuple[torch.Tensor, torch.Tensor],
        center: torch.Tensor,
        scale: torch.Tensor,
        score: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        mu, sigma = pred
        mu = mu.to(torch.float32)
        center = center.to(torch.float32)
        scale = scale.to(torch.float32)
        score = score.to(torch.float32).reshape(mu.shape[0])

        w, h = int(self.input_size[0]), int(self.input_size[1])
        coords = mu * torch.tensor([w, h], dtype=torch.float32, device=mu.device)  # crop pixels
        maxvals = torch.clamp(1.0 - sigma.to(torch.float32).mean(dim=-1), 0.0, 1.0)
        return preds_and_boxes(coords, maxvals, (h, w), center, scale, score,
                               to_original=self.to_original, use_udp=False,
                               pixel_std=self.pixel_std)
