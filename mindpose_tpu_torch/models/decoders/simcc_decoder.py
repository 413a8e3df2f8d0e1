"""SimCC decoder: per-axis bin argmax -> input pixels -> original frame.

Counterpart of mindpose_tpu/models/decoders/simcc_decoder.py, in plain
PyTorch on the logits' device (the JAX package decodes it with plain XLA
operations too; it has no kernel). The argmax is taken over the softmax,
not over the logits, as JAX takes it: two logits a rounding apart can be
equal after the softmax, and then the first bin wins. The bins over
``split_ratio`` are input-image pixels, which the top-down decoder's
back-projection maps to the original frame with the input size in place of
the heatmap size (``ops/cuda/decode.preds_and_boxes``). The keypoint score
is the softmax peak normalized by a sum-1 discrete Gaussian's,
``min(max px, max py) * sigma * sqrt(2 pi)``, so that a confident joint
scores ~1 against the evaluator's ``vis_thr``.
"""
import dataclasses
import math
from typing import Sequence, Tuple

import torch

from ...ops.cuda.decode import preds_and_boxes
from ...register import register
from .decoder import Decoder


@register("decoder", extra_name="simcc")
@dataclasses.dataclass(frozen=True)
class SimCCDecoder(Decoder):
    """Inputs: ``(x_logits [N, K, Bx], y_logits [N, K, By])``; center [N, 2];
    scale [N, 2]; score [N].
    Outputs: preds [N, K, 3]; boxes [N, 6], as ``TopDownHeatMapDecoder``'s.
    """

    input_size: Sequence[int] = (192, 256)  # (W, H)
    split_ratio: float = 2.0
    sigma: float = 6.0  # the labels' sigma in bins; normalizes the score
    pixel_std: float = 200.0
    to_original: bool = True

    def __post_init__(self):
        # yaml lists are unhashable; the dataclass stays hashable
        object.__setattr__(self, "input_size", tuple(self.input_size))

    def __call__(
        self,
        logits: Tuple[torch.Tensor, torch.Tensor],
        center: torch.Tensor,
        scale: torch.Tensor,
        score: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_logits, y_logits = logits
        center = center.to(torch.float32)
        scale = scale.to(torch.float32)
        score = score.to(torch.float32).reshape(x_logits.shape[0])

        px = torch.softmax(x_logits.to(torch.float32), dim=-1)
        py = torch.softmax(y_logits.to(torch.float32), dim=-1)
        # a tensor divisor: a Python scalar would be a reciprocal multiply on the card
        ratio = torch.tensor(self.split_ratio, dtype=torch.float32, device=px.device)
        x = torch.argmax(px, dim=-1).to(torch.float32) / ratio
        y = torch.argmax(py, dim=-1).to(torch.float32) / ratio
        # the peak of a sum-1 discrete Gaussian is ~1 / (sigma sqrt(2 pi))
        peak = self.sigma * math.sqrt(2.0 * math.pi)
        maxvals = torch.minimum(px.amax(dim=-1) * peak, py.amax(dim=-1) * peak)
        w, h = int(self.input_size[0]), int(self.input_size[1])
        return preds_and_boxes(torch.stack([x, y], dim=-1), maxvals, (h, w), center, scale,
                               score, to_original=self.to_original, use_udp=False,
                               pixel_std=self.pixel_std)
