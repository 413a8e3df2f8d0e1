"""Top-down heatmap decoder: argmax -> quarter-pixel shift -> original frame.

Counterpart of mindpose_tpu/models/decoders/top_down_decoder.py for NCHW
heatmaps. The argmax and shift go through ``ops/cuda/decode.argmax_shift_decode``:
on a CUDA heatmap that is the hand-written kernel, on a CPU heatmap its plain
PyTorch version. DARK/UDP refinement is not ported yet.
"""
import dataclasses
from typing import Tuple

import torch

from ...ops.cuda.decode import argmax_shift_decode
from ...register import register
from .decoder import Decoder


@register("decoder", extra_name="topdown_heatmap")
@dataclasses.dataclass(frozen=True)
class TopDownHeatMapDecoder(Decoder):
    """Decode NCHW heatmaps into keypoint coordinates with boxes.

    Inputs: heatmap [N, K, H, W]; center [N, 2]; scale [N, 2]; score [N].
    Outputs: preds [N, K, 3(x, y, score)];
             boxes [N, 6(cx, cy, sx, sy, area, box_score)].

    ``backend`` is accepted so that the JAX package's decoder settings load,
    and has no effect: the device of the heatmap picks the implementation.
    """

    pixel_std: float = 200.0
    to_original: bool = True
    shift_coordinate: bool = False
    use_udp: bool = False
    dark_udp_refine: bool = False
    kernel_size: int = 11
    backend: str = "xla"

    def __post_init__(self):
        if self.dark_udp_refine and self.shift_coordinate:
            raise ValueError(
                "`dark_udp_refine` and `shift_coordinate` cannot both be true."
            )
        if self.dark_udp_refine:
            raise NotImplementedError(
                "dark_udp_refine is not ported yet (ROADMAP.md, Queue 1 #5: "
                "ResNet, simple_baseline_head and UDP)"
            )

    def __call__(
        self,
        heatmap: torch.Tensor,
        center: torch.Tensor,
        scale: torch.Tensor,
        score: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        heatmap = heatmap.to(torch.float32)
        center = center.to(torch.float32)
        scale = scale.to(torch.float32)
        score = score.to(torch.float32).reshape(heatmap.shape[0])

        coords, maxvals = argmax_shift_decode(heatmap, self.shift_coordinate)
        if self.to_original:
            coords = self._transform_preds(coords, center, scale, heatmap.shape[2:4])

        preds = torch.cat([coords[..., :2], maxvals[..., None]], dim=-1)
        area = torch.prod(scale * self.pixel_std, dim=1)
        boxes = torch.cat([center, scale, area[:, None], score[:, None]], dim=1)
        return preds, boxes

    def _transform_preds(
        self,
        coords: torch.Tensor,
        center: torch.Tensor,
        scale: torch.Tensor,
        heatmap_hw: Tuple[int, int],
    ) -> torch.Tensor:
        """Map heatmap coords back to the raw-image frame."""
        h, w = heatmap_hw
        scale = scale * self.pixel_std
        if self.use_udp:
            scale_x = scale[:, 0:1] / (w - 1.0)
            scale_y = scale[:, 1:2] / (h - 1.0)
        else:
            scale_x = scale[:, 0:1] / w
            scale_y = scale[:, 1:2] / h
        x = coords[..., 0] * scale_x + center[:, 0:1] - scale[:, 0:1] * 0.5
        y = coords[..., 1] * scale_y + center[:, 1:2] - scale[:, 1:2] * 0.5
        return torch.stack([x, y], dim=-1)
