"""Top-down heatmap decoder: argmax -> quarter-pixel shift -> original frame.

Counterpart of mindpose_tpu/models/decoders/top_down_decoder.py for NCHW
heatmaps. The whole decode goes through ``ops/cuda/decode.decode_heatmap``:
on a CUDA heatmap that is one launch of the hand-written kernel per call, on
a CPU heatmap its plain PyTorch version. DARK/UDP refinement is not ported yet.
"""
import dataclasses
from typing import Tuple

import torch

from ...ops.cuda.decode import decode_heatmap
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
                "dark_udp_refine is not ported yet (ROADMAP.md, Queue 1, "
                "ResNet, simple_baseline_head and UDP)"
            )

    def __call__(
        self,
        heatmap: torch.Tensor,
        center: torch.Tensor,
        scale: torch.Tensor,
        score: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        heatmap = heatmap.to(torch.float32).contiguous()
        center = center.to(torch.float32).contiguous()
        scale = scale.to(torch.float32).contiguous()
        score = score.to(torch.float32).reshape(heatmap.shape[0]).contiguous()
        return decode_heatmap(heatmap, center, scale, score, shift=self.shift_coordinate,
                              to_original=self.to_original, use_udp=self.use_udp,
                              pixel_std=self.pixel_std)
