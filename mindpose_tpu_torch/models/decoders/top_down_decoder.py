"""Top-down heatmap decoder: argmax -> sub-pixel refine -> original frame.

Counterpart of mindpose_tpu/models/decoders/top_down_decoder.py for NCHW
heatmaps. Without DARK the whole decode goes through
``ops/cuda/decode.decode_heatmap``: on a CUDA heatmap that is one launch of
the hand-written kernel per call, on a CPU heatmap its plain PyTorch
version. With ``dark_udp_refine`` the argmax comes from the same kernel
(``argmax_shift_decode``, shift off), and the refinement and the
back-projection run as plain PyTorch after it, as the JAX package runs them
as plain XLA.
"""
import dataclasses
import functools
from typing import Tuple

import torch

from ...ops.cuda.decode import argmax_shift_decode, decode_heatmap, preds_and_boxes
from ...ops.heatmap import dark_udp_refine, gaussian_kernel_2d
from ...register import register
from .decoder import Decoder


@functools.cache
def _uploaded_blur_kernel(kernel_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(gaussian_kernel_2d(kernel_size)).to(device)


def _blur_kernel(kernel_size: int, device: torch.device) -> torch.Tensor:
    """The refinement's Gaussian on ``device``, uploaded once per size and device.

    Under ``torch.export`` it is made anew, and becomes a constant of the
    exported program: a tensor made while tracing must not outlive the trace.
    """
    if torch.compiler.is_compiling():
        return torch.from_numpy(gaussian_kernel_2d(kernel_size)).to(device)
    return _uploaded_blur_kernel(kernel_size, device)


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
        if self.dark_udp_refine:
            coords, maxvals = argmax_shift_decode(heatmap, False)
            coords = dark_udp_refine(coords, heatmap,
                                     _blur_kernel(self.kernel_size, heatmap.device))
            return preds_and_boxes(coords, maxvals, heatmap.shape[2:4], center, scale, score,
                                   to_original=self.to_original, use_udp=self.use_udp,
                                   pixel_std=self.pixel_std)
        return decode_heatmap(heatmap, center, scale, score, shift=self.shift_coordinate,
                              to_original=self.to_original, use_udp=self.use_udp,
                              pixel_std=self.pixel_std)
