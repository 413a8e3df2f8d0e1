"""SimCC inferencer: hflip TTA in bin space.

Counterpart of ``mindpose_tpu/engine/inferencer/simcc_inferencer.py``. A
horizontal flip maps pixel x to (W-1) - x, so bin b = x * ratio maps to
(W-1) * ratio - b; reversing the bin axis gives (B-1) - b, which overshoots
by ratio - 1 bins, so the mirrored logits shift left by
``round(split_ratio) - 1`` bins, the edge bin repeated (the heatmap path's
``shift_heatmap``, in bins). The mirrored crops' joints swap by
``flip_index_from_pairs``, and the two views' log-softmaxes are averaged
(after the decoder's softmax, a normalized geometric mean). The merge runs
after the forward, in the head's output dtype (float32 under autocast).
"""
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ...data.transform.utils import flip_index_from_pairs
from ...register import register
from .inferencer import Inferencer
from .topdown_inferencer import TopDownHeatMapInferencer


@register("inferencer", extra_name="simcc")
class SimCCInferencer(TopDownHeatMapInferencer):
    def __init__(self, net, config=None, device=None, amp_level="O0"):
        # bypass TopDownHeatMapInferencer.__init__'s heatmap-output check:
        # the SimCC TTA takes logits, not heatmaps
        Inferencer.__init__(self, net, config=config, device=device, amp_level=amp_level)
        self.decoder = net.decoder

    def load_inference_cfg(self) -> Dict[str, Any]:
        cfg = dict()
        cfg["has_heatmap_output"] = self.config.get("has_heatmap_output", False)
        cfg["hflip_tta"] = self.config["hflip_tta"]
        cfg["shift_heatmap"] = False  # the heatmap path's knob; not for bins
        cfg["flip_pairs"] = np.array(self.config["flip_pairs"])
        return cfg

    @torch.inference_mode()
    def head_outputs(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW crops -> (x_logits, y_logits); under TTA the merged log-softmaxes."""
        net = self.net.net.eval()
        with self.precision():
            xl, yl = net(image)
            if not self._inference_cfg["hflip_tta"]:
                return xl, yl
            xlf, ylf = net(image.flip(3))
        # swap left/right joints, mirror the x bins, realign; the permutation
        # is built from the real joint count
        flip_index = torch.from_numpy(
            flip_index_from_pairs(self._inference_cfg["flip_pairs"], xlf.shape[1])
        ).to(self.device)
        xlf = xlf.index_select(1, flip_index).flip(2)
        ylf = ylf.index_select(1, flip_index)
        shift = int(round(self.decoder.split_ratio)) - 1
        if shift > 0:
            xlf = torch.cat([xlf[..., shift:], xlf[..., -1:].expand(*xlf.shape[:-1], shift)],
                            dim=-1)
        mx = (torch.log_softmax(xl, dim=-1) + torch.log_softmax(xlf, dim=-1)) * 0.5
        my = (torch.log_softmax(yl, dim=-1) + torch.log_softmax(ylf, dim=-1)) * 0.5
        return mx, my
