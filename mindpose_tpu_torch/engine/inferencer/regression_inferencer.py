"""Regression inferencer: hflip TTA in normalized-coordinate space.

Counterpart of ``mindpose_tpu/engine/inferencer/regression_inferencer.py``,
for the RLE head. A horizontal flip maps pixel x to (W-1) - x, so a
normalized ``mu`` from the mirrored crop maps back as ``1 - 1/W - mu`` on
the x axis; the left and right joints swap by ``flip_index_from_pairs``;
the two views' ``mu`` and ``sigma`` are averaged (the uncertainty is the
same in either view). The merge runs after the
forward, in the head's output dtype (float32 under autocast).
"""
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ...data.transform.utils import flip_index_from_pairs
from ...register import register
from .inferencer import Inferencer
from .topdown_inferencer import TopDownHeatMapInferencer


@register("inferencer", extra_name="regression")
class RegressionInferencer(TopDownHeatMapInferencer):
    def __init__(self, net, config=None, device=None, amp_level="O0"):
        # bypass TopDownHeatMapInferencer.__init__'s heatmap-output check:
        # the regression TTA takes (mu, sigma), not heatmaps
        Inferencer.__init__(self, net, config=config, device=device, amp_level=amp_level)
        self.decoder = net.decoder

    def load_inference_cfg(self) -> Dict[str, Any]:
        cfg = dict()
        cfg["has_heatmap_output"] = self.config.get("has_heatmap_output", False)
        cfg["hflip_tta"] = self.config["hflip_tta"]
        cfg["shift_heatmap"] = False  # the heatmap path's knob; not for coordinates
        cfg["flip_pairs"] = np.array(self.config["flip_pairs"])
        return cfg

    @torch.inference_mode()
    def head_outputs(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW crops -> (mu, sigma); under TTA averaged with the mirrored crops'."""
        net = self.net.net.eval()
        with self.precision():
            mu, sigma = net(image)
            if not self._inference_cfg["hflip_tta"]:
                return mu, sigma
            muf, sigmaf = net(image.flip(3))
        # swap left/right joints and mirror x back; the permutation is built
        # from the real joint count
        flip_index = torch.from_numpy(
            flip_index_from_pairs(self._inference_cfg["flip_pairs"], muf.shape[1])
        ).to(self.device)
        muf = muf.index_select(1, flip_index)
        sigmaf = sigmaf.index_select(1, flip_index)
        inv_w = 1.0 / float(self.decoder.input_size[0])
        muf = torch.stack([1.0 - inv_w - muf[..., 0], muf[..., 1]], dim=-1)
        return (mu + muf) * 0.5, (sigma + sigmaf) * 0.5
