"""Top-down heatmap inferencer with optional hflip TTA.

Counterpart of ``mindpose_tpu/engine/inferencer/topdown_inferencer.py``,
for NCHW heatmaps. Per batch: upload, NHWC -> NCHW once, the forward; with
``hflip_tta`` the forward of the mirrored crops too, mirrored back along W,
its joint channels swapped by ``flip_index_from_pairs``, shifted 1 px right
with ``shift_heatmap``, and averaged with the first; then the decoder,
which on a CUDA heatmap is one launch of the decode kernel per batch.
"""
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...data.transform.utils import flip_index_from_pairs
from ...register import register
from .inferencer import Inferencer


@register("inferencer", extra_name="topdown_heatmap")
class TopDownHeatMapInferencer(Inferencer):
    def __init__(self, net, config=None, device=None, amp_level="O0"):
        super().__init__(net, config=config, device=device, amp_level=amp_level)
        self.decoder = net.decoder

        if self._inference_cfg["hflip_tta"]:
            if not self._inference_cfg["has_heatmap_output"]:
                raise ValueError("flip TTA needs heatmap output.")

    def load_inference_cfg(self) -> Dict[str, Any]:
        cfg = dict()
        cfg["has_heatmap_output"] = self.config["has_heatmap_output"]
        cfg["hflip_tta"] = self.config["hflip_tta"]
        cfg["shift_heatmap"] = self.config["shift_heatmap"]
        cfg["flip_pairs"] = np.array(self.config["flip_pairs"])
        return cfg

    @torch.inference_mode()
    def heatmaps(self, image: torch.Tensor) -> torch.Tensor:
        """NCHW crops -> [N, K, H, W] heatmaps, merged with the mirrored
        crops' under TTA, in the forward's output dtype. The net runs in eval
        mode, as the JAX package applies it with ``train=False``, whatever mode
        a train step left it in."""
        net = self.net.net.eval()
        with self.precision():
            heatmap = net(image)
            if not self._inference_cfg["hflip_tta"]:
                return heatmap
            flipped = net(image.flip(3))
        # flip back: mirror width, swap left/right joints (NCHW: K is dim 1);
        # the permutation is built from the real channel count
        flip_index = torch.from_numpy(
            flip_index_from_pairs(self._inference_cfg["flip_pairs"], flipped.shape[1])
        ).to(self.device)
        flipped = flipped.flip(3).index_select(1, flip_index)
        if self._inference_cfg["shift_heatmap"]:
            # 1-px right shift of the flipped map
            flipped = torch.cat([flipped[..., :1], flipped[..., :-1]], dim=3)
        return (heatmap + flipped) * 0.5

    def head_outputs(self, image: torch.Tensor) -> Any:
        """What the decoder takes for these crops: here the heatmaps; the
        SimCC and regression inferencers merge their heads' outputs instead."""
        return self.heatmaps(image)

    @torch.inference_mode()
    def infer_batch(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """One loader batch -> (preds [N, K, 3], boxes [N, 6], the head's
        outputs as ``head_outputs`` gives them), on the device."""
        image = self._upload(batch["image"]).permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        outputs = self.head_outputs(image)
        preds, boxes = self.decoder(outputs, self._upload(batch["center"]),
                                    self._upload(batch["scale"]),
                                    self._upload(batch["bbox_scores"]))
        return preds, boxes, outputs

    def infer(self, dataset) -> List[Dict[str, Any]]:
        outputs: List[Dict[str, Any]] = []
        for batch in dataset:
            preds, boxes, _ = self.infer_batch(batch)
            preds, boxes = preds.cpu().numpy(), boxes.cpu().numpy()
            for pred, box, image_path, bbox_id in zip(
                preds, boxes, batch["image_file"], batch["bbox_ids"]
            ):
                outputs.append(
                    dict(
                        pred=pred.tolist(),
                        box=box.tolist(),
                        image_path=str(image_path),
                        bbox_id=int(bbox_id),
                    )
                )
        return outputs
