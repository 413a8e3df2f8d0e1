"""COCO bottom-up dataset: one record per image, with all its persons.

Counterpart of ``mindpose_tpu/data/dataset/coco_bottomup.py``. A train
record carries the image's keypoints, one copy per heatmap level, the
persons' boxes, and the bit-packed validity mask that blanks crowd and
keypointless segments (rasterized with the copies of the COCO
segmentation codecs, ``utils/coco.py``); frames without annotations are
skipped. A val record is the image file alone. tests/test_torch_eval_copies.py
holds the val records equal to the JAX dataset's,
tests/test_torch_bottomup_train_data.py the train records.
"""
import os
from typing import Any, Dict, List

import numpy as np

from ...register import register
from ...utils.coco import COCO, annotation_to_mask, image_id_name_maps
from ..transform.topdown_transform import _cv2
from .bottomup import BottomUpDataset


@register("dataset", extra_name="coco_bottomup")
class COCOBottomUpDataset(BottomUpDataset):
    def load_dataset_cfg(self) -> Dict[str, Any]:
        c = self.config
        if not self.is_train:
            return {}
        return {
            "sigma": float(c["sigma"]),
            "heatmap_sizes": c["heatmap_sizes"],
            "expand_mask": c["expand_mask"],
        }

    @property
    def _num_levels(self) -> int:
        return len(self._dataset_cfg["heatmap_sizes"])

    def load_dataset(self) -> List[Dict[str, Any]]:
        self.coco = COCO(self.annotation_file)
        self.id2name, self.name2id = image_id_name_maps(self.coco.imgs)
        self.img_ids = self.coco.getImgIds()
        if not self.is_train:
            return [{"image_file": os.path.join(self.image_root, self.id2name[img_id])}
                    for img_id in self.img_ids]
        records = []
        for img_id in self.img_ids:
            anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))
            if not anns:
                continue  # nothing to supervise on this frame
            records.append(self._build_record(img_id, anns))
        return records

    def _build_record(self, img_id: int, anns: List[dict]) -> Dict[str, Any]:
        info = self.coco.loadImgs(img_id)[0]
        mask_info = self._validity_mask(anns, info["height"], info["width"])

        # crowd regions with no labeled keypoints are masked out, not
        # regressed against
        people = [a for a in anns
                  if not (a.get("iscrowd", 0) and a["num_keypoints"] == 0)]
        if people:
            kpts = np.stack([np.asarray(a["keypoints"], np.float64)
                             .reshape(-1, 3) for a in people])
            xywh = np.stack([np.asarray(a["bbox"], np.float64)
                             for a in people])
            corners = np.concatenate(
                [xywh[:, :2], xywh[:, :2] + xywh[:, 2:4]], axis=-1
            ).reshape(-1, 2, 2)
        else:
            kpts = np.zeros((1, self.num_joints, 3))
            corners = np.zeros((1, 2, 2))

        return {
            "image_file": os.path.join(self.image_root, self.id2name[img_id]),
            # one keypoint copy per heatmap level: [levels, M, K, 3]
            "keypoints": np.tile(kpts[None], (self._num_levels, 1, 1, 1)),
            "boxes": corners,  # [M, 2, 2] xyxy
            "mask_info": mask_info,
        }

    def _validity_mask(self, anns: List[dict], height: int,
                       width: int) -> Dict[str, Any]:
        """Bit-packed per-level mask of pixels the loss may supervise.

        Crowd segments and segments with zero labeled keypoints are blanked;
        with ``expand_mask`` each level's mask is additionally eroded by a
        3-sigma disk at that level's stride so Gaussian tails near blanked
        regions don't leak gradient.
        """
        blocked = np.zeros((height, width), np.float32)
        for a in anns:
            seg = a.get("segmentation")
            if seg and (a.get("iscrowd", 0) or a["num_keypoints"] == 0):
                blocked += annotation_to_mask(seg, height, width)
        valid = np.tile(blocked[None] < 0.5, (self._num_levels, 1, 1))

        if self._dataset_cfg["expand_mask"]:
            cv2 = _cv2()
            sigma = self._dataset_cfg["sigma"]
            for lvl in range(self._num_levels):
                r = int(3 * sigma * (2 ** (self._num_levels - lvl)))
                disk = np.zeros((2 * r + 1, 2 * r + 1), np.uint8)
                cv2.circle(disk, (r, r), r, 1, -1)
                valid[lvl] = cv2.erode(
                    valid[lvl].astype(np.uint8), disk).astype(bool)

        return {"encoded_mask": np.packbits(valid), "count": valid.size,
                "shape": valid.shape}
