"""COCO top-down dataset: one record per person instance.

Copy of ``mindpose_tpu/data/dataset/coco_topdown.py``. Record contract
(consumed by the transforms and the evaluator): ``image_file``, ``boxes``
(xywh), ``bbox_ids`` (per-image for GT, global for detections),
``bbox_scores``, ``rotation`` and, GT only, ``keypoints`` [K, 3] with
visibility clamped to {0, 1}.

Two sources:
- ground-truth keypoint annotations (``use_gt_bbox_for_val``);
- a person-detection result JSON (category 1, score >= ``det_bbox_thr``),
  the published recipe's eval with detector boxes.

tests/test_torch_eval_copies.py holds it equal to its original.
"""
import json
import os
from typing import Any, Dict, List

import numpy as np

from ...register import register
from ...utils.coco import COCO, image_id_name_maps
from .topdown import TopDownDataset


@register("dataset", extra_name="coco_topdown")
class COCOTopDownDataset(TopDownDataset):
    """Per-instance records from COCO keypoint annotations or from a person
    detection-result JSON filtered by ``det_bbox_thr``."""

    def load_dataset_cfg(self) -> Dict[str, Any]:
        return {"det_bbox_thr": float(self.config.get("det_bbox_thr", 0.0))}

    def load_dataset(self) -> List[Dict[str, Any]]:
        self.coco = COCO(self.annotation_file)
        self.id2name, self.name2id = image_id_name_maps(self.coco.imgs)

        if self.is_train or self.use_gt_bbox_for_val:
            self.img_ids = self.coco.getImgIds()
            records = []
            for img_id in self.img_ids:
                records.extend(self._instance_records(img_id))
            return records
        return self._detection_records()

    def _image_path(self, img_id: int) -> str:
        return os.path.join(self.image_root, self.id2name[img_id])

    def _instance_records(self, img_id: int) -> List[Dict[str, Any]]:
        """GT records for one image: non-crowd, sanitized-bbox, visible-kpt
        instances, numbered 0..n-1 within the image."""
        meta = self.coco.loadImgs(img_id)[0]
        annos = self.coco.loadAnns(
            self.coco.getAnnIds(imgIds=img_id, iscrowd=False)
        )
        annos = self._sanitize_bbox(annos, meta["width"], meta["height"])
        usable = [a for a in annos if self._has_visible_keypoints(a)]

        return [
            {
                "image_file": self._image_path(img_id),
                "keypoints": self._clamped_keypoints(anno),
                "rotation": 0,
                "boxes": anno["bbox"],
                "bbox_ids": slot,
                "bbox_scores": 1.0,
            }
            for slot, anno in enumerate(usable)
        ]

    def _detection_records(self) -> List[Dict[str, Any]]:
        """Records from a detector-output JSON: person class only, score
        threshold applied, numbered globally across the file."""
        with open(self.detection_file, "r") as f:
            detections = json.load(f)

        threshold = self._dataset_cfg["det_bbox_thr"]
        persons = (
            det
            for det in detections
            if det["category_id"] == 1 and det["score"] >= threshold
        )
        return [
            {
                "image_file": self._image_path(det["image_id"]),
                "rotation": 0,
                "boxes": det["bbox"],
                "bbox_ids": slot,
                "bbox_scores": det["score"],
            }
            for slot, det in enumerate(persons)
        ]

    @staticmethod
    def _has_visible_keypoints(anno: Dict[str, Any]) -> bool:
        kpts = anno.get("keypoints")
        if kpts is None or max(kpts) == 0:
            return False
        return anno.get("num_keypoints", -1) != 0

    @staticmethod
    def _clamped_keypoints(anno: Dict[str, Any]) -> np.ndarray:
        """[K, 3] keypoints with COCO visibility 2 ("visible") folded into 1."""
        kpts = np.asarray(anno["keypoints"]).reshape(-1, 3)
        kpts[:, 2] = kpts[:, 2].clip(max=1)
        return kpts
