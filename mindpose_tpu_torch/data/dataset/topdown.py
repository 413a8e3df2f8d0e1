"""Top-down dataset base: per-bbox records. A copy of ``mindpose_tpu/data/dataset/topdown.py``.

Records are plain dicts that flow through the transforms; images are
decoded lazily by the loader. ``_sanitize_bbox`` clips boxes into the image
and drops degenerate ones. tests/test_torch_eval_copies.py holds it equal to
its original.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np

from .base import RecordDataset


class TopDownDataset(RecordDataset):
    """Indexable dataset of per-instance records.

    Record keys: image_file, boxes (xywh), keypoints [K, 3] (train/gt),
    rotation, bbox_ids, bbox_scores.
    """

    def __init__(
        self,
        image_root: str,
        annotation_file: Optional[str] = None,
        is_train: bool = False,
        num_joints: int = 17,
        use_gt_bbox_for_val: bool = False,
        detection_file: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        # set before super().__init__ — load_dataset reads them
        self.use_gt_bbox_for_val = use_gt_bbox_for_val
        self.detection_file = detection_file
        if annotation_file is None and not is_train and not use_gt_bbox_for_val:
            raise ValueError(
                "For evaluation, `detection_file` must be provided "
                "when `use_gt_bbox_for_val` is `False`"
            )
        super().__init__(
            image_root,
            annotation_file=annotation_file,
            is_train=is_train,
            num_joints=num_joints,
            config=config,
        )

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        record = self._dataset[idx]
        state: Dict[str, Any] = {
            "image_file": record["image_file"],
            "boxes": np.asarray(record["boxes"], dtype=np.float32),
            "rotation": np.float32(record.get("rotation", 0.0)),
            "bbox_ids": np.int32(record.get("bbox_ids", 0)),
            "bbox_scores": np.float32(record.get("bbox_scores", 1.0)),
        }
        if "keypoints" in record:
            state["keypoints"] = np.asarray(record["keypoints"], dtype=np.float32)
        return state

    @staticmethod
    def _sanitize_bbox(
        annos: List[Dict], img_width: int, img_height: int
    ) -> List[Dict[str, Any]]:
        """Clip boxes into the image; drop degenerate/empty ones.

        Recipe (ref topdown.py:8-141): clamp the top-left into the image,
        clamp the bottom-right (inclusive-pixel convention, hence the -1s)
        and keep only boxes with positive extent and positive COCO area.
        """
        boxed = [a for a in annos if "bbox" in a]
        if not boxed:
            return []
        xywh = np.asarray([a["bbox"] for a in boxed], dtype=np.float64)
        tl = np.maximum(xywh[:, :2], 0.0)
        br_limit = np.array([img_width - 1, img_height - 1], np.float64)
        br = np.minimum(tl + np.maximum(xywh[:, 2:] - 1.0, 0.0), br_limit)
        extent_ok = (br > tl).all(axis=1)

        kept = []
        for anno, keep, p1, p2 in zip(boxed, extent_ok, tl, br):
            if not keep or anno.get("area", 1) <= 0:
                continue
            valid = deepcopy(anno)
            valid["bbox"] = [
                float(p1[0]),
                float(p1[1]),
                float(p2[0] - p1[0]),
                float(p2[1] - p1[1]),
            ]
            kept.append(valid)
        return kept
