"""Top-down distance-metric evaluator: PCK / AUC / EPE / NME.

Copy of ``mindpose_tpu/engine/evaluator/keypoint_evaluator.py`` on the port's
``Evaluator`` and its copy of ``utils/keypoint_metrics.py``. Each predicted
instance is matched to a ground-truth annotation of the same image by
nearest bbox center (exact under GT-bbox evaluation, ``val_use_gt_bbox:
True``, where every record's center came from one annotation's bbox); the
first record per (image, bbox_id) wins; then the distance metrics run over
the labeled joints.

Config keys (all optional): ``pck_thr`` (default 0.2), ``pck_norm_item``
("bbox" default: per-axis bbox w/h; "head": PCKh — isotropic
``head_scale`` x head-segment length between GT joints ``head_pair``,
MPII convention pair (9, 8) / scale 0.6), ``auc_norm`` (default 30.0 px),
``nme_norm_item`` ("bbox" default: sqrt of bbox area).
Register name: ``topdown_keypoint``. tests/test_torch_keypoint_eval.py
holds it equal to its original.
"""
import logging
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ...register import register
from ...utils.keypoint_metrics import (
    keypoint_auc,
    keypoint_epe,
    keypoint_nme,
    keypoint_pck_accuracy,
)
from .evaluator import Evaluator


@register("evaluator", extra_name="topdown_keypoint")
class TopDownKeypointEvaluator(Evaluator):
    SUPPORT_METRICS = {"PCK", "AUC", "EPE", "NME"}

    def __init__(
        self,
        annotation_file: str,
        metric: Union[str, List[str]] = "PCK",
        num_joints: int = 17,
        config: Optional[Dict[str, Any]] = None,
        result_path: str = "",
    ) -> None:
        # ``result_path`` is accepted as the entries pass it to every
        # evaluator; this one writes no result file
        super().__init__(
            annotation_file, metric=metric, num_joints=num_joints, config=config
        )
        self._gt_by_image = self._index_ground_truth()

    def load_evaluation_cfg(self) -> Dict[str, Any]:
        norm_item = self.config.get("pck_norm_item", "bbox")
        if norm_item not in ("bbox", "head"):
            raise ValueError(f"unknown pck_norm_item: {norm_item!r}")
        return {
            "pck_thr": float(self.config.get("pck_thr", 0.2)),
            "pck_norm_item": norm_item,
            "head_pair": tuple(self.config.get("head_pair", (9, 8))),
            "head_scale": float(self.config.get("head_scale", 0.6)),
            "auc_norm": float(self.config.get("auc_norm", 30.0)),
            "nme_norm_item": self.config.get("nme_norm_item", "bbox"),
        }

    def _index_ground_truth(self) -> Dict[int, List[Dict[str, np.ndarray]]]:
        """image_id -> [{center, bbox_wh, joints(K,2), vis(K,)}] for every
        annotation carrying at least one labeled keypoint."""
        by_image: Dict[int, List[Dict[str, np.ndarray]]] = defaultdict(list)
        for ann in self.coco.loadAnns(self.coco.getAnnIds()):
            kpts = np.asarray(
                ann.get("keypoints", []), np.float64
            ).reshape(-1, 3)[: self.num_joints]
            if kpts.size == 0 or not (kpts[:, 2] > 0).any():
                continue
            x, y, w, h = np.asarray(ann["bbox"], np.float64)
            by_image[int(ann["image_id"])].append(
                dict(
                    center=np.array([x + w / 2, y + h / 2]),
                    bbox_wh=np.array([max(w, 1.0), max(h, 1.0)]),
                    joints=kpts[:, :2],
                    vis=kpts[:, 2] > 0,
                )
            )
        return by_image

    def _match_records(
        self, records: List[Dict[str, Any]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Pair each deduped record with its nearest-center GT annotation.

        Returns stacked (preds (N,K,2), gts (N,K,2), mask (N,K), bbox (N,2)).
        """
        seen = set()
        preds, gts, masks, boxes = [], [], [], []
        unmatched = 0
        for record in records:
            image_id = self.name2id[os.path.basename(record["image_path"])]
            key = (image_id, record["bbox_id"])
            if key in seen:  # TTA / padding duplicates: first record wins
                continue
            seen.add(key)
            candidates = self._gt_by_image.get(image_id)
            if not candidates:
                unmatched += 1
                continue
            center = np.asarray(record["box"], np.float64)[0:2]
            nearest = min(
                candidates,
                key=lambda g: float(np.sum((g["center"] - center) ** 2)),
            )
            pred = np.asarray(record["pred"], np.float64)[: self.num_joints, :2]
            k = pred.shape[0]
            preds.append(pred)
            gts.append(nearest["joints"][:k])
            masks.append(nearest["vis"][:k])
            boxes.append(nearest["bbox_wh"])
        if unmatched:
            logging.warning(
                "topdown_keypoint: %d records had no labeled GT instance "
                "in their image and were skipped",
                unmatched,
            )
        if not preds:
            k = self.num_joints
            return (
                np.zeros((0, k, 2)),
                np.zeros((0, k, 2)),
                np.zeros((0, k), bool),
                np.zeros((0, 2)),
            )
        return (
            np.stack(preds),
            np.stack(gts),
            np.stack(masks),
            np.stack(boxes),
        )

    def eval(self, inference_result: List[Dict[str, Any]]) -> Dict[str, Any]:
        preds, gts, mask, bbox = self._match_records(inference_result)
        cfg = self._evaluation_cfg
        out: Dict[str, Any] = {}
        if "PCK" in self.metrics:
            if cfg["pck_norm_item"] == "head":
                p0, p1 = cfg["head_pair"]
                if max(p0, p1) >= self.num_joints:
                    raise ValueError(
                        f"head_pair {cfg['head_pair']} out of range for "
                        f"num_joints={self.num_joints}"
                    )
                seg = np.linalg.norm(gts[:, p0] - gts[:, p1], axis=-1)
                # instances missing either head joint drop out (norm <= 0)
                labeled = mask[:, p0] & mask[:, p1]
                head = np.where(labeled, cfg["head_scale"] * seg, 0.0)
                pck_norm = np.stack([head, head], axis=-1)
            else:
                pck_norm = bbox
            _, avg, _ = keypoint_pck_accuracy(
                preds, gts, mask, cfg["pck_thr"], pck_norm
            )
            out["PCK"] = avg
        if "AUC" in self.metrics:
            out["AUC"] = keypoint_auc(preds, gts, mask, cfg["auc_norm"])
        if "EPE" in self.metrics:
            out["EPE"] = keypoint_epe(preds, gts, mask)
        if "NME" in self.metrics:
            area = np.sqrt(np.prod(bbox, axis=-1, keepdims=True))
            norm = np.repeat(area, 2, axis=-1)
            out["NME"] = keypoint_nme(preds, gts, mask, norm)
        return out
