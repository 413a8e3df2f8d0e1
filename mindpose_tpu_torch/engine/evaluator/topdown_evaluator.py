"""Top-down evaluator: dedup by bbox_id, keypoint rescoring, OKS-NMS, COCO AP.

Copy of ``mindpose_tpu/engine/evaluator/topdown_evaluator.py``: group the
predictions per image, keep the first record per bbox_id (in bbox_id
order), replace each instance score by box_score x mean(joint scores above
``vis_thr``), optionally apply (soft-)OKS-NMS, then run the COCO keypoint
AP. tests/test_torch_eval_copies.py holds it equal to its original.
"""
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ...register import register
from ...utils.nms import oks_nms, soft_oks_nms
from .evaluator import Evaluator


@register("evaluator", extra_name="topdown")
class TopDownEvaluator(Evaluator):
    SUPPORT_METRICS = {"AP"}

    def __init__(
        self,
        annotation_file: str,
        metric: Union[str, List[str]] = "AP",
        num_joints: int = 17,
        config: Optional[Dict[str, Any]] = None,
        remove_result_file: bool = True,
        result_path: str = "./result_keypoints.json",
    ) -> None:
        super().__init__(
            annotation_file, metric=metric, num_joints=num_joints, config=config
        )
        self.remove_result_file = remove_result_file
        self.result_path = result_path

    def load_evaluation_cfg(self) -> Dict[str, Any]:
        return {
            "vis_thr": self.config["vis_thr"],
            "oks_thr": self.config["oks_thr"],
            "use_nms": self.config["use_nms"],
            "soft_nms": self.config["soft_nms"],
            "sigmas": np.array(self.config["sigmas"]),
            # CrowdPose protocol: extra AP over images bucketed by their
            # crowdIndex attribute (easy/medium/hard)
            "crowd_index_stats": bool(
                self.config.get("crowd_index_stats", False)),
        }

    def eval(self, inference_result: List[Dict[str, Any]]) -> Dict[str, Any]:
        per_image = self._collect_by_image(inference_result)

        kept = []
        for persons in per_image.values():
            self._rescore(persons)
            kept.append(self._apply_nms(persons))

        self._write_coco_keypoint_results(kept, self.result_path)
        name_value = dict(self._do_python_keypoint_eval(self.result_path))

        for name in self.metrics:
            if name not in name_value:
                raise ValueError(
                    f"`{name}` is not in the returned result `{name_value.keys()}`"
                )
        if self.remove_result_file:
            os.remove(self.result_path)
        return name_value

    def _collect_by_image(
        self, records: List[Dict[str, Any]]
    ) -> Dict[int, List[Dict[str, Any]]]:
        """image_id -> instances sorted by bbox_id, first record per bbox_id
        winning (TTA / ragged-batch padding can emit duplicates)."""
        slots = defaultdict(dict)
        for record in records:
            image_id = self.name2id[os.path.basename(record["image_path"])]
            # box layout from the inferencer: (center_xy, scale_xy, area, score)
            box = np.asarray(record["box"])
            entry = dict(
                keypoints=record["pred"],
                center=box[0:2],
                scale=box[2:4],
                area=box[4],
                score=box[5],
                image_id=image_id,
                bbox_id=record["bbox_id"],
            )
            slots[image_id].setdefault(record["bbox_id"], entry)
        return {
            image_id: [by_bbox[b] for b in sorted(by_bbox)]
            for image_id, by_bbox in slots.items()
        }

    def _rescore(self, persons: List[Dict[str, Any]]) -> None:
        """score := box_score x mean joint confidence above vis_thr (in
        place; zero when no joint clears the threshold)."""
        vis_thr = self._evaluation_cfg["vis_thr"]
        for person in persons:
            joint_conf = np.asarray(person["keypoints"], np.float64)[
                : self.num_joints, 2
            ]
            confident = joint_conf[joint_conf > vis_thr]
            mean_conf = confident.mean() if confident.size else 0.0
            person["score"] = float(mean_conf * person["score"])

    def _apply_nms(self, persons: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        if not self._evaluation_cfg["use_nms"]:
            return persons
        nms = soft_oks_nms if self._evaluation_cfg["soft_nms"] else oks_nms
        keep = nms(
            persons,
            self._evaluation_cfg["oks_thr"],
            sigmas=self._evaluation_cfg["sigmas"],
        )
        return [persons[i] for i in keep]
