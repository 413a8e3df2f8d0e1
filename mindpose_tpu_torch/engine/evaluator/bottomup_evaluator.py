"""Bottom-up evaluator: per-instance area from the keypoints' extent, OKS AP.

Copy of ``mindpose_tpu/engine/evaluator/bottomup_evaluator.py`` on the
port's copies of COCO, COCOeval and OKS-NMS (``utils/nms.py``): collect the
persons per image, optional OKS-NMS, COCOeval.
tests/test_torch_eval_copies.py holds it equal to its original.
"""
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ...register import register
from ...utils.nms import oks_nms, soft_oks_nms
from .evaluator import Evaluator


@register("evaluator", extra_name="bottomup")
class BottomUpEvaluator(Evaluator):
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
            "oks_thr": self.config["oks_thr"],
            "use_nms": self.config["use_nms"],
            "soft_nms": self.config["soft_nms"],
            "sigmas": np.array(self.config["sigmas"]),
        }

    def eval(self, inference_result: List[Dict[str, Any]]) -> Dict[str, Any]:
        per_image = self._collect_by_image(inference_result)
        kept = [self._apply_nms(persons) for persons in per_image.values()]

        self._write_coco_keypoint_results(kept, self.result_path)
        name_value = dict(self._do_python_keypoint_eval(self.result_path))

        missing = [m for m in self.metrics if m not in name_value]
        if missing:
            raise ValueError(
                f"`{missing[0]}` is not in the returned result `{name_value.keys()}`"
            )
        if self.remove_result_file:
            os.remove(self.result_path)
        return name_value

    def _collect_by_image(
        self, records: List[Dict[str, Any]]
    ) -> Dict[int, List[Dict[str, Any]]]:
        """image_id -> instance dicts; area = bounding extent of the joints
        (bottom-up has no detector boxes to take an area from)."""
        per_image: Dict[int, List[Dict[str, Any]]] = defaultdict(list)
        for record in records:
            image_id = self.name2id[os.path.basename(record["image_path"])]
            for joints, score in zip(record["pred"], record["score"]):
                joints = np.asarray(joints)
                extent = joints[:, :2].max(axis=0) - joints[:, :2].min(axis=0)
                per_image[image_id].append(
                    dict(
                        keypoints=joints[:, :3],
                        score=float(score),
                        image_id=image_id,
                        area=float(extent[0] * extent[1]),
                    )
                )
        return per_image

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
