"""Evaluator base: COCO GT loading, result writing, the OKS AP metric.

Copy of ``mindpose_tpu/engine/evaluator/evaluator.py`` on the port's copies
of ``COCO`` and ``COCOeval``, with the CrowdPose crowd-index bands.
tests/test_torch_eval_copies.py holds it equal to its original.
"""
import json
from typing import Any, Dict, List, Optional, Set, Tuple, Union

import numpy as np

from ...utils.coco import COCO, image_id_name_maps
from ...utils.cocoeval import COCOeval


class Evaluator:
    SUPPORT_METRICS: Set[str] = set()

    def __init__(
        self,
        annotation_file: str,
        metric: Union[str, List[str]] = "AP",
        num_joints: int = 17,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.annotation_file = annotation_file
        self.num_joints = num_joints
        self.config = config if config else dict()
        self._metrics = set(metric) if isinstance(metric, list) else {metric}
        for single in self._metrics:
            if single not in self.SUPPORT_METRICS:
                raise KeyError(f"metric {single} is not supported")

        self._evaluation_cfg = self.load_evaluation_cfg()

        self.coco = COCO(annotation_file)
        self.id2name, self.name2id = image_id_name_maps(self.coco.imgs)

        cat_ids = self.coco.getCatIds()
        cats = [cat["name"] for cat in self.coco.loadCats(cat_ids)]
        self.classes = ["__background__"] + cats
        self._class_to_coco_ind = dict(zip(cats, cat_ids))

    @property
    def metrics(self) -> Set[str]:
        return self._metrics

    def load_evaluation_cfg(self) -> Dict[str, Any]:
        raise NotImplementedError("Child class must implement this method.")

    def eval(self, inference_result: List[Dict[str, Any]]) -> Dict[str, Any]:
        raise NotImplementedError("Child class must implement this method.")

    def __call__(self, inference_result: List[Dict[str, Any]]) -> Dict[str, Any]:
        return self.eval(inference_result)

    def _write_coco_keypoint_results(self, keypoints, res_file: str) -> None:
        cat_id = self._class_to_coco_ind[self.classes[1]]
        results = []
        for img_kpts in keypoints:
            if not img_kpts:
                continue
            kp_arr = np.array(
                [np.asarray(k["keypoints"], np.float64) for k in img_kpts]
            ).reshape(len(img_kpts), -1)[:, : self.num_joints * 3]
            for img_kpt, kp in zip(img_kpts, kp_arr):
                results.append(
                    {
                        "image_id": int(img_kpt["image_id"]),
                        "category_id": cat_id,
                        "keypoints": kp.tolist(),
                        "score": float(img_kpt["score"]),
                        "center": np.asarray(img_kpt.get("center", -1)).tolist(),
                        "scale": np.asarray(img_kpt.get("scale", -1)).tolist(),
                    }
                )
        with open(res_file, "w") as f:
            json.dump(results, f, sort_keys=True, indent=4)

    def _do_python_keypoint_eval(self, res_file: str) -> List[Tuple[str, float]]:
        """OKS AP via the in-repo COCOeval (ref evaluator.py:141-167)."""
        coco_det = self.coco.loadRes(res_file)
        coco_eval = COCOeval(self.coco, coco_det, "keypoints")
        sigmas = self._evaluation_cfg.get("sigmas")
        if sigmas is not None:
            coco_eval.params.kpt_oks_sigmas = np.asarray(sigmas)
        coco_eval.evaluate()
        coco_eval.accumulate()
        coco_eval.summarize()

        stats_names = [
            "AP", "AP .5", "AP .75", "AP (M)", "AP (L)",
            "AR", "AR .5", "AR .75", "AR (M)", "AR (L)",
        ]
        stats = list(zip(stats_names, coco_eval.stats))
        if self._evaluation_cfg.get("crowd_index_stats"):
            stats += self._crowd_index_band_stats(coco_det, sigmas)
        return stats

    # CrowdPose band edges (CrowdPose paper §5): easy [0, 0.1),
    # medium [0.1, 0.8), hard [0.8, 1]
    _CROWD_BANDS = (("easy", 0.0, 0.1), ("medium", 0.1, 0.8),
                    ("hard", 0.8, 1.0001))

    def _crowd_index_band_stats(
        self, coco_det, sigmas
    ) -> List[Tuple[str, float]]:
        """CrowdPose-protocol AP per crowding band.

        The CrowdPose benchmark replaces area-based AP(M)/AP(L) with AP over
        image subsets bucketed by the annotation file's per-image
        ``crowdIndex`` (the official crowdpose-api's AP(E)/AP(M)/AP(H)).
        Images without the attribute count as crowdIndex 0. Empty bands
        report -1, matching COCOeval's empty-slot convention.
        """
        out: List[Tuple[str, float]] = []
        for name, lo, hi in self._CROWD_BANDS:
            ids = [
                img_id for img_id, img in self.coco.imgs.items()
                if lo <= float(
                    img.get("crowdIndex", img.get("crowd_index", 0.0))
                ) < hi
            ]
            if not ids:
                out.append((f"AP ({name})", -1.0))
                continue
            band_eval = COCOeval(self.coco, coco_det, "keypoints")
            if sigmas is not None:
                band_eval.params.kpt_oks_sigmas = np.asarray(sigmas)
            band_eval.params.imgIds = sorted(ids)
            band_eval.evaluate()
            band_eval.accumulate()
            band_eval.summarize()
            out.append((f"AP ({name})", band_eval.stats[0]))
        return out
