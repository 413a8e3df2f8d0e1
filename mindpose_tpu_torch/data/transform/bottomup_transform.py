"""Bottom-up (whole-image, multi-person) transforms of evaluation and serving.

Copies of ``mindpose_tpu/data/transform/bottomup_transform.py``: the base
``BottomUpTransform`` (:38), ``bottomup_rescale`` (``BottomUpRescale``,
:93: fit the image into ``max_image_size``, keeping its aspect ratio, with
the center and scale that map the heatmaps back) and ``bottomup_pad``
(``BottomUpPad``, :436: pad to ``max_image_size``, with the validity mask).
The training transforms (``bottomup_random_affine``,
``bottomup_horizontal_random_flip``, ``bottomup_generate_target`` and the
device pipeline's ``bottomup_generate_tag_ind``) come with bottom-up
training, and refuse until then. cv2 is imported when a transform first
needs it, as the top-down transforms import it. tests/test_torch_host_copies.py
holds each copy equal to its original.
"""
from typing import Any, Dict, Tuple

import numpy as np

from ...register import register
from .topdown_transform import _cv2
from .transform import Transform
from .utils import flip_index_from_pairs

__all__ = ["BottomUpTransform", "BottomUpRescale", "BottomUpPad"]

TRAINING_ITEM = "ROADMAP.md, Queue 1, HigherHRNet bottom-up: training"


class BottomUpTransform(Transform):
    def load_transform_cfg(self) -> Dict[str, Any]:
        cfg = dict()
        cfg["image_size"] = np.array(self.config["image_size"])
        cfg["max_image_size"] = np.array(self.config["max_image_size"])
        cfg["heatmap_sizes"] = np.array(self.config["heatmap_sizes"])
        assert len(cfg["image_size"]) == 2
        for x in cfg["heatmap_sizes"]:
            assert len(x) == 2

        flip_pairs = np.array(self.config["flip_pairs"])
        cfg["flip_pairs"] = flip_pairs
        cfg["flip_index"] = flip_index_from_pairs(flip_pairs)
        cfg["pixel_std"] = float(self.config["pixel_std"])
        cfg["tag_per_joint"] = self.config["tag_per_joint"]
        return cfg


@register("transform", extra_name="bottomup_rescale")
class BottomUpRescale(BottomUpTransform):
    """Rescale to fit max_image_size, keeping aspect ratio."""

    @staticmethod
    def _get_new_size(image_size, max_size) -> Tuple[int, int]:
        w, h = image_size
        max_w, max_h = max_size
        if w < h:
            max_w, max_h = max_h, max_w
        if w / h > max_w / max_h:
            target_w = max_w
            target_h = round(h * max_w / w)
        else:
            target_h = max_h
            target_w = round(w * max_h / h)
        return int(target_w), int(target_h)

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        cv2 = _cv2()
        image = state["image"]
        height, width = image.shape[:2]
        target_size = self._get_new_size(
            [width, height], self._transform_cfg["max_image_size"]
        )
        image = cv2.resize(image, target_size, interpolation=cv2.INTER_LINEAR)

        pixel_std = self._transform_cfg["pixel_std"]
        center = np.array([round(width / 2), round(height / 2)])
        scale = np.array([width / pixel_std, height / pixel_std])
        return dict(
            image=image,
            center=center,
            scale=scale,
            image_shape=np.array(target_size),
        )


@register("transform", extra_name="bottomup_pad")
class BottomUpPad(BottomUpTransform):
    """Pad to max_image_size and emit a validity mask."""

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image = state["image"]
        height, width = image.shape[:2]
        target_width, target_height = self._transform_cfg["max_image_size"]
        if width < height:
            target_height, target_width = target_width, target_height
        assert target_width >= width and target_height >= height

        image = np.pad(
            image, ((0, target_height - height), (0, target_width - width), (0, 0))
        )
        mask = np.zeros((target_height, target_width), dtype=np.uint8)
        mask[:height, :width] = 1
        return dict(image=image, mask=mask)


def _refuse_training_transform(name: str) -> None:
    def refused(*args: Any, **kwargs: Any):
        raise NotImplementedError(f"the transform {name!r} serves bottom-up training, which is "
                                  f"not ported yet ({TRAINING_ITEM})")

    refused.__name__ = name
    register("transform")(refused)


for _name in ("bottomup_random_affine", "bottomup_horizontal_random_flip",
              "bottomup_generate_target", "bottomup_generate_tag_ind"):
    _refuse_training_transform(_name)
