"""Top-down crop geometry at inference time, in numpy, and the val transforms.

Copies of the val branch of ``mindpose_tpu/data/transform/topdown_transform.py``:
``TopDownBoxToCenterScale._xywh2cs`` (:71-87) and the warp matrix of
``TopDownAffine._matrix_and_keypoints`` (:103-124, standard and UDP), as
functions. Serving warps the pixels on the device (``ops/image.affine_warp``).

The val transforms of the evaluation loader, registered under the JAX
package's names, are built on them: ``topdown_box_to_center_scale`` and
``topdown_affine``, which crops on the host with cv2.warpAffine as the JAX
loader does, so that evaluation feeds the net the same bytes as the JAX
package. cv2 is imported when a crop is made, so serving never imports it.
tests/test_torch_host_copies.py and tests/test_torch_eval_copies.py hold
each copy equal to its original.
"""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ...register import register
from .transform import Transform
from .utils import get_affine_transform, get_warp_matrix

__all__ = ["box_to_center_scale", "crop_matrix", "TopDownTransform",
           "TopDownBoxToCenterScale", "TopDownAffine"]


def box_to_center_scale(
    box: Sequence[float],
    image_size: Sequence[int],
    pixel_std: float = 200.0,
    scale_padding: float = 1.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """xywh box -> (center [2] float32, scale [2] float32), aspect-fixed and padded."""
    x, y, w, h = box
    image_size = np.array(image_size)
    pixel_std = float(pixel_std)
    aspect_ratio = image_size[0] / image_size[1]
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)

    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio

    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
    scale = scale * float(scale_padding)
    return center, scale


def crop_matrix(
    center: np.ndarray,
    scale: np.ndarray,
    image_size: Sequence[int],
    pixel_std: float = 200.0,
    use_udp: bool = False,
    rotation: float = 0.0,
) -> np.ndarray:
    """Forward 2x3 matrix mapping the source image onto the (W, H) crop."""
    image_size = np.array(image_size)
    pixel_std = float(pixel_std)
    if use_udp:
        return get_warp_matrix(
            rotation, center * 2.0, image_size - 1.0, scale * pixel_std
        )
    return get_affine_transform(center, scale, rotation, image_size, pixel_std=pixel_std)


class TopDownTransform(Transform):
    """Base of the top-down transforms: reads the dataset setting."""

    def __init__(self, is_train: bool = True, config: Optional[Dict[str, Any]] = None) -> None:
        if is_train:
            raise NotImplementedError(
                f"{type(self).__name__} is ported for evaluation only; the train transforms "
                "come with the training loader (ROADMAP.md, Queue 1 #2)")
        super().__init__(is_train=is_train, config=config)

    def load_transform_cfg(self) -> Dict[str, Any]:
        """The dataset keys the val transforms read (the train transforms,
        when ported, read the flip pairs, upper-body ids and joint weights)."""
        image_size = np.array(self.config["image_size"])
        if len(image_size) != 2:
            raise ValueError("image_size is a (W, H) pair")
        return {"image_size": image_size, "pixel_std": float(self.config["pixel_std"]),
                "scale_padding": float(self.config["scale_padding"])}


@register("transform", extra_name="topdown_box_to_center_scale")
class TopDownBoxToCenterScale(TopDownTransform):
    """xywh box -> (center, scale), aspect-fixed and padded."""

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self._transform_cfg
        center, scale = box_to_center_scale(state["boxes"], cfg["image_size"], cfg["pixel_std"],
                                            cfg["scale_padding"])
        return dict(center=center, scale=scale)


@register("transform", extra_name="topdown_affine")
class TopDownAffine(TopDownTransform):
    """Crop the instance to image_size with cv2.warpAffine; standard or UDP matrix.

    The JAX transform also maps the GT keypoints into the crop; the val
    batch does not carry them, so this one does not.
    """

    def __init__(self, is_train: bool = True, config: Optional[Dict[str, Any]] = None,
                 use_udp: bool = False) -> None:
        super().__init__(is_train=is_train, config=config)
        self.use_udp = use_udp

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        import cv2

        cfg = self._transform_cfg
        image_size = cfg["image_size"]
        trans = crop_matrix(state["center"], state["scale"], image_size, cfg["pixel_std"],
                            self.use_udp, state.get("rotation", 0.0))
        image = cv2.warpAffine(
            state["image"],
            np.asarray(trans, dtype=np.float64),
            (int(image_size[0]), int(image_size[1])),
            flags=cv2.INTER_LINEAR,
        )
        return dict(image=image)
