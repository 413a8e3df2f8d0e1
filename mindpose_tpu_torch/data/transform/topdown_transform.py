"""Top-down crop geometry at inference time, in numpy (no cv2).

Copies of the val branch of ``mindpose_tpu/data/transform/topdown_transform.py``:
``TopDownBoxToCenterScale._xywh2cs`` (:71-87) and the warp matrix of
``TopDownAffine._matrix_and_keypoints`` (:103-124, standard and UDP). The
pixels are warped on the device (``ops/image.affine_warp``), not by cv2.
tests/test_torch_host_copies.py holds each copy equal to its original.
"""
from typing import Sequence, Tuple

import numpy as np

from .utils import get_affine_transform, get_warp_matrix

__all__ = ["box_to_center_scale", "crop_matrix"]


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
