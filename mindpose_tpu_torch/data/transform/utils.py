"""Crop geometry for the top-down host path, in numpy.

Copies of ``mindpose_tpu/data/transform/utils.py:69-170``: the
center/scale -> affine-matrix construction (pixel_std=200 convention) and the
UDP closed-form warp matrix. The port cannot import the JAX package (its
``__init__`` imports JAX), so these live here; tests/test_torch_host_copies.py
holds each copy equal to its original.
"""
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["rotate_point", "get_affine_transform", "get_warp_matrix"]


def rotate_point(pt: Sequence[float], angle_rad: float) -> List[float]:
    sn, cs = np.sin(angle_rad), np.cos(angle_rad)
    return [pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs]


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotate (a - b) by 90 deg anticlockwise around b."""
    direction = a - b
    return b + np.array([-direction[1], direction[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 2x3 affine mapping 3 src points onto 3 dst points."""
    a = np.concatenate([src.astype(np.float64), np.ones((3, 1))], axis=1)
    coeffs, *_ = np.linalg.lstsq(a, dst.astype(np.float64), rcond=None)
    return coeffs.T  # [2, 3]


def get_affine_transform(
    center: np.ndarray,
    scale: np.ndarray,
    rot: float,
    output_size: Sequence[int],
    shift: Tuple[float, float] = (0.0, 0.0),
    inv: bool = False,
    pixel_std: float = 200.0,
) -> np.ndarray:
    """Affine matrix from center/scale/rot to output_size (W, H)."""
    scale_tmp = np.asarray(scale, dtype=np.float64) * pixel_std
    center = np.asarray(center, dtype=np.float64)
    shift = np.asarray(shift, dtype=np.float64)
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = np.asarray(rotate_point([0.0, src_w * -0.5], rot_rad))
    dst_dir = np.array([0.0, dst_w * -0.5])

    src = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    src[2, :] = _get_3rd_point(src[0, :], src[1, :])

    dst = np.zeros((3, 2), dtype=np.float32)
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    dst[2, :] = _get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src).astype(np.float64)
    return _solve_affine(src, dst).astype(np.float64)


def get_warp_matrix(
    theta: float,
    size_input: np.ndarray,
    size_dst: np.ndarray,
    size_target: np.ndarray,
) -> np.ndarray:
    """UDP closed-form warp matrix."""
    theta = np.deg2rad(theta)
    matrix = np.zeros((2, 3), dtype=np.float32)
    scale_x = size_dst[0] / size_target[0]
    scale_y = size_dst[1] / size_target[1]
    matrix[0, 0] = np.cos(theta) * scale_x
    matrix[0, 1] = -np.sin(theta) * scale_x
    matrix[0, 2] = scale_x * (
        -0.5 * size_input[0] * np.cos(theta)
        + 0.5 * size_input[1] * np.sin(theta)
        + 0.5 * size_target[0]
    )
    matrix[1, 0] = np.sin(theta) * scale_y
    matrix[1, 1] = np.cos(theta) * scale_y
    matrix[1, 2] = scale_y * (
        -0.5 * size_input[0] * np.sin(theta)
        - 0.5 * size_input[1] * np.cos(theta)
        + 0.5 * size_target[1]
    )
    return matrix
