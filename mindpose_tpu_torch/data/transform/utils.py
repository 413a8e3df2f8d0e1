"""Crop geometry for the top-down host path, in numpy.

Copies of ``mindpose_tpu/data/transform/utils.py``: the joints' horizontal
flip and its permutation (:15-66), the center/scale -> affine-matrix
construction (pixel_std=200 convention), a 2x3 matrix applied to a point
(:125), the UDP closed-form warp matrix (:142-167), a matrix applied to
joint arrays (:170), the zero-padding of arrays to their common shape
(``pad_to_same``, :176) and the bottom-up back-projection of grouped
keypoints to the original frame (``transform_keypoints``, :186).
The port cannot import the JAX package (its ``__init__`` imports JAX), so
these live here; tests/test_torch_host_copies.py holds each copy equal to
its original.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "fliplr_joints",
    "flip_index_from_pairs",
    "rotate_point",
    "get_affine_transform",
    "affine_transform",
    "get_warp_matrix",
    "warp_affine_joints",
    "pad_to_same",
    "transform_keypoints",
]


def fliplr_joints(
    keypoints: np.ndarray,
    img_width: int,
    flip_pairs: Optional[Sequence[Tuple[int, int]]] = None,
    flip_index: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Horizontally flip joints ([..., K, >=2]) via pairs or a flat index."""
    assert img_width > 0
    assert flip_pairs is not None or flip_index is not None

    if flip_pairs is not None:
        flipped = keypoints.copy()
        for left, right in flip_pairs:
            flipped[..., left, :] = keypoints[..., right, :]
            flipped[..., right, :] = keypoints[..., left, :]
    else:
        flip_index = np.asarray(flip_index)
        if len(flip_index) != keypoints.shape[-2]:
            raise ValueError(
                f"flip_index has {len(flip_index)} entries but keypoints "
                f"have {keypoints.shape[-2]} joints — rebuild it with "
                f"flip_index_from_pairs(pairs, num_joints)"
            )
        flipped = keypoints[..., flip_index, :].copy()

    flipped[..., 0] = img_width - 1 - flipped[..., 0]
    return flipped


def flip_index_from_pairs(flip_pairs, num_joints: Optional[int] = None) -> np.ndarray:
    """Full K-joint channel permutation with each pair swapped.

    ``num_joints`` defaults to ``max(pair index) + 1`` — correct whenever no
    unpaired joint sits after the last paired one (true for COCO and MPII);
    callers that know the real K should pass it (the flip transforms and
    TTA inferencers rebuild from the observed joint count when the cached
    index length mismatches).
    """
    flip_pairs = np.array(flip_pairs)
    if flip_pairs.ndim != 2:
        return flip_pairs  # already a flat permutation
    if num_joints is None:
        num_joints = int(flip_pairs.max()) + 1 if flip_pairs.size else 0
    elif flip_pairs.size and int(flip_pairs.max()) >= num_joints:
        raise ValueError(
            f"flip pair index {int(flip_pairs.max())} out of range for "
            f"num_joints={num_joints}"
        )
    index = np.arange(num_joints)
    for left, right in flip_pairs:
        index[left], index[right] = right, left
    return index


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


def affine_transform(pt: Sequence[float], trans_mat: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine matrix to a single 2D point."""
    return np.asarray(trans_mat) @ np.array([pt[0], pt[1], 1.0])


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


def warp_affine_joints(joints: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine matrix to [..., 2] joint coordinates."""
    ones = np.ones((*joints.shape[:-1], 1), dtype=np.float32)
    return np.concatenate((joints, ones), axis=-1) @ np.asarray(mat).T


def pad_to_same(arrays: List[np.ndarray]) -> List[np.ndarray]:
    """Zero-pad arrays to their common max shape."""
    shapes = np.array([x.shape for x in arrays])
    max_shape = shapes.max(axis=0, keepdims=True)
    offsets = max_shape - shapes
    return [
        np.pad(x, [(0, int(o)) for o in offsets[i]]) for i, x in enumerate(arrays)
    ]


def transform_keypoints(
    coords: List[np.ndarray],
    center: np.ndarray,
    scale: np.ndarray,
    heatmap_shape: np.ndarray,
    pixel_std: float = 200.0,
) -> List[np.ndarray]:
    """Map heatmap-frame coords back to the original image frame.

    coords: list over batch of [M, K, >=2] (or empty); center/scale [N, 2];
    heatmap_shape [N, 2].
    """
    scale = np.asarray(scale, dtype=np.float64) * pixel_std
    scale_x = scale[:, 0] / heatmap_shape[:, 0]
    scale_y = scale[:, 1] / heatmap_shape[:, 1]

    out = []
    for i, coord in enumerate(coords):
        if coord.size == 0:
            out.append(coord)
            continue
        t = coord.copy()
        t[..., 0] = coord[..., 0] * scale_x[i] + center[i, 0] - scale[i, 0] * 0.5
        t[..., 1] = coord[..., 1] * scale_y[i] + center[i, 1] - scale[i, 1] * 0.5
        out.append(t)
    return out
