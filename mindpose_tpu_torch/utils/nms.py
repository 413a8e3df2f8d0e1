"""OKS-based NMS over keypoint detections, in numpy: a copy of the JAX package's.

Copy of ``mindpose_tpu/utils/nms.py`` (``oks_iou``, ``oks_nms``,
``soft_oks_nms``): greedy OKS NMS and soft-NMS with gaussian rescoring.
``oks_iou`` takes the pairwise OKS from the C++ library
(``csrc/coco_native.cpp`` through ``utils/native.py``), as the original
does; its numpy path runs only where the caller turned the library off
(``MINDPOSE_NATIVE=0``). tests/test_torch_eval_copies.py holds the copy
equal to its original.
"""
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["oks_iou", "oks_nms", "soft_oks_nms"]

_DEFAULT_SIGMAS = (
    np.array(
        [
            0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72,
            0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89,
        ]
    )
    / 10.0
)


def oks_iou(
    g: np.ndarray,
    d: np.ndarray,
    a_g: float,
    a_d: np.ndarray,
    sigmas: Optional[np.ndarray] = None,
    vis_thr: Optional[float] = None,
) -> np.ndarray:
    """OKS between one instance ``g`` [3K] and instances ``d`` [N, 3K]."""
    if sigmas is None:
        sigmas = _DEFAULT_SIGMAS
    variances = (sigmas * 2) ** 2
    xg, yg, vg = g[0::3], g[1::3], g[2::3]
    d = np.asarray(d)
    if d.size == 0:
        return np.zeros(0, dtype=np.float32)

    from .native import oks_iou_pairs

    native = oks_iou_pairs(g, d, a_g, np.asarray(a_d), variances, vis_thr)
    if native is not None:
        return native.astype(np.float32)
    xd, yd, vd = d[:, 0::3], d[:, 1::3], d[:, 2::3]

    dx = xd - xg[None, :]
    dy = yd - yg[None, :]
    a_d = np.asarray(a_d, dtype=np.float64)
    denom = ((a_g + a_d) / 2 + np.spacing(1))[:, None]
    e = (dx**2 + dy**2) / variances[None, :] / denom / 2

    if vis_thr is not None:
        # the reference's `list(vg) and list(vd)` evaluates to the vd list;
        # keep joints where the *detection* confidence clears the threshold
        keep = vd > vis_thr
        num = np.where(keep, np.exp(-e), 0.0).sum(axis=1)
        cnt = keep.sum(axis=1)
        ious = np.where(cnt > 0, num / np.maximum(cnt, 1), 0.0)
    else:
        ious = np.exp(-e).mean(axis=1)
    return ious.astype(np.float32)


def oks_nms(
    kpts_db: List[Dict[str, Any]],
    thr: float,
    sigmas: Optional[np.ndarray] = None,
    vis_thr: Optional[float] = None,
) -> np.ndarray:
    """Greedy OKS NMS; returns indices to keep."""
    if not kpts_db:
        return []

    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])

    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        ovr = oks_iou(
            kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas, vis_thr
        )
        inds = np.where(ovr <= thr)[0]
        order = order[inds + 1]
    return np.array(keep)


def _rescore(
    overlap: np.ndarray, scores: np.ndarray, thr: float, key_type: str = "gaussian"
) -> np.ndarray:
    if len(overlap) != len(scores):
        raise ValueError(f"{len(overlap)} overlaps for {len(scores)} scores")
    if key_type not in ("gaussian", "linear"):
        raise ValueError(f"key_type must be 'gaussian' or 'linear', got {key_type!r}")
    if key_type == "linear":
        inds = np.where(overlap >= thr)[0]
        scores = scores.copy()
        scores[inds] = scores[inds] * (1 - overlap[inds])
    else:
        scores = scores * np.exp(-(overlap**2) / thr)
    return scores


def soft_oks_nms(
    kpts_db: List[Dict[str, Any]],
    thr: float,
    max_dets: int = 20,
    sigmas: Optional[np.ndarray] = None,
    vis_thr: Optional[float] = None,
) -> np.ndarray:
    """Soft OKS NMS with gaussian rescoring; returns indices to keep."""
    if not kpts_db:
        return []

    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])

    order = scores.argsort()[::-1]
    scores = scores[order]

    keep = np.zeros(max_dets, dtype=np.intp)
    keep_cnt = 0
    while order.size > 0 and keep_cnt < max_dets:
        i = order[0]
        ovr = oks_iou(
            kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas, vis_thr
        )
        order = order[1:]
        scores = _rescore(ovr, scores[1:], thr)
        tmp = scores.argsort()[::-1]
        order = order[tmp]
        scores = scores[tmp]
        keep[keep_cnt] = i
        keep_cnt += 1
    return keep[:keep_cnt]
