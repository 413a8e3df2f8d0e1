"""Distance-based keypoint metrics in numpy: PCK, AUC, EPE, NME.

Copy of ``mindpose_tpu/utils/keypoint_metrics.py``, computed on the host over
(N, K, 2) prediction and ground-truth arrays with per-joint visibility
masks; the ``topdown_keypoint`` evaluator (MPII's PCKh and EPE) reads them.
tests/test_torch_keypoint_eval.py holds the copy equal to its original.

Conventions:
- ``mask`` is (N, K) boolean: True where the ground-truth joint is labeled
  (v > 0).  Unlabeled joints never contribute to any metric.
- ``norm`` is (N, 2): the per-instance, per-axis normalization (e.g. bbox
  [w, h]).  A scalar normalizer is expressed as ``np.full((N, 2), s)``.
"""
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "normalized_distances",
    "keypoint_pck_accuracy",
    "keypoint_auc",
    "keypoint_epe",
    "keypoint_nme",
]


def normalized_distances(
    preds: np.ndarray,
    gts: np.ndarray,
    mask: np.ndarray,
    norm: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-joint distances, normalized per axis; masked joints are -1.

    Args:
        preds/gts: (N, K, 2) coordinates.
        mask: (N, K) boolean labeled-joint mask.
        norm: (N, 2) per-axis normalizer, or None for raw pixel distance.

    Returns:
        (N, K) float array; -1 marks joints excluded by ``mask`` (or by a
        non-positive normalizer).
    """
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    n, k = preds.shape[:2]
    valid = np.asarray(mask, bool).copy()
    if norm is None:
        norm = np.ones((n, 2), np.float64)
    else:
        norm = np.asarray(norm, np.float64)
        valid &= np.all(norm > 0, axis=-1, keepdims=True)
    dists = np.full((n, k), -1.0)
    if valid.any():
        scaled = (preds - gts) / norm[:, None, :]
        dists[valid] = np.linalg.norm(scaled[valid], axis=-1)
    return dists


def _accuracy_at(dists: np.ndarray, thr: float) -> Tuple[float, int]:
    """(fraction of valid joints with dist < thr, number of valid joints)."""
    valid = dists >= 0
    count = int(valid.sum())
    if count == 0:
        return 0.0, 0
    return float((dists[valid] < thr).mean()), count


def keypoint_pck_accuracy(
    preds: np.ndarray,
    gts: np.ndarray,
    mask: np.ndarray,
    thr: float,
    norm: np.ndarray,
) -> Tuple[np.ndarray, float, int]:
    """PCK: fraction of labeled joints whose normalized distance < ``thr``.

    Returns:
        (per-joint accuracy (K,), with -1 for joints never labeled;
         micro-averaged accuracy over all labeled joints;
         number of labeled joints).
    """
    dists = normalized_distances(preds, gts, mask, norm)
    k = dists.shape[1]
    per_joint = np.full(k, -1.0)
    for j in range(k):
        acc, cnt = _accuracy_at(dists[:, j], thr)
        if cnt:
            per_joint[j] = acc
    avg, count = _accuracy_at(dists, thr)
    return per_joint, avg, count


def keypoint_auc(
    preds: np.ndarray,
    gts: np.ndarray,
    mask: np.ndarray,
    norm_factor: float,
    num_thrs: int = 20,
) -> float:
    """Area under the PCK curve for thresholds in [0, 0.5).

    ``norm_factor`` is a scalar pixel normalizer (30 px is the conventional
    default), applied isotropically.
    """
    n = np.asarray(preds).shape[0]
    norm = np.full((n, 2), float(norm_factor))
    dists = normalized_distances(preds, gts, mask, norm)
    thrs = [0.5 * i / num_thrs for i in range(num_thrs)]
    return float(np.mean([_accuracy_at(dists, t)[0] for t in thrs]))


def keypoint_epe(preds: np.ndarray, gts: np.ndarray, mask: np.ndarray) -> float:
    """End-point error: mean raw pixel distance over labeled joints."""
    dists = normalized_distances(preds, gts, mask, None)
    valid = dists >= 0
    if not valid.any():
        return 0.0
    return float(dists[valid].mean())


def keypoint_nme(
    preds: np.ndarray, gts: np.ndarray, mask: np.ndarray, norm: np.ndarray
) -> float:
    """Normalized mean error over labeled joints (norm as in PCK)."""
    dists = normalized_distances(preds, gts, mask, norm)
    valid = dists >= 0
    if not valid.any():
        return 0.0
    return float(dists[valid].mean())
