"""Associative-embedding grouping on the host: a copy of ``mindpose_tpu/utils/match.py``.

Visit joints in ``joint_order``; per joint, assign the above-threshold top-K
candidates to existing instance groups by the L2 distance between a
candidate's tag and the group's running mean tag (the cost optionally
rounded for the assignment; the join test always uses the exact distance),
solved by scipy's Hungarian; a candidate whose optimal pairing is a dummy
column or lies beyond ``tag_thr`` starts a new group. The fixed-capacity
matcher that the JAX package runs on an accelerator is
``ops/grouping.py`` (plain) and ``ops/cuda/grouping.py`` (the kernel).
tests/test_torch_host_copies.py holds this copy equal to its original.
"""
from typing import List

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["match_by_tag"]

_FAR = 1e10


class _GroupBank:
    """Ordered bank of instance groups, keyed by each group's spawn tag.

    Keying by the scalar spawn tag (first tag dimension) reproduces the
    reference's dict semantics: spawning with an already-seen key updates
    that group's pose and resets its tag history instead of adding a slot.
    """

    def __init__(self, num_joints: int, feat_dim: int):
        self._slot_of_key = {}
        self._poses: List[np.ndarray] = []  # per group: [K, feat_dim]
        self._tag_hist: List[List[np.ndarray]] = []  # per group: list of [L]
        self._num_joints = num_joints
        self._feat_dim = feat_dim

    def __len__(self) -> int:
        return len(self._poses)

    def spawn(self, jidx: int, feat: np.ndarray, tag: np.ndarray) -> None:
        key = tag[0]
        slot = self._slot_of_key.get(key)
        if slot is None:
            slot = len(self._poses)
            self._slot_of_key[key] = slot
            self._poses.append(
                np.zeros((self._num_joints, self._feat_dim), np.float32)
            )
            self._tag_hist.append([tag])
        else:
            self._tag_hist[slot] = [tag]
        self._poses[slot][jidx] = feat

    def join(self, slot: int, jidx: int, feat: np.ndarray, tag: np.ndarray) -> None:
        self._poses[slot][jidx] = feat
        self._tag_hist[slot].append(tag)

    def mean_tags(self) -> np.ndarray:
        """[G, L] running mean tag per group."""
        return np.stack([np.mean(np.stack(h), axis=0) for h in self._tag_hist])

    def stack(self) -> np.ndarray:
        return np.asarray(self._poses, np.float32)


def match_by_tag(
    val_k: np.ndarray,
    tag_k: np.ndarray,
    ind_k: np.ndarray,
    joint_order: List[int],
    vis_thr: float = 0.1,
    tag_thr: float = 1.0,
    ignore_too_much: bool = False,
    use_rounded_norm: bool = True,
) -> np.ndarray:
    """Group per-joint top-K candidates into instances by tag similarity.

    Args:
        val_k: heatmap values, [K, M]
        tag_k: tag embeddings, [K, M, L]
        ind_k: candidate (x, y) locations, [K, M, 2]
        joint_order: joint visiting order for grouping

    Returns:
        [num_instances, K, 3 + L] array (x, y, score, tags...).
    """
    num_joints, capacity, tag_dim = tag_k.shape
    # candidate feature rows: (x, y, score, tag...)
    feats = np.concatenate((ind_k, val_k[..., None], tag_k), axis=2).astype(
        np.float32
    )

    bank = _GroupBank(num_joints, 3 + tag_dim)

    for jidx in joint_order:
        keep = feats[jidx, :, 2] > vis_thr
        if not keep.any():
            continue
        cand_feats = feats[jidx][keep]
        cand_tags = tag_k[jidx][keep]

        if len(bank) == 0:
            for feat, tag in zip(cand_feats, cand_tags):
                bank.spawn(jidx, feat, tag)
            continue
        if ignore_too_much and len(bank) == capacity:
            continue

        # [n_cand, n_grp] exact L2 tag distances; the assignment may use a
        # rounded copy, but the join decision always uses the exact value.
        exact = np.linalg.norm(
            cand_feats[:, None, 3:] - bank.mean_tags()[None, :, :], axis=2
        )
        cost = np.round(exact) if use_rounded_norm else exact
        n_cand, n_grp = cost.shape
        if n_cand > n_grp:
            # dummy columns so every candidate is assigned (and spawns when
            # it lands on a dummy)
            cost = np.hstack(
                [cost, np.full((n_cand, n_cand - n_grp), _FAR, cost.dtype)]
            )

        rows, cols = linear_sum_assignment(cost)
        for r, c in zip(rows, cols):
            if c < n_grp and exact[r, c] < tag_thr:
                bank.join(c, jidx, cand_feats[r], cand_tags[r])
            else:
                bank.spawn(jidx, cand_feats[r], cand_tags[r])

    return bank.stack()
