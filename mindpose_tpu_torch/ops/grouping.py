"""The fixed-capacity tag matcher, plain version: numpy on the host.

Counterpart of ``mindpose_tpu/ops/grouping.py`` (``_lsap``,
``match_by_tag_device``, ``match_by_tag_batch``), the JAX package's
associative-embedding grouping on an accelerator. Joints are visited in
``joint_order``; each joint's candidates above ``vis_thr`` are assigned to
the live groups by a Jonker-Volgenant linear-sum assignment over a padded
``[M, G + M]`` cost (the L2 distance from a candidate's tag to a group's
mean tag, rounded with the unrounded distance as a tie-break, and one
"spawn" column per candidate); an assigned candidate closer than
``tag_thr`` joins its group, the others start groups, in candidate order,
up to the capacity ``G``.

This version follows the JAX one step by step in float32, and is the
reference of the CUDA kernel ``csrc/grouping.cu`` (wrapper
``ops/cuda/grouping.match_by_tag_batch``), which repeats the same
operations in the same order and matches it bit for bit. Each operation is
rounded on its own, except at the two places where XLA on the CPU contracts
a multiply and an add into one fused multiply-add (measured: it does so
for every element, and the assignment changes with it on some inputs): the
squared tag distance, ``fma(t_l, t_l, acc)`` for l >= 1, and the rounded
cost, ``fma(eps, d, round(d))``. Numpy has no fused multiply-add, so
``_fma`` computes it exactly in float64. This version runs in the CPU
tests, and where the inferencer groups on the CPU with ``device_grouping``.

``match_by_tag_batch.steps`` counts the LSAP's Dijkstra iterations (the
passes of ``while p[j0] != 0``) of every call of either entry: the length
of the chain of dependent steps that the kernel runs, which gives its
bound.
"""
from typing import Sequence, Tuple

import numpy as np

__all__ = ["match_by_tag_device", "match_by_tag_batch"]

_INF = np.float32(1e30)
_F32 = np.float32


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The float64 product of two float32 values is exact; the float64 sum
    rounds, and its error ``e`` is exact (TwoSum). Moving the sum one
    float64 step toward ``e`` keeps it on the same side of every float32
    rounding boundary as the exact value, so the cast to float32 rounds as
    the exact value would.
    """
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    s = np.where(e > 0, np.nextafter(s, np.inf), np.where(e < 0, np.nextafter(s, -np.inf), s))
    return s.astype(_F32)


def _lsap(cost: np.ndarray) -> np.ndarray:
    """Optimal assignment of each row of a float32 [n, m] cost (n <= m) to a
    distinct column: the JAX package's ``_lsap``, row by row, with its
    potentials, its first-index argmin and its augmenting path."""
    n, m = cost.shape
    u = np.zeros(n + 1, _F32)
    v = np.zeros(m + 1, _F32)
    p = np.zeros(m + 1, np.int32)  # p[j]: the row (1-based) on column j, 0 if none
    steps = 0
    for i1 in range(1, n + 1):
        p[0] = i1
        way = np.zeros(m + 1, np.int32)
        minv = np.full(m + 1, _INF, _F32)
        used = np.zeros(m + 1, bool)
        j0 = 0
        while p[j0] != 0:
            steps += 1
            used[j0] = True
            i0 = p[j0]
            cur = (cost[i0 - 1] - u[i0]) - v[1:]
            upd = ~used[1:] & (cur < minv[1:])
            minv[1:][upd] = cur[upd]
            way[1:][upd] = j0
            masked = np.where(used[1:], _INF, minv[1:])
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    match_by_tag_batch.steps += steps
    ans = np.zeros(n, np.int32)
    cols = np.nonzero(p[1:])[0]
    ans[p[1:][cols] - 1] = cols
    return ans


def _add_joint(state, jidx, cand_mask, cands, tags, max_num, g_cap, tag_thr,
               use_rounded_norm, ignore_too_much) -> int:
    """Assign one joint's masked candidates to groups, in place; returns the
    new group count."""
    group_joints, group_tag_sum, group_tag_cnt, n_groups = state
    if ignore_too_much and n_groups >= max_num:
        return n_groups  # the whole joint is skipped, joins too
    if not cand_mask.any():
        return n_groups  # no join and no spawn, whatever the assignment

    group_mean = group_tag_sum / np.maximum(group_tag_cnt, _F32(1.0))[:, None]
    live = np.arange(g_cap) < n_groups
    diff = tags[:, None, :] - group_mean[None, :, :]
    acc = diff[..., 0] * diff[..., 0]
    for i in range(1, diff.shape[2]):
        acc = _fma(diff[..., i], diff[..., i], acc)
    dist = np.sqrt(acc)  # [M, G]
    dist_saved = dist
    valid2d = cand_mask[:, None] & live[None, :]
    if use_rounded_norm:
        dmax_u = np.max(np.where(valid2d, dist, _F32(0.0)))
        eps = _F32(0.5) / (_F32(max_num) * (dmax_u + _F32(1.0)))
        dist = _fma(eps, dist, np.round(dist))
    dmax = np.max(np.where(valid2d, dist, _F32(0.0)))
    pad_c = dmax * _F32(2.0) + _F32(10.0)  # a valid row's spawn column
    inval = dmax * _F32(4.0) + _F32(100.0)  # a masked row's or a dead column's cost
    real_cost = np.where(valid2d, dist, inval)
    pad_cost = np.repeat(np.where(cand_mask, pad_c, _F32(0.0))[:, None], max_num, axis=1)
    assign = _lsap(np.concatenate([real_cost, pad_cost], axis=1).astype(_F32))

    gcol = np.minimum(assign, g_cap - 1)
    pair_dist = dist_saved[np.arange(max_num), gcol]
    joins = cand_mask & (assign < g_cap) & live[gcol] & (pair_dist < tag_thr)
    for m in np.nonzero(joins)[0]:  # each group receives at most one candidate
        g = assign[m]
        group_joints[g, jidx] = cands[m]
        group_tag_sum[g] += tags[m]
        group_tag_cnt[g] += _F32(1.0)
    for m in np.nonzero(cand_mask & ~joins)[0]:  # spawns, in candidate order
        if n_groups >= g_cap:
            break
        group_joints[n_groups, jidx] = cands[m]
        group_tag_sum[n_groups] = tags[m]
        group_tag_cnt[n_groups] = _F32(1.0)
        n_groups += 1
    return n_groups


def match_by_tag_device(
    val_k: np.ndarray,
    tag_k: np.ndarray,
    ind_k: np.ndarray,
    joint_order: Sequence[int],
    vis_thr: float = 0.1,
    tag_thr: float = 1.0,
    use_rounded_norm: bool = True,
    ignore_too_much: bool = False,
    group_cap: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Group one image's per-joint top-K candidates into instances.

    Args:
        val_k: [K, M] heatmap values; tag_k: [K, M, L]; ind_k: [K, M, 2].
        group_cap: the group capacity G (0 -> M).

    Returns:
        groups [G, K, 3 + L] float32 (x, y, score, tags) and valid [G] bool.
    """
    val_k = np.asarray(val_k, _F32)
    tag_k = np.asarray(tag_k, _F32)
    ind_k = np.asarray(ind_k, _F32)
    num_joints, max_num, tag_dim = tag_k.shape
    g_cap = group_cap if group_cap else max_num
    joints_all = np.concatenate([ind_k, val_k[..., None], tag_k], axis=2)  # [K, M, 3+L]
    group_joints = np.zeros((g_cap, num_joints, 3 + tag_dim), _F32)
    group_tag_sum = np.zeros((g_cap, tag_dim), _F32)
    group_tag_cnt = np.zeros((g_cap,), _F32)
    n_groups = 0
    for jidx in joint_order:
        cands = joints_all[jidx]
        n_groups = _add_joint(
            (group_joints, group_tag_sum, group_tag_cnt, n_groups), jidx,
            cands[:, 2] > _F32(vis_thr), cands, tag_k[jidx], max_num, g_cap, _F32(tag_thr),
            use_rounded_norm, ignore_too_much)
    return group_joints, np.arange(g_cap) < n_groups


def match_by_tag_batch(
    val_k: np.ndarray,
    tag_k: np.ndarray,
    ind_k: np.ndarray,
    joint_order: Sequence[int],
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """``match_by_tag_device`` over a batch: [N, K, M...] -> ([N, G, K, 3+L], [N, G])."""
    out = [match_by_tag_device(v, t, i, joint_order, **kwargs)
           for v, t, i in zip(np.asarray(val_k), np.asarray(tag_k), np.asarray(ind_k))]
    groups = [g for g, _ in out]
    valid = [v for _, v in out]
    if not out:
        num_joints, max_num, tag_dim = np.shape(tag_k)[1:]
        g_cap = kwargs.get("group_cap", 0) or max_num
        return (np.zeros((0, g_cap, num_joints, 3 + tag_dim), _F32),
                np.zeros((0, g_cap), bool))
    return np.stack(groups), np.stack(valid)


match_by_tag_batch.steps = 0
