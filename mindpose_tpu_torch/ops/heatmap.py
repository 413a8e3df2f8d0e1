"""Heatmap decode primitives in PyTorch: the plain versions of the decode kernel.

Counterpart of mindpose_tpu/ops/heatmap.py (``argmax_coords``,
``quarter_offset``). The port's heatmaps are NCHW, [N, K, H, W], so each
(instance, joint) row of H*W values is contiguous.
"""
from typing import Tuple

import torch

__all__ = ["argmax_coords", "quarter_offset"]


def argmax_coords(heatmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-joint argmax of an NCHW heatmap.

    Returns (coords [N, K, 2] float (x, y), maxvals [N, K], flat_idx [N, K]).
    A tie goes to the first index, as in ``jnp.argmax``.
    """
    n, k, h, w = heatmap.shape
    flat = heatmap.reshape(n, k, h * w)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)
    x = (idx % w).to(torch.float32)
    y = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    return torch.stack([x, y], dim=-1), maxvals, idx


def quarter_offset(
    heatmap: torch.Tensor, coords: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """+-0.25 px shift toward the larger neighbour, zero at borders.

    Neighbour indices are clamped to the row, as in the reference; a clamped
    tap only occurs on a border, where the shift is zeroed anyway.
    """
    n, k, h, w = heatmap.shape
    flat = heatmap.reshape(n, k, h * w)
    x = coords[..., 0]
    y = coords[..., 1]

    def nb(offset: int) -> torch.Tensor:
        j = torch.clamp(idx + offset, 0, h * w - 1)
        return torch.gather(flat, 2, j[..., None])[..., 0]

    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    dx = torch.where((x >= 1) & (x <= w - 2), nb(1) - nb(-1), zero)
    dy = torch.where((y >= 1) & (y <= h - 2), nb(w) - nb(-w), zero)
    d = torch.stack([dx, dy], dim=-1)
    # jnp.sign(NaN) is NaN, torch.sign(NaN) is 0: keep the reference's NaN
    return coords + torch.where(d.isnan(), d, torch.sign(d)) * 0.25
