"""Gaussian heatmap targets for top-down training, on the device.

Counterpart of ``mindpose_tpu/ops/target.py:generate_topdown_targets``: the
whole target renders as one elementwise expression, with the reference's
semantics (round-to-pixel centres, the 3-sigma window, the UDP sub-pixel
variant, zero weight out of bounds), in the port's NCHW layout. The details
that decide where a Gaussian lands are the JAX package's:
- ``torch.round`` rounds half to even, as ``jnp.round`` and numpy's do;
- window bounds truncate toward zero (``torch.trunc``), as Python's ``int()``;
- the window is ``[ul, br)``;
- the effective centre is ``ul + size // 2``, not ``mu``.
Strides divide as float32 tensors, not Python scalars: PyTorch on CUDA would
multiply by a scalar's reciprocal, which rounds differently.
"""
from typing import Tuple

import torch

__all__ = ["generate_topdown_targets"]


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def generate_topdown_targets(
    keypoints: torch.Tensor,
    heatmap_size: Tuple[int, int],
    image_size: Tuple[int, int],
    sigma: float = 2.0,
    use_udp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render per-joint Gaussian targets.

    Args:
        keypoints: [N, K, 3] (x, y in input-image pixels, visibility).
        heatmap_size: (W, H); image_size: (W, H).

    Returns:
        target [N, K, H, W] float32, target_weight [N, K] float32.
    """
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    iw, ih = image_size
    tmp_size = sigma * 3.0
    size = int(2 * tmp_size + 1)
    k_center = size // 2

    keypoints = keypoints.float()
    kx, ky, vis = keypoints[..., 0], keypoints[..., 1], keypoints[..., 2]

    if use_udp:
        mu_x_ac = kx / _f32((iw - 1.0) / (w - 1.0), kx)
        mu_y_ac = ky / _f32((ih - 1.0) / (h - 1.0), ky)
        mu_x = torch.trunc(mu_x_ac + 0.5).to(torch.int32)
        mu_y = torch.trunc(mu_y_ac + 0.5).to(torch.int32)
        # the UDP kernel's peak is shifted by the sub-pixel remainder
        frac_x, frac_y = mu_x_ac - mu_x, mu_y_ac - mu_y
    else:
        mu_x = torch.round(kx / _f32(iw / w, kx)).to(torch.int32)
        mu_y = torch.round(ky / _f32(ih / h, ky)).to(torch.int32)
        frac_x = frac_y = 0.0

    ul_x = torch.trunc(mu_x - tmp_size).to(torch.int32)
    ul_y = torch.trunc(mu_y - tmp_size).to(torch.int32)
    br_x = torch.trunc(mu_x + tmp_size + 1).to(torch.int32)
    br_y = torch.trunc(mu_y + tmp_size + 1).to(torch.int32)
    in_bounds = ~((ul_x >= w) | (ul_y >= h) | (br_x < 0) | (br_y < 0))
    weight = vis * in_bounds.float()  # [N, K]

    cx = (ul_x.float() + k_center + frac_x)[..., None, None]  # [N, K, 1, 1]
    cy = (ul_y.float() + k_center + frac_y)[..., None, None]
    xs = torch.arange(w, dtype=torch.float32, device=keypoints.device)  # [W]
    ys = torch.arange(h, dtype=torch.float32, device=keypoints.device)[:, None]  # [H, 1]
    g = torch.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / _f32(2.0 * sigma**2, kx))  # [N, K, H, W]

    win = ((xs >= ul_x[..., None, None]) & (xs < br_x[..., None, None])
           & (ys >= ul_y[..., None, None]) & (ys < br_y[..., None, None]))
    active = (weight > 0.5)[..., None, None]
    target = torch.where(win & active, g, 0.0)
    return target, weight
