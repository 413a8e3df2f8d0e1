"""Heatmap decode primitives in PyTorch.

Counterpart of mindpose_tpu/ops/heatmap.py: ``argmax_coords`` and
``quarter_offset``, the plain versions of the decode kernel, and the
DARK/UDP refinement (``gaussian_kernel_2d``, a numpy copy,
``gaussian_blur_depthwise`` and ``dark_udp_refine``), which the JAX package
runs as plain XLA outside its Pallas kernel, and which runs here as plain
PyTorch after the kernel's argmax. The port's heatmaps are NCHW,
[N, K, H, W], so each (instance, joint) row of H*W values is contiguous.
"""
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["argmax_coords", "quarter_offset", "gaussian_kernel_2d", "gaussian_blur_depthwise",
           "dark_udp_refine"]


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


def gaussian_kernel_2d(kernel_size: int) -> np.ndarray:
    """Normalized 2D Gaussian with OpenCV's sigma rule (ref decoder :207-215)."""
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    xs = np.arange(-(kernel_size - 1) // 2, (kernel_size - 1) // 2 + 1, 1)
    ys = xs[:, None]
    kernel = np.exp(-(xs**2 + ys**2) / (2 * sigma**2))
    return (kernel / kernel.sum()).astype(np.float32)


def gaussian_blur_depthwise(heatmap: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' convolution (zero padding) of an NCHW heatmap with a 2D
    kernel, in float32."""
    k = heatmap.shape[1]
    kh, kw = kernel.shape
    filt = kernel.to(torch.float32).expand(k, 1, kh, kw).contiguous()
    return F.conv2d(heatmap.to(torch.float32), filt, padding="same", groups=k)


def dark_udp_refine(
    coords: torch.Tensor, heatmap: torch.Tensor, kernel: torch.Tensor
) -> torch.Tensor:
    """DARK/UDP sub-pixel refinement: one Newton step on the log of the blurred heatmap.

    The blurred heatmap is clamped to [0.001, 50], log-transformed and
    zero-padded by one pixel; the first derivatives and the 2x2 Hessian at
    the argmax come from central differences, and the step uses the
    Hessian's closed-form inverse (with 1e-7 added to its diagonal), as the
    JAX package's ``dark_udp_refine`` does.

    coords: [N, K, 2] integer argmax positions (x, y); heatmap: [N, K, H, W].
    Returns the refined coords [N, K, 2].
    """
    n, k, h, w = heatmap.shape
    hm = gaussian_blur_depthwise(heatmap, kernel)
    hm = torch.log(torch.clamp(hm, 0.001, 50.0))
    stride = w + 2
    flat = F.pad(hm, (1, 1, 1, 1)).reshape(n, k, (h + 2) * stride)

    xi = coords[..., 0].to(torch.int64) + 1
    yi = coords[..., 1].to(torch.int64) + 1
    center = xi + yi * stride  # [N, K], inside the padded map with every offset below

    def at(offset: int) -> torch.Tensor:
        return torch.gather(flat, 2, (center + offset)[..., None])[..., 0]

    i0 = at(0)
    ix1 = at(1)
    ix1_ = at(-1)
    iy1 = at(stride)
    iy1_ = at(-stride)
    ix1y1 = at(stride + 1)
    ix1_y1_ = at(-stride - 1)

    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2.0 * i0 + ix1_
    dyy = iy1 - 2.0 * i0 + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2.0 * i0 - ix1_ - iy1_ + ix1_y1_)

    # closed-form inverse of ([dxx, dxy], [dxy, dyy]) + 1e-7 * I
    a = dxx + 1e-7
    d = dyy + 1e-7
    b = dxy
    det = a * d - b * b
    inv_det = 1.0 / det
    step_x = inv_det * (d * dx - b * dy)
    step_y = inv_det * (a * dy - b * dx)
    return coords - torch.stack([step_x, step_y], dim=-1)
