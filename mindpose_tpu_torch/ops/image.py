"""Device image ops: batched inverse-affine bilinear warp and normalize.

Counterpart of mindpose_tpu/ops/image.py. Each output pixel back-projects
through its sample's inverse affine matrix and bilinearly samples the source
by a direct gather, with zero padding outside it: cv2.warpAffine's
coordinate convention (INTER_LINEAR, BORDER_CONSTANT 0) in float arithmetic.
``grid_sample`` is not used, because its normalised coordinates and
``align_corners`` follow another convention. Images are NHWC here, as in the
JAX package; the predictor permutes to NCHW once, before the model.
"""
from typing import Sequence, Tuple

import torch

__all__ = ["affine_warp", "invert_affine", "normalize_image"]


def invert_affine(mat: torch.Tensor) -> torch.Tensor:
    """Invert 2x3 affine matrices ([..., 2, 3])."""
    a, b, tx = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    c, d, ty = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    det = a * d - b * c
    ia = d / det
    ib = -b / det
    ic = -c / det
    id_ = a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_warp(
    images: torch.Tensor, mats: torch.Tensor, out_hw: Tuple[int, int]
) -> torch.Tensor:
    """Warp a batch: images [N, H, W, C] with FORWARD 2x3 mats [N, 2, 3].

    The matrix maps source to destination, as cv2.warpAffine's does; sampling
    uses its inverse. ``images`` may be uint8 and may be an expanded view of
    one image (stride 0 over N). Returns float32 [N, oh, ow, C].
    """
    n, h, w, c = images.shape
    oh, ow = out_hw
    inv = invert_affine(mats.to(torch.float32))[:, :, :, None, None]  # [N, 2, 3, 1, 1]
    ys = torch.arange(oh, dtype=torch.float32, device=images.device)
    xs = torch.arange(ow, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [oh, ow]

    sx = inv[:, 0, 0] * gx + inv[:, 0, 1] * gy + inv[:, 0, 2]  # [N, oh, ow]
    sy = inv[:, 1, 0] * gx + inv[:, 1, 1] * gy + inv[:, 1, 2]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    flat = images.reshape(n, h * w, c)
    rows = torch.arange(n, device=images.device)[:, None]

    def sample(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        vals = flat[rows, idx.reshape(n, -1)].reshape(n, oh, ow, c)
        return vals.to(torch.float32) * valid[..., None]

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)

    fx = fx[..., None]
    fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def normalize_image(
    images: torch.Tensor, mean: Sequence[float], std: Sequence[float]
) -> torch.Tensor:
    """(x - 255*mean) / (255*std) over the last (channel) axis, float32."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images.device) * 255.0
    std = torch.as_tensor(std, dtype=torch.float32, device=images.device) * 255.0
    return (images.to(torch.float32) - mean) / std
