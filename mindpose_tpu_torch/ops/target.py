"""Training targets, on the device.

Counterparts of ``mindpose_tpu/ops/target.py``: the Gaussian heatmaps of
``generate_topdown_targets`` and ``generate_bottomup_targets`` (:25-97), the
SimCC bin labels of ``generate_simcc_targets`` (:184) and the regression
coordinates of ``generate_regression_targets`` (:227). A top-down target renders as one
elementwise expression; a bottom-up level as one such expression per
instance slot, combined by a running max. Both keep the reference's
semantics (round-to-pixel centres, the 3-sigma window, the UDP sub-pixel
variant, zero weight out of bounds), in the port's NCHW layout. The details
that decide where a Gaussian lands are the JAX package's:
- ``torch.round`` rounds half to even, as ``jnp.round`` and numpy's do;
- window bounds truncate toward zero (``torch.trunc``), as Python's ``int()``;
- the window is ``[ul, br)``;
- the effective centre is ``ul + size // 2``, not ``mu``.
Strides divide as float32 tensors, not Python scalars: PyTorch on CUDA would
multiply by a scalar's reciprocal, which rounds differently. So do the
SimCC Gaussian's ``2 sigma^2`` and the regression's input size, so that
the targets follow the host transforms' arithmetic
(``data/transform/topdown_transform.py``): the regression targets equal
them bit for bit, the SimCC labels up to ``exp``'s rounding and the order
of each row's sum.
"""
from typing import Tuple

import torch

__all__ = ["generate_topdown_targets", "generate_bottomup_targets",
           "generate_simcc_targets", "generate_regression_targets"]


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


def generate_bottomup_targets(
    keypoints: torch.Tensor,
    heatmap_size: Tuple[int, int],
    sigma: float = 2.0,
) -> torch.Tensor:
    """Multi-instance Gaussian heatmaps with a per-pixel max, one level.

    The host ``bottomup_generate_target``'s rasterization, in its float32
    arithmetic: each visible point's patch starts at ``ul`` (the rounded
    centre minus ``3 * sigma``, truncated toward zero; the window is
    ``[ul, br)``), its sub-pixel centre in patch coordinates is
    ``(size_f // 2 + x) - round(x)`` with ``size_f // 2`` a float, and a
    pixel's distance is taken from its patch index ``xs - ul``; instances
    combine by max. So the targets differ from the host's by ``exp``'s
    rounding alone. (The JAX package's device targets take the centre as
    ``(ul + size_f // 2) + (x - round(x))`` in map coordinates, which rounds
    otherwise: up to ~1.6e-6 from its own host targets.) Each instance slot
    renders over the whole map and the canvas keeps the running max, so the
    temporaries are [N, K, H, W] per slot, never [M, N, K, H, W] (at batch
    32 a 256x256 level of 17 joints is 142 MB).

    Args:
        keypoints: [N, M, K, 3] in this level's heatmap coordinates
            (x, y, visibility); padded instance slots have visibility 0.
        heatmap_size: (W, H).

    Returns:
        target [N, K, H, W] float32.
    """
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    tmp_size = sigma * 3.0
    size_f = 2.0 * tmp_size + 1.0
    x0 = size_f // 2  # float floor-half (6.0 for sigma=2)

    keypoints = keypoints.float()
    n, m, k = keypoints.shape[:3]
    xs = torch.arange(w, dtype=torch.float32, device=keypoints.device)  # [W]
    ys = torch.arange(h, dtype=torch.float32, device=keypoints.device)[:, None]  # [H, 1]
    two_sigma2 = _f32(2.0 * sigma**2, keypoints)
    canvas = torch.zeros((n, k, h, w), dtype=torch.float32, device=keypoints.device)
    for slot in range(m):
        px, py, vis = keypoints[:, slot].unbind(-1)  # [N, K] each
        mu_x = torch.round(px).to(torch.int32)  # half to even
        mu_y = torch.round(py).to(torch.int32)
        ul_x = torch.trunc(mu_x - tmp_size).to(torch.int32)
        ul_y = torch.trunc(mu_y - tmp_size).to(torch.int32)
        br_x = torch.trunc(mu_x + tmp_size + 1).to(torch.int32)
        br_y = torch.trunc(mu_y + tmp_size + 1).to(torch.int32)
        sel = (vis > 0) & (ul_x < w) & (ul_y < h) & (br_x >= 0) & (br_y >= 0)  # [N, K]

        # patch-local sub-pixel centres and each pixel's patch index, as the host has them
        fx = ((x0 + px) - mu_x.float())[..., None, None]  # [N, K, 1, 1]
        fy = ((x0 + py) - mu_y.float())[..., None, None]
        ux, uy = ul_x.float()[..., None, None], ul_y.float()[..., None, None]
        g = torch.square((xs - ux) - fx) + torch.square((ys - uy) - fy)  # [N, K, H, W]
        g = torch.exp(g.neg_().div_(two_sigma2))
        win = (((xs >= ul_x[..., None, None]) & (xs < br_x[..., None, None]))
               & ((ys >= ul_y[..., None, None]) & (ys < br_y[..., None, None]))
               & sel[..., None, None])
        torch.maximum(canvas, g.masked_fill_(~win, 0.0), out=canvas)
    return canvas


def generate_simcc_targets(
    keypoints: torch.Tensor,
    input_size: Tuple[int, int],
    split_ratio: float = 2.0,
    sigma: float = 6.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-axis discrete Gaussian SimCC labels.

    Gaussians over the x and y bin axes centred at ``keypoints *
    split_ratio``, each normalized to sum 1, zeroed (with weight 0) where the
    centre falls outside the bin range or the joint is invisible.

    Args:
        keypoints: [N, K, 3] (x, y in input-image pixels, visibility).
        input_size: (W, H).

    Returns:
        target [N, K, Bx+By] float32 (x labels, then y labels),
        target_weight [N, K] float32.
    """
    bx = int(round(float(input_size[0]) * split_ratio))
    by = int(round(float(input_size[1]) * split_ratio))
    keypoints = keypoints.float()
    mu = keypoints[..., :2] * split_ratio  # [N, K, 2]
    vis = keypoints[..., 2] > 0
    inside = (mu[..., 0] >= 0) & (mu[..., 0] < bx) & (mu[..., 1] >= 0) & (mu[..., 1] < by)
    weight = (vis & inside).float()
    two_sigma2 = _f32(2.0 * sigma**2, keypoints)

    def labels(centers: torch.Tensor, n_bins: int) -> torch.Tensor:
        grid = torch.arange(n_bins, dtype=torch.float32, device=keypoints.device)
        g = torch.exp(-((grid - centers[..., None]) ** 2) / two_sigma2)
        return g / torch.clamp_min(g.sum(dim=-1, keepdim=True), 1e-12)

    target = torch.cat([labels(mu[..., 0], bx), labels(mu[..., 1], by)], dim=-1)
    return target * weight[..., None], weight


def generate_regression_targets(
    keypoints: torch.Tensor,
    input_size: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized-coordinate regression targets: the keypoints over the input
    size, zeroed (with weight 0) outside the crop or where invisible.

    Args:
        keypoints: [N, K, 3] (x, y in input-image pixels, visibility).
        input_size: (W, H).

    Returns:
        target [N, K, 2] float32, target_weight [N, K] float32.
    """
    w, h = float(input_size[0]), float(input_size[1])
    keypoints = keypoints.float()
    xy = keypoints[..., :2]
    vis = keypoints[..., 2] > 0
    inside = (xy[..., 0] >= 0) & (xy[..., 0] < w) & (xy[..., 1] >= 0) & (xy[..., 1] < h)
    weight = (vis & inside).float()
    target = xy / torch.tensor([w, h], dtype=torch.float32, device=keypoints.device)
    return target * weight[..., None], weight
