"""On-device input pipeline: normalize + target encode inside the train step.

Counterpart of mindpose_tpu/data/device_pipeline.py for ``device_pipeline:
true``. Top-down: host workers stop at the affine crop, and raw
uint8-range crops with post-affine keypoints go to the device, where the
train step normalizes them and renders the targets (``ops/target.py``):
Gaussian heatmaps, or the SimCC head's bin labels, or the RLE head's
coordinates. Bottom-up (:180-219): the host stops after the warp
and the AE tag indices (``bottomup_generate_tag_ind``), and the
multi-level targets render on the device from the per-level keypoints
(~12 KB per record in place of ~9 MB of targets at 512x512). The model
takes NCHW, so the preprocess returns the image NCHW; targets put the
joint axis before the spatial ones too.
"""
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..ops.image import normalize_image
from ..ops.target import (
    generate_bottomup_targets,
    generate_regression_targets,
    generate_simcc_targets,
    generate_topdown_targets,
)

__all__ = ["strip_host_target_transform", "build_topdown_preprocess",
           "BOTTOMUP_DEVICE_FINAL_COLUMNS", "swap_bottomup_target_transform",
           "build_bottomup_preprocess"]


def strip_host_target_transform(
    transforms: List[Any],
) -> Tuple[List[Any], Dict[str, Any]]:
    """Remove the host target-encode transform from the list.

    Returns its kwargs; for the SimCC / regression variants a
    ``target_type`` marker is added so build_topdown_preprocess renders bin
    labels / normalized coordinates instead of heatmaps.
    """
    kept = []
    target_kwargs: Dict[str, Any] = {}
    for t in transforms:
        name = t if isinstance(t, str) else list(t.keys())[0]
        if name == "topdown_generate_target":
            if isinstance(t, dict):
                target_kwargs = dict(list(t.values())[0] or {})
            continue
        if name == "topdown_generate_simcc_target":
            if isinstance(t, dict):
                target_kwargs = dict(list(t.values())[0] or {})
            target_kwargs["target_type"] = "simcc"
            continue
        if name == "topdown_generate_regression_target":
            if isinstance(t, dict):
                target_kwargs = dict(list(t.values())[0] or {})
            target_kwargs["target_type"] = "regression"
            continue
        kept.append(t)
    return kept, target_kwargs


def build_topdown_preprocess(
    image_size,
    heatmap_size,
    normalize_mean,
    normalize_std,
    sigma: float = 2.0,
    use_udp: bool = False,
    target_type: str = "heatmap",
    split_ratio: float = 2.0,
) -> Callable:
    """Preprocess for build_train_step: (image [N, H, W, 3] uint8-range,
    keypoints [N, K, 3]) -> (normalized image [N, 3, H, W] float32,
    target, target_weight [N, K]).

    ``target_type`` picks the target, as the JAX package's
    ``_make_target_encoder`` does: "heatmap" renders Gaussian heatmaps [N, K,
    h, w]; "simcc" per-axis bin labels [N, K, Bx+By]; "regression"
    normalized coordinates [N, K, 2].
    """
    mean, std = tuple(normalize_mean), tuple(normalize_std)
    hm = (int(heatmap_size[0]), int(heatmap_size[1]))
    im = (int(image_size[0]), int(image_size[1]))

    def encode(keypoints: torch.Tensor):
        if target_type == "simcc":
            return generate_simcc_targets(keypoints, input_size=im, split_ratio=split_ratio,
                                          sigma=sigma)
        if target_type == "regression":
            return generate_regression_targets(keypoints, input_size=im)
        return generate_topdown_targets(keypoints, heatmap_size=hm, image_size=im, sigma=sigma,
                                        use_udp=use_udp)

    def preprocess(image: torch.Tensor, keypoints: torch.Tensor):
        image = normalize_image(image, mean, std).permute(0, 3, 1, 2).contiguous()
        target, weight = encode(keypoints)
        return image, target, weight

    return preprocess


BOTTOMUP_DEVICE_FINAL_COLUMNS = ["image", "keypoints", "mask", "tag_ind"]


def swap_bottomup_target_transform(transforms: List[Any]) -> Tuple[List[Any], float]:
    """Replace the host ``bottomup_generate_target`` by ``bottomup_generate_tag_ind``
    with the same arguments, as the JAX train entry does (``tools/train.py:135``);
    returns the new list and the target's ``sigma``."""
    sigma = 2.0
    swapped = []
    for t in transforms:
        name = t if isinstance(t, str) else next(iter(t))
        if name == "bottomup_generate_target":
            kwargs = dict() if isinstance(t, str) else dict(next(iter(t.values())) or {})
            sigma = float(kwargs.get("sigma", 2.0))
            swapped.append({"bottomup_generate_tag_ind": kwargs})
        else:
            swapped.append(t)
    return swapped, sigma


def build_bottomup_preprocess(
    heatmap_sizes,
    normalize_mean,
    normalize_std,
    sigma: float = 2.0,
) -> Callable:
    """Preprocess for build_train_step: (image [N, H, W, 3] uint8-range,
    keypoints [N, S, max_num, K, 3] in each level's heatmap frame, mask
    [N, S, Hmax, Wmax] uint8, tag_ind) -> (normalized image [N, 3, H, W]
    float32, target [N, S, K, Hmax, Wmax] float32, each level zero-padded
    to the largest, mask as float32, tag_ind)."""
    mean, std = tuple(normalize_mean), tuple(normalize_std)
    sizes = [(int(w), int(h)) for w, h in heatmap_sizes]
    hmax = max(h for _, h in sizes)
    wmax = max(w for w, _ in sizes)

    def preprocess(image: torch.Tensor, keypoints: torch.Tensor, mask: torch.Tensor,
                   tag_ind: torch.Tensor):
        image = normalize_image(image, mean, std).permute(0, 3, 1, 2).contiguous()
        n, k = keypoints.shape[0], keypoints.shape[3]
        target = torch.zeros((n, len(sizes), k, hmax, wmax), dtype=torch.float32,
                             device=keypoints.device)
        for s, (w, h) in enumerate(sizes):
            target[:, s, :, :h, :w] = generate_bottomup_targets(
                keypoints[:, s], heatmap_size=(w, h), sigma=sigma)
        return image, target, mask.float(), tag_ind

    return preprocess
