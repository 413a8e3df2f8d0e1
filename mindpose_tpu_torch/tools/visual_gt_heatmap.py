"""Visualize ground-truth heatmaps and masks from the training pipeline.

Counterpart of the JAX package's ``tools/visual/visual_gt_heatmap.py``:
for N samples of the train loader (batch 1, the config's train transforms,
its shuffle from seed 0), the augmented image with the summed target
heatmap overlaid (top-down), or one panel per heatmap level and the mask
(bottom-up), written as ``gt_<i>.jpg``. It needs no net and runs on the
host (numpy and cv2). With one loader worker its images are the JAX
tool's, byte for byte (tests/test_torch_visual.py).

Usage:
    python3 -m mindpose_tpu_torch.tools.visual_gt_heatmap --config <cfg.yaml> \\
        [--num-samples 4] [--output-dir ./vis_gt]
"""
import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from ..config import parse_args
from ..data import create_dataset, create_pipeline

__all__ = ["overlay_heatmap", "run", "main"]


def overlay_heatmap(image_norm: np.ndarray, heatmap: np.ndarray, mean, std) -> np.ndarray:
    """image_norm: normalized HWC; heatmap: [H', W'] in [0, 1]."""
    import cv2

    img = (image_norm * (np.array(std) * 255.0) + np.array(mean) * 255.0)
    img = np.clip(img, 0, 255).astype(np.uint8)
    hm = cv2.resize(heatmap, (img.shape[1], img.shape[0]))
    hm = np.clip(hm * 255.0, 0, 255).astype(np.uint8)
    hm_color = cv2.applyColorMap(hm, cv2.COLORMAP_JET)
    return cv2.addWeighted(cv2.cvtColor(img, cv2.COLOR_RGB2BGR), 0.6, hm_color, 0.4, 0)


def run(args) -> List[str]:
    """Write ``args.num_samples`` images to ``args.output_dir``; returns their paths."""
    import cv2

    os.makedirs(args.output_dir, exist_ok=True)
    dataset = create_dataset(
        args.train_root, args.train_label, dataset_format=args.dataset_format,
        is_train=True, config=args.dataset_setting,
    )
    loader = create_pipeline(
        dataset, transforms=args.train_transforms, method=args.pipeline_method,
        batch_size=1, is_train=True, normalize_mean=args.normalize_mean,
        normalize_std=args.normalize_std, config=args.dataset_setting,
    )
    written = []
    it = iter(loader)
    for i in range(args.num_samples):
        batch = next(it)
        image = batch["image"][0]
        target = batch["target"][0]
        if args.pipeline_method == "topdown":
            hm = target.max(axis=-1)  # [H', W', K] -> [H', W']
            vis = overlay_heatmap(image, hm, args.normalize_mean, args.normalize_std)
        else:
            # bottom-up: one panel per level plus the mask
            panels = [overlay_heatmap(image, target[lvl].max(axis=-1), args.normalize_mean,
                                      args.normalize_std) for lvl in range(target.shape[0])]
            mask = batch["mask"][0]
            mask_vis = (mask[0][..., None] * np.array([0, 255, 0])).astype(np.uint8)
            mask_vis = cv2.resize(mask_vis, (panels[0].shape[1], panels[0].shape[0]))
            panels.append(mask_vis)
            vis = np.concatenate(panels, axis=1)
        out = os.path.join(args.output_dir, f"gt_{i}.jpg")
        cv2.imwrite(out, vis)
        print(f"wrote {out}")
        written.append(out)
    loader.close()
    return written


def main(argv: Optional[Sequence[str]] = None):
    """The CLI: parse ``argv`` (default ``sys.argv``) and ``run``; returns its result."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv, description="visualize gt heatmaps", extra_args=[
        {"names": ["--num-samples"], "type": int, "default": 4},
        {"names": ["--output-dir"], "type": str, "default": "./vis_gt"},
    ])
    return run(args)


if __name__ == "__main__":
    main()
