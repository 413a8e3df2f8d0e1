"""Visualize bottom-up AE predictions: each grouped person's joints.

Counterpart of the JAX package's ``tools/visual/visual_pred_heatmap_ae.py``:
for N samples of the bottom-up val loader (batch 1, the config's val
transforms), the persons that the bottom-up inferencer finds, each in its
own colour, their joints above ``vis_thr`` mapped back into the loader's
image, written as ``ae_<i>.jpg``. The inferencer runs the forward, the
decode and the tag grouping; on the card with ``device_grouping`` (its
default there) the grouping is one launch of the grouping kernel per sample.

The checkpoint is the port's own or the JAX package's flax msgpack file;
without ``--ckpt`` the net's initial weights (torch seed 0) are drawn, with
a warning. It runs on the current CUDA device unless ``--device`` says
otherwise, and raises without CUDA.

Usage:
    python3 -m mindpose_tpu_torch.tools.visual_pred_heatmap_ae --config <cfg.yaml> \\
        --ckpt <ckpt> [--num-samples 2] [--output-dir ./vis_ae] [--device cpu]
"""
import logging
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import parse_args
from ..data import create_dataset, create_pipeline
from ..engine import create_inferencer
from ..models import create_decoder, create_eval_network
from .visual_pred_heatmap_topdown import DEVICE_FLAG, build_net, resolve_device

__all__ = ["COLORS", "run", "main"]

COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (128, 255, 0), (255, 128, 0), (0, 128, 255), (128, 0, 255),
]


def run(args: Any) -> List[Dict[str, Any]]:
    """Write ``args.num_samples`` images to ``args.output_dir``; returns, per
    sample, its ``path`` and the inferencer's ``record`` (the persons ``pred``
    [P, K, 3 + L] in the original frame and their ``score``)."""
    import cv2

    device = resolve_device(getattr(args, "device", None))
    os.makedirs(args.output_dir, exist_ok=True)
    dataset = create_dataset(
        args.val_root, args.val_label, dataset_format=args.dataset_format,
        is_train=False, config=args.dataset_setting,
    )
    loader = create_pipeline(
        dataset, transforms=args.val_transforms, method="bottomup",
        batch_size=1, is_train=False, normalize_mean=args.normalize_mean,
        normalize_std=args.normalize_std, config=args.dataset_setting,
    )
    decoder = create_decoder(
        args.decoder_name, **(getattr(args, "decoder_setting", None) or {})
    )
    eval_net = create_eval_network(build_net(args), decoder, output_raw=True)
    inferencer = create_inferencer(
        eval_net, name=args.inference_method, config=args.eval_setting,
        dataset_config=args.dataset_setting, device=device,
    )

    mean = np.array(args.normalize_mean) * 255.0
    std = np.array(args.normalize_std) * 255.0
    vis_thr = args.eval_setting["vis_thr"]

    results = []
    it = iter(loader)
    for i in range(args.num_samples):
        batch = next(it)
        # device decode and grouping through the real inference path
        record = inferencer([batch])[0]

        img = np.clip(batch["image"][0] * std + mean, 0, 255).astype(np.uint8)
        vis = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)

        # draw grouped instances in the padded-image frame
        center = batch["center"][0]
        scale = np.asarray(batch["scale"][0], np.float64) * args.dataset_setting["pixel_std"]
        shape = np.asarray(batch["image_shape"][0], np.float64)
        for j, (kpt, score) in enumerate(zip(record["pred"], record["score"])):
            if score <= 0:
                continue
            color = COLORS[j % len(COLORS)]
            # map original-frame coords back into the padded canvas
            for x, y, s, *rest in np.asarray(kpt):
                if s > vis_thr:
                    cx = (x - center[0] + scale[0] * 0.5) * shape[0] / scale[0]
                    cy = (y - center[1] + scale[1] * 0.5) * shape[1] / scale[1]
                    cv2.circle(vis, (int(cx), int(cy)), 3, color, -1)
        out = os.path.join(args.output_dir, f"ae_{i}.jpg")
        cv2.imwrite(out, vis)
        print(f"wrote {out}")
        results.append({"path": out, "record": record})
    return results


def main(argv: Optional[Sequence[str]] = None):
    """The CLI: parse ``argv`` (default ``sys.argv``) and ``run``; returns its result."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv, description="visualize bottom-up AE predictions", extra_args=[
        {"names": ["--num-samples"], "type": int, "default": 2},
        {"names": ["--output-dir"], "type": str, "default": "./vis_ae"},
        DEVICE_FLAG,
    ])
    return run(args)


if __name__ == "__main__":
    main()
