"""Visualize top-down predicted heatmaps and keypoints for a checkpoint.

Counterpart of the JAX package's ``tools/visual/visual_pred_heatmap_topdown.py``:
for N samples of the val loader (batch 1, ground-truth boxes), the crop
with the predicted heatmaps' maximum over the joints overlaid and the
decoded joints above 0.2 drawn in white, written as ``pred_<i>.jpg``. The
net and the decoder (``to_original=False``: keypoints in the heatmap's
frame) run through ``create_eval_network(net, decoder, output_raw=True)``,
in float32; on the card the decode is one launch of the decode kernel per
sample.

The checkpoint is the port's own or the JAX package's flax msgpack file
(``utils/checkpoint.load_net_state_dict``); without ``--ckpt`` the net's
initial weights (torch seed 0) are drawn, with a warning. It runs on the
current CUDA device unless ``--device`` says otherwise, and raises without
CUDA.

Usage:
    python3 -m mindpose_tpu_torch.tools.visual_pred_heatmap_topdown --config <cfg.yaml> \\
        --ckpt <ckpt> [--num-samples 4] [--output-dir ./vis_pred] [--device cpu]
"""
import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import parse_args
from ..data import create_dataset, create_pipeline
from ..models import Net, create_decoder, create_eval_network, create_network_from_config
from ..utils.checkpoint import load_net_state_dict

__all__ = ["SEED", "DEVICE_FLAG", "VIS_THR", "resolve_device", "build_net", "run", "main"]

SEED = 0  # the torch seed of the initial weights drawn without --ckpt
VIS_THR = 0.2  # joints drawn above this score, as the JAX tool draws them
DEVICE_FLAG = {"names": ["--device"], "default": None,
               "help": "where the model runs (default: the current CUDA device)"}


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device``, or the current CUDA device; raises without CUDA."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the tool runs on the GPU by default, and CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def build_net(args: Any) -> Net:
    """The config's net with ``args.ckpt``'s weights (the port's or a JAX
    msgpack file), or its initial weights from torch seed ``SEED``."""
    if getattr(args, "ckpt", None):
        with torch.device("meta"):
            skeleton = create_network_from_config(args)
        state = load_net_state_dict(args.ckpt, skeleton)
        net = create_network_from_config(args)
        net.load_state_dict(state, strict=True)
        return net
    logging.warning("no --ckpt: drawing the net's initial weights (torch seed %d)", SEED)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return create_network_from_config(args)


def run(args: Any) -> List[Dict[str, Any]]:
    """Write ``args.num_samples`` images to ``args.output_dir``; returns, per
    sample, its ``path`` and ``preds`` [K, 3] (x, y, score in the heatmap's frame)."""
    import cv2

    device = resolve_device(getattr(args, "device", None))
    os.makedirs(args.output_dir, exist_ok=True)
    dataset = create_dataset(
        args.val_root, args.val_label, dataset_format=args.dataset_format,
        is_train=False, use_gt_bbox_for_val=True, config=args.dataset_setting,
    )
    loader = create_pipeline(
        dataset, transforms=args.val_transforms, method=args.pipeline_method,
        batch_size=1, is_train=False, normalize_mean=args.normalize_mean,
        normalize_std=args.normalize_std, config=args.dataset_setting,
    )
    net = build_net(args).to(device)
    decoder = create_decoder(
        args.decoder_name, to_original=False,
        **{k: v for k, v in (getattr(args, "decoder_setting", None) or {}).items()
           if k != "to_original"},
    )
    eval_net = create_eval_network(net, decoder, output_raw=True)
    if device.type == "cuda":  # float32 convolutions, as the CPU computes them
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    mean = np.array(args.normalize_mean) * 255.0
    std = np.array(args.normalize_std) * 255.0

    def column(batch, key):
        return torch.from_numpy(np.ascontiguousarray(batch[key], np.float32)).to(device)

    results = []
    it = iter(loader)
    for i in range(args.num_samples):
        batch = next(it)
        image = column(batch, "image").permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        (preds, _), heatmap = eval_net(image, column(batch, "center"), column(batch, "scale"),
                                       column(batch, "bbox_scores"))
        preds, heatmap = preds.cpu().numpy(), heatmap.float().cpu().numpy()  # heatmap NCHW
        img = np.clip(batch["image"][0] * std + mean, 0, 255).astype(np.uint8)
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        hm = heatmap[0].max(axis=0)
        hm = cv2.resize(np.clip(hm * 255, 0, 255).astype(np.uint8),
                        (img.shape[1], img.shape[0]))
        vis = cv2.addWeighted(img, 0.6, cv2.applyColorMap(hm, cv2.COLORMAP_JET), 0.4, 0)

        # draw decoded keypoints (heatmap frame -> image frame scale)
        scale_x = img.shape[1] / heatmap.shape[3]
        scale_y = img.shape[0] / heatmap.shape[2]
        for x, y, s in preds[0]:
            if s > VIS_THR:
                cv2.circle(vis, (int(x * scale_x), int(y * scale_y)), 3, (255, 255, 255), -1)
        out = os.path.join(args.output_dir, f"pred_{i}.jpg")
        cv2.imwrite(out, vis)
        print(f"wrote {out}")
        results.append({"path": out, "preds": preds[0]})
    return results


def main(argv: Optional[Sequence[str]] = None):
    """The CLI: parse ``argv`` (default ``sys.argv``) and ``run``; returns its result."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv, description="visualize top-down predictions", extra_args=[
        {"names": ["--num-samples"], "type": int, "default": 4},
        {"names": ["--output-dir"], "type": str, "default": "./vis_pred"},
        DEVICE_FLAG,
    ])
    return run(args)


if __name__ == "__main__":
    main()
