"""Device-vs-host AE grouping AP across independently trained checkpoints, on the GPU.

Counterpart of ``tools/exp_grouping.py``. Per seed: train HigherHRNet-W32
on synthetic multi-person COCO at ``--image-size`` (256 by default; 512 is
the published recipe's size), then evaluate the same checkpoint twice:
grouped by the host Hungarian (``utils/match.py``) and by the
fixed-capacity matcher, which on the card is the grouping kernel
(``ops/cuda/grouping.match_by_tag_batch``, one launch per batch) and on
the CPU its plain version (``ops/grouping.py``). ``--hflip-tta``,
``--multiscale`` and ``refine_missing_joint`` pin the published eval
recipe end to end. It reports each seed's pair of APs and the largest
|delta|. Training uses the device pipeline (the host stops at the warps
and the tag indices; the multi-level targets render in the step), adam at
1e-3 and bf16 autocast (the JAX tool trains a bf16 net). Finished seeds
are appended to ``<out>.runs.jsonl`` and skipped on resume.

    python3 -m mindpose_tpu_torch.tools.exp_grouping --seeds 0,1,2 --epochs 150 \\
        --out docs/experiments/grouping_device_vs_host.json [--device cpu]
    python3 -m mindpose_tpu_torch.tools.exp_grouping --seeds 0 --image-size 512 --hflip-tta \\
        --multiscale 1.0,2.0 --out docs/experiments/grouping_512.json
"""
import argparse
import json
import logging
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data import create_dataset, create_pipeline
from ..data.device_pipeline import BOTTOMUP_DEVICE_FINAL_COLUMNS, build_bottomup_preprocess
from ..engine import create_evaluator, create_inferencer
from ..models import (
    create_decoder,
    create_eval_network,
    create_loss,
    create_network,
    create_network_with_loss,
)
from ..optim import create_optimizer
from ..parallel import build_train_step
from .make_synthetic_coco import generate_split
from .timing import resolve_device

__all__ = ["SETTING", "EVAL_SETTING", "K", "M", "BACKBONE", "apply_image_size", "train_seed",
           "eval_grouping", "main"]

SETTING = {
    "image_size": [256, 256],
    "max_image_size": [256, 256],
    "heatmap_sizes": [[64, 64], [128, 128]],
    "sigma": 2.0,
    "expand_mask": True,
    "pixel_std": 200.0,
    "tag_per_joint": True,
    "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]],
}
EVAL_SETTING = {
    "has_heatmap_output": True,
    "hflip_tta": False,
    "downsample_scale": 2,
    "vis_thr": 0.1,
    "oks_thr": 0.9,
    "tag_thr": 1.0,
    "joint_order": [0, 1, 2, 3, 4, 5, 6, 11, 12, 7, 8, 9, 10, 13, 14, 15, 16],
    "ignore_too_much": False,
    "use_rounded_norm": True,
    "use_nms": False,
    "soft_nms": False,
    "refine_missing_joint": True,
    "sigmas": [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
               0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089,
               0.089],
}
K, M = 17, 30
BACKBONE = "hrnet_w32"
NORMALIZE_MEAN = [0.485, 0.456, 0.406]
NORMALIZE_STD = [0.229, 0.224, 0.225]


def apply_image_size(size: int) -> None:
    """Re-derive the size-coupled settings for a square --image-size."""
    SETTING["image_size"] = [size, size]
    SETTING["max_image_size"] = [size, size]
    SETTING["heatmap_sizes"] = [[size // 4, size // 4],
                                [size // 2, size // 2]]


def train_seed(seed: int, data, epochs: int, batch_size: int, steps_per_epoch: int,
               device: Optional[torch.device] = None,
               amp_level: str = "O2") -> torch.nn.Module:
    """Train HigherHRNet (``BACKBONE`` + ``higher_hrnet_head``) from torch seed
    ``seed`` for ``epochs`` x ``steps_per_epoch`` steps (the loader restarts
    when it runs out); returns the net."""
    device = torch.device(device) if device is not None else resolve_device(None)
    img_root, ann = data["train"]
    ds = create_dataset(img_root, ann, dataset_format="coco_bottomup", is_train=True,
                        config=SETTING)
    # the host stops after the warps and the AE tag indices; the multi-level
    # Gaussian targets render in the step
    loader = create_pipeline(
        ds,
        [{"bottomup_random_affine": {"rot_factor": 20, "scale_factor": [0.8, 1.2]}},
         {"bottomup_horizontal_random_flip": {"flip_prob": 0.5}},
         {"bottomup_generate_tag_ind": {"sigma": 2.0, "max_num": M}}],
        method="bottomup", batch_size=batch_size, is_train=True, config=SETTING, seed=seed,
        num_workers=2, normalize=False, final_columns=BOTTOMUP_DEVICE_FINAL_COLUMNS)
    preprocess = build_bottomup_preprocess(
        heatmap_sizes=SETTING["heatmap_sizes"], normalize_mean=NORMALIZE_MEAN,
        normalize_std=NORMALIZE_STD, sigma=2.0)
    torch.manual_seed(seed)
    net = create_network(
        BACKBONE, "higher_hrnet_head",
        backbone_args={"branch0_s2d": True, "bn_grad_stats": "fused"},
        head_args={"with_ae_loss": (True, False)}).to(device)
    loss = create_loss(
        "ae_multi_loss", num_joints=K, num_stages=2, stage_sizes=SETTING["heatmap_sizes"],
        mse_loss_factor=[1.0, 1.0], ae_loss_factor=[0.001, 0.001],
        with_mse_loss=[True, True], with_ae_loss=[True, False])
    nwl = create_network_with_loss(net, loss, has_extra_inputs=True)
    optimizer = create_optimizer(net, "adam", learning_rate=1e-3)
    step_fn = build_train_step(nwl, optimizer, preprocess=preprocess, amp_level=amp_level)

    t0 = time.time()
    it = iter(loader)
    for ep in range(epochs):
        for _ in range(steps_per_epoch):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                batch = next(it)
            lv = step_fn(*(torch.from_numpy(np.ascontiguousarray(batch[c])).to(device)
                           for c in BOTTOMUP_DEVICE_FINAL_COLUMNS))
        if (ep + 1) % 25 == 0:
            # ae_multi_loss returns stacked per-component losses
            logging.info("seed %d epoch %d loss %.5f (%.0fs)", seed, ep + 1,
                         float(lv.mean()), time.time() - t0)
    return net


def eval_grouping(net: torch.nn.Module, data, device_grouping: bool, hflip_tta: bool = False,
                  multiscale: Sequence[float] = (1.0,), eval_batch: int = 4,
                  device: Optional[torch.device] = None, amp_level: str = "O2") -> dict:
    """The COCO stats of ``net`` on ``data["val"]``, grouped by the matcher
    (``device_grouping``) or the host Hungarian. ``amp_level`` O2 evaluates
    in bf16 autocast, as the JAX tool evaluates its bf16 net; O0 in float32."""
    device = torch.device(device) if device is not None else resolve_device(None)
    img_root, ann = data["val"]
    vds = create_dataset(img_root, ann, dataset_format="coco_bottomup", is_train=False,
                         config=SETTING)
    vloader = create_pipeline(vds, ["bottomup_rescale", "bottomup_pad"], method="bottomup",
                              batch_size=eval_batch, is_train=False, config=SETTING)
    decoder = create_decoder(
        "bottomup_heatmap_ae", num_joints=K, num_stages=2, with_ae_loss=(True, False),
        use_nms=True, nms_kernel=3, max_num=M)
    eval_net = create_eval_network(net, decoder, output_raw=True)
    cfg = {**EVAL_SETTING, "device_grouping": device_grouping, "hflip_tta": hflip_tta,
           "multiscale_tta": tuple(multiscale)}
    inferencer = create_inferencer(eval_net, name="bottomup_heatmap_ae", config=cfg,
                                   dataset_config=SETTING, device=device, amp_level=amp_level)
    with tempfile.TemporaryDirectory() as td:
        evaluator = create_evaluator(
            ann, name="bottomup", metric=["AP"], config=cfg, dataset_config=SETTING,
            result_path=os.path.join(td, "result.json"))
        return evaluator(inferencer(vloader))


def main(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--train-images", type=int, default=160)
    p.add_argument("--val-images", type=int, default=120)
    p.add_argument("--people", type=int, default=4)
    p.add_argument("--image-size", type=int, default=256,
                   help="square train/eval input size (512 = the published HigherHRNet recipe)")
    p.add_argument("--hflip-tta", action="store_true",
                   help="eval with horizontal-flip TTA (the published bottom-up recipe)")
    p.add_argument("--multiscale", default="1.0",
                   help="comma-separated eval TTA scales, e.g. 1.0,2.0")
    p.add_argument("--eval-batch", type=int, default=4)
    p.add_argument("--data-root", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="where the tool runs (default: the current CUDA device)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    apply_image_size(args.image_size)
    scales = tuple(float(s) for s in args.multiscale.split(","))

    root = args.data_root or tempfile.mkdtemp(prefix="exp_grouping_")
    data = {}
    for split, n, seed in (("train", args.train_images, 0), ("val", args.val_images, 1)):
        sroot = os.path.join(root, split)
        if not os.path.exists(os.path.join(sroot, "annotations.json")):
            generate_split(sroot, n, seed=seed, people_per_img=args.people)
        data[split] = (os.path.join(sroot, "images"), os.path.join(sroot, "annotations.json"))

    runs = []
    runs_path = (args.out + ".runs.jsonl") if args.out else ""
    done = set()
    if runs_path and os.path.exists(runs_path):
        with open(runs_path) as f:
            for ln in f:
                try:
                    rec = json.loads(ln)
                    runs.append(rec)
                    done.add(rec["seed"])
                except (json.JSONDecodeError, KeyError, TypeError):
                    pass

    for seed in [int(s) for s in args.seeds.split(",")]:
        if seed in done:
            continue
        net = train_seed(seed, data, args.epochs, args.batch_size, args.steps_per_epoch,
                         device=device)
        host = eval_grouping(net, data, device_grouping=False, hflip_tta=args.hflip_tta,
                             multiscale=scales, eval_batch=args.eval_batch, device=device)
        dev = eval_grouping(net, data, device_grouping=True, hflip_tta=args.hflip_tta,
                            multiscale=scales, eval_batch=args.eval_batch, device=device)
        rec = {"seed": seed, "AP_host": float(host["AP"]), "AP_device": float(dev["AP"]),
               "delta": float(dev["AP"] - host["AP"])}
        runs.append(rec)
        print(json.dumps(rec), flush=True)
        if runs_path:
            with open(runs_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    deltas = [abs(r["delta"]) for r in runs]
    report = {
        "protocol": {
            "train_images": args.train_images, "val_images": args.val_images,
            "people_per_img": args.people, "epochs": args.epochs,
            "steps_per_epoch": args.steps_per_epoch,
            "batch_size": args.batch_size,
            "model": "higher_hrnet_w32 %dx%d heatmaps %d+%d" % (
                args.image_size, args.image_size,
                args.image_size // 4, args.image_size // 2),
            "hflip_tta": bool(args.hflip_tta),
            "multiscale_tta": list(scales),
            "refine_missing_joint": EVAL_SETTING["refine_missing_joint"],
        },
        "runs": runs,
        "max_abs_delta": max(deltas) if deltas else None,
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        logging.info("wrote %s", args.out)
    return report


if __name__ == "__main__":
    main()
