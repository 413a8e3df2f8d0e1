"""Paired-seed accuracy ablations on the synthetic-COCO benchmark, on the GPU.

Counterpart of ``tools/ablate_accuracy.py``. A claim such as "UDP beats
plain" made from one seed per arm is noise where the seed-to-seed spread
exceeds the margin. The tool makes such claims statistical: every arm
trains under the same data order, augmentation draws and initial weights
per seed (paired control: the loader's seed and the torch seed of the
net), across several seeds, on an enlarged and more crowded val split;
it reports per-seed paired deltas and each arm's mean and spread. The
arms (``ARMS``): ``plain`` heatmaps, ``udp`` (evaluated by the UDP decoder
and again by DARK-UDP on the same checkpoint, so their delta carries no
optimiser noise), ``simcc`` and ``rle``, through the port's factories,
``create_optimizer("adamw")``, ``build_train_step`` with the device
pipeline's preprocess (normalise and target encode in the step) and bf16
autocast (the JAX tool trains a bf16 net), and the ``topdown_heatmap`` /
``simcc`` / ``regression`` inferencers and the ``topdown`` evaluator. The
heatmap arms decode through the decode kernel (``ops/cuda/decode``) on the
card. ``--det-noise`` evaluates on jittered detector-style boxes
(``make_det_json``) and ``--tta`` with the published recipe's hflip TTA.
Each finished (arm, seed) evaluation is appended to ``<out>.runs.jsonl``
at once, and a restart skips every pair whose evaluations are all there.

    python3 -m mindpose_tpu_torch.tools.ablate_accuracy --arms plain,udp --seeds 0,1,2 \\
        --epochs 150 --out docs/ablation_udp.json [--device cpu]
"""
import argparse
import json
import logging
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..data import create_dataset, create_pipeline
from ..data.device_pipeline import (
    DEVICE_FINAL_COLUMNS,
    build_topdown_preprocess,
    strip_host_target_transform,
)
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

__all__ = ["DATASET_SETTING", "EVAL_SETTING", "ARMS", "make_data", "make_det_json",
           "train_arm", "eval_checkpoint", "load_completed_runs", "summarize", "main"]

DATASET_SETTING = {
    "image_size": [192, 256],
    "heatmap_size": [48, 64],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
    "det_bbox_thr": 0.0,
    "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]],
    "upper_body_ids": list(range(11)),
}
EVAL_SETTING = {
    "has_heatmap_output": True,
    "hflip_tta": False,
    "shift_heatmap": False,
    "vis_thr": 0.2,
    "oks_thr": 0.9,
    "use_nms": True,
    "soft_nms": False,
    "sigmas": [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
               0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089,
               0.089],
}
NORMALIZE_MEAN = [0.485, 0.456, 0.406]
NORMALIZE_STD = [0.229, 0.224, 0.225]

_AUG = [
    "topdown_box_to_center_scale",
    {"topdown_horizontal_random_flip": {"flip_prob": 0.5}},
    {"topdown_halfbody_transform": {"prob_half_body": 0.3,
                                    "scale_padding": 1.5}},
    {"topdown_randomscale_rotation": {"rot_factor": 40,
                                      "scale_factor": 0.5,
                                      "rot_prob": 0.6}},
]

# arm spec: transforms, evals [(label, decoder name, decoder kwargs)], loss
# (name, kwargs); optional head/head_args override the CLI values so arms
# with different heads (simcc vs heatmap) pair under the same backbone.
# "+DARK" re-decodes the SAME checkpoint, so its delta is optimizer-noise-free.
ARMS = {
    "plain": dict(
        transforms=_AUG + ["topdown_affine",
                           {"topdown_generate_target": {"sigma": 2.0}}],
        evals=[("plain", "topdown_heatmap", {"shift_coordinate": False})],
        loss=("joint_mse", {"use_target_weight": True}),
    ),
    "udp": dict(
        transforms=_AUG + [
            {"topdown_affine": {"use_udp": True}},
            {"topdown_generate_target": {"sigma": 2.0, "use_udp": True}},
        ],
        evals=[
            ("udp", "topdown_heatmap",
             {"use_udp": True, "dark_udp_refine": False, "kernel_size": 11}),
            ("udp+dark", "topdown_heatmap",
             {"use_udp": True, "dark_udp_refine": True, "kernel_size": 11}),
        ],
        loss=("joint_mse", {"use_target_weight": True}),
    ),
    "simcc": dict(
        transforms=_AUG + [
            "topdown_affine",
            {"topdown_generate_simcc_target": {"sigma": 6.0,
                                               "split_ratio": 2.0}},
        ],
        evals=[("simcc", "simcc",
                {"input_size": [192, 256], "split_ratio": 2.0,
                 "sigma": 6.0})],
        loss=("kl_discret", {"use_target_weight": True}),
        head="simcc_head",
        head_args={"input_size": [192, 256], "split_ratio": 2.0},
    ),
    "rle": dict(
        transforms=_AUG + ["topdown_affine",
                           "topdown_generate_regression_target"],
        evals=[("rle", "regression", {"input_size": [192, 256]})],
        loss=("rle", {"use_target_weight": True}),
        head="rle_head",
        head_args={},
    ),
}


def make_data(root: str, train_images: int, val_images: int, people: int) -> dict:
    paths = {}
    for split, n, seed in (("train", train_images, 0), ("val", val_images, 1)):
        sroot = os.path.join(root, split)
        generate_split(sroot, n, seed=seed, people_per_img=people)
        paths[split] = (os.path.join(sroot, "images"),
                        os.path.join(sroot, "annotations.json"))
    return paths


def make_det_json(ann_path: str, out_path: str, seed: int = 0,
                  jitter: float = 0.08, drop: float = 0.05,
                  fp: float = 0.10) -> str:
    """Detector-box noise for eval: jittered GT boxes + false positives.

    Mirrors what real person-detector output looks like against GT (the
    published HRNet numbers are on a detector's boxes): each kept GT box gets
    center/size jitter of ~N(0, jitter) relative to its size and a
    plausible confidence; `drop` of boxes are missed; `fp` of images gain
    a random off-person false positive with low score.
    """
    rng = np.random.RandomState(seed + 12345)
    with open(ann_path) as f:
        ann = json.load(f)
    dims = {im["id"]: (im["width"], im["height"]) for im in ann["images"]}
    dets = []
    for a in ann["annotations"]:
        if rng.rand() < drop:
            continue
        x, y, w, h = a["bbox"]
        cx, cy = x + w / 2 + rng.randn() * jitter * w, \
            y + h / 2 + rng.randn() * jitter * h
        w2 = w * float(np.exp(rng.randn() * jitter))
        h2 = h * float(np.exp(rng.randn() * jitter))
        dets.append({
            "image_id": a["image_id"], "category_id": 1,
            "bbox": [float(cx - w2 / 2), float(cy - h2 / 2),
                     float(w2), float(h2)],
            "score": float(np.clip(0.88 + rng.randn() * 0.08, 0.3, 1.0)),
        })
    for im in ann["images"]:
        if rng.rand() < fp:
            w, h = dims[im["id"]]
            bw, bh = rng.uniform(0.1, 0.3) * w, rng.uniform(0.2, 0.5) * h
            dets.append({
                "image_id": im["id"], "category_id": 1,
                "bbox": [float(rng.uniform(0, w - bw)),
                         float(rng.uniform(0, h - bh)), float(bw), float(bh)],
                "score": float(np.clip(0.45 + rng.randn() * 0.1, 0.05, 0.9)),
            })
    with open(out_path, "w") as f:
        json.dump(dets, f)
    return out_path


def train_arm(arm: str, seed: int, data: dict, epochs: int, batch_size: int,
              backbone: str, head: str, pretrained_path: str = "",
              milestone_eval: Optional[Callable] = None, head_args: Optional[dict] = None,
              device: Optional[torch.device] = None, amp_level: str = "O2") -> torch.nn.Module:
    """Train ``arm`` from torch seed ``seed`` (the loader's seed too); returns the net.

    The host ships uint8 crops and raw keypoints; normalise and the target
    encode run in the step (``build_topdown_preprocess``). ``amp_level`` O2
    (bf16 autocast) stands for the JAX tool's bf16 net. ``milestone_eval(epoch,
    net)`` runs after each epoch."""
    device = torch.device(device) if device is not None else resolve_device(None)
    spec = ARMS[arm]
    head = spec.get("head", head)
    head_args = spec.get("head_args", head_args)
    transforms, target_kwargs = strip_host_target_transform(spec["transforms"])
    preprocess = build_topdown_preprocess(
        image_size=DATASET_SETTING["image_size"], heatmap_size=DATASET_SETTING["heatmap_size"],
        normalize_mean=NORMALIZE_MEAN, normalize_std=NORMALIZE_STD, **target_kwargs)
    img_root, ann = data["train"]
    ds = create_dataset(img_root, ann, dataset_format="coco_topdown", is_train=True,
                        config=DATASET_SETTING)
    loader = create_pipeline(ds, transforms, method="topdown", batch_size=batch_size,
                             is_train=True, config=DATASET_SETTING, seed=seed, normalize=False,
                             final_columns=DEVICE_FINAL_COLUMNS)

    torch.manual_seed(seed)
    net = create_network(backbone, head, head_args=head_args or {}).to(device)
    loss_name, loss_kwargs = spec["loss"]
    nwl = create_network_with_loss(net, create_loss(loss_name, **loss_kwargs),
                                   has_extra_inputs=True)
    if pretrained_path:
        from ..utils.checkpoint import load_pretrained_backbone

        load_pretrained_backbone(pretrained_path, net)
    optimizer = create_optimizer(net, "adamw", learning_rate=1e-3, weight_decay=0.05)
    step_fn = build_train_step(nwl, optimizer, preprocess=preprocess, amp_level=amp_level)

    t0 = time.perf_counter()
    lv = None
    for epoch in range(epochs):
        for batch in loader:
            lv = step_fn(*(torch.from_numpy(np.ascontiguousarray(batch[c])).to(device)
                           for c in DEVICE_FINAL_COLUMNS))
        if (epoch + 1) % 25 == 0 and lv is not None:
            logging.info("[%s seed=%d] epoch %d/%d loss=%.5f (%.0fs)", arm, seed, epoch + 1,
                         epochs, float(lv.mean()), time.perf_counter() - t0)
        if milestone_eval is not None:
            milestone_eval(epoch + 1, net)
    return net


def eval_checkpoint(net: torch.nn.Module, data: dict, decoder_kwargs: dict, tta: bool = False,
                    decoder_name: str = "topdown_heatmap", det_file: str = "",
                    device: Optional[torch.device] = None, amp_level: str = "O2") -> dict:
    """The COCO stats of ``net`` on ``data["val"]``, by the decoder given.

    ``tta``: the published eval recipe, hflip TTA with the 1-px heatmap shift
    (UDP decoders skip the shift). ``det_file``: detector-style boxes in
    place of the ground truth's. ``amp_level`` O2 evaluates in bf16 autocast,
    as the JAX tool evaluates its bf16 net; O0 in float32."""
    device = torch.device(device) if device is not None else resolve_device(None)
    img_root, ann = data["val"]
    vds = create_dataset(img_root, ann, dataset_format="coco_topdown", is_train=False,
                         config=DATASET_SETTING, use_gt_bbox_for_val=not det_file,
                         detection_file=det_file or None)
    val_transforms = [
        "topdown_box_to_center_scale",
        {"topdown_affine": {"use_udp": decoder_kwargs.get("use_udp", False)}},
    ]
    vloader = create_pipeline(vds, val_transforms, method="topdown", batch_size=32,
                              is_train=False, config=DATASET_SETTING, normalize=True)
    decoder = create_decoder(decoder_name, **decoder_kwargs)
    eval_net = create_eval_network(
        net, decoder, output_raw=(decoder_name not in ("simcc", "regression")))
    eval_setting = dict(EVAL_SETTING)
    inferencer_name = "topdown_heatmap"
    if decoder_name == "simcc":
        inferencer_name = "simcc"
        eval_setting["has_heatmap_output"] = False
    elif decoder_name == "regression":
        inferencer_name = "regression"
        eval_setting["has_heatmap_output"] = False
    if tta:
        eval_setting["hflip_tta"] = True
        eval_setting["shift_heatmap"] = (
            decoder_name not in ("simcc", "regression")
            and not decoder_kwargs.get("use_udp", False))
    inferencer = create_inferencer(eval_net, name=inferencer_name, config=eval_setting,
                                   dataset_config=DATASET_SETTING, device=device,
                                   amp_level=amp_level)
    with tempfile.TemporaryDirectory() as td:
        evaluator = create_evaluator(
            ann, name="topdown", metric=["AP"], config=EVAL_SETTING,
            dataset_config=DATASET_SETTING, result_path=os.path.join(td, "result.json"))
        return evaluator(inferencer(vloader))


def load_completed_runs(runs_path: str) -> Tuple[list, Set[Tuple[str, int]]]:
    """Crash-safe resume: read <out>.runs.jsonl -> (runs, done_pairs).

    Dedups per (arm, seed, label) keeping the LAST record — a crash between
    an arm's evals leaves stale partials that a retrain then duplicates, so
    only the latest eval of each label counts. A pair is complete only when
    every eval label of the arm is present; a truncated tail line (crash
    mid-write) is skipped and its pair simply re-runs.
    """
    prior = []
    with open(runs_path) as f:
        for ln in f:
            if not ln.strip():
                continue
            try:
                prior.append(json.loads(ln))
            except json.JSONDecodeError:
                logging.warning("skipping malformed line in %s", runs_path)
    by_key = {}
    for rec in prior:
        try:
            by_key[(rec["arm"], rec["seed"], rec["label"])] = rec
        except (KeyError, TypeError):
            logging.warning("skipping malformed record in %s: %r", runs_path, rec)
    by_pair: Dict[Tuple[str, int], list] = {}
    for (arm, seed, _), rec in by_key.items():
        by_pair.setdefault((arm, seed), []).append(rec)
    runs, done_pairs = [], set()
    for (arm, seed), recs in by_pair.items():
        if arm not in ARMS:
            continue
        want = {label for label, _, _ in ARMS[arm]["evals"]}
        if {r["label"] for r in recs} >= want:
            done_pairs.add((arm, seed))
            runs.extend(recs)
    return runs, done_pairs


def summarize(runs: list) -> dict:
    by_label: Dict[str, list] = {}
    for r in runs:
        by_label.setdefault(r["label"], []).append(r["AP"])
    summary: Dict[str, Any] = {
        label: {"mean": round(float(np.mean(v)), 4),
                "std": round(float(np.std(v)), 4),
                "n": len(v), "aps": v}
        for label, v in by_label.items()
    }
    # paired per-seed deltas vs the plain arm, the statistic that matters
    plain = {r["seed"]: r["AP"] for r in runs if r["label"] == "plain"}
    for label in by_label:
        if label == "plain" or not plain:
            continue
        deltas = [r["AP"] - plain[r["seed"]] for r in runs
                  if r["label"] == label and r["seed"] in plain]
        if deltas:
            summary[label]["paired_delta_vs_plain"] = {
                "mean": round(float(np.mean(deltas)), 4),
                "std": round(float(np.std(deltas)), 4),
                "per_seed": [round(d, 4) for d in deltas],
            }
    return summary


def main(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arms", default="plain,udp")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--train-images", type=int, default=160)
    p.add_argument("--val-images", type=int, default=240)
    p.add_argument("--people", type=int, default=3)
    p.add_argument("--backbone", default="hrnet_w32")
    p.add_argument("--head", default="hrnet_head")
    p.add_argument("--head-args", default="",
                   help='JSON, e.g. {"num_deconv_layers": 2}')
    p.add_argument("--data-root", default="",
                   help="reuse an existing generated root")
    p.add_argument("--tta", action="store_true",
                   help="eval with hflip TTA + shift heatmap (the published recipe)")
    p.add_argument("--det-noise", action="store_true",
                   help="evaluate on noisy detector-style boxes (jittered GT + false "
                        "positives, make_det_json) instead of GT boxes")
    p.add_argument("--out", default="", help="write the JSON report here")
    p.add_argument("--device", default=None,
                   help="where the tool runs (default: the current CUDA device)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    root = args.data_root or tempfile.mkdtemp(prefix="ablate_acc_")
    if not os.path.exists(os.path.join(root, "train")):
        logging.info("generating synthetic data under %s (%d train / %d val, "
                     "%d people/frame)", root, args.train_images,
                     args.val_images, args.people)
    data = make_data(root, args.train_images, args.val_images, args.people)
    det_file = ""
    if args.det_noise:
        det_file = os.path.join(root, "val", "det_noisy.json")
        if not os.path.exists(det_file):
            make_det_json(data["val"][1], det_file)

    # Crash-safe incremental persistence: each finished (arm, seed) eval is
    # appended to <out>.runs.jsonl immediately, and on restart any pair that
    # already has all its eval records is skipped.
    runs: list = []
    runs_path = (args.out + ".runs.jsonl") if args.out else ""
    done_pairs: Set[Tuple[str, int]] = set()
    if runs_path and os.path.exists(runs_path):
        runs, done_pairs = load_completed_runs(runs_path)
        if done_pairs:
            logging.info("resuming: %d completed (arm, seed) pairs found in %s",
                         len(done_pairs), runs_path)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for arm in args.arms.split(","):
            arm = arm.strip()
            if (arm, seed) in done_pairs:
                continue
            head_args = json.loads(args.head_args) if args.head_args else None
            net = train_arm(arm, seed, data, args.epochs, args.batch_size, args.backbone,
                            args.head, head_args=head_args, device=device)
            for label, dec_name, dec_kwargs in ARMS[arm]["evals"]:
                result = eval_checkpoint(net, data, dec_kwargs, tta=args.tta,
                                         decoder_name=dec_name, det_file=det_file,
                                         device=device)
                rec = {"label": label, "arm": arm, "seed": seed,
                       "AP": float(result["AP"]),
                       "AP50": float(result.get("AP .5", -1)),
                       "AR": float(result.get("AR", -1))}
                runs.append(rec)
                print(json.dumps(rec), flush=True)
                if runs_path:
                    with open(runs_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")

    report = {
        "protocol": {
            "train_images": args.train_images, "val_images": args.val_images,
            "people_per_img": args.people, "epochs": args.epochs,
            "batch_size": args.batch_size, "backbone": args.backbone,
            "tta": bool(args.tta), "det_noise": bool(args.det_noise),
            "paired": "same loader seed + init key across arms per seed",
        },
        "runs": runs,
        "summary": summarize(runs),
    }
    print(json.dumps({"summary": report["summary"]}, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        logging.info("wrote %s", args.out)
    return report


if __name__ == "__main__":
    main()
