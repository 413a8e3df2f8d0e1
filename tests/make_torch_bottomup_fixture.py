"""Train the bottom-up evaluation fixture with the JAX package: a checkpoint and its COCO stats.

Trains the reduced HRNet of tests/make_torch_eval_fixture.py (``STAGE_CFG``,
8 channels on every branch) with a ``higher_hrnet_head`` (16 deconv
filters, 4 BasicBlocks) on ``TRAIN_IMAGES`` frames of
tests/fixtures/tiny_coco.py with the AE multi-loss and adam, on the CPU,
evaluating every ``eval_every_epochs`` epochs until the val AP (O0,
grouped by the fixed-capacity matcher, the JAX package's default on an
accelerator) is at least ``TARGET_AP`` and the matcher's groups are stable
(below), and keeps the last such checkpoint; then writes:

- tests/fixtures/tiny_higher_hrnet_bottomup.msgpack: the net's variables
  (``{"params", "batch_stats"}``, flax msgpack), under 1.5 MB;
- tests/fixtures/tiny_higher_hrnet_bottomup.json: the eval config, the data
  and training settings, and the 10 COCO stats of the JAX package's
  evaluation of that checkpoint on the val split: ``jax_stats`` (O0) for
  ``device_grouping`` true (the fixed-capacity matcher,
  ``mindpose_tpu/ops/grouping.py``) and false (the host Hungarian,
  ``mindpose_tpu/utils/match.py``), ``jax_stats_o2`` (O2, the matcher),
  and ``jax_stats_tta`` (O0, hflip and multi-scale ``[1.0, 0.5]`` TTA with
  ``refine_missing_joint``, both matchers).

Usage (about 8 minutes on 8 CPU cores: 40 epochs):

    JAX_PLATFORMS=cpu python3 tests/make_torch_bottomup_fixture.py

Stable groups: with one tag per joint (L = 1) the matcher's tie-break, the
unrounded distance, is degenerate: where the rounded costs tie, two
assignments whose candidates and group means lie on one side of each
other on the line have equal sums of |tag - mean|, and float rounding alone
picks one. So a change of the tags by a few 1e-6, as between the port's
forward and JAX's, can regroup persons whose tags the net has not
separated. The fixture is kept only when noise of ``STABLE_SIGMA`` on every
val tag (``STABLE_SEEDS`` draws) changes no image's groups. Such ties
arise where one person leaves two candidates of one joint (a peak and a
second local maximum): the NMS window of 5 leaves far fewer of them than
the recipe's 3 on this net.

The module also holds the JAX side of the evaluation,
``jax_bottomup_evaluate``: the calls ``tools/eval.py:evaluate`` makes, in
its order.
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

from mindpose_tpu.data import create_dataset, create_pipeline  # noqa: E402
from mindpose_tpu.engine import create_evaluator, create_inferencer  # noqa: E402
from mindpose_tpu.models import (  # noqa: E402
    create_decoder,
    create_eval_network,
    create_loss,
    create_network,
    create_network_with_loss,
)
from mindpose_tpu.optim import create_optimizer  # noqa: E402
from mindpose_tpu.parallel import build_train_step, create_train_state  # noqa: E402
from mindpose_tpu.utils.checkpoint import load_variables  # noqa: E402
from tests.fixtures import tiny_coco  # noqa: E402
from tests.make_torch_eval_fixture import (  # noqa: E402
    BACKBONE,
    STAGE_CFG,
    STAT_NAMES,
    register_jax_backbone,
)

FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures")
CKPT = os.path.join(FIXTURE_DIR, "tiny_higher_hrnet_bottomup.msgpack")
RECORD = os.path.join(FIXTURE_DIR, "tiny_higher_hrnet_bottomup.json")
TARGET_AP = 0.5
TRAIN_IMAGES, TRAIN_SEED = 192, 2
STABLE_SIGMA, STABLE_SEEDS = 1e-5, 4
TTA = {"hflip_tta": True, "multiscale_tta": [1.0, 0.5], "refine_missing_joint": True}

DATASET_SETTING = {
    "image_size": [128, 128],
    # square: the val batches stack (the batch rule of data_factory)
    "max_image_size": [192, 192],
    "heatmap_sizes": [[32, 32], [64, 64]],
    "sigma": 2.0,
    "expand_mask": True,
    "pixel_std": 200.0,
    "tag_per_joint": True,
    "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]],
}
# configs/higher_hrnet/higher_hrnet_w32_tpu.yaml's eval keys on the reduced
# net (val_root and val_label are where the val split is written), with an
# NMS window of 5 (the recipe's 3 leaves a second local maximum of a joint
# beside many peaks of this small net, a candidate whose choice the
# matcher's degenerate tie-break decides; see "Stable groups")
CONFIG = {
    "dataset_format": "coco_bottomup",
    "val_use_gt_bbox": None,
    "val_detection_result": None,
    "batch_size": 8,
    "num_joints": 17,
    "num_parallel_workers": 2,
    "dataset_setting": DATASET_SETTING,
    "pipeline_method": "bottomup",
    "normalize_mean": [0.485, 0.456, 0.406],
    "normalize_std": [0.229, 0.224, 0.225],
    "val_transforms": ["bottomup_rescale", "bottomup_pad"],
    "in_channels": 3,
    "backbone_name": BACKBONE,
    "backbone_setting": {},
    "neck_name": "",
    "head_name": "higher_hrnet_head",
    "head_setting": {"with_ae_loss": [True, False], "tag_per_joint": True,
                     "num_deconv_filters": [16]},
    "decoder_name": "bottomup_heatmap_ae",
    "decoder_setting": {"with_ae_loss": [True, False], "tag_per_joint": True,
                        "num_joints": 17, "num_stages": 2, "use_nms": True, "nms_kernel": 5,
                        "max_num": 30, "shift_coordinate": False},
    "amp_level": "O0",
    "inference_method": "bottomup_heatmap_ae",
    "eval_method": "bottomup",
    "eval_metric": ["AP"],
    "eval_setting": {
        "has_heatmap_output": True,
        "hflip_tta": False,
        "multiscale_tta": [1.0],
        "downsample_scale": 2,
        "vis_thr": 0.1,
        "oks_thr": 0.9,
        "tag_thr": 1.0,
        "joint_order": [0, 1, 2, 3, 4, 5, 6, 11, 12, 7, 8, 9, 10, 13, 14, 15, 16],
        "ignore_too_much": False,
        "use_rounded_norm": True,
        "use_nms": False,
        "soft_nms": False,
        "refine_missing_joint": False,
        "sharded_eval": False,
        "sigmas": [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
                   0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089],
    },
}
TRAINING = {
    "train_transforms": [
        {"bottomup_random_affine": {"rot_factor": 15, "scale_factor": [0.8, 1.2],
                                    "scale_type": "short", "trans_factor": 20}},
        {"bottomup_horizontal_random_flip": {"flip_prob": 0.5}},
        {"bottomup_generate_target": {"sigma": 2.0, "max_num": 30}},
    ],
    "loss": "ae_multi_loss",
    "loss_setting": {"num_joints": 17, "num_stages": 2, "stage_sizes": [[32, 32], [64, 64]],
                     "mse_loss_factor": [1.0, 1.0], "ae_loss_factor": [0.01, 0.01],
                     "with_mse_loss": [True, True], "with_ae_loss": [True, False],
                     "tag_per_joint": True},
    "optimizer": "adam",
    "lr": 0.002,
    "batch_size": 16,
    "seed": 0,
    "eval_every_epochs": 10,
    "max_epochs": 400,
    "max_seconds": 1500,
}


def eval_args(root: str, **eval_setting) -> dict:
    """The eval config on the val split under ``root``, its eval_setting updated."""
    val_root, val_ann = os.path.join(root, "images"), os.path.join(root, "annotations.json")
    return dict(CONFIG, val_root=val_root, val_label=val_ann,
                eval_setting=dict(CONFIG["eval_setting"], **eval_setting))


def jax_bottomup_evaluate(args: dict, ckpt: str, result_dir: str) -> dict:
    """``tools/eval.py:evaluate``'s calls, in its order, on the config ``args``
    (a dict), without its compilation cache and platform setup."""
    amp = args.get("amp_level", "O0")
    dtype = jnp.bfloat16 if amp not in ("O0", None) else jnp.float32
    dataset_val = create_dataset(
        args["val_root"], args["val_label"], dataset_format=args["dataset_format"],
        is_train=False, num_workers=args.get("num_parallel_workers", 4),
        config=args["dataset_setting"])
    loader_val = create_pipeline(
        dataset_val, transforms=args["val_transforms"], method=args["pipeline_method"],
        batch_size=args["batch_size"], is_train=False, normalize_mean=args["normalize_mean"],
        normalize_std=args["normalize_std"], num_workers=args.get("num_parallel_workers", 4),
        config=args["dataset_setting"])
    net = create_network(
        backbone_name=args["backbone_name"], head_name=args["head_name"],
        neck_name=args.get("neck_name", "") or "", in_channels=args.get("in_channels", 3),
        num_joints=args["num_joints"], backbone_args=args.get("backbone_setting"),
        head_args=args.get("head_setting"), dtype=dtype)
    w, h = args["dataset_setting"]["image_size"]
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3), jnp.float32),
                         train=False)
    variables = load_variables(ckpt, variables)
    decoder = create_decoder(args["decoder_name"], **(args.get("decoder_setting") or {}))
    eval_net = create_eval_network(
        net, decoder, output_raw=args["eval_setting"].get("has_heatmap_output", True))
    inferencer = create_inferencer(eval_net, name=args["inference_method"],
                                   config=args["eval_setting"],
                                   dataset_config=args["dataset_setting"], mesh=None)
    evaluator = create_evaluator(
        args["val_label"], name=args["eval_method"], metric=args["eval_metric"],
        config=args["eval_setting"], dataset_config=args["dataset_setting"],
        num_joints=args["num_joints"],
        result_path=os.path.join(result_dir, "result_keypoints.json"))
    return evaluator(inferencer(loader_val, variables=variables))


def unstable_images(args: dict, ckpt: str) -> int:
    """Val images whose matcher groups change when ``STABLE_SIGMA`` of noise is
    added to their tags (any of ``STABLE_SEEDS`` draws), at O0 without TTA."""
    from mindpose_tpu.ops.grouping import match_by_tag_batch

    dataset_val = create_dataset(args["val_root"], args["val_label"],
                                 dataset_format=args["dataset_format"], is_train=False,
                                 config=args["dataset_setting"])
    loader_val = create_pipeline(dataset_val, transforms=args["val_transforms"],
                                 method=args["pipeline_method"], batch_size=args["batch_size"],
                                 is_train=False, normalize_mean=args["normalize_mean"],
                                 normalize_std=args["normalize_std"],
                                 config=args["dataset_setting"])
    net = create_network(backbone_name=args["backbone_name"], head_name=args["head_name"],
                         num_joints=args["num_joints"], head_args=args.get("head_setting"))
    w, h = args["dataset_setting"]["image_size"]
    variables = load_variables(ckpt, net.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, h, w, 3)), train=False))
    eval_net = create_eval_network(net, create_decoder(args["decoder_name"],
                                                       **args["decoder_setting"]))
    forward = jax.jit(eval_net.apply)
    es = args["eval_setting"]
    kw = dict(joint_order=es["joint_order"], vis_thr=es["vis_thr"], tag_thr=es["tag_thr"],
              use_rounded_norm=es["use_rounded_norm"], ignore_too_much=es["ignore_too_much"])
    rng = np.random.RandomState(0)
    unstable = 0
    for batch in loader_val:
        val_k, tag_k, ind_k = (np.asarray(x) for x in
                               forward(variables, batch["image"], batch["mask"])[0][:3])
        groups, valid = (np.asarray(x) for x in match_by_tag_batch(val_k, tag_k, ind_k, **kw))
        changed = np.zeros(len(val_k), bool)
        for _ in range(STABLE_SEEDS):
            noisy = tag_k + rng.normal(0, STABLE_SIGMA, tag_k.shape).astype(np.float32)
            g2, v2 = (np.asarray(x) for x in match_by_tag_batch(val_k, noisy, ind_k, **kw))
            changed |= (v2 != valid).any(1) | (g2[..., :3] != groups[..., :3]).any((1, 2, 3))
        unstable += int(changed.sum())
    return unstable


def _stats(stats: dict) -> dict:
    return {name: float(stats[name]) for name in STAT_NAMES}


def _train(data_root: str):
    register_jax_backbone()
    t = TRAINING
    img_root, ann = tiny_coco.write_split(os.path.join(data_root, "train"), TRAIN_IMAGES,
                                          TRAIN_SEED)
    val = os.path.join(data_root, "val")
    tiny_coco.write_val(val)
    np.random.seed(t["seed"])
    ds = create_dataset(img_root, ann, dataset_format="coco_bottomup", is_train=True,
                        config=DATASET_SETTING)
    loader = create_pipeline(ds, t["train_transforms"], method="bottomup",
                             batch_size=t["batch_size"], is_train=True,
                             config=DATASET_SETTING, num_workers=1, seed=t["seed"])
    net = create_network(BACKBONE, "higher_hrnet_head", num_joints=17,
                         head_args=CONFIG["head_setting"])
    w, h = DATASET_SETTING["image_size"]
    variables = net.init(jax.random.PRNGKey(t["seed"]), jnp.zeros((1, h, w, 3)), train=False)
    tx = create_optimizer(variables["params"], t["optimizer"], learning_rate=t["lr"])
    state = create_train_state(variables, tx)
    step = build_train_step(create_network_with_loss(
        net, create_loss(t["loss"], **t["loss_setting"]), has_extra_inputs=True),
        tx, mesh=None, donate=False)
    start = time.perf_counter()
    best = (-1.0, None, None)  # (AP, epoch, variables bytes)
    for epoch in range(1, t["max_epochs"] + 1):
        for batch in loader:
            state, loss = step(state, jnp.asarray(batch["image"]), jnp.asarray(batch["target"]),
                               jnp.asarray(batch["mask"].astype(np.float32)),
                               jnp.asarray(batch["tag_ind"]))
        if epoch % t["eval_every_epochs"]:
            continue
        blob = serialization.to_bytes({"params": state.params, "batch_stats": state.batch_stats})
        ckpt = os.path.join(data_root, "candidate.msgpack")
        with open(ckpt, "wb") as f:
            f.write(blob)
        ap = jax_bottomup_evaluate(eval_args(val, device_grouping=True), ckpt, data_root)["AP"]
        unstable = unstable_images(eval_args(val), ckpt)
        elapsed = time.perf_counter() - start
        print(f"epoch {epoch}: loss {np.asarray(loss).tolist()}, val AP {ap:.4f}, "
              f"{unstable} of {tiny_coco.VAL_IMAGES} val images regroup under noise, "
              f"{elapsed:.0f} s", flush=True)
        if ap >= TARGET_AP and unstable == 0:
            best = (ap, epoch, blob)
            break
        if elapsed > t["max_seconds"]:
            raise RuntimeError(f"no stable checkpoint with AP >= {TARGET_AP} after {epoch} "
                               f"epochs")
    ap, epoch, blob = best
    with open(CKPT, "wb") as f:
        f.write(blob)
    runs = {}
    for key, amp, extra in (("jax_stats", "O0", {}), ("jax_stats_o2", "O2", {}),
                            ("jax_stats_tta", "O0", TTA)):
        for grouping in ((True,) if key == "jax_stats_o2" else (True, False)):
            args = dict(eval_args(val, device_grouping=grouping, **extra), amp_level=amp)
            runs.setdefault(key, {})["device_grouping" if grouping else "host"] = _stats(
                jax_bottomup_evaluate(args, CKPT, data_root))
    return epoch, runs


def main() -> None:
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_root:
        epochs, runs = _train(data_root)
    record = {
        "config": CONFIG,
        "stage_cfg": STAGE_CFG,
        "tta": TTA,
        "data": {"module": "tests/fixtures/tiny_coco.py",
                 "train_images": TRAIN_IMAGES, "train_seed": TRAIN_SEED,
                 "val_images": tiny_coco.VAL_IMAGES, "val_seed": tiny_coco.VAL_SEED},
        "training": dict(TRAINING, epochs=epochs),
        **runs,
    }
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {CKPT} ({os.path.getsize(CKPT)} B) and {RECORD}: AP "
          f"{runs['jax_stats']['device_grouping']['AP']:.4f} (matcher), "
          f"{runs['jax_stats']['host']['AP']:.4f} (host) after {epochs} epochs, "
          f"{time.perf_counter() - start:.0f} s")


if __name__ == "__main__":
    main()
