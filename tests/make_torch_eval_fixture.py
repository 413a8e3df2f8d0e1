"""Train the evaluation fixture with the JAX package: a checkpoint and its COCO stats.

Trains a reduced HRNet with ``hrnet_head`` on the train split of
tests/fixtures/tiny_coco.py with adam, on the CPU, until its val AP is at
least ``TARGET_AP``, then writes:

- tests/fixtures/tiny_hrnet_topdown.msgpack: the full TrainState, saved with
  ``mindpose_tpu.utils.checkpoint.save_checkpoint``;
- tests/fixtures/tiny_hrnet_topdown.json: the eval config, the stage
  config, the data and training settings, and the 10 COCO stats of the JAX
  package's evaluation of that checkpoint on the val split, in float32
  (``jax_stats``, the config's O0) and in bf16 (``jax_stats_o2``, O2).

Usage (about a minute on 8 CPU cores):

    JAX_PLATFORMS=cpu python3 tests/make_torch_eval_fixture.py

The module also holds the JAX side of the fixture's evaluation, which
tests/test_torch_eval.py runs against the port's: ``register_jax_backbone``
and ``jax_evaluate``, the functions ``tools/eval.py:evaluate`` calls, in its
order.
"""
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mindpose_tpu.data import create_dataset, create_pipeline  # noqa: E402
from mindpose_tpu.engine import create_evaluator, create_inferencer  # noqa: E402
from mindpose_tpu.models import (  # noqa: E402
    create_decoder,
    create_eval_network,
    create_loss,
    create_network,
    create_network_with_loss,
)
from mindpose_tpu.models.backbones.hrnet import HRNet, _freeze_cfg  # noqa: E402
from mindpose_tpu.optim import create_optimizer  # noqa: E402
from mindpose_tpu.parallel import build_train_step, create_train_state  # noqa: E402
from mindpose_tpu.register import has_component, register  # noqa: E402
from mindpose_tpu.utils.checkpoint import load_variables, save_checkpoint  # noqa: E402
from tests.fixtures import tiny_coco  # noqa: E402

FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures")
CKPT = os.path.join(FIXTURE_DIR, "tiny_hrnet_topdown.msgpack")
RECORD = os.path.join(FIXTURE_DIR, "tiny_hrnet_topdown.json")
BACKBONE = "fixture_hrnet"
TARGET_AP = 0.5
STAT_NAMES = ["AP", "AP .5", "AP .75", "AP (M)", "AP (L)",
              "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]

# tests/test_torch_hrnet.py:CFG (every stage, module and branch, both kinds
# of fuse) at 8 channels on every branch and one block per stage-4 branch:
# the full adam TrainState (params, statistics and two moments) then stays
# under 1 MB, where CFG's would take 4.9 MB
STAGE_CFG = {
    "stage1": {"num_modules": 1, "num_branches": 1, "block": "BOTTLENECK",
               "num_blocks": [1], "num_channels": [8]},
    "stage2": {"num_modules": 1, "num_branches": 2, "block": "BASIC",
               "num_blocks": [1, 2], "num_channels": [8, 8]},
    "stage3": {"num_modules": 1, "num_branches": 3, "block": "BASIC",
               "num_blocks": [2, 1, 1], "num_channels": [8, 8, 8]},
    "stage4": {"num_modules": 2, "num_branches": 4, "block": "BASIC",
               "num_blocks": [1, 1, 1, 1], "num_channels": [8, 8, 8, 8],
               "multiscale_output": False},
}
DATASET_SETTING = {
    "image_size": [96, 128],
    "heatmap_size": [24, 32],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
    "det_bbox_thr": 0.0,
    "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]],
    "upper_body_ids": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
}
# the eval config, with the keys tools/eval.py reads (val_root and
# val_label are where the val split is written)
CONFIG = {
    "dataset_format": "coco_topdown",
    "val_use_gt_bbox": True,
    "batch_size": 16,
    "num_joints": 17,
    "num_parallel_workers": 2,
    "dataset_setting": DATASET_SETTING,
    "pipeline_method": "topdown",
    "normalize_mean": [0.485, 0.456, 0.406],
    "normalize_std": [0.229, 0.224, 0.225],
    "val_transforms": ["topdown_box_to_center_scale", "topdown_affine"],
    "in_channels": 3,
    "backbone_name": BACKBONE,
    "backbone_setting": {},
    "neck_name": "",
    "head_name": "hrnet_head",
    "head_setting": {},
    "decoder_name": "topdown_heatmap",
    "decoder_setting": {"shift_coordinate": True},
    "amp_level": "O0",
    "inference_method": "topdown_heatmap",
    "eval_method": "topdown",
    "eval_metric": ["AP"],
    "eval_setting": {
        "has_heatmap_output": True,
        "hflip_tta": False,
        "shift_heatmap": False,
        "vis_thr": 0.2,
        "oks_thr": 0.9,
        "use_nms": True,
        "soft_nms": False,
        # one device: the JAX tool's mesh over several would only pad batches
        "sharded_eval": False,
        "sigmas": [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
                   0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089],
    },
}
TRAINING = {
    "train_transforms": [
        "topdown_box_to_center_scale",
        {"topdown_horizontal_random_flip": {"flip_prob": 0.5}},
        "topdown_affine",
        {"topdown_generate_target": {"sigma": 1.5}},
    ],
    "loss": "joint_mse",
    "loss_setting": {"use_target_weight": True},
    "optimizer": "adam",
    "lr": 0.002,
    "batch_size": 32,
    "seed": 0,
    "eval_every_epochs": 10,
    "max_epochs": 200,
}


def register_jax_backbone() -> None:
    """Register the fixture's reduced HRNet in the JAX package's registry."""
    if has_component("backbone", BACKBONE):
        return

    def fixture_hrnet(pretrained=False, ckpt_url="", in_channels=3, dtype=jnp.float32, **kw):
        return HRNet(stage_cfg=_freeze_cfg(STAGE_CFG), in_channels=in_channels, dtype=dtype)

    register("backbone", extra_name=BACKBONE)(fixture_hrnet)


def jax_evaluate(args, ckpt: str, result_dir: str) -> dict:
    """``tools/eval.py:evaluate``'s calls, in its order, on the config ``args``
    (a dict), without its compilation cache and platform setup."""
    amp = args.get("amp_level", "O0")
    dtype = jnp.bfloat16 if amp not in ("O0", None) else jnp.float32
    dataset_val = create_dataset(
        args["val_root"], args["val_label"], dataset_format=args["dataset_format"],
        is_train=False, use_gt_bbox_for_val=args.get("val_use_gt_bbox", True),
        detection_file=args.get("val_detection_result"),
        num_workers=args.get("num_parallel_workers", 4), config=args["dataset_setting"])
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


def _train(data_root: str):
    register_jax_backbone()
    t = TRAINING
    img_root, ann = tiny_coco.write_split(os.path.join(data_root, "train"),
                                          tiny_coco.TRAIN_IMAGES, tiny_coco.TRAIN_SEED)
    val_root, val_ann = tiny_coco.write_val(os.path.join(data_root, "val"))
    args = dict(CONFIG, val_root=val_root, val_label=val_ann)
    np.random.seed(t["seed"])
    ds = create_dataset(img_root, ann, dataset_format="coco_topdown", is_train=True,
                        config=DATASET_SETTING)
    loader = create_pipeline(ds, t["train_transforms"], method="topdown",
                             batch_size=t["batch_size"], is_train=True,
                             config=DATASET_SETTING, num_workers=1, seed=t["seed"])
    net = create_network(BACKBONE, "hrnet_head", num_joints=17)
    w, h = DATASET_SETTING["image_size"]
    variables = net.init(jax.random.PRNGKey(t["seed"]), jnp.zeros((1, h, w, 3)), train=False)
    tx = create_optimizer(variables["params"], t["optimizer"], learning_rate=t["lr"])
    state = create_train_state(variables, tx)
    step = build_train_step(create_network_with_loss(
        net, create_loss(t["loss"], **t["loss_setting"]), has_extra_inputs=True),
        tx, mesh=None, donate=False)
    for epoch in range(1, t["max_epochs"] + 1):
        for batch in loader:
            state, loss = step(state, jnp.asarray(batch["image"]),
                               jnp.asarray(batch["target"]), jnp.asarray(batch["target_weight"]))
        if epoch % t["eval_every_epochs"]:
            continue
        save_checkpoint(CKPT, state)
        stats = jax_evaluate(args, CKPT, data_root)
        print(f"epoch {epoch}: loss {float(jnp.sum(loss)):.6g}, val AP {stats['AP']:.4f}",
              flush=True)
        if stats["AP"] >= TARGET_AP:
            return epoch, stats, jax_evaluate(dict(args, amp_level="O2"), CKPT, data_root)
    raise RuntimeError(f"val AP stayed below {TARGET_AP} after {t['max_epochs']} epochs")


def main() -> None:
    with tempfile.TemporaryDirectory() as data_root:
        epochs, stats, stats_o2 = _train(data_root)
    record = {
        "config": CONFIG,
        "stage_cfg": STAGE_CFG,
        "data": {"module": "tests/fixtures/tiny_coco.py",
                 "train_images": tiny_coco.TRAIN_IMAGES, "train_seed": tiny_coco.TRAIN_SEED,
                 "val_images": tiny_coco.VAL_IMAGES, "val_seed": tiny_coco.VAL_SEED},
        "training": dict(TRAINING, epochs=epochs),
        "jax_stats": {name: float(stats[name]) for name in STAT_NAMES},
        "jax_stats_o2": {name: float(stats_o2[name]) for name in STAT_NAMES},
    }
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {CKPT} ({os.path.getsize(CKPT)} B) and {RECORD}: AP {stats['AP']:.4f} "
          f"(O2: {stats_o2['AP']:.4f}) after {epochs} epochs")


if __name__ == "__main__":
    main()
