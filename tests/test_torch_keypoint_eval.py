"""MPII's keypoint evaluator in the port against the JAX package's, and every recipe's checks.

- the ``topdown_keypoint`` evaluator (PCK by bbox and PCKh, AUC, EPE, NME;
  on ``utils/keypoint_metrics.py``, pinned by tests/test_torch_host_copies.py)
  on synthetic MPII records converted by the port's ``tools/convert_mpii.py``: the
  port's metrics equal the JAX evaluator's within 1e-12, with TTA
  duplicates (the first record wins) and a record whose image has no
  labeled person (skipped), as tests/engine/test_keypoint_evaluator.py has
  them; the callback takes EPE and NME as lower-is-better;
- configs/mpii/hrnet_w32_mpii_tpu.yaml through the train, eval and serving
  entries on the CPU with the evaluation fixture's reduced HRNet: 16
  joints, the callback's PCKh and EPE equal to the eval entry's;
- every recipe under configs/ passes the train entry's checks, and the
  port's registry holds every component it names; the CrowdPose recipe
  (14 joints) evaluates with its crowd-index bands as the JAX package does.
"""
import glob
import json
import os

import numpy as np
import pytest

from mindpose_tpu.engine.factory import create_evaluator as jax_create_evaluator
from mindpose_tpu_torch.callbacks import EvalCallback
from mindpose_tpu_torch.engine import create_evaluator
from mindpose_tpu_torch.models import create_decoder, create_loss
from mindpose_tpu_torch.register import entrypoint
from mindpose_tpu_torch.tools import train as port_train
from tests.fixtures import mpii
from tests.fixtures.eval_checks import RECORD, register_port_backbone
from tests.test_torch_simcc import small_crops, train_recipe_through_the_entries
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MPII_YAML = os.path.join(ROOT, "configs", "mpii", "hrnet_w32_mpii_tpu.yaml")
CROWDPOSE_YAML = os.path.join(ROOT, "configs", "crowdpose", "hrnet_w32_crowdpose_tpu.yaml")
RECIPES = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml")))
METRICS_ATOL = 1e-12
MPII_EVAL = {"pck_thr": 0.5, "pck_norm_item": "head", "head_pair": [9, 8], "head_scale": 0.6}


# ---------------------------------------------------------------- the evaluator


@pytest.fixture(scope="module")
def mpii_split(tmp_path_factory):
    """Synthetic MPII records (3 frames of 3 persons) converted to COCO format,
    with a fourth frame that holds one person with no labeled joint."""
    root = str(tmp_path_factory.mktemp("mpii_eval"))
    _, ann_path = mpii.write_split(root, 3, 7, people=3)
    with open(ann_path) as f:
        dataset = json.load(f)
    dataset["images"].append({"id": 4, "file_name": "unlabeled.jpg", "width": 640,
                              "height": 480})
    dataset["annotations"].append({"id": 100, "image_id": 4, "category_id": 1,
                                   "bbox": [10.0, 10.0, 200.0, 200.0], "area": 4e4,
                                   "iscrowd": 0, "keypoints": [0.0] * 48, "num_keypoints": 0})
    with open(ann_path, "w") as f:
        json.dump(dataset, f)
    return ann_path, dataset


def _records(dataset, rng, noise=25.0):
    """One inference record per labeled annotation, the joints moved by
    ``noise`` px (sd), the box as the inferencer writes it."""
    id2name = {im["id"]: im["file_name"] for im in dataset["images"]}
    records = []
    for i, ann in enumerate(a for a in dataset["annotations"] if a["num_keypoints"]):
        kp = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        pred = np.concatenate([kp[:, :2] + rng.normal(0, noise, kp[:, :2].shape),
                               rng.uniform(0.1, 1.0, (len(kp), 1))], axis=1)
        x, y, w, h = ann["bbox"]
        box = np.concatenate([[x + w / 2, y + h / 2], np.array([w, h]) / 200.0, [w * h], [1.0]])
        records.append(dict(pred=pred.tolist(), box=box.tolist(),
                            image_path=id2name[ann["image_id"]], bbox_id=i))
    return records


def _both(ann_path, metric, config, records):
    kwargs = dict(name="topdown_keypoint", metric=metric, num_joints=16, config=config)
    got = create_evaluator(ann_path, **kwargs)(records)
    want = jax_create_evaluator(ann_path, **kwargs)(records)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRICS_ATOL, (k, got[k], want[k])
    return got


@pytest.mark.parametrize("config", [MPII_EVAL, {"pck_thr": 0.2}, {"auc_norm": 12.0}],
                         ids=["pckh", "pck_bbox", "auc_12px"])
def test_metrics_match_the_jax_evaluator(mpii_split, config):
    ann_path, dataset = mpii_split
    records = _records(dataset, np.random.RandomState(1))
    got = _both(ann_path, ["PCK", "AUC", "EPE", "NME"], config, records)
    assert 0.0 < got["PCK"] < 1.0 and 0.0 < got["AUC"] < 1.0 and got["EPE"] > 1.0


def test_duplicate_and_unmatched_records_match_the_jax_evaluator(mpii_split):
    """A TTA duplicate of the first record with its joints 500 px off: the first
    record wins; a record in the frame with no labeled person is skipped."""
    ann_path, dataset = mpii_split
    records = _records(dataset, np.random.RandomState(2), noise=0.0)
    dup = dict(records[0], pred=(np.asarray(records[0]["pred"]) + 500.0).tolist())
    unmatched = dict(records[1], image_path="unlabeled.jpg", bbox_id=99)
    got = _both(ann_path, ["PCK", "EPE"], MPII_EVAL, records + [dup, unmatched])
    assert got == {"PCK": 1.0, "EPE": 0.0}
    assert _both(ann_path, ["PCK", "EPE"], MPII_EVAL, [unmatched]) == {"PCK": 0.0, "EPE": 0.0}


def test_head_pair_out_of_range_and_unknown_norm_raise_as_jax(mpii_split):
    ann_path, dataset = mpii_split
    records = _records(dataset, np.random.RandomState(3))
    for create in (create_evaluator, jax_create_evaluator):
        with pytest.raises(ValueError, match="head_pair"):
            create(ann_path, name="topdown_keypoint", metric="PCK", num_joints=16,
                   config=dict(MPII_EVAL, head_pair=[16, 8]))(records)
        with pytest.raises(ValueError, match="pck_norm_item"):
            create(ann_path, name="topdown_keypoint", metric="PCK", num_joints=16,
                   config={"pck_norm_item": "torso"})


def test_callback_takes_error_metrics_as_lower_is_better(tmp_path):
    signs = {name: EvalCallback(target_metric_name=name, summary_dir=str(tmp_path))._metric_sign
             for name in ("PCK", "AUC", "EPE", "NME", "AP")}
    assert signs == {"PCK": 1.0, "AUC": 1.0, "EPE": -1.0, "NME": -1.0, "AP": 1.0}


# ------------------------------------------------------------------ the entries


def test_mpii_recipe_trains_evaluates_and_serves(tmp_path):
    """hrnet_w32_mpii_tpu.yaml as parsed (16 joints, the decode's shift on,
    ``topdown_keypoint`` with PCKh and EPE) with the fixture's reduced HRNet on
    64x64 crops (16x16 heatmaps) of synthetic MPII frames: the callback's PCKh
    and EPE equal the eval entry's; the serving entry answers 16 joints."""
    register_port_backbone()
    root = str(tmp_path)
    data = (mpii.write_split(os.path.join(root, "train"), 8, mpii.TRAIN_SEED),
            mpii.write_split(os.path.join(root, "val"), 4, mpii.VAL_SEED))
    backbone = RECORD["config"]["backbone_name"]
    result, args = train_recipe_through_the_entries(MPII_YAML, root, data, dict(
        backbone_name=backbone, dataset_setting=small_crops(MPII_YAML, (64, 64), (16, 16))))
    assert args.num_joints == 16 and args.eval_method == "topdown_keypoint"
    assert args.decoder_setting == {"shift_coordinate": True}
    metrics = result["epochs"][0]["metrics"]
    assert sorted(metrics) == ["EPE", "PCK"] and 0.0 <= metrics["PCK"] <= 1.0


# ------------------------------------------------------------------ every recipe


@pytest.mark.parametrize("recipe", RECIPES, ids=lambda p: os.path.relpath(p, ROOT))
def test_every_recipe_passes_the_train_entry_checks(recipe):
    """As parsed: the train entry reads every key and refuses none; the port's
    registry holds its backbone, head, inferencer, evaluator, dataset and
    transforms, and its decoder and loss build from their settings."""
    args = port_train.parse_train_args(["--config", recipe])
    port_train.check_config(args)
    for module, name in (("backbone", args.backbone_name), ("head", args.head_name),
                         ("inferencer", args.inference_method), ("evaluator", args.eval_method),
                         ("dataset", args.dataset_format)):
        entrypoint(module, name)
    for t in list(args.train_transforms) + list(args.val_transforms):
        entrypoint("transform", t if isinstance(t, str) else next(iter(t)))
    create_decoder(args.decoder_name, **(args.decoder_setting or {}))
    create_loss(args.loss, **(args.loss_setting or {}))


def _crowd_split(path, rng, k=14):
    """Three frames of two 14-joint persons, their crowdIndex in each band."""
    images, annotations = [], []
    for i, crowd in enumerate((0.05, 0.5, 0.9), start=1):
        images.append({"id": i, "file_name": f"{i:06d}.jpg", "width": 640, "height": 480,
                       "crowdIndex": crowd})
        for p in range(2):
            x, y, w, h = 60.0 + 280 * p, 40.0, 120.0, 300.0
            kp = np.zeros((k, 3))
            kp[:, 0] = rng.uniform(x, x + w, k)
            kp[:, 1] = rng.uniform(y, y + h, k)
            kp[:, 2] = 2
            annotations.append({"id": len(annotations) + 1, "image_id": i, "category_id": 1,
                                "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                                "keypoints": kp.ravel().tolist(), "num_keypoints": k})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person", "keypoints": [], "skeleton": []}]},
                  f)
    return images, annotations


def test_crowdpose_recipe_evaluates_its_crowd_bands_as_jax(tmp_path):
    args = port_train.parse_train_args(["--config", CROWDPOSE_YAML])
    assert args.num_joints == 14 and args.eval_setting["crowd_index_stats"]
    rng = np.random.RandomState(4)
    images, annotations = _crowd_split(str(tmp_path / "crowd.json"), rng)
    records = []
    for i, ann in enumerate(annotations):
        kp = np.asarray(ann["keypoints"]).reshape(-1, 3)
        pred = np.concatenate([kp[:, :2] + rng.normal(0, 4, (14, 2)), np.full((14, 1), 0.9)], 1)
        x, y, w, h = ann["bbox"]
        records.append(dict(pred=pred.tolist(), box=[x + w / 2, y + h / 2, w / 200, h / 200,
                                                     w * h, 1.0],
                            image_path=f"{ann['image_id']:06d}.jpg", bbox_id=i))
    stats = []
    for create, out in ((create_evaluator, "port.json"), (jax_create_evaluator, "jax.json")):
        evaluator = create(str(tmp_path / "crowd.json"), name=args.eval_method,
                           metric=args.eval_metric, config=args.eval_setting,
                           dataset_config=args.dataset_setting, num_joints=args.num_joints,
                           result_path=str(tmp_path / out))
        stats.append(evaluator(records))
    got, want = stats
    assert sorted(got) == sorted(want) and {"AP (easy)", "AP (medium)", "AP (hard)"} <= set(got)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= METRICS_ATOL, k
    assert 0 < got["AP"] <= 1
