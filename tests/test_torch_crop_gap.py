"""The AP gap between evaluation's host crop and serving's crop, port and JAX.

Evaluation crops each box on the host with cv2 (``topdown_affine``) in both
packages. Serving crops differently in the port: ``TopDownPredictor`` warps
on the device by a bilinear gather (``ops/image.affine_warp``), where the
JAX package's predictor crops with the same cv2 transform as its
evaluation. So the two packages' gaps between the two paths need not be
equal; this file measures them on the eval fixture (the reduced HRNet's
JAX TrainState, AP 0.672972 through the eval entry) and holds the port's
gap to JAX's.

The same boxes go both ways: the eval entry's records (ground-truth boxes
of tiny_coco's val split) give each box's center, scale, area and score;
the serving path replaces each record's keypoints by the predictor's for
that box (the image as the server decodes it, RGB), and the same evaluator
(the port's copy of JAX's, with its OKS NMS) scores both. JAX's evaluation
AP is the fixture record's (tests/test_torch_eval.py holds it to JAX's
eval entry).

Measured on the CPU with cv2 5.0.0 (which samples at the float coordinate;
cv2 4.13.0 rounds to 1/32 px): all four APs are 0.672972, so both gaps are
0. The port's serving keypoints equal its evaluation's in x and y (the
decode's argmax and quarter-pixel shift absorb the two crops' difference)
and their scores (the heatmap maxima) lie within 1.02e-3 of them; JAX's
serving keypoints lie within 1.6e-5 px of the port's evaluation's.
"""
from collections import defaultdict

import cv2
import numpy as np
import pytest

from mindpose_tpu.engine.predictor import TopDownPredictor as JaxPredictor
from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.utils.checkpoint import load_variables as jax_load_variables
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.data import create_dataset
from mindpose_tpu_torch.engine import create_evaluator
from mindpose_tpu_torch.engine.predictor import TopDownPredictor
from mindpose_tpu_torch.models import create_network
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.utils.checkpoint import load_net_state_dict
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import CKPT, RECORD, recording_entry, register_port_backbone
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

CONFIG = RECORD["config"]
GAP_ATOL = 0.01  # |port gap - JAX gap| in AP (measured: 0)
SCORE_ATOL = 0.01  # serving's keypoint scores against evaluation's (measured: 1.02e-3)


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    root = tmp_path_factory.mktemp("gap")
    val_root, val_label = tiny_coco.write_val(str(root / "val"))
    fixture.register_jax_backbone()
    register_port_backbone()
    args = dict(CONFIG, val_root=val_root, val_label=val_label, ckpt=CKPT,
                result_path=str(root / "result.json"))
    with recording_entry(port_eval) as seen:
        eval_stats = port_eval.evaluate(Config(**args), device="cpu")
    records = seen["outputs"][-1]

    dataset = create_dataset(val_root, val_label, dataset_format=CONFIG["dataset_format"],
                             is_train=False, use_gt_bbox_for_val=True,
                             config=CONFIG["dataset_setting"])["dataset"]
    boxes = defaultdict(dict)  # image path -> bbox id -> xywh
    for i in range(len(dataset)):
        r = dataset[i]
        boxes[str(r["image_file"])][int(r["bbox_ids"])] = np.asarray(r["boxes"], np.float32)

    net = create_network(CONFIG["backbone_name"], CONFIG["head_name"],
                         num_joints=CONFIG["num_joints"])
    net.load_state_dict(load_net_state_dict(CKPT, net), strict=True)
    predictors = {
        "port": TopDownPredictor(net, CONFIG["dataset_setting"], CONFIG["decoder_setting"],
                                 CONFIG["normalize_mean"], CONFIG["normalize_std"],
                                 device="cpu"),
        "jax": JaxPredictor(jax_create_network(CONFIG["backbone_name"], CONFIG["head_name"],
                                               num_joints=CONFIG["num_joints"]),
                            jax_load_variables(CKPT), CONFIG["dataset_setting"],
                            CONFIG["decoder_setting"], CONFIG["normalize_mean"],
                            CONFIG["normalize_std"]),
    }
    served = {}
    for name, predictor in predictors.items():
        preds = {}
        for path, by_id in boxes.items():
            image = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
            ids = sorted(by_id)
            out = predictor(image, np.stack([by_id[i] for i in ids]))
            preds.update({(path, i): np.asarray(p) for i, p in zip(ids, out)})
        outputs = [dict(r, pred=preds[(r["image_path"], r["bbox_id"])].tolist())
                   for r in records]
        evaluator = create_evaluator(
            val_label, name=CONFIG["eval_method"], metric=CONFIG["eval_metric"],
            config=CONFIG["eval_setting"], dataset_config=CONFIG["dataset_setting"],
            num_joints=CONFIG["num_joints"], result_path=str(root / f"serve_{name}.json"))
        served[name] = {"stats": evaluator(outputs), "preds": preds}
    return {"eval_port": float(eval_stats["AP"]), "eval_jax": float(RECORD["jax_stats"]["AP"]),
            "serve_port": float(served["port"]["stats"]["AP"]),
            "serve_jax": float(served["jax"]["stats"]["AP"]),
            "records": records, "served": served}


def test_port_s_serving_gap_is_jax_s_within_the_bound(measured):
    gap_port = measured["eval_port"] - measured["serve_port"]
    gap_jax = measured["eval_jax"] - measured["serve_jax"]
    assert measured["serve_port"] > 0.5 and measured["serve_jax"] > 0.5
    assert abs(gap_port - gap_jax) <= GAP_ATOL


def test_port_s_device_crop_gives_evaluation_s_keypoints(measured):
    port_preds = measured["served"]["port"]["preds"]
    for r in measured["records"]:
        got = port_preds[(r["image_path"], r["bbox_id"])]
        want = np.asarray(r["pred"])
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2], want[:, 2], atol=SCORE_ATOL, rtol=0)


def test_jax_s_serving_crops_as_its_evaluation_does(measured):
    """JAX's predictor and the port's evaluation crop with the same cv2 call:
    their keypoints agree as the port's and JAX's evaluations do."""
    jax_preds = measured["served"]["jax"]["preds"]
    for r in measured["records"]:
        got = np.asarray(r["pred"])
        want = jax_preds[(r["image_path"], r["bbox_id"])]
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-2)
