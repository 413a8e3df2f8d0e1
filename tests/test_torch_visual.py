"""The port's visualisation tools against the JAX package's, on the CPU.

Each JAX tool (``tools/visual/*.py``) runs in a subprocess with
``JAX_PLATFORMS=cpu`` (tests/fixtures/jax_visual.py, which registers the
fixtures' reduced HRNet and records the tool's predictions), and the
port's tool (``mindpose_tpu_torch/tools/visual_*.py``) here with
``--device cpu``, on tiny_coco frames with the JAX-written fixture
checkpoints (tests/fixtures/eval_checks.py):

- ground truth, top-down with hrnet_w32_tpu.yaml's train transforms and
  ``topdown_photometric_distortion``, and bottom-up with
  higher_hrnet_w32_tpu.yaml's: the images byte for byte (the train loader
  at one worker, numpy's stream seeded alike before each tool);
- top-down predictions: the decoded keypoints (heatmap frame) within the
  eval tests' tolerances (tests/test_torch_eval.py: scores within 1e-5,
  x and y within 1e-3 px where the heatmap's decode margin exceeds 1e-4);
- AE predictions with ``bottomup_resize`` (128x192 inputs, not square), the
  host Hungarian and the fixed-capacity matcher (the grouping kernel's
  plain version): the same persons, x and y within 1e-3 px, scores within
  1e-4 (tests/test_torch_bottomup_serve.py's);
- the predicted images: JPEG files of overlays, compared pixel by pixel.
  The two forwards' heatmaps differ by float32 rounding (~1e-6), which can
  move a uint8 overlay value across a rounding boundary, and JPEG spreads
  such a one-level change over its 8x8 block: at least 99% of the values
  within 2 levels and a mean difference below 0.1 levels.

The bottom-up evaluation with ``bottomup_resize`` as the val transform
goes through both eval entries, its stats within the bottom-up eval tests'
1e-3.
"""
import os
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from mindpose_tpu_torch.config import parse_args
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.tools import (
    visual_gt_heatmap,
    visual_pred_heatmap_ae,
    visual_pred_heatmap_topdown,
)
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import (
    BOTTOMUP_CKPT,
    BOTTOMUP_RECORD,
    CKPT,
    RECORD,
    decode_margin,
    register_port_backbone,
)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = 2
SEED = 11  # numpy's global stream before each GT tool
TRAIN_IMAGES = 6
SCORE_ATOL, PEAK_GAP, XY_ATOL = 1e-5, 1e-4, 1e-3  # tests/test_torch_eval.py's, O0
BU_XY_ATOL, BU_SCORE_ATOL = 1e-3, 1e-4
STATS_ATOL = 1e-3  # tests/test_torch_bottomup_eval.py's
PIXEL_LEVELS, PIXEL_SHARE, PIXEL_MEAN = 2, 0.99, 0.1  # JPEG of overlays (see the module's note)
RESIZE = [{"bottomup_resize": {"size": 128}}]


def _recipe(name):
    with open(os.path.join(ROOT, "configs", *name)) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("visual")
    train = tiny_coco.write_split(str(root / "train"), TRAIN_IMAGES, tiny_coco.TRAIN_SEED)
    val = tiny_coco.write_val(str(root / "val"))
    data = dict(train_root=train[0], train_label=train[1], val_root=val[0], val_label=val[1])
    hrnet = _recipe(("hrnet", "hrnet_w32_tpu.yaml"))
    higher = _recipe(("higher_hrnet", "higher_hrnet_w32_tpu.yaml"))
    topdown = dict(RECORD["config"], **data, train_transforms=[
        hrnet["train_transforms"][0], "topdown_photometric_distortion",
        *hrnet["train_transforms"][1:]])
    bottomup = dict(BOTTOMUP_RECORD["config"], **data, val_transforms=RESIZE,
                    train_transforms=higher["train_transforms"])
    configs = {}
    for name, cfg in (("topdown", topdown), ("bottomup", bottomup),
                      ("bottomup_matcher", dict(bottomup, eval_setting=dict(
                          bottomup["eval_setting"], device_grouping=True)))):
        configs[name] = str(root / f"{name}.yaml")
        with open(configs[name], "w") as f:
            yaml.safe_dump(cfg, f)
    register_port_backbone()
    return root, configs


def _jax_tool(tool, out_dir, argv):
    """The JAX tool in a subprocess; returns its recorded predictions."""
    record = os.path.join(out_dir, "jax_record.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "tests.fixtures.jax_visual", tool, record, str(SEED), "--",
         *argv, "--output-dir", os.path.join(out_dir, "jax")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(record, "rb") as f:
        return pickle.load(f)


def _port_tool(module, out_dir, argv, device=True):
    np.random.seed(SEED)
    return module.main([*argv, *(["--device", "cpu"] if device else []),
                        "--output-dir", os.path.join(out_dir, "port")])


def _images(out_dir, prefix):
    names = [f"{prefix}_{i}.jpg" for i in range(SAMPLES)]
    for side in ("port", "jax"):
        assert sorted(os.listdir(os.path.join(out_dir, side))) == names
    return [(os.path.join(out_dir, "port", n), os.path.join(out_dir, "jax", n)) for n in names]


def _assert_close_pixels(port_path, jax_path):
    got, want = cv2.imread(port_path), cv2.imread(jax_path)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff <= PIXEL_LEVELS).mean() >= PIXEL_SHARE, (diff <= PIXEL_LEVELS).mean()
    assert diff.mean() < PIXEL_MEAN, diff.mean()


@pytest.mark.parametrize("which", ["topdown", "bottomup"])
def test_gt_images_are_byte_equal(setup, tmp_path, which):
    _, configs = setup
    argv = ["--config", configs[which], "--num-samples", str(SAMPLES)]
    _jax_tool("visual_gt_heatmap", str(tmp_path), argv)
    written = _port_tool(visual_gt_heatmap, str(tmp_path), argv, device=False)
    pairs = _images(str(tmp_path), "gt")
    assert written == [p for p, _ in pairs]
    for port_path, jax_path in pairs:
        with open(port_path, "rb") as a, open(jax_path, "rb") as b:
            assert a.read() == b.read()
    if which == "bottomup":  # the levels' panels and the mask side by side
        h, w = cv2.imread(pairs[0][0]).shape[:2]
        assert w == 3 * h


def test_topdown_predictions_match_jax(setup, tmp_path):
    _, configs = setup
    argv = ["--config", configs["topdown"], "--ckpt", CKPT, "--num-samples", str(SAMPLES)]
    want = _jax_tool("visual_pred_heatmap_topdown", str(tmp_path), argv)
    got = _port_tool(visual_pred_heatmap_topdown, str(tmp_path), argv)
    assert len(got) == len(want) == SAMPLES
    for g, w in zip(got, want):
        preds, jax_preds = g["preds"].astype(np.float64), w["preds"].astype(np.float64)
        assert preds.shape == jax_preds.shape == (17, 3)
        heat = torch.from_numpy(np.ascontiguousarray(w["heatmap"].transpose(2, 0, 1)))[None]
        clear = decode_margin(heat)[0].numpy() > PEAK_GAP
        assert clear.mean() > 0.5
        np.testing.assert_allclose(preds[:, 2], jax_preds[:, 2], rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(preds[clear, :2], jax_preds[clear, :2], rtol=0, atol=XY_ATOL)
    for port_path, jax_path in _images(str(tmp_path), "pred"):
        _assert_close_pixels(port_path, jax_path)


@pytest.mark.parametrize("which", ["bottomup", "bottomup_matcher"])
def test_ae_predictions_match_jax_on_non_square_inputs(setup, tmp_path, which):
    _, configs = setup
    argv = ["--config", configs[which], "--ckpt", BOTTOMUP_CKPT, "--num-samples", str(SAMPLES)]
    want = _jax_tool("visual_pred_heatmap_ae", str(tmp_path), argv)
    got = _port_tool(visual_pred_heatmap_ae, str(tmp_path), argv)
    assert len(got) == len(want) == SAMPLES
    persons = 0
    for g, w in zip(got, want):
        record = g["record"]
        assert len(record["pred"]) == len(w["pred"])
        np.testing.assert_allclose(record["score"], w["score"], rtol=0, atol=BU_SCORE_ATOL)
        for p, q in zip(record["pred"], w["pred"]):
            p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
            assert p.shape == q.shape
            np.testing.assert_allclose(p[:, :2], q[:, :2], rtol=0, atol=BU_XY_ATOL)
            np.testing.assert_allclose(p[:, 2], q[:, 2], rtol=0, atol=BU_SCORE_ATOL)
            persons += 1
    assert persons > 0
    for port_path, jax_path in _images(str(tmp_path), "ae"):
        h, w = cv2.imread(port_path).shape[:2]
        assert (h, w) == (128, 192)  # bottomup_resize: sides multiples of 64, not square
        _assert_close_pixels(port_path, jax_path)


def test_tools_run_on_the_gpu_unless_asked_for_the_cpu(setup, tmp_path, monkeypatch):
    _, configs = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (visual_pred_heatmap_topdown, visual_pred_heatmap_ae):
        with pytest.raises(RuntimeError, match="--device cpu"):
            module.main(["--config", configs["topdown"], "--ckpt", CKPT,
                         "--output-dir", str(tmp_path)])


@pytest.mark.parametrize("device_grouping", [False, True])
def test_bottomup_evaluation_with_bottomup_resize_matches_jax(setup, tmp_path, device_grouping):
    """Batch 1 (no ``bottomup_pad``: the batch rule's), non-square inputs
    through the inferencer and either matcher, against JAX's eval entry."""
    root, _ = setup
    cfg = dict(BOTTOMUP_RECORD["config"], val_transforms=RESIZE,
               val_root=str(root / "val" / "images"),
               val_label=str(root / "val" / "annotations.json"),
               eval_setting=dict(BOTTOMUP_RECORD["config"]["eval_setting"],
                                 device_grouping=device_grouping))
    fixture.register_jax_backbone()
    want = fixture.jax_evaluate(cfg, BOTTOMUP_CKPT, str(tmp_path))
    timings = {}
    got = port_eval.evaluate(parse_args(
        ["--config", _write(tmp_path, cfg), "--ckpt", BOTTOMUP_CKPT,
         "--cfg-options", f"result_path={tmp_path / 'result.json'}"]), device="cpu",
        timings=timings)
    assert timings["batches"] == timings["records"] == tiny_coco.VAL_IMAGES
    assert list(got) == list(want) and len(got) == 10
    np.testing.assert_allclose([float(v) for v in got.values()],
                               [float(v) for v in want.values()], rtol=0, atol=STATS_ATOL)
    assert float(got["AP"]) > 0


def _write(tmp_path, cfg):
    path = str(tmp_path / "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path
