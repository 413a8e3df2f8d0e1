"""``device_pipeline: full`` in the port against the JAX package and the host pipeline, on the CPU.

In full mode the host stops at the decode: ``topdown_affine_matrix`` ships
each record's uint8 source patch (``crop_source_patch``) with its warp
matrix, a deferred flip folded in, the loader pads a batch's patches to
``image_bucket``, and the step warps, normalizes and renders the targets
(``data/device_pipeline.build_topdown_full_preprocess``).

- The loader's full-mode batch (patches, matrices, keypoints) equals the
  JAX loader's bit for bit.
- On that batch the port's preprocess gives JAX's crops within
  ``CROP_ATOL`` on the 0-255 scale, and JAX's targets within 1e-5, for
  heatmap, UDP, SimCC and regression targets. The crops differ because XLA
  fuses each sample coordinate's multiply-adds: a few float32 ulps of a
  coordinate below 512 px (3.1e-5 px each), times a step of at most 255
  between neighbouring pixels, is below 0.05 (0.0116 measured).
- Against the host pipeline (cv2 crop, host Gaussian) the crops agree
  within 1.0 intensity (cv2's fixed-point interpolation and its rounding
  to uint8) and the targets within 1e-5, as tests/data/test_device_pipeline_full.py
  holds JAX's.
- A warp of the source patch with the rebased matrix equals the warp of the
  whole frame within 2e-2 (tests/data/test_crop_source_patch.py's fuzz:
  rotations, flips, boxes off the frame), and the port's patch and matrix
  are the JAX transform's bit for bit.
- ``tools/train.train`` trains the fixture's reduced HRNet in full mode for
  two epochs with the decode cache, frame-grouped shuffling and
  patch-grouped batching: finite, falling losses, an evaluation, and with
  ``profile: true`` one trace whose steps are epoch 2's only. Bottom-up
  takes a full ``device_pipeline`` as the bottom-up device encode.
"""
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.data import device_pipeline as jax_device_pipeline
from mindpose_tpu.data.transform.topdown_transform import (
    TopDownAffineMatrix as JaxTopDownAffineMatrix,
)
from mindpose_tpu.data.transform.utils import get_affine_transform
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.data import device_pipeline
from mindpose_tpu_torch.data.transform.topdown_transform import TopDownAffineMatrix
from mindpose_tpu_torch.ops.image import affine_warp
from mindpose_tpu_torch.tools import train as port_train
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import RECORD, register_port_backbone
from tests.helpers import make_tiny_coco
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "hrnet", "hrnet_w32_tpu.yaml")
SETTING = {
    "image_size": [64, 64],
    "heatmap_size": [16, 16],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
    "det_bbox_thr": 0.0,
    "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]],
    "upper_body_ids": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
}
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
HOST_TRANSFORMS = [
    "topdown_box_to_center_scale",
    {"topdown_horizontal_random_flip": {"flip_prob": 1.0}},  # deterministic
    "topdown_affine",
    {"topdown_generate_target": {"sigma": 1.5}},
]
CROP_ATOL = 0.05  # port against JAX, 0-255 scale (see the module's docstring)
HOST_ATOL = 1.0  # against cv2's crop, 0-255 scale
TARGET_ATOL = 1e-5
TRAIN_IMAGES = 16  # 32 records: 2 steps an epoch at batch 16
TARGETS = {
    "heatmap": {},
    "udp": {"use_udp": True},
    "simcc": {"target_type": "simcc", "sigma": 2.0},
    "regression": {"target_type": "regression"},
}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return make_tiny_coco(str(tmp_path_factory.mktemp("coco_full")), num_images=4,
                          people_per_img=2)


def _full_batch(fixture, create_ds, create_pl, dp):
    """The first full-mode batch of the val split (a deterministic flip)."""
    img_root, ann = fixture
    transforms, target_kwargs = dp.strip_host_target_transform(HOST_TRANSFORMS)
    ds = create_ds(img_root, ann, dataset_format="coco_topdown", is_train=False,
                   config=SETTING, use_gt_bbox_for_val=True)
    loader = create_pl(ds, dp.to_matrix_transforms(transforms), method="topdown", batch_size=8,
                       is_train=False, normalize=False, config=SETTING,
                       final_columns=dp.DEVICE_FULL_FINAL_COLUMNS + ["bbox_ids"],
                       image_bucket=64)
    return next(iter(loader)), target_kwargs


@pytest.fixture(scope="module")
def batches(fixture):
    port, target_kwargs = _full_batch(fixture, create_dataset, create_pipeline, device_pipeline)
    jax, _ = _full_batch(fixture, jax_create_dataset, jax_create_pipeline, jax_device_pipeline)
    return port, jax, target_kwargs


def _preprocess(builder, target_kwargs, target):
    kwargs = dict(target_kwargs, **TARGETS[target])
    if "target_type" in kwargs:
        kwargs.pop("use_udp", None)
    return builder(image_size=SETTING["image_size"], heatmap_size=SETTING["heatmap_size"],
                   normalize_mean=MEAN, normalize_std=STD, **kwargs)


def _port_outputs(batch, preprocess):
    crops, target, weight = preprocess(*(torch.from_numpy(batch[c]) for c in
                                         device_pipeline.DEVICE_FULL_FINAL_COLUMNS))
    crops = crops.permute(0, 2, 3, 1).numpy()  # NCHW -> NHWC
    target = target.numpy()
    if target.ndim == 4:  # heatmaps [N, K, h, w] -> [N, h, w, K]
        target = target.transpose(0, 2, 3, 1)
    return crops, target, weight.numpy()


def _unnormalize(crops):
    return crops * (np.asarray(STD) * 255.0) + np.asarray(MEAN) * 255.0


def test_full_mode_batch_equals_jax_s(batches):
    port, jax, _ = batches
    assert list(port) == list(jax) == device_pipeline.DEVICE_FULL_FINAL_COLUMNS + ["bbox_ids"]
    for col in jax:
        assert port[col].dtype == jax[col].dtype and port[col].shape == jax[col].shape, col
        np.testing.assert_array_equal(port[col], jax[col], err_msg=col)
    n, bh, bw, _ = port["image"].shape
    assert n == 8 and bh % 64 == 0 and bw % 64 == 0 and port["image"].dtype == np.uint8


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_full_preprocess_matches_jax(batches, target):
    port, _, target_kwargs = batches
    crops, got_target, got_weight = _port_outputs(
        port, _preprocess(device_pipeline.build_topdown_full_preprocess, target_kwargs, target))
    want = [np.asarray(v) for v in _preprocess(
        jax_device_pipeline.build_topdown_full_preprocess, target_kwargs, target)(
        *(jnp.asarray(port[c]) for c in jax_device_pipeline.DEVICE_FULL_FINAL_COLUMNS))]
    assert crops.shape == want[0].shape == (8, 64, 64, 3)
    diff = np.abs(_unnormalize(crops) - _unnormalize(want[0]))
    assert diff.max() <= CROP_ATOL, diff.max()
    assert got_target.shape == want[1].shape and got_weight.shape == want[2].shape
    np.testing.assert_allclose(got_target, want[1], rtol=0, atol=TARGET_ATOL)
    np.testing.assert_allclose(got_weight, want[2], rtol=0, atol=TARGET_ATOL)


def test_full_preprocess_matches_the_host_pipeline(fixture, batches):
    port, _, target_kwargs = batches
    img_root, ann = fixture
    ds = create_dataset(img_root, ann, dataset_format="coco_topdown", is_train=False,
                        config=SETTING, use_gt_bbox_for_val=True)
    host = next(iter(create_pipeline(
        ds, HOST_TRANSFORMS, method="topdown", batch_size=8, is_train=False, normalize=False,
        config=SETTING, final_columns=["image", "keypoints", "target", "target_weight",
                                       "bbox_ids"])))
    np.testing.assert_array_equal(host["bbox_ids"], port["bbox_ids"])
    np.testing.assert_allclose(host["keypoints"], port["keypoints"], atol=1e-4)
    crops, target, weight = _port_outputs(
        port, _preprocess(device_pipeline.build_topdown_full_preprocess, target_kwargs,
                          "heatmap"))
    diff = np.abs(_unnormalize(crops) - host["image"].astype(np.float32))
    assert diff.max() <= HOST_ATOL + 1e-3, diff.max()
    np.testing.assert_allclose(target, host["target"], rtol=0, atol=TARGET_ATOL)
    np.testing.assert_allclose(weight, host["target_weight"], rtol=0, atol=1e-6)


def _warp(image, mat, out_hw):
    return affine_warp(torch.from_numpy(image[None]),
                       torch.from_numpy(np.asarray(mat, np.float32)[None]), out_hw)[0].numpy()


def test_patch_warp_equals_frame_warp_fuzz():
    """Random center, scale and rotation, boxes hanging off the frame: the
    patch's warp is the frame's, and the patch and matrix are JAX's."""
    rng = np.random.RandomState(7)
    ow, oh = 96, 128
    config = dict(SETTING, image_size=[ow, oh])
    tf = TopDownAffineMatrix(is_train=False, config=config)
    jax_tf = JaxTopDownAffineMatrix(is_train=False, config=config)
    for case in range(40):
        h, w = int(rng.randint(100, 400)), int(rng.randint(100, 400))
        frame = rng.randint(0, 255, size=(h, w, 3)).astype(np.uint8)
        center = np.array([rng.uniform(-20, w + 20), rng.uniform(-20, h + 20)], np.float32)
        scale = np.array([rng.uniform(0.3, 2.0), rng.uniform(0.4, 2.7)], np.float32)
        rot = float(rng.uniform(-60, 60)) if case % 2 else 0.0
        trans = get_affine_transform(center, scale, rot, np.array([ow, oh]), pixel_std=200.0)
        want = _warp(frame, trans, (oh, ow))
        patch, trans2 = tf._crop_to_patch(frame, trans)
        jax_patch, jax_trans2 = jax_tf._crop_to_patch(frame, trans)
        np.testing.assert_array_equal(patch, jax_patch)
        np.testing.assert_array_equal(trans2, jax_trans2)
        got = _warp(patch, trans2, (oh, ow))
        assert patch.shape[0] <= h and patch.shape[1] <= w
        np.testing.assert_allclose(got, want, atol=2e-2, err_msg=f"case {case} rot={rot:.1f}")


# --- the train entry in full mode

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_coco_full"))
    register_port_backbone()
    return (tiny_coco.write_split(os.path.join(root, "train"), TRAIN_IMAGES, tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))


def _args(root, data, **extra):
    (train_root, train_label), (val_root, val_label) = data
    cfg = RECORD["config"]
    options = dict(train_root=train_root, train_label=train_label, val_root=val_root,
                   val_label=val_label, backbone_name=cfg["backbone_name"],
                   dataset_setting=cfg["dataset_setting"], batch_size=16, num_epochs=2,
                   warmup=3, val_interval=2, amp_level="O0", num_parallel_workers=2,
                   ckpt_save_dir=os.path.join(root, "ckpt"))
    options.update(extra)
    return port_train.parse_train_args(
        ["--config", RECIPE, "--device", "cpu", "--seed", "0", "--cfg-options",
         *(f"{k}={v!r}" if not isinstance(v, str) else f"{k}={v}" for k, v in options.items())])


def test_train_entry_full_mode_with_profile(data, tmp_path):
    profile_dir = str(tmp_path / "trace")
    got = port_train.train(_args(str(tmp_path), data, device_pipeline="full", profile=True,
                                 profile_dir=profile_dir, decode_cache_mb=64,
                                 frame_grouped_shuffle=True, patch_grouped_batching=True,
                                 num_parallel_workers=1))  # one worker: exact cache counts
    epochs = got["epochs"]
    losses = [e["loss"] for e in epochs]
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses
    assert [e["steps"] for e in epochs] == [2, 2] and got["step"] == 4
    assert epochs[0]["metrics"] == {} and float(epochs[1]["metrics"]["AP"]) >= 0
    # uint8 patches of a 64-bucket, float32 matrices and keypoints
    assert all(e["batch_bytes"] >= 2 * 16 * (64 * 64 * 3 + 4 * (6 + 17 * 3)) for e in epochs)
    cache = got["decode_cache"]
    records = 2 * TRAIN_IMAGES  # 2 persons a frame: each frame decoded once in 2 epochs
    assert cache["misses"] == TRAIN_IMAGES and cache["hits"] == 2 * records - TRAIN_IMAGES
    (trace_file,) = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({e["name"] for e in events if e.get("name", "").startswith("train step ")})
    assert steps == [f"train step {s}" for s in range(2, 4)]  # epoch 2's steps only


def test_bottomup_takes_full_as_the_device_encode(data, tmp_path, monkeypatch):
    """A full ``device_pipeline`` on a bottom-up config is the bottom-up device
    encode, as the JAX entry's truthy check makes it (tools/train.py:135)."""
    called = []

    def swap(transforms):
        called.append(transforms)
        raise RuntimeError("bottom-up device encode")

    monkeypatch.setattr(port_train, "swap_bottomup_target_transform", swap)
    args = _args(str(tmp_path), data, device_pipeline="full", pipeline_method="bottomup")
    with pytest.raises(RuntimeError, match="bottom-up device encode"):
        port_train.train(args)
    assert called == [args.train_transforms]


def test_profiler_traces_only_when_enabled(tmp_path):
    """``trace`` writes one Chrome trace holding the block's annotated
    regions; disabled, or without a directory, it writes nothing."""
    from mindpose_tpu_torch.utils.profiler import StepTraceContext, annotate, trace

    x = torch.ones(4, 4)
    with trace(str(tmp_path / "off"), enabled=False), annotate("not traced"):
        x = x @ x
    with trace(None), annotate("not traced"):
        x = x @ x
    with trace(str(tmp_path / "on"), device=torch.device("cpu")):
        with StepTraceContext("train", 7), annotate("decode"):
            x = x @ x
    assert not (tmp_path / "off").exists()
    (trace_file,) = glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
    with open(trace_file) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train step 7", "decode", "aten::mm"} <= names and "not traced" not in names
