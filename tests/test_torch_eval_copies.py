"""The port's copies of the JAX package's evaluation host code stay equal to them.

``COCO``, ``COCOeval``, ``oks_iou``/``oks_nms``/``soft_oks_nms``, the
top-down evaluator, the ``coco_topdown`` dataset and the val loader are
copies (the port cannot import the JAX package). On the same inputs
(tests/helpers.py:make_tiny_coco with make_detection_json, random
predictions, and tests/cocofixtures.py's realistic eval fixture) each gives
its original's output bit for bit, with the original's C++ OKS path off;
with it on, the COCO stats agree to 1e-9.
"""
import json
import logging
import os
import threading
import time

import numpy as np
import pytest

from mindpose_tpu.config import parse_args as jax_parse_args
from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.engine import create_evaluator as jax_create_evaluator
from mindpose_tpu.utils import native
from mindpose_tpu.utils.coco import COCO as JaxCOCO
from mindpose_tpu.utils.coco import image_id_name_maps as jax_image_id_name_maps
from mindpose_tpu.utils.cocoeval import COCOeval as JaxCOCOeval
from mindpose_tpu.utils.nms import oks_iou as jax_oks_iou
from mindpose_tpu.utils.nms import oks_nms as jax_oks_nms
from mindpose_tpu.utils.nms import soft_oks_nms as jax_soft_oks_nms
from mindpose_tpu_torch.config import parse_args
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.engine import create_evaluator
from mindpose_tpu_torch.engine.factory import _merged
from mindpose_tpu_torch.utils.coco import COCO, image_id_name_maps
from mindpose_tpu_torch.utils.cocoeval import COCOeval
from mindpose_tpu_torch.utils.nms import oks_iou, oks_nms, soft_oks_nms
from tests.cocofixtures import make_realistic_eval_fixture
from tests.helpers import DATASET_SETTING, make_detection_json, make_tiny_coco
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_SETTING = {
    "has_heatmap_output": True, "hflip_tta": False, "shift_heatmap": False,
    "vis_thr": 0.2, "oks_thr": 0.9, "use_nms": True, "soft_nms": False,
    "sigmas": [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
               0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089],
}
VAL_TRANSFORMS = ["topdown_box_to_center_scale", "topdown_affine"]


@pytest.fixture
def numpy_only():
    """The JAX package's COCOeval and NMS on their numpy path, restored after."""
    native.set_native_enabled(False)
    yield
    native.set_native_enabled(True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(image_root, annotation_path, detection_path) of make_tiny_coco."""
    root = str(tmp_path_factory.mktemp("tiny_coco"))
    img_root, ann = make_tiny_coco(root, num_images=4, people_per_img=2)
    det, _ = make_detection_json(ann, os.path.join(root, "dets.json"))
    return img_root, ann, det


def _predictions(ann_path, seed=0, noise=6.0):
    """Keypoint results near each GT person plus a few false positives, with
    random joint and instance scores."""
    rng = np.random.RandomState(seed)
    with open(ann_path) as f:
        gt = json.load(f)
    results = []
    for a in gt["annotations"]:
        kp = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
        kp[:, :2] += rng.randn(len(kp), 2) * noise
        kp[:, 2] = rng.uniform(0.1, 1.0, len(kp))
        results.append({"image_id": a["image_id"], "category_id": 1,
                        "keypoints": kp.ravel().tolist(), "score": float(rng.uniform(0.3, 1))})
        if rng.rand() < 0.5:
            fp = kp.copy()
            fp[:, :2] += rng.uniform(-80, 80, 2)
            results.append({"image_id": a["image_id"], "category_id": 1,
                            "keypoints": fp.ravel().tolist(),
                            "score": round(float(rng.uniform(0.1, 0.6)), 1)})
    return results


def _coco_stats(coco_cls, eval_cls, gt, results, sigmas=None):
    coco = coco_cls(gt)
    ev = eval_cls(coco, coco.loadRes(results), "keypoints")
    if sigmas is not None:
        ev.params.kpt_oks_sigmas = np.asarray(sigmas)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev


def test_coco_index_and_queries(tiny):
    _, ann, _ = tiny
    port, jax_coco = COCO(ann), JaxCOCO(ann)
    for attr in ("dataset", "anns", "imgs", "cats", "imgToAnns", "catToImgs"):
        assert getattr(port, attr) == getattr(jax_coco, attr), attr
    assert image_id_name_maps(port.imgs) == jax_image_id_name_maps(jax_coco.imgs)
    queries = [{}, {"imgIds": 2}, {"imgIds": [1, 3], "catIds": 1}, {"iscrowd": False},
               {"areaRng": [0, 1e5]}, {"catIds": [2]}]
    for q in queries:
        assert port.getAnnIds(**q) == jax_coco.getAnnIds(**q), q
    assert port.getImgIds() == jax_coco.getImgIds()
    assert port.getImgIds(catIds=[1]) == jax_coco.getImgIds(catIds=[1])
    assert port.getCatIds(catNms=["person"]) == jax_coco.getCatIds(catNms=["person"])
    assert port.loadCats(port.getCatIds()) == jax_coco.loadCats(jax_coco.getCatIds())
    results = _predictions(ann)
    assert port.loadRes(results).dataset == jax_coco.loadRes(results).dataset


@pytest.mark.parametrize("source", ["tiny", "realistic"])
def test_cocoeval_bitwise_on_the_numpy_path(tiny, numpy_only, source):
    if source == "tiny":
        with open(tiny[1]) as f:
            gt = json.load(f)
        results, sigmas = _predictions(tiny[1]), EVAL_SETTING["sigmas"]
    else:
        gt, results = make_realistic_eval_fixture(num_images=12, seed=3)
        sigmas = None
    port = _coco_stats(COCO, COCOeval, gt, results, sigmas)
    want = _coco_stats(JaxCOCO, JaxCOCOeval, gt, results, sigmas)
    np.testing.assert_array_equal(port.stats, want.stats)
    for key in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(port.eval[key], want.eval[key])
    assert port.stats[0] > 0


def test_cocoeval_against_the_native_path():
    """The JAX package with its C++ OKS path on: the stats agree to 1e-9."""
    gt, results = make_realistic_eval_fixture(num_images=12, seed=4)
    port = _coco_stats(COCO, COCOeval, gt, results)
    want = _coco_stats(JaxCOCO, JaxCOCOeval, gt, results)
    np.testing.assert_allclose(port.stats, want.stats, rtol=0, atol=1e-9)


def test_ground_truth_as_predictions_gives_ap_one(tiny):
    with open(tiny[1]) as f:
        gt = json.load(f)
    results = [{"image_id": a["image_id"], "category_id": 1, "keypoints": a["keypoints"],
                "score": 1.0} for a in gt["annotations"]]
    stats = _coco_stats(COCO, COCOeval, gt, results, EVAL_SETTING["sigmas"]).stats
    assert stats[0] == 1.0 and stats[5] == 1.0


def test_oks_nms_and_soft_nms_bitwise(numpy_only):
    rng = np.random.RandomState(5)
    for trial in range(20):
        n = rng.randint(1, 12)
        base = rng.uniform(0, 300, (1, 17, 2))
        kpts = np.concatenate([base + rng.randn(n, 17, 2) * rng.uniform(1, 40),
                               rng.uniform(0, 1, (n, 17, 1))], axis=-1)
        db = [{"keypoints": k, "score": float(s), "area": float(a)}
              for k, s, a in zip(kpts, rng.uniform(0, 1, n), rng.uniform(500, 20000, n))]
        sigmas = np.asarray(EVAL_SETTING["sigmas"]) if trial % 2 else None
        vis_thr = 0.2 if trial % 3 == 0 else None
        flat = kpts.reshape(n, -1)
        np.testing.assert_array_equal(
            oks_iou(flat[0], flat[1:], 900.0, np.full(n - 1, 800.0), sigmas, vis_thr),
            jax_oks_iou(flat[0], flat[1:], 900.0, np.full(n - 1, 800.0), sigmas, vis_thr))
        for thr in (0.3, 0.9):
            np.testing.assert_array_equal(oks_nms(db, thr, sigmas, vis_thr),
                                          jax_oks_nms(db, thr, sigmas, vis_thr))
            np.testing.assert_array_equal(soft_oks_nms(db, thr, 5, sigmas, vis_thr),
                                          jax_soft_oks_nms(db, thr, 5, sigmas, vis_thr))
    assert oks_nms([], 0.9) == jax_oks_nms([], 0.9) == []


def _records(ann_path, seed):
    """Inferencer-style records for every GT box, with a duplicate bbox_id."""
    rng = np.random.RandomState(seed)
    coco = JaxCOCO(ann_path)
    records = []
    for img_id in coco.getImgIds():
        name = coco.imgs[img_id]["file_name"]
        for slot, a in enumerate(coco.loadAnns(coco.getAnnIds(imgIds=img_id))):
            kp = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
            kp[:, :2] += rng.randn(len(kp), 2) * 5
            kp[:, 2] = rng.uniform(0, 1, len(kp))
            x, y, w, h = a["bbox"]
            box = [x + w / 2, y + h / 2, w / 200 * 1.25, h / 200 * 1.25, w * h * 1.5,
                   float(rng.uniform(0.5, 1))]
            records.append({"pred": kp.tolist(), "box": box,
                            "image_path": os.path.join("images", name), "bbox_id": slot})
    records.append(dict(records[0], box=[0, 0, 1, 1, 1, 0.01]))  # a duplicate: dropped
    return records


@pytest.mark.parametrize("setting", [{}, {"use_nms": False}, {"soft_nms": True},
                                     {"vis_thr": 0.6, "crowd_index_stats": True}])
def test_topdown_evaluator_bitwise(tiny, tmp_path, numpy_only, setting):
    ann = tiny[1]
    config = dict(EVAL_SETTING, **setting)
    records = _records(ann, seed=7)
    port = create_evaluator(ann, name="topdown", metric=["AP"], config=config,
                            result_path=str(tmp_path / "port.json"), remove_result_file=False)
    want = jax_create_evaluator(ann, name="topdown", metric=["AP"], config=config,
                                result_path=str(tmp_path / "jax.json"),
                                remove_result_file=False)
    got, expected = port(records), want(records)
    assert list(got) == list(expected)
    np.testing.assert_array_equal(list(got.values()), list(expected.values()))
    with open(tmp_path / "port.json") as a, open(tmp_path / "jax.json") as b:
        assert a.read() == b.read()
    with pytest.raises(KeyError, match="not supported"):
        create_evaluator(ann, metric="PCK", config=config)


@pytest.mark.parametrize("detections", [False, True], ids=["gt boxes", "detector boxes"])
def test_val_loader_batches_bitwise(tiny, detections):
    img_root, ann, det = tiny
    setting = dict(DATASET_SETTING, det_bbox_thr=0.1)
    kwargs = dict(is_train=False, config=setting, use_gt_bbox_for_val=not detections,
                  detection_file=det if detections else None)
    port_ds = create_dataset(img_root, ann, dataset_format="coco_topdown", **kwargs)
    jax_ds = jax_create_dataset(img_root, ann, dataset_format="coco_topdown", **kwargs)
    assert len(port_ds["dataset"]) == len(jax_ds["dataset"]) == (12 if detections else 8)
    for i in range(len(jax_ds["dataset"])):
        got, want = port_ds["dataset"][i], jax_ds["dataset"][i]
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype

    port_batches = list(create_pipeline(port_ds, VAL_TRANSFORMS, batch_size=5, is_train=False,
                                        config=setting, num_workers=3))
    jax_batches = list(jax_create_pipeline(jax_ds, VAL_TRANSFORMS, batch_size=5, is_train=False,
                                           config=setting))
    assert len(port_batches) == len(jax_batches) == (3 if detections else 2)
    for got, want in zip(port_batches, jax_batches):
        assert list(got) == list(want)
        for col in want:
            assert got[col].dtype == want[col].dtype and got[col].shape == want[col].shape, col
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)


class _MissingImage:
    """A record dataset whose record ``bad`` names an image that does not exist."""

    def __init__(self, dataset, bad):
        self.dataset, self.bad = dataset, bad

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        state = self.dataset[idx]
        return dict(state, image_file="missing.png") if idx == self.bad else state


def test_val_loader_prefetches_and_stops(tiny):
    """While the caller holds batch 0, the producer makes batches 1 and 2 (the
    queue's 2) and batch 3, which waits to be queued, and no more; a pass
    the caller abandons stops its producer; a record that fails to load
    raises in the caller."""
    img_root, ann, _ = tiny
    ds = create_dataset(img_root, ann, is_train=False, config=DATASET_SETTING,
                        use_gt_bbox_for_val=True)
    loader = create_pipeline(ds, VAL_TRANSFORMS, batch_size=1, is_train=False,
                             config=DATASET_SETTING)
    made, process_one = [], loader._process_one
    loader._process_one = lambda idx: made.append(idx) or process_one(idx)
    before = set(threading.enumerate())
    batches = iter(loader)
    assert next(batches)["bbox_ids"].tolist() == [0]
    (producer,) = [t for t in threading.enumerate()
                   if t not in before and t.name == "loader-prefetch"]
    deadline = time.monotonic() + 30
    while len(made) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert made == [0, 1, 2, 3]
    batches.close()
    producer.join(timeout=5)
    assert not producer.is_alive()

    loader.dataset = _MissingImage(loader.dataset, bad=5)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        list(loader)


def test_pipeline_refuses_what_it_does_not_support(tiny):
    img_root, ann, _ = tiny
    # sharding is ported: a rank's loader keeps the records rank_id::device_num
    for is_train in (True, False):
        whole = create_dataset(img_root, ann, is_train=is_train, config=DATASET_SETTING,
                               use_gt_bbox_for_val=True)["dataset"]
        shard = create_pipeline(
            create_dataset(img_root, ann, is_train=is_train, device_num=2, rank_id=1,
                           config=DATASET_SETTING, use_gt_bbox_for_val=True),
            VAL_TRANSFORMS, is_train=is_train, config=DATASET_SETTING)
        assert shard.num_samples == len(whole) // 2 and shard.rank_id == 1
    ds = create_dataset(img_root, ann, is_train=False, config=DATASET_SETTING,
                        use_gt_bbox_for_val=True)
    # every method of the JAX package is ported (imagefolder_bottomup: its
    # own test is tests/test_torch_demo.py); an unknown one raises
    with pytest.raises(ValueError, match="unknown pipeline method"):
        create_pipeline(ds, VAL_TRANSFORMS, is_train=False, method="imagefolder_topdown",
                        config=DATASET_SETTING)
    folder = create_pipeline(ds, VAL_TRANSFORMS, is_train=False, method="imagefolder_bottomup",
                             config=DATASET_SETTING)
    assert folder.final_columns == ["image", "mask", "center", "scale", "image_file",
                                    "image_shape"]
    # accepted: device_pipeline: full's loader options, and hwc_to_chw, which
    # the JAX package's create_pipeline does not read either (batches stay NHWC)
    plain = next(iter(create_pipeline(ds, VAL_TRANSFORMS, is_train=False,
                                      config=DATASET_SETTING)))
    for kwargs in ({"decode_cache_mb": 64}, {"image_bucket": 32}, {"hwc_to_chw": True},
                   {"frame_grouped_shuffle": True}, {"patch_grouped_batching": True}):
        batch = next(iter(create_pipeline(ds, VAL_TRANSFORMS, **dict({"is_train": False},
                                                                     **kwargs),
                                          config=DATASET_SETTING)))
        assert batch["image"].shape[-1] == 3
        if "image_bucket" not in kwargs:
            np.testing.assert_array_equal(batch["image"], plain["image"])
    # bottom-up training is ported: the same call builds a train loader
    loader = create_pipeline(ds, VAL_TRANSFORMS, **dict({"is_train": False}, method="bottomup",
                                                        is_train=True), config=DATASET_SETTING)
    assert loader.is_train and loader.final_columns == ["image", "target", "mask", "tag_ind"]


def test_config_and_merge(tmp_path, caplog):
    cfg = os.path.join(ROOT, "configs", "hrnet", "hrnet_w32_tpu.yaml")
    argv = ["--config", cfg, "--ckpt", "w.msgpack", "--cfg-options", "batch_size=8",
            "eval_setting.hflip_tta=True", "val_root=/data/val", "dataset_setting.sigma=[1, 2]"]
    got, want = parse_args(argv), jax_parse_args(argv).asdict()
    assert want.pop("seed") is None  # the JAX train CLI's flag; the port's eval has none
    assert got.asdict() == want
    assert got.batch_size == 8 and got["eval_setting"]["hflip_tta"] is True
    assert got.get("missing", 3) == 3 and "ckpt" in got
    with caplog.at_level(logging.WARNING):
        assert _merged({"a": 1, "b": 2}, None, {"b": 3}) == {"a": 1, "b": 3}
    assert "Duplicated keys" in caplog.text


# ---------------------------------------------------------------- bottom-up

BOTTOMUP_SETTING = dict(
    DATASET_SETTING, image_size=[64, 64], heatmap_sizes=[[16, 16], [32, 32]], sigma=2.0,
    expand_mask=True, tag_per_joint=True)
BOTTOMUP_EVAL = dict(EVAL_SETTING, use_nms=True, oks_thr=0.9)


def _bottomup_records(ann_path, seed):
    """Inferencer-style bottom-up records: per image, its persons' keypoints
    with noise (and a false positive), their scores."""
    rng = np.random.RandomState(seed)
    coco = JaxCOCO(ann_path)
    records = []
    for img_id in coco.getImgIds():
        persons = []
        for a in coco.loadAnns(coco.getAnnIds(imgIds=img_id)):
            kp = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
            kp[:, :2] += rng.randn(len(kp), 2).astype(np.float32) * 4
            kp[:, 2] = rng.uniform(0, 1, len(kp))
            persons.append(np.concatenate([kp, rng.randn(len(kp), 1).astype(np.float32)], 1))
        persons.append(persons[0] + np.float32(2.0))
        records.append({"pred": persons, "score": [np.float32(rng.uniform(0.2, 1))
                                                   for _ in persons],
                        "image_path": os.path.join("images", coco.imgs[img_id]["file_name"])})
    return records


@pytest.mark.parametrize("setting", [{}, {"use_nms": False}, {"soft_nms": True}])
def test_bottomup_evaluator_bitwise(tiny, tmp_path, numpy_only, setting):
    ann = tiny[1]
    config = dict(BOTTOMUP_EVAL, **setting)
    records = _bottomup_records(ann, seed=8)
    port = create_evaluator(ann, name="bottomup", metric=["AP"], config=config,
                            result_path=str(tmp_path / "port.json"), remove_result_file=False)
    want = jax_create_evaluator(ann, name="bottomup", metric=["AP"], config=config,
                                result_path=str(tmp_path / "jax.json"),
                                remove_result_file=False)
    got, expected = port(records), want(records)
    assert list(got) == list(expected)
    np.testing.assert_array_equal(list(got.values()), list(expected.values()))
    with open(tmp_path / "port.json") as a, open(tmp_path / "jax.json") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("max_size,batch,want_batch", [
    ([96, 64], 4, 1),  # non-square: portrait and landscape pad apart, batch 1
    ([96, 96], 3, 3),  # square: one shape, batches stack
])
def test_bottomup_val_loader_batches_bitwise(tiny, max_size, batch, want_batch):
    """coco_bottomup val records, bottomup_rescale and bottomup_pad, and the
    batch rule, equal to the JAX package's loader's batches."""
    img_root, ann, _ = tiny
    setting = dict(BOTTOMUP_SETTING, max_image_size=max_size)
    port_ds = create_dataset(img_root, ann, dataset_format="coco_bottomup", is_train=False,
                             config=setting)
    jax_ds = jax_create_dataset(img_root, ann, dataset_format="coco_bottomup", is_train=False,
                                config=setting)
    assert len(port_ds["dataset"]) == len(jax_ds["dataset"]) == 4
    for i in range(4):
        assert port_ds["dataset"][i] == jax_ds["dataset"][i]
    transforms = ["bottomup_rescale", "bottomup_pad"]
    port_loader = create_pipeline(port_ds, transforms, method="bottomup", batch_size=batch,
                                  is_train=False, config=setting, num_workers=2)
    jax_loader = jax_create_pipeline(jax_ds, transforms, method="bottomup", batch_size=batch,
                                     is_train=False, config=setting)
    assert port_loader.batch_size == jax_loader.batch_size == want_batch
    port_batches, jax_batches = list(port_loader), list(jax_loader)
    assert len(port_batches) == len(jax_batches)
    for got, want in zip(port_batches, jax_batches):
        assert list(got) == list(want)
        for col in want:
            assert got[col].dtype == want[col].dtype and got[col].shape == want[col].shape, col
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)


def test_bottomup_training_is_refused(tiny):
    """Named for when the port refused bottom-up training: the same calls now
    build the train records and the train transforms
    (tests/test_torch_bottomup_train_data.py holds them to JAX's)."""
    img_root, ann, _ = tiny
    ds = create_dataset(img_root, ann, dataset_format="coco_bottomup", is_train=True,
                        config=BOTTOMUP_SETTING)["dataset"]
    assert len(ds) == 4 and ds[0]["mask"].shape[0] == len(BOTTOMUP_SETTING["heatmap_sizes"])
    from mindpose_tpu_torch.register import entrypoint

    for name in ("bottomup_random_affine", "bottomup_horizontal_random_flip",
                 "bottomup_generate_target", "bottomup_generate_tag_ind"):
        assert callable(entrypoint("transform", name)(
            is_train=True, config=dict(BOTTOMUP_SETTING, max_image_size=[96, 96])))
