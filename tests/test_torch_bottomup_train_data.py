"""The port's bottom-up training data against the JAX package's, on the CPU.

Bit for bit, from the same inputs and the same ``np.random`` state:

- the COCO segmentation codecs (``utils/coco.py``) on crafted crowd
  annotations: polygons (one with a repeated vertex, one too short to
  count), uncompressed and compressed RLE, and the compressed counts'
  encoder;
- the ``coco_bottomup`` train records of tests/fixtures/tiny_coco.py's
  frames with those crowd annotations added (``CROWD``), their bit-packed
  ``mask_info`` with and without ``expand_mask``, and what ``__getitem__``
  unpacks; a frame without annotations is skipped;
- each train transform (``bottomup_random_affine``,
  ``bottomup_horizontal_random_flip``, ``bottomup_generate_target``,
  ``bottomup_generate_tag_ind``), with one tag per joint and one per
  person, each leaving the random stream where the JAX transform leaves it;
- the train loader with higher_hrnet_w32_tpu.yaml's ``train_transforms``
  (and with the device pipeline's tag-index transform) at one worker over 2
  epochs, at the bottom-up fixture's reduced sizes (128x128 input, levels
  32x32 and 64x64), and ``DevicePrefetcher`` carrying its four columns.

The device targets (``ops/target.generate_bottomup_targets``) take the
host transform's float32 arithmetic, so they differ from the host's by
``exp``'s rounding alone: within 1e-6 (measured 1.2e-7). JAX's device
targets sum the sub-pixel centre in another order, ``(ul + 6) + (x -
round(x))`` in map coordinates where the host takes ``(6 + x) - round(x)``
in patch coordinates, so the centres round apart by up to an ulp of the
map coordinate, and JAX's device targets sit that far from its own host
transform's (1.6e-6 on a 64-wide map). Against JAX's device targets and
``build_bottomup_preprocess`` the bound is ``jax_atol``: the largest slope
of the Gaussian, ``1 / (sigma * sqrt(e))`` per pixel in each axis, times
that ulp.
"""
import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.data.device_pipeline import (
    BOTTOMUP_DEVICE_FINAL_COLUMNS as JAX_DEVICE_COLUMNS,
)
from mindpose_tpu.data.device_pipeline import build_bottomup_preprocess as jax_preprocess
from mindpose_tpu.ops.target import generate_bottomup_targets as jax_targets
from mindpose_tpu.register import entrypoint as jax_entrypoint
from mindpose_tpu.utils import coco as jax_coco
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.data.device_pipeline import (
    BOTTOMUP_DEVICE_FINAL_COLUMNS,
    build_bottomup_preprocess,
    swap_bottomup_target_transform,
)
from mindpose_tpu_torch.data.loader import DevicePrefetcher, _decode_image
from mindpose_tpu_torch.ops.target import generate_bottomup_targets
from mindpose_tpu_torch.register import entrypoint
from mindpose_tpu_torch.utils import coco
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import BOTTOMUP_RECORD
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "configs", "higher_hrnet", "higher_hrnet_w32_tpu.yaml")) as f:
    RECIPE = yaml.safe_load(f)
SETTING = BOTTOMUP_RECORD["config"]["dataset_setting"]  # 128x128, levels 32 and 64
TRAIN_TRANSFORMS = RECIPE["train_transforms"]
FRAMES = 12
H, W = tiny_coco.FRAME_HW
SEED = 5
TARGET_ATOL = 1e-6


def _rect_counts(y0, y1, x0, x1, h=H, w=W):
    """Uncompressed RLE counts (column-major, background first) of a rectangle."""
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    flat = m.T.ravel()
    changes = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(bounds).tolist()
    return counts if flat[0] == 0 else [0] + counts


def _zeros_kpts(n=0):
    k = np.zeros((17, 3))
    for i in range(n):
        k[i] = [60.0 + 3 * i, 40.0 + 2 * i, 2]
    return k.ravel().tolist()


# (image id, annotation fields) of the crowd and keypointless annotations added
CROWD = [
    (1, {"iscrowd": 1, "num_keypoints": 0, "keypoints": _zeros_kpts(),
         "segmentation": [[10.5, 10.0, 60.2, 12.0, 55.0, 70.7, 8.0, 66.0],
                          [150.0, 100.0, 200.0, 100.0, 200.0, 100.0, 180.0, 150.0],
                          [5.0, 5.0, 9.0, 9.0]]}),
    (2, {"iscrowd": 1, "num_keypoints": 0, "keypoints": _zeros_kpts(),
         "segmentation": {"counts": _rect_counts(20, 90, 30, 110), "size": [H, W]}}),
    (3, {"iscrowd": 1, "num_keypoints": 0, "keypoints": _zeros_kpts(),
         "segmentation": {"counts": jax_coco._encode_counts(_rect_counts(0, 40, 100, 224))
                          .decode("ascii"), "size": [H, W]}}),
    (4, {"iscrowd": 0, "num_keypoints": 0, "keypoints": _zeros_kpts(),
         "segmentation": [[100.0, 20.0, 140.0, 20.0, 140.0, 90.0, 100.0, 90.0]]}),
    (5, {"iscrowd": 1, "num_keypoints": 3, "keypoints": _zeros_kpts(3),
         "segmentation": [[40.0, 30.0, 90.0, 30.0, 90.0, 80.0]]}),
]


@pytest.fixture(scope="module")
def train_split(tmp_path_factory):
    """tiny_coco frames with ``CROWD`` added; frame 6 keeps only a crowd
    annotation without keypoints (no person), the last frame none."""
    root = str(tmp_path_factory.mktemp("bottomup_train"))
    img_root, ann = tiny_coco.write_split(root, FRAMES, tiny_coco.TRAIN_SEED)
    with open(ann) as f:
        data = json.load(f)
    data["annotations"] = [a for a in data["annotations"]
                           if a["image_id"] not in (6, FRAMES)]
    extra = CROWD + [(6, dict(CROWD[0][1]))]
    for image_id, fields in extra:
        data["annotations"].append(dict(
            fields, id=len(data["annotations"]) + 1000, image_id=image_id, category_id=1,
            bbox=[10.0, 10.0, 50.0, 60.0], area=3000.0))
    with open(ann, "w") as f:
        json.dump(data, f)
    return img_root, ann


# ------------------------------------------------------------------ codecs


def test_segmentation_codecs_equal_the_originals():
    for _, fields in CROWD:
        seg = fields["segmentation"]
        got, want = coco.annotation_to_mask(seg, H, W), jax_coco.annotation_to_mask(seg, H, W)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (H, W)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < H * W
        if isinstance(seg, list):
            for poly in seg:
                if len(poly) >= 6:
                    assert (coco.rle_counts_from_poly(poly, H, W)
                            == jax_coco.rle_counts_from_poly(poly, H, W))
            np.testing.assert_array_equal(coco.poly_to_mask(seg, H, W),
                                          jax_coco.poly_to_mask(seg, H, W))
        else:
            np.testing.assert_array_equal(coco.decode_rle(seg), jax_coco.decode_rle(seg))
    counts = _rect_counts(3, 150, 7, 200)
    enc = coco._encode_counts(counts)
    assert enc == jax_coco._encode_counts(counts)
    assert coco._decode_compressed_counts(enc) == jax_coco._decode_compressed_counts(enc) == counts
    np.testing.assert_array_equal(coco._mask_from_counts(counts, H, W),
                                  jax_coco._mask_from_counts(counts, H, W))
    with pytest.raises(ValueError, match="counts sum"):
        coco.decode_rle({"counts": [5, 5], "size": [H, W]})


# ----------------------------------------------------------------- records


@pytest.mark.parametrize("expand_mask", [True, False])
def test_train_records_equal_the_jax_dataset(train_split, expand_mask):
    setting = dict(SETTING, expand_mask=expand_mask)
    got = create_dataset(*train_split, dataset_format="coco_bottomup", is_train=True,
                         config=setting)["dataset"]
    want = jax_create_dataset(*train_split, dataset_format="coco_bottomup", is_train=True,
                              config=setting)["dataset"]
    assert len(got) == len(want) == FRAMES - 1  # the frame without annotations is skipped
    for r, w in zip(got._dataset, want._dataset):
        assert r.keys() == w.keys() and r["image_file"] == w["image_file"]
        for key in ("keypoints", "boxes"):
            np.testing.assert_array_equal(r[key], w[key])
            assert r[key].dtype == w[key].dtype
        assert r["mask_info"]["count"] == w["mask_info"]["count"]
        assert r["mask_info"]["shape"] == w["mask_info"]["shape"] == (2, H, W)
        np.testing.assert_array_equal(r["mask_info"]["encoded_mask"],
                                      w["mask_info"]["encoded_mask"])
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for key in ("boxes", "keypoints", "mask"):
            np.testing.assert_array_equal(g[key], w[key])
            assert g[key].dtype == w[key].dtype
    # the crowd annotations blank pixels; the crowd without keypoints is no person
    masks = [got[i]["mask"] for i in range(6)]  # frames 1-6
    for m, (y, x) in zip(masks, [(40, 45), (40, 45), (20, 150), (50, 120), (40, 75), (40, 45)]):
        assert not m[:, y, x].any() and m.any()
    assert got[5]["keypoints"].shape == (2, 1, 17, 3) and not got[5]["keypoints"].any()
    assert got[4]["keypoints"].shape == (2, 3, 17, 3)  # the crowd with keypoints is kept
    if expand_mask:  # each level eroded by its own disk
        assert (masks[1][0] == 0).sum() > (masks[1][1] == 0).sum()
    else:
        assert (masks[1][0] == masks[1][1]).all()


# -------------------------------------------------------------- transforms


def _states(train_split):
    """Decoded records as they reach the first train transform."""
    ds = create_dataset(*train_split, dataset_format="coco_bottomup", is_train=True,
                        config=SETTING)["dataset"]
    return [_decode_image(ds[i]) for i in range(len(ds))]


def _run(make, states, seed):
    np.random.seed(seed)
    t = make()
    outs = [t(copy.deepcopy(s)) for s in states]
    return outs, np.random.get_state()


def _assert_same_outputs(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            gv, wv = np.asarray(g[key]), np.asarray(w[key])
            assert gv.dtype == wv.dtype and gv.shape == wv.shape, key
            np.testing.assert_array_equal(gv, wv, err_msg=key)


def _warped(states, setting):
    """The states after the JAX package's random affine (the recipe's)."""
    name, kwargs = next(iter(TRAIN_TRANSFORMS[0].items()))
    np.random.seed(SEED + 1)
    t = jax_entrypoint("transform", name)(is_train=True, config=setting, **kwargs)
    return [t(copy.deepcopy(s)) for s in states]


AFFINES = [dict(next(iter(TRAIN_TRANSFORMS[0].values()))),
           {"rot_factor": 10, "scale_factor": [0.5, 2.0], "scale_type": "long",
            "trans_factor": 0}]


@pytest.mark.parametrize("name,kwargs,warped,tag_per_joint", [
    ("bottomup_random_affine", AFFINES[0], False, True),
    ("bottomup_random_affine", AFFINES[1], False, True),
    ("bottomup_horizontal_random_flip", {"flip_prob": 0.5}, True, True),
    ("bottomup_generate_target", {"sigma": 2.0, "max_num": 30}, True, True),
    ("bottomup_generate_target", {"sigma": 1.5, "max_num": 30}, True, False),
    ("bottomup_generate_tag_ind", {"sigma": 2.0, "max_num": 30}, True, True),
    ("bottomup_generate_tag_ind", {"sigma": 2.0, "max_num": 30}, True, False),
])
def test_train_transforms_equal_the_jax_transforms(train_split, name, kwargs, warped,
                                                   tag_per_joint):
    setting = dict(SETTING, tag_per_joint=tag_per_joint)
    states = _states(train_split)
    if warped:
        states = _warped(states, setting)
    want, want_rng = _run(lambda: jax_entrypoint("transform", name)(
        is_train=True, config=setting, **kwargs), states, SEED)
    got, got_rng = _run(lambda: entrypoint("transform", name)(
        is_train=True, config=setting, **kwargs), states, SEED)
    _assert_same_outputs(got, want)
    for g, w in zip(got_rng, want_rng):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if name == "bottomup_horizontal_random_flip":  # some flipped, some not
        flipped = [not np.array_equal(g["image"], s["image"]) for g, s in zip(got, states)]
        assert any(flipped) and not all(flipped)


def test_generate_target_refuses_too_many_persons(train_split):
    state = _warped(_states(train_split)[:1], SETTING)[0]
    for name in ("bottomup_generate_target", "bottomup_generate_tag_ind"):
        t = entrypoint("transform", name)(is_train=True, config=SETTING, max_num=1)
        with pytest.raises(ValueError, match="exceeds the maximum"):
            t(copy.deepcopy(state))


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("device_pipeline", [False, True])
def test_train_loader_equals_the_jax_loader_over_2_epochs(train_split, device_pipeline):
    transforms, columns = TRAIN_TRANSFORMS, None
    if device_pipeline:
        transforms, _ = swap_bottomup_target_transform(TRAIN_TRANSFORMS)
        columns = BOTTOMUP_DEVICE_FINAL_COLUMNS
        assert columns == JAX_DEVICE_COLUMNS
    batches = {}
    for side, (make_ds, make_pipe) in {"jax": (jax_create_dataset, jax_create_pipeline),
                                       "port": (create_dataset, create_pipeline)}.items():
        np.random.seed(SEED)
        ds = make_ds(*train_split, dataset_format="coco_bottomup", is_train=True,
                     config=SETTING)
        loader = make_pipe(ds, transforms, method="bottomup", batch_size=4, is_train=True,
                           normalize=not device_pipeline, config=SETTING, num_workers=1,
                           seed=SEED, final_columns=columns)
        batches[side] = [b for _ in range(2) for b in loader]
    assert len(batches["port"]) == len(batches["jax"]) == 2 * ((FRAMES - 1) // 4)
    names = columns or ["image", "target", "mask", "tag_ind"]
    for g, w in zip(batches["port"], batches["jax"]):
        assert list(g) == list(w) == names
        for key in names:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    first = batches["port"][0]
    if device_pipeline:
        assert first["keypoints"].shape == (4, 2, 30, 17, 3) and first["image"].dtype == np.uint8
    else:
        assert first["target"].shape == (4, 2, 64, 64, 17) and first["target"].max() > 0.9
    assert first["mask"].shape == (4, 2, 64, 64) and first["tag_ind"].shape == (4, 2, 30, 17, 2)
    # the epochs differ (the shuffle and the augmentations)
    assert not np.array_equal(batches["port"][0]["image"], batches["port"][2]["image"])


def test_device_prefetcher_carries_the_four_columns(train_split):
    """The train entry's ``device_prefetch`` over the bottom-up loader: on the
    CPU each batch's four columns as tensors, in order, equal to the batch."""
    np.random.seed(SEED)
    ds = create_dataset(*train_split, dataset_format="coco_bottomup", is_train=True,
                        config=SETTING)
    loader = create_pipeline(ds, TRAIN_TRANSFORMS, method="bottomup", batch_size=4,
                             is_train=True, config=SETTING, num_workers=1, seed=SEED)
    columns = ["image", "target", "mask", "tag_ind"]
    np.random.seed(SEED)
    want = list(loader)
    loader.epoch = 0
    np.random.seed(SEED)
    got = list(DevicePrefetcher(loader, columns, "cpu", depth=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert [type(t) for t in g] == [torch.Tensor] * 4
        for t, c in zip(g, columns):
            np.testing.assert_array_equal(t.numpy(), w[c])


# ----------------------------------------------------------- device targets


def _keypoints(rng, n=3, m=5, k=17, size=(20, 16)):
    """[n, m, k, 3] in a (w, h) level's frame: inside, at .5 (half to even),
    near and past each edge, invisible, and padded slots."""
    w, h = size
    xy = rng.uniform(-12, max(w, h) + 12, (n, m, k, 2))
    xy[0, 0, :6] = [[2.5, 3.5], [3.5, 2.5], [-6.4, 4.0], [w + 6.4, 4.0], [5.0, -7.6], [4.0, h + 6.6]]
    xy[0, 1, :4] = [[0.5, 0.5], [w - 0.5, h - 0.5], [-0.5, 3.0], [w + 0.49, 3.0]]
    vis = (rng.uniform(0, 1, (n, m, k, 1)) < 0.8).astype(np.float32)
    vis[:, -1] = 0  # a padded slot
    vis[0, :2, :6] = 2
    return np.concatenate([xy, vis], -1).astype(np.float32)


def jax_atol(kpts: np.ndarray, sigma: float) -> float:
    """Two Gaussians whose centres lie one float32 ulp of the largest map
    coordinate apart in each axis differ by at most this."""
    ulp = float(np.spacing(np.float32(np.abs(kpts[..., :2]).max() + 3 * sigma + 1)))
    return 2 * ulp / (sigma * np.sqrt(np.e))


@pytest.mark.parametrize("sigma", [2.0, 1.5])
def test_device_targets_match_jax_and_the_host_transform(sigma):
    rng = np.random.RandomState(6)
    size = (20, 16)
    kpts = _keypoints(rng, size=size)
    got = generate_bottomup_targets(torch.from_numpy(kpts), size, sigma=sigma)
    want = np.asarray(jax_targets(jnp.asarray(kpts), heatmap_size=size, sigma=sigma))
    assert got.shape == (3, 17, 16, 20) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0,
                               atol=jax_atol(kpts, sigma))
    np.testing.assert_array_equal(got > 0, want.transpose(0, 3, 1, 2) > 0)
    # the host transform on each image's persons, padded slots dropped
    config = dict(SETTING, heatmap_sizes=[list(size)])
    host = entrypoint("transform", "bottomup_generate_target")(
        is_train=True, config=config, sigma=sigma, max_num=30)
    for i in range(len(kpts)):
        t = host({"keypoints": kpts[i:i + 1, :-1]})["target"][0]  # [H, W, K]
        np.testing.assert_allclose(got[i], t.transpose(2, 0, 1), rtol=0, atol=TARGET_ATOL)
    assert got.max() > 0.99


def test_bottomup_preprocess_matches_jax():
    rng = np.random.RandomState(7)
    levels = SETTING["heatmap_sizes"]
    image = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    kpts = np.stack([_keypoints(rng, n=2, m=30, size=tuple(s)) for s in levels], axis=1)
    mask = rng.randint(0, 2, (2, 2, 64, 64)).astype(np.uint8)
    tag_ind = rng.randint(0, 1024, (2, 2, 30, 17, 2)).astype(np.int32)
    mean, std = RECIPE["normalize_mean"], RECIPE["normalize_std"]
    want = jax_preprocess(levels, mean, std, sigma=2.0)(
        jnp.asarray(image), jnp.asarray(kpts), jnp.asarray(mask), jnp.asarray(tag_ind))
    got = build_bottomup_preprocess(levels, mean, std, sigma=2.0)(
        *(torch.from_numpy(a) for a in (image, kpts, mask, tag_ind)))
    assert got[0].shape == (2, 3, 128, 128) and got[0].is_contiguous()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).transpose(0, 3, 1, 2))
    assert got[1].shape == (2, 2, 17, 64, 64)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]).transpose(0, 1, 4, 2, 3),
                               rtol=0, atol=jax_atol(kpts, 2.0))
    assert not got[1][:, 0, :, 32:].any() and not got[1][:, 0, :, :, 32:].any()
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
