"""The port's copies of the JAX package's numpy host helpers stay equal to them.

The port cannot import ``mindpose_tpu`` (its ``__init__`` imports JAX), so
the crop geometry, the joints' flip permutation and the DARK refinement's
Gaussian kernel, and the bottom-up host path (the host Hungarian matcher
``utils/match.py``, ``transform_keypoints``, ``bottomup_rescale``,
``bottomup_pad`` and the levels' ``pad_to_same``), the SimCC and
regression target transforms and MPII's distance metrics
(``utils/keypoint_metrics.py``), ``device_pipeline: full``'s host side
(``topdown_affine_matrix`` with its source patch, the deferred flip, the
matrices' composition and mirror, ``DecodedFrameCache``), the backbone
converter's host side (``utils/ms_ckpt.py``, ``normalize_source_keys``) and
``utils/download.py``, the demos' ``utils/smoothing.py`` (the One-Euro
filter) and ``tools/skeleton.py`` (``tools/common/skeleton.py``), the two
transforms no recipe sets (``bottomup_resize``, ``topdown_photometric_distortion``),
the native COCO library's C++ source (byte for byte), the pod launcher's
barrier (``prepare_data_rank0``) and the data tools ``make_synthetic_coco``
and ``convert_mpii`` live in the port as copies (the bottom-up
train transforms' own test is tests/test_torch_bottomup_train_data.py);
these tests pin each copy to its original, bit for bit. They also pin chip_smoke.py's config literal to
configs/hrnet/hrnet_w32_tpu.yaml, so the GPU machine needs no yaml parser.
"""
import os

import numpy as np
import pytest
import yaml

from mindpose_tpu.data.transform import utils as jax_utils
from mindpose_tpu.data.transform.bottomup_transform import BottomUpPad as JaxBottomUpPad
from mindpose_tpu.data.transform.bottomup_transform import (
    BottomUpResize as JaxBottomUpResize,
)
from mindpose_tpu.data.transform.bottomup_transform import (
    BottomUpRescale as JaxBottomUpRescale,
)
from mindpose_tpu.data.loader import DecodedFrameCache as JaxDecodedFrameCache
from mindpose_tpu.data.transform.topdown_transform import (
    TopDownAffine,
    TopDownBoxToCenterScale,
)
from mindpose_tpu.data.transform.topdown_transform import (
    TopDownAffineMatrix as JaxTopDownAffineMatrix,
)
from mindpose_tpu.data.transform.topdown_transform import (
    TopDownHorizontalRandomFlip as JaxTopDownHorizontalRandomFlip,
)
from mindpose_tpu.data.transform.topdown_transform import (
    TopDownGenerateRegressionTarget as JaxRegressionTarget,
)
from mindpose_tpu.data.transform.topdown_transform import (
    TopDownGenerateSimCCTarget as JaxSimCCTarget,
)
from mindpose_tpu.data.transform.topdown_transform import (
    TopDownPhotometricDistortion as JaxPhotometricDistortion,
)
from mindpose_tpu.models.backbones.convert import (
    normalize_source_keys as jax_normalize_source_keys,
)
from mindpose_tpu.ops.heatmap import gaussian_kernel_2d as jax_gaussian_kernel_2d
from mindpose_tpu.utils import download as jax_download
from mindpose_tpu.utils import keypoint_metrics as jax_metrics
from mindpose_tpu.utils import ms_ckpt as jax_ms_ckpt
from mindpose_tpu.utils import smoothing as jax_smoothing
from mindpose_tpu.utils.match import match_by_tag as jax_match_by_tag
from mindpose_tpu_torch.data.loader import DecodedFrameCache
from mindpose_tpu_torch.data.transform import utils
from mindpose_tpu_torch.data.transform.bottomup_transform import (
    BottomUpPad,
    BottomUpRescale,
    BottomUpResize,
)
from mindpose_tpu_torch.data.transform.topdown_transform import (
    TopDownAffineMatrix,
    TopDownGenerateRegressionTarget,
    TopDownHorizontalRandomFlip,
    TopDownGenerateSimCCTarget,
    TopDownPhotometricDistortion,
    box_to_center_scale,
    crop_matrix,
)
from mindpose_tpu_torch.models.convert_source import normalize_source_keys
from mindpose_tpu_torch.ops.heatmap import gaussian_kernel_2d
from mindpose_tpu_torch.tools import convert_mpii, launch_pod, make_synthetic_coco, skeleton
from mindpose_tpu_torch.utils import download, keypoint_metrics, ms_ckpt, smoothing
from mindpose_tpu_torch.utils.match import match_by_tag
from tests.fixtures.grouping_sets import ORDER, candidate_sets
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTING = {
    "image_size": [192, 256],
    "heatmap_size": [48, 64],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
    "flip_pairs": [[1, 2]],
    "upper_body_ids": [0, 1],
}


def _boxes(rng, n=50):
    xy = rng.uniform(-50, 600, (n, 2))
    wh = rng.uniform(1, 400, (n, 2))
    boxes = np.concatenate([xy, wh], axis=1).astype(np.float32)
    boxes[0, 2:] = [192, 256]  # exactly the crop's aspect ratio
    return boxes


def test_rotate_point_and_third_point():
    rng = np.random.RandomState(0)
    for _ in range(20):
        pt, angle = rng.randn(2) * 50, rng.uniform(-np.pi, np.pi)
        assert utils.rotate_point(pt, angle) == jax_utils.rotate_point(pt, angle)
        a, b = rng.randn(2).astype(np.float32), rng.randn(2).astype(np.float32)
        np.testing.assert_array_equal(utils._get_3rd_point(a, b), jax_utils._get_3rd_point(a, b))
        src, dst = rng.randn(3, 2).astype(np.float32), rng.randn(3, 2).astype(np.float32)
        np.testing.assert_array_equal(utils._solve_affine(src, dst),
                                      jax_utils._solve_affine(src, dst))


@pytest.mark.parametrize("inv", [False, True])
def test_get_affine_transform(inv):
    rng = np.random.RandomState(1)
    for _ in range(30):
        center = rng.uniform(0, 600, 2)
        scale = rng.uniform(0.1, 3.0, 2)
        rot = rng.uniform(-45, 45)
        shift = tuple(rng.uniform(-0.2, 0.2, 2))
        size = (int(rng.randint(16, 400)), int(rng.randint(16, 400)))
        args = (center, scale, rot, size)
        np.testing.assert_array_equal(
            utils.get_affine_transform(*args, shift=shift, inv=inv, pixel_std=200.0),
            jax_utils.get_affine_transform(*args, shift=shift, inv=inv, pixel_std=200.0))


@pytest.mark.parametrize("pairs, num_joints", [
    ([[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]], None),
    ([[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]], 17),
    ([[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]], 16),  # MPII
    ([[1, 2]], 5),  # unpaired joints after the last pair
    ([], 3),
    (np.array([0, 2, 1, 3]), None),  # already a flat permutation
])
def test_flip_index_from_pairs(pairs, num_joints):
    got = utils.flip_index_from_pairs(pairs, num_joints)
    want = jax_utils.flip_index_from_pairs(pairs, num_joints)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_flip_index_from_pairs_rejects_an_index_out_of_range():
    for flip in (utils.flip_index_from_pairs, jax_utils.flip_index_from_pairs):
        with pytest.raises(ValueError, match="out of range"):
            flip([[1, 2], [3, 17]], 17)


def test_get_warp_matrix():
    rng = np.random.RandomState(2)
    for _ in range(30):
        args = (rng.uniform(-45, 45), rng.uniform(0, 1200, 2),
                rng.uniform(10, 300, 2), rng.uniform(10, 800, 2))
        np.testing.assert_array_equal(utils.get_warp_matrix(*args),
                                      jax_utils.get_warp_matrix(*args))


@pytest.mark.parametrize("use_udp", [False, True])
def test_center_scale_and_crop_matrix_equal_the_val_transforms(use_udp):
    to_cs = TopDownBoxToCenterScale(is_train=False, config=SETTING)
    affine = TopDownAffine(is_train=False, config=SETTING, use_udp=use_udp)
    for box in _boxes(np.random.RandomState(3)):
        want = to_cs.transform({"boxes": box})
        center, scale = box_to_center_scale(box, SETTING["image_size"], SETTING["pixel_std"],
                                            SETTING["scale_padding"])
        np.testing.assert_array_equal(center, want["center"])
        np.testing.assert_array_equal(scale, want["scale"])
        assert center.dtype == want["center"].dtype and scale.dtype == want["scale"].dtype

        want_mat = affine._matrix_and_keypoints(
            {"center": want["center"], "scale": want["scale"], "rotation": 0.0})["_trans"]
        got_mat = crop_matrix(center, scale, SETTING["image_size"], SETTING["pixel_std"],
                              use_udp=use_udp)
        np.testing.assert_array_equal(got_mat, want_mat)


def test_chip_smoke_config_literal_equals_the_yaml():
    import chip_smoke

    with open(os.path.join(ROOT, "configs", "hrnet", "hrnet_w32_tpu.yaml")) as f:
        cfg = yaml.safe_load(f)
    want = {key: cfg[key] for key in chip_smoke.HRNET_W32.keys() if key in cfg}
    assert chip_smoke.HRNET_W32 == want


def test_joint_helpers():
    """fliplr_joints (by pairs and by index), affine_transform and warp_affine_joints."""
    rng = np.random.RandomState(4)
    pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
    for _ in range(20):
        kpts = np.concatenate([rng.uniform(-20, 500, (17, 2)), rng.randint(0, 2, (17, 1))],
                              axis=1).astype(np.float32)
        width = int(rng.randint(1, 800))
        for kwargs in ({"flip_pairs": pairs}, {"flip_index": utils.flip_index_from_pairs(pairs)}):
            got, want = utils.fliplr_joints(kpts, width, **kwargs), jax_utils.fliplr_joints(
                kpts, width, **kwargs)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        mat = rng.randn(2, 3) * [[1, 1, 100]]
        for k in range(17):
            np.testing.assert_array_equal(utils.affine_transform(kpts[k, :2], mat),
                                          jax_utils.affine_transform(kpts[k, :2], mat))
        for m in (mat, mat.astype(np.float32)):
            got, want = utils.warp_affine_joints(kpts[:, :2], m), jax_utils.warp_affine_joints(
                kpts[:, :2], m)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="flip_index"):
        utils.fliplr_joints(np.zeros((5, 3)), 10, flip_index=np.arange(4))


@pytest.mark.parametrize("shapes", [
    [(17, 16, 16), (17, 32, 32)],  # the bottom-up targets of two levels
    [(16, 16), (32, 24), (8, 40)],  # the levels' masks
    [(5, 3)],
])
def test_pad_to_same(shapes):
    rng = np.random.RandomState(len(shapes))
    arrays = [rng.randint(0, 255, s).astype(np.uint8 if len(s) == 2 else np.float32)
              for s in shapes]
    got, want = utils.pad_to_same(arrays), jax_utils.pad_to_same(arrays)
    assert len(got) == len(want) == len(arrays)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", [3, 5, 7, 10, 11, 17])
def test_gaussian_kernel_2d(size):
    want = jax_gaussian_kernel_2d(size)
    got = gaussian_kernel_2d(size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tag_dim", [1, 2])
@pytest.mark.parametrize("rounded,ignore", [(True, False), (False, False), (True, True)])
def test_host_matcher(tag_dim, rounded, ignore):
    """utils/match.py on seeded candidate sets (a few persons, close tags,
    more persons than candidates): the same groups, bit for bit."""
    rng = np.random.RandomState(10 * tag_dim + 2 * rounded + ignore)
    for kwargs in (dict(persons=5, spread=3.0, visible=0.3), dict(persons=5, spread=0.5),
                   dict(persons=40, spread=10.0, visible=1.0)):
        val_k, tag_k, ind_k = candidate_sets(rng, 3, tag_dim=tag_dim, **kwargs)
        for v, t, i in zip(val_k, tag_k, ind_k):
            kw = dict(vis_thr=0.1, tag_thr=1.0, use_rounded_norm=rounded, ignore_too_much=ignore)
            got, want = match_by_tag(v, t, i, ORDER, **kw), jax_match_by_tag(v, t, i, ORDER, **kw)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_transform_keypoints():
    rng = np.random.RandomState(11)
    coords = [rng.uniform(0, 200, (3, 17, 4)).astype(np.float32), np.zeros((0, 17, 4), np.float32),
              rng.uniform(0, 200, (1, 17, 4)).astype(np.float32)]
    center = rng.uniform(0, 500, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 4, (3, 2)).astype(np.float32)
    shape = rng.randint(64, 512, (3, 2)).astype(np.float32) / 2
    for pixel_std in (200.0, 1.0):
        got = utils.transform_keypoints(coords, center, scale, shape, pixel_std=pixel_std)
        want = jax_utils.transform_keypoints(coords, center, scale, shape, pixel_std=pixel_std)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


BOTTOMUP = {
    "image_size": [512, 512], "heatmap_sizes": [[128, 128], [256, 256]], "pixel_std": 200.0,
    "tag_per_joint": True, "flip_pairs": [[1, 2], [3, 4]],
}


@pytest.mark.parametrize("max_size", [[832, 512], [832, 832], [96, 64]])
def test_bottomup_rescale_and_pad(max_size):
    """Landscape, portrait, square, odd-sized and already-fitting images."""
    rng = np.random.RandomState(12)
    config = dict(BOTTOMUP, max_image_size=max_size)
    for h, w in ((480, 640), (640, 480), (500, 500), (37, 123), (64, 96), (1, 2)):
        image = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        state, jax_state = {"image": image}, {"image": image.copy()}
        for port_cls, jax_cls in ((BottomUpRescale, JaxBottomUpRescale),
                                  (BottomUpPad, JaxBottomUpPad)):
            state.update(port_cls(is_train=False, config=config).transform(state))
            jax_state.update(jax_cls(is_train=False, config=config).transform(jax_state))
        assert sorted(state) == sorted(jax_state)
        for key in jax_state:
            got, want = np.asarray(state[key]), np.asarray(jax_state[key])
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("size, base_length", [(512, 64), (128, 64), (100, 32)])
def test_bottomup_resize(size, base_length):
    """Landscape, portrait, square and odd-sized images: the image (its sides
    multiples of ``base_length``, not square), mask, center, scale and shape."""
    rng = np.random.RandomState(13)
    config = dict(BOTTOMUP, max_image_size=[832, 512])
    kwargs = dict(is_train=False, config=config, size=size, base_length=base_length)
    for h, w in ((480, 640), (640, 480), (500, 500), (37, 123), (160, 224)):
        image = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        got = BottomUpResize(**kwargs).transform({"image": image})
        want = JaxBottomUpResize(**kwargs).transform({"image": image.copy()})
        assert sorted(got) == sorted(want)
        for key in want:
            g, w_ = np.asarray(got[key]), np.asarray(want[key])
            assert g.dtype == w_.dtype and g.shape == w_.shape, key
            np.testing.assert_array_equal(g, w_, err_msg=key)
        assert got["image"].shape[0] % base_length == got["image"].shape[1] % base_length == 0


@pytest.mark.parametrize("kwargs", [{}, {"brightness_delta": 64.0, "contrast_range": (0.2, 2.0),
                                         "saturation_range": (0.0, 3.0), "hue_delta": 90.0}])
def test_photometric_distortion_under_the_same_seed(kwargs):
    """Each of 40 images from the same ``np.random`` state: the same pixels,
    and the stream left where the original leaves it."""
    rng = np.random.RandomState(14)
    port = TopDownPhotometricDistortion(is_train=True, config=SETTING, **kwargs)
    jax = JaxPhotometricDistortion(is_train=True, config=SETTING, **kwargs)
    changed = 0
    for i in range(40):
        image = rng.randint(0, 256, (int(rng.randint(8, 90)), int(rng.randint(8, 90)), 3),
                            dtype=np.uint8)
        np.random.seed(200 + i)
        want = jax.transform({"image": image.copy()})
        after = np.random.rand()
        np.random.seed(200 + i)
        got = port.transform({"image": image.copy()})
        assert list(got) == list(want) == ["image"]
        assert got["image"].dtype == want["image"].dtype == np.uint8
        np.testing.assert_array_equal(got["image"], want["image"])
        assert np.random.rand() == after
        changed += not np.array_equal(got["image"], image)
    assert changed > 20


def test_native_source_is_a_byte_for_byte_copy():
    with open(os.path.join(ROOT, "csrc", "coco_native.cpp"), "rb") as f:
        original = f.read()
    with open(os.path.join(ROOT, "mindpose_tpu_torch", "csrc", "coco_native.cpp"), "rb") as f:
        assert f.read() == original


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, imported from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_prepare_barrier_runs_the_command_once_per_stamp(tmp_path, monkeypatch):
    """``prepare_data_rank0`` as the original: rank 0 runs the command and
    writes the command's hash; a matching barrier is not run again; a changed
    command removes the stale barrier and runs; another rank waits for the
    stamp and runs nothing."""
    import hashlib
    import sys as _sys

    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    original = _jax_tool("launch_pod")
    runs = {}
    for label, module in (("port", launch_pod), ("jax", original)):
        work = tmp_path / label
        work.mkdir()
        log = work / "log"
        cmd = f"{_sys.executable} -c \"open(r'{log}', 'a').write('x')\""
        module.prepare_data_rank0(cmd, str(work), 0)
        module.prepare_data_rank0(cmd, str(work), 0)  # the barrier matches: not run
        module.prepare_data_rank0(cmd, str(work), 1)  # the stamp is there: no wait, no run
        stamp = (work / ".mindpose_data_ready").read_text()
        module.prepare_data_rank0(cmd + " ", str(work), 0)  # a changed command runs
        changed = (work / ".mindpose_data_ready").read_text()
        assert stamp == hashlib.sha256(cmd.encode()).hexdigest()
        assert changed == hashlib.sha256((cmd + " ").encode()).hexdigest()
        runs[label] = log.read_text()
    assert runs["port"] == runs["jax"] == "xx"


def test_synthetic_coco_and_mpii_converter_equal_their_originals(tmp_path):
    original = _jax_tool("make_synthetic_coco")
    for layout, people in (("grid", 2), ("person", 3)):
        for label, module in (("port", make_synthetic_coco), ("jax", original)):
            module.generate_split(str(tmp_path / label / layout), 3, seed=layout == "grid",
                                  people_per_img=people, layout=layout)
        port, jax = tmp_path / "port" / layout, tmp_path / "jax" / layout
        assert (port / "annotations.json").read_bytes() == (jax / "annotations.json").read_bytes()
        names = sorted(os.listdir(jax / "images"))
        assert sorted(os.listdir(port / "images")) == names and len(names) == 3
        for name in names:
            assert (port / "images" / name).read_bytes() == (jax / "images" / name).read_bytes()
    mpii = _jax_tool("convert_mpii")
    assert convert_mpii.MPII_FLIP_PAIRS == mpii.MPII_FLIP_PAIRS
    assert convert_mpii.MPII_JOINT_NAMES == mpii.MPII_JOINT_NAMES
    rng = np.random.RandomState(15)
    records = [{"image": f"{i % 3:09d}.jpg", "center": rng.uniform(100, 400, 2).tolist(),
                "scale": float(rng.uniform(0.8, 3)),
                "joints": (rng.uniform(-5, 500, (16, 2)) * (rng.rand(16, 1) > 0.1)).tolist(),
                "joints_vis": (rng.rand(16) > 0.3).astype(float).tolist()} for i in range(7)]
    for shift in (True, False):
        assert convert_mpii.convert(records, apply_center_shift=shift) == mpii.convert(
            records, apply_center_shift=shift)


TARGETS = {"image_size": [48, 64], "heatmap_size": [12, 16], "pixel_std": 200.0,
           "scale_padding": 1.25, "flip_pairs": [[1, 2]], "upper_body_ids": [0, 1]}


def _crop_keypoints(rng, n=6, k=17, w=48.0, h=64.0):
    """[n, k, 3] crop keypoints: inside, on and just past the edges, outside, some invisible."""
    xy = rng.uniform([-20, -20], [w + 20, h + 20], (n, k, 2))
    xy[0, :6] = [[0.0, 0.0], [w - 1e-3, h - 1e-3], [w, 5.0], [5.0, h], [-1e-3, 3.0], [17.5, 30.25]]
    vis = rng.randint(0, 3, (n, k, 1))
    vis[0, :6] = 2
    return np.concatenate([xy, vis], -1).astype(np.float32)


@pytest.mark.parametrize("sigma, split_ratio", [(6.0, 2.0), (2.0, 2.0), (4.0, 2.5)])
def test_simcc_and_regression_target_transforms(sigma, split_ratio):
    pairs = [(TopDownGenerateSimCCTarget(config=TARGETS, sigma=sigma, split_ratio=split_ratio),
              JaxSimCCTarget(config=TARGETS, sigma=sigma, split_ratio=split_ratio)),
             (TopDownGenerateRegressionTarget(config=TARGETS),
              JaxRegressionTarget(config=TARGETS))]
    for kpts in _crop_keypoints(np.random.RandomState(13)):
        for port, jax_t in pairs:
            got, want = port.transform({"keypoints": kpts}), jax_t.transform({"keypoints": kpts})
            assert sorted(got) == sorted(want) == ["target", "target_weight"]
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


def test_keypoint_metrics():
    """PCK, AUC, EPE and NME, with an instance and a joint never labeled and
    non-positive normalizers (the instance drops out)."""
    rng = np.random.RandomState(14)
    preds = rng.uniform(0, 400, (12, 16, 2))
    gts = preds + rng.normal(0, 15, (12, 16, 2))
    mask = rng.uniform(0, 1, (12, 16)) > 0.2
    mask[0], mask[:, 3] = False, False
    norm = rng.uniform(20, 200, (12, 2))
    norm[1, 0], norm[2] = 0.0, -5.0
    with np.errstate(divide="ignore"):
        for fn, args in (("normalized_distances", (preds, gts, mask, norm)),
                         ("normalized_distances", (preds, gts, mask, None)),
                         ("keypoint_epe", (preds, gts, mask)),
                         ("keypoint_nme", (preds, gts, mask, norm)),
                         ("keypoint_auc", (preds, gts, mask, 30.0)),
                         ("keypoint_auc", (preds, gts, mask, 12.5, 7))):
            got, want = getattr(keypoint_metrics, fn)(*args), getattr(jax_metrics, fn)(*args)
            np.testing.assert_array_equal(got, want, err_msg=fn)
        for thr in (0.05, 0.2, 0.5):
            got = keypoint_metrics.keypoint_pck_accuracy(preds, gts, mask, thr, norm)
            want = jax_metrics.keypoint_pck_accuracy(preds, gts, mask, thr, norm)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    empty = np.zeros((3, 16), bool)
    assert keypoint_metrics.keypoint_epe(preds[:3], gts[:3], empty) == 0.0
    pck = keypoint_metrics.keypoint_pck_accuracy(preds[:3], gts[:3], empty, 0.5, norm[:3])
    assert pck[1:] == (0.0, 0)


def test_affine_composition_and_mirror():
    rng = np.random.RandomState(21)
    for _ in range(20):
        outer, inner = rng.randn(2, 3) * 50, rng.randn(2, 3) * 50
        np.testing.assert_array_equal(utils.compose_affine(outer, inner),
                                      jax_utils.compose_affine(outer, inner))
        width = float(rng.uniform(10, 900))
        np.testing.assert_array_equal(utils.hflip_matrix(width), jax_utils.hflip_matrix(width))


FULL_SETTING = dict(SETTING, flip_pairs=[[1, 2], [3, 4]])


def _matrix_states(rng, n=40):
    """Records as they reach topdown_affine_matrix: frames of many sizes,
    boxes on and off them, rotations, flips deferred or not."""
    for i in range(n):
        h, w = int(rng.randint(60, 500)), int(rng.randint(60, 500))
        yield {
            "image": rng.randint(0, 256, (h, w, 3), dtype=np.uint8),
            "center": np.array([rng.uniform(-40, w + 40), rng.uniform(-40, h + 40)], np.float32),
            "scale": rng.uniform(0.2, 3.0, 2).astype(np.float32),
            "rotation": np.float32(rng.uniform(-60, 60) if i % 3 else 0.0),
            "keypoints": np.concatenate([rng.uniform(-20, 520, (5, 2)),
                                         rng.randint(0, 3, (5, 1))], 1).astype(np.float32),
            "hflip": bool(i % 2),
        }


@pytest.mark.parametrize("kwargs", [{}, {"use_udp": True}, {"crop_source_patch": False},
                                    {"patch_margin": 0}, {"patch_margin": 5, "use_udp": True}],
                         ids=str)
def test_topdown_affine_matrix(kwargs):
    """Patch, warp matrix and keypoints bit for bit, from the JAX transform's inputs."""
    port = TopDownAffineMatrix(is_train=True, config=FULL_SETTING, **kwargs)
    jax = JaxTopDownAffineMatrix(is_train=True, config=FULL_SETTING, **kwargs)
    for i, state in enumerate(_matrix_states(np.random.RandomState(22))):
        got, want = port.transform(dict(state)), jax.transform(dict(state))
        assert sorted(got) == sorted(want), i
        for key in want:
            assert got[key].dtype == want[key].dtype, (i, key)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"record {i}: {key}")


@pytest.mark.parametrize("defer", [False, True])
def test_horizontal_flip_deferred_or_not(defer):
    """The same draws, keypoints and center; the deferred flip flags the
    record and leaves its pixels alone, the host flip mirrors them."""
    port = TopDownHorizontalRandomFlip(is_train=True, config=FULL_SETTING, flip_prob=0.5,
                                       defer_to_warp=defer)
    jax = JaxTopDownHorizontalRandomFlip(is_train=True, config=FULL_SETTING, flip_prob=0.5,
                                         defer_to_warp=defer)
    flips = 0
    for i, state in enumerate(_matrix_states(np.random.RandomState(23))):
        state.pop("hflip")
        np.random.seed(200 + i)
        want = jax.transform(dict(state))
        after = np.random.rand()
        np.random.seed(200 + i)
        got = port.transform(dict(state))
        assert np.random.rand() == after
        assert sorted(got) == sorted(want), i
        for key in want:
            if isinstance(want[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i}: {key}")
            else:
                assert got[key] == want[key]
        flips += "hflip" in got or not np.array_equal(got["image"], state["image"])
    assert 0 < flips < 40


def test_decoded_frame_cache():
    """The same hits, misses, evictions and read-only frames over one sequence of calls."""
    rng = np.random.RandomState(24)
    port, jax = DecodedFrameCache(1), JaxDecodedFrameCache(1)
    for step in range(200):
        path = str(rng.randint(12))
        side = int(rng.randint(100, 400))
        frame = np.zeros((side, side, 3), np.uint8)
        got = port.get_or_decode(path, lambda: frame.copy())
        want = jax.get_or_decode(path, lambda: frame.copy())
        assert got.shape == want.shape and not got.flags.writeable, step
        assert (port.hits, port.misses, port._bytes) == (jax.hits, jax.misses, jax._bytes)
        assert list(port._frames) == list(jax._frames)


def test_ms_checkpoint_reader_and_writer(tmp_path):
    rng = np.random.RandomState(25)
    tensors = {"conv.weight": rng.randn(4, 3, 3, 3).astype(np.float32),
               "bn.moving_mean": rng.randn(4).astype(np.float64),
               "steps": np.array(7, np.int32), "mask": rng.rand(5) > 0.5,
               "half": rng.randn(2, 2).astype(np.float16), "empty": np.zeros((0, 3), np.int8)}
    ms_ckpt.write_ms_checkpoint(str(tmp_path / "port.ckpt"), tensors)
    jax_ms_ckpt.write_ms_checkpoint(str(tmp_path / "jax.ckpt"), tensors)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    got = ms_ckpt.read_ms_checkpoint(str(tmp_path / "jax.ckpt"))
    want = jax_ms_ckpt.read_ms_checkpoint(str(tmp_path / "jax.ckpt"))
    assert list(got) == list(want) == list(tensors)
    for key in want:
        assert got[key].dtype == want[key].dtype == tensors[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    (tmp_path / "bad.ckpt").write_bytes(b"")
    for reader in (ms_ckpt.read_ms_checkpoint, jax_ms_ckpt.read_ms_checkpoint):
        with pytest.raises(ValueError, match="no tensors"):
            reader(str(tmp_path / "bad.ckpt"))


def test_normalize_source_keys():
    names = ["backbone.layer1.0.bn1.gamma", "module.layer1.0.down_sample.1.moving_variance",
             "net.conv1.weight", "model.blocks.0.norm1.beta", "last_norm.gamma",
             "layer2.0.bn2.moving_mean", "backbone.module.fc.bias", "pos_embed"]
    state = {k: np.full(2, i, np.float32) for i, k in enumerate(names)}
    got, want = normalize_source_keys(state), jax_normalize_source_keys(state)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_download_helpers(tmp_path):
    import gzip
    import tarfile
    import zipfile

    (tmp_path / "a.txt").write_bytes(b"pose" * 1000)
    assert download.DownLoad.calculate_md5(str(tmp_path / "a.txt")) == (
        jax_download.DownLoad.calculate_md5(str(tmp_path / "a.txt")))
    assert download.get_default_download_root() == jax_download.get_default_download_root()
    with tarfile.open(tmp_path / "a.tar.gz", "w:gz") as tar:
        tar.add(tmp_path / "a.txt", arcname="a.txt")
    with zipfile.ZipFile(tmp_path / "a.zip", "w") as z:
        z.write(tmp_path / "a.txt", arcname="a.txt")
    with gzip.open(tmp_path / "b.txt.gz", "wb") as f:
        f.write(b"gz" * 100)
    for name in ("a.tar.gz", "a.zip", "b.txt.gz"):
        for mod in (download, jax_download):
            out = tmp_path / f"{mod.__name__.split('.')[0]}_{name}"
            out.mkdir()
            mod.DownLoad().extract_archive(str(tmp_path / name), str(out))
        port_files = sorted(p.name for p in (tmp_path / f"mindpose_tpu_torch_{name}").iterdir())
        jax_files = sorted(p.name for p in (tmp_path / f"mindpose_tpu_{name}").iterdir())
        assert port_files == jax_files and port_files
    with pytest.raises(ValueError, match="Unsupported archive"):
        download.DownLoad().extract_archive(str(tmp_path / "a.txt"))


@pytest.mark.parametrize("shape", [(17, 2), (3, 17, 2)])
def test_one_euro_filter(shape):
    rng = np.random.RandomState(12)
    port = smoothing.OneEuroFilter(freq=25.0, min_cutoff=0.5, beta=0.05)
    jax = jax_smoothing.OneEuroFilter(freq=25.0, min_cutoff=0.5, beta=0.05)
    track = np.cumsum(rng.normal(0, 3, (12,) + shape), axis=0)
    for i, frame in enumerate(track):
        dt = 0.07 if i % 5 == 4 else None  # an irregular frame now and then
        np.testing.assert_array_equal(port(frame, dt), jax(frame, dt))
        if i == 7:  # a scene cut, then a new person count
            port.reset()
            jax.reset()
    np.testing.assert_array_equal(port(track[0][:5]), jax(track[0][:5]))
    with pytest.raises(ValueError, match="freq"):
        smoothing.OneEuroFilter(freq=0)


def test_resolve_skeleton(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    from common import skeleton as jax_skeleton

    assert skeleton.COCO_SKELETON == jax_skeleton.COCO_SKELETON
    for setting, joints in (({}, 17), ({}, 16), ({"skeleton": [[0, 1], [2, 15], [3, 20]]}, 16),
                            (None, 17), ({"skeleton": [[-1, 2], [4, 5]]}, 14)):
        args = type("Args", (), {"dataset_setting": setting, "num_joints": joints})
        assert skeleton.resolve_skeleton(args) == jax_skeleton.resolve_skeleton(args)


DIVERGENT_CASES = [
    {},
    {"backbone_setting": {"bn_grad_stats": "fused"}},
    {"backbone_setting": {"bn_stats_frac": 0.25}, "head_setting": {"bn_grad_stats": "frozen"}},
    {"backbone_setting": {"bn_grad_stats": "frozen_var"}},
    {"backbone_setting": {"bn_grad_stats": "frozen"},
     "optimizer_setting": {"radial_projection": True}},
    {"optimizer_setting": {"radial_projection": True}, "allow_divergent_knobs": True},
    {"backbone_setting": None, "optimizer_setting": None},
]


@pytest.mark.parametrize("case", DIVERGENT_CASES)
def test_check_divergent_knobs_is_a_copy(case, caplog):
    """The training entry's gate, ``mindpose_tpu/config.py:23-56``: the same
    source, and on each config the same exit text or the same warnings."""
    import inspect
    import logging
    from types import SimpleNamespace

    from mindpose_tpu.config import check_divergent_knobs as jax_check
    from mindpose_tpu_torch.config import check_divergent_knobs

    assert inspect.getsource(check_divergent_knobs) == inspect.getsource(jax_check)
    outcomes = []
    for check in (jax_check, check_divergent_knobs):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            try:
                check(SimpleNamespace(**case))
                outcomes.append(("passed", [r.getMessage() for r in caplog.records]))
            except SystemExit as e:
                outcomes.append(("exit", str(e)))
    assert outcomes[0] == outcomes[1]
