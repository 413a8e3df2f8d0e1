"""The port's copies of the JAX package's numpy host helpers stay equal to them.

The port cannot import ``mindpose_tpu`` (its ``__init__`` imports JAX), so
the crop geometry, the joints' flip permutation and the DARK refinement's
Gaussian kernel live in the port as copies; these tests pin each copy to
its original, bit for bit. They also pin chip_smoke.py's config literal to
configs/hrnet/hrnet_w32_tpu.yaml, so the GPU machine needs no yaml parser.
"""
import os

import numpy as np
import pytest
import yaml

from mindpose_tpu.data.transform import utils as jax_utils
from mindpose_tpu.data.transform.topdown_transform import TopDownAffine, TopDownBoxToCenterScale
from mindpose_tpu.ops.heatmap import gaussian_kernel_2d as jax_gaussian_kernel_2d
from mindpose_tpu_torch.data.transform import utils
from mindpose_tpu_torch.data.transform.topdown_transform import box_to_center_scale, crop_matrix
from mindpose_tpu_torch.ops.heatmap import gaussian_kernel_2d

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


@pytest.mark.parametrize("size", [3, 5, 7, 10, 11, 17])
def test_gaussian_kernel_2d(size):
    want = jax_gaussian_kernel_2d(size)
    got = gaussian_kernel_2d(size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
