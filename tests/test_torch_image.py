"""Port's device image ops against mindpose_tpu/ops/image.py on the same inputs.

The warp is the same float32 arithmetic in both (back-projection, floor,
four taps, bilinear blend), but the libraries may fuse or order the
multiply-adds differently: one ulp of a source coordinate near 160 (1.5e-5)
times a step of 255 between neighbouring noise pixels is 4e-3, so crops agree
to 1e-2 on the 0-255 scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.data.transform.utils import get_affine_transform
from mindpose_tpu.ops.image import affine_warp as jax_affine_warp
from mindpose_tpu.ops.image import invert_affine as jax_invert_affine
from mindpose_tpu.ops.image import normalize_image as jax_normalize_image
from mindpose_tpu_torch.ops.image import affine_warp, invert_affine, normalize_image
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)


def _mats(rng, n):
    mats = []
    for _ in range(n):
        center = rng.uniform(20, 140, 2)
        scale = rng.uniform(0.3, 1.2, 2)
        mats.append(get_affine_transform(center, scale, rng.uniform(-40, 40), (48, 64)))
    return np.stack(mats).astype(np.float32)


def test_invert_affine_matches_jax():
    mats = _mats(np.random.RandomState(0), 6)
    want = np.asarray(jax_invert_affine(jnp.asarray(mats)))
    got = invert_affine(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("one_image", [False, True])
def test_affine_warp_matches_jax(one_image):
    rng = np.random.RandomState(1)
    n = 5
    images = rng.randint(0, 256, (1 if one_image else n, 120, 160, 3)).astype(np.uint8)
    if one_image:
        images = np.repeat(images, n, 0)
    mats = _mats(rng, n)
    want = np.asarray(jax_affine_warp(jnp.asarray(images, jnp.float32), jnp.asarray(mats), (64, 48)))
    t = torch.from_numpy(images)
    if one_image:  # the predictor's form: one uint8 image, expanded over the boxes
        t = t[:1].expand(n, *t.shape[1:])
    got = affine_warp(t, torch.from_numpy(mats), (64, 48)).numpy()
    assert got.shape == want.shape == (n, 64, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_normalize_image_matches_jax():
    images = np.random.RandomState(2).uniform(0, 255, (2, 8, 6, 3)).astype(np.float32)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    want = np.asarray(jax_normalize_image(jnp.asarray(images), mean, std))
    got = normalize_image(torch.from_numpy(images), mean, std).numpy()
    np.testing.assert_array_equal(got, want)
