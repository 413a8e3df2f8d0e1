"""The port's bottomup_heatmap_ae decoder and resize helpers against the JAX package's.

Both decoders get the same seeded float32 model outputs (NCHW for the port,
NHWC for JAX) and the same validity mask. The maps and the candidates'
values agree within ``ATOL``: the bilinear resizes and the level average
round differently in the two libraries (measured: below 5e-7). The top-K
order is exact: the port sorts stably in descending order, so ties (most of
an NMS'd heatmap is exactly 0) go to the lower flat index, as
``jax.lax.top_k`` gives them; so ``ind_k`` equals JAX's everywhere and
``tag_k`` within ``ATOL`` everywhere, not only where ``val_k`` passes
``vis_thr``. Cases: NMS on and off (k = 3, 5 and the even 4), the
quarter-pixel shift on and off, 1 and 2 stages, per-joint and shared tags,
and a mask whose size is not a multiple of the heatmap's (the nearest
resize downsamples by 2.5 and 2.2).

``resize_bilinear`` is ``jax.image.resize(method="bilinear")``, antialiased
where it downsamples, within 1e-6 (up, down, non-integer factors);
``resize_nearest`` equals ``jax.image.resize(method="nearest")`` exactly.
"""
import jax
import numpy as np
import pytest
import torch

from mindpose_tpu.models.common import resize_bilinear as jax_resize_bilinear
from mindpose_tpu.models.common import resize_nearest as jax_resize_nearest
from mindpose_tpu.models.decoders.bottom_up_decoder import (
    BottomUpHeatMapAEDecoder as JaxDecoder,
)
from mindpose_tpu_torch.models import create_decoder
from mindpose_tpu_torch.models.common import resize_bilinear, resize_nearest

ATOL = 2e-6
K = 17


def _outputs(rng, n, h, w, num_stages, tag_per_joint):
    """Seeded outputs: level 0 [N, K + K_tag, h, w], level 1 [N, K, 2h, 2w];
    heatmaps in [0, 1) with a few peaks, tags O(1)."""
    kt = K if tag_per_joint else 1
    outs = [np.concatenate([rng.uniform(0, 0.3, (n, K, h, w)) ** 2,
                            rng.normal(0, 2, (n, kt, h, w))], axis=1)]
    if num_stages == 2:
        outs.append(rng.uniform(0, 0.3, (n, K, 2 * h, 2 * w)) ** 2)
    for out in outs:
        peaks = rng.randint(0, out.shape[2] * out.shape[3], (n, K, 4))
        flat = out[:, :K].reshape(n, K, -1)
        np.put_along_axis(flat, peaks, rng.uniform(0.5, 1.0, peaks.shape), axis=2)
    return [o.astype(np.float32) for o in outs]


def _mask(n, height, width):
    mask = np.zeros((n, height, width), np.uint8)
    mask[0, : height * 3 // 4, : width - 7] = 1
    mask[1:, :, : width * 2 // 3] = 1
    return mask


CASES = [
    # (num_stages, use_nms, nms_kernel, shift_coordinate, tag_per_joint)
    (2, True, 3, False, True),  # higher_hrnet_w32_tpu.yaml
    (2, True, 5, True, True),
    (2, False, 5, False, True),
    (2, False, 5, True, True),
    (1, True, 3, True, True),
    (1, True, 4, False, True),
    (2, True, 3, True, False),
]


@pytest.mark.parametrize("num_stages,use_nms,nms_kernel,shift,tag_per_joint", CASES)
def test_decoder_matches_jax(num_stages, use_nms, nms_kernel, shift, tag_per_joint):
    rng = np.random.RandomState(num_stages * 100 + nms_kernel * 10 + shift + use_nms * 3)
    h, w = 12, 10
    outs = _outputs(rng, 2, h, w, num_stages, tag_per_joint)
    size = 2 * h if num_stages == 2 else h
    # a mask whose size is no multiple of the heatmap's (2.5x, 2.2x at 2 stages)
    mask = _mask(2, int(size * 2.5), int((size * w // h) * 2.2))
    setting = dict(num_joints=K, num_stages=num_stages, with_ae_loss=(True, False)[:num_stages],
                   use_nms=use_nms, nms_kernel=nms_kernel, max_num=30,
                   tag_per_joint=tag_per_joint, shift_coordinate=shift)
    want = jax.jit(lambda o, m: JaxDecoder(**setting)(o, m))(
        [o.transpose(0, 2, 3, 1) for o in outs], mask)
    want = [np.asarray(x) for x in want]
    decoder = create_decoder("bottomup_heatmap_ae", **setting)
    got = decoder([torch.from_numpy(o) for o in outs], torch.from_numpy(mask))
    val_k, tag_k, ind_k, heatmap, tagging = got
    for t in (val_k, tag_k, ind_k):
        assert t.dtype == torch.float32 and t.is_contiguous()
    assert val_k.shape == (2, K, 30) and tag_k.shape == (2, K, 30, 1)
    assert ind_k.shape == (2, K, 30, 2)
    heatmap, tagging = decoder.maps_to_nhwc(heatmap, tagging)
    np.testing.assert_allclose(heatmap.numpy(), want[3], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tagging.numpy(), want[4], atol=ATOL, rtol=0)
    np.testing.assert_allclose(val_k.numpy(), want[0], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ind_k.numpy(), want[2])
    np.testing.assert_allclose(tag_k.numpy(), want[1], atol=ATOL, rtol=0)
    assert (want[0] > 0.1).sum() > 2 * K  # candidates that group
    if use_nms:
        assert (want[0] == 0).any()  # ties at 0 decided as top_k decides them


@pytest.mark.parametrize("src,dst", [((8, 6), (16, 12)), ((16, 12), (8, 6)),
                                     ((16, 12), (7, 5)), ((5, 7), (13, 11)),
                                     ((20, 20), (20, 20))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(sum(src + dst)).standard_normal((2, 3) + src).astype(np.float32)
    want = np.asarray(jax_resize_bilinear(x.transpose(0, 2, 3, 1), *dst))
    got = resize_bilinear(torch.from_numpy(x), *dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,dst", [((832, 832), (416, 416)), ((832, 512), (416, 256)),
                                     ((75, 55), (30, 25)), ((9, 7), (27, 21))])
def test_resize_nearest_of_a_mask_matches_jax(src, dst):
    x = (np.random.RandomState(1).uniform(0, 1, (2, 1) + src) > 0.5).astype(np.float32)
    want = np.asarray(jax_resize_nearest(x.transpose(0, 2, 3, 1), *dst))
    got = resize_nearest(torch.from_numpy(x), *dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
