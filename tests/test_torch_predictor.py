"""The port's top-down serving slice against the JAX composition it replaces.

Same image, boxes and weights (a reduced HRNet carried across with the
port's converter) through:
- the port's ``TopDownPredictor`` on the CPU: numpy crop geometry, device
  warp + normalize, forward, decode;
- the JAX chain ``get_affine_transform`` -> ``ops.image.affine_warp`` ->
  ``normalize_image`` -> ``EvalNet.apply``.
Keypoints agree within 1e-3 px wherever a joint's heatmap peak leads the
runner-up by more than 1e-4 (elsewhere float32 summation order may pick the
other peak), and scores within 1e-4.

The JAX ``TopDownPredictor`` crops with cv2.warpAffine, which uses
fixed-point taps (and rounds a uint8 image's crop to uint8). The port's crops
agree with cv2's to the tolerance of tests/data/test_device_ops.py, and its
keypoints with the JAX predictor's to a median of 0.1 px.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.data.transform.topdown_transform import TopDownAffine, TopDownBoxToCenterScale
from mindpose_tpu.engine.predictor import TopDownPredictor as JaxTopDownPredictor
from mindpose_tpu.models.decoders.top_down_decoder import TopDownHeatMapDecoder as JaxDecoder
from mindpose_tpu.models.networks import EvalNet as JaxEvalNet
from mindpose_tpu.models.quantize import quantize_variables, quantized_eval_apply
from mindpose_tpu.ops.image import affine_warp as jax_affine_warp
from mindpose_tpu.ops.image import normalize_image as jax_normalize_image
from mindpose_tpu_torch.engine import TopDownPredictor
from tests.test_torch_hrnet import pair  # noqa: F401  (the reduced HRNet, both packages)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

SETTING = {
    "image_size": [192, 256],
    "heatmap_size": [48, 64],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
    "flip_pairs": [[1, 2]],
    "upper_body_ids": [0, 1],
}
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
DECODER_SETTINGS = [{"shift_coordinate": False}, {"shift_coordinate": True}, {"use_udp": True}]


def _request():
    rng = np.random.RandomState(3)
    image = rng.randint(0, 256, (240, 320, 3)).astype(np.uint8)
    # smooth, so that cv2's uint8 rounding stays small against float sampling
    image = cv2.GaussianBlur(image, (7, 7), 2.0)
    boxes = np.array([[10, 20, 100, 180], [150, 5, 120, 200], [200, 100, 110, 130],
                      [-20, 150, 90, 110], [60, 60, 40, 90]], np.float32)
    return image, boxes


def _jax_composition(jax_net, variables, image, boxes, decoder_setting, quantize=False):
    """JAX's crop, normalize and ``EvalNet.apply``; with ``quantize``, the
    apply of ``quantized_eval_apply`` over ``quantize_variables``'s int8."""
    use_udp = decoder_setting.get("use_udp", False)
    to_cs = TopDownBoxToCenterScale(is_train=False, config=SETTING)
    affine = TopDownAffine(is_train=False, config=SETTING, use_udp=use_udp)
    centers, scales, mats = [], [], []
    for box in boxes:
        cs = to_cs.transform({"boxes": box})
        mats.append(affine._matrix_and_keypoints(dict(cs, rotation=0.0))["_trans"])
        centers.append(cs["center"])
        scales.append(cs["scale"])
    images = np.repeat(image[None], len(boxes), 0)
    crops = jax_affine_warp(jnp.asarray(images), jnp.asarray(np.stack(mats), jnp.float32), (256, 192))
    crops = jax_normalize_image(crops, np.array(MEAN), np.array(STD))
    eval_net = JaxEvalNet(jax_net, JaxDecoder(**decoder_setting), output_raw=True)
    apply = lambda *inputs: eval_net.apply(variables, *inputs)  # noqa: E731
    if quantize:
        apply = quantized_eval_apply(eval_net, quantize_variables(variables))
    (preds, _), heat = apply(crops, jnp.asarray(np.stack(centers)),
                             jnp.asarray(np.stack(scales)), jnp.ones(len(boxes)))
    return np.asarray(preds), np.asarray(heat).transpose(0, 3, 1, 2)  # heat -> NCHW


def _top2_gap(heat):
    flat = np.sort(heat.reshape(*heat.shape[:2], -1), axis=-1)
    return flat[..., -1] - flat[..., -2]


@pytest.mark.parametrize("decoder_setting", DECODER_SETTINGS)
def test_predictor_matches_the_jax_composition(pair, decoder_setting):  # noqa: F811
    jax_net, variables, port, _ = pair
    image, boxes = _request()
    want, heat = _jax_composition(jax_net, variables, image, boxes, decoder_setting)

    predictor = TopDownPredictor(port, SETTING, decoder_setting, MEAN, STD, batch_size=2,
                                 device=torch.device("cpu"))
    got = predictor(image, boxes)
    assert got.shape == (5, 17, 3)

    clear = _top2_gap(heat) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got[..., :2][clear], want[..., :2][clear], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-4, rtol=0)


def test_crops_and_keypoints_near_the_cv2_predictor(pair):  # noqa: F811
    jax_net, variables, port, _ = pair
    image, boxes = _request()
    jax_predictor = JaxTopDownPredictor(jax_net, variables, dataset_setting=SETTING,
                                        decoder_setting={"shift_coordinate": True}, batch_size=4)
    want = jax_predictor(image, boxes)
    predictor = TopDownPredictor(port, SETTING, {"shift_coordinate": True}, MEAN, STD,
                                 device=torch.device("cpu"))
    got = predictor(image, boxes)

    crops, centers, scales = predictor.preprocess(image, boxes)
    for i, box in enumerate(boxes):
        # a float copy of the image, as in test_device_ops: cv2 then skips its uint8 rounding
        state = {"boxes": box, "image": image.astype(np.float32), "rotation": 0.0}
        state.update(TopDownBoxToCenterScale(is_train=False, config=SETTING).transform(state))
        np.testing.assert_array_equal(centers[i].numpy(), state["center"])
        ref = TopDownAffine(is_train=False, config=SETTING).transform(state)["image"]
        crop = crops[i].permute(1, 2, 0).numpy() * (np.array(STD) * 255) + np.array(MEAN) * 255
        # the tolerance of tests/data/test_device_ops.py: interiors match to
        # interpolation tolerance, borders differ by padding mode
        diff = np.abs(ref[2:-2, 2:-2] - crop[2:-2, 2:-2])
        assert diff.mean() < 0.5 and np.median(diff) < 0.1

    dist = np.linalg.norm(got[..., :2] - want[..., :2], axis=-1)
    assert np.median(dist) < 0.1
    assert np.abs(got[..., 2] - want[..., 2]).mean() < 0.5 * np.abs(want[..., 2]).mean()


def test_default_device_is_the_gpu_and_raises_without_cuda(pair, monkeypatch):  # noqa: F811
    # an entry point runs on the card unless the caller asks for the CPU
    port = pair[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopDownPredictor(port, SETTING)
    assert TopDownPredictor(port, SETTING, device="cpu").device == torch.device("cpu")
