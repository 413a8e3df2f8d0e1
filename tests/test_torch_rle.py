"""The port's RLE family against the JAX package's, on the same weights and inputs.

- ``rle_head`` at full width (2048 channels, 8x6 features) against flax
  with the port's converted weights, float32 within 1e-5 of the largest
  output;
- the reduced ResNet of tests/test_torch_simcc.py with the head, end to end
  through ``EvalNet`` and the ``regression`` decoder;
- the decoder (back-projection, ``clip(1 - mean sigma, 0, 1)``) on crafted
  outputs;
- the hflip TTA merge: against the JAX inferencer on the reduced net, and
  on a stub net whose mirrored view must come back to the same coordinates;
- ``rle`` (laplace and gaussian) and its gradients against ``jax.grad`` in
  float64;
- three adamw steps with ``filter_bias_and_bn`` against the JAX step and
  optax, in float64;
- the device targets bit for bit with ``topdown_generate_regression_target``
  (pinned to its original by tests/test_torch_host_copies.py) on the CPU;
- the converter for the head and back, and a JAX adamw TrainState restored;
- resnet50_rle_tpu.yaml through the train (``device_pipeline: true``),
  eval and serving entries on the CPU, with the reduced ResNet, one epoch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.engine.inferencer.regression_inferencer import (
    RegressionInferencer as JaxRegressionInferencer,
)
from mindpose_tpu.models.decoders.regression_decoder import (
    RegressionDecoder as JaxRegressionDecoder,
)
from mindpose_tpu.models.heads import rle_head as jax_rle_head_module
from mindpose_tpu.models.heads.rle_head import RLERegressionHead as JaxRLEHead
from mindpose_tpu.models.loss import rle as jax_rle_loss_module
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.networks import EvalNet as JaxEvalNet
from mindpose_tpu.ops.target import generate_regression_targets as jax_regression_targets
from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
from mindpose_tpu_torch.data.transform.topdown_transform import TopDownGenerateRegressionTarget
from mindpose_tpu_torch.engine import create_inferencer
from mindpose_tpu_torch.models import create_decoder, create_loss
from mindpose_tpu_torch.models.backbones.resnet import ResNet
from mindpose_tpu_torch.models.convert import convert_net_variables, convert_variables, head_mapping
from mindpose_tpu_torch.models.heads import RLERegressionHead
from mindpose_tpu_torch.models.networks import EvalNet, Net
from mindpose_tpu_torch.ops.target import generate_regression_targets
from tests.fixtures import tiny_coco
from tests.test_torch_bottomup_loss import Float64Numpy
from tests.test_torch_simcc import (
    BLOCKS,
    ENTRY_TRAIN_IMAGES,
    FLIP_PAIRS,
    HEAD_RTOL_OF_MAX,
    IMAGE_SIZE,
    MEAN,
    REDUCED_RESNET,
    ROOT,
    RTOL_OF_MAX,
    SETTING,
    STD,
    close,
    converter_round_trip_and_train_state,
    crops,
    fill_head,
    nchw,
    reduced_pair,
    register_reduced_resnet,
    small_crops,
    target_keypoints,
    three_steps_match_jax_float64,
    train_recipe_through_the_entries,
)
from tests.test_torch_train_step import _keypoints

RLE_YAML = os.path.join(ROOT, "configs", "rle", "resnet50_rle_tpu.yaml")


@pytest.fixture(scope="module")
def reduced():
    return reduced_pair(JaxRLEHead(), RLERegressionHead())


def check_preds(got, want, outputs):
    """Coordinates within the outputs' error times the crop's size in pixels
    (``mu`` is in input-size units); scores within the sigmas' error."""
    mu, sigma = (np.asarray(o) for o in outputs)
    tol_mu = RTOL_OF_MAX * float(np.abs(mu).max())
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=1e-6,
                               atol=2 * tol_mu * 200.0 * 3.0)  # scale <= 3.0 in crops()
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0,
                               atol=2 * RTOL_OF_MAX * float(np.abs(sigma).max()))


# ----------------------------------------------------------------- the head


def test_full_width_head_matches_flax_with_converted_weights():
    rng = np.random.RandomState(20)
    jax_head = JaxRLEHead(in_channels=2048, num_joints=17)
    x = rng.standard_normal((2, 8, 6, 2048)).astype(np.float32)
    variables = fill_head(jax_head.init(jax.random.PRNGKey(0), x, train=False), rng, "head")
    want = jax.jit(lambda v, x: jax_head.apply(v, x, train=False))(variables, x)
    head = RLERegressionHead(in_channels=2048, num_joints=17).eval()
    head.load_state_dict(convert_variables(variables, head_mapping(head)), strict=True)
    with torch.no_grad():
        got = head(nchw(x))
    assert [tuple(g.shape) for g in got] == [(2, 17, 2), (2, 17, 2)]
    assert all(g.dtype == torch.float32 for g in got)
    assert 0 < float(got[1].min()) and float(got[1].max()) < 1
    for g, w in zip(got, want):
        close(g.numpy(), w, HEAD_RTOL_OF_MAX)


def test_reduced_net_matches_jax_through_eval_net(reduced):
    jax_net, variables, port = reduced
    rng = np.random.RandomState(21)
    x = rng.standard_normal((4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.float32)
    center, scale, score = crops(rng, 4)
    decoder = create_decoder("regression", input_size=IMAGE_SIZE)
    (want_preds, want_boxes), want_out = jax.jit(
        JaxEvalNet(jax_net, JaxRegressionDecoder(input_size=IMAGE_SIZE)).apply)(
        variables, x, center, scale, score)
    (preds, boxes), out = EvalNet(port, decoder)(
        nchw(x), *(torch.from_numpy(a) for a in (center, scale, score)))
    for g, w in zip(out, want_out):
        close(g.numpy(), w)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), rtol=2e-7)
    check_preds(preds.numpy(), np.asarray(want_preds), want_out)


# -------------------------------------------------------------- the decoder


@pytest.mark.parametrize("to_original", [True, False])
def test_decoder_matches_jax(to_original):
    """mu inside and outside [0, 1]; sigmas whose mean lies above 1 and below
    0 (the score clips), as well as inside."""
    rng = np.random.RandomState(22)
    mu = rng.uniform(-0.2, 1.2, (5, 17, 2)).astype(np.float32)
    sigma = rng.uniform(0, 1, (5, 17, 2)).astype(np.float32)
    sigma[0, :3] = [[1.5, 1.2], [-0.4, -0.1], [0.0, 0.0]]
    center, scale, score = crops(rng, 5)
    want = JaxRegressionDecoder(input_size=IMAGE_SIZE, to_original=to_original)(
        (jnp.asarray(mu), jnp.asarray(sigma)), center, scale, score)
    got = create_decoder("regression", input_size=list(IMAGE_SIZE), to_original=to_original)(
        (torch.from_numpy(mu), torch.from_numpy(sigma)),
        *(torch.from_numpy(a) for a in (center, scale, score)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got[0][0, :3, 2].numpy(), [0.0, 1.0, 1.0])
    if not to_original:
        np.testing.assert_allclose(got[0][..., :2].numpy(), mu * IMAGE_SIZE, rtol=1e-7)


# ------------------------------------------------------------------ the TTA


def test_tta_matches_the_jax_inferencer(reduced):
    jax_net, variables, port = reduced
    rng = np.random.RandomState(23)
    x = rng.standard_normal((4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.float32)
    center, scale, score = crops(rng, 4)
    config = {"hflip_tta": True, "flip_pairs": FLIP_PAIRS}
    jax_decoder = JaxRegressionDecoder(input_size=IMAGE_SIZE)
    forward = JaxRegressionInferencer(JaxEvalNet(jax_net, jax_decoder, output_raw=False),
                                      variables, config=config)._build_forward()
    want_preds, want_boxes = forward(variables, x, center, scale, score)
    inferencer = create_inferencer(
        EvalNet(port, create_decoder("regression", input_size=IMAGE_SIZE), output_raw=False),
        name="regression", config=config, device="cpu")
    preds, boxes, merged = inferencer.infer_batch(
        {"image": x, "center": center, "scale": scale, "bbox_scores": score})
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), rtol=2e-7)
    check_preds(preds.numpy(), np.asarray(want_preds), [m.numpy() for m in merged])


class BrightColumnNet(torch.nn.Module):
    """A stub net: joint 0 at the input's brightest column c, joint 1 at c - 5,
    joint 2 at c + 5 (a left/right pair), all at row 20, as ``mu`` =
    pixel / (W, H); sigma 0.1 for joint 0 and 0.2, 0.4 for the pair, the
    same in either view once the pair swaps."""

    def forward(self, x):
        c = x[:, 0].sum(1).argmax(-1).float()  # [N]
        px = torch.stack([c, c - 5, c + 5], dim=1)
        mu = torch.stack([px / IMAGE_SIZE[0], torch.full_like(px, 20.0 / IMAGE_SIZE[1])], -1)
        flipped = (x[:, 1, 0, 0] > 0)[:, None, None]  # a mark that only the mirrored view has
        sigma = torch.tensor([[0.1, 0.1], [0.2, 0.2], [0.4, 0.4]]).expand_as(mu)
        return mu, torch.where(flipped, sigma[:, [0, 2, 1]], sigma)


def test_tta_brings_the_mirrored_view_back_to_the_same_coordinates():
    x = np.zeros((2, IMAGE_SIZE[1], IMAGE_SIZE[0], 3), np.float32)
    x[0, :, 17, 0], x[1, :, 30, 0] = 1.0, 1.0
    x[:, 0, -1, 1] = 1.0  # at the last column: column 0 once mirrored
    center, scale, score = crops(np.random.RandomState(24), 2)
    decoder = create_decoder("regression", input_size=IMAGE_SIZE, to_original=False)
    config = {"hflip_tta": True, "flip_pairs": [[1, 2]]}
    inferencer = create_inferencer(EvalNet(BrightColumnNet(), decoder, output_raw=False),
                                   name="regression", config=config, device="cpu")
    preds, _, (mu, sigma) = inferencer.infer_batch(
        {"image": x, "center": center, "scale": scale, "bbox_scores": score})
    want = np.array([[[c, 20.0], [c - 5, 20.0], [c + 5, 20.0]] for c in (17.0, 30.0)])
    np.testing.assert_allclose(preds[..., :2].numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), [[[0.1, 0.1], [0.2, 0.2], [0.4, 0.4]]] * 2,
                               rtol=1e-7)


# ------------------------------------------------------------------- the loss


@pytest.fixture
def jax_float64(monkeypatch):
    """The JAX RLE head's and loss's float32 casts read as float64."""
    monkeypatch.setattr(jax_rle_head_module, "jnp", Float64Numpy())
    monkeypatch.setattr(jax_rle_loss_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("q_distribution", ["laplace", "gaussian"])
@pytest.mark.parametrize("use_target_weight", [True, False])
def test_rle_loss_and_its_gradients_match_jax_float64(jax_float64, q_distribution,
                                                      use_target_weight):
    rng = np.random.RandomState(25)
    mu = rng.uniform(-0.2, 1.2, (3, 7, 2))
    sigma = rng.uniform(0.01, 1.0, (3, 7, 2))
    sigma[0, 0] = 0.0  # eps keeps the log finite
    target, weight = generate_regression_targets(
        torch.from_numpy(_keypoints(rng, 3, 7, w=48.0, h=64.0)), IMAGE_SIZE)
    target, weight = target.double().numpy(), weight.double().numpy() * 0.7
    kwargs = dict(use_target_weight=use_target_weight, q_distribution=q_distribution)
    want, (gmu, gsigma) = jax.value_and_grad(
        lambda p: jax_create_loss("rle", **kwargs)(p, target, weight))(
        (jnp.asarray(mu), jnp.asarray(sigma)))
    tmu, tsigma = torch.from_numpy(mu).requires_grad_(), torch.from_numpy(sigma).requires_grad_()
    got = create_loss("rle", **kwargs)((tmu, tsigma), torch.from_numpy(target),
                                       torch.from_numpy(weight))
    got.backward()
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(tmu.grad.numpy(), np.asarray(gmu), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tsigma.grad.numpy(), np.asarray(gsigma), rtol=1e-12, atol=1e-15)


def test_rle_loss_refuses_an_unknown_distribution():
    pred = (torch.zeros(1, 2, 2), torch.ones(1, 2, 2))
    with pytest.raises(ValueError, match="q_distribution"):
        create_loss("rle", q_distribution="cauchy")(pred, torch.zeros(1, 2, 2))


# ------------------------------------------------------------------ the step


def test_three_adamw_steps_match_jax_float64(reduced, jax_float64):
    _, variables, _ = reduced
    rng = np.random.RandomState(26)
    image = rng.randint(0, 256, (4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.uint8)
    kpts = _keypoints(rng, 4, w=float(IMAGE_SIZE[0]), h=float(IMAGE_SIZE[1]))
    pp = build_topdown_preprocess(IMAGE_SIZE, (12, 16), MEAN, STD, target_type="regression")
    batch = tuple(t.double() for t in pp(torch.from_numpy(image), torch.from_numpy(kpts)))
    assert batch[1].shape == (4, 17, 2) and batch[2].sum() > 10
    port = Net(ResNet(BLOCKS), RLERegressionHead())
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
    three_steps_match_jax_float64(variables, JaxRLEHead(dtype=jnp.float64), port, batch, "rle",
                                  {"use_target_weight": True, "q_distribution": "laplace"})


# --------------------------------------------------------------- the targets


def test_device_targets_are_the_host_transform_s_bit_for_bit():
    """The device targets on the CPU against ``topdown_generate_regression_target``
    (pinned to its original by tests/test_torch_host_copies.py), bit for bit."""
    kpts = target_keypoints(np.random.RandomState(27), 6)
    host = [TopDownGenerateRegressionTarget(config=SETTING).transform({"keypoints": k})
            for k in kpts]
    target, weight = generate_regression_targets(torch.from_numpy(kpts),
                                                 tuple(SETTING["image_size"]))
    np.testing.assert_array_equal(target.numpy(), np.stack([h["target"] for h in host]))
    np.testing.assert_array_equal(weight.numpy(), np.stack([h["target_weight"] for h in host]))
    assert 0 < weight.sum() < weight.numel()
    # JAX's device targets: its weights, and its division by a constant as a
    # multiply by the reciprocal (an ulp apart)
    jax_t, jax_w = jax_regression_targets(jnp.asarray(kpts), tuple(SETTING["image_size"]))
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jax_w))
    np.testing.assert_allclose(target.numpy(), np.asarray(jax_t), rtol=2e-7, atol=0)


# -------------------------------------------------- converter and checkpoints


def test_converter_round_trip_and_jax_train_state(reduced, tmp_path):
    _, variables, _ = reduced
    converter_round_trip_and_train_state(variables, RLERegressionHead(), tmp_path)


# ------------------------------------------------------------------ the entries


def test_rle_recipe_trains_with_device_targets_evaluates_and_serves(tmp_path):
    """resnet50_rle_tpu.yaml as parsed (hflip TTA on) with ``device_pipeline:
    true`` and the reduced ResNet on 64x48 crops of tiny COCO."""
    register_reduced_resnet()
    root = str(tmp_path)
    data = (tiny_coco.write_split(os.path.join(root, "train"), ENTRY_TRAIN_IMAGES,
                                  tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))
    result, args = train_recipe_through_the_entries(RLE_YAML, root, data, dict(
        backbone_name=REDUCED_RESNET, device_pipeline=True,
        dataset_setting=small_crops(RLE_YAML, IMAGE_SIZE, (12, 16)),
        decoder_setting={"input_size": list(IMAGE_SIZE)}))
    assert args.device_pipeline is True and args.eval_setting["hflip_tta"]
    assert args.loss_setting == {"use_target_weight": True, "q_distribution": "laplace"}
    assert "AP" in result["epochs"][0]["metrics"]
