"""The port's SimCC family against the JAX package's, on the same weights and inputs.

- ``simcc_head`` at full width (2048 channels, 8x6 features, 384 and 512
  bins) against flax with the port's converted weights, float32 within
  1e-5 of the largest logit;
- a reduced ResNet (one bottleneck per stage, full width) with the head,
  end to end through ``EvalNet`` and the ``simcc`` decoder: logits within
  ``RTOL_OF_MAX``, every joint whose softmax peak is clear decoded alike;
- the decoder on planted logits: a softmax tie, where the first bin wins
  (the logits' own argmax is the later one), and the score;
- the hflip TTA merge: against the JAX inferencer on the reduced net, and
  on a stub net whose mirrored view must come back to the same bins;
- ``kl_discret`` and its gradients against ``jax.grad`` in float64;
- three adamw steps with ``filter_bias_and_bn`` against the JAX step and
  optax, in float64 (the decay mask on the Linear weights and biases);
- the device targets against ``topdown_generate_simcc_target`` (pinned to
  its original by tests/test_torch_host_copies.py) on the CPU, and the
  device preprocess of both new target types against the JAX package's;
- the converter for the head and back, and a JAX adamw TrainState of the
  reduced net restored into the port;
- resnet50_simcc_tpu.yaml through the train, eval and serving entries on
  the CPU, with the reduced ResNet, one epoch.

The reduced ResNet, its JAX twin and the float64 step are shared with
tests/test_torch_rle.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from mindpose_tpu.data.device_pipeline import build_topdown_preprocess as jax_build_preprocess
from mindpose_tpu.engine.inferencer.simcc_inferencer import SimCCInferencer as JaxSimCCInferencer
from mindpose_tpu.models.backbones.resnet import ResNet as JaxResNet
from mindpose_tpu.models.decoders.simcc_decoder import SimCCDecoder as JaxSimCCDecoder
from mindpose_tpu.models.heads import simcc_head as jax_simcc_head_module
from mindpose_tpu.models.heads.simcc_head import SimCCHead as JaxSimCCHead
from mindpose_tpu.models.loss import simcc as jax_simcc_loss_module
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.networks import EvalNet as JaxEvalNet
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.ops.target import generate_simcc_targets as jax_simcc_targets
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel.train import build_train_step as jax_build_train_step
from mindpose_tpu.parallel.train import create_train_state
from mindpose_tpu.scheduler.schedulers import create_lr_scheduler as jax_create_scheduler
from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
from mindpose_tpu_torch.data.transform.topdown_transform import (
    TopDownGenerateRegressionTarget,
    TopDownGenerateSimCCTarget,
)
from mindpose_tpu_torch.engine import create_inferencer
from mindpose_tpu_torch.models import (
    create_decoder,
    create_loss,
    create_network,
    create_network_with_loss,
)
from mindpose_tpu_torch.models.backbones.resnet import ResNet
from mindpose_tpu_torch.models.convert import (
    convert_net_variables,
    convert_variables,
    export_variables,
    head_mapping,
    net_mapping,
)
from mindpose_tpu_torch.models.heads import SimCCHead
from mindpose_tpu_torch.models.networks import EvalNet, Net
from mindpose_tpu_torch.ops.target import generate_simcc_targets
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.register import list_components, register
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.tools import serve as port_serve
from mindpose_tpu_torch.tools import train as port_train
from mindpose_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state
from tests.fixtures import tiny_coco
from tests.test_torch_bottomup_loss import Float64Numpy
from tests.test_torch_simple_baseline import _randomize
from tests.test_torch_train_step import _as, _keypoints
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMCC_YAML = os.path.join(ROOT, "configs", "simcc", "resnet50_simcc_tpu.yaml")
BLOCKS = (1, 1, 1, 1)
IMAGE_SIZE = (48, 64)  # (W, H): the reduced ResNet's 2x2 map, 96 and 128 bins
FEATURE_SIZE = (2, 2)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
# float32 on both sides, convolutions and products summed in other orders:
# each output within this fraction of its largest |value| (as
# tests/test_torch_simple_baseline.py holds the same ResNet)
RTOL_OF_MAX = 2e-5
HEAD_RTOL_OF_MAX = 1e-5  # the head alone: a 1x1 conv and two products
# float64 on both sides, the float32 casts of the JAX head and loss lifted
F64_RTOL = 1e-6
# resnet50_simcc_tpu.yaml's optimizer (adamw, weight decay 0.05 off biases and norms)
OPTIMIZER = dict(name="adamw", weight_decay=0.05, filter_bias_and_bn=True)
REDUCED_RESNET = "resnet_reduced_test"
ENTRY_TRAIN_IMAGES = 8  # 16 records: one step of 16


def close(got, want, rtol_of_max=RTOL_OF_MAX, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_of_max * float(np.abs(want).max()),
                               err_msg=err_msg)


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()


def fill_head(variables, rng, head: str):
    """The head's leaves drawn from ``rng``: kernels with variance 1 / fan_in,
    biases 0.1 sd (flax initializes biases at 0, which would hide a bias the
    converter drops)."""
    variables = unfreeze(jax.device_get(variables))

    def fill(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                fill(value)
            elif key == "kernel":
                fan_in = int(np.prod(value.shape[:-1]))
                tree[key] = (rng.standard_normal(value.shape) / np.sqrt(fan_in)).astype(np.float32)
            else:
                tree[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)

    fill(variables["params"][head] if head in variables["params"] else variables["params"])
    return variables


def crops(rng, n):
    """Centers, scales and box scores of ``n`` crops, float32."""
    return (rng.uniform(50, 600, (n, 2)).astype(np.float32),
            rng.uniform(0.3, 3.0, (n, 2)).astype(np.float32),
            rng.uniform(0.2, 1.0, n).astype(np.float32))


def register_reduced_resnet() -> None:
    """The reduced ResNet in the port's registry (once), for the entries."""
    if REDUCED_RESNET in list_components("backbone"):
        return

    def resnet_reduced_test(pretrained=False, ckpt_url="", in_channels=3, **kwargs):
        return ResNet(BLOCKS, in_channels=in_channels)

    register("backbone", extra_name=REDUCED_RESNET)(resnet_reduced_test)


def reduced_pair(jax_head, port_head, head_scope_rng=1):
    """(JAX net, variables, port net with the same weights) of the reduced
    ResNet with ``jax_head`` / ``port_head``: randomized BatchNorm, a head
    drawn from a numpy seed."""
    jax_net = JaxNet(backbone=JaxResNet(block_counts=BLOCKS), head=jax_head)
    init = jax.jit(lambda key, x: jax_net.init(key, x, train=False))
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)))
    variables = _randomize(variables, np.random.RandomState(0))
    variables = fill_head(variables, np.random.RandomState(head_scope_rng), "head")
    port = Net(ResNet(BLOCKS), port_head)
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
    return jax_net, variables, port


@pytest.fixture(scope="module")
def reduced():
    return reduced_pair(JaxSimCCHead(input_size=IMAGE_SIZE),
                        SimCCHead(input_size=IMAGE_SIZE, feature_size=FEATURE_SIZE))


def check_preds(got, want, clear, tol):
    """Joints whose peaks are ``clear`` decode to the same coordinates (up to
    the back-projection's float32 rounding); every score, a softmax peak,
    within ``2 tol`` relative (the logits' error ``tol`` through exp)."""
    np.testing.assert_allclose(got[..., :2][clear], want[..., :2][clear], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=2 * tol, atol=0)


def clear_joints(logits, margin):
    """[N, K]: True where the softmax's top bin leads its runner-up by more than
    ``margin`` on both axes, so that logits that close can not decode apart."""
    out = None
    for t in logits:
        top2 = torch.topk(torch.softmax(torch.from_numpy(np.array(t)), -1), 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).numpy() > margin
        out = gap if out is None else out & gap
    return out


# ----------------------------------------------------------------- the head


def test_full_width_head_matches_flax_with_converted_weights():
    rng = np.random.RandomState(0)
    jax_head = JaxSimCCHead(in_channels=2048, num_joints=17, input_size=(192, 256),
                            split_ratio=2.0)
    x = rng.standard_normal((2, 8, 6, 2048)).astype(np.float32)
    variables = fill_head(jax_head.init(jax.random.PRNGKey(0), x, train=False), rng, "head")
    want = jax.jit(lambda v, x: jax_head.apply(v, x, train=False))(variables, x)
    head = SimCCHead(in_channels=2048, num_joints=17, input_size=(192, 256), split_ratio=2.0,
                     feature_size=(8, 6)).eval()
    head.load_state_dict(convert_variables(variables, head_mapping(head)), strict=True)
    with torch.no_grad():
        got = head(nchw(x))
    assert [tuple(g.shape) for g in got] == [(2, 17, 384), (2, 17, 512)]
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        close(g.numpy(), w, HEAD_RTOL_OF_MAX)


def test_head_needs_its_feature_size_and_the_factory_traces_it():
    with pytest.raises(ValueError, match="feature_size"):
        SimCCHead(in_channels=8)
    with torch.device("meta"):
        net = create_network("resnet50", "simcc_head",
                             head_args={"input_size": [192, 256], "split_ratio": 2.0})
    assert (net.head.mlp_x.in_features, net.head.mlp_x.out_features) == (48, 384)
    assert (net.head.mlp_y.in_features, net.head.mlp_y.out_features) == (48, 512)


def test_reduced_net_matches_jax_through_eval_net(reduced):
    jax_net, variables, port = reduced
    rng = np.random.RandomState(2)
    x = rng.standard_normal((4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.float32)
    center, scale, score = crops(rng, 4)
    decoder = create_decoder("simcc", input_size=IMAGE_SIZE, split_ratio=2.0, sigma=6.0)
    jax_decoder = JaxSimCCDecoder(input_size=IMAGE_SIZE, split_ratio=2.0, sigma=6.0)
    (want_preds, want_boxes), want_logits = jax.jit(JaxEvalNet(jax_net, jax_decoder).apply)(
        variables, x, center, scale, score)
    (preds, boxes), logits = EvalNet(port, decoder)(
        nchw(x), *(torch.from_numpy(a) for a in (center, scale, score)))
    for g, w in zip(logits, want_logits):
        close(g.numpy(), w)
    # the area, a product of two products, may round apart in its last bit
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), rtol=2e-7)
    tol = RTOL_OF_MAX * max(float(np.abs(w).max()) for w in want_logits)
    clear = clear_joints(want_logits, 4 * tol)
    assert clear.mean() > 0.9
    check_preds(preds.numpy(), np.asarray(want_preds), clear, tol)


# -------------------------------------------------------------- the decoder


def test_decoder_takes_the_first_bin_of_a_softmax_tie():
    """Logits a rounding apart below 0.25 are equal after the softmax (exp of
    -1.5e-8 rounds to 1): JAX and the port take the first bin, where the
    logits' own argmax is the later one. Scores and the back-projection as JAX's."""
    rng = np.random.RandomState(3)
    xl = rng.uniform(-3, -1, (3, 17, 96)).astype(np.float32)
    yl = rng.uniform(-3, -1, (3, 17, 128)).astype(np.float32)
    a = np.float32(0.2)
    xl[0, 0, 10], xl[0, 0, 40] = a, np.nextafter(a, np.float32(1))
    yl[1, 5, 7], yl[1, 5, 100] = a, np.nextafter(a, np.float32(1))
    assert np.argmax(xl[0, 0]) == 40 and np.argmax(yl[1, 5]) == 100
    center, scale, score = crops(rng, 3)
    for kwargs in ({"to_original": True}, {"to_original": False}):
        want = JaxSimCCDecoder(input_size=IMAGE_SIZE, **kwargs)(
            (jnp.asarray(xl), jnp.asarray(yl)), center, scale, score)
        got = create_decoder("simcc", input_size=list(IMAGE_SIZE), **kwargs)(
            (torch.from_numpy(xl), torch.from_numpy(yl)),
            *(torch.from_numpy(a) for a in (center, scale, score)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-4)
    preds = got[0].numpy()
    assert preds[0, 0, 0] == 10 / 2.0 and preds[1, 5, 1] == 7 / 2.0  # bins over split_ratio
    px = torch.softmax(torch.from_numpy(xl), -1).amax(-1)
    py = torch.softmax(torch.from_numpy(yl), -1).amax(-1)
    np.testing.assert_allclose(preds[..., 2], (torch.minimum(px, py) * 6.0
                                               * np.sqrt(2 * np.pi)).numpy(), rtol=1e-6)


# ------------------------------------------------------------------ the TTA


def test_tta_matches_the_jax_inferencer(reduced):
    jax_net, variables, port = reduced
    rng = np.random.RandomState(4)
    x = rng.standard_normal((4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.float32)
    center, scale, score = crops(rng, 4)
    config = {"hflip_tta": True, "flip_pairs": FLIP_PAIRS}
    decoder = create_decoder("simcc", input_size=IMAGE_SIZE, split_ratio=2.0)
    jax_decoder = JaxSimCCDecoder(input_size=IMAGE_SIZE, split_ratio=2.0)
    forward = JaxSimCCInferencer(JaxEvalNet(jax_net, jax_decoder, output_raw=False),
                                 variables, config=config)._build_forward()
    want_preds, want_boxes = forward(variables, x, center, scale, score)
    inferencer = create_inferencer(EvalNet(port, decoder, output_raw=False), name="simcc",
                                   config=config, device="cpu")
    preds, boxes, merged = inferencer.infer_batch(
        {"image": x, "center": center, "scale": scale, "bbox_scores": score})
    # the area, a product of two products, may round apart in its last bit
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), rtol=2e-7)
    # the merged log-softmaxes are as close as the logits; their peaks decide
    tol = RTOL_OF_MAX * max(float(m.abs().max()) for m in merged)
    clear = clear_joints([m.numpy() for m in merged], 4 * tol)
    assert clear.mean() > 0.9
    check_preds(preds.numpy(), np.asarray(want_preds), clear, tol)


class BrightColumnNet(torch.nn.Module):
    """A stub net: joint 0 at the input's brightest column c and at row 20,
    joint 1 at c - 5, joint 2 at c + 5 (a left/right pair); each axis's
    logits a Gaussian over the bins centred at the pixel times ``ratio``."""

    def __init__(self, ratio: float, size=IMAGE_SIZE):
        super().__init__()
        self.ratio, self.size = ratio, size

    def forward(self, x):
        c = x[:, 0].sum(1).argmax(-1).float()  # [N]
        px = torch.stack([c, c - 5, c + 5], dim=1)  # [N, 3]
        py = torch.full_like(px, 20.0)
        bx = torch.arange(int(self.size[0] * self.ratio), dtype=torch.float32)
        by = torch.arange(int(self.size[1] * self.ratio), dtype=torch.float32)
        return (-((bx - px[..., None] * self.ratio) ** 2) / 8.0,
                -((by - py[..., None] * self.ratio) ** 2) / 8.0)


@pytest.mark.parametrize("ratio", [2.0, 3.0, 1.0])
def test_tta_brings_the_mirrored_view_back_to_the_same_bins(ratio):
    """On the stub net the mirrored crop's joints land on the mirrored columns;
    swapped, reversed and shifted by round(ratio) - 1 bins they come back to
    the original's bins, so the merge decodes the original joints."""
    x = np.zeros((2, IMAGE_SIZE[1], IMAGE_SIZE[0], 3), np.float32)
    x[0, :, 17, 0], x[1, :, 30, 0] = 1.0, 1.0
    center, scale, score = crops(np.random.RandomState(5), 2)
    decoder = create_decoder("simcc", input_size=IMAGE_SIZE, split_ratio=ratio, sigma=2.0,
                             to_original=False)
    config = {"hflip_tta": True, "flip_pairs": [[1, 2]]}
    inferencer = create_inferencer(EvalNet(BrightColumnNet(ratio), decoder, output_raw=False),
                                   name="simcc", config=config, device="cpu")
    preds, _, _ = inferencer.infer_batch(
        {"image": x, "center": center, "scale": scale, "bbox_scores": score})
    want = np.array([[[c, 20.0], [c - 5, 20.0], [c + 5, 20.0]] for c in (17.0, 30.0)])
    np.testing.assert_array_equal(preds[..., :2].numpy(), want)
    no_tta = create_inferencer(EvalNet(BrightColumnNet(ratio), decoder, output_raw=False),
                               name="simcc", config=dict(config, hflip_tta=False), device="cpu")
    np.testing.assert_array_equal(no_tta.infer_batch(
        {"image": x, "center": center, "scale": scale, "bbox_scores": score})[0][..., :2].numpy(),
        want)


# ------------------------------------------------------------------- the loss


@pytest.fixture
def jax_float64(monkeypatch):
    """The JAX SimCC head's and loss's float32 casts read as float64."""
    monkeypatch.setattr(jax_simcc_head_module, "jnp", Float64Numpy())
    monkeypatch.setattr(jax_simcc_loss_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        yield


def simcc_batch(rng, n=3, k=7, bx=96, by=128):
    xl = rng.standard_normal((n, k, bx))
    yl = rng.standard_normal((n, k, by))
    kpts = _keypoints(rng, n, k, w=bx / 2.0, h=by / 2.0)
    target, weight = generate_simcc_targets(torch.from_numpy(kpts), (bx // 2, by // 2))
    weight = weight * torch.from_numpy(rng.uniform(0.5, 1.5, (n, k)).astype(np.float32))
    return xl, yl, target.double().numpy(), weight.double().numpy()


@pytest.mark.parametrize("use_target_weight", [True, False])
def test_kl_discret_and_its_gradients_match_jax_float64(jax_float64, use_target_weight):
    xl, yl, target, weight = simcc_batch(np.random.RandomState(6))
    assert weight.min() == 0 and target.max() > 0.01
    loss = create_loss("kl_discret", use_target_weight=use_target_weight)
    jax_loss = jax_create_loss("kl_discret", use_target_weight=use_target_weight)
    want, (gx, gy) = jax.value_and_grad(lambda p: jax_loss(p, target, weight))(
        (jnp.asarray(xl), jnp.asarray(yl)))
    txl, tyl = torch.from_numpy(xl).requires_grad_(), torch.from_numpy(yl).requires_grad_()
    got = loss((txl, tyl), torch.from_numpy(target), torch.from_numpy(weight))
    got.backward()
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(txl.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-15)
    np.testing.assert_allclose(tyl.grad.numpy(), np.asarray(gy), rtol=0, atol=1e-15)


def test_kl_discret_is_float32_for_bf16_logits():
    xl, yl, target, weight = simcc_batch(np.random.RandomState(7))
    pred = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (xl, yl))
    got = create_loss("kl_discret")(pred, torch.from_numpy(target).float(),
                                    torch.from_numpy(weight).float())
    want = jax_create_loss("kl_discret")(tuple(jnp.asarray(p.float().numpy(), jnp.bfloat16)
                                               for p in pred), target.astype(np.float32),
                                         weight.astype(np.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ------------------------------------------------------------------ the step


def schedule_kwargs():
    # the recipe's lr and milestones, warmup shortened to 2
    return dict(lr=1e-3, total_epochs=210, steps_per_epoch=1, warmup=2, milestones=[170, 200])


def three_steps_match_jax_float64(variables, jax_head64, port_net, batch, loss_name,
                                  loss_setting):
    """The recipe's adamw (weight decay 0.05 off biases and norms) and schedule
    (warmup 2) for 3 steps on one batch, the port's step against the JAX
    package's, both in float64 from the same weights: the losses, then the
    parameters and running statistics within ``F64_RTOL`` of each tensor's
    largest entry (a gradient or a decay mask apart would move a tensor
    O(lr) apart). Every parameter moves, and the head's Linear weights decay
    where its biases do not, as the JAX package's mask has it."""
    net = port_net.double()
    nwl = create_network_with_loss(net, create_loss(loss_name, **loss_setting),
                                   has_extra_inputs=True)
    optimizer = create_optimizer(net, **OPTIMIZER)
    group_of = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    head = [(n, group_of[id(p)]["weight_decay"]) for n, p in net.named_parameters()
            if n.startswith("head.")]
    assert head and all((decay > 0) == n.endswith("weight") for n, decay in head), head
    schedule = create_lr_scheduler("warmup_multi_step_decay", **schedule_kwargs())
    step = build_train_step(nwl, optimizer, schedule)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}

    def near(got, want, name):
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= F64_RTOL * scale, name

    jax_net = JaxNet(backbone=JaxResNet(block_counts=BLOCKS, dtype=jnp.float64), head=jax_head64)
    nwl_j = jax_create_nwl(jax_net, jax_create_loss(loss_name, **loss_setting),
                           has_extra_inputs=True)
    variables64 = {"params": _as(variables["params"], jnp.float64),
                   "batch_stats": _as(variables["batch_stats"], jnp.float64)}
    tx = jax_create_optimizer(variables64["params"], learning_rate=jax_create_scheduler(
        "warmup_multi_step_decay", **schedule_kwargs()), **OPTIMIZER)
    state = create_train_state(variables64, tx)
    step_j = jax_build_train_step(nwl_j, tx, donate=False)
    batch_j = (jnp.asarray(batch[0].permute(0, 2, 3, 1).numpy()), jnp.asarray(batch[1].numpy()),
               jnp.asarray(batch[2].numpy()))
    for _ in range(3):
        state, loss_j = step_j(state, *batch_j)
        loss = step(*batch)
        np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=F64_RTOL)
    want = convert_net_variables({"params": state.params, "batch_stats": state.batch_stats}, net)
    assert step.count == 3
    for name, value in net.state_dict().items():
        if value.is_floating_point():
            near(value, want[name].double(), name)
    for name, v in start.items():
        assert float((want[name].double() - v).abs().max()) > 1e-5, name  # every tensor moved


def test_three_adamw_steps_match_jax_float64(reduced, jax_float64):
    _, variables, _ = reduced
    rng = np.random.RandomState(8)
    image = rng.randint(0, 256, (4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.uint8)
    kpts = _keypoints(rng, 4, w=float(IMAGE_SIZE[0]), h=float(IMAGE_SIZE[1]))
    pp = build_topdown_preprocess(IMAGE_SIZE, (12, 16), MEAN, STD, sigma=6.0,
                                  target_type="simcc", split_ratio=2.0)
    batch = tuple(t.double() for t in pp(torch.from_numpy(image), torch.from_numpy(kpts)))
    assert batch[1].shape == (4, 17, 96 + 128) and batch[2].sum() > 10
    port = Net(ResNet(BLOCKS), SimCCHead(input_size=IMAGE_SIZE, feature_size=FEATURE_SIZE))
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
    three_steps_match_jax_float64(
        variables, JaxSimCCHead(input_size=IMAGE_SIZE, dtype=jnp.float64), port, batch,
        "kl_discret", {"use_target_weight": True})


# --------------------------------------------------------------- the targets

SETTING = {"image_size": [48, 64], "heatmap_size": [12, 16], "pixel_std": 200.0,
           "scale_padding": 1.25, "flip_pairs": [[1, 2]], "upper_body_ids": [0, 1]}


def target_keypoints(rng, n, k=17, w=48.0, h=64.0):
    """Keypoints inside, on and outside the crop's edges, some invisible."""
    kpts = _keypoints(rng, n, k, w=w, h=h)
    kpts[0, 6:10, :2] = [[0.0, 0.0], [w - 1e-3, h - 1e-3], [w, 5.0], [5.0, h]]
    kpts[0, 6:10, 2] = 1
    return kpts


@pytest.mark.parametrize("sigma, split_ratio", [(6.0, 2.0), (4.0, 2.5)])
def test_device_targets_match_the_host_and_jax(sigma, split_ratio):
    """On the CPU the port's device targets hold the host transform's weights
    bit for bit and its labels within float32 exp and summation rounding;
    JAX's device targets as close."""
    kpts = target_keypoints(np.random.RandomState(10), 6)
    host = TopDownGenerateSimCCTarget(config=SETTING, sigma=sigma, split_ratio=split_ratio)
    want = [host.transform({"keypoints": k}) for k in kpts]
    want_t = np.stack([w["target"] for w in want])
    want_w = np.stack([w["target_weight"] for w in want])
    target, weight = generate_simcc_targets(torch.from_numpy(kpts), tuple(SETTING["image_size"]),
                                            split_ratio=split_ratio, sigma=sigma)
    np.testing.assert_array_equal(weight.numpy(), want_w)
    assert 0 < want_w.sum() < want_w.size and want_t.max() > 0.01
    np.testing.assert_allclose(target.numpy(), want_t, rtol=1e-6, atol=1e-9)
    jax_t, jax_w = jax_simcc_targets(jnp.asarray(kpts), tuple(SETTING["image_size"]),
                                     split_ratio=split_ratio, sigma=sigma)
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jax_w))
    np.testing.assert_allclose(target.numpy(), np.asarray(jax_t), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("target_type", ["simcc", "regression"])
def test_preprocess_renders_simcc_and_regression_targets_as_jax(target_type):
    """``device_pipeline: true`` with either new target type: the normalized
    NCHW crops equal JAX's NHWC ones, the weights equal, the targets within
    float32 rounding (the regression targets bit for bit with the host
    transform's, within an ulp of JAX's)."""
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, (3, 64, 48, 3)).astype(np.uint8)
    kpts = target_keypoints(rng, 3)
    kwargs = dict(sigma=6.0, target_type=target_type, split_ratio=2.0)
    want = jax_build_preprocess((48, 64), (12, 16), MEAN, STD, **kwargs)(
        jnp.asarray(image), jnp.asarray(kpts))
    got = build_topdown_preprocess((48, 64), (12, 16), MEAN, STD, **kwargs)(
        torch.from_numpy(image), torch.from_numpy(kpts))
    assert got[0].shape == (3, 3, 64, 48) and got[0].is_contiguous()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).transpose(0, 3, 1, 2))
    assert got[1].shape == want[1].shape == ((3, 17, 96 + 128) if target_type == "simcc"
                                             else (3, 17, 2))
    if target_type == "regression":
        # the port divides as the host transform does, bit for bit; XLA
        # multiplies by the reciprocal of the constant input size, an ulp apart
        host = TopDownGenerateRegressionTarget(config=SETTING)
        np.testing.assert_array_equal(
            got[1].numpy(), np.stack([host.transform({"keypoints": k})["target"] for k in kpts]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-7, atol=0)
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# -------------------------------------------------- converter and checkpoints


def converter_round_trip_and_train_state(variables, port_head, tmp_path):
    """``net_mapping`` names every flax leaf of the net (convert raises
    otherwise), ``export_variables`` gives the flax tree back bit for bit, and
    a JAX adamw TrainState after 2 updates, written by the JAX package's
    ``save_checkpoint``, restores into the port: weights, moments and step."""
    port = Net(ResNet(BLOCKS), port_head)
    state_dict = convert_net_variables(variables, port)
    port.load_state_dict(state_dict, strict=True)
    back = export_variables(port.state_dict(), net_mapping(port), {})
    for tree in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(unfreeze(jax.device_get(variables[tree])))
        got = dict(jax.tree_util.tree_leaves_with_path(back[tree]))
        assert len(got) == len(want)
        for path, value in want:
            np.testing.assert_array_equal(got[path], np.asarray(value), err_msg=str(path))

    rng = np.random.RandomState(12)
    tx = jax_create_optimizer(variables["params"], "adamw", learning_rate=1e-3,
                              weight_decay=0.05)
    state = create_train_state(variables, tx)
    params, opt_state = state.params, state.opt_state
    update = jax.jit(lambda g, o, p: tx.update(g, o, p))
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    state = state.replace(step=jnp.asarray(2, jnp.int32), params=params, opt_state=opt_state)
    path = str(tmp_path / "state.msgpack")
    jax_save_checkpoint(path, state)
    optimizer = create_optimizer(port, name="adamw", learning_rate=1e-3, weight_decay=0.05)
    assert restore_train_state(path, port, optimizer) == 2
    stats = jax.device_get(state.batch_stats)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
               if hasattr(s, "mu")]
    want = {kind: convert_net_variables({"params": jax.device_get(tree), "batch_stats": stats},
                                        port)
            for kind, tree in (("param", params), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))}
    for name, value in port.state_dict().items():
        assert torch.equal(value, want["param"][name]), name
    for name, p in port.named_parameters():
        s = optimizer.state[p]
        assert float(s["step"]) == 2.0, name
        assert torch.equal(s["exp_avg"], want["exp_avg"][name]), name
        assert torch.equal(s["exp_avg_sq"], want["exp_avg_sq"][name]), name


def test_converter_round_trip_and_jax_train_state(reduced, tmp_path):
    _, variables, _ = reduced
    converter_round_trip_and_train_state(
        variables, SimCCHead(input_size=IMAGE_SIZE, feature_size=FEATURE_SIZE), tmp_path)


# ------------------------------------------------------------------ the entries


def small_crops(recipe, image_size, heatmap_size):
    """``recipe``'s dataset_setting at another crop and heatmap size ([W, H])."""
    setting = port_train.parse_train_args(["--config", recipe]).dataset_setting
    return dict(setting, image_size=list(image_size), heatmap_size=list(heatmap_size))


def train_recipe_through_the_entries(recipe, root, data, overrides):
    """``recipe`` as parsed, with ``overrides`` (the reduced backbone, smaller
    crops, ...), through ``tools/train.train`` on the CPU for one epoch (the
    data, batch 16, O0, one worker), then its last checkpoint through
    ``tools/eval.evaluate`` (the callback's stats) and
    ``tools/serve.build_service`` with the same overrides (one box). Returns
    the train entry's result and its parsed config."""
    (train_root, train_label), (val_root, val_label) = data
    name = os.path.splitext(os.path.basename(recipe))[0]
    args = port_train.parse_train_args(
        ["--config", recipe, "--device", "cpu", "--cfg-options", f"train_root={train_root}",
         f"train_label={train_label}", f"val_root={val_root}", f"val_label={val_label}",
         "batch_size=16", "num_epochs=1", "warmup=0", "val_interval=1", "amp_level=O0",
         "num_parallel_workers=1", f"ckpt_save_dir={os.path.join(root, 'ckpt')}",
         *(f"{k}={v}" if isinstance(v, str) else f"{k}={v!r}" for k, v in overrides.items())])
    result = port_train.train(args)
    (epoch,) = result["epochs"]
    assert epoch["steps"] == 1 and np.isfinite(epoch["loss"]) and epoch["metrics"]
    last = os.path.join(root, "ckpt", f"{name}_last.ckpt")
    assert load_checkpoint(last)["step"] == 1
    got = port_eval.evaluate(Config(**dict(vars(args), ckpt=last,
                                           result_path=os.path.join(root, "result.json"))),
                             device=torch.device("cpu"))
    assert sorted(got) == sorted(epoch["metrics"])
    for k, v in epoch["metrics"].items():
        assert abs(float(got[k]) - float(v)) <= 1e-9, k
    serve_args = port_serve.parse_serve_args(["--config", recipe, "--ckpt", last])
    for k, v in overrides.items():
        setattr(serve_args, k, v)
    service = port_serve.build_service(serve_args, batch_size=8, device=torch.device("cpu"))
    try:
        preds = service.predictor(np.full((160, 224, 3), 127, np.uint8),
                                  np.array([[40.0, 20.0, 60.0, 120.0]], np.float32))
    finally:
        service.close()
    assert preds.shape == (1, args.num_joints, 3) and np.isfinite(preds).all()
    return result, args


def test_simcc_recipe_trains_evaluates_and_serves(tmp_path):
    """resnet50_simcc_tpu.yaml as parsed (hflip TTA on, host targets) with the
    reduced ResNet on 64x48 crops of tiny COCO (96 and 128 bins); then, from
    the same seed, with ``device_pipeline: true`` one step gives the same loss."""
    register_reduced_resnet()
    root = str(tmp_path)
    data = (tiny_coco.write_split(os.path.join(root, "train"), ENTRY_TRAIN_IMAGES,
                                  tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))
    small = {"input_size": list(IMAGE_SIZE), "split_ratio": 2.0}
    result, args = train_recipe_through_the_entries(SIMCC_YAML, root, data, dict(
        backbone_name=REDUCED_RESNET, dataset_setting=small_crops(SIMCC_YAML, IMAGE_SIZE, (12, 16)),
        head_setting=small, decoder_setting=dict(small, sigma=6.0)))
    assert args.eval_setting["hflip_tta"] and args.inference_method == "simcc"
    assert "AP" in result["epochs"][0]["metrics"]
    device = port_train.train(Config(**dict(vars(args), device_pipeline=True, val_while_train=False,
                                            ckpt_save_dir=os.path.join(root, "device"))))
    np.testing.assert_allclose(device["epochs"][0]["loss"], result["epochs"][0]["loss"],
                               rtol=1e-5)
