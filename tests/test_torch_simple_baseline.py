"""Port's ResNet + simple_baseline_head against the JAX package's, on the same weights.

The JAX variables (non-trivial BN parameters and running statistics) are
carried into the port with the port's own converter, and both run on the
same input in float32 on the CPU; the two libraries sum each convolution in
other orders, so outputs agree to a tolerance relative to their largest
value, not bitwise:

- the mapping of ResNet-50/101/152 + the head at full width names every
  flax leaf and every port tensor, with matching shapes;
- a reduced-depth ResNet (one bottleneck per stage, full width) on 64x48
  crops, at inference and in train mode with its BN running statistics;
- the head at narrow widths (16 filters) for 4x4 and 2x2 kernels: this pins
  the transposed conv's spatial flip, its in/out swap and its output
  alignment (without the flip the outputs differ); a 3x3 kernel raises;
- the whole ResNet-50 net at full width on one 256x192 crop;
- a JAX TrainState of ResNet-50 + the head, written by the JAX package's
  own checkpoint code, restored by the port: weights, adam moments, step;
- three train steps of the reduced net against the JAX step, both in float64.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.models.backbones.convert import resnet_mapping as jax_resnet_mapping
from mindpose_tpu.models.backbones.resnet import ResNet as JaxResNet
from mindpose_tpu.models.heads.simple_baseline_head import SimpleBaselineHead as JaxHead
from mindpose_tpu.models.loss import mse as jax_mse_module
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel.train import build_train_step as jax_build_train_step
from mindpose_tpu.parallel.train import create_train_state
from mindpose_tpu.scheduler.schedulers import create_lr_scheduler as jax_create_scheduler
from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
from mindpose_tpu_torch.models import (
    create_backbone,
    create_decoder,
    create_head,
    create_loss,
    create_network,
    create_network_from_config,
    create_network_with_loss,
)
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.backbones.resnet import ResNet
from mindpose_tpu_torch.models.common import BatchNorm2d
from mindpose_tpu_torch.models.convert import (
    convert_net_variables,
    convert_variables,
    head_mapping,
    net_mapping,
    resnet_mapping,
)
from mindpose_tpu_torch.models.heads import SimpleBaselineHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.tools import train as port_train
from mindpose_tpu_torch.utils.checkpoint import restore_train_state
from tests.test_torch_bottomup_loss import Float64Numpy
from tests.test_torch_train_step import YAML, _adam_gradients, _as, _keypoints, _schedule_kwargs
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

BLOCKS = (1, 1, 1, 1)
FILTERS = (16, 16, 16)
ARCHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(glob.glob(os.path.join(ROOT, "configs", "simple_baseline", "*.yaml"))
                 + glob.glob(os.path.join(ROOT, "configs", "udp", "*.yaml")))
# float32 on both sides, convolutions summed in other orders: each output
# within this fraction of its largest |value| (measured: below 2e-6)
RTOL_OF_MAX = 2e-5
# in train mode stage 4's BatchNorm normalizes over 16 values per channel
# (batch 4 x 2 x 2), which magnifies those differences (measured: 2.1e-5)
TRAIN_RTOL_OF_MAX = 1e-4


def _randomize(variables, rng):
    """Non-trivial BN affine parameters and running statistics everywhere."""
    variables = unfreeze(jax.device_get(variables))

    def walk(tree, name=""):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, key)
            elif name.startswith("BatchNorm") or name == "bn1":
                if key in ("scale", "var"):
                    tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
                else:  # bias, mean
                    tree[key] = (0.2 * rng.standard_normal(value.shape)).astype(np.float32)
            elif name == "final_layer":
                # a trainable head: its own init is near zero
                tree[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)

    walk(variables)
    return variables


def _close(got, want, rtol_of_max=RTOL_OF_MAX):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_of_max * float(np.abs(want).max()))


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ the mappings


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resnet_mapping_pairs_the_same_entries_as_the_jax_export(arch):
    assert resnet_mapping(ARCHS[arch]) == jax_resnet_mapping(ARCHS[arch])


def _flax_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flax_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mapping_names_every_flax_leaf_and_every_port_tensor(arch):
    """At full width, from ``net.init``'s shapes (no weights computed): each
    flax leaf is used once, each port tensor named once, shapes matching
    after the layout change (a transposed conv's [kh, kw, I, O] -> [I, O, kh, kw])."""
    jax_net = jax_create_network(arch, "simple_baseline_head")
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 256, 192, 3)), train=False))
    flax = {("params",) + k: v for k, v in _flax_shapes(unfreeze(shapes["params"])).items()}
    flax.update({("batch_stats",) + k: v
                 for k, v in _flax_shapes(unfreeze(shapes["batch_stats"])).items()})
    with torch.device("meta"):
        net = create_network(arch, "simple_baseline_head")
    port = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    used, named = [], {}
    for kind, name, path in net_mapping(net):
        if kind in ("conv", "conv_bias", "deconv"):
            kh, kw, i, o = flax[("params",) + path + ("kernel",)]
            named[f"{name}.weight"] = (i, o, kh, kw) if kind == "deconv" else (o, i, kh, kw)
            used.append(("params",) + path + ("kernel",))
            if kind == "conv_bias":
                named[f"{name}.bias"] = flax[("params",) + path + ("bias",)]
                used.append(("params",) + path + ("bias",))
        else:
            for leaf, group, tname in (("scale", "params", "weight"), ("bias", "params", "bias"),
                                       ("mean", "batch_stats", "running_mean"),
                                       ("var", "batch_stats", "running_var")):
                named[f"{name}.{tname}"] = flax[(group,) + path + (leaf,)]
                used.append((group,) + path + (leaf,))
            named[f"{name}.num_batches_tracked"] = ()
    assert sorted(used) == sorted(flax)
    assert named == port
    n_params = sum(int(np.prod(s)) for k, s in flax.items() if k[0] == "params")
    assert n_params == sum(p.numel() for p in net.parameters())


# --------------------------------------------------------- reduced ResNet


def _reduced_pair(kernel: int = 4):
    """(JAX net, variables, port net with the same weights)."""
    jax_net = JaxNet(backbone=JaxResNet(block_counts=BLOCKS),
                     head=JaxHead(num_deconv_filters=FILTERS, num_deconv_kernels=(kernel,) * 3))
    init = jax.jit(lambda key, x: jax_net.init(key, x, train=False))
    variables = _randomize(init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3))),
                           np.random.RandomState(0))
    port = Net(ResNet(BLOCKS), SimpleBaselineHead(num_deconv_filters=FILTERS,
                                                  num_deconv_kernels=(kernel,) * 3))
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
    return jax_net, variables, port


@pytest.fixture(scope="module")
def reduced():
    return _reduced_pair()


def test_reduced_resnet_matches_jax_at_inference(reduced):
    jax_net, variables, port = reduced
    x = np.random.RandomState(1).standard_normal((2, 64, 48, 3)).astype(np.float32)
    backbone_vars = {"params": variables["params"]["backbone"],
                     "batch_stats": variables["batch_stats"]["backbone"]}
    want = np.asarray(jax.jit(lambda v, x: jax_net.backbone.apply(v, x, train=False))(
        backbone_vars, x))
    port.eval()
    with torch.no_grad():
        got = _nhwc(port.backbone(_nchw(x)))
        heat = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape == (2, 2, 2, 2048)
    _close(got, want)
    want_heat = np.asarray(jax.jit(lambda v, x: jax_net.apply(v, x, train=False))(variables, x))
    assert want_heat.shape == (2, 16, 16, 17) and np.abs(want_heat).max() > 0.1
    _close(heat, want_heat)


def test_reduced_resnet_matches_jax_in_train_mode_with_bn_statistics(reduced):
    jax_net, variables, port = reduced
    x = np.random.RandomState(2).standard_normal((4, 64, 48, 3)).astype(np.float32)
    want, updates = jax.jit(lambda v, x: jax_net.apply(v, x, train=True,
                                                        mutable=["batch_stats"]))(variables, x)
    net = Net(ResNet(BLOCKS), SimpleBaselineHead(num_deconv_filters=FILTERS))
    net.load_state_dict(port.state_dict())
    net.train()
    _close(_nhwc(net(_nchw(x))), np.asarray(want), TRAIN_RTOL_OF_MAX)
    want_sd = convert_net_variables(
        {"params": variables["params"], "batch_stats": jax.device_get(updates["batch_stats"])},
        net)
    got_sd = net.state_dict()
    names = [n for n in want_sd if n.endswith(("running_mean", "running_var"))]
    assert any(n.startswith("head.") for n in names) and len(names) == 2 * (1 + 4 * 4 + 3)
    for name in names:
        np.testing.assert_allclose(got_sd[name].numpy(), want_sd[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


# ------------------------------------------------------------------ head


@pytest.mark.parametrize("kernel", [4, 2])
def test_head_matches_flax_and_needs_the_kernel_flip(kernel):
    """The head alone on [2, 8, 3, 2] features (unequal sides, so a shifted or
    transposed output shows): equal to flax's within the tolerance; the same
    weights carried across without the spatial flip are far off."""
    rng = np.random.RandomState(3)
    jax_head = JaxHead(num_deconv_filters=FILTERS, num_deconv_kernels=(kernel,) * 3,
                       in_channels=8)
    x = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    init = jax.jit(lambda key, x: jax_head.init(key, x, train=False))
    variables = _randomize(init(jax.random.PRNGKey(1), x), rng)
    want = np.asarray(jax.jit(lambda v, x: jax_head.apply(v, x, train=False))(variables, x))
    assert want.shape == (2, 24, 16, 17)

    head = SimpleBaselineHead(num_deconv_filters=FILTERS, num_deconv_kernels=(kernel,) * 3,
                              in_channels=8).eval()
    sd = convert_variables(variables, head_mapping(head))
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _nhwc(head(_nchw(x)))
    assert got.shape == want.shape
    _close(got, want)

    for i in (0, 3, 6):  # the transposed convs, undone to [I, O, kh, kw] without the flip
        sd[f"deconv_layers.{i}.weight"] = sd[f"deconv_layers.{i}.weight"].flip(2, 3)
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        unflipped = _nhwc(head(_nchw(x)))
    assert np.abs(unflipped - want).max() > 100 * RTOL_OF_MAX * np.abs(want).max()


def test_head_settings_are_checked():
    with pytest.raises(ValueError, match="Invalid deconv_kernel"):
        SimpleBaselineHead(num_deconv_kernels=(4, 3, 4))
    with pytest.raises(ValueError, match="Invalid deconv_kernel"):
        JaxHead(num_deconv_kernels=(3, 3, 3)).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 8)))
    # the frozen-statistics mode builds (tests/test_torch_divergent_knobs.py holds it to JAX)
    frozen = create_head("simple_baseline_head", in_channels=8, bn_grad_stats="frozen")
    assert {m.grad_stats for m in frozen.modules() if isinstance(m, BatchNorm2d)} == {"frozen"}
    head = create_head("simple_baseline_head", in_channels=8, final_conv_kernel_size=3,
                       num_deconv_kernels=(2, 2, 2), bn_grad_stats="fused")
    assert head.final_layer.padding == (1, 1)
    assert [m.padding for m in head.deconv_layers if isinstance(m, torch.nn.ConvTranspose2d)] \
        == [(0, 0)] * 3


def test_backbone_settings_and_refusals():
    with torch.device("meta"):
        assert create_backbone("resnet101", bn_grad_stats="fused").block_counts == (3, 4, 23, 3)
        assert create_backbone("resnet152").out_channels == 2048
        # the train entry loads a pretrained backbone; building ignores the flag, as in JAX
        assert create_backbone("resnet50", pretrained=True).block_counts == (3, 4, 6, 3)
        assert isinstance(create_network("resnet50", "simple_baseline_head",
                                         backbone_pretrained=True).backbone, ResNet)
    # the divergent BatchNorm modes build (tests/test_torch_divergent_knobs.py holds them to JAX)
    with torch.device("meta"):
        for knobs, want in (({"bn_stats_frac": 0.5}, (0.5, "exact")),
                            ({"bn_grad_stats": "frozen_var"}, (1.0, "frozen_var"))):
            backbone = create_backbone("resnet50", **knobs)
            assert {(m.stats_frac, m.grad_stats) for m in backbone.modules()
                    if isinstance(m, BatchNorm2d)} == {want}
    with pytest.raises(TypeError):
        create_backbone("resnet50", no_such_setting=1)


@pytest.mark.parametrize("recipe", RECIPES, ids=os.path.basename)
def test_recipe_passes_the_train_entry_and_builds(recipe):
    """Each SimpleBaseline and UDP recipe as parsed: the train entry reads every
    key and refuses none; its net and its decoder build, DARK on as well."""
    args = port_train.parse_train_args(["--config", recipe])
    port_train.check_config(args)
    with torch.device("meta"):
        net = create_network_from_config(args)
    assert isinstance(net.backbone, ResNet if args.backbone_name.startswith("resnet") else HRNet)
    create_decoder(args.decoder_name, **args.decoder_setting)
    if not args.decoder_setting.get("shift_coordinate", False):
        create_decoder(args.decoder_name, **dict(args.decoder_setting, dark_udp_refine=True))


# -------------------------------------------------------- full ResNet-50


def _port_net(arch: str = "resnet50") -> Net:
    """The port's net at full width, built without initializing its weights."""
    with torch.device("meta"):
        net = create_network(arch, "simple_baseline_head")
    return net.to_empty(device="cpu")


@pytest.fixture(scope="module")
def full():
    """ResNet-50 + the head at full width: flax's variable tree, filled from
    a numpy seed (He-normal kernels, randomized BN) without running JAX's init."""
    jax_net = jax_create_network("resnet50", "simple_baseline_head")
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 256, 192, 3)), train=False))
    rng = np.random.RandomState(4)

    def fill(path, s):
        if path[-1].key == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, unfreeze(shapes))
    return jax_net, _randomize(variables, rng)


def test_full_width_resnet50_net_matches_jax(full):
    jax_net, variables = full
    x = np.random.RandomState(5).standard_normal((1, 256, 192, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jax_net.apply(v, x, train=False))(variables, x))
    net = _port_net().eval()
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == want.shape == (1, 64, 48, 17) and np.abs(want).max() > 0.1
    _close(got, want)


def test_jax_resnet50_train_state_restores_into_the_port(full, tmp_path):
    """adamw after 2 updates of random gradients (so the moments are not 0),
    written by the JAX package's save_checkpoint, restored bit for bit."""
    _, variables = full
    rng = np.random.RandomState(6)
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
    path = str(tmp_path / "resnet50_state.msgpack")
    jax_save_checkpoint(path, state)

    net = _port_net()
    optimizer = create_optimizer(net, name="adamw", learning_rate=1e-3, weight_decay=0.05)
    assert restore_train_state(path, net, optimizer) == 2

    stats = jax.device_get(state.batch_stats)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
               if hasattr(s, "mu")]
    want = {kind: convert_net_variables({"params": jax.device_get(tree), "batch_stats": stats},
                                        net)
            for kind, tree in (("param", params), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))}
    for name, value in net.state_dict().items():
        assert torch.equal(value, want["param"][name]), name
    for name, p in net.named_parameters():
        s = optimizer.state[p]
        assert float(s["step"]) == 2.0, name
        assert torch.equal(s["exp_avg"], want["exp_avg"][name]), name
        assert torch.equal(s["exp_avg_sq"], want["exp_avg_sq"][name]), name
        assert float(s["exp_avg"].abs().max()) > 0, name


# ------------------------------------------------- the reduced net's step

IMAGE_SIZE = (64, 64)  # (W, H): a reduced ResNet's 2x2 map gives a 16x16 heatmap
HEATMAP_SIZE = (16, 16)
# float64 on both sides from the same inputs, the loss too (the JAX
# package's float32 loss cast lifted, as in tests/test_torch_bottomup_loss.py;
# the port takes a float64 net's loss in float64), where a fault in any layer
# shows as O(1)
F64_RTOL = 1e-6


def test_three_steps_match_jax_float64(reduced, monkeypatch):
    """The yaml's optimizer and schedule (warmup shortened to 2) for 3 steps of
    the reduced net on one batch of 4, the port's step and the JAX package's
    both in float64, on the same crops, targets and joint weights (the port's
    preprocess, cast to float64). In float32 the comparison would measure
    rounding, not the step: train-mode BatchNorm over the 16 values per
    channel of stage 4 puts float32 gradients up to ~1e-2 of a tensor's
    largest entry off the float64 ones. Losses, every step's gradients,
    running statistics and parameters within ``F64_RTOL`` of each tensor's
    largest entry (losses: relative)."""
    _, variables, _ = reduced
    rng = np.random.RandomState(7)
    image = rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    kpts = _keypoints(rng, 4, w=64.0, h=64.0)
    pp = build_topdown_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0)
    batch = tuple(t.double() for t in pp(torch.from_numpy(image), torch.from_numpy(kpts)))
    assert batch[1].abs().max() > 0.5  # targets with peaks

    net = Net(ResNet(BLOCKS), SimpleBaselineHead(num_deconv_filters=FILTERS))
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    net.double()
    nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    schedule = create_lr_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
    step = build_train_step(nwl, create_optimizer(net, **YAML), schedule)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}

    def close(got, want, name):
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= F64_RTOL * scale, name

    monkeypatch.setattr(jax_mse_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        jax_net = JaxNet(backbone=JaxResNet(block_counts=BLOCKS, dtype=jnp.float64),
                         head=JaxHead(num_deconv_filters=FILTERS, dtype=jnp.float64))
        nwl_j = jax_create_nwl(jax_net, jax_create_loss("joint_mse", use_target_weight=True),
                               has_extra_inputs=True)
        schedule_j = jax_create_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
        variables64 = {"params": _as(variables["params"], jnp.float64),
                       "batch_stats": _as(variables["batch_stats"], jnp.float64)}
        tx = jax_create_optimizer(variables64["params"], learning_rate=schedule_j, **YAML)
        state = create_train_state(variables64, tx)
        step_j = jax_build_train_step(nwl_j, tx, donate=False)
        # NCHW -> NHWC for the JAX net and loss
        batch_j = (jnp.asarray(batch[0].permute(0, 2, 3, 1).numpy()),
                   jnp.asarray(batch[1].permute(0, 2, 3, 1).numpy()), jnp.asarray(batch[2].numpy()))
        mu = None
        for i in range(3):
            stats = state.batch_stats
            state, loss_j = step_j(state, *batch_j)
            g, mu = _adam_gradients(state.opt_state, mu)  # the gradient the step took
            want_g = convert_net_variables({"params": g, "batch_stats": stats}, net)
            loss = step(*batch)
            np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=F64_RTOL)
            for name, p in net.named_parameters():
                close(p.grad.double(), want_g[name].double(), name)
        want = convert_net_variables({"params": state.params, "batch_stats": state.batch_stats},
                                     net)
    assert step.count == 3 and schedule(2) > 0
    for name, value in net.state_dict().items():
        if value.is_floating_point():
            close(value, want[name].double(), name)
    for name, v in start.items():
        assert float((want[name].double() - v).abs().max()) > 1e-4  # every tensor moved
